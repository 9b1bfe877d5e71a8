"""What a driver roll under the configuration's policy must come to.

Every roll ends with every node ``upgrade-done`` and every node's driver
pod at the roll's revision; at no sample are more nodes unschedulable
than the policy's ``maxUnavailable`` allows, nor more in flight than its
``maxParallelUpgrades``.
"""

from __future__ import annotations

import math

DONE = "upgrade-done"


def max_unavailable(spec, nodes: int) -> int:
    """``maxUnavailable`` as a node count: a percentage rounds down, but
    never below one node (the GPU operator's reading)."""
    if isinstance(spec, str) and spec.endswith("%"):
        return max(1, math.floor(nodes * float(spec[:-1]) / 100.0))
    return int(spec)


def roll_faults(rolls: list, policy: dict, nodes: int) -> list[str]:
    """Every way the recorded rolls departed from the policy.  A roll is
    ``{"revision", "final_states", "final_revisions",
    "max_unavailable_seen", "max_in_flight_seen"}``."""
    cap_down = max_unavailable(policy["max_unavailable"], nodes)
    cap_flight = int(policy["max_parallel_upgrades"])
    faults = []
    for i, r in enumerate(rolls):
        states = r.get("final_states") or {}
        if len(states) != nodes or any(s != DONE for s in states.values()):
            faults.append(f"roll {i}: final states {states}")
        revs = r.get("final_revisions") or {}
        if len(revs) != nodes or any(v != r["revision"] for v in revs.values()):
            faults.append(f"roll {i}: driver revisions {revs}, "
                          f"want {r['revision']}")
        if r.get("max_unavailable_seen", 0) > cap_down:
            faults.append(f"roll {i}: {r['max_unavailable_seen']} nodes "
                          f"unschedulable at once, policy {cap_down}")
        if r.get("max_in_flight_seen", 0) > cap_flight:
            faults.append(f"roll {i}: {r['max_in_flight_seen']} nodes in "
                          f"flight at once, policy {cap_flight}")
    return faults
