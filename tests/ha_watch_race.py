"""A leader-elected watch-mode controller's roll, by either package.

    python tests/ha_watch_race.py reference|port [--resync S] [--timeout S]
                                  [--late-baseline S] [--runs N]

Each run rolls one two-host TPU slice (``tests/fixtures.py``'s, the
package prefix rewritten for the port) with one controller,
``leader_elect`` and ``watch`` on, the health gate off, and reports the
final states, the controller's passes and the seconds.  The controller's
watch pump opens its streams only once the replica leads, from a
baseline its informer takes when the pump thread next runs; the first
pass of the epoch runs meanwhile, and writes that land before the
baseline wake nothing.  ``--late-baseline S`` holds the informer's
baseline back S seconds, so they always do: with a long ``--resync`` the
roll then waits for the resync.  Prints one JSON line a run and the
count of stalled runs.  The reference's mode needs JAX (its controller
imports its health battery); the port's imports none.
"""

from __future__ import annotations

import argparse
import importlib
import json
import re
import sys
import threading
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"reference": "k8s_operator_libs_tpu",
            "port": "k8s_operator_libs_tpu_torch"}


def run_once(package: str, resync_s: float, timeout_s: float,
             late_baseline_s: float) -> dict:
    source = (ROOT / "tests" / "fixtures.py").read_text()
    fixtures = types.ModuleType(f"_fixtures_{package}")
    exec(compile(re.sub(r"\bk8s_operator_libs_tpu\b", package, source),
                 "fixtures", "exec"), fixtures.__dict__)
    api = importlib.import_module(f"{package}.api")
    k8s = importlib.import_module(f"{package}.k8s")
    ctl = importlib.import_module(f"{package}.controller")
    # Each controller's own keys: the reference's default driver, the
    # port's on the NVIDIA domain.
    if package == PACKAGES["port"]:
        keys = importlib.import_module(f"{package}.keys").driver_keys()
    else:
        keys = importlib.import_module(f"{package}.upgrade").UpgradeKeys()
    store = k8s.FakeCluster()
    fx = fixtures.ClusterFixture(store, keys)
    ds = fx.daemon_set(hash_suffix="v1", revision=1)
    nodes = fx.tpu_slice("pool-a", hosts=2, topology="2x2x2")
    for n in nodes:
        fx.driver_pod(n, ds, hash_suffix="v1")
    fx.bump_daemon_set_template(ds, "v2", revision=2)
    fx.auto_recreate_driver_pods(ds, "v2")
    controller = ctl.UpgradeController(store, ctl.ControllerConfig(
        namespace=fixtures.NAMESPACE,
        driver_labels=fixtures.DRIVER_LABELS,
        interval_s=resync_s,
        policy=api.TPUUpgradePolicySpec(
            auto_upgrade=True,
            drain_spec=api.DrainSpec(enable=True, timeout_second=5),
            health_gate=api.SliceHealthGateSpec(enable=False),
        ),
        watch=True, watch_debounce_s=0.02, hbm_floor_fraction=0.0,
        leader_elect=True, identity="replica-1", publish_events=False,
    ))
    controller.manager.provider.poll_interval_s = 0.01
    controller.manager.provider.poll_timeout_s = 2.0
    if late_baseline_s:
        sync = controller.informer.sync

        def late_sync():
            time.sleep(late_baseline_s)
            return sync()

        controller.informer.sync = late_sync
    passes = [0]
    reconcile = controller.reconcile_once

    def counted():
        passes[0] += 1
        return reconcile()

    controller.reconcile_once = counted
    thread = threading.Thread(target=controller.run_forever, daemon=True)
    t0 = time.monotonic()
    thread.start()
    while time.monotonic() - t0 < timeout_s:
        states = sorted({store.get_node(n.name, cached=False).labels.get(
            keys.state_label, "") for n in nodes})
        if states == ["upgrade-done"]:
            break
        time.sleep(0.05)
    seconds = time.monotonic() - t0
    controller.stop()
    thread.join(10.0)
    return {"package": package, "states": states, "passes": passes[0],
            "seconds": round(seconds, 3),
            "stalled": states != ["upgrade-done"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("package", choices=sorted(PACKAGES))
    parser.add_argument("--resync", type=float, default=120.0)
    parser.add_argument("--timeout", type=float, default=3.0)
    parser.add_argument("--late-baseline", type=float, default=0.0)
    parser.add_argument("--runs", type=int, default=1)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    stalled = 0
    for _ in range(args.runs):
        record = run_once(PACKAGES[args.package], args.resync, args.timeout,
                          args.late_baseline)
        stalled += record["stalled"]
        print(json.dumps(record), flush=True)
    print(f"stalled {stalled} of {args.runs}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
