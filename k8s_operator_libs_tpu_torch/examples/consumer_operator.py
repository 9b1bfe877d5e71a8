"""A consumer operator embedding the port's upgrade library: the copy of
``examples/consumer_operator.py`` with the package prefix rewritten.

It shows the reference's primary usage shape (its consumers, the
GPU/Network Operators, own the reconcile loop and wire their own policy
source and validation).

This example manages a fictional "mydriver" DaemonSet with:

- its own policy source (here: a dict; in a real operator, your CRD),
- a custom validation prober (here: "driver pod publishes a ready file
  marker annotation" — the moral equivalent of the reference's consumers
  pointing ValidationManager at their nvidia-smi validation pod),
- its own reconcile cadence.

Run against a real cluster (kubeconfig from $KUBECONFIG or
~/.kube/config, in-cluster service account when deployed):

    python -m k8s_operator_libs_tpu_torch.examples.consumer_operator --interval 30

or exercise it hermetically (what tests/test_torch_example.py does) by
passing a FakeCluster through ``run_reconcile_loop(client, ...)``.
"""

from __future__ import annotations

import argparse
import time

from k8s_operator_libs_tpu_torch.api import TPUUpgradePolicySpec
from k8s_operator_libs_tpu_torch.health.slice_prober import ProbeResult
from k8s_operator_libs_tpu_torch.upgrade import (
    ClusterUpgradeStateManager,
    UpgradeKeys,
)

DRIVER_NAME = "mydriver"
NAMESPACE = "mydriver-system"
DRIVER_LABELS = {"app": f"{DRIVER_NAME}-driver"}
READY_MARKER = "example.com/mydriver-validated"


class MarkerProber:
    """Consumer-supplied validation: a slice passes when every host's
    node carries the READY_MARKER annotation (your driver's readiness
    probe would publish it).  Same duck type as NodeReportProber."""

    def probe(self, group) -> ProbeResult:
        missing = [
            n.name
            for n in group.nodes
            if n.annotations.get(READY_MARKER) != "true"
        ]
        if missing:
            return ProbeResult(
                False, f"awaiting validation marker on: {', '.join(missing)}"
            )
        return ProbeResult(True, f"all {group.size()} host(s) validated")


def build_manager(client) -> ClusterUpgradeStateManager:
    keys = UpgradeKeys(driver_name=DRIVER_NAME, domain="example.com")
    mgr = ClusterUpgradeStateManager(client, keys=keys)
    mgr.with_validation_enabled(MarkerProber())
    # Your workload pods, not DaemonSets, get evicted before the upgrade.
    mgr.with_pod_deletion_enabled(lambda pod: not pod.is_daemonset_pod())
    return mgr


def load_policy() -> TPUUpgradePolicySpec:
    """In a real operator this comes from your CRD spec."""
    return TPUUpgradePolicySpec.from_dict(
        {
            "autoUpgrade": True,
            "maxParallelUpgrades": 1,
            "maxUnavailable": "25%",
            "podDeletion": {"force": False, "timeoutSeconds": 300},
            "drain": {"enable": True, "timeoutSeconds": 300},
            # The library's GPU health gate is replaced by MarkerProber,
            # so the built-in gate knobs are left enabled-by-default.
        }
    )


def run_reconcile_loop(
    client,
    interval_s: float = 30.0,
    max_passes: int | None = None,
    leader_elect: bool = False,
    elector=None,
) -> None:
    """The consumer-owned loop: snapshot, tick, sleep — identical shape
    to a controller-runtime Reconcile with a resync period.

    ``leader_elect`` shows the HA pattern for a consumer running 2+
    replicas: only the Lease holder reconciles, everyone else stands by
    (the same library protocol the bundled controller uses)."""
    if leader_elect and elector is None:
        from k8s_operator_libs_tpu_torch.k8s.leader import (
            LeaderElector,
            ensure_lease_kind,
        )

        ensure_lease_kind(client)  # no-op on a real apiserver
        elector = LeaderElector(
            client, namespace=NAMESPACE, name=f"{DRIVER_NAME}-operator"
        )
    mgr = build_manager(client)
    policy = load_policy()
    passes = 0
    while max_passes is None or passes < max_passes:
        if elector is not None and not elector.acquire_or_renew():
            time.sleep(min(elector.retry_period_s, interval_s))
            continue
        state = mgr.build_state(NAMESPACE, DRIVER_LABELS, policy)
        # Re-check right before the mutating phase: a build_state that
        # outlives the 10 s renew deadline must not cordon/drain
        # concurrently with a successor that already took over (the
        # controller's ``_still_leading`` guard, in example form).
        if elector is not None and not elector.acquire_or_renew():
            continue
        mgr.apply_state(state, policy)
        mgr.wait_for_async_work()
        print(
            f"pass {passes}: managed={mgr.get_total_managed_nodes(state)} "
            f"in-progress={mgr.get_upgrades_in_progress(state)} "
            f"done={mgr.get_upgrades_done(state)} "
            f"failed={mgr.get_upgrades_failed(state)}"
        )
        passes += 1
        if max_passes is None:
            renewing_sleep(elector, interval_s)
    if elector is not None:
        elector.release()  # clean handover to the standby replica


def renewing_sleep(elector, seconds: float) -> None:
    """Sleep in retry-period chunks, renewing the Lease between chunks.

    A plain ``time.sleep(interval_s)`` would forfeit the lease every
    pass (interval 30 s > the 15 s default term) and ping-pong
    leadership with the standby; this mirrors the bundled controller's
    ``_wait``."""
    deadline = time.monotonic() + seconds
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return
        chunk = remaining
        if elector is not None:
            chunk = min(chunk, elector.retry_period_s)
        time.sleep(chunk)
        if elector is not None:
            elector.acquire_or_renew()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--interval", type=float, default=30.0)
    parser.add_argument(
        "--leader-elect",
        action="store_true",
        help="run 2+ replicas safely: only the Lease holder reconciles",
    )
    args = parser.parse_args()
    from k8s_operator_libs_tpu_torch.k8s import get_default_client

    run_reconcile_loop(
        get_default_client(),
        interval_s=args.interval,
        leader_elect=args.leader_elect,
    )


if __name__ == "__main__":
    main()
