"""Node-side probe agent.

Counterpart of ``k8s_operator_libs_tpu.health.agent`` for one GPU host:
each cycle it runs the battery on the host's CUDA devices and publishes
the resulting :class:`~.report.HealthReport` as a node annotation, where
the controller-side ``NodeReportProber`` (either package's) reads it.
One process drives every GPU of the host, its collectives included.
Across hosts the agents form one ``torch.distributed`` world from
torchrun-style env (:func:`maybe_initialize_distributed`), in which the
battery's ``dcn_collective`` check all-reduces once a cycle.

Run in the validation DaemonSet as
``python -m k8s_operator_libs_tpu_torch.health.agent``.
"""

from __future__ import annotations

import os
import time
from datetime import timedelta
from typing import Optional, Sequence

import torch

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.health.probes import run_host_probe
from k8s_operator_libs_tpu_torch.health.report import HealthReport
from k8s_operator_libs_tpu_torch.keys import driver_keys, keys_from_env
from k8s_operator_libs_tpu_torch.layers import layer_span, spanned
from k8s_operator_libs_tpu_torch.upgrade.util import UpgradeKeys

logger = get_logger(__name__)

# Set by the downward API in the agent DaemonSet spec.
NODE_NAME_ENV = "NODE_NAME"
# Driver revision the agent probes under; injected by the controller via
# the DaemonSet template (so it changes exactly when the driver does).
DRIVER_REVISION_ENV = "DRIVER_REVISION"
# How long a collective of the cross-host world waits for a peer that
# never enters it before it raises and fails its check.
DISTRIBUTED_TIMEOUT_S = 120.0


def maybe_initialize_distributed(
    backend: Optional[str] = None, init_method: str = "env://"
) -> bool:
    """Join the cross-host ``torch.distributed`` world when the env names
    one: ``WORLD_SIZE`` > 1 and ``RANK``, with ``MASTER_ADDR`` and
    ``MASTER_PORT`` for the default ``env://`` store (as torchrun sets
    them; a ``file://`` ``init_method`` needs no address).

    The backend is NCCL when CUDA is present and ``backend`` is None,
    else gloo, or the one named.  The process group's timeout is finite,
    so a peer that never enters a collective makes it raise under gloo,
    and under NCCL lets the watchdog act (by default it ends the
    process); either way the gate sees a failed or stale report instead
    of a wedged agent.  A second call is a
    no-op.  Returns True when the world spans more than one process."""
    import torch.distributed as dist

    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1") or "1")
        if world < 2:
            return False
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(
            backend,
            init_method=init_method,
            rank=int(os.environ["RANK"]),
            world_size=world,
            timeout=timedelta(seconds=DISTRIBUTED_TIMEOUT_S),
        )
    return dist.get_world_size() > 1


class HealthAgent:
    """Probe-and-publish loop for one GPU host.

    ``client`` needs one method, ``patch_node_annotations(name, patch)``
    (the JAX package's ``KubeClient`` and ``FakeCluster`` have it)."""

    def __init__(
        self,
        client,
        node_name: str,
        keys: Optional[UpgradeKeys] = None,
        driver_revision: str = "",
        devices: Optional[Sequence[torch.device]] = None,
        slice_wide: bool = False,
        matmul_n: int = 4096,
        hbm_mib: int = 1024,
        allreduce_elems: int = 1 << 20,
        deep: bool = False,
        max_iters: Optional[int] = None,
        dcn_peers: Optional[Sequence[str]] = None,
        dcn_group: str = "",
        dcn_expected_groups: Optional[Sequence[str]] = None,
        fused: Optional[bool] = None,
    ) -> None:
        self.client = client
        self.node_name = node_name
        self.keys = keys or driver_keys()
        self.driver_revision = driver_revision
        self.devices = list(devices) if devices is not None else None
        self.slice_wide = slice_wide
        self.matmul_n = matmul_n
        self.hbm_mib = hbm_mib
        self.allreduce_elems = allreduce_elems
        self.deep = deep
        # Sustained-measurement iteration cap; None = the probes' default.
        self.max_iters = max_iters
        self.dcn_peers = list(dcn_peers) if dcn_peers else None
        # This host's DCN group and the groups expected in the world:
        # with both, the battery ends in the dcn_collective all-reduce.
        self.dcn_group = dcn_group
        self.dcn_expected_groups = (
            list(dcn_expected_groups) if dcn_expected_groups else None
        )
        self.fused = fused
        # The request of the last probe's layer spans, which its publish
        # joins (set only while they are on).
        self._request: Optional[int] = None

    @spanned("agent.probe", opens="_request")
    def probe_once(self) -> HealthReport:
        kwargs = {} if self.max_iters is None else {"max_iters": self.max_iters}
        checks = run_host_probe(
            self.devices,
            matmul_n=self.matmul_n,
            hbm_mib=self.hbm_mib,
            allreduce_elems=self.allreduce_elems,
            deep=self.deep,
            dcn_peers=self.dcn_peers,
            dcn_group=self.dcn_group,
            dcn_expected_groups=self.dcn_expected_groups,
            fused=self.fused,
            **kwargs,
        )
        # The visible-device count comes from the enumeration check, not
        # a second enumeration: with a broken driver (the failure this
        # agent exists to report) that would raise and the unhealthy
        # report would never be published.
        devs = 0
        for check in checks:
            if check.name == "device_enumeration":
                devs = int(check.metrics.get("devices", 0.0))
                break
        with layer_span("agent.report"):
            return HealthReport(
                node_name=self.node_name,
                driver_revision=self.driver_revision,
                checks=checks,
                timestamp=time.time(),
                visible_devices=devs,
                slice_wide=self.slice_wide,
            )

    @spanned("agent.publish", joins="_request")
    def publish(self, report: HealthReport) -> None:
        with layer_span("agent.report"):
            payload = report.to_json()
        self.client.patch_node_annotations(
            self.node_name, {self.keys.health_report_annotation: payload},
        )

    def run_once(self) -> HealthReport:
        report = self.probe_once()
        self.publish(report)
        logger.info(
            "published health report for %s: healthy=%s",
            self.node_name,
            report.healthy,
        )
        return report

    def run_forever(self, interval_s: float = 30.0) -> None:
        """Probe/publish until the process is killed (DaemonSet lifecycle).
        Probe failures are published, not raised: an unhealthy report is
        the signal the controller needs."""
        while True:
            try:
                self.run_once()
            except Exception:  # noqa: BLE001 — agent must stay alive
                logger.exception("health probe cycle failed")
            time.sleep(interval_s)


def csv_env(name: str) -> Optional[list]:
    """Comma-separated env var -> stripped non-empty entries, or None."""
    entries = [
        e.strip() for e in os.environ.get(name, "").split(",") if e.strip()
    ]
    return entries or None


def main() -> None:
    """Entrypoint for the agent container:
    ``python -m k8s_operator_libs_tpu_torch.health.agent``."""
    from k8s_operator_libs_tpu_torch.k8s import get_default_client

    node_name = os.environ.get(NODE_NAME_ENV, "")
    if not node_name:
        raise SystemExit(f"{NODE_NAME_ENV} is required")
    # The cross-host world carries only dcn_collective: an H100 node is
    # one host whose GPUs this process drives, so its reports stay
    # slice_wide=False (the agent's default) whatever the world's size.
    maybe_initialize_distributed()
    agent = HealthAgent(
        client=get_default_client(),
        node_name=node_name,
        # DRIVER_NAME, set by the agent DaemonSet, names the controller's
        # driver: the report lands under the keys the controller reads.
        keys=keys_from_env(),
        driver_revision=os.environ.get(DRIVER_REVISION_ENV, ""),
        deep=os.environ.get("HEALTH_DEEP_PROBE", "") == "1",
        dcn_peers=csv_env("HEALTH_DCN_PEERS"),
        dcn_group=os.environ.get("HEALTH_DCN_GROUP", ""),
        dcn_expected_groups=csv_env("HEALTH_DCN_GROUPS"),
    )
    interval = float(os.environ.get("HEALTH_PROBE_INTERVAL_S", "30"))
    agent.run_forever(interval)


if __name__ == "__main__":
    main()
