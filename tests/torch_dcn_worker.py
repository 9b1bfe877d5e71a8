"""One host of a multi-process world running both packages' DCN checks.

Spawned by ``test_torch_dcn_collective.py``, once per rank.  Each process
models one host of a multi-node job: it joins a ``jax.distributed`` world
(CPU, gloo collectives, 2 virtual devices; the JAX package's own
``maybe_initialize_distributed`` from the GKE-shaped env) and a gloo
``torch.distributed`` world on a ``FileStore`` (the port's
``maybe_initialize_distributed`` with a ``file://`` store), then runs the
same cases through both packages, in the same order on every rank:

- ``dcn_collective_probe`` over the groups ``ring-a``/``ring-b`` (rank
  parity picks this host's), then with ``ring-c`` expected as well, then
  with the collective raising;
- ``run_network_path_checks`` and ``NetworkPathGateProber`` on this
  process's devices, expecting the world's size and one process more,
  healthy and with a ring member that keeps its own value;
- the port's ``HealthAgent`` report with the DCN checks configured, for
  the two group lists (the second with a live listener as its peer).

Prints one JSON line on stdout: each case's results from both packages.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_cpu_collectives_implementation", "gloo")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from k8s_operator_libs_tpu.artifacts import gates as jgates  # noqa: E402
from k8s_operator_libs_tpu.health import agent as jagent  # noqa: E402
from k8s_operator_libs_tpu.health import fused as jfused  # noqa: E402
from k8s_operator_libs_tpu.health import probes as jprobes  # noqa: E402
from k8s_operator_libs_tpu_torch.artifacts import gates as tgates  # noqa: E402
from k8s_operator_libs_tpu_torch.health import agent as tagent  # noqa: E402
from k8s_operator_libs_tpu_torch.health import fused as tfused  # noqa: E402
from k8s_operator_libs_tpu_torch.health import probes as tprobes  # noqa: E402
from k8s_operator_libs_tpu_torch.kernels import collectives  # noqa: E402
from k8s_operator_libs_tpu_torch.upgrade import UpgradeKeys  # noqa: E402

GROUPS = ["ring-a", "ring-b"]
WITH_C = GROUPS + ["ring-c"]
# The port drives two CPU "GPUs", as each JAX process holds two devices.
DEVICES = [torch.device("cpu")] * 2


def _check(c) -> dict:
    return {"name": c.name, "ok": c.ok, "detail": c.detail,
            "metrics": dict(c.metrics)}


def _gate(g) -> dict:
    return {"passed": g.passed, "detail": g.detail, "checks": g.checks}


class _Recorder:
    def __init__(self):
        self.patches = []

    def patch_node_annotations(self, name, patch):
        self.patches.append(dict(patch))


def _raise(*args, **kwargs):
    raise RuntimeError("injected DCN fault")


def _network(world: int) -> dict:
    out = {}
    for expected in (world, world + 1):
        ref = jfused.run_network_path_checks(
            jax.local_devices(), expected_processes=expected
        )
        port = tfused.run_network_path_checks(
            DEVICES, expected_processes=expected
        )
        out[f"expect {expected}"] = [
            [_check(c) for c in ref], [_check(c) for c in port]
        ]
    ref = jgates.NetworkPathGateProber(
        runner=lambda: jfused.run_network_path_checks(
            jax.local_devices(), expected_processes=world
        )
    ).probe(None, "net")
    port = tgates.NetworkPathGateProber(
        runner=lambda: tfused.run_network_path_checks(
            DEVICES, expected_processes=world
        )
    ).probe(None, "net")
    out["gate"] = [_gate(ref), _gate(port)]
    return out


def main() -> None:
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    group = GROUPS[rank % 2]
    assert jagent.maybe_initialize_distributed(backend="cpu")
    assert tagent.maybe_initialize_distributed(
        backend="gloo", init_method="file://" + os.environ["TORCH_STORE"]
    )
    # A second call is a no-op.
    assert tagent.maybe_initialize_distributed(backend="gloo")
    cases: dict = {"world": [jax.process_count(), dist.get_world_size()]}

    for label, expected in (("pass", GROUPS), ("ring-c", WITH_C)):
        ref = jprobes.dcn_collective_probe(jax.devices(), group, expected)
        port = tprobes.dcn_collective_probe(DEVICES, group, expected)
        cases[f"dcn {label}"] = [_check(ref), _check(port)]

    saved = (jax.lax.psum, dist.all_reduce)
    jax.lax.psum, dist.all_reduce = _raise, _raise
    try:
        ref = jprobes.dcn_collective_probe(jax.devices(), group, GROUPS)
        port = tprobes.dcn_collective_probe(DEVICES, group, GROUPS)
    finally:
        jax.lax.psum, dist.all_reduce = saved
    cases["dcn raises"] = [_check(ref), _check(port)]

    cases["network"] = _network(world)
    # The JAX battery's compiled program holds the ring it was traced
    # with: drop both caches so the fault reaches it.
    jfused.reset_battery_cache()
    tfused.reset_battery_cache()
    saved = (jax.lax.ppermute, collectives.ring_shift)
    jax.lax.ppermute = lambda x, axis_name, perm: x
    collectives.ring_shift = lambda shards: [s.clone() for s in shards]
    try:
        cases["network, ring fault"] = _network(world)
    finally:
        jax.lax.ppermute, collectives.ring_shift = saved

    reports = {}
    for label, expected, peers in (
        ("pass", GROUPS, None),
        ("ring-c", WITH_C, [os.environ["LIVE_PEER"]]),
    ):
        client = _Recorder()
        keys = UpgradeKeys()
        tagent.HealthAgent(
            client, f"host-{rank}", keys, driver_revision="rev-dcn",
            devices=DEVICES, matmul_n=64, hbm_mib=1, allreduce_elems=64,
            dcn_peers=peers, dcn_group=group, dcn_expected_groups=expected,
        ).run_once()
        reports[label] = client.patches[0][keys.health_report_annotation]
    cases["reports"] = reports
    print(json.dumps(cases), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
