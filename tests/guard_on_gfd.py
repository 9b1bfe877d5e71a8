"""One guard stage on a GFD-labelled fleet, by either package.

    python tests/guard_on_gfd.py reference STAGE [--torch] [--slices N --hosts H]
    python tests/guard_on_gfd.py port STAGE [--torch] [--slices N --hosts H]

``reference`` runs ``tools/bench_guard.py``'s ``measure_<STAGE>`` with the
fixtures' ``tpu_slice`` building GPU Feature Discovery-labelled nodes of
the same names, each in no slice (the fleet the port's guard builds);
``port`` runs ``k8s_operator_libs_tpu_torch.bench_guard``'s stage on its
own GFD fleet.  ``--torch`` imports torch first, as every process of the
port did before its package stopped importing its health battery.
STAGE is ``tracing`` or ``incremental``; ``--slices``/``--hosts`` size
the incremental stage.  Prints the stage's record as one JSON line,
with ``start_rss_mib``, the process's resident set before the stage.
The port's mode imports no JAX; the reference's needs it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GFD_LABELS = {"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
              "nvidia.com/gpu.count": "8"}


def _rss_mib() -> float:
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) / 1024 for line in f
                    if line.startswith("VmRSS:"))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("package", choices=("reference", "port"))
    parser.add_argument("stage", choices=("tracing", "incremental"))
    parser.add_argument("--torch", action="store_true")
    parser.add_argument("--slices", type=int)
    parser.add_argument("--hosts", type=int)
    args = parser.parse_args()
    if args.torch:
        import torch  # noqa: F401
    sizes = {k: v for k, v in (("slices", args.slices),
                               ("hosts", args.hosts)) if v}
    if args.package == "reference":
        sys.path[:0] = [str(ROOT), str(ROOT / "tools"), str(ROOT / "tests")]
        import fixtures

        def gfd_nodes(self, slice_id, hosts=4, state=None, topology=None,
                      **kw):
            return [self.node(name=f"{slice_id}-w{i}", state=state,
                              labels=dict(GFD_LABELS))
                    for i in range(hosts)]

        fixtures.ClusterFixture.tpu_slice = gfd_nodes
        import bench_guard as guard
        # The reference's modules, imported before the stage, as the
        # port's are.
        import k8s_operator_libs_tpu.upgrade  # noqa: F401
    else:
        sys.path.insert(0, str(ROOT))
        from k8s_operator_libs_tpu_torch import bench_guard as guard
    start = _rss_mib()
    record = getattr(guard, f"measure_{args.stage}")(**sizes)
    record["start_rss_mib"] = start
    record["package"] = args.package
    record["torch_imported"] = "torch" in sys.modules
    print(json.dumps(record, sort_keys=True, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
