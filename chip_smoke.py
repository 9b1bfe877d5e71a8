#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's health battery on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It imports the port (``k8s_operator_libs_tpu_torch``) and nothing of JAX.
Phases:

1. the device: name, count, and ``nvidia-smi`` name and power limit;
2. build the hand-written kernels from ``kernels/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, exactly,
   at the main path's shapes and at odd, unaligned, 0.25- and NaN-seeded
   inputs, with CUDA-event times beside the bound and one library call;
   then the fused battery at a small size on the card against the CPU;
4. the unfused battery at production size (n=4096 bf16, 1 GiB stream);
5. the fused battery twice (a warm-up-cache miss, then a hit);
6. the node agent publishing a report, which the port's NodeReportProber
   accepts, and the LocalDeviceProber.

Kernel launch counts are zeroed just before each path of phases 4-6
(unfused, fused cold, fused warm, agent, local prober) and read just
after it: every kernel must have been launched on every path, and no
path may have fallen back from the fused battery.  Any failure exits
non-zero and prints no result; so does a machine without a CUDA device.  The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# NVIDIA data sheet, H100 SXM: fp32 outside the tensor cores.  The
# operations side of the elementwise kernels' bound (the bytes side,
# from the card's HBM rate, is the larger one for both).
FP32_PEAK_TFLOPS = 67.0
PROD = dict(matmul_n=4096, hbm_mib=1024)
SMALL = dict(matmul_n=128, hbm_mib=1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def nvidia_smi_name_power() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print(
            "chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
            file=sys.stderr,
        )
        return 1
    import k8s_operator_libs_tpu_torch as port
    from k8s_operator_libs_tpu_torch import hw
    from k8s_operator_libs_tpu_torch.health import fused
    from k8s_operator_libs_tpu_torch.health.agent import HealthAgent
    from k8s_operator_libs_tpu_torch.health.report import HealthReport
    from k8s_operator_libs_tpu_torch.kernels import battery as K
    from k8s_operator_libs_tpu_torch.kernels import build
    from k8s_operator_libs_tpu_torch.upgrade import UpgradeKeys

    require(
        Path(port.__file__).resolve().parent.parent == HERE,
        f"the port was imported from {port.__file__}, not from this checkout",
    )

    # -- 1. device ---------------------------------------------------------
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = nvidia_smi_name_power()
    print(f"device: {name} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(card, flush=True)
    spec = hw.chip_spec(name)
    hbm_gbps = spec.hbm_gbps if spec else 3350.0

    # -- 2. build ----------------------------------------------------------
    build.load_library()
    print(f"[build] kernels built and loaded in {build.last_build_s:.2f} s "
          f"({build.SOURCE.relative_to(HERE)})", flush=True)

    # -- 3. kernels against their plain versions ---------------------------
    max_err = {"stream_increment_": 0.0, "verify_stats": 0.0}

    def same(kname: str, got: torch.Tensor, want: torch.Tensor, what: str):
        torch.cuda.synchronize()
        require(
            torch.equal(got.isnan(), want.isnan()),
            f"{kname} {what}: NaN pattern differs from the plain version",
        )
        diff = (got - want).abs().nan_to_num(0.0).max().item()
        max_err[kname] = max(max_err[kname], diff)
        require(diff == 0.0, f"{kname} {what}: max |kernel - plain| {diff}")

    n_x = PROD["hbm_mib"] * 1024 * 1024 // 4
    for n, off in ((n_x, 0), (1_000_003, 0), (1_000_003, 1), (5, 3)):
        x = torch.zeros(n + off, device=dev)[off:]
        y = x.clone()
        for _ in range(3):
            K.stream_increment_(x)
            K.stream_increment_plain_(y)
        same("stream_increment_", x, y, f"n={n} offset={off}")
        require(x[0].item() == 3.0, "stream_increment_: 3 passes != 3.0")
        del x, y
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # Both main-path shapes (x: fp32 1 GiB; C: bf16 4096^2), then odd,
    # unaligned and tiny inputs.
    odd = ((1_000_003, 0), (1_000_003, 1), (5, 3))
    for dtype, cases in (
        (torch.float32, ((n_x, 0), (4096 * 4096, 0)) + odd),
        (torch.bfloat16, ((4096 * 4096, 0),) + odd),
    ):
        for n, off in cases:
            x = torch.randn(n + off, device=dev, generator=gen).to(dtype)[off:]
            for center in (0.0, 0.5):
                same("verify_stats", K.verify_stats(x, center),
                     K.verify_stats_plain(x, center),
                     f"{dtype} n={n} offset={off} center={center}")
            del x
    c = torch.full((4096, 4096), 0.5, dtype=torch.bfloat16, device=dev)
    require(K.verify_stats(c, 0.5).tolist() == [0.5, 0.5, 0.0],
            "verify_stats on the exact 0.5 matrix")
    c[1234, 567] = 0.25
    got = K.verify_stats(c, 0.5)
    same("verify_stats", got, K.verify_stats_plain(c, 0.5), "0.25 seeded")
    require(got.tolist() == [0.25, 0.5, 0.25], f"0.25 seeded: {got.tolist()}")
    c[4095, 4095] = float("nan")
    got = K.verify_stats(c, 0.5)
    same("verify_stats", got, K.verify_stats_plain(c, 0.5), "NaN seeded")
    require(bool(got.isnan().all()), f"NaN seeded: {got.tolist()}")
    x = torch.full((n_x,), 8.0, device=dev)
    x[n_x - 1] = float("nan")
    require(bool(K.verify_stats(x, 0.0).isnan().all()),
            "NaN at the end of the 1 GiB stream did not propagate")
    del c, x
    print("[kernels] K1 and K2 match their plain versions exactly "
          "(1 GiB fp32, 4096^2 bf16, odd length, unaligned, 0.25, NaN)",
          flush=True)

    flush_buf = torch.empty(256 * 1024 * 1024 // 4, device=dev)

    def time_ms(fn, iters: int, flush: bool = False) -> float:
        """Mean ms per call by CUDA events; with ``flush`` each call
        starts with a cold L2 (a 256 MiB write outside the timed span)."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if not flush:
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters
        total = 0.0
        for _ in range(iters):
            flush_buf.zero_()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    def bound(nbytes: float, ops: float) -> tuple[float, str]:
        by_bytes = nbytes / (hbm_gbps * 1e9) * 1e3
        by_ops = ops / (FP32_PEAK_TFLOPS * 1e12) * 1e3
        return max(by_bytes, by_ops), (
            "bytes" if by_bytes >= by_ops else "operations"
        )

    x = torch.zeros(n_x, device=dev)
    c = torch.full((4096, 4096), 0.5, dtype=torch.bfloat16, device=dev)
    timing = {}
    k1_bound, k1_by = bound(2 * 4 * n_x, n_x)
    timing["stream_increment_"] = dict(
        at=f"x fp32 [{n_x}] (1 GiB), in place",
        ms=time_ms(lambda: K.stream_increment_(x), 50),
        plain_ms=time_ms(lambda: K.stream_increment_plain_(x), 50),
        library_ms=time_ms(lambda: x.add_(1.0), 50),
        bound_ms=k1_bound, bound_by=k1_by,
    )
    shapes = []
    for label, t, flush in (
        (f"x fp32 [{n_x}] (1 GiB)", x, False),
        ("C bf16 [4096, 4096], cold L2", c, True),
    ):
        b_ms, b_by = bound(t.numel() * t.element_size() + 12, 4 * t.numel())
        shapes.append(dict(
            at=label,
            ms=time_ms(lambda: K.verify_stats(t, 0.5), 30, flush),
            plain_ms=time_ms(lambda: K.verify_stats_plain(t, 0.5), 30, flush),
            library_ms=time_ms(lambda: torch.aminmax(t), 30, flush),
            bound_ms=b_ms, bound_by=b_by,
        ))
    timing["verify_stats"] = dict(shapes[0], shapes=shapes)
    del x, c, flush_buf
    for kname, t in timing.items():
        for s in t.get("shapes", [t]):
            print(f"[timing] {kname} {s['at']}: kernel {s['ms']:.4f} ms, "
                  f"bound {s['bound_ms']:.4f} ms ({s['bound_by']}), "
                  f"plain {s['plain_ms']:.4f} ms, library "
                  f"{s['library_ms']:.4f} ms on {card}", flush=True)

    # The fused battery at a small size: the card against the CPU.
    on_gpu = port.run_host_probe([dev], fused=True, **SMALL)
    on_cpu = port.run_host_probe([torch.device("cpu")], fused=True, **SMALL)
    require(
        [(r.name, r.ok, r.detail) for r in on_gpu[1:]]
        == [(r.name, r.ok, r.detail) for r in on_cpu[1:]],
        "small fused battery: the card disagrees with the CPU reference",
    )
    print("[reference] small fused battery on the card matches the CPU",
          flush=True)

    # -- 4-6. the main path, with launch counts per path -------------------
    fused.reset_battery_cache()
    launches = {k: 0 for k in K.launch_counts()}

    def on_path(label: str, fn):
        """Run one path of the main path with the counts zeroed just
        before it and read just after it; every kernel must launch."""
        K.reset_launch_counts()
        out = fn()
        counts = K.launch_counts()
        print(f"[launches] {label}: "
              + ", ".join(f"{k} {n}" for k, n in counts.items()), flush=True)
        for kname, n in counts.items():
            require(n > 0, f"{kname} was not launched on the {label} path")
            launches[kname] += n
        return out

    def all_ok(checks, what: str) -> None:
        for r in checks:
            print(f"  {r.name}: ok={r.ok} {r.detail} "
                  f"{json.dumps({k: round(v, 4) for k, v in r.metrics.items()})}")
        bad = [f"{r.name}: {r.detail}" for r in checks if not r.ok]
        require(not bad, f"{what}: {bad}")

    t0 = time.perf_counter()
    unfused = on_path("unfused",
                      lambda: port.run_host_probe(fused=False, **PROD))
    print(f"[unfused] production battery in "
          f"{time.perf_counter() - t0:.2f} s on {card}:")
    all_ok(unfused, "unfused battery")
    for r in unfused:
        if r.metrics.get("timing_inconclusive"):
            print(f"  {r.name}: timing inconclusive (not a failure)")
        for k in ("tflops", "mfu", "gbps"):
            if k in r.metrics:
                print(f"  {r.name} {k} = {r.metrics[k]} on {card}")

    runs = []
    for attempt in ("cold", "warm"):
        checks = on_path(f"fused {attempt}",
                         lambda: port.run_host_probe(fused=True, **PROD))
        print(f"[fused] {attempt} production battery on {card}:")
        all_ok(checks, f"fused battery ({attempt})")
        runs.append(checks[1:])
    for checks, hit in zip(runs, (0.0, 1.0)):
        for r in checks:
            require(r.metrics.get("fused") == 1.0, f"{r.name} is not fused")
            require(r.metrics["battery_cache_hit"] == hit,
                    f"{r.name}: battery_cache_hit != {hit}")
    stats = fused.battery_stats()
    require(stats["fallbacks"] == 0, f"fused fallbacks: {stats}")
    for attempt, checks in zip(("cold", "warm"), runs):
        m = checks[0].metrics
        print(f"[fused] {attempt}: battery_compile_ms "
              f"{m['battery_compile_ms']:.3f}, battery_execute_ms "
              f"{m['battery_execute_ms']:.3f} on {card}")

    class RecordingClient:
        def __init__(self):
            self.patches = []

        def patch_node_annotations(self, node, patch):
            self.patches.append((node, dict(patch)))

    class Node:
        def __init__(self, name, annotations):
            self.name, self.annotations = name, annotations

    class Member:
        def __init__(self, node):
            self.node, self.driver_daemon_set = node, "driver-ds"

    class Group:
        def __init__(self, nodes):
            self.id, self.nodes, self.slice_info = nodes[0].name, nodes, None
            self.members = [Member(n) for n in nodes]

        def size(self):
            return len(self.nodes)

    keys = UpgradeKeys(driver_name="nvidia", domain="nvidia.com")
    client = RecordingClient()
    agent = HealthAgent(client, "gpu-node-0", keys,
                        driver_revision="rev-smoke", **PROD)
    report = on_path("agent", agent.run_once)
    require(report.healthy, f"agent report unhealthy: {report.to_json()}")
    require(len(client.patches) == 1, f"patches: {client.patches}")
    node_name, patch = client.patches[0]
    raw = patch[keys.health_report_annotation]
    parsed = HealthReport.from_json(raw)
    require(parsed.healthy and parsed.visible_devices == count,
            f"published report: {raw}")
    for r in parsed.checks[1:]:
        require(r.metrics.get("fused") == 1.0,
                f"agent's published {r.name} is not fused: {raw}")
    group = Group([Node(node_name, {keys.health_report_annotation: raw})])
    verdict = port.NodeReportProber(
        keys, revision_resolver=lambda ds: "rev-smoke"
    ).probe(group)
    require(verdict.healthy, f"NodeReportProber: {verdict.detail}")
    local = on_path("local prober",
                    lambda: port.LocalDeviceProber(**PROD).probe(group))
    require(local.healthy, f"LocalDeviceProber: {local.detail}")
    stats = fused.battery_stats()
    require(stats["fallbacks"] == 0,
            f"fused fallbacks after the agent and local prober: {stats}")
    print(f"[agent] published {len(raw)} bytes; NodeReportProber: "
          f"{verdict.detail}; LocalDeviceProber: {local.detail}")
    print("[launches] main path total: "
          + ", ".join(f"{k} {n}" for k, n in launches.items()), flush=True)

    # -- 7. kernel line, card, result --------------------------------------
    source = str(build.SOURCE.relative_to(HERE))
    replaces = {
        "stream_increment_": "k8s_operator_libs_tpu/health/probes.py:517",
        "verify_stats": "k8s_operator_libs_tpu/health/fused.py:194",
    }
    kernels = [
        dict(
            name=kname, route="cuda", source=source,
            replaces=replaces[kname], launches=launches[kname],
            max_abs_err=max_err[kname], **timing[kname],
        )
        for kname in ("stream_increment_", "verify_stats")
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": count},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
