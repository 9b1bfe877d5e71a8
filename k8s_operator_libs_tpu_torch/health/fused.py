"""Fused probe battery with a topology-keyed warm-up cache.

Counterpart of ``k8s_operator_libs_tpu.health.fused``.  The JAX package
fuses the matmul and HBM chains (and the collectives) into one compiled
XLA program; here the same body is enqueued back to back on each device
with no host synchronisation until the end:

- ``MATMUL_CHAIN_ITERS`` chained ``C ← C @ B`` (bf16, fp32 accumulation,
  ``torch.matmul``);
- ``HBM_CHAIN_ITERS`` launches of the ``stream_increment_`` kernel over
  the ``hbm_mib`` buffer;
- the ``verify_stats`` kernel on C (center 0.5) and on x;
- then one host readback of the six verification scalars.

The cache entry takes the place of XLA's ahead-of-time compile: a miss
builds or loads the kernel library and runs the body once at the key's
shapes (warming cuBLAS and the caching allocator), and reports that time
as ``battery_compile_ms``; a hit reports 0.  The per-check decomposition
and detail strings are the JAX package's, so verdicts read the same.
With two or more devices the ICI checks fail closed until the
collectives are ported.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from k8s_operator_libs_tpu_torch.health.probes import (
    COLLECTIVES_NOT_PORTED,
    CheckResult,
    device_kind,
    exact_bf16_matmul,
    resolve_floors,
)
from k8s_operator_libs_tpu_torch.kernels import (
    load_library,
    stream_increment_,
    verify_stats,
)

# Bump when the battery's math or output layout changes.
BATTERY_VERSION = 1

# Static chain lengths (never timing-derived), as in the JAX package.
MATMUL_CHAIN_ITERS = 8
HBM_CHAIN_ITERS = 8


@dataclass(frozen=True)
class BatteryKey:
    """Cache key: everything that shapes the battery's device work."""

    version: int
    device_kind: str
    device_count: int
    # Per-process device counts, sorted (one process in this slice).
    process_layout: tuple[int, ...]
    matmul_n: int
    hbm_mib: int
    skip_ici: bool


def battery_key(
    devices: Sequence[torch.device],
    matmul_n: int,
    hbm_mib: int,
    skip_ici: bool,
) -> BatteryKey:
    kinds = sorted({device_kind(d) for d in devices})
    return BatteryKey(
        version=BATTERY_VERSION,
        device_kind=",".join(kinds),
        device_count=len(devices),
        process_layout=(len(devices),),
        matmul_n=matmul_n,
        hbm_mib=hbm_mib,
        skip_ici=skip_ici,
    )


_LOCK = threading.Lock()
# Warmed-up batteries: key -> the warm-up's milliseconds.
_CACHE: dict[BatteryKey, float] = {}
_STATS = {
    "compile_cache_hits": 0,
    "compile_cache_misses": 0,
    "fallbacks": 0,
    "last_compile_ms": 0.0,
    "last_execute_ms": 0.0,
}


def battery_stats() -> dict:
    """Snapshot of cache/timing counters (metrics + bench consumers)."""
    with _LOCK:
        stats = dict(_STATS)
        stats["cached_programs"] = float(len(_CACHE))
        return stats


def record_fallback() -> None:
    """Count one fused→unfused fallback (called by run_host_probe)."""
    with _LOCK:
        _STATS["fallbacks"] += 1


def reset_battery_cache() -> None:
    """Drop every cached battery and zero the counters (tests)."""
    with _LOCK:
        _CACHE.clear()
        for k in _STATS:
            _STATS[k] = 0.0 if k.startswith("last_") else 0


def _build_inputs(key: BatteryKey, device: torch.device):
    """(a, b, x) on ``device``: A = 0.5, B = 1/n, x = 0."""
    n = key.matmul_n
    elems = max(1, (key.hbm_mib * 1024 * 1024) // 4)
    a = torch.full((n, n), 0.5, dtype=torch.bfloat16, device=device)
    b = torch.full((n, n), 1.0 / n, dtype=torch.bfloat16, device=device)
    x = torch.zeros(elems, dtype=torch.float32, device=device)
    return a, b, x


def _battery_body(a, b, x) -> torch.Tensor:
    """Enqueue the battery on the inputs' device; returns fp32[6]:
    (C min, C max, max|C − 0.5|, x min, x max, max|x|)."""
    c = a
    for _ in range(MATMUL_CHAIN_ITERS):
        c = torch.matmul(c, b)
    for _ in range(HBM_CHAIN_ITERS):
        stream_increment_(x)
    return torch.cat([verify_stats(c, 0.5), verify_stats(x, 0.0)])


def _prepare(
    key: BatteryKey, devices: Sequence[torch.device]
) -> Optional[float]:
    """Warm up the battery for ``key`` on a cache miss; returns the
    warm-up's milliseconds, or None on a hit.  Warm-up runs outside the
    lock; a racing duplicate warm-up is benign."""
    with _LOCK:
        if key in _CACHE:
            _STATS["compile_cache_hits"] += 1
            return None
    t0 = time.perf_counter()
    if any(d.type == "cuda" for d in devices):
        load_library()
    with exact_bf16_matmul():
        outs = [_battery_body(*_build_inputs(key, d)) for d in devices]
    for out in outs:
        out.tolist()
    compile_ms = (time.perf_counter() - t0) * 1e3
    with _LOCK:
        _CACHE[key] = compile_ms
        _STATS["compile_cache_misses"] += 1
        _STATS["last_compile_ms"] = compile_ms
    return compile_ms


def run_fused_battery(
    devices: Sequence[torch.device],
    matmul_n: int = 4096,
    hbm_mib: int = 1024,
    skip_ici: bool = False,
) -> list[CheckResult]:
    """Run the fused battery; returns the mxu_matmul / hbm_bandwidth
    (+ ici_allreduce / ici_ring) CheckResults.

    Device enumeration stays with the caller (run_host_probe).  Raises on
    any infrastructure fault; the caller falls back to the unfused
    battery."""
    devs = list(devices)
    n_dev = len(devs)
    if matmul_n & (matmul_n - 1):
        raise ValueError(
            f"fused battery needs power-of-two matmul_n, got {matmul_n}"
        )
    key = battery_key(devs, matmul_n, hbm_mib, skip_ici)
    compile_ms = _prepare(key, devs)

    inputs = [_build_inputs(key, d) for d in devs]
    t0 = time.perf_counter()
    with exact_bf16_matmul():
        outs = [_battery_body(*inp) for inp in inputs]
    # Reading the verification scalars back is the synchronisation.
    rows = [out.tolist() for out in outs]
    execute_ms = (time.perf_counter() - t0) * 1e3
    with _LOCK:
        _STATS["last_execute_ms"] = execute_ms
    mm_rows = [(i, r[2]) for i, r in enumerate(rows)]
    hbm_min_rows = [(i, r[3]) for i, r in enumerate(rows)]
    hbm_max_rows = [(i, r[4]) for i, r in enumerate(rows)]

    battery_metrics = {
        "fused": 1.0,
        "battery_cache_hit": 1.0 if compile_ms is None else 0.0,
        "battery_compile_ms": compile_ms or 0.0,
        "battery_execute_ms": execute_ms,
    }
    floors = resolve_floors(key.device_kind)
    if floors is not None:
        battery_metrics["floor_mxu_tflops"] = floors.mxu_tflops
        battery_metrics["floor_hbm_gbps"] = floors.hbm_gbps
        battery_metrics["floor_ici_busbw_gbps"] = floors.ici_busbw_gbps

    def result(
        name: str, ok: bool, detail: str, extra: Optional[dict] = None
    ) -> CheckResult:
        metrics = dict(battery_metrics)
        if extra:
            metrics.update(extra)
        return CheckResult(name, ok, execute_ms, detail, metrics)

    results: list[CheckResult] = []

    # -- mxu_matmul: every device's chain must be exactly 0.5 ----------
    bad_mm = [(row, err) for row, err in mm_rows if err != 0.0]
    if bad_mm:
        row, err = bad_mm[0]
        results.append(
            result(
                "mxu_matmul",
                False,
                f"matmul result mismatch on device {row}: max abs error "
                f"{err} from expected 0.5 over {MATMUL_CHAIN_ITERS} "
                f"chained matmuls (n={matmul_n})",
                {"n": float(matmul_n), "iters": float(MATMUL_CHAIN_ITERS)},
            )
        )
    else:
        results.append(
            result(
                "mxu_matmul",
                True,
                f"exact over {MATMUL_CHAIN_ITERS} chained matmuls "
                f"(n={matmul_n}) on {len(mm_rows)} device(s); fused "
                "battery (throughput unmeasured)",
                {"n": float(matmul_n), "iters": float(MATMUL_CHAIN_ITERS)},
            )
        )

    # -- hbm_bandwidth: chained value == iteration count everywhere ----
    expected = float(HBM_CHAIN_ITERS)
    bad_hbm = [
        (row, v)
        for rows_ in (hbm_min_rows, hbm_max_rows)
        for row, v in rows_
        if v != expected
    ]
    if bad_hbm:
        row, got = bad_hbm[0]
        results.append(
            result(
                "hbm_bandwidth",
                False,
                f"stream content mismatch on device {row}: expected "
                f"{expected}, got {got}",
                {"mib": float(hbm_mib), "iters": float(HBM_CHAIN_ITERS)},
            )
        )
    else:
        results.append(
            result(
                "hbm_bandwidth",
                True,
                f"content exact over {hbm_mib} MiB x {HBM_CHAIN_ITERS} "
                "passes; fused battery (bandwidth unmeasured)",
                {"mib": float(hbm_mib), "iters": float(HBM_CHAIN_ITERS)},
            )
        )

    if skip_ici:
        return results

    if n_dev < 2:
        results.append(
            result(
                "ici_allreduce",
                True,
                "single device; no ICI to probe",
                {"devices": float(n_dev)},
            )
        )
        results.append(
            result(
                "ici_ring",
                True,
                "single device; no links to probe",
                {"devices": float(n_dev)},
            )
        )
    else:
        for name in ("ici_allreduce", "ici_ring"):
            results.append(
                result(
                    name,
                    False,
                    f"{n_dev} devices: {COLLECTIVES_NOT_PORTED}",
                    {"devices": float(n_dev)},
                )
            )
    return results
