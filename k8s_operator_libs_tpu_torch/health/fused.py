"""Fused probe battery with a topology-keyed warm-up cache.

Counterpart of ``k8s_operator_libs_tpu.health.fused``.  The JAX package
fuses the matmul and HBM chains (and the collectives) into one compiled
XLA program; here the same body is enqueued back to back on each device
with no host synchronisation until the end:

- ``MATMUL_CHAIN_ITERS`` chained ``C ← C @ B`` (bf16, fp32 accumulation,
  ``torch.matmul``);
- ``HBM_CHAIN_ITERS`` passes of the ``stream_increment_`` kernel over
  the ``hbm_mib`` buffer, the last one ``stream_increment_verify_``,
  which also returns the check of x (min, max, max|x|) without reading
  it again;
- the ``verify_stats`` kernel on C (center 0.5);
- with two or more devices, ``PSUM_ROUNDS`` chained all-reduces
  ``s ← all_reduce(s) / n`` of the ramp (member i holds i+1, so every
  round after the first gives (n+1)/2 exactly) and one +1 ring shift,
  the host's collectives of
  :mod:`~k8s_operator_libs_tpu_torch.kernels.collectives` (kernel K4);
- then one host readback per member of its verification scalars, its
  first all-reduced element and its ring value.

The cache entry takes the place of XLA's ahead-of-time compile: a miss
builds or loads the kernel library and runs the body once at the key's
shapes (warming cuBLAS and the caching allocator), and reports that time
as ``battery_compile_ms``; a hit reports 0.  The per-check decomposition
and detail strings are the JAX package's, so verdicts read the same.

:func:`run_network_path_checks` is the network-path artifact gate's
battery: the cross-host world's size and the ring at the smallest sizes.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from k8s_operator_libs_tpu_torch.health.probes import (
    CheckResult,
    device_kind,
    distributed_world_size,
    exact_bf16_matmul,
    resolve_floors,
)
from k8s_operator_libs_tpu_torch.kernels import (
    collectives,
    load_library,
    stream_increment_,
    stream_increment_verify_,
    verify_stats,
)
from k8s_operator_libs_tpu_torch.layers import count, layer_span

# Bump when the battery's math or output layout changes.
BATTERY_VERSION = 1

# Static chain lengths (never timing-derived), as in the JAX package.
MATMUL_CHAIN_ITERS = 8
HBM_CHAIN_ITERS = 8
PSUM_ROUNDS = 4


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
    allreduce_elems: int
    skip_ici: bool


def battery_key(
    devices: Sequence[torch.device],
    matmul_n: int,
    hbm_mib: int,
    allreduce_elems: int,
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
        allreduce_elems=allreduce_elems,
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


def _build_inputs(key: BatteryKey, device: torch.device, member: int):
    """Member ``member``'s (a, b, x, ramp, ring) on ``device``: A = 0.5,
    B = 1/n, x = 0, the ramp's constant member+1 and the ring's value
    member."""
    n = key.matmul_n
    elems = max(1, (key.hbm_mib * 1024 * 1024) // 4)
    a = torch.full((n, n), 0.5, dtype=torch.bfloat16, device=device)
    b = torch.full((n, n), 1.0 / n, dtype=torch.bfloat16, device=device)
    x = torch.zeros(elems, dtype=torch.float32, device=device)
    ramp = torch.full((key.allreduce_elems,), float(member + 1),
                      device=device)
    ring = torch.full((1,), float(member), device=device)
    return a, b, x, ramp, ring


def _battery_body(a, b, x) -> torch.Tensor:
    """Enqueue the battery on the inputs' device; returns fp32[6]:
    (C min, C max, max|C − 0.5|, x min, x max, max|x|)."""
    c = a
    for _ in range(MATMUL_CHAIN_ITERS):
        c = torch.matmul(c, b)
    for _ in range(HBM_CHAIN_ITERS - 1):
        stream_increment_(x)
    return torch.cat([verify_stats(c, 0.5), stream_increment_verify_(x, 0.0)])


def _run(key: BatteryKey, inputs: list) -> list[list[float]]:
    """Enqueue every member's body, then the collectives, and read back
    each member's row: the six body scalars, its first all-reduced
    element and its ring value."""
    count("fused.batteries")
    with layer_span("fused.enqueue"), exact_bf16_matmul():
        stats = [_battery_body(a, b, x) for a, b, x, _, _ in inputs]
    s = [inp[3] for inp in inputs]
    ring = [inp[4] for inp in inputs]
    n_dev = len(inputs)
    if not key.skip_ici and n_dev >= 2:
        # Chained rounds s ← all_reduce(s) / n: (n+1)/2 after the first,
        # a fixed point after; every value is exact in fp32.
        with layer_span("fused.collectives"):
            for _ in range(PSUM_ROUNDS):
                s = collectives.all_reduce(s, divisor=float(n_dev))
            ring = collectives.ring_shift(ring)
    # One readback per member is the synchronisation.
    with layer_span("fused.readback"):
        return [
            torch.cat([st, si[:1], ri]).tolist()
            for st, si, ri in zip(stats, s, ring)
        ]


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
    _run(key, [_build_inputs(key, d, i) for i, d in enumerate(devices)])
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
    allreduce_elems: int = 1 << 20,
    skip_ici: bool = False,
) -> list[CheckResult]:
    """Run the fused battery; returns the mxu_matmul / hbm_bandwidth
    (+ ici_allreduce / ici_ring) CheckResults.

    Device enumeration stays with the caller (run_host_probe).  Raises on
    any infrastructure fault; the caller falls back to the unfused
    battery."""
    devs = list(devices)
    if matmul_n & (matmul_n - 1):
        raise ValueError(
            f"fused battery needs power-of-two matmul_n, got {matmul_n}"
        )
    key = battery_key(devs, matmul_n, hbm_mib, allreduce_elems, skip_ici)
    with layer_span("fused.prepare"):
        compile_ms = _prepare(key, devs)
    with layer_span("fused.inputs"):
        inputs = [_build_inputs(key, d, i) for i, d in enumerate(devs)]
    # The battery's one timing: its layer spans split this interval.
    t0 = time.perf_counter()
    rows = _run(key, inputs)
    execute_ms = (time.perf_counter() - t0) * 1e3
    with _LOCK:
        _STATS["last_execute_ms"] = execute_ms
    with layer_span("fused.checks"):
        return _checks(key, rows, compile_ms, execute_ms)


def _checks(
    key: BatteryKey,
    rows: list,
    compile_ms: Optional[float],
    execute_ms: float,
) -> list[CheckResult]:
    """The battery's CheckResults from its members' rows."""
    n_dev = key.device_count
    matmul_n, hbm_mib, skip_ici = key.matmul_n, key.hbm_mib, key.skip_ici
    mm_rows = [(i, r[2]) for i, r in enumerate(rows)]
    hbm_min_rows = [(i, r[3]) for i, r in enumerate(rows)]
    hbm_max_rows = [(i, r[4]) for i, r in enumerate(rows)]
    psum_rows = [(i, r[6]) for i, r in enumerate(rows)]
    ring_rows = [(i, r[7]) for i, r in enumerate(rows)]

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

    # -- ici_allreduce ------------------------------------------------
    if n_dev < 2:
        results.append(
            result(
                "ici_allreduce",
                True,
                "single device; no ICI to probe",
                {"devices": float(n_dev)},
            )
        )
    else:
        want = (n_dev + 1) / 2.0  # fixed point of the chained all-reduce
        bad_psum = [(row, v) for row, v in psum_rows if v != want]
        if bad_psum:
            row, got = bad_psum[0]
            results.append(
                result(
                    "ici_allreduce",
                    False,
                    f"psum mismatch on device {row}: expected {want}, "
                    f"got {got}",
                    {"devices": float(n_dev), "iters": float(PSUM_ROUNDS)},
                )
            )
        else:
            results.append(
                result(
                    "ici_allreduce",
                    True,
                    f"psum over {n_dev} devices exact ({PSUM_ROUNDS} "
                    "rounds); fused battery (bus bandwidth unmeasured)",
                    {"devices": float(n_dev), "iters": float(PSUM_ROUNDS)},
                )
            )

    # -- ici_ring -----------------------------------------------------
    if n_dev < 2:
        results.append(
            result(
                "ici_ring",
                True,
                "single device; no links to probe",
                {"devices": float(n_dev)},
            )
        )
    else:
        bad_ring = [
            (row, v) for row, v in ring_rows if v != float((row - 1) % n_dev)
        ]
        if bad_ring:
            row, got = bad_ring[0]
            results.append(
                result(
                    "ici_ring",
                    False,
                    f"link {(row - 1) % n_dev}->{row} delivered {got}, "
                    f"expected {float((row - 1) % n_dev)}",
                    {
                        "devices": float(n_dev),
                        "bad_links": float(len(bad_ring)),
                    },
                )
            )
        else:
            results.append(
                result(
                    "ici_ring",
                    True,
                    f"all {len(ring_rows)} locally-received ring link(s) "
                    f"verified ({n_dev}-device ring)",
                    {"devices": float(n_dev)},
                )
            )
    return results


# Problem sizes of the network-path battery: the smallest fused battery
# that still carries a value over every link of the host's ring.  It runs
# once per gated artifact step inside the drain window, so it must cost
# milliseconds warm; its sizes give it a warm-up-cache key of its own.
NETWORK_MATMUL_N = 128
NETWORK_HBM_MIB = 1
NETWORK_ALLREDUCE_ELEMS = 8


def run_network_path_checks(
    devices: Sequence[torch.device],
    expected_processes: Optional[int] = None,
) -> list[CheckResult]:
    """Network-path checks gating the networking artifact's step:
    ``dcn_reachability`` and ``ici_link_state``.

    - **dcn_reachability**: every expected process (host) is in the
      ``torch.distributed`` world (1 when there is none); a host that
      cannot be enumerated cannot be reached.  No device work.
    - **ici_link_state**: the fused battery's ring at network-probe
      sizes: every link of the host's ring carries one value and the
      receiver checks it exactly.

    Raises on infrastructure faults; the caller treats that as a gate
    not passed, never as a pass."""
    devs = list(devices)
    results: list[CheckResult] = []

    t0 = time.perf_counter()
    visible = distributed_world_size()
    want = expected_processes if expected_processes else visible
    dcn_ms = (time.perf_counter() - t0) * 1e3
    metrics = {"expected": float(want), "visible": float(visible)}
    if visible >= want:
        results.append(
            CheckResult(
                "dcn_reachability", True, dcn_ms,
                f"all {want} expected process(es) visible over DCN "
                f"({visible} enumerated)",
                metrics,
            )
        )
    else:
        results.append(
            CheckResult(
                "dcn_reachability", False, dcn_ms,
                f"only {visible} of {want} expected process(es) visible "
                "over DCN",
                metrics,
            )
        )

    ring = [
        r
        for r in run_fused_battery(
            devs,
            matmul_n=NETWORK_MATMUL_N,
            hbm_mib=NETWORK_HBM_MIB,
            allreduce_elems=NETWORK_ALLREDUCE_ELEMS,
        )
        if r.name == "ici_ring"
    ]
    if ring:
        src = ring[0]
        results.append(
            CheckResult(
                "ici_link_state", src.ok, src.latency_ms, src.detail,
                dict(src.metrics),
            )
        )
    else:  # the battery always rings here; stay fail-closed regardless
        results.append(
            CheckResult(
                "ici_link_state", False, 0.0,
                "fused battery returned no ring verdict", {},
            )
        )
    return results
