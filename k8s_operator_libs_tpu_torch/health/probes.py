"""PyTorch/CUDA health-probe computations.

Counterpart of ``k8s_operator_libs_tpu.health.probes`` on CUDA devices.
Each probe runs device work with an analytically known result and checks
it, so a probe failure distinguishes "the math came out wrong" (broken
GPU or driver) from "the program didn't run" (device lost: an exception
the caller handles).  The checks keep the JAX package's names and
messages, so reports from either package read the same:

- **device enumeration**: the driver loaded and every GPU is visible;
- **mxu_matmul**: the tensor cores multiply correctly (bf16 inputs, fp32
  accumulation, chained so every element stays exactly 0.5), checked
  over the whole matrix by the ``verify_stats`` kernel;
- **hbm_bandwidth**: the ``stream_increment_`` kernel moves the whole
  buffer once per pass at a sane rate and every value equals the pass
  count;
- **ici_allreduce / ici_ring**: the host's collectives
  (:mod:`~k8s_operator_libs_tpu_torch.kernels.collectives`, kernel K4)
  over every device, one process driving them all as the JAX package's
  local mesh does: the all-reduce of a ramp must give n(n+1)/2 exactly,
  with its sustained bus bandwidth, and a +1 ring shift must leave
  member i holding i-1, naming the bad link otherwise; vacuous on one
  device, as in the JAX package;
- **ici_ring_attention** (the deep probe): ring attention over every
  device (:mod:`~k8s_operator_libs_tpu_torch.workloads.ring_attention`,
  block kernel K3) against single-device full attention; vacuous on one
  device;
- **dcn_reachability / dcn_collective**: TCP connects to peer hosts, and
  a ``torch.distributed`` all-reduce across the hosts' processes that
  must carry every expected DCN group's contribution.

Devices are explicit ``torch.device``s.  With ``devices=None`` the
entry points enumerate the CUDA devices and never fall back to the CPU;
tests pass ``[torch.device("cpu")]``, where the kernels' plain versions
run.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.fleet.profiles import generation_profile
from k8s_operator_libs_tpu_torch.hw import chip_spec, mfu
from k8s_operator_libs_tpu_torch.kernels import (
    collectives,
    stream_increment_,
    verify_stats,
)
from k8s_operator_libs_tpu_torch.layers import layer_span

logger = get_logger(__name__)


@dataclass
class CheckResult:
    """Outcome of one probe."""

    name: str
    ok: bool
    latency_ms: float = 0.0
    detail: str = ""
    # Free-form numeric side channel (e.g. tflops, gbps) for metrics/bench.
    metrics: dict[str, float] = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "ok": self.ok,
            "latency_ms": round(self.latency_ms, 3),
            "detail": self.detail,
            "metrics": {k: round(v, 3) for k, v in self.metrics.items()},
        }

    @staticmethod
    def from_dict(d: dict) -> "CheckResult":
        return CheckResult(
            name=d.get("name", ""),
            ok=bool(d.get("ok", False)),
            latency_ms=float(d.get("latency_ms", 0.0)),
            detail=d.get("detail", ""),
            metrics=dict(d.get("metrics", {})),
        )


@dataclass(frozen=True)
class GenerationFloors:
    """The probe gates one generation is judged against, resolved from
    the fleet ``GenerationProfile`` registry."""

    generation: str
    mxu_tflops: float
    hbm_gbps: float
    ici_busbw_gbps: float
    allreduce_latency_ms: float


def resolve_floors(device_kind: str) -> Optional[GenerationFloors]:
    """Per-generation probe floors for a device name or GKE accelerator
    label; None when the generation is unknown (CPU test devices)."""
    profile = generation_profile(device_kind)
    if profile is None:
        return None
    return GenerationFloors(
        generation=profile.name,
        mxu_tflops=profile.mxu_floor(),
        hbm_gbps=profile.hbm_floor(),
        ici_busbw_gbps=profile.ici_floor(),
        allreduce_latency_ms=profile.allreduce_latency_ceiling_ms,
    )


def device_kind(device: torch.device) -> str:
    """The device's kind string: the CUDA device name, else the device
    type ("cpu", as JAX names its CPU devices)."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def cuda_devices() -> list[torch.device]:
    """Every visible CUDA device; raises RuntimeError when there is none
    (the driver did not load), so callers report a failed enumeration
    instead of silently probing the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible (torch.cuda.is_available() is False)"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@contextlib.contextmanager
def exact_bf16_matmul():
    """Keep cuBLAS from reducing split-K partial sums in bf16 (its
    default), which could break the exact 0.5 invariant of the chained
    matmul; restores the previous setting."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = prev


# Sustained measurement window: a single-launch timing is dominated by
# launch and readback cost, so probes time the slope between two loop
# lengths instead (see _timed_sustained).
def _min_time_from_env() -> float:
    raw = os.environ.get("K8S_TPU_PROBE_MIN_TIME_S", "")
    try:
        return float(raw) if raw else 0.05
    except ValueError:
        logger.warning(
            "ignoring malformed K8S_TPU_PROBE_MIN_TIME_S=%r "
            "(want seconds as a float); using 0.05",
            raw,
        )
        return 0.05


DEFAULT_MIN_TIME_S = _min_time_from_env()
_MAX_SUSTAINED_ITERS = 2048
# Initial k1 is capped low (fast probes stay fast); the differential
# check escalates toward _MAX_SUSTAINED_ITERS//4 only when the measured
# slope doesn't hold enough device work to trust.
_INIT_SUSTAINED_ITERS = 256

# Injectable for unit tests.
_perf_counter = time.perf_counter


def _median(xs: list) -> float:
    xs = sorted(xs)
    mid = len(xs) // 2
    return xs[mid] if len(xs) % 2 else (xs[mid - 1] + xs[mid]) / 2


class InconclusiveTiming(RuntimeError):
    """Sustained-rate measurement failed to produce a valid slope.

    Not a health failure: the computation ran and its content is
    verifiable (``out``/``applied`` carry the final chained value and
    application count); only the throughput figure is missing."""

    def __init__(self, msg: str, out: object, applied: int) -> None:
        super().__init__(msg)
        self.out = out
        self.applied = applied


def _sync_readback(out) -> None:
    """Wait for ``out`` (a tensor, or one per member of a collective) by
    reading one element of each back to the host: a copy cannot complete
    before the kernels that produce it, so every member is synchronised."""
    for t in out if isinstance(out, (list, tuple)) else (out,):
        t.reshape(-1)[:1].item()


def _timed(fn, *args) -> tuple[float, object]:
    """Run ``fn`` once as a warm-up, then time one synchronised call."""
    out = fn(*args)
    _sync_readback(out)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync_readback(out)
    return (time.perf_counter() - t0) * 1e3, out


def _members_numpy(out) -> np.ndarray:
    """[n, elems] on the host from one tensor per member."""
    return np.stack([t.reshape(-1).cpu().numpy() for t in out])


def _timed_sustained(
    fn,
    args: tuple,
    min_time_s: float = DEFAULT_MIN_TIME_S,
    chain: bool = False,
    max_iters: int = _MAX_SUSTAINED_ITERS,
    deterministic: bool = False,
) -> tuple[float, object, int]:
    """(per-iteration latency ms, last output, chained iterations).

    The same estimator as the JAX package: the slope between a k1-long
    and a 4·k1-long run (each ending in one readback) cancels every fixed
    cost; the median of three slope pairs rejects one contaminated pair;
    an untrusted slope escalates the run length up to the cap.
    ``chain=True`` feeds each output back as the first argument, so the
    returned iteration count is the number of applications on the
    chained value.  ``deterministic`` pins the schedule to constants."""
    state = {"out": None, "applied": 0}

    def run(iters: int, start) -> float:
        cur = start
        out = None
        t0 = _perf_counter()
        for _ in range(iters):
            out = fn(*cur)
            if chain:
                cur = (out, *args[1:])
        _sync_readback(out)
        elapsed = _perf_counter() - t0
        state["out"] = out
        state["applied"] += iters
        return elapsed

    def start_args():
        return (state["out"], *args[1:]) if chain else args

    # Warm-up.
    state["out"] = fn(*args)
    _sync_readback(state["out"])
    state["applied"] = 1
    # Pilot run to size k1 so the short run holds >= min_time_s of work.
    pilot_s = run(2, start_args())
    if deterministic:
        k1 = 16
    else:
        per_est = max(pilot_s / 2, 1e-7)
        init_cap = min(_INIT_SUSTAINED_ITERS, max_iters // 4)
        k1 = max(16, min(init_cap, int(min_time_s / per_est) + 1))
    k2 = 4 * k1
    # One k1-long warm run; its time re-sizes k1 (the pilot's estimate
    # is dominated by fixed launch and readback cost).
    warm_s = run(k1, start_args())
    if not deterministic:
        per_warm = max(warm_s / k1, 1e-9)
        resized = int(min_time_s / per_warm) + 1
        if resized > k1:
            k1 = min(max_iters // 4, resized)
            k2 = 4 * k1
    # A slope is trusted only when the k2−k1 differential holds at least
    # min_time_s and the three slopes agree within 1.5x; otherwise the
    # run length escalates.  At the cap, valid slopes are accepted as
    # they are; with no valid pair the measurement is inconclusive.
    slopes: list[float] = []
    pairs: list[tuple[float, float]] = []
    while True:
        slopes.clear()
        pairs.clear()
        diffs: list[float] = []
        for _ in range(3):
            t1 = run(k1, start_args())
            t2 = run(k2, start_args())
            pairs.append((t1, t2))
            if t2 > t1:
                slopes.append((t2 - t1) / (k2 - k1))
                diffs.append(t2 - t1)
        at_cap = deterministic or k1 >= max_iters // 4
        if slopes:
            med_diff = _median(diffs)
            consistent = (
                len(slopes) == 3 and max(slopes) <= 1.5 * min(slopes)
            )
            if at_cap or (med_diff >= min_time_s and consistent):
                break
            needed = int(k1 * min_time_s / max(med_diff, 1e-9)) + 1
            k1 = min(max_iters // 4, max(k1 * 4, needed))
        elif at_cap:
            raise InconclusiveTiming(
                f"unstable timing: {k1}- vs {k2}-iteration runs were "
                f"non-monotonic in all {len(pairs)} attempts ({pairs}); "
                "cannot measure sustained rate",
                state["out"],
                state["applied"],
            )
        else:
            k1 = min(k1 * 4, max_iters // 4)
        k2 = 4 * k1
    return _median(slopes) * 1e3, state["out"], state["applied"]


def device_inventory(
    devices: Optional[Sequence[torch.device]] = None,
    expected_devices: int = 0,
) -> CheckResult:
    """Enumerate devices: driver loaded, GPUs visible.

    ``expected_devices`` > 0 additionally asserts the count."""
    t0 = time.perf_counter()
    try:
        devs = list(devices) if devices is not None else cuda_devices()
    except RuntimeError as e:  # no CUDA at all — driver not loaded
        return CheckResult(
            "device_enumeration", False, 0.0, f"device enumeration failed: {e}"
        )
    latency_ms = (time.perf_counter() - t0) * 1e3
    kinds = sorted({device_kind(d) for d in devs})
    ok = len(devs) > 0
    detail = f"{len(devs)} device(s): {', '.join(kinds)}"
    if expected_devices and len(devs) != expected_devices:
        ok = False
        detail += f" (expected {expected_devices})"
    return CheckResult(
        "device_enumeration",
        ok,
        latency_ms,
        detail,
        {"devices": float(len(devs))},
    )


def matmul_probe(
    device: Optional[torch.device] = None,
    n: int = 4096,
    dtype: torch.dtype = torch.bfloat16,
    min_time_s: float = DEFAULT_MIN_TIME_S,
    max_iters: int = _MAX_SUSTAINED_ITERS,
) -> CheckResult:
    """Tensor-core correctness + sustained throughput with an analytic
    result.

    A is filled with ``0.5`` and B with ``1/n``, so every element of
    ``A @ B`` is exactly 0.5 for power-of-two ``n`` with fp32
    accumulation, and the product can be chained ``C ← C @ B``.  The
    chained output is checked over the whole matrix by ``verify_stats``;
    any deviation is a compute fault, not rounding.  Reports sustained
    TFLOPS and MFU against the card's spec."""
    if n & (n - 1):
        return CheckResult(
            "mxu_matmul", False, 0.0,
            f"matmul_probe needs power-of-two n for exact chained "
            f"verification, got {n}",
        )
    if device is None:
        device = cuda_devices()[0]
    a_val, b_val = 0.5, 1.0 / n
    expected = np.float32(a_val)  # invariant under each chained matmul

    inconclusive = ""
    with exact_bf16_matmul():
        try:
            a = torch.full((n, n), a_val, dtype=dtype, device=device)
            b = torch.full((n, n), b_val, dtype=dtype, device=device)
            latency_ms, out, iters = _timed_sustained(
                torch.matmul, (a, b), min_time_s=min_time_s, chain=True,
                max_iters=max_iters,
            )
            got_min, got_max, err = verify_stats(out, a_val).tolist()
        except InconclusiveTiming as e:
            latency_ms, out, iters = 0.0, e.out, e.applied
            got_min, got_max, err = verify_stats(out, a_val).tolist()
            inconclusive = str(e)
        except Exception as e:  # noqa: BLE001 — any device fault fails the check
            return CheckResult("mxu_matmul", False, 0.0, f"matmul failed: {e}")
    if err != 0.0:
        return CheckResult(
            "mxu_matmul", False, latency_ms,
            f"matmul result mismatch: expected {expected}, got "
            f"[{np.float32(got_min)}, {np.float32(got_max)}]",
            {"n": float(n), "iters": float(iters)},
        )
    if inconclusive:
        return CheckResult(
            "mxu_matmul", True, 0.0,
            f"exact over {iters} chained matmuls (n={n}); throughput "
            f"unmeasured: {inconclusive}",
            {"n": float(n), "iters": float(iters), "timing_inconclusive": 1.0},
        )
    tflops = (2.0 * n * n * n) / (latency_ms * 1e-3) / 1e12
    metrics = {"tflops": tflops, "n": float(n), "iters": float(iters)}
    mfu_frac = mfu(tflops, device_kind(device))
    if mfu_frac is not None:
        if mfu_frac > 1.0:
            # Physically impossible: residual timing contamination.  An
            # over-spec figure is never reported; correctness stands.
            return CheckResult(
                "mxu_matmul", True, 0.0,
                f"exact over {iters} chained matmuls (n={n}); measured "
                f"{tflops:.1f} TFLOPS exceeds the chip's peak — timing "
                "unreliable, throughput unmeasured",
                {
                    "n": float(n),
                    "iters": float(iters),
                    "timing_inconclusive": 1.0,
                },
            )
        metrics["mfu"] = mfu_frac
    return CheckResult(
        "mxu_matmul",
        True,
        latency_ms,
        f"exact; {tflops:.1f} TFLOPS sustained over {iters} chained "
        f"matmuls (n={n})",
        metrics,
    )


def hbm_bandwidth_probe(
    device: Optional[torch.device] = None,
    mib: int = 1024,
    min_time_s: float = DEFAULT_MIN_TIME_S,
    max_iters: int = _MAX_SUSTAINED_ITERS,
) -> CheckResult:
    """Sustained HBM stream: chained ``x += 1`` by ``stream_increment_``
    over a ``mib``-MiB fp32 buffer (default 1 GiB, far beyond the 50 MB
    L2), one launch per pass.  The final value is the exact pass count."""
    if device is None:
        device = cuda_devices()[0]
    elems = (mib * 1024 * 1024) // 4

    inconclusive = ""
    try:
        x = torch.zeros(elems, dtype=torch.float32, device=device)
        latency_ms, out, iters = _timed_sustained(
            stream_increment_, (x,), min_time_s=min_time_s, chain=True,
            max_iters=max_iters,
        )
        sample = out[:8].cpu().numpy()
    except InconclusiveTiming as e:
        latency_ms, out, iters = 0.0, e.out, e.applied
        sample = out[:8].cpu().numpy()
        inconclusive = str(e)
    except Exception as e:  # noqa: BLE001
        return CheckResult("hbm_bandwidth", False, 0.0, f"stream failed: {e}")
    expected = float(iters)
    if not np.all(sample == expected):
        return CheckResult(
            "hbm_bandwidth", False, latency_ms,
            f"stream content mismatch: expected {expected}, got "
            f"{sample[:4]}",
            {"mib": float(mib), "iters": float(iters)},
        )
    if inconclusive:
        return CheckResult(
            "hbm_bandwidth", True, 0.0,
            f"content exact over {mib} MiB x {iters} passes; bandwidth "
            f"unmeasured: {inconclusive}",
            {
                "mib": float(mib),
                "iters": float(iters),
                "timing_inconclusive": 1.0,
            },
        )
    nbytes = elems * 4 * 2  # read + write per pass
    gbps = nbytes / (latency_ms * 1e-3) / 1e9
    spec = chip_spec(device_kind(device))
    if spec is not None and gbps > 1.05 * spec.hbm_gbps:
        # Over physical bandwidth: fiction, not a measurement.
        return CheckResult(
            "hbm_bandwidth", True, 0.0,
            f"content exact over {mib} MiB x {iters} passes; measured "
            f"{gbps:.1f} GB/s exceeds the chip's {spec.hbm_gbps:.0f} GB/s "
            "spec — timing unreliable, bandwidth unmeasured",
            {
                "mib": float(mib),
                "iters": float(iters),
                "timing_inconclusive": 1.0,
            },
        )
    return CheckResult(
        "hbm_bandwidth",
        True,
        latency_ms,
        f"{gbps:.1f} GB/s sustained over {mib} MiB x {iters} passes",
        {"gbps": gbps, "mib": float(mib), "iters": float(iters)},
    )


def ici_allreduce_probe(
    devices: Optional[Sequence[torch.device]] = None,
    per_device_elems: int = 1 << 20,
    min_time_s: float = DEFAULT_MIN_TIME_S,
    max_iters: int = _MAX_SUSTAINED_ITERS,
) -> CheckResult:
    """All-reduce across every device.

    Member ``i`` contributes the constant ``i+1``, so every element of
    every member's result must equal ``n(n+1)/2`` exactly.  Bus bandwidth
    is measured over a sustained run (the same input re-reduced back to
    back), with the JAX package's formula.  The rounds are one persistent
    all-reduce (``collectives.all_reduce_init``) into outputs made once,
    as nccl-tests time a collective: a round costs the host one library
    call, so the run times the collective and not the allocation of each
    round's outputs."""
    devs = list(devices) if devices is not None else cuda_devices()
    n = len(devs)
    if n < 2:
        return CheckResult(
            "ici_allreduce", True, 0.0, "single device; no ICI to probe",
            {"devices": float(n)},
        )
    expected = n * (n + 1) / 2.0
    inconclusive = ""
    try:
        # The ramp: member i holds the constant i+1.
        shards = [
            torch.full((per_device_elems,), float(i + 1), device=d)
            for i, d in enumerate(devs)
        ]
        latency_ms, out, iters = _timed_sustained(
            collectives.all_reduce_init(shards), (),
            min_time_s=min_time_s, max_iters=max_iters,
        )
        got = _members_numpy(out)
    except InconclusiveTiming as e:
        latency_ms, out, iters = 0.0, e.out, e.applied
        got = _members_numpy(out)
        inconclusive = str(e)
    except Exception as e:  # noqa: BLE001 — any device fault fails the check
        return CheckResult(
            "ici_allreduce", False, 0.0, f"all-reduce failed: {e}"
        )
    if not np.all(got == expected):
        return CheckResult(
            "ici_allreduce", False, latency_ms,
            f"psum mismatch: expected {expected}, got "
            f"[{got.min()}, {got.max()}]",
            {"devices": float(n), "iters": float(iters)},
        )
    if inconclusive:
        return CheckResult(
            "ici_allreduce", True, 0.0,
            f"psum over {n} devices exact ({iters} rounds); bus bandwidth "
            f"unmeasured: {inconclusive}",
            {
                "devices": float(n),
                "iters": float(iters),
                "timing_inconclusive": 1.0,
            },
        )
    # A ring all-reduce moves 2(n-1)/n of the buffer over each link.
    shard_bytes = per_device_elems * 4
    busbw = (2.0 * (n - 1) / n) * shard_bytes / (latency_ms * 1e-3) / 1e9
    return CheckResult(
        "ici_allreduce",
        True,
        latency_ms,
        f"psum over {n} devices exact; {busbw:.1f} GB/s bus bandwidth "
        f"sustained over {iters} rounds",
        {"devices": float(n), "busbw_gbps": busbw, "iters": float(iters)},
    )


def ici_ring_probe(
    devices: Optional[Sequence[torch.device]] = None,
) -> CheckResult:
    """Per-link verification: shift every member's value to its +1 ring
    neighbour; member ``i`` must then hold ``i-1 (mod n)``.  A failure
    names the first broken link."""
    devs = list(devices) if devices is not None else cuda_devices()
    n = len(devs)
    if n < 2:
        return CheckResult(
            "ici_ring", True, 0.0, "single device; no links to probe",
            {"devices": float(n)},
        )
    try:
        shards = [
            torch.full((1,), float(i), device=d) for i, d in enumerate(devs)
        ]
        latency_ms, out = _timed(lambda x: collectives.ring_shift(x), shards)
        bad: list[tuple[int, float]] = []
        checked = 0
        for row, vals in enumerate(_members_numpy(out)):
            for got_v in vals:
                checked += 1
                if got_v != float((row - 1) % n):
                    bad.append((row, float(got_v)))
    except Exception as e:  # noqa: BLE001 — any device fault fails the check
        return CheckResult("ici_ring", False, 0.0, f"ppermute failed: {e}")
    if bad:
        first, got_v = bad[0]
        return CheckResult(
            "ici_ring",
            False,
            latency_ms,
            f"link {(first - 1) % n}->{first} delivered {got_v}, "
            f"expected {float((first - 1) % n)}",
            {"devices": float(n), "bad_links": float(len(bad))},
        )
    return CheckResult(
        "ici_ring",
        True,
        latency_ms,
        f"all {checked} locally-received ring link(s) verified "
        f"({n}-device ring)",
        {"devices": float(n)},
    )


def ici_ring_attention_probe(
    devices: Optional[Sequence[torch.device]] = None,
    seq_per_device: int = 128,
) -> CheckResult:
    """Deep link soak: ring attention over every device, one process
    driving them all, checked against single-device full attention.
    Vacuous on one device, as in the JAX package."""
    from k8s_operator_libs_tpu_torch.workloads.ring_attention import (
        ring_attention_soak,
    )

    devs = list(devices) if devices is not None else cuda_devices()
    if len(devs) < 2:
        return CheckResult(
            "ici_ring_attention", True, 0.0,
            "single device; no ring to soak",
            {"devices": float(len(devs))},
        )
    try:
        res = ring_attention_soak(devs, seq_per_device=seq_per_device)
    except Exception as e:  # noqa: BLE001 — any device fault fails the check
        return CheckResult(
            "ici_ring_attention", False, 0.0, f"ring attention failed: {e}"
        )
    return CheckResult(
        "ici_ring_attention",
        bool(res["ok"]),
        float(res["latency_ms"]),
        (
            f"seq {res['global_seq']} over {res['devices']} devices, "
            f"max err {res['max_err']:.2e}"
        ),
        {
            "devices": float(res["devices"]),
            "link_gbps": float(res["link_gbps"]),
            "global_seq": float(res["global_seq"]),
        },
    )


# Default TPU runtime gRPC port (what peer-slice hosts listen on).
DCN_DEFAULT_PORT = 8471


def dcn_reachability_probe(
    peers: Sequence[str], timeout_s: float = 2.0
) -> CheckResult:
    """TCP reachability to peer hosts across the data-center network.

    ``peers`` are "host[:port]"; reachability is a TCP connect."""

    def parse(peer: str) -> tuple[str, int]:
        # "host", "host:port", "[v6]:port", or a bare IPv6 literal.
        if peer.startswith("["):
            host, _, rest = peer[1:].partition("]")
            port = rest.lstrip(":")
        elif peer.count(":") > 1:
            host, port = peer, ""
        else:
            host, _, port = peer.partition(":")
        return host, int(port or DCN_DEFAULT_PORT)

    def connect(peer: str) -> Optional[str]:
        try:
            with socket.create_connection(parse(peer), timeout=timeout_s):
                return None
        except (OSError, ValueError) as e:
            return f"{peer} ({e})"

    t0 = time.perf_counter()
    # Concurrent connects: total probe time stays about one timeout even
    # with many unreachable peers.
    with ThreadPoolExecutor(max_workers=min(32, max(1, len(peers)))) as pool:
        failures = list(pool.map(connect, peers))
    unreachable = [f for f in failures if f is not None]
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    reachable = len(peers) - len(unreachable)
    detail = f"{reachable}/{len(peers)} DCN peer(s) reachable"
    if unreachable:
        detail += ": unreachable " + "; ".join(unreachable)
    return CheckResult(
        "dcn_reachability",
        not unreachable,
        elapsed_ms,
        detail,
        metrics={"peers": float(len(peers)), "reachable": float(reachable)},
    )


def distributed_world_size() -> int:
    """Processes in the ``torch.distributed`` world: the default process
    group's size once it is initialized, else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def dcn_collective_probe(
    devices: Optional[Sequence[torch.device]] = None,
    dcn_group: str = "",
    expected_groups: Optional[Sequence[str]] = None,
) -> CheckResult:
    """The cross-host all-reduce gate, stronger than
    :func:`dcn_reachability_probe`: a port can answer while the collective
    transport is broken, and only a completed all-reduce that carries
    every peer group's contribution proves a multi-node job can step.

    Each process (one per host, driving ``devices``) builds an fp32
    one-hot over the sorted expected DCN group names at its own group's
    index, times ``len(devices)``, on ``devices[0]``, and all-reduces it
    (SUM) over the default ``torch.distributed`` world (NCCL on the card,
    which needs the CUDA tensor; gloo in tests).  Entry g then counts the
    devices whose host claims group g, as the JAX package's psum over the
    global device rows does.  The verdict: every expected group
    contributed.  There is no hand kernel: the traffic crosses the
    network, where the JAX package leaves it to XLA's collective.  Every
    process must call this once, at the same point of its battery; a
    peer that never enters it makes the collective raise once the
    process group's timeout passes, which fails the check."""
    try:
        devs = list(devices) if devices is not None else cuda_devices()
    except RuntimeError as e:
        return CheckResult(
            "dcn_collective", False, 0.0, f"device enumeration failed: {e}"
        )
    if not dcn_group:
        return CheckResult(
            "dcn_collective", False, 0.0,
            "no DCN group configured for this host (HEALTH_DCN_GROUP)",
        )
    groups = sorted(set(expected_groups or ()) | {dcn_group})
    if len(groups) < 2:
        return CheckResult(
            "dcn_collective", False, 0.0,
            f"need >=2 expected DCN groups, have {groups} — a single-group "
            "collective proves nothing about the DCN",
        )
    n_processes = distributed_world_size()
    if n_processes < 2:
        return CheckResult(
            "dcn_collective", False, 0.0,
            f"distributed world spans {n_processes} process(es); the "
            "cross-slice world never formed",
            metrics={"processes": float(n_processes)},
        )
    import torch.distributed as dist

    t0 = time.perf_counter()
    try:
        onehot = torch.zeros(len(groups), dtype=torch.float32,
                             device=devs[0])
        onehot[groups.index(dcn_group)] = float(len(devs))
        dist.all_reduce(onehot, op=dist.ReduceOp.SUM)
        counts = onehot.tolist()
    except Exception as e:  # noqa: BLE001 — a broken DCN raises mid-collective
        return CheckResult(
            "dcn_collective", False,
            (time.perf_counter() - t0) * 1e3,
            f"cross-slice psum failed: {e}",
        )
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    contributions = {g: int(c) for g, c in zip(groups, counts)}
    missing = [g for g, c in contributions.items() if c < 1]
    detail = "cross-slice psum completed; contributions: " + " ".join(
        f"{g}={c}" for g, c in contributions.items()
    )
    if missing:
        detail = (
            "DCN collective missing contribution(s) from: "
            + ", ".join(missing) + "; " + detail
        )
    return CheckResult(
        "dcn_collective",
        not missing,
        elapsed_ms,
        detail,
        metrics={
            "groups": float(len(groups)),
            "participating": float(len(groups) - len(missing)),
            "processes": float(n_processes),
        },
    )


def fused_battery_enabled() -> bool:
    """Fused battery default: on unless K8S_TPU_FUSED_BATTERY disables
    it (the unfused path is the always-available fallback)."""
    raw = os.environ.get("K8S_TPU_FUSED_BATTERY", "1").strip().lower()
    return raw not in ("0", "false", "no", "off")


def run_host_probe(
    devices: Optional[Sequence[torch.device]] = None,
    expected_devices: int = 0,
    matmul_n: int = 4096,
    hbm_mib: int = 1024,
    allreduce_elems: int = 1 << 20,
    skip_ici: bool = False,
    deep: bool = False,
    min_time_s: float = DEFAULT_MIN_TIME_S,
    max_iters: int = _MAX_SUSTAINED_ITERS,
    dcn_peers: Optional[Sequence[str]] = None,
    dcn_group: str = "",
    dcn_expected_groups: Optional[Sequence[str]] = None,
    on_check=None,
    fused: Optional[bool] = None,
) -> list[CheckResult]:
    """Run the full probe battery; returns every check's result.

    Same contract as the JAX package's ``run_host_probe``: production
    defaults (n=4096 bf16 matmuls, a 1 GiB stream, a 4 MiB all-reduce
    ramp per device), fail fast on
    enumeration, then the fused battery (``health.fused``) with the
    unfused probes as fallback, stamping the same ``battery_*`` parity
    keys either way, then the DCN checks; ``on_check`` is called as each
    check completes.  With ``dcn_expected_groups`` the battery ends in the
    cross-host all-reduce, the only collective that crosses processes, so
    every host enters it exactly once a call whatever its timings.
    ``devices=None`` means every CUDA device; without one the result is a
    single failing ``device_enumeration`` check."""
    results: list[CheckResult] = []

    def add(check: CheckResult) -> None:
        results.append(check)
        if on_check is not None:
            on_check(check)

    try:
        devs = list(devices) if devices is not None else cuda_devices()
    except RuntimeError as e:  # no CUDA at all — driver not loaded
        add(
            CheckResult(
                "device_enumeration",
                False,
                0.0,
                f"device enumeration failed: {e}",
            )
        )
        return results
    with layer_span("battery.inventory"):
        add(device_inventory(devs, expected_devices))
    if not devs:
        return results
    if fused is None:
        fused = fused_battery_enabled()
    fused_checks: Optional[list[CheckResult]] = None
    if fused:
        from k8s_operator_libs_tpu_torch.health import fused as fused_mod

        try:
            with layer_span("battery.fused"):
                fused_checks = fused_mod.run_fused_battery(
                    devs,
                    matmul_n=matmul_n,
                    hbm_mib=hbm_mib,
                    allreduce_elems=allreduce_elems,
                    skip_ici=skip_ici,
                )
        except Exception as e:  # noqa: BLE001 — unfused is the fallback
            fused_mod.record_fallback()
            logger.warning(
                "fused probe battery failed (%s); falling back to the "
                "unfused probes",
                e,
            )
            fused_checks = None
    if fused_checks is not None:
        for check in fused_checks:
            add(check)
    else:
        probe_dev = devs[0]
        battery_checks: list[CheckResult] = []
        t0 = time.perf_counter()
        battery_checks.append(
            matmul_probe(
                probe_dev,
                n=matmul_n,
                min_time_s=min_time_s,
                max_iters=max_iters,
            )
        )
        battery_checks.append(
            hbm_bandwidth_probe(
                probe_dev,
                mib=hbm_mib,
                min_time_s=min_time_s,
                max_iters=max_iters,
            )
        )
        if not skip_ici:
            battery_checks.append(
                ici_allreduce_probe(
                    devs,
                    per_device_elems=allreduce_elems,
                    min_time_s=min_time_s,
                    max_iters=max_iters,
                )
            )
            battery_checks.append(ici_ring_probe(devs))
        execute_ms = (time.perf_counter() - t0) * 1e3
        # Telemetry parity with the fused battery: the same battery_*
        # keys (``fused: 0.0``) and the generation's floor metadata.
        parity = {
            "fused": 0.0,
            "battery_cache_hit": 0.0,
            "battery_compile_ms": 0.0,
            "battery_execute_ms": execute_ms,
        }
        kinds = sorted({device_kind(d) for d in devs})
        floors = resolve_floors(",".join(kinds))
        if floors is not None:
            parity["floor_mxu_tflops"] = floors.mxu_tflops
            parity["floor_hbm_gbps"] = floors.hbm_gbps
            parity["floor_ici_busbw_gbps"] = floors.ici_busbw_gbps
        for check in battery_checks:
            check.metrics.update(parity)
            add(check)
    if not skip_ici and deep:
        with layer_span("battery.deep"):
            add(ici_ring_attention_probe(devs))
    if dcn_peers:
        add(dcn_reachability_probe(dcn_peers))
    if dcn_expected_groups:
        add(
            dcn_collective_probe(
                devs, dcn_group=dcn_group,
                expected_groups=dcn_expected_groups,
            )
        )
    return results
