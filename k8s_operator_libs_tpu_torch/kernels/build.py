"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` has a plain C interface.  Each source is compiled
with ``nvcc`` for ``sm_90a`` into an object file, all of them at once
(one ``nvcc`` process per source), and the objects are linked into one
shared library named by a hash of all the sources and flags, so an
edited source is rebuilt, and loaded with ``ctypes``.

Where the library lives (``kernel_dir()``):

- ``$K8S_TPU_TORCH_KERNEL_DIR``, when set (the port's image sets it to
  the directory its build stage filled);
- in a checkout of the repository, ``build/torch_kernels/`` beside the
  package, which git ignores;
- for an installed package, a per-user cache:
  ``$XDG_CACHE_HOME/k8s_operator_libs_tpu_torch/kernels``, else
  ``~/.cache/k8s_operator_libs_tpu_torch/kernels``.  Nothing is written
  into the install itself.

``load_library()`` compiles there on first use when the library is
missing.  ``python -m k8s_operator_libs_tpu_torch.kernels.build``
compiles it without loading it (``nvcc``, no GPU): an image builds it so,
and its containers then load it by the same hash and need no ``nvcc``.
Without the library and without ``nvcc`` a launch raises, naming the
directory; there is no fallback.  Nothing here runs at import: the CPU
tests import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
# The directory that holds the package: a checkout's root, or
# site-packages for an installed package.
ROOT = Path(__file__).resolve().parents[2]
# A checkout's kernel directory.
BUILD_DIR = ROOT / "build" / "torch_kernels"
KERNEL_DIR_ENV = "K8S_TPU_TORCH_KERNEL_DIR"
# The build entry: ``python -m`` this module.
ENTRY = "k8s_operator_libs_tpu_torch.kernels.build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
NVCC_TIMEOUT_S = 600

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
# Seconds the last load_library() call that built or loaded spent.
last_build_s = 0.0


def _nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME`` (or
    ``$CUDA_PATH``), else, when neither is set, under the toolkit's
    default ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    nvcc = Path(home or "/usr/local/cuda") / "bin" / "nvcc"
    if nvcc.is_file():
        return str(nvcc)
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME)")


def in_checkout() -> bool:
    """Whether the package lies in a checkout of this repository (its
    ``pyproject.toml`` beside it), not in an install."""
    return (ROOT / "pyproject.toml").is_file()


def kernel_dir() -> Path:
    """The directory the kernel library is built into and loaded from."""
    configured = os.environ.get(KERNEL_DIR_ENV)
    if configured:
        return Path(configured)
    if in_checkout():
        return BUILD_DIR
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "k8s_operator_libs_tpu_torch" / "kernels"


def library_path() -> Path:
    """The library of these sources and flags in ``kernel_dir()``."""
    return kernel_dir() / f"libport_kernels-{_digest()}.so"


def _run_all(commands: list[list[str]], what: list[str]) -> None:
    """Run the commands concurrently; raise with the output of every one
    that failed."""
    procs = [
        subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        for cmd in commands
    ]
    failures = []
    try:
        for proc, name in zip(procs, what):
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                failures.append(
                    f"nvcc failed ({proc.returncode}) on {name}:\n{out}"
                )
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failures:
        raise RuntimeError("\n".join(failures))


def _compile(target: Path) -> None:
    try:
        nvcc = _nvcc()
    except RuntimeError as e:
        raise RuntimeError(
            f"the kernel library {target.name} is not in {target.parent} "
            f"and cannot be built there: {e}; build it with `python -m "
            f"{ENTRY}` where nvcc is, with {KERNEL_DIR_ENV} naming that "
            "directory"
        ) from None
    target.parent.mkdir(parents=True, exist_ok=True)
    # Build in a private directory and rename the library into place:
    # concurrent first users never load a half-written library.
    with tempfile.TemporaryDirectory(prefix=".tmp-", dir=target.parent) as tmp:
        objects = [Path(tmp) / f"{src.stem}.o" for src in SOURCES]
        _run_all(
            [
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(SOURCES, objects)
            ],
            [src.name for src in SOURCES],
        )
        lib = Path(tmp) / target.name
        _run_all(
            [[nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
              *map(str, objects)]],
            ["the link"],
        )
        os.replace(lib, target)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # The shared headers (``*.cuh``) count too: an edited header rebuilds.
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, sz, i, f = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    lib.battery_threads_per_block.argtypes = []
    lib.battery_threads_per_block.restype = i
    lib.battery_verify_scratch_floats.argtypes = [i]
    lib.battery_verify_scratch_floats.restype = i
    lib.battery_stream_increment.argtypes = [vp, sz, i, i, vp]
    lib.battery_stream_increment.restype = i
    for name in ("battery_verify_stats_f32", "battery_verify_stats_bf16",
                 "battery_stream_increment_verify_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, sz, f, vp, vp, i, i, vp]
        fn.restype = i
    lib.battery_error_string.argtypes = [i]
    lib.battery_error_string.restype = ctypes.c_char_p
    lib.attention_block_f32.argtypes = [
        vp, vp, vp, vp, vp, vp,  # q, k, v, num, m, l
        i, i, i, i, i,  # B, Sq, Sk, H, D
        ll, ll, i, f,  # q_offset, k_offset, causal, scale
        i, vp,  # device, stream
    ]
    lib.attention_block_f32.restype = i
    lib.attention_block_merge_f32.argtypes = [
        vp, vp, vp, vp, vp, vp,  # acc_num, acc_m, acc_l, q, k, v
        i, i, i, i, i,  # B, Sq, Sk, H, D
        ll, ll, i, f,  # q_offset, k_offset, causal, scale
        i, vp,  # device, stream
    ]
    lib.attention_block_merge_f32.restype = i
    lib.collective_peer_enable.argtypes = [i, i]
    lib.collective_peer_enable.restype = i
    lib.collective_peer_reduce.argtypes = [
        vp, i, sz, sz, vp, f,  # packed src[k] as uint64, k, off, len, dst,
        # divisor
        i, vp,  # device, stream
    ]
    lib.collective_peer_reduce.restype = i
    lib.collective_peer_gather.argtypes = [
        vp, i, sz, sz, vp, i, vp,  # packed src[k], off[k], len[k] as
        # uint64; k, rows, pitch, dst, device, stream
    ]
    lib.collective_peer_gather.restype = i
    lib.collective_plan_create.argtypes = [
        i, i, ctypes.POINTER(i), ctypes.POINTER(sz), ctypes.POINTER(sz),
        sz, sz, ctypes.POINTER(vp),  # kind, n, devices, begin, end, rows,
        # pitch, plan
    ]
    lib.collective_plan_create.restype = i
    # plan, the round's pointers (in[n], out[n], streams[n] as uint64,
    # packed), divisor
    lib.collective_plan_launch.argtypes = [vp, vp, f]
    lib.collective_plan_launch.restype = i
    lib.collective_plan_nodes.argtypes = [
        vp, ctypes.POINTER(i), ctypes.POINTER(i),
    ]
    lib.collective_plan_nodes.restype = None
    return lib


def build_library() -> Path:
    """Compile the library into ``kernel_dir()`` unless it is there
    already, and return its path.  Needs ``nvcc``, not a GPU."""
    target = library_path()
    if not target.exists():
        _compile(target)
    return target


def load_library() -> ctypes.CDLL:
    """The kernel library, compiled on first use when it is missing."""
    global _LIB, last_build_s
    if _LIB is not None:  # every launch asks: no lock once loaded
        return _LIB
    with _LOCK:
        if _LIB is None:
            t0 = time.perf_counter()
            _LIB = _bind(ctypes.CDLL(str(build_library())))
            last_build_s = time.perf_counter() - t0
        return _LIB


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code:
        msg = lib.battery_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def main() -> int:
    """Compile the library (``build_library``) and print its path."""
    t0 = time.perf_counter()
    path = build_library()
    print(f"{path} ({time.perf_counter() - t0:.2f} s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
