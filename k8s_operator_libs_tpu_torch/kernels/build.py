"""Build and load the battery's CUDA kernels.

``battery_kernels.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_kernels/`` beside the package, named by a hash of the
source so an edited source is rebuilt, and loaded with ``ctypes``.
Nothing here runs at import: the CPU tests import every module and have
no ``nvcc``.
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

SOURCE = Path(__file__).resolve().parent / "csrc" / "battery_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
# Seconds the last load_library() call that built or loaded spent.
last_build_s = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME)")


def _compile(target: Path) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    # Compile to a private name and rename: concurrent first users never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(
        suffix=".so", prefix=".tmp-", dir=target.parent
    )
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True,
            text=True,
            timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {SOURCE.name}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, sz, i, f = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_float
    lib.battery_threads_per_block.argtypes = []
    lib.battery_threads_per_block.restype = i
    lib.battery_stream_increment.argtypes = [vp, sz, i, i, vp]
    lib.battery_stream_increment.restype = i
    for name in ("battery_verify_stats_f32", "battery_verify_stats_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, sz, f, vp, vp, i, i, vp]
        fn.restype = i
    lib.battery_error_string.argtypes = [i]
    lib.battery_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """The kernel library, compiled on first use in this checkout."""
    global _LIB, last_build_s
    with _LOCK:
        if _LIB is None:
            t0 = time.perf_counter()
            digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
            target = BUILD_DIR / f"libbattery_kernels-{digest}.so"
            if not target.exists():
                _compile(target)
            _LIB = _bind(ctypes.CDLL(str(target)))
            last_build_s = time.perf_counter() - t0
        return _LIB


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code:
        msg = lib.battery_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
