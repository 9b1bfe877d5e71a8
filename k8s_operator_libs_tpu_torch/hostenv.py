"""Host environment for the port's child processes, and a CUDA preflight.

Counterpart of ``k8s_operator_libs_tpu.hostenv``, whose job is to keep
device work off an accelerator plugin whose backend init hangs instead
of raising.  A CUDA host has the same failure: a GPU that fell off the
bus (or a driver mid-upgrade) can hang ``cuInit`` in every process that
touches the card.  Two parts answer it here:

- :func:`cpu_child_env` — the environment of a child process that the
  caller ASKED to run on the CPU (the tests, ``entry.dryrun_multichip(...,
  device="cpu")``): ``CUDA_VISIBLE_DEVICES=""`` hides every card, so the
  child cannot reach one even by accident;
- :func:`probe_cuda_init` — CUDA init, one small kernel and a
  synchronize in a child process under a timeout.  The child is killed
  on expiry, so a hung init costs the caller ``timeout_s`` and a failure
  record, never the caller itself.

The JAX package's ``pin_current_process_to_cpu`` has no counterpart.  A
JAX plugin registers its backend when the interpreter starts, so that
function has to undo a registration; CUDA registers nothing at
interpreter start (PyTorch initialises it lazily, at the first call that
needs the card), so a running interpreter has nothing to unpin.

Nothing here falls back to the CPU when the card fails: a caller that
needs the card reports the failure (the bench prints its line with
``value`` 0.0 and exits non-zero).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Optional

# What the preflight child runs: init, one kernel, a synchronize, and the
# card's name and count on its last line.
_PROBE_SOURCE = (
    "import json, torch\n"
    "torch.cuda.init()\n"
    "x = torch.ones(1, device='cuda').add_(1)\n"
    "torch.cuda.synchronize()\n"
    "if x.item() != 2.0:\n"
    "    raise SystemExit(f'ones(1) + 1 gave {x.item()} on the card')\n"
    "print(json.dumps({'device_name': torch.cuda.get_device_name(0),\n"
    "                  'count': torch.cuda.device_count()}))\n"
)


def cpu_child_env(
    base_env: Optional[dict] = None,
    *,
    prepend_pythonpath: Optional[str] = None,
) -> dict:
    """A copy of ``base_env`` (default ``os.environ``) in which a child
    interpreter sees no CUDA device.

    ``prepend_pythonpath``: a path the child must import from (the
    checkout's root), put first on ``PYTHONPATH``."""
    env = dict(os.environ if base_env is None else base_env)
    env["CUDA_VISIBLE_DEVICES"] = ""
    if prepend_pythonpath:
        rest = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
        env["PYTHONPATH"] = os.pathsep.join([prepend_pythonpath] + rest)
    return env


def probe_cuda_init(timeout_s: float = 120.0) -> dict:
    """Initialise CUDA, run ``torch.ones(1, device="cuda").add_(1)`` and
    synchronize, in a child process killed after ``timeout_s``.

    Returns ``{ok, device_name, count, seconds, error}``: ``device_name``
    and ``count`` are the child's ``torch.cuda.get_device_name(0)`` and
    ``torch.cuda.device_count()`` (None and 0 on failure), ``seconds``
    the child's wall time and ``error`` None or why it failed."""
    result = {"ok": False, "device_name": None, "count": 0,
              "seconds": 0.0, "error": None}
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-c", _PROBE_SOURCE],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        result["seconds"] = time.monotonic() - t0
        result["error"] = (
            f"CUDA init did not finish within {timeout_s:g} s; the child "
            "was killed"
        )
        return result
    result["seconds"] = time.monotonic() - t0
    lines = out.strip().splitlines()
    if proc.returncode != 0 or not lines:
        tail = (err.strip().splitlines() or ["no output"])[-1]
        result["error"] = f"CUDA init failed (rc {proc.returncode}): {tail}"
        return result
    found = json.loads(lines[-1])
    result.update(ok=True, device_name=found["device_name"],
                  count=int(found["count"]))
    return result
