"""Entry points: the canary's loss on one device, and a multi-member dry run.

Counterpart of the JAX package's ``__graft_entry__.py``.

``entry()`` returns the canary transformer's loss (the workload the
upgrade framework protects) at a tiny configuration, with its example
arguments, on the card.

``dryrun_multichip(n)`` runs one real step of the sharded train step
(tp over heads and hidden, dp over the batch, the collectives written
out on the port's kernels) and the ring-attention soak over ``n``
members, at tiny shapes.  It runs in a child process under a watchdog:
a card whose CUDA init hangs costs the caller ``timeout_s`` and a
failure line, never the caller itself.  ``device="cuda"`` puts the
members on the host's cards in turn (``cuda:0`` repeated on a one-card
host, as an HGX board's members are rehearsed on one card);
``device="cpu"`` must be asked for and runs the child with no CUDA
device visible.

Run ``python -m k8s_operator_libs_tpu_torch.entry [n]`` for both on the
card.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from k8s_operator_libs_tpu_torch.hostenv import cpu_child_env
from k8s_operator_libs_tpu_torch.health.probes import cuda_devices
from k8s_operator_libs_tpu_torch.workloads.canary import (
    CanaryConfig,
    init_params,
    loss_fn,
    make_mesh,
    make_sharded_train_step,
)

_REPO_ROOT = str(Path(__file__).resolve().parents[1])

# The JAX entry's configuration (``__graft_entry__._TINY``).
_TINY = CanaryConfig(
    vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128, seq_len=32,
    batch=8,
)


def _batch(cfg: CanaryConfig, device) -> torch.Tensor:
    """The JAX entry's batch: tokens from ``default_rng(0)``."""
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (cfg.batch, cfg.seq_len + 1), dtype=np.int32
    )
    return torch.from_numpy(tokens).to(device)


def entry(device=None):
    """``(fn, args)``: ``fn(params, batch)`` is the canary's loss at the
    tiny configuration, ``args`` its parameters (from a
    ``torch.Generator`` seeded 0) and batch.  ``device=None`` means the
    first CUDA device; without one this raises."""
    dev = torch.device(device) if device is not None else cuda_devices()[0]
    cfg = _TINY
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(gen, cfg)

    def fn(params, batch):
        return loss_fn(params, batch, cfg)

    return fn, (params, _batch(cfg, dev))


def members_of(n: int, device: str) -> list[torch.device]:
    """``n`` members of a board: the host's cards in turn (``device``
    "cuda"), or the CPU ``n`` times ("cpu")."""
    if device == "cpu":
        return [torch.device("cpu")] * n
    cards = cuda_devices()
    return [cards[i % len(cards)] for i in range(n)]


def dryrun_multichip(
    n_devices: int, timeout_s: float = 600.0, device: str = "cuda"
) -> None:
    """One sharded train step and the ring-attention soak over
    ``n_devices`` members in a child process under a watchdog.  Prints
    the child's line; raises ``RuntimeError`` after printing a failure
    line when the child fails or outlives ``timeout_s``."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    cmd = [
        sys.executable, "-u", "-c",
        "from k8s_operator_libs_tpu_torch import entry; "
        f"entry._dryrun_body({int(n_devices)}, {device!r})",
    ]
    if device == "cpu":
        env = cpu_child_env(prepend_pythonpath=_REPO_ROOT)
    else:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_REPO_ROOT, env.get("PYTHONPATH")) if p
        )
    try:
        proc = subprocess.run(
            cmd, env=env, cwd=_REPO_ROOT, timeout=timeout_s,
            capture_output=True, text=True,
        )
    except subprocess.TimeoutExpired as exc:
        tails = [
            (s.decode(errors="replace") if isinstance(s, bytes) else s or "")
            [-2000:] for s in (exc.stdout, exc.stderr)
        ]
        print(f"dryrun_multichip: FAILED: the watchdog killed the child "
              f"after {timeout_s:g} s; stdout tail {tails[0]!r}; stderr "
              f"tail {tails[1]!r}", flush=True)
        raise RuntimeError(
            f"dryrun_multichip watchdog expired after {timeout_s:g} s"
        ) from exc
    if proc.stdout:
        sys.stdout.write(proc.stdout)
        sys.stdout.flush()
    if proc.returncode != 0:
        print(f"dryrun_multichip: FAILED: the child exited rc "
              f"{proc.returncode}; stderr tail: {proc.stderr[-2000:]}",
              flush=True)
        raise RuntimeError(
            f"dryrun_multichip child failed rc={proc.returncode}"
        )


def _dryrun_body(n_devices: int, device: str) -> None:
    """The dry run itself; runs in the child."""
    from k8s_operator_libs_tpu_torch.workloads.ring_attention import (
        ring_attention_soak,
    )

    members = members_of(n_devices, device)
    cfg = _TINY
    mesh = make_mesh(members)
    sharded = make_sharded_train_step(mesh, cfg)
    gen = torch.Generator(device=members[0])
    gen.manual_seed(0)
    params = sharded.shard_params(init_params(gen, cfg))
    opt_state = [sharded.opt.init(p) for p in params]
    batch = sharded.shard_batch(_batch(cfg, members[0]))
    params, opt_state, loss = sharded.step(params, opt_state, batch)
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    soak = ring_attention_soak(
        members, seq_per_device=32, batch=1, heads=2, head_dim=16
    )
    if not soak["ok"]:
        raise RuntimeError(f"ring attention mismatch: {soak}")
    print(f"dryrun_multichip: mesh={mesh.shape} members on "
          f"{sorted({str(m) for m in members})} loss={loss:.4f} "
          f"ring_attention seq={soak.get('global_seq')} max_err="
          f"{soak['max_err']:.2e} ok", flush=True)


if __name__ == "__main__":
    fn, args = entry()
    print(f"entry: loss={float(fn(*args)):.4f} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
