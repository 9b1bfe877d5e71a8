"""The port's host environment and entry points, on the CPU.

``cpu_child_env`` hides every card from a child; ``probe_cuda_init``
fails with an error on a machine without CUDA and kills a child that
outlives its timeout.  ``entry()``'s loss equals the JAX package's
``__graft_entry__.entry()`` loss on the same weights (crossed through
numpy) and batch, within ``test_torch_canary.py``'s 1e-3 loss limit, and
``dryrun_multichip(4, device="cpu")`` completes.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from k8s_operator_libs_tpu_torch import entry as tentry  # noqa: E402
from k8s_operator_libs_tpu_torch import hostenv  # noqa: E402
from k8s_operator_libs_tpu_torch.workloads import canary as tc  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import __graft_entry__ as jentry  # noqa: E402

LOSS_ATOL = 1e-3  # test_torch_canary.py's loss limit


def test_cpu_child_env_hides_the_cards_and_keeps_the_rest():
    base = {"CUDA_VISIBLE_DEVICES": "0,1", "PYTHONPATH": "/a:/b",
            "HOME": "/home/x", "OTHER": "1"}
    env = hostenv.cpu_child_env(base, prepend_pythonpath="/repo")
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert env["PYTHONPATH"] == os.pathsep.join(["/repo", "/a", "/b"])
    assert {k: env[k] for k in ("HOME", "OTHER")} == {"HOME": "/home/x",
                                                       "OTHER": "1"}
    assert base["CUDA_VISIBLE_DEVICES"] == "0,1"  # the input is untouched
    assert hostenv.cpu_child_env({})["CUDA_VISIBLE_DEVICES"] == ""
    assert "PYTHONPATH" not in hostenv.cpu_child_env({})


def test_probe_cuda_init_fails_without_a_card():
    result = hostenv.probe_cuda_init(timeout_s=120.0)
    assert result["ok"] is False
    assert result["device_name"] is None and result["count"] == 0
    assert result["error"].startswith("CUDA init failed (rc ")
    assert result["seconds"] > 0


def test_probe_cuda_init_kills_a_hung_child(tmp_path, monkeypatch):
    pid_file = tmp_path / "pid"
    monkeypatch.setattr(hostenv, "_PROBE_SOURCE", (
        "import os, time\n"
        f"open({str(pid_file)!r}, 'w').write(str(os.getpid()))\n"
        "time.sleep(600)\n"
    ))
    result = hostenv.probe_cuda_init(timeout_s=2.0)
    assert result["ok"] is False
    assert "did not finish within 2 s; the child was killed" in (
        result["error"])
    assert 2.0 <= result["seconds"] < 30.0
    with pytest.raises(ProcessLookupError):
        os.kill(int(pid_file.read_text()), 0)


def test_entry_loss_matches_the_jax_entry():
    jfn, (jparams, jbatch) = jentry.entry()
    want = float(jfn(jparams, jbatch))
    fn, (params, batch) = tentry.entry(device="cpu")
    assert np.array_equal(batch.numpy(), np.asarray(jbatch))
    crossed = tc.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   torch.device("cpu"))
    got = float(fn(crossed, batch))
    assert abs(got - want) <= LOSS_ATOL, (got, want)
    # The port's own weights (torch.Generator) give a loss near ln(vocab).
    own = float(fn(*(params, batch)))
    assert abs(own - np.log(64)) < 0.5


def test_entry_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()


def test_dryrun_multichip_on_the_cpu(capsys):
    tentry.dryrun_multichip(4, timeout_s=300.0, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip: mesh={'dp': 2, 'tp': 2} members on ['cpu']" in (
        out)
    assert out.rstrip().endswith(" ok")


def test_dryrun_multichip_reports_a_failing_child(capsys):
    # Five members cannot hold _TINY's 4 heads: the child raises.
    with pytest.raises(RuntimeError, match="child failed rc=1"):
        tentry.dryrun_multichip(5, timeout_s=300.0, device="cpu")
    assert "dryrun_multichip: FAILED" in capsys.readouterr().out
    with pytest.raises(ValueError):
        tentry.dryrun_multichip(4, device="tpu")
