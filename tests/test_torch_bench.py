"""The port's roll bench on the CPU, at small sizes.

A roll of the four GPU-labelled nodes, with a tiny canary on the CPU and
small batteries over 8 CPU members, must complete with every node
``upgrade-done`` and one node out at a time, and its attribution check
must name its node.  The downtime counts the open interval when the roll
did not finish; the emitted line stays within 2 KB and parses, whatever
the summary holds; and without a card the bench prints its line with
``value`` 0.0 and exits non-zero, never running on the CPU.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from k8s_operator_libs_tpu_torch import bench  # noqa: E402
from k8s_operator_libs_tpu_torch import bench_io  # noqa: E402
from k8s_operator_libs_tpu_torch.workloads.canary import (  # noqa: E402
    CanaryConfig,
    CanaryRunner,
)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TINY = CanaryConfig(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
                    seq_len=16, batch=4)
SMALL = bench.BatterySize(matmul_n=64, hbm_mib=1, allreduce_elems=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Six pytest workers share the host: one intra-op thread each.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_sequential_roll_completes_and_names_the_missing_report():
    canary = CanaryRunner(TINY, device=CPU)
    canary.run_step()  # warm-up, as the bench's
    result = bench.roll([CPU] * bench.GPUS_PER_NODE, canary,
                        threading.Lock(), pipeline=False, attribution=True,
                        sizes=(SMALL, SMALL))
    assert result["complete"], result.get("final_states")
    assert result["attribution"] == {
        "ok": True, "victim": "pool-1",
        "detail": "no health report from node pool-1",
    }
    finals, pool0 = {}, {}
    for t, name, state in result["transitions"]:
        finals[name] = state
        if name == "pool-0":
            pool0[state] = t
    assert finals == {f"pool-{i}": "upgrade-done" for i in range(4)}
    assert result["max_concurrent_unavailable"] == 1
    assert all(w is not None and w > 0
               for w in result["node_windows_s"].values())
    assert result["canary_error"] is None
    # pool-0 is cordoned from before wait-for-jobs-required until after
    # uncordon-required is reached: the canary's pause, which its
    # longest gap covers.
    paused = pool0["uncordon-required"] - pool0["wait-for-jobs-required"]
    assert 0 < paused <= result["downtime_s"] < 60
    assert math.isfinite(result["downtime_s"])
    assert 0.0 <= result["lock"]["wait_in_longest_gap_s"] <= (
        result["downtime_s"])
    assert result["batteries"] > bench.N_NODES


def test_pipelined_roll_completes():
    canary = CanaryRunner(TINY, device=CPU)
    canary.run_step()
    result = bench.roll([CPU] * bench.GPUS_PER_NODE, canary,
                        threading.Lock(), pipeline=True, attribution=False,
                        sizes=(SMALL, SMALL))
    assert result["complete"], result.get("final_states")
    assert result["attribution"] is None


@pytest.mark.parametrize(
    "steps, until, want",
    [
        # Finished: the longest closed gap, closed by step 3.
        ([1.0, 1.5, 2.0, 5.0, 5.5], None, (3.0, 3)),
        # Unfinished: the open interval since the last step counts.
        ([1.0, 1.5, 2.0], 9.0, (7.0, -1)),
        # Unfinished, but a closed gap is longer still.
        ([1.0, 6.0, 6.5], 7.0, (5.0, 1)),
        # No step at all: the whole window.
        ([], 4.0, (4.0, -1)),
        ([], None, (0.0, -1)),
        # The wait before the first step counts.
        ([3.0, 3.5], None, (3.0, 0)),
    ],
)
def test_longest_gap(steps, until, want):
    assert bench.longest_gap(steps, 0.0, until) == want


def test_node_windows():
    transitions = [
        (0.1, "a", "upgrade-required"), (0.2, "a", "cordon-required"),
        (1.2, "a", "upgrade-done"), (0.1, "b", "upgrade-required"),
        (1.3, "b", "drain-required"),
    ]
    assert bench.node_windows(transitions) == {"a": 1.0, "b": None}


@pytest.mark.parametrize(
    "summary",
    [
        {"complete": True, "x": 1.5},
        {"complete": False, "error": ["Traceback " * 50] * 100},
        {"complete": False, "error": {"nested": list(range(5000))},
         "backend": {"k": "v" * 5000}, "details_file": "p" * 5000},
        {"complete": True, **{f"k{i}": "v" * 40 for i in range(200)}},
    ],
    ids=["small", "list_error", "nested_everything", "many_keys"],
)
def test_emitted_line_is_capped_and_parses(summary, capsys, tmp_path):
    path = tmp_path / "details.json"
    line = bench_io.emit(bench.METRIC_NAME * 30, 1.25, "s", 96.0, summary,
                         full_details={"all": summary},
                         details_path=str(path))
    printed = capsys.readouterr().out
    assert printed == line + "\n"
    assert len(line.encode()) <= bench_io.MAX_LINE_BYTES
    parsed = json.loads(line)
    assert (parsed["value"], parsed["unit"], parsed["vs_baseline"]) == (
        1.25, "s", 96.0)
    assert parsed["details"]["complete"] == summary["complete"]
    assert json.loads(path.read_text()) == {"all": summary}


def test_failed_preflight_prints_zero_and_exits_non_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.bench"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 2, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    parsed = json.loads(lines[0])
    assert parsed["metric"] == bench.METRIC_NAME
    assert (parsed["value"], parsed["vs_baseline"]) == (0.0, 0.0)
    assert parsed["details"]["complete"] is False
    assert parsed["details"]["error"].startswith(
        "CUDA preflight failed: CUDA init failed")
    assert "battery" not in proc.stderr  # nothing ran on the CPU
