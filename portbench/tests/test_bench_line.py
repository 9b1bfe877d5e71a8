"""The result line's keys, the refusal without a card, the import guard
and the trace's interval arithmetic."""

import json
import sys
import types

import numpy as np
import pytest
import torch

import run
from harness import guard
from harness import trace as tr

SMALL_BATTERY = {"matmul_n": 64, "matmul_operands": "bfloat16",
                 "matmul_accumulate": "float32", "hbm_mib": 1,
                 "allreduce_elems": 256, "allreduce_dtype": "float32",
                 "fused": True}


def small_gate(**extra):
    return {"config": {"battery": SMALL_BATTERY, **extra}}


def test_line_has_the_contract_keys_in_order():
    line = run.run_cell("gate.default", 2**31 + 11, 0.5, False,
                        [torch.device("cpu")], overrides=small_gate())
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"gate_p95_ms", "setup_s"}
    assert line["metrics"]["gate_p95_ms"]["unit"] == "ms"
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line, allow_nan=False)


class FakeTrace:
    """A device trace with one busy millisecond in every ten."""

    def __init__(self, cards):
        self.cards = cards

    def start(self):
        pass

    def stop(self):
        pass

    def reduce(self, window, spans):
        w0, w1 = (int(t * 1e9) for t in window)
        starts = np.arange(w0, w1, 10_000_000)
        unions = {0: np.stack([starts, starts + 1_000_000], axis=1)}
        busy = float(len(starts)) * 1e-3
        return {"window_s": (w1 - w0) / 1e9, "busy_s": busy, "devices": 1,
                "unions": unions, "by_name": {"peer_reduce_kernel": 1e-4},
                "offset_ns": 0,
                "breakdown": {"device_ops": [["peer_reduce_kernel", 1e-4]],
                              "idle_gaps": [["battery", 0.1]]}}


def test_traced_line_adds_the_breakdown_and_the_busy_time(monkeypatch):
    monkeypatch.setattr(tr, "Trace", FakeTrace)
    line = run.run_cell("gate.default", 2**31 + 12, 0.5, True,
                        [torch.device("cpu")], overrides=small_gate())
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    names = set(line["metrics"])
    assert {"verdict_ms.gate", "publish_ms.gate", "battery_ms.gate",
            "device_idle_pct.gate", "collective_ms.gate"} <= names
    assert line["metrics"]["device_idle_pct.gate"]["value"] == pytest.approx(
        90.0, abs=1.0)
    # No share of a peak on a card the table does not hold.
    assert "battery_roofline_pct.gate" not in names


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "gate.default", "--seed", str(2**31 + 5),
                   "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0
    assert out == ""
    assert "no CUDA device" in err


def test_too_few_cards_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", "gate.default", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == ""
    assert "needs 1" in err


def test_guard_compares_whole_top_level_names():
    mods = {"k8s_operator_libs_tpu_torch.health": None, "numpy": None}
    assert guard.loaded_forbidden(mods) == []
    mods["k8s_operator_libs_tpu.health"] = None
    mods["jaxlib.xla_client"] = None
    assert guard.loaded_forbidden(mods) == ["jaxlib.xla_client",
                                            "k8s_operator_libs_tpu.health"]
    with pytest.raises(guard.ImportGuardError, match="jaxlib"):
        guard.check("test", mods)


def test_guard_fails_a_run_that_loads_jax(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: guard.check("x"))
    monkeypatch.setattr(tr, "require_cards", lambda n: [torch.device("cpu")])
    rc = run.main(["--workload", "gate.default", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "jax" in err


def test_the_references_import_neither_jax_nor_the_port(tmp_path):
    guard.check_references(run.HERE / "reference")
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    import k8s_operator_libs_tpu_torch.hw\n")
    with pytest.raises(guard.ImportGuardError, match="bad.py"):
        guard.check_references(tmp_path)


def test_union_and_busy_within():
    u = tr._union([(5, 9), (0, 3), (2, 4), (10, 12)])
    assert u.tolist() == [[0, 4], [5, 9], [10, 12]]
    unions = {0: u, 1: tr._union([(0, 12)])}
    spans = [(3e-9, 11e-9)]
    # Card 0: 1 + 4 + 1; card 1: 8.
    assert tr.busy_within(unions, 0, spans) == pytest.approx(14e-9)


def test_downtime_counts_gaps_inside_the_window_only():
    from harness.record import Run

    r = Run("roll.canary", 1, 10.0, False, {}, {})
    r.window = (100.0, 110.0)
    # Set-up's last step at 90; steps every 0.2 s, a 1 s pause in the first
    # roll and an open one at the window's end in the second.
    steps = [90.0] + [100.1 + 0.2 * i for i in range(10)]
    steps += [103.9 + 0.2 * i for i in range(20)]
    r.facts = {"canary_steps": steps, "rolls": [
        {"start": 100.0, "end": 105.0, "canary_out": True},
        {"start": 105.0, "end": None, "canary_out": True},
        {"start": 109.9, "end": None, "canary_out": False}]}
    value = run.reader("downtime_s")(r)
    # Roll 0: the pause 101.9 -> 103.9 (2 s); roll 1: open since 107.7.
    assert value == pytest.approx((2.0 + (110.0 - 107.7)) / 2)
