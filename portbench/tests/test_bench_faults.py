"""A run with its timed path broken underneath has to come out as not
correct: for each fault a cell can have, the harness's look for a card
skipped and the rest of a run driven on the CPU at a small size."""

import time

import pytest
import torch

import run
from k8s_operator_libs_tpu_torch.health import fused
from k8s_operator_libs_tpu_torch.health.agent import HealthAgent
from k8s_operator_libs_tpu_torch.health.report import HealthReport
from k8s_operator_libs_tpu_torch.health.slice_prober import NodeReportProber
from k8s_operator_libs_tpu_torch.upgrade.validation_manager import ProbeResult
from k8s_operator_libs_tpu_torch.workloads import canary

CPU = [torch.device("cpu")]
BATTERY = {"matmul_n": 64, "matmul_operands": "bfloat16",
           "matmul_accumulate": "float32", "hbm_mib": 1,
           "allreduce_elems": 256, "allreduce_dtype": "float32",
           "fused": True}
CANARY = {"vocab": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
          "d_ff": 64, "seq_len": 16, "batch": 8}


def gate_run(seed=2**31 + 101):
    return run.run_cell("gate.default", seed, 0.5, False, CPU,
                        overrides={"config": {"battery": BATTERY}})


def roll_run(seed=2**31 + 202):
    cfg = run.load_json(run.HERE / "configs" / "gpu-operator-pool4.json")
    small = {**cfg["canary"], **CANARY}
    node = {**cfg["node"], "battery": BATTERY}
    return run.run_cell("roll.canary", seed, 3.0, False, CPU, overrides={
        "config": {"canary": small, "node": node}})


def failing(line):
    return [k for k, c in line["checks"].items()
            if c["value"] is None or c["value"] > c["limit"]]


def test_sound_gate_run_is_correct():
    assert gate_run()["correct"] is True


def test_sound_roll_run_is_correct():
    line = roll_run()
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("kind,check", [("stream", "hbm_bandwidth"),
                                        ("ramp", "ici_allreduce"),
                                        ("ring", "ici_ring")])
def test_a_planted_input_reads_as_the_reference_has_it(kind, check):
    from harness.gate import apply_plant
    from reference import battery as ref_battery

    members = CPU * 8
    key = fused.battery_key(members, 64, 1, 256, False)
    inputs = [fused._build_inputs(key, d, i) for i, d in enumerate(members)]
    plant = (kind, 5, 1234 if kind == "stream" else 0, 40.0)
    apply_plant(inputs, plant)
    want = ref_battery.expected_rows(8, 64, 1, CPU[0], plant=plant)
    assert fused._run(key, inputs) == want
    healthy = ref_battery.expected_rows(8, 64, 1, CPU[0])
    assert ref_battery.failing_checks(want, healthy) == {check}


# -- the gate's faults -------------------------------------------------------


def broken_run(real):
    def half(key, inputs):
        return real(key, inputs[: len(inputs) // 2])

    def altered(key, inputs):
        rows = real(key, inputs)
        rows[-1][-1] += 1.0
        return rows

    return {"half of the members left out": half,
            "an answer altered where it is produced": altered}


@pytest.mark.parametrize("fault", ["half of the members left out",
                                   "an answer altered where it is produced"])
def test_gate_fault_in_the_battery_read_back(monkeypatch, fault):
    monkeypatch.setattr(fused, "_run", broken_run(fused._run)[fault])
    line = gate_run()
    assert line["correct"] is False
    assert "row_gap" in failing(line)


def test_gate_fault_rows_cached_instead_of_computed(monkeypatch):
    # The first rows of each battery returned again, whatever the inputs:
    # the gates with a planted fault read the healthy rows.
    real, cache = fused._run, {}

    def cached(key, inputs):
        if key not in cache:
            cache[key] = real(key, inputs)
        return [list(r) for r in cache[key]]

    monkeypatch.setattr(fused, "_run", cached)
    line = gate_run()
    assert line["correct"] is False
    assert {"row_gap", "verdict_mismatches"} <= set(failing(line))


def test_gate_fault_prober_ignores_failed_checks(monkeypatch):
    # The prober still checks the revision and the report's age, but
    # passes a report whose checks failed: the planted gates show it.
    monkeypatch.setattr(HealthReport, "failed_checks", lambda self: [])
    line = gate_run()
    assert line["correct"] is False
    assert failing(line) == ["verdict_mismatches"]


def test_gate_fault_stream_pass_returns_its_state_unchanged(monkeypatch):
    monkeypatch.setattr(fused, "stream_increment_", lambda x: x)
    line = gate_run()
    assert line["correct"] is False and "row_gap" in failing(line)


def test_gate_fault_exchange_between_members_left_out(monkeypatch):
    monkeypatch.setattr(fused.collectives, "all_reduce",
                        lambda s, divisor=1.0: [t.clone() for t in s])
    line = gate_run()
    assert line["correct"] is False and "row_gap" in failing(line)


def test_gate_fault_verdict_altered(monkeypatch):
    monkeypatch.setattr(NodeReportProber, "probe",
                        lambda self, group: ProbeResult(True, "altered"))
    line = gate_run()
    assert line["correct"] is False
    assert "verdict_mismatches" in failing(line)


# -- the roll's faults -------------------------------------------------------


def test_roll_fault_step_returns_its_state_unchanged(monkeypatch):
    monkeypatch.setattr(canary, "apply_updates", lambda params, updates: params)
    line = roll_run()
    assert line["correct"] is False and "change_gap" in failing(line)


def test_roll_fault_from_the_window_on(monkeypatch):
    # Sound through set-up's warm steps, then every update left out: only
    # a comparison of the window's own steps sees it.
    warm = run.load_json(run.HERE / "traffic" / "roll.json")[
        "canary_warm_steps"]
    real, calls = canary.apply_updates, []

    def late(params, updates):
        calls.append(1)
        return real(params, updates) if len(calls) <= warm else params

    monkeypatch.setattr(canary, "apply_updates", late)
    line = roll_run()
    assert line["correct"] is False
    assert {"loss_gap", "change_gap"} <= set(failing(line))


def test_roll_fault_half_of_the_batch_left_out(monkeypatch):
    real = canary.loss_fn
    monkeypatch.setattr(canary, "loss_fn", lambda params, batch, cfg: real(
        params, batch[: batch.shape[0] // 2], cfg))
    line = roll_run()
    assert line["correct"] is False
    assert {"loss_gap", "grad_gap"} & set(failing(line))


def test_roll_fault_exchange_between_members_left_out(monkeypatch):
    monkeypatch.setattr(fused.collectives, "all_reduce",
                        lambda s, divisor=1.0: [t.clone() for t in s])
    line = roll_run()
    assert line["correct"] is False and "row_gap" in failing(line)


def test_roll_fault_verdict_altered(monkeypatch):
    monkeypatch.setattr(NodeReportProber, "probe",
                        lambda self, group: ProbeResult(True, "altered"))
    # On the card a battery takes about 0.1 s, so the gate's first probe of
    # a node finds its report stale, where a verdict of healthy is wrong.
    # At this size it takes milliseconds, and the agent could publish
    # before the gate's first probe every time.
    real = HealthAgent.probe_once

    def card_paced(self, *args, **kwargs):
        time.sleep(0.1)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(HealthAgent, "probe_once", card_paced)
    line = roll_run()
    assert line["correct"] is False
    assert {"verdict_mismatches", "engine_faults"} & set(failing(line))
