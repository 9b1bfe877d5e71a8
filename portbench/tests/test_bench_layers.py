"""The program's layer spans in a run: ``harness/program.py``, the layer
metrics' readers and ``run_layers.py``."""

import numpy as np
import pytest
import torch

import run
import run_layers
from harness import program
from harness import trace as tr
from harness.record import Run
from k8s_operator_libs_tpu_torch import layers
from test_bench_line import FakeTrace, small_gate

H100 = "NVIDIA H100 80GB HBM3"
LAYER_NAMES = sorted({n for m in run_layers.LAYER_METRICS.values()
                      for n in m})


@pytest.fixture(autouse=True)
def layers_off():
    layers.record_layers(False)
    layers.take_layers()
    yield
    layers.record_layers(False)
    layers.take_layers()


def ns(t: float) -> int:
    return int(round(t * 1e9))


def synthetic_run() -> Run:
    """A run of 10 s from t = 100 s with what every reader reads: two
    gates, harness spans, a device trace, the canary's steps and a
    roll."""
    r = Run("gate.deep", 1, 10.0, True,
            run.load_json(run.HERE / "configs" / "hgx-h100-node.json"),
            {"deep": True})
    r.window = (100.0, 110.0)
    for name in ("battery", "publish", "verdict", "deep_probe",
                 "engine_pass"):
        r.spans[name] += [(101.0, 101.05), (104.0, 104.07)]
    unions = {0: np.array([[ns(101.0), ns(101.04)], [ns(104.0),
                                                       ns(104.06)]])}
    r.device_trace = {
        "window_s": 10.0, "busy_s": 0.1, "devices": 1, "unions": unions,
        "offset_ns": 0, "breakdown": {},
        "by_name": {"peer_reduce_kernel": 1e-4,
                    "stream_increment_kernel<1, false>": 0.1}}
    steps = [100.0 + 0.2 * i for i in range(40)]
    r.facts = {
        "gates": [(101.0, 101.2), (104.0, 104.3)], "device_kind": H100,
        "setup_s": 12.0, "canary_steps": steps, "tokens_per_step": 1024,
        "nodes_done": 4, "pace_s": 10.0, "api_writes": 60,
        "rolls": [{"start": 100.0, "end": 105.0, "canary_out": True}],
        "canary_matmul_precision": "tf32",
        "canary_cfg": {"vocab": 64, "d_model": 32, "n_heads": 2,
                       "n_layers": 1, "d_ff": 64, "seq_len": 16,
                       "batch": 4},
    }
    return r


def benchmark_metrics() -> list:
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    return [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]


def record(spans: list, counters: dict) -> None:
    """Lay ``spans`` ``(name, start_s, end_s, parent, request)`` and
    ``counters`` into the program's buffer as it would record them."""
    buf, _ = layers.take_layers()
    for name, s, e, parent, request in spans:
        buf.append((name, ns(s), ns(e), parent, request, 1))
    layers._spans.extend(buf)
    for name, n in counters.items():
        layers._counters[name] = n


GATE_SPANS = [
    ("battery.fused", 101.0, 101.03, -1, 1),
    ("fused.readback", 101.01, 101.025, 0, 1),
    ("k8s.get_node", 101.1, 101.101, -1, 2),
    ("k8s.patch_node", 101.05, 101.0512, -1, 1),
    ("battery.fused", 104.0, 104.05, -1, 3),
    ("fused.readback", 104.03, 104.04, 4, 3),
    ("deep.inputs", 104.06, 104.066, -1, 3),
    ("deep.ring", 104.07, 104.074, -1, 3),
    ("deep.ring", 104.08, 104.082, -1, 3),
    # Before the window: read by nothing.
    ("battery.fused", 90.0, 90.5, -1, 0),
    ("k8s.get_node", 90.0, 90.5, -1, 0),
]
ROLL_SPANS = [
    ("engine.build_state", 102.0, 102.01, -1, 7),
    ("k8s.list_pods", 102.001, 102.003, -1, 7),
    ("engine.apply_state", 102.01, 102.05, -1, 7),
    ("k8s.patch_node", 102.02, 102.024, -1, 7),
    ("engine.async_wait", 102.05, 102.09, -1, 7),
    ("engine.build_state", 103.0, 103.02, -1, 8),
    ("k8s.list_pods", 103.001, 103.003, -1, 8),
    ("engine.async_wait", 103.02, 103.03, -1, 8),
    # A drain worker's own request and the sampler's read: not a pass's.
    ("k8s.evict_pod", 102.03, 102.1, -1, 9),
    ("k8s.get_node", 102.5, 102.6, -1, 10),
    ("canary.enqueue", 101.0, 101.03, -1, 11),
    ("canary.enqueue", 101.2, 101.25, -1, 12),
]
COUNTERS = {"k1.bytes": 3 * 64 * (1 << 31), "fused.batteries": 3}


def collected(spans=GATE_SPANS + ROLL_SPANS, counters=COUNTERS) -> Run:
    r = synthetic_run()
    record(spans, counters)
    program.collect(r)
    return r


def test_collect_leaves_every_existing_reader_unchanged():
    names = benchmark_metrics()
    before = synthetic_run()
    values = {n: run.reader(n)(before) for n in names}
    assert sum(v is not None for v in values.values()) >= 12
    after = collected()
    assert {n: run.reader(n)(after) for n in names} == values
    assert after.facts["program_counters"] == COUNTERS
    assert after.spans["battery.fused"][0] == pytest.approx((101.0, 101.03))


def test_each_layer_reader_reads_the_program_spans():
    r = collected()
    got = {n: run.reader(n)(r) for n in LAYER_NAMES}
    want = {
        # Every API call in the window over its two gates.
        "api_ms.gate": (1.0 + 1.2 + 2 + 4 + 2 + 70 + 100) / 2,
        "battery_host_ms.gate": ((30 - 15) + (50 - 10)) / 2,
        # Two batteries of 64 passes of 2 GiB over 0.1 s at 3.35 TB/s.
        "k1_roofline_pct.gate": 100 * 2 * 64 * 2**31 / 3.35e12 / 0.1,
        "deep_inputs_ms.gate": 6.0,
        "deep_ring_ms.gate": 3.0,
        "async_wait_ms.roll": (40 + 10) / 2,
        "api_ms.roll": (2 + 4 + 2) / 2,
        "canary_enqueue_ms.roll": (30 + 50) / 2,
    }
    assert got == pytest.approx(want)


def test_each_layer_reader_gives_none_without_program_spans():
    r = synthetic_run()
    assert {n: run.reader(n)(r) for n in LAYER_NAMES} == dict.fromkeys(
        LAYER_NAMES)
    # Spans without K1's counters: no roofline.
    r = collected(counters={})
    assert run.reader("k1_roofline_pct.gate")(r) is None


def test_an_untraced_run_never_turns_recording_on(monkeypatch):
    calls = []
    monkeypatch.setattr(layers, "record_layers", calls.append)
    line = run.run_cell("gate.default", 2**31 + 21, 0.5, False,
                        [torch.device("cpu")], overrides=small_gate())
    assert line["correct"] is True
    assert True not in calls
    assert layers.take_layers() == ([], {})


def test_run_layers_adds_the_program_s_metrics_and_spans(monkeypatch):
    monkeypatch.setattr(tr, "Trace", FakeTrace)
    # Long enough for whole gates of the small battery on the CPU.
    seconds = 4.0
    plain = run.run_cell("gate.default", 2**31 + 22, seconds, True,
                         [torch.device("cpu")], overrides=small_gate())
    line = run_layers.run_traced("gate.default", 2**31 + 22, seconds,
                                 [torch.device("cpu")],
                                 overrides=small_gate())
    assert line["correct"] is True
    assert list(line) == list(plain) + ["layers"]
    assert set(line["metrics"]) - set(plain["metrics"]) == {
        "gate_p95_ms", "setup_s", "api_ms.gate", "battery_host_ms.gate"}
    spans = line["layers"]["spans"]
    assert {"agent.probe", "battery.fused", "fused.readback",
            "k8s.get_node", "k8s.patch_node", "prober.probe"} <= set(spans)
    count, seconds, own = spans["battery.fused"]
    assert count >= 1 and seconds > own > 0
    assert spans["k8s.get_node"][1] == pytest.approx(spans["k8s.get_node"][2])
    assert line["layers"]["counters"]["fused.batteries"] >= count
    assert not layers._on
    assert tr.Trace is FakeTrace and run.loop_for.__name__ == "loop_for"


def test_run_layers_without_recording_records_nothing(monkeypatch):
    monkeypatch.setattr(tr, "Trace", FakeTrace)
    calls = []
    monkeypatch.setattr(layers, "record_layers", calls.append)
    line = run_layers.run_traced("gate.default", 2**31 + 23, 0.5,
                                 [torch.device("cpu")], layers=False,
                                 overrides=small_gate())
    assert line["correct"] is True
    assert True not in calls
    assert line["layers"] == {"spans": {}, "idle_s": {}, "counters": {}}
    assert "setup_s" in line["metrics"]


def test_idle_by_span_splits_the_gaps_by_each_span_s_own_time():
    r = synthetic_run()
    # Busy 101.00-101.04 and 104.00-104.06; a gate's spans around.
    record([("gate", 100.5, 101.5, -1, 1),
            ("battery.fused", 101.0, 101.1, 0, 1),
            ("k8s.get_node", 101.2, 101.3, 0, 1),
            ("k8s.get_node", 103.0, 103.5, -1, 2)], {})
    program.collect(r)
    idle = run_layers.idle_by_span(r)
    assert idle == pytest.approx({
        "gate": 0.5 + 0.2 + 0.1,       # 100.5-101.0, 101.1-101.2, -101.5
        "k8s.get_node": 0.1 + 0.5,
        "battery.fused": 0.06,
        # 9.9 s idle, less the gate's 0.96 and the later read's 0.5.
        "none": 9.9 - 0.96 - 0.5})
