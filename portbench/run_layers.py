"""Run one cell traced, with the program's own layer spans recorded.

    python3 portbench/run_layers.py --workload <cell> --seed <n> \
        --seconds <s> [--layers 0]

from the root of a checkout, as ``run.py --trace 1``, and the same run
but for this: the port's layer spans and counters
(``harness/program.py``) are on from before the cell's set-up and laid
into the run before the device trace is reduced, so that the
breakdown's idle gaps name the program's spans where they cover a gap.
The line adds the cell's end-to-end metrics (which a traced ``run.py``
leaves out) and its layer metrics (``LAYER_METRICS``, each read by
``metrics/<name>.py``) to ``metrics``, and ``layers``: each program
span's count, seconds and own seconds (its time less its children's)
in the window (``spans``), the device's idle seconds in each span's own
time (``idle_s``; spans of other threads may overlap, so these may sum
to more than the idle time, whose part outside every program span is
``idle_s["none"]``), and the counters of the whole run.  ``--layers 0``
runs the same without recording: the two give what recording costs.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

import numpy as np

import run as bench
from harness import program
from harness import trace as tr

# The cells' layer metrics: name -> unit.
GATE_METRICS = {"api_ms.gate": "ms/gate", "battery_host_ms.gate": "ms",
                "k1_roofline_pct.gate": "%"}
LAYER_METRICS = {
    "gate.default": GATE_METRICS,
    "gate.deep": {**GATE_METRICS, "deep_inputs_ms.gate": "ms",
                  "deep_ring_ms.gate": "ms"},
    "roll.canary": {"async_wait_ms.roll": "ms", "api_ms.roll": "ms/pass",
                    "canary_enqueue_ms.roll": "ms"},
}


def run_traced(workload: str, seed: int, seconds: float, cards: list,
               layers: bool = True, started: float | None = None,
               overrides: dict | None = None) -> dict:
    """``run.run_cell`` traced, with the program's layer spans unless
    ``layers`` is False."""
    runs: list = []
    loop_for, trace = bench.loop_for, tr.Trace

    def recording_loop(kind: str):
        loop = loop_for(kind)

        def make(run, loop_cards):
            runs.append(run)
            if layers:
                program.start()
            return loop(run, loop_cards)

        return make

    def collecting_trace(trace_cards):
        tracer = trace(trace_cards)
        reduce = tracer.reduce

        def collect_then_reduce(window, spans):
            program.collect(runs[-1])
            return reduce(window, spans)

        tracer.reduce = collect_then_reduce
        return tracer

    bench.loop_for = recording_loop
    if layers:
        tr.Trace = collecting_trace
    try:
        line = bench.run_cell(workload, seed, seconds, True, cards,
                              started=started, overrides=overrides)
    finally:
        bench.loop_for, tr.Trace = loop_for, trace
        program.stop()
    run = runs[-1]
    cell = bench.load_json(bench.ROOT / "BENCHMARK.json")
    units = {m["name"]: m["unit"]
             for m in bench.metrics_for(cell, workload, False)}
    units.update(LAYER_METRICS.get(workload, {}))
    for name, unit in units.items():
        value = bench.reader(name)(run)
        if value is not None:
            line["metrics"][name] = {"value": float(value), "unit": unit}
    line["layers"] = {"spans": span_seconds(run),
                      "idle_s": idle_by_span(run),
                      "counters": run.facts.get("program_counters", {})}
    return bench.finite(line)


def own_pieces(spans: list) -> list:
    """Each closed span's own time, ``(name, start_ns, end_ns)`` pieces:
    its interval less its children's."""
    kids: dict = {}
    for name, s, e, parent, *_ in spans:
        if e is not None and parent >= 0:
            kids.setdefault(parent, []).append((s, e))
    return [(name, a, b) for i, (name, s, e, *_) in enumerate(spans)
            if e is not None for a, b in own_time(s, e, kids.get(i, ()))]


def span_seconds(run) -> dict:
    """``name -> [count, seconds, own seconds]`` of the program's spans
    that ended inside the window."""
    spans = run.facts.get("program_spans") or []
    out: dict = {}
    for name, s, e, *_ in spans:
        if e is not None and run.in_window(e / 1e9):
            c = out.setdefault(name, [0, 0.0, 0.0])
            c[0] += 1
            c[1] += (e - s) / 1e9
    for name, a, b in own_pieces(spans):
        if name in out and run.in_window(b / 1e9):
            out[name][2] += (b - a) / 1e9
    return dict(sorted(out.items()))


def idle_gaps(trace: dict, window: tuple) -> np.ndarray:
    """The window's intervals (trace nanoseconds) in which no device
    ran."""
    off = trace["offset_ns"]
    w0, w1 = int(window[0] * 1e9) + off, int(window[1] * 1e9) + off
    busy = [u for u in trace["unions"].values() if len(u)]
    merged = (tr._union(np.concatenate(busy)) if busy
              else np.zeros((0, 2), np.int64))
    merged = merged[(merged[:, 1] > w0) & (merged[:, 0] < w1)]
    edges = np.concatenate([[w0], merged.ravel().clip(w0, w1), [w1]])
    gaps = edges.reshape(-1, 2)
    return gaps[gaps[:, 1] > gaps[:, 0]]


def own_time(start: int, end: int, children: list) -> list:
    """``[start, end]`` less its children's intervals."""
    pieces, at = [], start
    for s, e in sorted(children):
        if s > at:
            pieces.append((at, s))
        at = max(at, e)
    if end > at:
        pieces.append((at, end))
    return pieces


def idle_by_span(run) -> dict:
    """Idle device seconds in the window within each program span's own
    time, by name, largest first; ``none`` for idle time outside every
    program span."""
    t, spans = run.device_trace, run.facts.get("program_spans")
    if not t or not spans:
        return {}
    gaps = {0: idle_gaps(t, run.window)}
    own: dict = {}
    for name, a, b in own_pieces(spans):
        own.setdefault(name, []).append((a / 1e9, b / 1e9))
    idle = {name: tr.busy_within(gaps, t["offset_ns"], pieces)
            for name, pieces in own.items()}
    covered = tr.busy_within(gaps, t["offset_ns"], [
        (s / 1e9, e / 1e9) for _, s, e, *_ in spans if e is not None])
    idle["none"] = float(sum(b - a for a, b in gaps[0]) / 1e9) - covered
    return dict(sorted(((k, v) for k, v in idle.items() if v > 0),
                       key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    started = bench.process_start_s()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--layers", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    bench.cache_env(bench.ROOT)
    try:
        bench_json = bench.load_json(bench.ROOT / "BENCHMARK.json")
        cell = bench.find_cell(bench_json, args.workload)
        cards = tr.require_cards(int(cell["chips"]))
    except tr.NoCardError as e:
        print(f"portbench: {e}; no result", file=sys.stderr)
        return bench.EXIT_NO_CARD
    try:
        line = run_traced(args.workload, args.seed, args.seconds, cards,
                          layers=bool(args.layers), started=started)
    except bench.guard.ImportGuardError as e:
        print(f"portbench: {e}; no result", file=sys.stderr)
        return bench.EXIT_GUARD
    except Exception:  # noqa: BLE001 — the run's end: say why, print nothing
        traceback.print_exc()
        print("portbench: the run failed; no result", file=sys.stderr)
        return bench.EXIT_ERROR
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
