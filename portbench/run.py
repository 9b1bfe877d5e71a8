"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.
The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``, whose ``kind`` names the loop
that drives it, ``portbench/harness/<kind>.py``); each metric is read by
``portbench/metrics/<name>.py``.  A run:

1. sets up (timed from the process's start as ``setup_s``): the port's
   kernel library, built once into the checkout's ``build/torch_kernels``
   and loaded from there later; the cell's weights and inputs, made on
   the card from ``--seed``; every shape the cell uses, warmed;
2. measures for ``--seconds`` (traced by ``torch.profiler`` with
   ``--trace 1``, whose metrics are then the cell's per-layer ones);
3. compares what the window produced with the plain references under
   ``portbench/reference`` (after the memory peak is read and the
   port's state is freed);
4. prints each compared number beside its limit on standard error, then
   one JSON line on standard output: ``correct``, ``attempted``,
   ``failed``, ``metrics``, ``device`` (and ``breakdown`` when traced),
   and ``checks`` last.

Without the cell's cards, with JAX or the JAX package loaded, or without
the port beside it, the run prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# The harness beside this file, and the port at the checkout's root.
sys.path[:0] = [str(HERE), str(ROOT)]

from harness import guard  # noqa: E402
from harness.record import Run  # noqa: E402

EXIT_NO_CARD = 3
EXIT_GUARD = 4
EXIT_ERROR = 1


def process_start_s() -> float:
    """The wall-clock second this process started (from /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def cache_env(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    nothing of the JAX stack through a library that would load it."""
    build = root / "build"
    os.environ["K8S_TPU_TORCH_KERNEL_DIR"] = str(build / "torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "portbench" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(build / "portbench" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "portbench" / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or (traced) its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loop_for(kind: str):
    """The loop that drives a traffic mix of ``kind``: the ``Loop`` of
    ``portbench/harness/<kind>.py``."""
    if not kind.isidentifier():
        raise ValueError(f"traffic kind {kind!r} is no module name")
    return importlib.import_module(f"harness.{kind}").Loop


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {value, limit}})``: each number at or under its
    limit; a number without a limit fails."""
    out, ok = {}, True
    for name, value in checks.items():
        limit = limits.get(name)
        good = (limit is not None and value == value
                and not math.isinf(value) and value <= limit)
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             cards: list, root: Path = ROOT, started: float | None = None,
             overrides: dict | None = None) -> dict:
    """One run of ``workload`` on ``cards``; the result line as a dict.
    ``overrides`` (tests) replaces configuration and traffic keys."""
    from harness import trace as tr

    started = time.time() if started is None else started
    bench = load_json(root / "BENCHMARK.json")
    cell = find_cell(bench, workload)
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    for key, value in ((overrides or {}).get("config") or {}).items():
        config[key] = value
    for key, value in ((overrides or {}).get("traffic") or {}).items():
        traffic[key] = value
    guard.check_references(HERE / "reference")
    run = Run(workload=workload, seed=seed, seconds=float(seconds),
              trace=trace, config=config, traffic=traffic, spans_on=trace)
    run.phase("imports")
    try:
        loop = loop_for(traffic["kind"])(run, cards)
        guard.check("set-up")
        tracer = tr.Trace(cards) if trace else None
        if tracer:
            tracer.start()
        run.facts["setup_s"] = time.time() - started
        t0 = time.perf_counter()
        deadline = t0 + run.seconds
        run.window = (t0, deadline)
        loop.window(deadline)
        if tracer:
            tracer.stop()
        guard.check("window")
        loop.finish()
        device = tr.device_info(cards)
        run.facts["device_kind"] = device["kind"]
        loop.release()
    finally:
        run.unpatch()
    if trace:
        run.device_trace = tracer.reduce(run.window, run.spans)
        device["busy_s"] = run.device_trace["busy_s"]
        device["window_s"] = run.device_trace["window_s"]
    metrics = {}
    for m in metrics_for(bench, workload, trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = loop.compare()
    correct, checks = judge(result["checks"], config["limits"])
    guard.check("result")
    line = {"correct": correct, "attempted": int(result["attempted"]),
            "failed": int(result["failed"]), "metrics": metrics,
            "device": device}
    if trace:
        line["breakdown"] = run.device_trace["breakdown"]
    line["checks"] = checks
    begin = started - time.time() + time.perf_counter()
    print("portbench: set-up " + ", ".join(
        f"{name} {end - begin:.3f} s" for name, end in run.phases),
        file=sys.stderr)
    for note in result.get("notes", ()):
        print(f"portbench: {note}", file=sys.stderr)
    return finite(line)


def finite(x):
    """The line with every non-finite number as null (JSON has none)."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    started = process_start_s()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env(ROOT)
    try:
        from harness import trace as tr

        bench = load_json(ROOT / "BENCHMARK.json")
        cards = tr.require_cards(int(find_cell(bench, args.workload)["chips"]))
    except tr.NoCardError as e:
        print(f"portbench: {e}; no result", file=sys.stderr)
        return EXIT_NO_CARD
    try:
        line = run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), cards, started=started)
    except guard.ImportGuardError as e:
        print(f"portbench: {e}; no result", file=sys.stderr)
        return EXIT_GUARD
    except Exception:  # noqa: BLE001 — the run's end: say why, print nothing
        traceback.print_exc()
        print("portbench: the run failed; no result", file=sys.stderr)
        return EXIT_ERROR
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
