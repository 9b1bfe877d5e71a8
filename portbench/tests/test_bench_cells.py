"""BENCHMARK.json against the contract, and every cell against the files
it names."""

import json
import re
import statistics
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits its 43,200 s.
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    texts = ([c["why"] for c in BENCH["workloads"] + BENCH["configs"]]
             + [c["source"] for c in BENCH["configs"]]
             + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")


def test_four_chip_cells_within_a_quarter():
    four = [c for c in BENCH["workloads"] if c["chips"] == 4]
    assert all(c["chips"] in (1, 4) for c in BENCH["workloads"])
    assert len(four) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files(cell):
    c = next(w for w in BENCH["workloads"] if w["name"] == cell)
    cfg = next(x for x in BENCH["configs"] if x["name"] == c["config"])
    assert (ROOT / cfg["file"]).is_file()
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    traffic = json.loads((HERE / "traffic" / f"{c['traffic']}.json").read_text())
    import run

    assert callable(run.loop_for(traffic["kind"]))

    e2e = run.metrics_for(BENCH, cell, trace=False)
    layer = run.metrics_for(BENCH, cell, trace=True)
    assert any(m["name"] == "setup_s" for m in e2e)
    assert len(e2e) >= 2 and layer
    for m in e2e + layer:
        assert callable(run.reader(m["name"])), m["name"]
    limits = json.loads((ROOT / cfg["file"]).read_text())["limits"]
    assert all(isinstance(v, (int, float)) for v in limits.values()), limits


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"]
        layers.setdefault(m["layer"], 0)
    assert len(layers) >= 5


def test_spread_rule_matches_statistics_quantiles():
    # The bounds were set from statistics.quantiles(values, n=4).
    q = statistics.quantiles([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], n=4)
    assert q == [1.75, 3.5, 5.25]
