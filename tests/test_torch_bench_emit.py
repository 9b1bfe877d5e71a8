"""The JAX package's ``tests/test_bench_emit.py`` against the port's
``bench_io`` (the bench's one capped stdout line and its side file).

``port_module`` runs the file's source with the package prefix
rewritten, so its cap cases hold the port's ``compact_line`` and
``emit``.  The battery's progress case hands the port's battery its CPU
device (``SUBSTITUTIONS``).  Two cases depart by design
(``DEPARTURES``), each mirrored on the port: its ``emit`` names the side
file by its path, and its ``bench.py`` has a contract of its own.  The
two cases that read the root ``bench.py`` (its summary's keys, its stall
table) read the reference's bench, which the port leaves as it is.
"""

from __future__ import annotations

import ast
import json
import os

from k8s_operator_libs_tpu_torch import bench as port_bench
from k8s_operator_libs_tpu_torch.bench_io import MAX_LINE_BYTES, emit
from tests.test_torch_control_plane import (
    PORT,
    departed,
    port_module,
    port_tests,
    unmirrored,
)

SUBSTITUTIONS = (
    ("    import jax\n", "    import torch\n"),
    ('jax.devices("cpu")[:1]', '[torch.device("cpu")]'),
)
# Reference cases that cannot hold on the port, each with its reason and
# the port case that mirrors it.
DEPARTURES = {
    "test_emit_splits_bulk_to_side_file": (
        "the port's emit names the side file by its path relative to the "
        "working directory (its bench writes build/bench_torch/), the "
        "reference's by its base name",
        "test_port_emit_splits_bulk_to_side_file",
    ),
    "test_bench_py_promises_the_capped_contract": (
        "it reads the root bench.py, the reference's; the port's bench is "
        "its package's bench.py, whose DCN worker prints its own JSON line "
        "for its parent and whose crash guard catches Exception",
        "test_port_bench_py_promises_the_capped_contract",
    ),
}

_emit = port_module("test_bench_emit.py", substitutions=SUBSTITUTIONS)
globals().update(departed(port_tests(_emit), DEPARTURES))


def test_every_departure_has_its_mirror():
    assert unmirrored(DEPARTURES, globals()) == []


def test_port_emit_splits_bulk_to_side_file(tmp_path, capsys, monkeypatch):
    """The reference's case on the port: the bulk lands in the side file,
    never on stdout, and the line names the file by its relative path."""
    monkeypatch.chdir(tmp_path)
    transitions = [[round(i * 0.37, 2), f"pool-{i % 4}", "state-" + "x" * 20]
                   for i in range(120)]
    full = {
        "complete": True,
        "backend": "default (the long honest label lives here)",
        "transitions": transitions,
        "pipelined_transitions": transitions,
        "probe_metrics": {"mxu_matmul": {"tflops": 179.3, "mfu": 0.91}},
    }
    path = str(tmp_path / "bench_torch" / "details.json")
    line = emit(_emit.METRIC, 0.9, "s", 133.33,
                _emit._bench_shaped_summary(), full, path)
    out = capsys.readouterr().out
    assert out.count("\n") == 1 and out.strip() == line
    assert len(line.encode()) <= MAX_LINE_BYTES
    parsed = json.loads(line)
    assert parsed["details"]["details_file"] == os.path.join(
        "bench_torch", "details.json")
    assert "transitions" not in parsed["details"]
    with open(path) as f:
        side = json.load(f)
    assert side["transitions"] == transitions
    assert side["backend"].startswith("default")


def test_port_bench_py_promises_the_capped_contract():
    """The port's bench routes its result through ``bench_io.emit``: the
    only ``json.dumps`` in it is its DCN worker's line, read by the
    parent stage; the side file is ``DETAILS_PATH``; and the crash guard
    emits one line and exits 4."""
    src = (PORT / "bench.py").read_text()
    tree = ast.parse(src)
    assert "from k8s_operator_libs_tpu_torch.bench_io import emit" in src
    dumps_in = {
        getattr(top, "name", "<module>") for top in tree.body
        if any(isinstance(n, ast.Attribute) and n.attr == "dumps"
               and isinstance(n.value, ast.Name) and n.value.id == "json"
               for n in ast.walk(top))
    }
    assert dumps_in == {"dcn_worker"}
    assert port_bench.DETAILS_PATH.name == "details.json"
    main_block = tree.body[-1]
    assert isinstance(main_block, ast.If)
    guard = ast.unparse(main_block)
    assert "except Exception" in guard
    assert "emit(METRIC_NAME, 0.0" in guard
    assert "code = 4" in guard and "sys.exit(code)" in guard
