"""The PyTorch port imports neither JAX nor the JAX package.

Importing every module of ``k8s_operator_libs_tpu_torch`` in a fresh
interpreter must leave ``jax`` and ``k8s_operator_libs_tpu`` out of
``sys.modules``, and no port module (nor ``chip_smoke.py``) may name
either in an import statement, even one that is not executed here.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "k8s_operator_libs_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_name(path: Path) -> str:
    parts = path.relative_to(ROOT).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _forbidden(module: str) -> bool:
    return any(
        module == root or module.startswith(root + ".")
        for root in ("jax", "k8s_operator_libs_tpu")
    )


def test_importing_every_port_module_loads_no_jax():
    modules = [_module_name(p) for p in SOURCES if p.parent != ROOT]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules\n"
        "      if m == 'jax' or m.startswith('jax.')\n"
        "      or m == 'k8s_operator_libs_tpu'\n"
        "      or m.startswith('k8s_operator_libs_tpu.')))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    assert len(modules) >= 15  # every module of the slice was imported
    assert {
        "k8s_operator_libs_tpu_torch.artifacts",
        "k8s_operator_libs_tpu_torch.artifacts.gates",
        "k8s_operator_libs_tpu_torch.health.agent",
        "k8s_operator_libs_tpu_torch.health.fused",
    } <= set(modules)


@pytest.mark.parametrize(
    "path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES]
)
def test_no_import_statement_names_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    named = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            named += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            named.append(node.module)
    assert not [m for m in named if _forbidden(m)]
