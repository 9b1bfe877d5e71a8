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
    assert len(modules) >= 90  # every module of the port was imported
    assert {
        "k8s_operator_libs_tpu_torch.controller",
        "k8s_operator_libs_tpu_torch.coordination",
        "k8s_operator_libs_tpu_torch.coordination.elastic",
        "k8s_operator_libs_tpu_torch.coordination.protocol",
        "k8s_operator_libs_tpu_torch.coordination.workload",
        "k8s_operator_libs_tpu_torch.federation",
        "k8s_operator_libs_tpu_torch.federation.canary",
        "k8s_operator_libs_tpu_torch.federation.coordinator",
        "k8s_operator_libs_tpu_torch.federation.ledger",
        "k8s_operator_libs_tpu_torch.federation.plan",
        "k8s_operator_libs_tpu_torch.federation.registry",
        "k8s_operator_libs_tpu_torch.driver",
        "k8s_operator_libs_tpu_torch.driver.daemonset",
        "k8s_operator_libs_tpu_torch.driver.safe_load_init",
        "k8s_operator_libs_tpu_torch.keys",
        "k8s_operator_libs_tpu_torch.manifests",
        "k8s_operator_libs_tpu_torch.metrics",
        "k8s_operator_libs_tpu_torch.status",
        "k8s_operator_libs_tpu_torch.artifacts",
        "k8s_operator_libs_tpu_torch.artifacts.dag",
        "k8s_operator_libs_tpu_torch.artifacts.gates",
        "k8s_operator_libs_tpu_torch.bench",
        "k8s_operator_libs_tpu_torch.bench_fleet",
        "k8s_operator_libs_tpu_torch.bench_guard",
        "k8s_operator_libs_tpu_torch.bench_io",
        "k8s_operator_libs_tpu_torch.entry",
        "k8s_operator_libs_tpu_torch.health.agent",
        "k8s_operator_libs_tpu_torch.health.fused",
        "k8s_operator_libs_tpu_torch.hostenv",
        "k8s_operator_libs_tpu_torch.k8s.apiserver",
        "k8s_operator_libs_tpu_torch.k8s.client",
        "k8s_operator_libs_tpu_torch.obs.trace",
        "k8s_operator_libs_tpu_torch.planning.planner",
        "k8s_operator_libs_tpu_torch.upgrade.sharded",
        "k8s_operator_libs_tpu_torch.upgrade.upgrade_state",
    } <= set(modules)


@pytest.mark.parametrize(
    "entry", ["controller", "status", "manifests", "bench_guard",
              "bench_fleet"])
def test_the_operator_entry_points_load_no_jax(entry):
    """``python -m k8s_operator_libs_tpu_torch.<entry>`` imports its
    module alone: neither jax nor the JAX package comes with it."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('k8s_operator_libs_tpu_torch.{entry}')\n"
        "print(sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'k8s_operator_libs_tpu')))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("module", ["", ".bench_guard", ".bench_fleet",
                                    ".upgrade", ".k8s", ".planning"])
def test_the_package_engine_and_guard_load_no_torch(module):
    """The package, its engine and the guard import no torch: the guard's
    100,000-node stage runs in a child of its own, whose peak RSS would
    otherwise start at the CUDA build's resident libraries."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('k8s_operator_libs_tpu_torch{module}')\n"
        "print('torch' in sys.modules)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


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


def test_the_port_and_chip_smoke_lint_clean():
    """The repository's linter finds nothing in the port or in
    ``chip_smoke.py`` (``make lint`` covers the JAX package's tree)."""
    proc = subprocess.run(
        [sys.executable, "tools/lint.py", "k8s_operator_libs_tpu_torch",
         "chip_smoke.py"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout == ""
    assert proc.stderr.strip().endswith(" files, 0 finding(s)"), proc.stderr
