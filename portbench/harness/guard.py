"""The import guard: no JAX, and no JAX package, in a benchmark run.

Names are compared by their top-level part (before the first dot), whole:
the port's package name begins with the JAX package's name, so a prefix
test would confuse the two.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "k8s_operator_libs_tpu"})
# The references must not reach the program either.
PORT = "k8s_operator_libs_tpu_torch"


def loaded_forbidden(modules=None) -> list[str]:
    """Loaded module names whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


class ImportGuardError(RuntimeError):
    pass


def check(stage: str, modules=None) -> None:
    """Raise when a forbidden module is loaded, naming it and ``stage``."""
    found = loaded_forbidden(modules)
    if found:
        raise ImportGuardError(
            f"import guard ({stage}): forbidden modules loaded: "
            + ", ".join(found[:20])
        )


def imported_top_levels(path: Path) -> set[str]:
    """Every top-level module name a Python file imports, anywhere in it
    (function bodies included)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".", 1)[0])
    return out


def check_references(reference_dir: Path) -> None:
    """Raise when a reference module imports JAX, the JAX package or the
    port."""
    for path in sorted(Path(reference_dir).glob("*.py")):
        bad = imported_top_levels(path) & (FORBIDDEN | {PORT})
        if bad:
            raise ImportGuardError(
                f"import guard: reference {path.name} imports "
                + ", ".join(sorted(bad))
            )
