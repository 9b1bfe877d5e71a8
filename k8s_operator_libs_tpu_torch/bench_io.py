"""Bench artifact emission: one small JSON line on stdout and a side file.

Counterpart of ``k8s_operator_libs_tpu.bench_io``.  A caller that reads
only the tail of the bench's output must always find the headline, so
the result is split:

- **stdout**: exactly one JSON line of at most ``MAX_LINE_BYTES``, with
  ``metric``, ``value``, ``unit``, ``vs_baseline`` and a compact
  ``details`` summary naming the side file;
- **side file**: the full evidence (transitions, probe metrics, each
  roll's record), with no size limit.

:func:`compact_line` enforces the cap whatever the summary holds: under
size pressure it drops expendable keys, then shortens strings, and as a
last resort keeps only ``complete`` and ``details_file``.  The JAX
package's copy stops shrinking when an oversized protected value is not
a string; here the last step does not depend on the values' types.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping, Optional

MAX_LINE_BYTES = 2048

# Keys dropped last under size pressure.
_PROTECTED = ("complete", "backend", "details_file", "error")
# Keys the last resort keeps.
_FLOOR = ("complete", "details_file")


def _fits(line: str) -> bool:
    return len(line.encode("utf-8")) <= MAX_LINE_BYTES


def compact_line(
    metric: str,
    value: float,
    unit: str,
    vs_baseline: float,
    summary: Mapping[str, Any],
) -> str:
    """Serialize the one-line payload, at most ``MAX_LINE_BYTES``.

    Expendable summary keys are dropped last-first; then the metric and
    the longest strings are shortened (non-scalar protected values are
    flattened to strings first); then ``details`` keeps only
    ``complete`` and ``details_file``, cut to 64 characters.  The
    numbers are never changed."""
    details = dict(summary)

    def render() -> str:
        return json.dumps(
            {"metric": metric, "value": value, "unit": unit,
             "vs_baseline": vs_baseline, "details": details},
            separators=(",", ":"), default=str,
        )

    line = render()
    if _fits(line):
        return line
    for key in reversed(list(details)):
        if key in _PROTECTED:
            continue
        del details[key]
        line = render()
        if _fits(line):
            return line
    metric = metric[:80]
    for key, val in list(details.items()):
        if not isinstance(val, (str, int, float, bool, type(None))):
            details[key] = json.dumps(val, default=str)[:200]
    line = render()
    while not _fits(line):
        key = max(
            (k for k in details if isinstance(details[k], str)),
            key=lambda k: len(details[k]),
            default=None,
        )
        if key is None or len(details[key]) <= 8:
            break
        details[key] = details[key][: max(8, len(details[key]) // 2)]
        line = render()
    if not _fits(line):
        details = {
            k: (v[:64] if isinstance(v, str) else v)
            for k, v in details.items() if k in _FLOOR
        }
        unit = unit[:32]
        line = render()
    return line


def emit(
    metric: str,
    value: float,
    unit: str,
    vs_baseline: float,
    summary: Mapping[str, Any],
    full_details: Optional[Mapping[str, Any]] = None,
    details_path: Optional[str] = None,
) -> str:
    """Write ``full_details`` to ``details_path`` (when both are given)
    and print the capped line to stdout; returns the printed line.  A
    side file that cannot be written is named in the line, never raised:
    the line is the result that must always land."""
    summary = dict(summary)
    if details_path is not None and full_details is not None:
        try:
            os.makedirs(os.path.dirname(details_path) or ".", exist_ok=True)
            tmp = details_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(full_details, f, indent=1, sort_keys=True,
                          default=str)
                f.write("\n")
            os.replace(tmp, details_path)
            summary["details_file"] = os.path.relpath(details_path)
        except (OSError, TypeError, ValueError) as e:
            summary["details_file"] = f"<write failed: {e}>"[:120]
    line = compact_line(metric, value, unit, vs_baseline, summary)
    print(line, flush=True)
    return line
