"""Kubernetes label-selector evaluation.

The engine consumes selectors in two forms, matching the reference's usage:
``matchLabels`` dicts (DaemonSet selectors, driver labels) and selector
strings (``podSelector`` fields).  String parsing supports the
equality-based and set-based syntax the apiserver accepts:
``k=v``, ``k==v``, ``k!=v``, ``k``, ``!k``, ``k in (a,b)``, ``k notin (a,b)``.
"""

from __future__ import annotations

import re


class SelectorError(ValueError):
    pass


_IN_RE = re.compile(r"^\s*([\w./-]+)\s+(in|notin)\s+\(([^)]*)\)\s*$")
_EQ_RE = re.compile(r"^\s*([\w./-]+)\s*(==|=|!=)\s*([\w./-]*)\s*$")
_KEY_RE = re.compile(r"^\s*(!?)\s*([\w./-]+)\s*$")


def _split_requirements(selector: str) -> list[str]:
    """Split on commas that are not inside a set-based ``( ... )`` group."""
    parts, depth, cur = [], 0, []
    for ch in selector:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return [p for p in parts if p.strip()]


def matches_selector(labels: dict[str, str], selector: str) -> bool:
    """True if ``labels`` satisfy the selector string (empty matches all)."""
    if not selector or not selector.strip():
        return True
    for req in _split_requirements(selector):
        m = _IN_RE.match(req)
        if m:
            key, op, vals = m.group(1), m.group(2), m.group(3)
            values = {v.strip() for v in vals.split(",") if v.strip()}
            present = key in labels and labels[key] in values
            if op == "in" and not present:
                return False
            if op == "notin" and key in labels and labels[key] in values:
                return False
            continue
        m = _EQ_RE.match(req)
        if m:
            key, op, val = m.group(1), m.group(2), m.group(3)
            if op in ("=", "=="):
                if labels.get(key) != val:
                    return False
            else:  # !=
                if key in labels and labels[key] == val:
                    return False
            continue
        m = _KEY_RE.match(req)
        if m:
            negate, key = m.group(1) == "!", m.group(2)
            if negate and key in labels:
                return False
            if not negate and key not in labels:
                return False
            continue
        raise SelectorError(f"cannot parse selector requirement {req!r}")
    return True


def matches_labels(labels: dict[str, str], match_labels: dict[str, str]) -> bool:
    """matchLabels-dict form: every pair must be present."""
    return all(labels.get(k) == v for k, v in (match_labels or {}).items())


def selector_from_match_labels(match_labels: dict[str, str]) -> str:
    """Render a matchLabels dict as a selector string
    (labels.SelectorFromSet analogue, reference pod_manager.go:98)."""
    return ",".join(f"{k}={v}" for k, v in sorted((match_labels or {}).items()))
