"""Cron-style UTC maintenance-window membership.

A pool's ``maintenanceWindow.cron`` is a standard 5-field cron
expression (minute hour day-of-month month day-of-week, UTC) read as a
*membership test*: the window is OPEN at instant T iff every field of
T's UTC breakdown matches the expression.  ``"* 2-5 * * 6,0"`` therefore
means "02:00–05:59 UTC on weekends" — the natural way to write a
maintenance window without a separate duration field, and crash-safe for
free because openness is a pure function of the clock (no state to
persist across controller incarnations).

Standard cron quirks are honored: ``*``, lists, ranges, steps
(``*/15``), day-of-week 0 and 7 both meaning Sunday, and the dom/dow OR
rule (when *both* are restricted, matching either opens the window).
"""

from __future__ import annotations

import calendar
import time

# Scanning horizon for next_open: a full leap cycle covers every
# reachable (month, dom, dow) combination, so a window that has not
# opened within it never opens (e.g. "0 0 31 2 *" — Feb 31).
NEXT_OPEN_HORIZON_S = 4 * 366 * 86400.0

# Field index -> (low, high) inclusive bounds, standard cron order.
_BOUNDS = ((0, 59), (0, 23), (1, 31), (1, 12), (0, 7))
_FIELD_NAMES = ("minute", "hour", "day-of-month", "month", "day-of-week")


def _parse_field(text: str, lo: int, hi: int, name: str) -> frozenset[int]:
    """Expand one cron field into the set of matching values."""
    values: set[int] = set()
    for part in text.split(","):
        part = part.strip()
        if not part:
            raise ValueError(f"empty element in cron {name} field {text!r}")
        step = 1
        if "/" in part:
            part, step_text = part.split("/", 1)
            if not step_text.isdigit() or int(step_text) < 1:
                raise ValueError(
                    f"invalid step {step_text!r} in cron {name} field"
                )
            step = int(step_text)
        if part == "*":
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            if not (a.isdigit() and b.isdigit()):
                raise ValueError(
                    f"invalid range {part!r} in cron {name} field"
                )
            start, end = int(a), int(b)
        elif part.isdigit():
            start = end = int(part)
        else:
            raise ValueError(f"invalid value {part!r} in cron {name} field")
        if start > end or start < lo or end > hi:
            raise ValueError(
                f"cron {name} value {part!r} out of range [{lo}, {hi}]"
            )
        values.update(range(start, end + 1, step))
    return frozenset(values)


def _parse(cron: str) -> tuple[frozenset[int], ...]:
    fields = cron.split()
    if len(fields) != 5:
        raise ValueError(
            f"cron expression must have 5 fields, got {len(fields)}: {cron!r}"
        )
    return tuple(
        _parse_field(text, lo, hi, name)
        for text, (lo, hi), name in zip(fields, _BOUNDS, _FIELD_NAMES)
    )


def validate_window(cron: str) -> None:
    """Raise ValueError when ``cron`` is not a valid 5-field expression."""
    _parse(cron)


def window_open(cron: str, now: float | None = None) -> bool:
    """True when the UTC instant ``now`` (epoch seconds; default current
    time) falls inside the window described by ``cron``."""
    minute_f, hour_f, dom_f, month_f, dow_f = _parse(cron)
    t = time.gmtime(time.time() if now is None else now)
    if t.tm_min not in minute_f or t.tm_hour not in hour_f:
        return False
    if t.tm_mon not in month_f:
        return False
    # Cron dow: 0 and 7 are both Sunday; struct_time wday: Monday=0.
    dow = (t.tm_wday + 1) % 7
    dom_ok = t.tm_mday in dom_f
    dow_ok = dow in dow_f or (dow == 0 and 7 in dow_f)
    dom_restricted = dom_f != frozenset(range(1, 32))
    dow_restricted = dow_f != frozenset(range(0, 8))
    if dom_restricted and dow_restricted:
        # Standard cron OR rule when both are restricted.
        return dom_ok or dow_ok
    return dom_ok and dow_ok


def _day_matches(
    t: time.struct_time,
    dom_f: frozenset[int],
    month_f: frozenset[int],
    dow_f: frozenset[int],
) -> bool:
    """The date part of the membership test (same dom/dow OR rule as
    :func:`window_open`), independent of the time of day."""
    if t.tm_mon not in month_f:
        return False
    dow = (t.tm_wday + 1) % 7
    dom_ok = t.tm_mday in dom_f
    dow_ok = dow in dow_f or (dow == 0 and 7 in dow_f)
    dom_restricted = dom_f != frozenset(range(1, 32))
    dow_restricted = dow_f != frozenset(range(0, 8))
    if dom_restricted and dow_restricted:
        return dom_ok or dow_ok
    return dom_ok and dow_ok


def next_open(
    cron: str,
    now: float | None = None,
    horizon_s: float = NEXT_OPEN_HORIZON_S,
) -> float | None:
    """Earliest UTC epoch second ≥ ``now`` at which the window is open,
    or None when it never opens within ``horizon_s`` (a provably
    unreachable window — e.g. ``"0 0 31 2 *"``).

    Deterministic and pure (clock in, epoch out), so the planner can
    project wave start times and admission can reject never-opening
    windows without waiting on wall-clock."""
    minute_f, hour_f, dom_f, month_f, dow_f = _parse(cron)
    now = time.time() if now is None else now
    if window_open(cron, now):
        return now
    hours = sorted(hour_f)
    minutes = sorted(minute_f)
    # Scan day by day from the current UTC midnight: cheap (≤ ~1464
    # struct_time conversions over the full horizon) and immune to the
    # varying month/DST-free UTC day lengths.
    t0 = time.gmtime(now)
    day_start = calendar.timegm(
        (t0.tm_year, t0.tm_mon, t0.tm_mday, 0, 0, 0, 0, 0, 0)
    )
    deadline = now + horizon_s
    day = float(day_start)
    while day <= deadline:
        if _day_matches(time.gmtime(day), dom_f, month_f, dow_f):
            for hour in hours:
                for minute in minutes:
                    candidate = day + hour * 3600 + minute * 60
                    if candidate >= now:
                        return candidate if candidate <= deadline else None
        day += 86400.0
    return None
