"""The comparison that decides ``correct``: the program's rows against the
plain reference of ``reference/``, computed once the window has closed."""

import math

import numpy as np

__all__ = ["compare", "verdict"]


def compare(spec, items, device, precision: str = "float64"):
    """``items``: ``(signal, rows, upto)``, ``rows`` the program's answer
    (None: it never came) and ``upto`` how many leading rows were due
    (None: all of the signal's).  Returns the readings: ``max_abs_err``
    over the rows that came; ``excess_err``, the largest amount by which a
    feature departs from the reference beyond the half unit in the last
    place that rounding the reference to the float32 output costs in any
    case; the answers whose row count is wrong; the answers that never
    came."""
    tables = spec.tables(device, precision)
    err, excess, wrong, missing = 0.0, 0.0, 0, 0
    for signal, rows, upto in items:
        if rows is None:
            missing += 1
            continue
        want = spec.features(signal, device, precision, tables)
        if upto is not None:
            want = want[:upto]
            rows = rows[:upto]
        if rows.shape != want.shape:
            wrong += 1
            continue
        if rows.size:
            d = np.abs(np.asarray(rows, np.float64) - want)
            half_ulp = 0.5 * np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
            big, over = d.max(), (d - half_ulp).max()
            err = max(err, float(big) if np.isfinite(big) else math.inf)
            excess = max(excess, float(over) if np.isfinite(over) else math.inf)
    return {"max_abs_err": err, "excess_err": excess, "row_count_mismatches": wrong,
            "unanswered": missing}


EXACT = ("row_count_mismatches", "unanswered")


def verdict(numbers, limits):
    """``(correct, checks)``: each number the cell's ``limits`` name, and
    the exact counts (limit 0), beside its limit; ``correct`` when none
    passes its limit."""
    checks = {}
    for name, value in numbers.items():
        if name not in limits and name not in EXACT:
            continue
        checks[name] = {"value": value, "limit": limits.get(name, 0)}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
