"""The comparison that decides ``correct``, shared by the stats
references.

Results are dicts keyed by station id whose values are ``(min, mean,
max, count, mean |value|)`` in degrees.  The reference gives exact
float64 values; the program's sink items, or the control's
lower-precision aggregates, are put in the same form and judged
against them.
"""

from dataclasses import dataclass, field
from typing import Dict

__all__ = ["Verdict", "judge"]


@dataclass
class Verdict:
    attempted: int
    failed: int
    #: name -> (reading, limit); the order is the print order.
    checks: Dict[str, tuple] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(value <= limit for value, limit in self.checks.values())


def judge(got: dict, want: dict, limits: dict) -> Verdict:
    """Every result of ``want`` against ``got``: the set of results
    (``missing``: absent or extra, limit 0), each count
    (``count_err``, limit 0), min and max (``minmax_err_deci``: the
    widest gap in deci-degrees), the mean (``mean_err``: the widest
    gap over the result's mean |value|)."""
    missing = len(set(want) ^ set(got))
    failed = missing
    count_err = minmax_err = mean_err = 0.0
    lim_mm, lim_mean = limits["minmax_err_deci"], limits["mean_err"]
    for kw, (mn, mean, mx, count, mean_abs) in want.items():
        g = got.get(kw)
        if g is None:
            continue
        gmn, gmean, gmx, gcount = g[:4]
        c = abs(float(gcount) - count)
        mm = max(abs(float(gmn) - mn), abs(float(gmx) - mx)) * 10.0
        if mean_abs:
            me = abs(float(gmean) - mean) / mean_abs
        else:
            me = 0.0 if float(gmean) == mean else float("inf")
        c, mm, me = _finite(c), _finite(mm), _finite(me)
        if not (c <= limits["count_err"] and mm <= lim_mm and me <= lim_mean):
            failed += 1
        count_err, minmax_err, mean_err = max(count_err, c), max(minmax_err, mm), max(mean_err, me)
    checks = {
        "missing": (float(missing), float(limits["missing"])),
        "count_err": (_finite(count_err), float(limits["count_err"])),
        "minmax_err_deci": (_finite(minmax_err), float(lim_mm)),
        "mean_err": (_finite(mean_err), float(lim_mean)),
    }
    return Verdict(len(want), failed, checks)


def _finite(x: float) -> float:
    """A NaN never compares above a limit: count it as infinite."""
    return float("inf") if x != x else float(x)
