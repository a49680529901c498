"""Rows a second the card's fold sustains: the rows handed over in the
window over the device time of the fold's kernels in it, from the
profiler's device timeline.  The card's capacity for the stream, apart
from the host that paces it; None where no fold kernel ran on a card."""


def read(ctx):
    tr = ctx.trace
    if not tr or not tr.get("fold_kernels") or not tr["fold_s"]:
        return None
    return ctx.rows / tr["fold_s"]
