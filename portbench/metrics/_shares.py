"""Arithmetic the per-layer readers share.  Each reader takes the
run's context (see ``portbench/run.py`` ``Context``) and returns a
number, or None where the run has nothing to read."""

from typing import Optional


def phase_share(ctx, *phases) -> Optional[float]:
    """Per cent of the window the main thread spent in ``phases`` of
    the epoch ledger."""
    if ctx.phases is None or not ctx.window_s:
        return None
    return 100.0 * sum(ctx.phases.get(p, 0.0) for p in phases) / ctx.window_s


def idle_share(ctx) -> Optional[float]:
    """Per cent of the traced window in which nothing ran on the
    card."""
    tr = ctx.trace
    if not tr or not tr["window_s"] or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def fold_roofline(ctx) -> Optional[float]:
    """Per cent of the fold's device time that its bytes need at the
    card's peak bandwidth."""
    tr = ctx.trace
    if not tr or not tr.get("fold_kernels") or ctx.fold_bytes is None or not ctx.peak_bytes_per_s:
        return None
    return 100.0 * ctx.fold_bytes / ctx.peak_bytes_per_s / tr["fold_s"]
