"""Arithmetic over the program's own counters (``engine.flight``
``RECORDER.counters``, their deltas over the window).  A reader
returns None where the program keeps no such counter."""

from typing import Optional


def counter(ctx, name: str) -> Optional[float]:
    """The window's delta of the counter ``name``, or None."""
    if ctx.counters is None:
        return None
    return ctx.counters.get(name)


def counter_share(ctx, name: str) -> Optional[float]:
    """Per cent of the window that the seconds counter ``name``
    (a span's, on any thread) covers."""
    seconds = counter(ctx, name)
    if seconds is None or not ctx.window_s:
        return None
    return 100.0 * seconds / ctx.window_s
