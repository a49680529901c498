"""Windows each event was counted in (the program's counter
``window_rows_ingested`` over the window's events)."""

from portbench.metrics._counters import counter


def read(ctx):
    n = counter(ctx, "window_rows_ingested")
    if n is None or not ctx.rows:
        return None
    return n / ctx.rows
