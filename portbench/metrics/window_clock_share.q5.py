"""Per cent of the window spent on the window tier's clock (the
program's span ``window_clock``: each ingest's key ids, the retirement
of keys with no open window, the watermarks and the late rows; on the
driver's thread)."""

from portbench.metrics._counters import counter_share


def read(ctx):
    return counter_share(ctx, "window_clock_seconds")
