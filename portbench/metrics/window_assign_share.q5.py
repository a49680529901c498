"""Per cent of the window spent assigning rows to windows (the
program's span ``window_assign``: the window-id expansion, the
composite ``unique`` and the slot loop of ``_fold_rows``, without the
fold itself; on the pipeline worker)."""

from portbench.metrics._counters import counter_share


def read(ctx):
    return counter_share(ctx, "window_assign_seconds")
