"""Per cent of the window the main thread spent in the host tier:
the ledger phases ``host`` (a step's own work: routing, keys, window
math, emission) and ``flush`` (waiting on the dispatch pipeline)."""

from portbench.metrics._shares import phase_share


def read(ctx):
    return phase_share(ctx, "host", "flush")
