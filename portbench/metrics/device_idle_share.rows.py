"""Per cent of the traced window in which no kernel, copy or memset
ran on the card (the profiler's device timeline)."""

from portbench.metrics._shares import idle_share


def read(ctx):
    return idle_share(ctx)
