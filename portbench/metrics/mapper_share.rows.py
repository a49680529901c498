"""Per cent of the window spent in the flow's own batch mappers (the
program's span ``mapper`` around each ``flat_map_batch`` mapper call,
inside the ledger phase ``host``)."""

from portbench.metrics._counters import counter_share


def read(ctx):
    return counter_share(ctx, "mapper_seconds")
