"""Per cent of the window the dispatch task spent in its vocabulary
work (the program's span ``dispatch_vocab`` on the pipeline worker:
vocabulary sync, slot allocation, the touched-key list)."""

from portbench.metrics._counters import counter_share


def read(ctx):
    return counter_share(ctx, "dispatch_vocab_seconds")
