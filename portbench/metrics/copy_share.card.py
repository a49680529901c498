"""Per cent of the window the dispatch task spent packing and copying
(the program's span ``dispatch_copy`` on the pipeline worker: dtype
conversion, packing, the blocking host-to-device copies)."""

from portbench.metrics._counters import counter_share


def read(ctx):
    return counter_share(ctx, "dispatch_copy_seconds")
