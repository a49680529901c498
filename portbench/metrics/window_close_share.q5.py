"""Per cent of the window spent closing due windows (the program's
span ``window_close``: ``_open_arrays``, the due scan, the snapshot
fetch, the event building, ``notify_at`` and ``on_eof``; on the
pipeline worker, or on the driver's thread for a notification and the
end of the stream)."""

from portbench.metrics._counters import counter_share


def read(ctx):
    return counter_share(ctx, "window_close_seconds")
