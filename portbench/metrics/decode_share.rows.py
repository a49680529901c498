"""Per cent of the window spent decoding text chunks into line arrays
(the program's span ``decode`` around ``ops.text.split_lines``, with
the card gather and its readback, inside the ledger phase
``ingest``)."""

from portbench.metrics._counters import counter_share


def read(ctx):
    return counter_share(ctx, "decode_seconds")
