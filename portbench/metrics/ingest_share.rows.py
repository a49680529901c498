"""Per cent of the window the main thread spent polling sources and
decoding (the ledger phase ``ingest``)."""

from portbench.metrics._shares import phase_share


def read(ctx):
    return phase_share(ctx, "ingest")
