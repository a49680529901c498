"""The fold's share of its roofline: the least time its logical bytes
need at the card's peak bandwidth, over the device time of every
kernel launched under the ``portbench.fold`` range."""

from portbench.metrics._shares import fold_roofline


def read(ctx):
    return fold_roofline(ctx)
