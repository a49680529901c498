"""1BRC over columnar batches: the station stats of the whole
stream, emitted at its end (upstream bytewax ``examples/1brc.py``;
the port's ``models/brc.py`` ``brc_flow_columnar`` without its host
rounding step, so the sink sees the fold's own numbers)."""

import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch import xla
from bytewax_tpu_torch.dataflow import Dataflow
from portbench import roofline


def build(source, sinks: dict, cfg: dict, params: dict) -> Dataflow:
    """``source`` hands dictionary-encoded batches; ``sinks["down"]``
    receives ``(station, (min, mean, max, count))``."""
    flow = Dataflow("portbench_brc")
    s = op.input("inp", flow, source)
    stats = xla.stats_final("stats", s)
    op.output("down", stats, sinks["down"])
    return flow


def fold_bytes(stream, blocks, spec: dict) -> float:
    """The fold's logical bytes over the handed ``blocks``: one fold a
    block (a text file is one chunk), keyed by station."""
    return roofline.keyed_fold_bytes(stream, blocks, int(spec["fold_row_bytes"]))
