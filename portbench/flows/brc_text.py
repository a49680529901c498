"""1BRC over the challenge's own text format: ``FileSource`` line
batches, split on ``;`` by the port's vectorized ``split_fields``,
then the station stats of the whole stream (as ``chip_smoke.py``'s
``_ingest_brc`` builds it)."""

import numpy as np

import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch import xla
from bytewax_tpu_torch.dataflow import Dataflow

from bytewax_tpu_torch.engine.arrays import ArrayBatch
from bytewax_tpu_torch.ops import text
from portbench import roofline


def _parse(batch):
    lines = batch.cols["line"]
    cols = text.split_fields(lines, 2, ";")
    if cols is None:
        # A chunk the vectorized split refuses (ragged lines): split
        # it line by line.
        parts = [ln.split(";") for ln in lines.tolist()]
        cols = [np.array([p[0] for p in parts]), np.array([p[1] for p in parts])]
    return ArrayBatch({"key": cols[0], "value": cols[1].astype(np.float64)})


def build(source, sinks: dict, cfg: dict, params: dict) -> Dataflow:
    """``sinks["down"]`` receives ``(station, (min, mean, max, count))``."""
    flow = Dataflow("portbench_brc_text")
    s = op.input("inp", flow, source)
    s = op.flat_map_batch("parse", s, _parse)
    stats = xla.stats_final("stats", s)
    op.output("down", stats, sinks["down"])
    return flow


def fold_bytes(stream, blocks, spec: dict) -> float:
    """The fold's logical bytes over the handed ``blocks``: one fold a
    block (a text file is one chunk), keyed by station."""
    return roofline.keyed_fold_bytes(stream, blocks, int(spec["fold_row_bytes"]))
