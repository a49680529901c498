"""Peaks of the cards the benchmark runs on, and the bytes the fold
must move, counted from the cell's logical inputs.

The fold's least time is its bytes over the card's memory bandwidth:
each input row's key and value counted once in the cell's own dtypes
(``fold_row_bytes`` in the cell file), and each touched key's fields
at 4 bytes, read once and written once, in every fold.  The same count
holds whatever implements the fold, so its share of the roofline
compares implementations.  A flow module's ``fold_bytes`` applies it
to the blocks a run handed over.
"""

import numpy as np

__all__ = ["PEAKS", "fold_bytes", "keyed_fold_bytes", "peak_bytes_per_s"]

#: Published peaks (NVIDIA's data sheet, SXM part) at the full power
#: limit of 700 W, by the name ``torch.cuda.get_device_name`` gives.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def peak_bytes_per_s(kind: str):
    """The card's memory bandwidth, or None for a card not in the
    table (its roofline is then not reported)."""
    peak = PEAKS.get(kind)
    return None if peak is None else peak["hbm_bytes_per_s"]


def fold_bytes(rows: int, row_bytes: int, slots: int, n_fields: int) -> float:
    """Bytes a fold of ``rows`` input rows touching ``slots`` slots of
    ``n_fields`` 4-byte fields must move at the least."""
    return float(rows) * row_bytes + float(slots) * n_fields * 4 * 2


def keyed_fold_bytes(stream, blocks, row_bytes: int, n_fields: int = 4) -> float:
    """The fold bytes of a keyed aggregation that folds each handed
    block once: its rows, and the distinct keys it touches."""
    per_ring = {}
    total = 0.0
    for b in blocks:
        r = int(b) % stream.ring
        if r not in per_ring:
            keys = len(np.unique(stream.blocks[r].ids))
            per_ring[r] = fold_bytes(stream.batch_rows, row_bytes, keys, n_fields)
        total += per_ring[r]
    return total
