"""The plain reference of ``brc-10k``: exact per-station count, sum,
sum of |value|, min and max in integer deci-degrees, over every row the
sources handed over, from the generator's ring of distinct batches and
how many times each was handed over (the per-batch partials of
``chip_smoke.py:982`` ``_reference`` and ``:1190`` ``_stats_oracle``,
combined by multiplicity).  Plain numpy; the control
(:func:`lowp`) is the same aggregation in torch at a lower precision
(:func:`lower_precision`).  The comparison is the stats tuples' shared
one (``_judge.judge``).
"""

import weakref

import numpy as np

from portbench.reference._judge import judge

__all__ = ["canon", "expect", "judge", "lower_precision", "lowp", "pack"]

#: The precision one below each one the configuration may state.
_LOWER = {"float64": "float32", "float32": "bfloat16"}

#: Each stream's station name -> id map, built at its first sink write.
_INDEX = weakref.WeakKeyDictionary()


def _partials(ids: np.ndarray, deci: np.ndarray, n_keys: int):
    ids = ids.astype(np.int64)
    d = deci.astype(np.int64)
    count = np.bincount(ids, minlength=n_keys)
    total = np.bincount(ids, weights=d, minlength=n_keys)
    abs_total = np.bincount(ids, weights=np.abs(d), minlength=n_keys)
    order = np.sort(ids * 4096 + (d + 2048))
    first = np.r_[True, order[1:] // 4096 != order[:-1] // 4096]
    last = np.r_[order[1:] // 4096 != order[:-1] // 4096, True]
    mn = np.full(n_keys, 1 << 30)
    mx = np.full(n_keys, -(1 << 30))
    mn[order[first] // 4096] = order[first] % 4096 - 2048
    mx[order[last] // 4096] = order[last] % 4096 - 2048
    return count, total, abs_total, mn, mx


def multiplicity(stream, handed) -> np.ndarray:
    """How many times each ring entry was handed over."""
    return np.bincount(np.asarray(handed.block, dtype=np.int64) % stream.ring, minlength=stream.ring)


def expect(stream, handed, cell: dict) -> dict:
    """``{station id: (min, mean, max, count, mean |value|)}`` in
    degrees, exact."""
    n_keys = len(stream.stations.names)
    mult = multiplicity(stream, handed)
    count = np.zeros(n_keys, dtype=np.int64)
    total = np.zeros(n_keys)
    abs_total = np.zeros(n_keys)
    mn = np.full(n_keys, 1 << 30)
    mx = np.full(n_keys, -(1 << 30))
    for r in np.flatnonzero(mult).tolist():
        blk = stream.blocks[r]
        c, t, a, lo, hi = _partials(blk.ids, blk.deci, n_keys)
        count += mult[r] * c
        total += mult[r] * t
        abs_total += mult[r] * a
        mn = np.minimum(mn, lo)
        mx = np.maximum(mx, hi)
    want = {
        k: (mn[k] / 10.0, total[k] / count[k] / 10.0, mx[k] / 10.0, int(count[k]),
            abs_total[k] / count[k] / 10.0)
        for k in np.flatnonzero(count).tolist()
    }
    return want


def pack(sink: str, items, stream) -> np.ndarray:
    """``(station, (min, mean, max, count))`` items as rows ``[station
    id, min, mean, max, count]`` (an unknown station is -1)."""
    index = _INDEX.get(stream)
    if index is None:
        index = _INDEX[stream] = {name: i for i, name in enumerate(stream.stations.names.tolist())}
    rows = [(index.get(name, -1), *stats) for name, stats in items]
    return np.array(rows, dtype=np.float64).reshape(-1, 5)


def canon(outputs: dict, stream) -> dict:
    """The sink's packed rows by station id; a station seen twice
    counts as an extra result."""
    got = {}
    for row in outputs["down"].tolist():
        k = int(row[0])
        if k in got:
            k = ("again", len(got))
        got[k] = tuple(row[1:])
    return got


def lower_precision(cfg: dict) -> str:
    """The control's precision: one below the configuration's
    (bfloat16 for float32, float32 for float64)."""
    if cfg["precision"] not in _LOWER:
        msg = f"precision {cfg['precision']!r}: the control knows {sorted(_LOWER)}"
        raise ValueError(msg)
    return _LOWER[cfg["precision"]]


def lowp(stream, handed, cell: dict, dtype, device) -> dict:
    """The control: the reference put in the program's place and
    computed in ``dtype`` (a torch dtype) on ``device``: each handed
    batch's readings folded into per-station sums, counts, minima and
    maxima held in ``dtype``, one batch after another."""
    import torch

    n_keys = len(stream.stations.names)
    cnt = torch.zeros(n_keys, dtype=dtype, device=device)
    tot = torch.zeros(n_keys, dtype=dtype, device=device)
    mn = torch.full((n_keys,), float("inf"), dtype=dtype, device=device)
    mx = torch.full((n_keys,), float("-inf"), dtype=dtype, device=device)
    blocks = [b % stream.ring for b in handed.block]
    dev_blocks = {}
    for r in sorted(set(blocks)):
        blk = stream.blocks[r]
        ids = torch.from_numpy(blk.ids.astype(np.int64)).to(device)
        vals = (torch.from_numpy(blk.deci.astype(np.float32)).to(device) / 10).to(dtype)
        dev_blocks[r] = (ids, vals, torch.ones_like(vals))
    for r in blocks:
        ids, vals, ones = dev_blocks[r]
        cnt.index_add_(0, ids, ones)
        tot.index_add_(0, ids, vals)
        mn.scatter_reduce_(0, ids, vals, "amin")
        mx.scatter_reduce_(0, ids, vals, "amax")
    c = cnt.double().cpu().numpy()
    t = tot.double().cpu().numpy()
    lo = mn.double().cpu().numpy()
    hi = mx.double().cpu().numpy()
    return {k: (lo[k], t[k] / c[k], hi[k], c[k]) for k in np.flatnonzero(c).tolist()}
