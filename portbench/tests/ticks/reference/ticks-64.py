"""The plain reference of ``ticks-64``: the exact count of events for
each (key, sliding window), from the generator's events of every block
the feed handed over.  Its own sink packing and comparison; the
control counts in bfloat16, which is exact only up to 256."""

import numpy as np

from portbench.reference._judge import Verdict

__all__ = ["canon", "expect", "judge", "lower_precision", "lowp", "pack"]


def _windows(key: np.ndarray, ts: np.ndarray, cfg: dict) -> tuple:
    """``(key, window id)`` of every event and window it falls in:
    window ``w`` spans ``[t0 + w * offset, t0 + w * offset + length)``."""
    length, offset = int(cfg["window_us"]), int(cfg["offset_us"])
    rel = ts - int(cfg["t0_us"])
    last = rel // offset
    first = (rel - length) // offset + 1
    keys, wins = [], []
    for j in range(-(-length // offset)):
        ok = last - j >= first
        keys.append(key[ok])
        wins.append(last[ok] - j)
    return np.concatenate(keys), np.concatenate(wins)


def expect(stream, handed, cell: dict) -> dict:
    """``{(key, window id): count}``, exact."""
    key, wid = _windows(*stream.events(handed.block), stream.cfg)
    pairs, count = np.unique(np.stack([key, wid], axis=1), axis=0, return_counts=True)
    return {(int(k), int(w)): int(c) for (k, w), c in zip(pairs.tolist(), count.tolist())}


def pack(sink: str, items, stream) -> np.ndarray:
    """``("k<key>", (window id, count))`` items as int64 rows ``[key,
    window id, count]``."""
    rows = [(int(k[1:]), wid, count) for k, (wid, count) in items]
    return np.array(rows, dtype=np.int64).reshape(-1, 3)


def canon(outputs: dict, stream) -> dict:
    """The sink's rows by (key, window); a window seen twice counts as
    an extra result."""
    got = {}
    for k, w, c in outputs["down"].tolist():
        kw = (k, w) if (k, w) not in got else ("again", len(got))
        got[kw] = c
    return got


def judge(got: dict, want: dict, limits: dict) -> Verdict:
    """The set of windows (``missing``: absent or extra) and each
    window's count (``count_err``: the widest gap), both exact."""
    missing = len(set(want) ^ set(got))
    errs = [abs(float(got[kw]) - c) for kw, c in want.items() if kw in got]
    count_err = max(errs, default=0.0)
    failed = missing + sum(e > limits["count_err"] for e in errs)
    checks = {
        "missing": (float(missing), float(limits["missing"])),
        "count_err": (count_err, float(limits["count_err"])),
    }
    return Verdict(len(want), failed, checks)


def lower_precision(cfg: dict) -> str:
    """Exact counts: the control accumulates them in bfloat16."""
    return "bfloat16"


def lowp(stream, handed, cell: dict, dtype, device) -> dict:
    """The control: each handed block's (key, window) counts added into
    a table held in ``dtype``, one block after another."""
    import torch

    per_block = [_windows(*stream.events([b]), stream.cfg) for b in handed.block]
    pairs, inverse = np.unique(
        np.concatenate([np.stack(kw, axis=1) for kw in per_block]), axis=0, return_inverse=True
    )
    table = torch.zeros(len(pairs), dtype=dtype, device=device)
    start = 0
    for key, _wid in per_block:
        idx = torch.from_numpy(inverse[start:start + len(key)].ravel()).to(device)
        table.index_add_(0, idx, torch.ones(len(key), dtype=dtype, device=device))
        start += len(key)
    counts = table.double().cpu().numpy()
    return {(int(k), int(w)): float(c) for (k, w), c in zip(pairs.tolist(), counts.tolist())}
