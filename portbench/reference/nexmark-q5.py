"""The plain reference of ``nexmark-q5``: NEXMark query 5 ("hot
items", github.com/nexmark/nexmark ``queries/q5.sql``) over the events
of every block the feed handed over, in plain PyTorch on the CPU
(int64 tensors; numpy only for the generator's arrays and the sink's
packed rows).

- Step 1: the bids of each (auction, window), for every
  ``HOP(dateTime, slide, length)`` window a bid falls in, windows at
  the end of the stream included (the port closes everything at its
  end).
- Step 2: each window's largest count ``maxn`` and the auctions whose
  count reaches it.

It owns its sink packing and its comparison: ``missing`` (an (auction,
window) count or a window that is absent, extra or emitted twice),
``count_err`` (the widest gap of a count), ``max_err`` (of a window's
largest count), ``hot_set_err`` (windows whose set of auctions
differs) and ``late`` (rows at the ``late`` sink), each with limit 0.
The control counts in bfloat16, which is exact only up to 256.
"""

import numpy as np
import torch

from portbench.reference._judge import Verdict

__all__ = ["canon", "expect", "judge", "lower_precision", "lowp", "pack"]

_BID = 2
_SHIFT = 1 << 32


def _bid_windows(stream, blocks) -> torch.Tensor:
    """``auction * 2^32 + window id`` of every bid of ``blocks`` in
    every window it falls in (an int64 tensor): window ``w`` spans
    ``[w * slide, w * slide + length)`` seconds after the epoch."""
    cfg = stream.cfg
    ev = stream.events(blocks)
    bid = torch.from_numpy(ev["event_type"]) == _BID
    auction = torch.from_numpy(ev["auction"])[bid]
    last = torch.div(torch.from_numpy(ev["date_time"])[bid], int(cfg["window_slide_s"]) * 1_000_000,
                     rounding_mode="floor")
    per_ts = int(cfg["window_length_s"]) // int(cfg["window_slide_s"])
    return auction.repeat(per_ts) * _SHIFT + torch.cat([last - j for j in range(per_ts)])


def _pairs(keys: torch.Tensor) -> torch.Tensor:
    """``[auction, window]`` rows of composite keys."""
    return torch.stack([torch.div(keys, _SHIFT, rounding_mode="floor"), keys % _SHIFT], dim=1)


def _hot(pairs: torch.Tensor, counts: torch.Tensor) -> dict:
    """``{window: (largest count, sorted auctions reaching it)}`` of
    ``(auction, window)`` pairs and their counts."""
    wins, of = torch.unique(pairs[:, 1], return_inverse=True)
    top = torch.zeros(len(wins), dtype=counts.dtype).scatter_reduce(0, of, counts, "amax", include_self=False)
    at = counts == top[of]
    hot = {}
    for w, a in zip(pairs[at, 1].tolist(), pairs[at, 0].tolist()):
        hot.setdefault(w, []).append(a)
    return {w: (top[i].item(), tuple(sorted(hot[w]))) for i, w in enumerate(wins.tolist())}


def _result(keys: torch.Tensor, counts: torch.Tensor, late: int = 0) -> dict:
    """Sorted composite keys, their counts, the hot auctions."""
    return {"keys": keys, "counts": counts.double(), "hot": _hot(_pairs(keys), counts), "late": late}


def expect(stream, handed, cell: dict) -> dict:
    """The exact counts, each window's hot auctions, and no late row."""
    keys, counts = torch.unique(_bid_windows(stream, handed.block), return_counts=True)
    return _result(keys, counts)


def pack(sink: str, items, stream) -> np.ndarray:
    """``counts``: ``("<auction>", (window id, count))`` items as int64
    rows ``[auction, window, count]``; ``hot``: ``("<window>", (window
    id, (maxn, auctions)))`` items as one row ``[window, maxn, number of
    auctions, auction]`` an auction (auction -1 for an empty set);
    ``late``: one row ``[1]`` an item."""
    if sink == "counts":
        rows = [(int(k), w, c) for k, (w, c) in items]
        return np.array(rows, dtype=np.int64).reshape(-1, 3)
    if sink == "hot":
        rows = [(int(k), n, len(a), int(x)) for k, (_w, (n, a)) in items for x in a or (-1,)]
        return np.array(rows, dtype=np.int64).reshape(-1, 4)
    return np.ones((len(items), 1), dtype=np.int64)


def canon(outputs: dict, stream) -> dict:
    """The sinks' rows in the reference's form; an (auction, window)
    count or a window's auctions emitted twice count as ``again``."""
    rows = torch.from_numpy(outputs["counts"])
    keys, first, n = torch.unique(rows[:, 0] * _SHIFT + rows[:, 1], return_inverse=True, return_counts=True)
    counts = torch.zeros(len(keys), dtype=torch.int64).index_put_((first,), rows[:, 2])
    hot, again = {}, int((n - 1).sum())
    for w, maxn, size, a in outputs["hot"].tolist():
        got = hot.setdefault(w, [maxn, size, []])
        again += got[:2] != [maxn, size]
        if a >= 0:
            got[2].append(a)
    for w, (maxn, size, auctions) in hot.items():
        again += len(auctions) != size
        hot[w] = (maxn, tuple(sorted(set(auctions))))
    return {"keys": keys, "counts": counts.double(), "hot": hot, "late": len(outputs["late"]),
            "again": again}


def judge(got: dict, want: dict, limits: dict) -> Verdict:
    """Every (auction, window) count and every window's largest count
    and auctions, exactly; and the late rows."""
    key_w, key_g = want["keys"], got["keys"]
    pos = torch.searchsorted(key_g, key_w).clamp(max=max(len(key_g) - 1, 0))
    found = key_g[pos] == key_w if len(key_g) else torch.zeros(len(key_w), dtype=torch.bool)
    errs = (got["counts"][pos[found]] - want["counts"][found]).abs() if len(key_g) else torch.zeros(0)
    common = int(found.sum())
    missing = (len(key_w) - common) + (len(key_g) - common) + got.get("again", 0)
    windows_w, windows_g = set(want["hot"]), set(got["hot"])
    missing += len(windows_w ^ windows_g)
    max_errs = [abs(got["hot"][w][0] - want["hot"][w][0]) for w in windows_w & windows_g]
    set_errs = sum(got["hot"][w][1] != want["hot"][w][1] for w in windows_w & windows_g)
    count_err = float(errs.max()) if len(errs) else 0.0
    max_err = float(max(max_errs, default=0.0))
    failed = missing + int((errs > limits["count_err"]).sum()) + set_errs
    failed += sum(e > limits["max_err"] for e in max_errs)
    checks = {
        "missing": (float(missing), float(limits["missing"])),
        "count_err": (count_err, float(limits["count_err"])),
        "max_err": (max_err, float(limits["max_err"])),
        "hot_set_err": (float(set_errs), float(limits["hot_set_err"])),
        "late": (float(got["late"]), float(limits["late"])),
    }
    return Verdict(len(key_w) + len(windows_w), failed, checks)


def lower_precision(cfg: dict) -> str:
    """Exact counts: the control accumulates them in bfloat16."""
    return "bfloat16"


def lowp(stream, handed, cell: dict, dtype, device) -> dict:
    """The control: each handed block's bids added into a table of
    (auction, window) counts held in ``dtype``, one block after
    another; each window's largest count and auctions from that
    table."""
    per_block = [_bid_windows(stream, [b]) for b in handed.block]
    keys, inverse = torch.unique(torch.cat(per_block), return_inverse=True)
    table = torch.zeros(len(keys), dtype=dtype, device=device)
    start = 0
    for block in per_block:
        idx = inverse[start:start + len(block)].to(device)
        table.index_add_(0, idx, torch.ones(len(block), dtype=dtype, device=device))
        start += len(block)
    return _result(keys, table.double().cpu())
