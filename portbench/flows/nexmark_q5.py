"""NEXMark query 5, "hot items" (github.com/nexmark/nexmark
``queries/q5.sql``), through the port's public operators:

1. a columnar ``flat_map_batch`` keeps the bids (``event_type == 2``),
   keyed by the auction id as a string, with ``date_time`` as the
   event time;
2. step 1, ``count_window`` over ``EventClock(date_time, wait 4 s)``
   (the suite's watermark, ``dateTime - INTERVAL '4' SECOND``) and
   ``SlidingWindower(10 s, 2 s)`` aligned to the Unix epoch, as Flink's
   ``HOP`` aligns it: the bids of each (auction, window), on the device
   window tier (``engine/window_accel.py``);
3. step 2, each window's largest count and the auctions that reach it
   (``num >= maxn``), once a window: a batch mapper folds each delivery
   of step 1's counts into one partial a window, and a host-tier
   ``fold_window`` keyed by the window merges the partials.

Step 2's clock takes the window's start as its event time, with one
tumbling window of the slide's length a key, so each step-1 window is
one step-2 window that closes ``wait + slide`` of wall time after its
first partial arrived.  Step 1 closes a window for each auction on its
own clock, when the auction's watermark (its latest bid - 4 s, plus
the wall time since that bid was ingested) passes the window's end: an
auction whose last bid in the window came at its start closes it up to
``length + 4 s`` after that bid was ingested, one whose bids ran past
the end closes it at once.  So the closes of one window spread over
``length + 4 s`` of wall time, plus how far apart the two ingests lie
and how late a batch or a notification sees a close.  The wait of step
2 is twice ``length + 4 s``: a count that reached step 2 after its
window closed would be late there, and the late stream is checked.

Sinks: ``counts`` (step 1), ``hot`` (step 2) and ``late`` (both steps'
late streams).
"""

from datetime import datetime, timedelta, timezone

import numpy as np

import bytewax_tpu_torch.operators as op
import bytewax_tpu_torch.operators.windowing as win
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.engine.arrays import ArrayBatch, column_ts

from portbench import roofline

EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)
_BID = 2


def _bids(batch):
    """The bids of a batch of events: ``key`` (the auction id) and
    ``ts`` (``date_time``, microseconds)."""
    keep = batch.cols["event_type"] == _BID
    return ArrayBatch({"key": batch.cols["auction"][keep].astype(str), "ts": batch.cols["date_time"][keep]})


def _partials(items):
    """One ``(window, (window id, largest count, auctions reaching
    it))`` partial a window of one delivery of step 1's ``(auction,
    (window id, count))`` counts."""
    best = {}
    for auction, (wid, count) in items:
        top = best.get(wid)
        if top is None or count > top[0]:
            best[wid] = [count, [auction]]
        elif count == top[0]:
            top[1].append(auction)
    return [(str(wid), (wid, n, tuple(a))) for wid, (n, a) in best.items()]


def _merge(acc, part):
    """Fold a partial into a window's ``(largest count, auctions)``."""
    n, auctions = acc
    _wid, pn, pa = part
    if pn > n:
        return (pn, pa)
    if pn == n:
        return (n, auctions + pa)
    return acc


def build(source, sinks: dict, cfg: dict, params: dict) -> Dataflow:
    length = timedelta(seconds=int(cfg["window_length_s"]))
    slide = timedelta(seconds=int(cfg["window_slide_s"]))
    delay = timedelta(seconds=int(cfg["watermark_delay_s"]))

    flow = Dataflow("portbench_nexmark_q5")
    s = op.input("inp", flow, source)
    bids = op.flat_map_batch("bids", s, _bids)
    clock = win.EventClock(ts_getter=column_ts, wait_for_system_duration=delay)
    hop = win.SlidingWindower(length=length, offset=slide, align_to=EPOCH)
    counts = win.count_window("count", bids, clock, hop, key=lambda x: x)

    parts = op.flat_map_batch("partials", counts.down, _partials)
    by_start = win.EventClock(
        ts_getter=lambda part: EPOCH + part[0] * slide,
        wait_for_system_duration=2 * (length + delay),
    )
    hot = win.fold_window(
        "top", parts, by_start, win.TumblingWindower(length=slide, align_to=EPOCH),
        lambda: (0, ()), _merge, lambda a, b: _merge(a, (None, *b)),
    )
    op.output("counts_out", counts.down, sinks["counts"])
    op.output("hot_out", hot.down, sinks["hot"])
    op.output("late_out", op.merge("lates", counts.late, hot.late), sinks["late"])
    return flow


def fold_bytes(stream, blocks, spec: dict) -> float:
    """Step 1's fold bytes over the handed ``blocks``, one fold a
    block: each bid's ``(slot, count)`` row in each of its windows
    (``fold_row_bytes``), and each (auction, window) slot the block
    touches, its one count field read and written."""
    cfg = stream.cfg
    slide_us = int(cfg["window_slide_s"]) * 1_000_000
    per_ts = int(cfg["window_length_s"]) // int(cfg["window_slide_s"])
    total = 0.0
    for b in blocks:
        ev = stream.events([b])
        bid = ev["event_type"] == _BID
        auction, last = ev["auction"][bid], ev["date_time"][bid] // slide_us
        pairs = np.unique(np.concatenate([auction * (1 << 32) + (last - j) for j in range(per_ts)]))
        total += roofline.fold_bytes(len(auction) * per_ts, int(spec["fold_row_bytes"]), len(pairs), 1)
    return total
