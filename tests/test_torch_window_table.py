"""The port's device window tier keeps its open sliding and tumbling
windows in columns (``window_accel._OpenWindows``): a close scans them
as arrays and does Python work only per window that closes.

Random streams of rising keys that go quiet, retire and come back,
with late rows, closed by ingests and by notifications on a clock
moved by hand:

- through a dataflow at pipeline depths 1 and 2, with string and
  dictionary-encoded keys, the device tier gives the JAX package's
  host tier output: counts, late rows and window metadata;
- on the state alone, on the single-device and the sharded slot
  table, every close emits its windows in the order they opened, each
  with its value and then its metadata; windows of one id closed
  together carry equal metadata that are distinct objects;
  ``notify_at`` is the brute-force minimum over the open windows; the
  table compacts, and its live count is the windows opened less those
  closed;
- a resume from the state's snapshots and an ``extract_keys`` /
  ``inject_keys`` round trip mid-stream change no output.
"""

import os
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

import bytewax_tpu.testing as ref_testing
from bytewax_tpu_torch.engine import flight
from bytewax_tpu_torch.engine import window_accel as wa
from bytewax_tpu_torch.engine.arrays import ArrayBatch, column_ts
from bytewax_tpu_torch.testing import run_main
from bytewax_tpu_torch.utils import VIRTUAL_DEVICES_ENV, force_platform
from tests.test_torch_window_retire import (
    ALIGN,
    BASE,
    PORT,
    REF,
    _Clock,
    _fake_now,
    _late_key,
    _timed_source,
)

#: Sliding windows of 10 s every 2 s, or tumbling windows of 4 s.
SHAPES = {
    "sliding": (timedelta(seconds=10), timedelta(seconds=2)),
    "tumbling": (timedelta(seconds=4), timedelta(seconds=4)),
}


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    saved = {name: os.environ.get(name) for name in ("BYTEWAX_TPU_PLATFORM", VIRTUAL_DEVICES_ENV)}
    force_platform("cpu")
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "0")
    monkeypatch.setattr(wa, "datetime", _Clock)
    _Clock.t = ALIGN.timestamp()
    yield
    for name, value in saved.items():
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value


def _counters() -> dict:
    return dict(flight.RECORDER.counters)


def _delta(before: dict, name: str) -> int:
    return flight.RECORDER.counters.get(name, 0) - before.get(name, 0)


# -- through a dataflow, against the JAX package's host tier -----------------


#: The clock's wait: a key's windows outlive the three batches (9 s)
#: it stays in the pool, so none comes due between two ingests of it
#: (at depth 2 a close due then would retire the key after the ingest
#: on the device tier and before it on the host tier).
_WAIT = timedelta(seconds=8)


def _flow_batches(seed: int, n: int = 24):
    """``(keys, seconds, at)`` batches 3 s apart: six new keys a batch
    over a pool of the newest 18, rows in random order within 6 s; four
    rows a batch planted 20 s behind an earlier row of their key (late
    on any clock); every sixth batch also brings back keys quiet for
    30 s or more (retired), and every eighth is followed by a 25 s
    quiet spell in which notifications close every open window."""
    rng = np.random.default_rng(seed)
    out, t, at = [], 0, 0
    for b in range(n):
        newest = 6 * (b + 1)
        pool = np.arange(max(0, newest - 18), newest)
        if b % 6 == 5 and newest > 60:
            pool = np.concatenate([pool, rng.choice(newest - 60, 4)])
        keys = rng.choice(pool, 40)
        secs = t + rng.integers(0, 6, 40)
        for i in rng.choice(np.arange(20, 40), 4, replace=False):
            earlier = np.nonzero(keys[:20] == keys[i])[0]
            if len(earlier):
                secs[i] = secs[earlier[0]] - 20
        out.append((keys, secs, at))
        t += 3
        at += 28 if b % 8 == 7 else 3
    return out


def _flow(batches, encoding: str, shape: str, pkg):
    length, offset = SHAPES[shape]
    flow = pkg.Dataflow("table")
    s = pkg.op.input("inp", flow, _timed_source(batches, encoding, pkg))
    clock = pkg.win.EventClock(ts_getter=pkg.column_ts, wait_for_system_duration=_WAIT,
                               now_getter=_fake_now)
    if shape == "sliding":
        windower = pkg.win.SlidingWindower(length=length, offset=offset, align_to=ALIGN)
    else:
        windower = pkg.win.TumblingWindower(length=length, align_to=ALIGN)
    wo = pkg.win.count_window("count", s, clock, windower, key=lambda x: x)
    down, late, meta = [], [], []
    pkg.op.output("down", wo.down, pkg.testing.TestingSink(down))
    pkg.op.output("late", wo.late, pkg.testing.TestingSink(late))
    pkg.op.output("meta", wo.meta, pkg.testing.TestingSink(meta))
    return flow, down, late, meta


def _outputs(down, late, meta):
    return (
        sorted(down),
        sorted(late, key=_late_key),
        sorted((k, w, m.open_time, m.close_time) for k, (w, m) in meta),
    )


@pytest.mark.parametrize("encoding", ["key", "key_id"])
@pytest.mark.parametrize("depth", ["1", "2"])
@pytest.mark.parametrize("shape", ["sliding", "tumbling"])
def test_the_device_tier_matches_the_host_tier(monkeypatch, shape, depth, encoding):
    """Counts, late rows and metadata of a random stream through the
    port's device tier equal the JAX package's host tier's and the
    port's own; the table empties by the end."""
    monkeypatch.setenv("BYTEWAX_TPU_PIPELINE_DEPTH", depth)
    # One delivery a batch: the coalescer would merge them.
    monkeypatch.setenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", "0")
    monkeypatch.setattr(PORT.op, "_get_system_utc", _fake_now)
    batches = _flow_batches(seed=int(depth) * 10 + len(encoding) + len(shape))

    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "0")
    flow, *outs = _flow(batches, encoding, shape, REF)
    ref_testing.run_main(flow)
    ref = _outputs(*outs)
    assert ref[0] and ref[1]

    runs = {}
    for accel in ("0", "1"):
        monkeypatch.setenv("BYTEWAX_TPU_ACCEL", accel)
        before = _counters()
        flow, *outs = _flow(batches, encoding, shape, PORT)
        run_main(flow)
        runs[accel] = _outputs(*outs)
        assert (_delta(before, "window_rows_ingested") > 0) == (accel == "1")
    assert runs["1"] == ref
    assert runs["0"] == ref
    # Every window opened closed, by scans that closed many at once,
    # and some keys retired and came back.
    opened = _delta(before, "windows_opened")
    assert opened == _delta(before, "windows_closed") == len(ref[0])
    assert 0 < _delta(before, "window_close_scans") < opened
    assert _delta(before, "window_keys_retired") > len({k for keys, _s, _at in batches for k in keys.tolist()})


# -- the state alone, against an oracle of the stream --------------------------

#: Event seconds a batch; the hand-moved clock runs 2 s a batch, so a
#: row of a key that went quiet is never behind its watermark.
_PERIOD = 4


def _state_batches(seed: int, n: int = 30):
    """``(keys, event us, values, late)`` batches: on-time rows in
    increasing event time within the batch's first second, over a
    sliding pool of rising keys with a few long-quiet keys back every
    fifth batch; then rows planted behind an earlier row of their key
    in the same batch (late on any clock)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        newest = 8 * (b + 1)
        pool = np.arange(max(0, newest - 24), newest)
        if b % 5 == 4 and newest > 60:
            pool = np.concatenate([pool, rng.choice(newest - 60, 3)])
        m = 48
        keys = rng.choice(pool, m)
        us = b * _PERIOD * 1_000_000 + np.sort(rng.choice(1_000_000, m, replace=False))
        vals = rng.integers(-50, 50, m)
        late = np.zeros(m, dtype=bool)
        planted = rng.choice(np.arange(m // 2, m), 6, replace=False)
        for i in planted:
            earlier = np.nonzero(keys[: m // 2] == keys[i])[0]
            if len(earlier):
                us[i] = us[earlier[0]] - rng.integers(1, 3_000_000)
                late[i] = True
        out.append((keys, us, vals, late))
    return out


def _make(kind: str, shape: str, table: str, monkeypatch):
    if table == "sharded":
        monkeypatch.setenv("BYTEWAX_TPU_SHARD", "4")
        monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "4")
    length, offset = SHAPES[shape]
    state = wa.WindowAccelSpec(kind, column_ts, ALIGN, length, offset, timedelta(0)).make_state()
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "0")
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV, raising=False)
    assert (type(state.agg).__name__ == "ShardedAggState") == (table == "sharded")
    return state


def _batch(kind: str, keys, us, vals) -> ArrayBatch:
    cols = {"key": np.char.add("k", keys.astype(str)), "ts": BASE + us.astype("timedelta64[us]")}
    if kind != "count":
        cols["value"] = vals
    return ArrayBatch(cols)


class _Oracle:
    """The open windows of one state as the stream says they must be:
    each window's value, and its place in the order windows opened (a
    batch's new windows open in (key id, window id) order)."""

    def __init__(self, state):
        self.state = state
        spec = state.spec
        self.length_us, self.offset_us = spec.length_us, spec.offset_us
        self.expand = state.expand
        self.rows = {}  # (key, wid) -> on-time values
        self.order = {}  # (key, wid) -> opening rank
        self.rank = 0
        self.same_wid_pairs = 0

    def close_us(self, wid: int) -> float:
        return self.state.spec.align_us + wid * self.offset_us + self.length_us

    def ingest(self, keys, us, vals, late) -> None:
        new = {}
        for key, u, v, is_late in zip(keys.tolist(), us.tolist(), vals.tolist(), late.tolist()):
            if is_late:
                continue
            name = f"k{key}"
            hi = u // int(self.offset_us)
            for wid in range(hi - self.expand + 1, hi + 1):
                if u < wid * self.offset_us + self.length_us:
                    w = (name, wid)
                    if w not in self.rows:
                        new[w] = (self.state.key_ids[name], wid)
                    self.rows.setdefault(w, []).append(v)
        for w in sorted(new, key=new.get):
            self.order[w] = self.rank
            self.rank += 1

    def check_close(self, kind: str, events) -> None:
        """A close's events: each window's value then its metadata, in
        the order the windows opened; equal metadata for one window id,
        each its own object."""
        assert len(events) % 2 == 0
        ranks, metas = [], {}
        for (k_e, (w_e, tag_e, value)), (k_m, (w_m, tag_m, meta)) in zip(events[::2], events[1::2]):
            assert (k_e, w_e, tag_e) == (k_m, w_m, "E") and tag_m == "M"
            ranks.append(self.order.pop((k_e, w_e)))
            vals = self.rows.pop((k_e, w_e))
            want = {
                "count": len(vals),
                "sum": sum(vals),
                "mean": (sum(vals), len(vals)),
                "stats": (min(vals), max(vals), sum(vals), len(vals)),
            }[kind]
            assert value == want, (k_e, w_e)
            opens = ALIGN + timedelta(microseconds=w_m * self.offset_us)
            assert (meta.open_time, meta.close_time) == (opens, opens + timedelta(microseconds=self.length_us))
            assert not meta.merged_ids
            for other in metas.get(w_m, ()):
                assert other == meta and other is not meta
                self.same_wid_pairs += 1
            metas.setdefault(w_m, []).append(meta)
        assert ranks == sorted(ranks)

    def check_table(self) -> None:
        """The live count, the per-key counts, the fold table's slots
        and ``notify_at`` against the oracle's open windows."""
        state = self.state
        assert state._open.n_live == len(self.order) == sum(state._open_n.values())
        assert sorted(state.open_close_us) == sorted((state.key_ids[k], w) for k, w in self.order)
        assert sorted(state.agg.keys()) == sorted(f"{k}\x00{w}" for k, w in self.order)
        ats = []
        for key, wid in self.order:
            kid = state.key_ids[key]
            base = state.base_us[kid]
            if np.isfinite(base):
                ats.append(state.sys_at_base[kid] + (self.close_us(wid) - base))
        want = datetime.fromtimestamp(min(ats) / 1e6, tz=timezone.utc) if ats else None
        assert state.notify_at() == want


def _drive(state, oracle, kind, batch, steps=4):
    """One batch (its phase inline), then ``steps`` half seconds of
    the clock, each with a notification."""
    keys, us, vals, late = batch
    late_events, phase = state.on_batch_columnar(_batch(kind, keys, us, vals))
    assert sum(1 for _k, (_w, tag, _v) in late_events if tag == "L") >= late.sum()
    assert all(tag == "L" for _k, (_w, tag, _v) in late_events)
    oracle.ingest(keys, us, vals, late)
    closes, hint = phase()
    oracle.check_close(kind, closes)
    oracle.check_table()
    assert hint == state.notify_at()
    for _ in range(steps):
        _Clock.t += 0.5
        oracle.check_close(kind, state.on_notify())
        oracle.check_table()


@pytest.mark.parametrize("table", ["single", "sharded"])
@pytest.mark.parametrize("shape", ["sliding", "tumbling"])
@pytest.mark.parametrize("kind", ["count", "sum", "mean", "stats"])
def test_closes_follow_the_opening_order(monkeypatch, kind, shape, table):
    """Every close of a random stream, by ingest, by notifications in
    dribbles and at EOF, against an oracle of the stream."""
    state = _make(kind, shape, table, monkeypatch)
    oracle = _Oracle(state)
    before = _counters()
    for b, batch in enumerate(_state_batches(seed=len(kind) + len(shape) + len(table))):
        _Clock.t = ALIGN.timestamp() + 2 * b
        _drive(state, oracle, kind, batch)
        assert _delta(before, "windows_opened") - _delta(before, "windows_closed") == state._open.n_live
    peak = state._open.n_live
    # The last windows close in dribbles, the rest at EOF.
    while state._open.n_live > peak // 3:
        _Clock.t += 0.25
        oracle.check_close(kind, state.on_notify())
        oracle.check_table()
    assert state._open.n_live
    oracle.check_close(kind, state.on_eof())
    oracle.check_table()
    assert not oracle.order and not state.key_ids and not state._open.n_live
    assert _delta(before, "windows_opened") == _delta(before, "windows_closed")
    assert _delta(before, "window_table_compactions") > 0
    assert 0 < _delta(before, "window_close_scans") < _delta(before, "windows_closed")
    assert oracle.same_wid_pairs > 0


def _normal(events):
    """Close events as comparable tuples, in any order."""
    out = []
    for key, (wid, tag, value) in events:
        if tag == "M":
            value = (value.open_time, value.close_time, sorted(value.merged_ids))
        out.append((key, wid, tag, value))
    return sorted(out)


@pytest.mark.parametrize("table", ["single", "sharded"])
@pytest.mark.parametrize("shape", ["sliding", "tumbling"])
def test_a_resume_and_a_round_trip_mid_stream_change_nothing(monkeypatch, shape, table):
    """Three states take the same batches on the same clock: one
    uninterrupted; one that hands half its keys to ``extract_keys``
    and takes them back by ``inject_keys`` halfway; one resumed
    halfway from the first's snapshots.  Each step's closes, its
    notification and the EOF are the same on all three."""
    kind = "stats"
    whole, moved = (_make(kind, shape, table, monkeypatch) for _ in range(2))
    resumed = None
    batches = _state_batches(seed=7 + len(shape) + len(table))
    rng = np.random.default_rng(3)
    for b, (keys, us, vals, _late) in enumerate(batches):
        _Clock.t = ALIGN.timestamp() + 2 * b
        if b == len(batches) // 2:
            names = sorted(whole.key_ids)
            resumed = _make(kind, shape, table, monkeypatch)
            resumed.load_many(whole.snapshots_for(names))
            taken = sorted(rng.choice(names, len(names) // 2, replace=False).tolist())
            live = moved._open.n_live
            items = moved.extract_keys(taken)
            assert [k for k, _s in items] == taken
            assert moved._open.n_live == live - sum(len(s.windower_state.opened) for _k, s in items)
            assert moved.snapshots_for(taken) == [(k, None) for k in taken]
            moved.inject_keys(items)
            assert moved._open.n_live == live
        states = [s for s in (whole, moved, resumed) if s is not None]
        outs = []
        for state in states:
            late_events, phase = state.on_batch_columnar(_batch(kind, keys, us, vals))
            closes, hint = phase()
            outs.append((_normal(late_events + closes), hint))
        for _ in range(3):
            _Clock.t += 0.5
            for i, state in enumerate(states):
                outs[i] += (_normal(state.on_notify()),)
        assert all(out == outs[0] for out in outs[1:]), b
    ends = [_normal(state.on_eof()) for state in (whole, moved, resumed)]
    assert ends[0] and ends[1] == ends[0] and ends[2] == ends[0]
    assert not any(state._open.n_live or state.key_ids for state in (whole, moved, resumed))


def test_a_late_maximum_leaves_the_watermark_where_it_was():
    """A key's base moves only past its running watermark, as the host
    tier's ``_EventClockLogic.on_item`` moves it: rows whose largest
    timestamp lies between the base and the watermark are late and
    must not restart the system-time term, which would pull the
    watermark back and let the next batch's behind rows in."""
    spec = wa.WindowAccelSpec("count", column_ts, ALIGN, *SHAPES["sliding"], timedelta(0))
    state = spec.make_state()

    def ingest(at, secs):
        _Clock.t = ALIGN.timestamp() + at
        ts = BASE + np.asarray(secs).astype("timedelta64[s]")
        late, phase = state.on_batch_columnar(ArrayBatch({"key": np.array(["a"] * len(secs)), "ts": ts}))
        phase()
        return sorted({v.timestamp() - ALIGN.timestamp() for _k, (_w, _t, v) in late})

    assert ingest(110, [65]) == []
    # The watermark is 65 + 3 s: both rows are late.
    assert ingest(113, [65, 67]) == [65, 67]
    # Still 65 + 6 s (not 67 + 3 s): 70 is late, 72 on time.
    assert ingest(116, [70, 72]) == [70]
