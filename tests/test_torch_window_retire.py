"""Key state of the port's device window tier is bounded as the host
tier bounds it: a key that holds no open window loses its clock, its
id and its encoder entries (the host tier discards an empty
``_WindowLogic``), a key that comes back starts a fresh clock, and the
ids are reused.

Rising keys over many batches give the output of the JAX package's
host tier (and of the port's own) at pipeline depths 1 and 2, with
string and dictionary-encoded keys; the live key count stays at the
keys with an open window; a key that an ingest touched after the phase
that emptied it is kept.
"""

import os
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

import bytewax_tpu.dataflow as ref_dataflow
import bytewax_tpu.engine.arrays as ref_arrays
import bytewax_tpu.inputs as ref_inputs
import bytewax_tpu.operators as ref_op
import bytewax_tpu.operators.windowing as ref_win
import bytewax_tpu.testing as ref_testing
import bytewax_tpu_torch.dataflow as port_dataflow
import bytewax_tpu_torch.engine.arrays as port_arrays
import bytewax_tpu_torch.inputs as port_inputs
import bytewax_tpu_torch.operators as op
import bytewax_tpu_torch.operators.windowing as win
import bytewax_tpu_torch.testing as port_testing
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.engine import flight
from bytewax_tpu_torch.engine import window_accel as wa
from bytewax_tpu_torch.engine.arrays import ArrayBatch, column_ts
from bytewax_tpu_torch.testing import TestingSink, run_main
from bytewax_tpu_torch.utils import force_platform

ALIGN = datetime(2022, 1, 1, tzinfo=timezone.utc)
BASE = np.datetime64(ALIGN.replace(tzinfo=None), "us")
LENGTH, OFFSET = timedelta(seconds=10), timedelta(seconds=2)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    saved = os.environ.get("BYTEWAX_TPU_PLATFORM")
    force_platform("cpu")
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "0")
    yield
    if saved is None:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    else:
        os.environ["BYTEWAX_TPU_PLATFORM"] = saved


class _Clock(datetime):
    """The system clock of both tiers, moved by hand."""

    t = ALIGN.timestamp()

    @classmethod
    def now(cls, tz=None):
        return datetime.fromtimestamp(cls.t, tz)


def _fake_now():
    return _Clock.now(timezone.utc)


class _Pkg:
    """One package's modules: the JAX package (the reference) or the
    port."""

    def __init__(self, dataflow, arrays, inputs, ops, windowing, testing):
        self.Dataflow = dataflow.Dataflow
        self.ArrayBatch = arrays.ArrayBatch
        self.column_ts = arrays.column_ts
        self.inputs, self.op, self.win, self.testing = inputs, ops, windowing, testing


REF = _Pkg(ref_dataflow, ref_arrays, ref_inputs, ref_op, ref_win, ref_testing)
PORT = _Pkg(port_dataflow, port_arrays, port_inputs, op, win, port_testing)


def _timed_source(batches, encoding, pkg):
    """A source of ``pkg`` that hands over ``(keys, seconds, at)``
    batches; each poll first sets the clock to ``at`` seconds, as if
    the batch arrived then."""

    class _Part(pkg.inputs.StatelessSourcePartition):
        def __init__(self, todo):
            self._todo = todo

        def next_batch(self):
            if not self._todo:
                raise StopIteration()
            keys, secs, at = self._todo.pop(0)
            _Clock.t = ALIGN.timestamp() + at
            ts = BASE + secs.astype("timedelta64[s]")
            if encoding == "key":
                return pkg.ArrayBatch({"key": np.char.add("k", keys.astype(str)), "ts": ts})
            vocab = np.char.add("k", np.arange(10_100).astype(str))
            return pkg.ArrayBatch({"key_id": keys.astype(np.int32), "ts": ts}, key_vocab=vocab)

    class _Source(pkg.inputs.DynamicSource):
        def build(self, step_id, worker_index, worker_count):
            return _Part(list(batches) if worker_index == 0 else [])

    return _Source()


def _returning_batches(n_rounds=8, per=8):
    """``(keys, seconds, at)`` batches 30 s apart: ``per`` new keys and
    a second row of the first (late behind the first's rows of the same
    batch on both tiers, with a wait of 0); then a batch of another key
    while the quiet keys' windows close by the clock; then the first
    keys again, with event times 20 s behind the clock (on time for a
    fresh clock, late for the kept one)."""
    out, t = [], 0
    for r in range(n_rounds):
        new = np.array([r * per + j for j in range(per)])
        first = t + np.arange(per + 1, dtype=np.int64)
        first[-1] = t - 1
        out.append((np.append(new, new[0]), first, t))
        out.append((np.array([10_000 + r]), np.array([t + 30]), t + 30))
        out.append((new, t + 40 + np.arange(per, dtype=np.int64), t + 60))
        t += 90
    return out


def _count_flow(batches, encoding, pkg=PORT):
    flow = pkg.Dataflow("retire")
    s = pkg.op.input("inp", flow, _timed_source(batches, encoding, pkg))
    clock = pkg.win.EventClock(ts_getter=pkg.column_ts, wait_for_system_duration=timedelta(0),
                               now_getter=_fake_now)
    windower = pkg.win.SlidingWindower(length=LENGTH, offset=OFFSET, align_to=ALIGN)
    wo = pkg.win.count_window("count", s, clock, windower, key=lambda x: x)
    down, late = [], []
    pkg.op.output("down", wo.down, pkg.testing.TestingSink(down))
    pkg.op.output("late", wo.late, pkg.testing.TestingSink(late))
    return flow, down, late


def _late_key(x):
    return repr(x)


@pytest.mark.parametrize("encoding", ["key", "key_id"])
@pytest.mark.parametrize("depth", ["1", "2"])
def test_returning_keys_match_the_host_tier(monkeypatch, depth, encoding):
    """Keys go quiet, their windows close as the clock runs on, and
    they come back: the host tier has discarded them and starts fresh
    clocks, and so must the device tier (with the stale clock of a
    key that is kept, every returning row would be late).  The port's
    device tier must give the JAX package's host tier output, and its
    own host tier's.  At depths 1 and 2 every phase has run before the
    next ingest; deeper, a close may still be queued when the key
    returns (the last test)."""
    monkeypatch.setenv("BYTEWAX_TPU_PIPELINE_DEPTH", depth)
    # One delivery a batch: the coalescer would merge them.
    monkeypatch.setenv("BYTEWAX_TPU_INGEST_TARGET_ROWS", "0")
    monkeypatch.setattr(wa, "datetime", _Clock)
    # The system clock the lowering accepts is this test's clock.
    monkeypatch.setattr(op, "_get_system_utc", _fake_now)
    batches = _returning_batches()

    # The reference: the JAX package's host tier.
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "0")
    flow, down, late = _count_flow(batches, encoding, REF)
    ref_testing.run_main(flow)
    ref = (sorted(down), sorted(late, key=_late_key))
    assert ref[0]

    runs = {}
    for accel in ("0", "1"):
        monkeypatch.setenv("BYTEWAX_TPU_ACCEL", accel)
        counters0 = dict(flight.RECORDER.counters)
        flow, down, late = _count_flow(batches, encoding)
        run_main(flow)
        runs[accel] = (sorted(down), sorted(late, key=_late_key))
        rows = flight.RECORDER.counters.get("window_rows_ingested", 0)
        assert (rows > counters0.get("window_rows_ingested", 0)) == (accel == "1")
    host, device = runs["0"], runs["1"]
    assert device == ref
    assert host == ref
    retired = flight.RECORDER.counters["window_keys_retired"] - counters0.get("window_keys_retired", 0)
    down, late = device
    # Only each round's second row of its first key is late, in the
    # five windows that hold it; the returning keys are on time.
    n_rows = sum(len(k) for k, _s, _at in batches)
    assert len(late) == 8 * 5
    assert sum(c for _k, (_w, c) in down) == (n_rows - 8) * 5
    # Each round's new keys and its filler key, and the new keys again.
    assert retired == 8 * (8 + 1 + 8)


def _live(state) -> int:
    return len({kid for kid, _w in state.open_close_us})


def test_live_keys_stay_at_the_keys_with_an_open_window(monkeypatch):
    """Rising keys, each seen over two one-second batches, one batch a
    second of system time: a quiet key's windows close 14 s after its
    last event, and its state goes with them.  The ids in use, the
    clock and the encoder stay at the keys with an open window, and
    the counts are exact."""
    monkeypatch.setattr(wa, "datetime", _Clock)
    _Clock.t = ALIGN.timestamp()
    spec = wa.WindowAccelSpec("count", column_ts, ALIGN, LENGTH, OFFSET, timedelta(seconds=4))
    state = spec.make_state()
    counters0 = dict(flight.RECORDER.counters)
    events, rows = [], []
    n_batches, per = 120, 64
    for b in range(n_batches):
        i = np.arange(per)
        keys = 4 * b + i % 8
        us = b * 1_000_000 + i * (1_000_000 // per)
        rows.append((keys, us))
        batch = ArrayBatch({"key": np.char.add("k", keys.astype(str)), "ts": BASE + us.astype("timedelta64[us]")})
        _Clock.t = ALIGN.timestamp() + b + 1
        late, phase = state.on_batch_columnar(batch)
        closes, _hint = phase()
        events += late + closes + state.on_notify()
        assert len(state.key_ids) == _live(state)
        assert len(state._enc._ids) == len(state.key_ids)
    assert 0 < len(state.key_ids) <= 70
    assert len(state.keys) <= 80 and len(state.base_us) <= 256
    events += state.on_eof()
    assert not state.key_ids and not state.open_close_us and not state._open_n

    assert not [e for e in events if e[1][1] == "L"]
    got = {(k, w): v for k, (w, tag, v) in events if tag == "E"}
    keys = np.concatenate([k for k, _u in rows])
    us = np.concatenate([u for _k, u in rows])
    want = {}
    for k, u in zip(keys.tolist(), us.tolist()):
        for w in range(u // 2_000_000 - 4, u // 2_000_000 + 1):
            want[(f"k{k}", w)] = want.get((f"k{k}", w), 0) + 1
    assert got == want
    delta = {k: v - counters0.get(k, 0) for k, v in flight.RECORDER.counters.items()}
    assert delta["windows_opened"] == delta["windows_closed"] == len(want)
    assert delta["window_keys_retired"] == len(set(keys.tolist()))


def test_a_key_touched_after_its_emptying_phase_stays():
    """At pipeline depth 3 a key can be ingested again while the phase
    that closed its last window is still queued: the retirement of
    that phase must leave it alone."""
    spec = wa.WindowAccelSpec("count", column_ts, ALIGN, LENGTH, OFFSET, timedelta(days=-1))
    state = spec.make_state()

    def batch(sec):
        return ArrayBatch({"key": np.array(["a"]), "ts": np.array([BASE + np.timedelta64(sec, "s")])})

    _late1, phase1 = state.on_batch_columnar(batch(0))
    _late2, phase2 = state.on_batch_columnar(batch(100_000))
    phase1()
    state._drain_retired()
    assert "a" in state.key_ids
    phase2()
    state._drain_retired()
    assert "a" not in state.key_ids
    assert state.snapshots_for(["a"]) == [("a", None)]


def test_a_storeless_epoch_close_builds_no_window_snapshot(monkeypatch):
    """With no recovery store an epoch close only forgets which keys
    changed: building every touched key's snapshot would hold the
    stream while the watermarks run on with the host's clock."""
    from bytewax_tpu_torch.testing import TestingSource

    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")
    built = []
    orig = wa.DeviceWindowAggState.snapshots_for

    def snapshots_for(self, keys):
        built.append(len(keys))
        return orig(self, keys)

    monkeypatch.setattr(wa.DeviceWindowAggState, "snapshots_for", snapshots_for)
    rows = [ALIGN + timedelta(seconds=i) for i in range(200)]
    flow = Dataflow("storeless")
    s = op.input("inp", flow, TestingSource(rows, batch_size=20))
    clock = win.EventClock(ts_getter=lambda x: x, wait_for_system_duration=timedelta(seconds=5))
    windower = win.SlidingWindower(length=LENGTH, offset=OFFSET, align_to=ALIGN)
    wo = win.count_window("count", s, clock, windower, key=lambda dt: f"k{dt.second % 7}")
    down = []
    op.output("down", wo.down, TestingSink(down))
    run_main(flow, epoch_interval=timedelta(0))
    assert sum(c for _k, (_w, c) in down) == 200 * 5
    assert built == []
