"""Windowed folds through ``run_main`` of the JAX package and of the
torch port, on the same seeded inputs: tumbling, sliding and session
windows, each with ``count_window`` and the marked folds (``SUM``,
``MIN``, ``MAX``, ``mean_window``, ``stats_window``), over columnar
``{key, ts, value}`` batches, dictionary-encoded batches and itemized
rows promoted by the native ``wa_encode`` pass.

Counts, window ids, min, max and late rows must match exactly; float32
sums and means to ``rtol=atol=1e-5``.  Both packages run their device
windower (the JAX package with ``BYTEWAX_TPU_SHARD=0``, so that it
uses the single-device slot table the port has).

Also here: window state carried from the JAX package's
``DeviceWindowAggState`` into the port's, an abort-and-resume of a
windowed flow through the port's ``RecoveryConfig``, and the
residency extract/inject round trip of the port's window state.
"""

import os
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

import bytewax_tpu.operators as ref_op
import bytewax_tpu.operators.windowing as ref_win
import bytewax_tpu_torch.engine.sharded_state as port_sharded_state
import bytewax_tpu_torch.operators as port_op
import bytewax_tpu_torch.operators.windowing as port_win
from bytewax_tpu import xla as ref_xla
from bytewax_tpu.dataflow import Dataflow as RefDataflow
from bytewax_tpu.engine import window_accel as ref_wa
from bytewax_tpu.engine.arrays import ArrayBatch as RefBatch
from bytewax_tpu.models.brc import ArrayBatchSource as RefArraySource
from bytewax_tpu.testing import TestingSink as RefSink
from bytewax_tpu.testing import TestingSource as RefSource
from bytewax_tpu.testing import run_main as ref_run_main
from bytewax_tpu_torch import xla as port_xla
from bytewax_tpu_torch.dataflow import Dataflow as PortDataflow
from bytewax_tpu_torch.engine import window_accel as port_wa
from bytewax_tpu_torch.engine.arrays import ArrayBatch as PortBatch
from bytewax_tpu_torch.models.brc import ArrayBatchSource as PortArraySource
from bytewax_tpu_torch.testing import TestingSink as PortSink
from bytewax_tpu_torch.testing import TestingSource as PortSource
from bytewax_tpu_torch.testing import run_main as port_run_main
from bytewax_tpu_torch.utils import force_platform

ALIGN = datetime(2022, 1, 1, tzinfo=timezone.utc)
WAIT = timedelta(seconds=5)

REF = {
    "op": ref_op,
    "win": ref_win,
    "xla": ref_xla,
    "wa": ref_wa,
    "Dataflow": RefDataflow,
    "Batch": RefBatch,
    "ArraySource": RefArraySource,
    "Source": RefSource,
    "Sink": RefSink,
    "run_main": ref_run_main,
}
PORT = {
    "op": port_op,
    "win": port_win,
    "xla": port_xla,
    "wa": port_wa,
    "Dataflow": PortDataflow,
    "Batch": PortBatch,
    "ArraySource": PortArraySource,
    "Source": PortSource,
    "Sink": PortSink,
    "run_main": port_run_main,
}

WINDOWERS = ("tumbling", "sliding", "session")
KINDS = ("count", "sum", "min", "max", "mean", "stats")


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    saved = os.environ.get("BYTEWAX_TPU_PLATFORM")
    force_platform("cpu")
    yield
    if saved is None:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    else:
        os.environ["BYTEWAX_TPU_PLATFORM"] = saved


@pytest.fixture
def folds(monkeypatch):
    """Device tier on for both packages; counts the rows the port's
    windowers fold through ``DeviceAggState.update_ids`` (the
    segment fold's (slot, value) row source)."""
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "0")
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")
    rows = []
    make = port_sharded_state.make_agg_state

    def recording(kind, driver=None):
        state = make(kind, driver=driver)
        update_ids = state.update_ids

        def counted(slot_ids, values):
            rows.append(len(slot_ids))
            return update_ids(slot_ids, values)

        state.update_ids = counted
        return state

    monkeypatch.setattr(port_sharded_state, "make_agg_state", recording)
    return rows


def _windower(pkg, name):
    win = pkg["win"]
    if name == "tumbling":
        return win.TumblingWindower(length=timedelta(minutes=1), align_to=ALIGN)
    if name == "sliding":
        return win.SlidingWindower(
            length=timedelta(minutes=2),
            offset=timedelta(seconds=40),
            align_to=ALIGN,
        )
    return win.SessionWindower(gap=timedelta(seconds=7))


def _windowed(pkg, s, windower, kind, clock):
    win, xla = pkg["win"], pkg["xla"]
    if kind == "count":
        return win.count_window("w", s, clock, windower, key=lambda x: x)
    if kind == "mean":
        return win.mean_window("w", s, clock, windower)
    if kind == "stats":
        return win.stats_window("w", s, clock, windower)
    return win.reduce_window("w", s, clock, windower, getattr(xla, kind.upper()))


def _flow(pkg, source, windower_name, kind, outs):
    """``outs``: the down, late and meta lists."""
    flow = pkg["Dataflow"]("win")
    s = pkg["op"].input("inp", flow, source)
    clock = pkg["win"].EventClock(
        ts_getter=pkg["xla"].column_ts, wait_for_system_duration=WAIT
    )
    wo = _windowed(pkg, s, _windower(pkg, windower_name), kind, clock)
    for name, stream in zip(("down", "late", "meta"), (wo.down, wo.late, wo.meta)):
        pkg["op"].output(name, stream, pkg["Sink"](outs[name]))
    return flow


def _events(seed: int, n: int = 400, n_keys: int = 4, spread_s: int = 900):
    """Mostly rising event seconds with some rows pushed back past the
    watermark (late), keys, and float32-exact values."""
    rng = np.random.RandomState(seed)
    secs = np.sort(rng.randint(0, spread_s, size=n))
    back = rng.rand(n) < 0.05
    secs[back] -= rng.randint(10, 90, size=int(back.sum()))
    ids = rng.randint(0, n_keys, size=n).astype(np.int32)
    vals = np.round(rng.randn(n) * 20, 2).astype(np.float32).astype(np.float64)
    return secs, ids, vals


def _ts(secs):
    return np.datetime64(ALIGN.replace(tzinfo=None), "us") + secs.astype(
        "timedelta64[s]"
    )


def _columnar(pkg, secs, ids, vals, encoded: bool, size: int = 64):
    vocab = np.array([f"key{k}" for k in range(int(ids.max()) + 1)])
    ts = _ts(secs)
    batches = []
    for i in range(0, len(secs), size):
        cols = {"ts": ts[i : i + size], "value": vals[i : i + size]}
        if encoded:
            cols["key_id"] = ids[i : i + size]
            batches.append(pkg["Batch"](cols, key_vocab=vocab))
        else:
            cols["key"] = vocab[ids[i : i + size]]
            batches.append(pkg["Batch"](cols))
    return pkg["ArraySource"](batches)


def _close(g, w):
    return abs(g - w) <= 1e-5 + 1e-5 * abs(w)


def _same_value(kind, g, w):
    if kind == "stats":
        gmn, gmean, gmx, gn = g
        wmn, wmean, wmx, wn = w
        return (gmn, gmx, gn) == (wmn, wmx, wn) and _close(gmean, wmean)
    if kind in ("sum", "mean"):
        return _close(g, w)
    return g == w and type(g) is type(w)


def _late_key(item):
    key, (wid, v) = item
    if isinstance(v, datetime):
        return (key, wid, v, None)
    return (key, wid, float(v), getattr(v, "ts", None))


def _meta_key(item):
    key, (wid, meta) = item
    return (key, wid, meta.open_time, meta.close_time, sorted(meta.merged_ids))


def assert_windows_match(kind, got, want):
    down_g, down_w = sorted(got["down"], key=repr), sorted(want["down"], key=repr)
    assert [(k, wid) for k, (wid, _v) in down_g] == [
        (k, wid) for k, (wid, _v) in down_w
    ]
    for (k, (wid, g)), (_k, (_wid, w)) in zip(down_g, down_w):
        assert _same_value(kind, g, w), (k, wid, g, w)
    assert sorted(map(_late_key, got["late"])) == sorted(
        map(_late_key, want["late"])
    )
    assert sorted(map(_meta_key, got["meta"])) == sorted(
        map(_meta_key, want["meta"])
    )


def _run_both(build):
    outs = []
    for pkg in (REF, PORT):
        out = {"down": [], "late": [], "meta": []}
        pkg["run_main"](build(pkg, out))
        outs.append(out)
    return outs


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("windower", WINDOWERS)
def test_columnar_windows_match_reference(folds, windower, kind):
    secs, ids, vals = _events(seed=WINDOWERS.index(windower) * 10 + KINDS.index(kind))

    def build(pkg, out):
        source = _columnar(pkg, secs, ids, vals, encoded=False)
        return _flow(pkg, source, windower, kind, out)

    want, got = _run_both(build)
    assert got["down"] and got["late"] and got["meta"]
    assert_windows_match(kind, got, want)
    # Every on-time row folded through the port's device windower.
    on_time_rows = sum(folds)
    assert on_time_rows >= len(secs) - len(got["late"])


@pytest.mark.parametrize("windower", WINDOWERS)
def test_dictionary_encoded_windows_match_reference(folds, windower):
    secs, ids, vals = _events(seed=40, n=500, n_keys=7)

    def build(pkg, out):
        source = _columnar(pkg, secs, ids, vals, encoded=True, size=100)
        return _flow(pkg, source, windower, "stats", out)

    want, got = _run_both(build)
    assert_windows_match("stats", got, want)
    assert folds


def _key_of_time(t: datetime) -> str:
    return f"key{int(t.timestamp()) % 3}"


@pytest.mark.parametrize("kind", ["count", "sum"])
@pytest.mark.parametrize("windower", WINDOWERS)
def test_itemized_promotion_matches_reference(folds, monkeypatch, windower, kind):
    """``(key, datetime)`` rows (counts) and ``(key, TsValue)`` rows
    (sums) promote through ``wa_encode`` onto the device windower."""
    from bytewax_tpu_torch.native import is_available

    if not is_available():
        pytest.skip("the native host library does not build here")
    calls = []
    promote = port_wa.DeviceWindowAggState.on_batch_items

    def spy(self, items):
        res = promote(self, items)
        calls.append(res is not None)
        return res

    monkeypatch.setattr(port_wa.DeviceWindowAggState, "on_batch_items", spy)
    secs, ids, vals = _events(seed=50 + WINDOWERS.index(windower), n=300)
    times = [ALIGN + timedelta(seconds=int(s)) for s in secs]

    def build(pkg, out):
        flow = pkg["Dataflow"]("win")
        clock = pkg["win"].EventClock(
            ts_getter=pkg["xla"].column_ts, wait_for_system_duration=WAIT
        )
        wdr = _windower(pkg, windower)
        if kind == "count":
            # count_window keys each timestamp: (key, datetime) rows.
            s = pkg["op"].input("inp", flow, pkg["Source"](times, batch_size=50))
            wo = pkg["win"].count_window("w", s, clock, wdr, key=_key_of_time)
        else:
            items = [
                (f"key{k}", pkg["xla"].TsValue(v, t))
                for k, v, t in zip(ids.tolist(), vals.tolist(), times)
            ]
            s = pkg["op"].input("inp", flow, pkg["Source"](items, batch_size=50))
            wo = pkg["win"].reduce_window("w", s, clock, wdr, pkg["xla"].SUM)
        for name, stream in zip(("down", "late", "meta"), (wo.down, wo.late, wo.meta)):
            pkg["op"].output(name, stream, pkg["Sink"](out[name]))
        return flow

    want, got = _run_both(build)
    assert_windows_match(kind, got, want)
    assert calls and all(calls)
    assert folds


@pytest.mark.parametrize(
    "offsets_s, late_expected",
    [
        ([120, 100], [100]),
        ([100, 120], []),
        ([120, 110], []),
        ([120, 109], [109]),
    ],
)
def test_lateness_boundary_matches_reference(folds, offsets_s, late_expected):
    """The pin of ``tests/test_window_accel.py::
    test_window_accel_lateness_boundary``: each row is judged
    post-item against its key's running watermark, strict ``<``."""

    def build(pkg, out):
        clock = pkg["win"].EventClock(
            ts_getter=lambda item: item[0],
            wait_for_system_duration=timedelta(seconds=10),
        )
        windower = pkg["win"].TumblingWindower(
            length=timedelta(minutes=1), align_to=ALIGN
        )
        inp = [(ALIGN + timedelta(seconds=s), "a") for s in offsets_s]
        flow = pkg["Dataflow"]("test_df")
        s = pkg["op"].input("inp", flow, pkg["Source"](inp, batch_size=len(inp)))
        wo = pkg["win"].count_window(
            "count", s, clock, windower, key=lambda item: item[1]
        )
        pkg["op"].output("down", wo.down, pkg["Sink"](out["down"]))
        pkg["op"].output("late", wo.late, pkg["Sink"](out["late"]))
        return flow

    want, got = _run_both(build)
    for out in (want, got):
        late_secs = sorted(
            int((v[0] - ALIGN).total_seconds()) for _k, (_wid, v) in out["late"]
        )
        assert late_secs == late_expected
        assert sum(c for _k, (_wid, c) in out["down"]) == len(offsets_s) - len(
            late_expected
        )
    assert sorted(got["down"]) == sorted(want["down"])
    assert folds


@pytest.mark.parametrize("batch_size", [1, 6])
def test_session_merge_matches_reference(folds, batch_size):
    """Two sessions of one key bridged by later on-time values merge
    into the earlier one, which records the absorbed id (the rows of
    ``tests/test_session_accel.py::test_session_merge_metadata``)."""
    secs = [0, 2, 30, 12, 21, 500]

    def build(pkg, out):
        clock = pkg["win"].EventClock(
            ts_getter=lambda item: item[0],
            wait_for_system_duration=timedelta(seconds=60),
        )
        windower = pkg["win"].SessionWindower(gap=timedelta(seconds=10))
        inp = [(ALIGN + timedelta(seconds=s), "a") for s in secs]
        flow = pkg["Dataflow"]("merge")
        s = pkg["op"].input("inp", flow, pkg["Source"](inp, batch_size=batch_size))
        wo = pkg["win"].count_window("count", s, clock, windower, key=lambda item: item[1])
        for name, stream in zip(("down", "late", "meta"), (wo.down, wo.late, wo.meta)):
            pkg["op"].output(name, stream, pkg["Sink"](out[name]))
        return flow

    want, got = _run_both(build)
    assert_windows_match("count", got, want)
    merged = [m for _k, (_wid, m) in got["meta"] if m.merged_ids]
    if batch_size == 1:
        # One row per delivery: the device sees the arrival order.
        assert merged and merged[0].close_time == ALIGN + timedelta(seconds=30)
    else:
        # One delivery: its rows are placed in timestamp order, so
        # they form one session with nothing to merge.
        assert not merged and len(got["down"]) == 2
    assert sum(c for _k, (_wid, c) in got["down"]) == len(secs)
    assert folds


# -- window state carried across ----------------------------------------------


def _spec(pkg, windower, kind):
    wa = pkg["wa"]
    if windower == "session":
        return wa.SessionAccelSpec(kind, lambda x: x, timedelta(seconds=7), WAIT)
    length, offset = (
        (timedelta(minutes=1), timedelta(minutes=1))
        if windower == "tumbling"
        else (timedelta(minutes=2), timedelta(seconds=40))
    )
    return wa.WindowAccelSpec(kind, lambda x: x, ALIGN, length, offset, WAIT)


def _ingest(state, pkg, secs, ids, vals):
    vocab = np.array([f"key{k}" for k in range(8)])
    batch = pkg["Batch"]({"key": vocab[ids], "ts": _ts(secs), "value": vals})
    late, phase = state.on_batch_columnar(batch)
    closes, _hint = phase()
    return late + closes


def _events_key(kind, events):
    out = []
    for key, (wid, tag, v) in events:
        if tag == "M":
            v = (v.open_time, v.close_time, sorted(v.merged_ids))
        elif tag == "L" and not isinstance(v, datetime):
            v = float(v)
        out.append((key, wid, tag, v))
    return sorted(out, key=repr)


def _assert_events_match(kind, got, want):
    assert len(got) == len(want)
    for g, w in zip(_events_key(kind, got), _events_key(kind, want)):
        assert g[:3] == w[:3]
        if g[2] != "E" or kind not in ("sum", "mean", "stats"):
            assert g[3] == w[3], (g, w)
        elif kind == "sum":
            assert _close(g[3], w[3]), (g, w)
        elif kind == "mean":
            assert g[3][1] == w[3][1] and _close(g[3][0], w[3][0]), (g, w)
        else:  # the raw (min, max, sum, count) accumulator
            assert (g[3][0], g[3][1], g[3][3]) == (w[3][0], w[3][1], w[3][3])
            assert _close(g[3][2], w[3][2]), (g, w)


@pytest.mark.parametrize("kind", ["count", "sum", "stats"])
@pytest.mark.parametrize("windower", WINDOWERS)
def test_reference_window_state_carries_into_the_port(monkeypatch, windower, kind):
    """Snapshots of a JAX ``DeviceWindowAggState`` load into the
    port's state; both then take the same rows and close the same
    windows with the same values."""
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "0")
    secs, ids, vals = _events(seed=60, n=600, n_keys=5, spread_s=1200)
    half = len(secs) // 2
    ref_state = _spec(REF, windower, kind).make_state()
    _ingest(ref_state, REF, secs[:half], ids[:half], vals[:half])
    keys = sorted(ref_state.key_ids)
    snaps = ref_state.snapshots_for(keys)
    assert any(s is not None for _k, s in snaps)

    # The port's own snapshots of the same rows are the reference's.
    direct = _spec(PORT, windower, kind).make_state()
    _ingest(direct, PORT, secs[:half], ids[:half], vals[:half])
    _assert_snaps_match(kind, direct.snapshots_for(keys), snaps)

    port_state = _spec(PORT, windower, kind).make_state()
    for key, snap in snaps:
        if snap is not None:
            port_state.load(key, _to_port_snapshot(snap))
    assert port_state.agg.device.type == "cpu"
    rest = (secs[half:], ids[half:], vals[half:])
    got = _ingest(port_state, PORT, *rest) + port_state.on_eof()
    want = _ingest(ref_state, REF, *rest) + ref_state.on_eof()
    assert any(tag == "E" for _k, (_w, tag, _v) in want)
    _assert_events_match(kind, got, want)


def _acc_close(kind, g, w):
    """Window accumulators: counts, min and max exactly, sums to the
    float32 tolerance."""
    if kind == "count" or kind in ("min", "max"):
        return g == w
    if kind == "sum":
        return _close(g, w)
    mn, mx, total, n = g  # stats: (min, max, sum, count)
    return (mn, mx, n) == (w[0], w[1], w[3]) and _close(total, w[2])


def _assert_snaps_match(kind, got, want):
    assert [k for k, _s in got] == [k for k, _s in want]
    for (key, g), (_key, w) in zip(got, want):
        if w is None:
            assert g is None, key
            continue
        # (system_time_of_max_event is each run's own wall clock)
        assert g.clock_state.watermark_base == w.clock_state.watermark_base, key
        gws, wws = g.windower_state, w.windower_state
        if hasattr(wws, "opened"):
            assert {i: (m.open_time, m.close_time) for i, m in gws.opened.items()} == {
                i: (m.open_time, m.close_time) for i, m in wws.opened.items()
            }, key
        else:
            assert gws.next_id == wws.next_id, key
            assert {
                i: (m.open_time, m.close_time, m.merged_ids) for i, m in gws.sessions.items()
            } == {i: (m.open_time, m.close_time, m.merged_ids) for i, m in wws.sessions.items()}
        assert g.logic_states.keys() == w.logic_states.keys(), key
        for wid, acc in w.logic_states.items():
            assert _acc_close(kind, g.logic_states[wid], acc), (key, wid)


def _to_port_snapshot(snap):
    """The JAX package's ``_WindowSnapshot`` rebuilt from the port's
    classes (same fields; a recovery store carries them as pickles of
    whichever package wrote them)."""
    w = port_win
    ws = snap.windower_state
    if hasattr(ws, "opened"):
        windower_state = w._SlidingWindowerState(
            opened={
                wid: w.WindowMetadata(m.open_time, m.close_time, set(m.merged_ids))
                for wid, m in ws.opened.items()
            }
        )
    else:
        windower_state = w._SessionWindowerState(
            next_id=ws.next_id,
            sessions={
                wid: w.WindowMetadata(m.open_time, m.close_time, set(m.merged_ids))
                for wid, m in ws.sessions.items()
            },
            merge_queue=list(ws.merge_queue),
        )
    cs = snap.clock_state
    return w._WindowSnapshot(
        w._EventClockState(
            system_time_of_max_event=cs.system_time_of_max_event,
            watermark_base=cs.watermark_base,
        ),
        windower_state,
        dict(snap.logic_states),
        list(snap.queue),
    )


@pytest.mark.parametrize("windower", WINDOWERS)
def test_extract_inject_round_trip(monkeypatch, windower):
    """The residency surface of the port's window state: extracted
    keys release their slots, and injecting them back gives the same
    closes as a state that never let them go."""
    secs, ids, vals = _events(seed=70, n=400, n_keys=4, spread_s=900)
    half = len(secs) // 2
    kept = _spec(PORT, windower, "sum").make_state()
    moved = _spec(PORT, windower, "sum").make_state()
    for state in (kept, moved):
        _ingest(state, PORT, secs[:half], ids[:half], vals[:half])
    keys = ["key0", "key2"]
    live = len(moved.agg.keys())
    extracted = moved.extract_keys(keys)
    assert [k for k, _s in extracted] == keys
    assert len(moved.agg.keys()) < live
    moved.inject_keys(extracted)
    rest = (secs[half:], ids[half:], vals[half:])
    got = _ingest(moved, PORT, *rest) + moved.on_eof()
    want = _ingest(kept, PORT, *rest) + kept.on_eof()
    _assert_events_match("sum", got, want)


def test_windowed_flow_resumes_after_abort(folds, tmp_path):
    """Abort mid-input and resume in one process through the port's
    ``RecoveryConfig``: the windows close with every on-time row
    counted once, as in an uninterrupted run."""
    from bytewax_tpu_torch.recovery import RecoveryConfig, init_db_dir

    secs, ids, _vals = _events(seed=80, n=300, n_keys=3, spread_s=600)
    secs = np.sort(secs)
    items = [
        (f"key{k}", ALIGN + timedelta(seconds=int(s)))
        for k, s in zip(ids.tolist(), secs.tolist())
    ]

    def flow(inp, out):
        clock = port_win.EventClock(
            ts_getter=lambda x: x[1], wait_for_system_duration=WAIT
        )
        windower = port_win.TumblingWindower(
            length=timedelta(minutes=1), align_to=ALIGN
        )
        f = PortDataflow("resume")
        s = port_op.input("inp", f, PortSource(inp, batch_size=25))
        wo = port_win.count_window("count", s, clock, windower, key=lambda x: x[0])
        port_op.output("out", wo.down, PortSink(out))
        return f

    whole = []
    port_run_main(flow(items, whole))

    init_db_dir(tmp_path, 1)
    rc = RecoveryConfig(str(tmp_path))
    out = []
    inp = items[:150] + [PortSource.ABORT()] + items[150:]
    f = flow(inp, out)
    port_run_main(f, epoch_interval=timedelta(0), recovery_config=rc)
    first = list(out)
    assert len(first) < len(whole)
    port_run_main(f, epoch_interval=timedelta(0), recovery_config=rc)
    assert sorted(out) == sorted(whole)
    assert folds
