"""The torch port's window operators and windowers
(``bytewax_tpu_torch/operators/windowing.py``) held against the JAX
package: the cases of ``tests/operators/test_windower_logic.py`` (the
windowers' and clocks' own logic, driven directly) and of
``tests/operators/test_windowing.py`` (``fold_window``,
``reduce_window``, ``max_window``/``min_window``, ``collect_window``,
``count_window`` and ``join_window`` with their ``down``, ``late`` and
``meta`` streams, and a window resumed from a store of each package's
own).  A case the reference runs under its ``entry_point`` fixture runs
here under each package's own ``run_main``, ``cluster_main`` with one
lane and ``cluster_main`` with two.  The outputs must be equal, in the
order the reference asserts.
"""

from datetime import datetime, timedelta, timezone

import pytest

from tests.torch_entry_points import (  # noqa: F401
    ENTRY_POINTS,
    PKGS,
    assert_same_error,
    port_on_cpu,
    raised,
    recovery_config,
    run_both,
    unsharded,
)

ALIGN = datetime(2022, 1, 1, tzinfo=timezone.utc)
ZERO_TD = timedelta(seconds=0)


def _t(seconds):
    return ALIGN + timedelta(seconds=seconds)


def _same(results):
    """Each package's result; they must be equal."""
    want, got = results
    assert got == want
    return got


def _meta(m):
    """A ``WindowMetadata`` as plain values (each package has its own
    class)."""
    return (m.open_time, m.close_time, set(m.merged_ids))


# -- the windowers' and clocks' own logic -------------------------------------


def test_sliding_intersecting_boundaries():
    def run(pkg):
        logic = pkg["win"].SlidingWindower(
            length=timedelta(seconds=10), offset=timedelta(seconds=5), align_to=ALIGN
        ).build(None)
        return [logic.intersecting_ids(_t(s)) for s in (10, 7, -3)]

    # At a window's open: it and the one before (the close is
    # exclusive); mid-window; before align_to: negative ids.
    assert _same([run(pkg) for pkg in PKGS]) == [[1, 2], [0, 1], [-2, -1]]


def test_tumbling_open_close_metadata():
    def run(pkg):
        logic = pkg["win"].TumblingWindower(
            length=timedelta(minutes=1), align_to=ALIGN
        ).build(None)
        opened = list(logic.open_for(_t(30)))
        before = logic.close_for(_t(59))  # the close time is exclusive
        closed = [(w, _meta(m)) for w, m in logic.close_for(_t(60))]
        return opened, before, closed, logic.is_empty()

    got = _same([run(pkg) for pkg in PKGS])
    assert got == ([0], [], [(0, (ALIGN, _t(60), set()))], True)


def test_session_grows_and_merges():
    def run(pkg):
        logic = pkg["win"].SessionWindower(gap=timedelta(seconds=5)).build(None)
        steps = [list(logic.open_for(_t(s))) for s in (0, 20, 4)]
        steps.append(list(logic.merged()))
        # Pull b's open down to 16, then extend a's close 4 -> 9 -> 13:
        # b's open now lies within the 5 s gap, and they merge.
        steps += [list(logic.open_for(_t(s))) for s in (16, 9, 13)]
        steps.append(list(logic.merged()))
        steps.append([(w, _meta(m)) for w, m in logic.close_for(_t(100))])
        return steps

    got = _same([run(pkg) for pkg in PKGS])
    (a,), (b,) = got[0], got[1]
    assert a != b and got[2] == [a] and got[3] == []
    assert got[4:7] == [[b], [a], [a]]
    assert got[7] == [(b, a)]  # the later session merged into the earlier
    assert got[8] == [(a, (_t(0), _t(20), {b}))]


def test_session_never_reuses_ids():
    def run(pkg):
        logic = pkg["win"].SessionWindower(gap=timedelta(seconds=1)).build(None)
        (a,) = logic.open_for(_t(0))
        logic.close_for(_t(100))
        (b,) = logic.open_for(_t(200))
        return a, b, logic.is_empty()

    a, b, empty = _same([run(pkg) for pkg in PKGS])
    assert b != a and not empty  # sessions never report empty


def test_session_late_sentinel():
    def run(pkg):
        logic = pkg["win"].SessionWindower(gap=timedelta(seconds=1)).build(None)
        return list(logic.late_for(_t(0))), pkg["win"].LATE_SESSION_ID

    late, sentinel = _same([run(pkg) for pkg in PKGS])
    assert late == [sentinel]


def test_sliding_snapshot_roundtrip():
    def run(pkg):
        windower = pkg["win"].SlidingWindower(
            length=timedelta(seconds=10), offset=timedelta(seconds=5), align_to=ALIGN
        )
        logic = windower.build(None)
        logic.open_for(_t(7))
        resumed = windower.build(logic.snapshot())
        same_notify = resumed.notify_at() == logic.notify_at()
        return same_notify, sorted(w for w, _m in resumed.close_for(_t(100)))

    assert _same([run(pkg) for pkg in PKGS]) == (True, [0, 1])


def test_event_clock_watermark_advances_with_system_time():
    def run(pkg):
        getter = pkg["TimeTestingGetter"](ALIGN)
        logic = pkg["win"].EventClock(
            ts_getter=lambda item: item[0],
            wait_for_system_duration=timedelta(seconds=10),
            now_getter=getter.get,
        ).build(None)
        logic.before_batch()
        first = logic.on_item((ALIGN, "x"))
        # The watermark advances as system time passes with no items.
        getter.advance(timedelta(seconds=7))
        return first, logic.on_notify()

    got = _same([run(pkg) for pkg in PKGS])
    assert got == ((ALIGN, _t(-10)), _t(-3))


def test_event_clock_watermark_never_regresses():
    def run(pkg):
        getter = pkg["TimeTestingGetter"](ALIGN)
        logic = pkg["win"].EventClock(
            ts_getter=lambda item: item[0],
            wait_for_system_duration=ZERO_TD,
            now_getter=getter.get,
        ).build(None)
        logic.before_batch()
        _, wm1 = logic.on_item((_t(60), "x"))
        # An out-of-order item must not pull the watermark back.
        _, wm2 = logic.on_item((_t(1), "y"))
        return wm1, wm2

    wm1, wm2 = _same([run(pkg) for pkg in PKGS])
    assert wm2 == wm1


def test_sliding_offset_longer_than_length_raises():
    want, got = (
        raised(
            lambda pkg=pkg: pkg["win"].SlidingWindower(
                length=timedelta(seconds=1), offset=timedelta(seconds=10), align_to=ALIGN
            )
        )
        for pkg in PKGS
    )
    assert_same_error(want, got)
    assert isinstance(got, ValueError) and "offset" in str(got)


# -- the window operators -----------------------------------------------------


def _ts_clock(pkg, wait_s=10):
    # wait=10 s gives load tolerance: EventClock watermarks advance
    # with wall-clock time; the deliberate lateness cases use event
    # gaps of 29-59 s, far above the wait.
    return pkg["win"].EventClock(
        ts_getter=lambda item: item[0], wait_for_system_duration=timedelta(seconds=wait_s)
    )


def _tumbling(pkg):
    return pkg["win"].TumblingWindower(length=timedelta(minutes=1), align_to=ALIGN)


def _window_flow(inp, window, streams=("down",), key=True, batch_size=None):
    """``input -> key_on("ALL") -> window(pkg, stream)`` with an output
    for each of ``streams``; ``out`` maps each stream to its rows."""

    def build(pkg):
        flow = pkg["Dataflow"]("test_df")
        kwargs = {} if batch_size is None else {"batch_size": batch_size}
        s = pkg["op"].input("inp", flow, pkg["Source"](inp, **kwargs))
        if key:
            s = pkg["op"].key_on("key", s, lambda _x: "ALL")
        wo = window(pkg, s)
        out = {name: [] for name in streams}
        for name in streams:
            pkg["op"].output(name, getattr(wo, name), pkg["Sink"](out[name]))
        return flow, out

    return build


def _sum_fold(pkg, s, clock, windower):
    return pkg["win"].fold_window(
        "sum",
        s,
        clock,
        windower,
        builder=lambda: 0,
        folder=lambda acc, item: acc + item[1],
        merger=lambda a, b: a + b,
    )


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_tumbling_fold_window(entry_point):
    inp = [(_t(s), v) for s, v in [(1, 1), (5, 2), (61, 10), (62, 20)]]
    build = _window_flow(inp, lambda pkg, s: _sum_fold(pkg, s, _ts_clock(pkg), _tumbling(pkg)))
    want, got = run_both(build, entry_point)
    assert sorted(got["down"]) == sorted(want["down"]) == [("ALL", (0, 3)), ("ALL", (1, 30))]


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_tumbling_window_metadata(entry_point):
    build = _window_flow(
        [(_t(1), 1)],
        lambda pkg, s: _sum_fold(pkg, s, _ts_clock(pkg), _tumbling(pkg)),
        streams=("down", "meta"),
    )
    want, got = run_both(build, entry_point)
    metas = [(k, (wid, _meta(m))) for k, (wid, m) in got["meta"]]
    assert metas == [(k, (wid, _meta(m))) for k, (wid, m) in want["meta"]]
    assert metas == [("ALL", (0, (ALIGN, _t(60), set())))]


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_sliding_window_overlap(entry_point):
    # length 10 s, offset 5 s: an item at t=7 falls in windows 0 and 1.
    def window(pkg, s):
        windower = pkg["win"].SlidingWindower(
            length=timedelta(seconds=10), offset=timedelta(seconds=5), align_to=ALIGN
        )
        return pkg["win"].collect_window("coll", s, _ts_clock(pkg), windower)

    want, got = run_both(_window_flow([(_t(7), 1)], window), entry_point)

    def vals(out):
        return sorted((wid, [v for _ts, v in items]) for _k, (wid, items) in out["down"])

    assert vals(got) == vals(want) == [(0, [1]), (1, [1])]


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_late_items_go_to_late_stream(entry_point):
    inp = [(_t(60), "on-time"), (_t(1), "late")]  # the second lies behind the watermark
    build = _window_flow(
        inp,
        lambda pkg, s: pkg["win"].collect_window("coll", s, _ts_clock(pkg), _tumbling(pkg)),
        streams=("down", "late"),
    )
    want, got = run_both(build, entry_point)
    assert got["late"] == want["late"] == [("ALL", (0, (_t(1), "late")))]
    assert got["down"] == want["down"] and len(got["down"]) == 1


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_session_window_merge(entry_point):
    # Two separate sessions, then an item within the gap of both
    # merges them.  The clock waits long enough that the out-of-order
    # bridge is not late.
    inp = [(_t(s), s) for s in (0, 10, 5)]

    def window(pkg, s):
        return pkg["win"].collect_window(
            "coll",
            s,
            _ts_clock(pkg, wait_s=60),
            pkg["win"].SessionWindower(gap=timedelta(seconds=5)),
            ordered=False,
        )

    build = _window_flow(inp, window, streams=("down", "meta"), batch_size=1)
    want, got = run_both(build, entry_point)
    assert got["down"] == want["down"] and len(got["down"]) == 1
    _k, (_wid, items) = got["down"][0]
    assert sorted(v for _ts, v in items) == [0, 5, 10]
    metas = [(k, (wid, _meta(m))) for k, (wid, m) in got["meta"]]
    assert metas == [(k, (wid, _meta(m))) for k, (wid, m) in want["meta"]]
    _k, (_wid, (open_time, close_time, merged)) = metas[0]
    assert (open_time, close_time, len(merged)) == (ALIGN, _t(10), 1)


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_session_late(entry_point):
    inp = [(_t(30), "a"), (_t(1), "late")]

    def window(pkg, s):
        return pkg["win"].collect_window(
            "coll", s, _ts_clock(pkg), pkg["win"].SessionWindower(gap=timedelta(seconds=4))
        )

    want, got = run_both(_window_flow(inp, window, streams=("down", "late")), entry_point)
    late_id = PKGS[1]["win"].LATE_SESSION_ID
    assert got["late"] == want["late"] == [("ALL", (late_id, (_t(1), "late")))]


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_reduce_window(entry_point):
    inp = [(_t(1), 5), (_t(2), 3), (_t(3), 9)]

    def window(pkg, s):
        return pkg["win"].reduce_window(
            "max", s, _ts_clock(pkg), _tumbling(pkg), lambda a, b: a if a[1] >= b[1] else b
        )

    want, got = run_both(_window_flow(inp, window), entry_point)
    assert got["down"] == want["down"] == [("ALL", (0, (_t(3), 9)))]


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_max_min_window(entry_point):
    inp = [(_t(1), 5), (_t(2), 3)]

    def build(pkg):
        flow = pkg["Dataflow"]("test_df")
        s = pkg["op"].input("inp", flow, pkg["Source"](inp))
        keyed = pkg["op"].key_on("key", s, lambda _x: "ALL")
        out = {"max": [], "min": []}
        for name, fn in (("max", pkg["win"].max_window), ("min", pkg["win"].min_window)):
            wo = fn(name, keyed, _ts_clock(pkg), _tumbling(pkg), by=lambda item: item[1])
            pkg["op"].output(f"{name}_out", wo.down, pkg["Sink"](out[name]))
        return flow, out

    want, got = run_both(build, entry_point)
    assert got == want
    assert got == {"max": [("ALL", (0, (_t(1), 5)))], "min": [("ALL", (0, (_t(2), 3)))]}


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_count_window(entry_point):
    inp = [(_t(1), "apple"), (_t(2), "apple"), (_t(3), "pear")]

    def window(pkg, s):
        return pkg["win"].count_window(
            "count", s, _ts_clock(pkg), _tumbling(pkg), key=lambda item: item[1]
        )

    want, got = run_both(_window_flow(inp, window, key=False), entry_point)
    assert sorted(got["down"]) == sorted(want["down"]) == [("apple", (0, 2)), ("pear", (0, 1))]


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_collect_window_set_and_dict(entry_point):
    inp = [(_t(1), ("x", 1)), (_t(2), ("x", 2)), (_t(3), ("y", 9))]

    def window(pkg, s):
        unpacked = pkg["op"].map_value("unpack", s, lambda item: item[1])
        clock = pkg["win"].EventClock(
            ts_getter=lambda _kv: ALIGN, wait_for_system_duration=timedelta(seconds=60)
        )
        return pkg["win"].collect_window("coll", unpacked, clock, _tumbling(pkg), into=dict)

    want, got = run_both(_window_flow(inp, window), entry_point)
    assert got["down"] == want["down"] == [("ALL", (0, {"x": 2, "y": 9}))]


def _join_flow(left, right, window):
    def build(pkg):
        flow = pkg["Dataflow"]("test_df")
        lefts = pkg["op"].input("left", flow, pkg["Source"](*left))
        rights = pkg["op"].input("right", flow, pkg["Source"](*right))
        wo = window(pkg, lefts, rights)
        out = []
        pkg["op"].output("out", wo.down, pkg["Sink"](out))
        return flow, out

    return build


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_join_window(entry_point):
    def window(pkg, lefts, rights):
        clock = pkg["win"].EventClock(
            ts_getter=lambda _v: _t(1), wait_for_system_duration=timedelta(seconds=60)
        )
        return pkg["win"].join_window("join", clock, _tumbling(pkg), lefts, rights)

    want, got = run_both(_join_flow(([("k", 1)],), ([("k", "x")],), window), entry_point)
    assert got == want == [("k", (0, (1, "x")))]


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_join_window_product_merge_keeps_all_values(entry_point):
    # A session merge in product mode keeps both windows' values.
    left = (
        [("k", ("x", _t(0))), ("k", ("y", _t(10))), ("k", ("bridge", _t(5)))],
        1,
    )

    def window(pkg, lefts, rights):
        clock = pkg["win"].EventClock(
            ts_getter=lambda v: v[1], wait_for_system_duration=timedelta(seconds=60)
        )
        return pkg["win"].join_window(
            "join",
            clock,
            pkg["win"].SessionWindower(gap=timedelta(seconds=5)),
            lefts,
            rights,
            insert_mode="product",
            emit_mode="final",
        )

    want, got = run_both(_join_flow(left, ([("k", ("r", _t(0)))],), window), entry_point)
    assert sorted(got, key=repr) == sorted(want, key=repr)
    assert sorted(v[0] for _k, (_wid, (v, _r)) in got) == ["bridge", "x", "y"]


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_system_clock_runs(entry_point):
    def window(pkg, s):
        windower = pkg["win"].TumblingWindower(length=timedelta(hours=1), align_to=ALIGN)
        return pkg["win"].collect_window("coll", s, pkg["win"].SystemClock(), windower)

    want, got = run_both(_window_flow(list(range(5)), window), entry_point)
    # Everything lands in one window, closed at EOF (its id is the
    # wall clock's hour, the same in both runs but for an hour's turn).
    assert [items for _k, (_wid, items) in got["down"]] == [[0, 1, 2, 3, 4]]
    assert [items for _k, (_wid, items) in want["down"]] == [[0, 1, 2, 3, 4]]


def test_window_recovery(tmp_path):
    # ABORT (not EOF): EOF closes every window through the UTC_MAX
    # watermark, so open window state only carries across crashes.
    def build(pkg):
        inp = [(_t(1), 1), (_t(2), 2), pkg["Source"].ABORT(), (_t(3), 4), (_t(70), 100)]
        # The wait covers the clock's gap between the two runs.
        clock = _ts_clock(pkg, wait_s=100 * 365 * 86400)
        return _window_flow(inp, lambda pkg, s: _sum_fold(pkg, s, clock, _tumbling(pkg)))(pkg)

    outs = []
    for pkg in PKGS:
        flow, out = build(pkg)
        rc = recovery_config(pkg, tmp_path / pkg["name"])
        pkg["run_main"](flow, epoch_interval=ZERO_TD, recovery_config=rc)
        crashed = list(out["down"])  # windows still open
        pkg["run_main"](flow, epoch_interval=ZERO_TD, recovery_config=rc)
        outs.append((crashed, sorted(out["down"])))
    assert _same(outs) == ([], [("ALL", (0, 7)), ("ALL", (1, 100))])
