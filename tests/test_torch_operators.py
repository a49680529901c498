"""The torch port's operator library (``bytewax_tpu_torch/operators/
__init__.py`` and ``operators/helpers.py``) and its testing helpers
(``bytewax_tpu_torch/testing.py``, ``inputs.py``) held against the JAX
package: the cases of ``tests/operators/test_misc_operators.py`` and
``tests/operators/test_stateful_lifecycle.py``, each run through both
packages on the same input with the outputs compared in the order the
reference asserts.  ``collect`` by size runs under each package's
``run_main`` and ``cluster_main`` with one and two lanes, as the
reference's ``entry_point`` fixture runs it; so does
``filter_map_value``, which the reference's tests never call.
``collect`` by timeout (a ``PAUSE`` longer than the timeout), which
the reference runs under ``run_main`` only, runs under ``run_main``
and under ``cluster_main`` with two lanes.  ``enrich_cached`` and the
stateful lifecycle, which the reference runs under ``run_main`` only,
run under all three here; the lifecycle's recovery cases use a store
of each package's own (``init_db_dir``/``RecoveryConfig``).
"""

import asyncio
import time
from datetime import datetime, timedelta, timezone

import pytest

from tests.torch_entry_points import (  # noqa: F401
    ENTRY_POINTS,
    PKGS,
    entry,
    port_on_cpu,
    recovery_config,
    run_both,
    unsharded,
)

ZERO_TD = timedelta(seconds=0)
T0 = datetime(2022, 1, 1, tzinfo=timezone.utc)


def _collect_flow(inp, timeout, max_size):
    def build(pkg):
        flow = pkg["Dataflow"]("test_df")
        s = pkg["op"].input("inp", flow, pkg["Source"](inp(pkg)))
        c = pkg["op"].collect("collect", s, timeout=timeout, max_size=max_size)
        out = []
        pkg["op"].output("out", c, pkg["Sink"](out))
        return flow, out

    return build


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_collect_max_size(entry_point):
    inp = [("k", i) for i in range(7)]
    want, got = run_both(
        _collect_flow(lambda pkg: inp, timedelta(seconds=10), 3), entry_point
    )
    # Size-triggered flushes of 3, then the remainder at EOF.
    assert got == want == [("k", [0, 1, 2]), ("k", [3, 4, 5]), ("k", [6])]


@pytest.mark.parametrize("entry_point", ["run_main", "cluster_main-2thread"])
def test_collect_timeout(entry_point):
    # A mid-stream pause longer than the timeout flushes the batch.
    def inp(pkg):
        pause = pkg["Source"].PAUSE(for_duration=timedelta(seconds=1.2))
        return [("k", 0), ("k", 1), pause, ("k", 2)]

    want, got = run_both(
        _collect_flow(inp, timedelta(seconds=0.5), 10), entry_point
    )
    assert got == want == [("k", [0, 1]), ("k", [2])]


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_enrich_cached_caches_within_ttl(entry_point):
    calls = {}

    def build(pkg):
        made = calls.setdefault(pkg["name"], [])

        def getter(k):
            made.append(k)
            return k.upper()

        fake = pkg["TimeTestingGetter"](T0)
        flow = pkg["Dataflow"]("test_df")
        s = pkg["op"].input("inp", flow, pkg["Source"](["a", "a", "b"]))
        e = pkg["op"].enrich_cached(
            "enrich",
            s,
            getter,
            lambda cache, x: (x, cache.get(x)),
            ttl=timedelta(minutes=1),
            _now_getter=fake.get,
        )
        out = []
        pkg["op"].output("out", e, pkg["Sink"](out))
        return flow, out

    want, got = run_both(build, entry_point)
    assert got == want == [("a", "A"), ("a", "A"), ("b", "B")]
    # The second "a" is served from the cache.
    assert calls["bytewax_tpu_torch"] == calls["bytewax_tpu"] == ["a", "b"]


def test_ttl_cache_expiry():
    seen = []
    for pkg in PKGS:
        calls = []
        fake = pkg["TimeTestingGetter"](T0)
        cache = pkg["op"].TTLCache(
            lambda k, calls=calls: calls.append(k) or len(calls),
            fake.get,
            timedelta(seconds=30),
        )
        got = [cache.get("x"), cache.get("x")]
        fake.advance(timedelta(seconds=31))
        got.append(cache.get("x"))  # expired, fetched again
        cache.remove("x")
        got.append(cache.get("x"))
        seen.append(got)
    assert seen[1] == seen[0] == [1, 1, 2, 3]


def test_pause_sentinel_delays_items():
    gaps = []

    def build(pkg):
        stamps = []
        gaps.append(stamps)
        inp = [1, pkg["Source"].PAUSE(for_duration=timedelta(seconds=0.5)), 2]
        flow = pkg["Dataflow"]("test_df")
        s = pkg["op"].input("inp", flow, pkg["Source"](inp))
        s = pkg["op"].map("stamp", s, lambda x: (stamps.append(time.monotonic()), x)[1])
        out = []
        pkg["op"].output("out", s, pkg["Sink"](out))
        return flow, out

    want, got = run_both(build)
    assert got == want == [1, 2]
    for stamps in gaps:
        assert stamps[1] - stamps[0] >= 0.45


def test_batch_helpers():
    seen = []
    for pkg in PKGS:
        inputs = pkg["inputs"]
        got = [list(inputs.batch(iter(range(5)), 2))]
        items = iter([1, 2, None, 3])
        got.append(next(inputs.batch_getter(lambda items=items: next(items), 10)))
        items2 = iter([1, 2])

        def getter_ex(items2=items2):
            try:
                return next(items2)
            except StopIteration:
                raise IndexError() from None

        got.append(next(inputs.batch_getter_ex(getter_ex, 10)))
        seen.append(got)
    assert seen[1] == seen[0] == [[[0, 1], [2, 3], [4]], [1, 2], [1, 2]]


def _batched(pkg, agen, timeout_s, size):
    return list(
        pkg["inputs"].batch_async(agen(), timeout=timedelta(seconds=timeout_s), batch_size=size)
    )


def test_batch_async():
    async def agen():
        for i in range(5):
            yield i

    seen = [[b for b in _batched(pkg, agen, 1, 2) if b] for pkg in PKGS]
    assert seen[1] == seen[0] == [[0, 1], [2, 3], [4]]


def test_batch_async_slow_producer_preserves_inflight():
    # A producer slower than the gather timeout yields partial or
    # empty batches, and the in-flight anext survives across timeouts,
    # so no item is lost or duplicated.
    async def agen():
        for i in range(6):
            await asyncio.sleep(0.03)  # slower than the 20 ms timeout
            yield i

    for pkg in PKGS:
        batches = _batched(pkg, agen, 0.02, 3)
        assert [x for b in batches for x in b] == [0, 1, 2, 3, 4, 5]
        assert 3 < len(batches) < 100


def test_then_returns_chainable_windowout():
    # `.then` through an operator that returns a dataclass bundle.
    def build(pkg):
        win = pkg["win"]
        flow = pkg["Dataflow"]("test_df")
        wo = (
            pkg["op"].input("inp", flow, pkg["Source"]([T0]))
            .then(pkg["op"].key_on, "key", lambda _x: "ALL")
            .then(
                win.collect_window,
                "cw",
                win.EventClock(ts_getter=lambda x: x, wait_for_system_duration=ZERO_TD),
                win.TumblingWindower(length=timedelta(minutes=1), align_to=T0),
            )
        )
        out = []
        pkg["op"].output("out", wo.down, pkg["Sink"](out))
        return flow, out

    want, got = run_both(build)
    assert got == want == [("ALL", (0, [T0]))]


def test_simple_polling_source_snapshot_resume():
    """``SimplePollingSource``'s snapshot and resume round-trip
    through the partition."""
    seen = []
    for pkg in PKGS:

        class Cursor(pkg["inputs"].SimplePollingSource):
            def __init__(self):
                super().__init__(interval=timedelta(0))
                self.at = 0
                self.resumed_with = None

            def next_item(self):
                self.at += 1
                return self.at

            def snapshot(self):
                return self.at

            def resume(self, resume_state):
                self.resumed_with = resume_state
                self.at = resume_state

        poll = pkg["testing"].poll_next_batch
        part = Cursor().build_part("poll", "singleton", None)
        got = [poll(part), poll(part), part.snapshot()]
        src2 = Cursor()
        part2 = src2.build_part("poll", "singleton", got[-1])
        got += [src2.resumed_with, poll(part2)]
        seen.append(got)
    assert seen[1] == seen[0] == [[1], [2], 2, 2, [3]]


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_filter_map_value(entry_point):
    def build(pkg):
        flow = pkg["Dataflow"]("test_df")
        s = pkg["op"].input("inp", flow, pkg["Source"]([("a", "1"), ("b", "x"), ("a", "3")]))
        s = pkg["op"].filter_map_value("parse", s, lambda v: int(v) if v.isdigit() else None)
        out = []
        pkg["op"].output("out", s, pkg["Sink"](out))
        return flow, out

    want, got = run_both(build, entry_point)
    assert sorted(got) == sorted(want) == [("a", 1), ("a", 3)]


# -- the stateful lifecycle ---------------------------------------------------


def _logic(pkg, **flags):
    """The lifecycle probe of ``tests/operators/test_stateful_lifecycle.py``
    on ``pkg``'s ``StatefulLogic``: every hook emits its state
    transition; ``flags`` set the class's retain/discard choices."""
    base = pkg["op"].StatefulLogic

    class TestLogic(base):
        item_triggers_notify = False
        after_item = base.RETAIN
        after_notify = base.RETAIN
        after_eof = base.RETAIN

        def __init__(self, state):
            self._notify_at = None
            self._state = state if state is not None else "NEW"

        def _move(self, to, after):
            old, self._state = self._state, to
            return ([(old, to)], after)

        def on_item(self, value):
            if self.item_triggers_notify:
                self._notify_at = datetime.now(timezone.utc)
            return self._move("ITEM", self.after_item)

        def on_notify(self):
            self._notify_at = None
            return self._move("NOTIFY", self.after_notify)

        def on_eof(self):
            return self._move("EOF", self.after_eof)

        def notify_at(self):
            return self._notify_at

        def snapshot(self):
            return self._state

    for name, value in flags.items():
        setattr(TestLogic, name, getattr(base, value) if isinstance(value, str) else value)
    return TestLogic


def _lifecycle(inp, stores=None, runs=1, entry_point="run_main", **flags):
    """Runs the probe over ``inp(pkg)`` under each package's
    ``run_main``, ``runs`` times against one store of its own; returns
    each package's outputs per run."""
    outs = []
    for pkg in PKGS:
        flow = pkg["Dataflow"]("test_df")
        s = pkg["op"].input("inp", flow, pkg["Source"](inp(pkg)))
        s = pkg["op"].key_on("key", s, lambda _x: "ALL")
        s = pkg["op"].stateful("stateful", s, _logic(pkg, **flags))
        out = []
        pkg["op"].output("out", s, pkg["Sink"](out))
        kwargs = {}
        if stores is not None:
            kwargs["recovery_config"] = recovery_config(pkg, stores / pkg["name"])
        per_run = []
        for _ in range(runs):
            out.clear()
            entry(pkg, entry_point)(flow, epoch_interval=ZERO_TD, **kwargs)
            per_run.append(list(out))
        outs.append(per_run)
    return outs


def _items_then_abort(pkg):
    return [1, 2, pkg["Source"].ABORT()]


@pytest.mark.parametrize(
    "flags, expect",
    [
        # Discard after each item: the logic is built fresh every time.
        ({"after_item": "DISCARD"}, [("NEW", "ITEM"), ("NEW", "ITEM")]),
        ({"after_item": "RETAIN"}, [("NEW", "ITEM"), ("ITEM", "ITEM")]),
        (
            {"item_triggers_notify": True, "after_notify": "DISCARD"},
            [("NEW", "ITEM"), ("ITEM", "NOTIFY"), ("NEW", "ITEM"), ("ITEM", "NOTIFY")],
        ),
        (
            {"item_triggers_notify": True, "after_notify": "RETAIN"},
            [("NEW", "ITEM"), ("ITEM", "NOTIFY"), ("NOTIFY", "ITEM"), ("ITEM", "NOTIFY")],
        ),
    ],
    ids=["on_item_discard", "on_item_retain", "on_notify_discard", "on_notify_retain"],
)
@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_stateful_hooks(entry_point, flags, expect):
    (want,), (got,) = _lifecycle(_items_then_abort, entry_point=entry_point, **flags)
    assert got == want == [("ALL", t) for t in expect]


@pytest.mark.parametrize(
    "after_eof, resumed",
    [("DISCARD", ("NEW", "ITEM")), ("RETAIN", ("EOF", "ITEM"))],
    ids=["on_eof_discard", "on_eof_retain"],
)
@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_stateful_on_eof(tmp_path, entry_point, after_eof, resumed):
    # A recovery continuation past EOF() proves the discard (or the
    # retain) was durable: the resumed item sees a fresh logic (or the
    # state retained across EOF).
    def inp(pkg):
        return [1, pkg["Source"].EOF(), 2, pkg["Source"].ABORT()]

    want, got = _lifecycle(
        inp, stores=tmp_path, runs=2, entry_point=entry_point, after_eof=after_eof
    )
    assert got == want
    assert got[0] == [("ALL", ("NEW", "ITEM")), ("ALL", ("ITEM", "EOF"))]
    assert got[1] == [("ALL", resumed)]


@pytest.mark.parametrize("entry_point", ENTRY_POINTS)
def test_stateful_resume_state_passed_to_builder(tmp_path, entry_point):
    def inp(pkg):
        return [1, pkg["Source"].ABORT(), 2]

    want, got = _lifecycle(
        inp, stores=tmp_path, runs=2, entry_point=entry_point, after_item="RETAIN"
    )
    assert got == want
    assert got[0] == [("ALL", ("NEW", "ITEM"))]
    # The snapshotted state "ITEM" is passed to the rebuilt logic; the
    # second run exhausts the input, so EOF fires too.
    assert got[1] == [("ALL", ("ITEM", "ITEM")), ("ALL", ("ITEM", "EOF"))]
