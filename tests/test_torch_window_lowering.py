"""The window tier's lowering and fall-back rules in the torch port
(``bytewax_tpu_torch/engine/flatten.py`` ``_annotate_accel`` and
``_window_accel_spec``; ``engine/driver.py``
``_process_window_accel``) held against the JAX package.

Each flow runs through both packages with the device tier on
(``BYTEWAX_TPU_ACCEL=1``) unless a case says otherwise, and each case
checks three things: the annotation (the ``stateful_batch`` core
operator's ``conf["_accel"]``, the same spec class, kind and window
shape in both packages, or ``None`` in both), the port's folds on its
device tier (the rows ``DeviceAggState._scatter`` took, the one place
a fold launches the segment-fold kernel on a card: a lowered run folds
there, a run that stays on or falls back to the host folds nothing
there), and the output (equal, with float sums to ``rtol=atol=1e-5``).

The cases are those of ``tests/test_window_accel.py`` and
``tests/test_session_accel.py`` that ``tests/test_torch_windowing.py``
does not already hold against the reference:

- annotated: ``test_count_window_is_annotated``,
  ``test_fold_window_with_mean_marker_is_annotated``,
  ``test_session_count_window_is_annotated`` (here with ``reduce_window``,
  ``fold_window`` over ``SUM`` and ``mean_window`` beside them);
- kept on the host: ``test_session_fold_custom_merger_stays_host``,
  and the rules of ``_window_accel_spec`` that no reference test
  drives (a builder that is not the kind's identity, a user-made
  ``Reducer``/``WindowFold``, a builder that raises, a fake clock);
- falling back at run time: ``test_windowed_sum_itemized_falls_back_to_host``,
  ``test_windowed_fold_nonconforming_columnar_falls_back``,
  ``test_windowed_sum_mixed_columnar_then_itemized``,
  ``test_windowed_fallback_boundary_then_columnar``;
- the host tier's degrade of columnar batches:
  ``test_columnar_batches_degrade_on_host_tier``,
  ``test_windowed_sum_columnar_degrades_on_host_tier``;
- crossing tiers through a store: ``test_window_accel_cross_tier_recovery``,
  ``test_window_accel_host_to_device_recovery``,
  ``test_mean_window_cross_tier_recovery``,
  ``test_dict_encoded_window_cross_tier_recovery``,
  ``test_session_cross_tier_recovery`` (both directions);
- the state's own rules: ``test_key_id_without_vocab_raises_clearly``,
  ``test_windowed_vocab_must_extend``,
  ``test_itemized_promotion_unit_matches_per_item_path``,
  ``test_itemized_promotion_rejects_disagreeing_getter``,
  ``test_itemized_promotion_rejects_non_utc``, ``test_ts_value_degrade_shapes``;
- flows: ``test_count_window_benchmark_shape``,
  ``test_window_accel_late_items``, ``test_high_cardinality_windowed_count``,
  ``test_session_late_values_use_sentinel``.

Already held against the reference in ``tests/test_torch_windowing.py``
(its columnar, dictionary-encoded, itemized-promotion, lateness-boundary
and session-merge cases): ``test_count_window_device_matches_host``,
``test_window_accel_lateness_boundary``, ``test_count_window_columnar``,
``test_windowed_sum_columnar_matches_host``,
``test_windowed_mean_stats_device_matches_host``,
``test_count_window_dict_encoded_columnar``,
``test_windowed_sum_dict_encoded_matches_host``,
``test_itemized_tsvalue_flow_device_matches_host``,
``test_session_count_device_matches_host``,
``test_session_merge_metadata`` and ``test_session_sum_columnar_matches_host``.
"""

import operator
import pickle
import time
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from tests.torch_entry_points import (  # noqa: F401
    PKGS,
    PORT,
    REF,
    assert_same_error,
    port_folds,
    port_on_cpu,
    raised,
    recovery_config,
    unsharded,
)

ALIGN = datetime(2022, 1, 1, tzinfo=timezone.utc)
BASE = np.datetime64(ALIGN.replace(tzinfo=None), "us")
FAR = timedelta(days=999)


@pytest.fixture
def accel(monkeypatch):
    """Sets ``BYTEWAX_TPU_ACCEL`` for the runs that follow."""

    def set_accel(on: bool):
        monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1" if on else "0")

    set_accel(True)
    return set_accel


def _t(seconds):
    return ALIGN + timedelta(seconds=seconds)


def _ts(secs):
    return BASE + np.asarray(secs).astype("timedelta64[s]")


def _close(g, w):
    return abs(g - w) <= 1e-5 + 1e-5 * abs(w)


def _same_value(g, w):
    if isinstance(w, tuple):
        return len(g) == len(w) and all(_same_value(a, b) for a, b in zip(g, w))
    if isinstance(w, float) and not isinstance(w, bool):
        return _close(g, w)
    return g == w and type(g) is type(w)


def assert_windows_equal(got, want):
    """``(key, (wid, value))`` rows: keys, window ids, counts, min and
    max exact, float sums to the tolerance."""
    got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert [(k, wid) for k, (wid, _v) in got] == [(k, wid) for k, (wid, _v) in want]
    for (k, (wid, g)), (_k, (_w, w)) in zip(got, want):
        assert _same_value(g, w), (k, wid, g, w)


def _meta(rows):
    return sorted(
        (k, wid, m.open_time, m.close_time, sorted(m.merged_ids)) for k, (wid, m) in rows
    )


def _spec_of(pkg, flow):
    plan = pkg["flatten"](flow)
    (inner,) = [o for o in plan.ops if o.name == "stateful_batch"]
    return inner.conf.get("_accel")


def _spec_shape(spec):
    if spec is None:
        return None
    return (
        type(spec).__name__,
        spec.kind,
        spec.align_us,
        spec.length_us,
        spec.offset_us,
        spec.wait_us,
        getattr(spec, "gap_us", None),
    )


def _clock(pkg, ts_getter=None, wait=timedelta(seconds=5), **kwargs):
    return pkg["win"].EventClock(
        ts_getter=ts_getter or pkg["column_ts"], wait_for_system_duration=wait, **kwargs
    )


def _windower(pkg, name):
    win = pkg["win"]
    if name == "tumbling":
        return win.TumblingWindower(length=timedelta(minutes=1), align_to=ALIGN)
    if name == "sliding":
        return win.SlidingWindower(
            length=timedelta(minutes=3), offset=timedelta(minutes=1), align_to=ALIGN
        )
    return win.SessionWindower(gap=timedelta(seconds=20))


def _flow(pkg, source, window, streams=("down",)):
    """``input(source) -> window(pkg, stream)``; returns the flow and a
    dict of each stream's rows."""
    flow = pkg["Dataflow"]("test_df")
    s = pkg["op"].input("inp", flow, source)
    wo = window(pkg, s)
    out = {name: [] for name in streams}
    for name in streams:
        pkg["op"].output(name, getattr(wo, name), pkg["Sink"](out[name]))
    return flow, out


def _run_both(source_of, window, streams=("down",)):
    """Builds and runs the flow in each package; returns each
    package's annotation and outputs."""
    runs = []
    for pkg in PKGS:
        flow, out = _flow(pkg, source_of(pkg), window, streams)
        spec = _spec_of(pkg, flow)
        pkg["run_main"](flow)
        runs.append((_spec_shape(spec), out))
    (want_spec, want), (got_spec, got) = runs
    assert got_spec == want_spec
    return got_spec, want, got


def _events(n=600, n_keys=4, spread_s=600, seed=0):
    rng = np.random.RandomState(seed)
    secs = np.sort(rng.randint(0, spread_s, size=n))
    ids = rng.randint(0, n_keys, size=n)
    vals = np.round(rng.randn(n) * 20, 2).astype(np.float32).astype(np.float64)
    return secs, ids, vals


def _columnar(secs, ids, vals=None, size=128):
    vocab = np.array([f"key{k}" for k in range(int(ids.max()) + 1)])

    def source_of(pkg):
        batches = []
        for i in range(0, len(secs), size):
            cols = {"ts": _ts(secs[i : i + size])}
            if vals is not None:
                cols["value"] = vals[i : i + size]
            cols["key"] = vocab[ids[i : i + size]]
            batches.append(pkg["Batch"](cols))
        return pkg["ArraySource"](batches)

    return source_of


# -- what lowers --------------------------------------------------------------


def _count(pkg, s, windower="tumbling"):
    return pkg["win"].count_window(
        "w", s, _clock(pkg, lambda x: x), _windower(pkg, windower), key=lambda x: x
    )


LOWERED = {
    "count_tumbling": (lambda pkg, s: _count(pkg, s), "count"),
    "count_session": (lambda pkg, s: _count(pkg, s, "session"), "count"),
    "reduce_sum_sliding": (
        lambda pkg, s: pkg["win"].reduce_window(
            "w", s, _clock(pkg), _windower(pkg, "sliding"), pkg["xla"].SUM
        ),
        "sum",
    ),
    "reduce_min_tumbling": (
        lambda pkg, s: pkg["win"].reduce_window(
            "w", s, _clock(pkg), _windower(pkg, "tumbling"), pkg["xla"].MIN
        ),
        "min",
    ),
    "reduce_max_session": (
        lambda pkg, s: pkg["win"].reduce_window(
            "w", s, _clock(pkg), _windower(pkg, "session"), pkg["xla"].MAX
        ),
        "max",
    ),
    "fold_mean_tumbling": (
        lambda pkg, s: pkg["win"].fold_window(
            "w",
            s,
            _clock(pkg),
            _windower(pkg, "tumbling"),
            pkg["xla"].MEAN.make_acc,
            pkg["xla"].MEAN,
            pkg["xla"].MEAN.merge,
        ),
        "mean",
    ),
    "fold_sum_sliding_add": (
        lambda pkg, s: pkg["win"].fold_window(
            "w", s, _clock(pkg), _windower(pkg, "sliding"), lambda: 0.0, pkg["xla"].SUM, operator.add
        ),
        "sum",
    ),
    "fold_sum_session": (
        lambda pkg, s: pkg["win"].fold_window(
            "w", s, _clock(pkg), _windower(pkg, "session"), lambda: 0, pkg["xla"].SUM, pkg["xla"].SUM
        ),
        "sum",
    ),
    "mean_window_session": (
        lambda pkg, s: pkg["win"].mean_window("w", s, _clock(pkg), _windower(pkg, "session")),
        "mean",
    ),
}


@pytest.mark.parametrize("case", sorted(LOWERED))
def test_lowered_window_folds_on_device(accel, port_folds, case):
    """Each lowered shape carries its spec in both packages, folds on
    the port's device tier and gives the reference's windows."""
    window, kind = LOWERED[case]
    secs, ids, vals = _events(seed=sorted(LOWERED).index(case))
    source_of = _columnar(secs, ids, None if kind == "count" else vals)
    spec, want, got = _run_both(source_of, window, streams=("down", "meta"))
    session = "session" in case
    assert spec is not None and spec[:2] == (
        "SessionAccelSpec" if session else "WindowAccelSpec",
        kind,
    )
    assert got["down"] and _meta(got["meta"]) == _meta(want["meta"])
    assert_windows_equal(got["down"], want["down"])
    assert port_folds.total > 0
    assert [s.device.type for s in port_folds.states] == ["cpu"]


# -- what stays on the host ---------------------------------------------------


def _raising_builder():
    raise RuntimeError("no builder here")


HOST = {
    # The device fold starts from the kind's identity: any other
    # initial accumulator keeps the step on the host.
    "sum_builder_not_identity": lambda pkg, s: pkg["win"].fold_window(
        "w", s, _clock(pkg), _windower(pkg, "tumbling"), lambda: 1.0, pkg["xla"].SUM, pkg["xla"].SUM
    ),
    "mean_builder_not_identity": lambda pkg, s: pkg["win"].fold_window(
        "w",
        s,
        _clock(pkg),
        _windower(pkg, "tumbling"),
        lambda: (1.0, 0),
        pkg["xla"].MEAN,
        pkg["xla"].MEAN.merge,
    ),
    # A user's Reducer of a kind with no binary device combine.
    "user_reducer_mean": lambda pkg, s: pkg["win"].reduce_window(
        "w", s, _clock(pkg), _windower(pkg, "tumbling"), pkg["xla"].Reducer("mean", max)
    ),
    # A user's WindowFold of a kind the device tier lacks.
    "user_window_fold": lambda pkg, s: pkg["win"].fold_window(
        "w",
        s,
        _clock(pkg),
        _windower(pkg, "tumbling"),
        list,
        pkg["xla"].WindowFold("median", list, lambda a, v: a + [v], operator.add, sorted),
        operator.add,
    ),
    # A session fold whose merger is not the kind's own combine.
    "session_custom_merger": lambda pkg, s: pkg["win"].fold_window(
        "w", s, _clock(pkg), _windower(pkg, "session"), lambda: 0, pkg["xla"].SUM, lambda a, b: a + b
    ),
    "plain_folder": lambda pkg, s: pkg["win"].fold_window(
        "w", s, _clock(pkg), _windower(pkg, "tumbling"), lambda: 0.0, lambda a, v: a + v, operator.add
    ),
    # A clock with its own now_getter needs the host's per-item path.
    "fake_clock": lambda pkg, s: pkg["win"].count_window(
        "w",
        s,
        _clock(pkg, lambda x: x, now_getter=pkg["TimeTestingGetter"](_t(10**6)).get),
        _windower(pkg, "tumbling"),
        key=lambda x: x,
    ),
}


@pytest.mark.parametrize("case", sorted(HOST))
def test_unlowerable_window_stays_on_host(accel, port_folds, case):
    secs, ids, vals = _events(n=300, seed=20 + sorted(HOST).index(case))
    source_of = _columnar(secs, ids, None if case == "fake_clock" else vals)
    spec, want, got = _run_both(source_of, HOST[case])
    assert spec is None
    assert got["down"]
    if case == "user_window_fold":
        assert sorted(got["down"]) == sorted(want["down"])
    else:
        assert_windows_equal(got["down"], want["down"])
    assert port_folds.states == [] and port_folds.total == 0


def test_raising_builder_probe_stays_on_host():
    """A builder that raises when the lowering probes it keeps the step
    on the host, with a warning that names the step."""
    messages = []
    for pkg in PKGS:
        flow, _out = _flow(
            pkg,
            pkg["Source"]([]),
            lambda pkg, s: pkg["win"].fold_window(
                "w", s, _clock(pkg), _windower(pkg, "tumbling"), _raising_builder,
                pkg["xla"].SUM, pkg["xla"].SUM,
            ),
        )
        with pytest.warns(RuntimeWarning, match="probing the window fold builder") as caught:
            assert _spec_of(pkg, flow) is None
        messages.append([str(w.message) for w in caught if w.category is RuntimeWarning])
    assert messages[1] == messages[0] and "'test_df.w" in messages[1][0]


# -- what falls back at run time ----------------------------------------------


class _Stamped(float):
    """A float that carries its event time under a name of its own (no
    ``.ts``): the itemized promotion cannot read it."""

    def __new__(cls, value, at):
        self = super().__new__(cls, value)
        self.at = at
        return self


def _batches_source(batches_of):
    """A one-partition source handing out ``batches_of(pkg)`` in turn
    (columnar and itemized batches mixed)."""

    def source_of(pkg):
        inputs = pkg["inputs"]
        batches = batches_of(pkg)

        class _Part(inputs.StatelessSourcePartition):
            def __init__(self, mine):
                self._batches = list(batches) if mine else []

            def next_batch(self):
                if not self._batches:
                    raise StopIteration()
                return self._batches.pop(0)

        class _Source(inputs.DynamicSource):
            def build(self, step_id, worker_index, worker_count):
                return _Part(worker_index == 0)

        return _Source()

    return source_of


def _reduce(kind):
    def window(pkg, s):
        return pkg["win"].reduce_window(
            "w", s, _clock(pkg, lambda v: v.at if hasattr(v, "at") else pkg["column_ts"](v)),
            _windower(pkg, "tumbling"), getattr(pkg["xla"], kind),
        )

    return window


def _col(pkg, keys, secs, vals=None):
    cols = {"key": np.array(keys), "ts": _ts(secs)}
    if vals is not None:
        cols["value"] = np.array(vals, dtype=np.float64)
    return pkg["Batch"](cols)


FALLBACK = {
    # Itemized values the promotion cannot read: the numeric fold
    # falls back to the host on first contact.
    "itemized_first": (
        lambda pkg: [[("k", _Stamped(2.0, _t(1))), ("k", _Stamped(3.0, _t(2)))]],
        "SUM",
        [("k", (0, 5.0))],
        False,
    ),
    # A columnar batch with ts but no value column: the host takes it,
    # degraded to keyed items whose value is the timestamp.
    "columnar_without_value": (
        lambda pkg: [pkg["Batch"]({"key": np.array(["k", "k"]), "ts": _ts([1, 2])})],
        "MAX",
        [("k", (0, _t(2)))],
        False,
    ),
    # Itemized rows before any device state, then a columnar batch: with
    # no native promotion the itemized rows move the step to the host
    # for good and the columnar batch degrades there; with it, both
    # fold on the device.
    "itemized_then_columnar_no_native": (
        lambda pkg: [[("a", pkg["TsValue"](2.0, _t(1)))], _col(pkg, ["a"], [1], [3.0])],
        "SUM",
        [("a", (0, 5.0))],
        "no_native",
    ),
    "itemized_then_columnar_promoted": (
        lambda pkg: [[("a", pkg["TsValue"](2.0, _t(1)))], _col(pkg, ["a"], [1], [3.0])],
        "SUM",
        [("a", (0, 5.0))],
        True,
    ),
    # Device state from a columnar batch first: later itemized rows
    # fold on the device through the ts getter.
    "columnar_then_itemized": (
        lambda pkg: [
            _col(pkg, ["a", "b"], [1, 2], [2.0, 5.0]),
            [("a", pkg["TsValue"](3.0, _t(2))), ("b", pkg["TsValue"](7.0, _t(70)))],
        ],
        "SUM",
        [("a", (0, 5.0)), ("b", (0, 5.0)), ("b", (1, 7.0))],
        True,
    ),
    # The same with itemized values the promotion cannot read: once
    # device state exists they take the per-item device path.
    "columnar_then_unpromotable": (
        lambda pkg: [
            _col(pkg, ["a", "b"], [1, 2], [2.0, 5.0]),
            [("a", _Stamped(3.0, _t(2))), ("b", _Stamped(7.0, _t(70)))],
        ],
        "SUM",
        [("a", (0, 5.0)), ("b", (0, 5.0)), ("b", (1, 7.0))],
        True,
    ),
}


@pytest.mark.parametrize("case", sorted(FALLBACK))
def test_runtime_fallback(accel, port_folds, monkeypatch, case):
    batches_of, kind, expect, on_device = FALLBACK[case]
    if on_device == "no_native":
        # Both packages as they run where the native library does not
        # build: the promotion declines every batch.
        for pkg in PKGS:
            monkeypatch.setattr(
                pkg["wa"].DeviceWindowAggState, "on_batch_items", lambda self, items: None
            )
        on_device = False
    spec, want, got = _run_both(_batches_source(batches_of), _reduce(kind))
    assert spec is not None and spec[:2] == ("WindowAccelSpec", kind.lower())
    assert sorted(got["down"]) == sorted(want["down"]) == expect
    if on_device:
        # Both deliveries folded on the device, one fold each.
        batches = batches_of(PORT)
        assert port_folds.rows == [len(b) for b in batches]
    else:
        assert port_folds.total == 0


@pytest.mark.parametrize("case", ["count", "sum"])
def test_columnar_batches_degrade_on_host_tier(accel, port_folds, case):
    accel(False)
    vals = None if case == "count" else np.array([2.0, 5.0, 7.0])
    source_of = _columnar(np.array([1, 2, 61]), np.array([0, 1, 0]), vals)
    if case == "count":
        window = LOWERED["count_tumbling"][0]
        expect = [("key0", (0, 1)), ("key0", (1, 1)), ("key1", (0, 1))]
    else:
        window = _reduce("SUM")
        expect = [("key0", (0, 2.0)), ("key0", (1, 7.0)), ("key1", (0, 5.0))]
    spec, want, got = _run_both(source_of, window)
    assert spec is not None
    assert sorted(got["down"]) == sorted(want["down"]) == expect
    assert port_folds.total == 0


# -- crossing tiers through a store -------------------------------------------


def _abort_run_twice(tmp_path, accel, port_folds, first, second, source_of, window,
                     streams=("down",)):
    """Runs the flow over ``source_of(pkg)`` to its abort on the tier
    ``first`` and resumes it on ``second``, in each package against a
    store of its own; returns each package's rows of each run and the
    port's folds per run."""
    runs, folds = [], []
    for pkg in PKGS:
        flow, out = _flow(pkg, source_of(pkg), window, streams)
        rc = recovery_config(pkg, tmp_path / pkg["name"])
        per_run = []
        for on in (first, second):
            accel(on)
            before = port_folds.total
            pkg["run_main"](flow, epoch_interval=timedelta(0), recovery_config=rc)
            per_run.append({name: list(rows) for name, rows in out.items()})
            for rows in out.values():
                rows.clear()
            if pkg is PORT:
                folds.append(port_folds.total - before)
        runs.append(per_run)
    return runs[0], runs[1], folds


def _testing_source(inp):
    return lambda pkg: pkg["Source"](inp(pkg))


def test_window_cross_tier_recovery(tmp_path, accel, port_folds):
    def inp(pkg):
        return [(_t(1), "a"), (_t(2), "a"), pkg["Source"].ABORT(), (_t(3), "a")]

    def window(pkg, s):
        return pkg["win"].count_window(
            "w", s, _clock(pkg, lambda item: item[0], FAR), _windower(pkg, "tumbling"),
            key=lambda item: item[1],
        )

    # Crash on the device tier, resume on the host tier.
    want, got, folds = _abort_run_twice(
        tmp_path, accel, port_folds, True, False, _testing_source(inp), window
    )
    assert got == want
    assert [r["down"] for r in got] == [[], [("a", (0, 3))]]
    assert folds[0] > 0 and folds[1] == 0


def test_window_host_to_device_recovery(tmp_path, accel, port_folds):
    # An ordered host-tier window logic keeps on-time values ahead of
    # the watermark in its snapshot's queue; the device tier must
    # replay them into their windows on resume.
    ts_map = {2.0: _t(1), 3.0: _t(2), 4.0: _t(3)}

    def inp(pkg):
        return [("k", 2.0), ("k", 3.0), pkg["Source"].ABORT(), ("k", 4.0)]

    def window(pkg, s):
        return pkg["win"].fold_window(
            "w", s, _clock(pkg, ts_map.__getitem__, FAR), _windower(pkg, "tumbling"),
            lambda: 0, pkg["xla"].SUM, pkg["xla"].SUM,
        )

    want, got, folds = _abort_run_twice(
        tmp_path, accel, port_folds, False, True, _testing_source(inp), window
    )
    assert got == want
    assert [r["down"] for r in got] == [[], [("k", (0, 9))]]
    assert folds[0] == 0


def test_mean_window_cross_tier_recovery(tmp_path, accel, port_folds):
    ts_map = {2.0: _t(1), 4.0: _t(2), 9.0: _t(3)}

    def inp(pkg):
        return [("k", 2.0), ("k", 4.0), pkg["Source"].ABORT(), ("k", 9.0)]

    def window(pkg, s):
        return pkg["win"].mean_window(
            "w", s, _clock(pkg, ts_map.__getitem__, FAR), _windower(pkg, "tumbling")
        )

    want, got, folds = _abort_run_twice(
        tmp_path, accel, port_folds, True, False, _testing_source(inp), window
    )
    assert got == want
    assert [r["down"] for r in got] == [[], [("k", (0, 5.0))]]
    assert folds[1] == 0


@pytest.mark.parametrize("first", [True, False], ids=["device_to_host", "host_to_device"])
def test_session_cross_tier_recovery(tmp_path, accel, port_folds, first):
    def inp(pkg):
        # The last item lies within the gap of the snapshot's open
        # session: it must extend it.
        return [(_t(1), "a"), (_t(3), "a"), pkg["Source"].ABORT(), (_t(9), "a")]

    def window(pkg, s):
        return pkg["win"].count_window(
            "w", s, _clock(pkg, lambda item: item[0], FAR),
            pkg["win"].SessionWindower(gap=timedelta(seconds=10)), key=lambda item: item[1],
        )

    want, got, folds = _abort_run_twice(
        tmp_path, accel, port_folds, first, not first, _testing_source(inp), window,
        ("down", "meta", "late")
    )
    assert [r["down"] for r in got] == [r["down"] for r in want] == [[], [("a", (0, 3))]]
    assert [_meta(r["meta"]) for r in got] == [_meta(r["meta"]) for r in want]
    assert _meta(got[1]["meta"]) == [("a", 0, _t(1), _t(9), [])]
    assert (folds[0] > 0) is first


def test_dict_encoded_window_cross_tier_recovery(tmp_path, accel, port_folds):
    """Dictionary-encoded batches crash on the device tier and resume
    on the host tier."""
    vocab = np.array(["a", "b"])
    crashed = set()  # the crash fires once per package, like ABORT

    def batch(pkg, ids, secs, vals):
        cols = {
            "key_id": np.asarray(ids, dtype=np.int32),
            "ts": _ts(secs),
            "value": np.asarray(vals, dtype=np.float64),
        }
        return pkg["Batch"](cols, key_vocab=vocab)

    def source_of(pkg):
        inputs = pkg["inputs"]

        class _Part(inputs.StatefulSourcePartition):
            def __init__(self, resume):
                self._i = resume or 0
                self._batches = [
                    batch(pkg, [0, 1], [1, 2], [2.0, 5.0]),
                    None,  # the crash
                    batch(pkg, [0, 1], [3, 4], [3.0, 7.0]),
                ]

            def next_batch(self):
                while True:
                    if self._i >= len(self._batches):
                        raise StopIteration()
                    b = self._batches[self._i]
                    self._i += 1
                    if b is not None:
                        return b
                    if pkg["name"] not in crashed:
                        crashed.add(pkg["name"])
                        raise inputs.AbortExecution()

            def snapshot(self):
                return self._i

        class _Source(inputs.FixedPartitionedSource):
            def list_parts(self):
                return ["p0"]

            def build_part(self, step_id, name, resume):
                return _Part(resume)

        return _Source()

    def window(pkg, s):
        return pkg["win"].reduce_window(
            "w", s, _clock(pkg, wait=FAR), _windower(pkg, "tumbling"), pkg["xla"].SUM
        )

    want, got, folds = _abort_run_twice(tmp_path, accel, port_folds, True, False, source_of, window)
    assert [sorted(r["down"]) for r in got] == [sorted(r["down"]) for r in want]
    assert sorted(got[1]["down"]) == [("a", (0, 5.0)), ("b", (0, 12.0))]
    assert got[0]["down"] == [] and folds[0] > 0 and folds[1] == 0


# -- the state's own rules ----------------------------------------------------


def test_key_id_without_vocab_raises_clearly():
    # A key_id column invokes the dictionary convention: a batch with no
    # vocabulary is a clear error, not silently mis-keyed rows.
    for cols in (
        {"key_id": np.array([0]), "ts": _ts([1])},
        {"key_id": np.array([0]), "ts": _ts([1]), "value": np.array([1.0])},
        {"key_id": np.array([0]), "value": np.array([1.0])},
    ):
        want, got = (raised(lambda pkg=pkg: pkg["Batch"](dict(cols)).to_pylist()) for pkg in PKGS)
        assert_same_error(want, got)
        assert isinstance(got, TypeError) and "key_vocab" in str(got)


def _window_state(pkg, kind, ts_getter, wait=timedelta(seconds=5)):
    return pkg["wa"].WindowAccelSpec(
        kind, ts_getter, ALIGN, timedelta(minutes=1), timedelta(minutes=1), wait
    ).make_state()


def test_windowed_vocab_must_extend(accel):
    # An unrelated vocabulary swapped in between batches must raise,
    # not silently remap ids.
    errors = []
    for pkg in PKGS:
        state = _window_state(pkg, "count", lambda x: x)
        ids = np.array([0, 1])
        state.on_batch_columnar(
            pkg["Batch"]({"key_id": ids, "ts": _ts([1, 2])}, key_vocab=np.array(["a", "b"]))
        )
        batch = pkg["Batch"]({"key_id": ids, "ts": _ts([1, 2])}, key_vocab=np.array(["x", "b"]))
        errors.append(raised(lambda state=state, batch=batch: state.on_batch_columnar(batch)))
    assert_same_error(*errors)
    assert isinstance(errors[1], TypeError) and "append-only" in str(errors[1])


def _drained(ingest):
    late, phase = ingest
    closes, _hint = phase()
    return [
        (k, (wid, tag, (v.open_time, v.close_time) if tag == "M" else v))
        for k, (wid, tag, v) in late + closes
    ]


def _native_or_skip():
    from bytewax_tpu_torch.native import is_available

    if not is_available():
        pytest.skip("the native host library does not build here")


def test_itemized_promotion_unit_matches_per_item_path():
    """The native promotion (``on_batch_items``) gives the events of
    the per-item path (``on_batch``), in each package, for both row
    shapes: ``(key, datetime)`` counts and ``(key, TsValue)`` sums."""
    _native_or_skip()
    seen = []
    for pkg in PKGS:
        counts = [("a", _t(s)) for s in (1, 2, 61, 150)] + [("b", _t(5))]
        sums = [
            ("a", pkg["TsValue"](2.0, _t(1))),
            ("a", pkg["TsValue"](3.0, _t(2))),
            ("b", pkg["TsValue"](7.0, _t(61))),
        ]
        got = []
        for kind, getter, rows in (("count", lambda x: x, counts), ("sum", pkg["column_ts"], sums)):
            promo = _window_state(pkg, kind, getter, timedelta(0))
            items = _window_state(pkg, kind, getter, timedelta(0))
            ingest = promo.on_batch_items(list(rows))
            assert ingest is not None
            events = _drained(ingest)
            assert events == _drained(items.on_batch([k for k, _ in rows], [v for _, v in rows]))
            assert [k for k, _s in promo.snapshots_for(["a", "b"])] == ["a", "b"]
            got.append(events)
        seen.append(got)
    assert seen[1] == seen[0]


@pytest.mark.parametrize(
    "getter, row",
    [
        # A ts getter that does not read the row's own timestamp.
        (lambda x: x + timedelta(hours=1), ("a", _t(1))),
        # A timestamp not in UTC: the per-item path's .timestamp()
        # handles any zone, the native promotion must refuse it.
        (lambda x: x, ("a", datetime(2022, 1, 1, 2, 0, 1, tzinfo=timezone(timedelta(hours=2))))),
    ],
    ids=["disagreeing_getter", "non_utc"],
)
def test_itemized_promotion_refuses(getter, row):
    _native_or_skip()
    for pkg in PKGS:
        state = _window_state(pkg, "count", getter, timedelta(0))
        with pytest.raises(pkg["NonNumericValues"]):
            state.on_batch_items([row])


def test_ts_value_degrade_shapes():
    # The {key, ts, value} to_pylist convention: (key, TsValue) pairs
    # whose payload folds as a float and carries .ts, with the batch's
    # fixed-point value_scale applied; they survive pickling.
    seen = []
    for pkg in PKGS:
        batch = pkg["Batch"](
            {
                "key": np.array(["a", "b"]),
                "ts": _ts([1, 2]),
                "value": np.array([25, -5], dtype=np.int16),
            },
            value_scale=0.1,
        )
        items = batch.to_pylist()
        back = pickle.loads(pickle.dumps(items[0][1]))
        assert type(back) is pkg["TsValue"]
        seen.append(
            (
                [k for k, _v in items],
                [float(v) for _k, v in items],
                [pkg["column_ts"](v) for _k, v in items],
                (float(back), back.ts),
            )
        )
    assert seen[1] == seen[0] == (["a", "b"], [2.5, -0.5], [_t(1), _t(2)], (2.5, _t(1)))


# -- flows --------------------------------------------------------------------


def test_count_window_benchmark_shape(accel, port_folds):
    # The reference benchmark's shape: timestamp items, 2 random keys,
    # 1-minute tumbling windows.
    import random

    def window(pkg, s):
        rand = random.Random(7)
        return pkg["win"].count_window(
            "w", s, _clock(pkg, lambda x: x, timedelta(seconds=10)), _windower(pkg, "tumbling"),
            key=lambda _x: str(rand.randrange(2)),
        )

    inp = [_t(i) for i in range(3000)]
    spec, want, got = _run_both(lambda pkg: pkg["Source"](inp, batch_size=256), window)
    assert spec[:2] == ("WindowAccelSpec", "count")
    assert sorted(got["down"]) == sorted(want["down"])
    assert sum(c for _k, (_w, c) in got["down"]) == 3000
    assert port_folds.total > 0


def test_window_accel_late_items(accel, port_folds):
    inp = [(_t(120), "a"), (_t(1), "a")]  # the second lies far behind the watermark

    def window(pkg, s):
        return pkg["win"].count_window(
            "w", s, _clock(pkg, lambda item: item[0], timedelta(seconds=10)),
            _windower(pkg, "tumbling"), key=lambda item: item[1],
        )

    spec, want, got = _run_both(lambda pkg: pkg["Source"](inp), window, ("down", "late"))
    assert got == want
    assert got["late"] == [("a", (0, (_t(1), "a")))]
    assert sum(c for _k, (_wid, c) in got["down"]) == 1
    assert port_folds.total > 0


def test_session_late_values_use_sentinel(accel, port_folds):
    inp = [(_t(100), "a"), (_t(1), "a")]  # far behind the watermark (wait 0)

    def window(pkg, s):
        return pkg["win"].count_window(
            "w", s, _clock(pkg, lambda item: item[0], timedelta(0)),
            pkg["win"].SessionWindower(gap=timedelta(seconds=10)), key=lambda item: item[1],
        )

    spec, want, got = _run_both(
        lambda pkg: pkg["Source"](inp, batch_size=1), window, ("down", "late")
    )
    assert spec[0] == "SessionAccelSpec"
    sentinel = PORT["win"].LATE_SESSION_ID
    assert got["late"] == want["late"] == [("a", (sentinel, (_t(1), "a")))]
    assert port_folds.total > 0


def test_high_cardinality_windowed_count(accel, port_folds):
    # 20,000 keys with open windows: the per-batch due check must stay
    # vectorized (a smoke bound, not a benchmark).
    n_keys, n_batches = 20_000, 5
    keys = np.array([f"key{i:05d}" for i in range(n_keys)])

    def source_of(pkg):
        return pkg["ArraySource"](
            [pkg["Batch"]({"key": keys, "ts": _ts(np.full(n_keys, b))}) for b in range(n_batches)]
        )

    window = lambda pkg, s: pkg["win"].count_window(  # noqa: E731
        "w", s, _clock(pkg, lambda x: x, timedelta(seconds=60)), _windower(pkg, "tumbling"),
        key=lambda x: x,
    )
    flow, out = _flow(PORT, source_of(PORT), window)
    t0 = time.monotonic()
    PORT["run_main"](flow)
    elapsed = time.monotonic() - t0
    ref_flow, ref_out = _flow(REF, source_of(REF), window)
    REF["run_main"](ref_flow)
    assert sorted(out["down"]) == sorted(ref_out["down"])
    assert len(out["down"]) == n_keys
    assert all(c == n_batches for _k, (_w, c) in out["down"])
    assert port_folds.total == n_keys * n_batches
    assert elapsed < 30, f"high-cardinality run too slow: {elapsed:.1f}s"
