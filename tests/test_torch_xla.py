"""The columnar and keyed-aggregation cases of ``tests/test_xla.py``,
each run on the JAX package and on the torch port with the same input
and held to the reference test's expectations in both: ``ArrayBatch``
items, columnar ``reduce_final``, a batch UDF (``xla.jit_batch``, a
torch callable in the port) and its refusal of Python items, the
accelerated count and its host twin, ``min_final`` over strings,
``stats_final``, recovery across tiers, table growth, the host fall-back
for sums past int32, scaled values under string keys, the append-only
vocabulary and a columnar redistribute into the fold.  The port runs on
the CPU."""

from datetime import timedelta

import numpy as np
import pytest

from bytewax_tpu.engine.xla import DeviceAggState as RefAggState
from bytewax_tpu_torch.engine.xla import DeviceAggState as PortAggState
from tests.torch_entry_points import PKGS, PORT, REF, port_on_cpu, recovery_config, unsharded  # noqa: F401

ZERO_TD = timedelta(seconds=0)
AGG_STATES = {REF["name"]: RefAggState, PORT["name"]: PortAggState}


def _each(case, *args):
    """``case(pkg, ...)`` for the JAX package and the port; returns the
    two results."""
    return tuple(case(pkg, *args) for pkg in PKGS)


def _keyed_flow(pkg, source, build, out):
    flow = pkg["Dataflow"]("test_df")
    s = pkg["op"].input("inp", flow, source)
    s = build(s)
    pkg["op"].output("out", s, pkg["Sink"](out))
    return flow


def test_array_batch_to_pylist_kv():
    def case(pkg):
        ab = pkg["Batch"]({"key": np.array(["a", "b"]), "value": np.array([1, 2])})
        return ab.to_pylist(), len(ab)

    want, got = _each(case)
    assert want == ([("a", 1), ("b", 2)], 2)
    assert got == want


def test_columnar_reduce_final_sum():
    def case(pkg):
        batches = [
            pkg["Batch"]({"key": np.array(["a", "b", "a"]), "value": np.array([1.0, 10.0, 2.0])}),
            pkg["Batch"]({"key": np.array(["b"]), "value": np.array([30.0])}),
        ]
        out = []
        build = lambda s: pkg["op"].reduce_final("sum", s, pkg["xla"].SUM)  # noqa: E731
        pkg["run_main"](_keyed_flow(pkg, pkg["ArraySource"](batches), build, out))
        return sorted(out)

    want, got = _each(case)
    assert want == [("a", 3.0), ("b", 40.0)]
    assert got == want


def test_columnar_jax_udf_map():
    """The batch UDF doubles the value column (the string key column
    bypasses it and re-attaches); in the port the UDF is a torch
    callable through the same ``xla.jit_batch``."""

    def case(pkg):
        batches = [pkg["Batch"]({"key": np.array(["a", "a"]), "value": np.array([1.0, 2.0])})]

        @pkg["xla"].jit_batch
        def double(cols):
            return {"value": cols["value"] * 2}

        def build(s):
            s = pkg["op"].flat_map_batch("double", s, double)
            return pkg["op"].reduce_final("sum", s, pkg["xla"].SUM)

        out = []
        pkg["run_main"](_keyed_flow(pkg, pkg["ArraySource"](batches), build, out))
        return out

    want, got = _each(case)
    assert want == [("a", 6.0)]
    assert got == want


def test_jax_udf_rejects_python_items():
    def case(pkg):
        @pkg["xla"].jit_batch
        def ident(cols):
            return cols

        build = lambda s: pkg["op"].flat_map_batch("bad", s, ident)  # noqa: E731
        flow = _keyed_flow(pkg, pkg["Source"]([1, 2]), build, [])
        with pytest.raises(TypeError, match="ArrayBatch") as info:
            pkg["run_main"](flow)
        return info.value

    want, got = _each(case)
    assert type(got).__name__ == type(want).__name__


def test_accelerated_count_matches_host(monkeypatch):
    inp = ["apple", "banana", "apple", "banana", "banana"]

    def case(pkg, accel):
        monkeypatch.setenv("BYTEWAX_TPU_ACCEL", accel)
        out = []
        build = lambda s: pkg["op"].count_final("count", s, lambda x: x)  # noqa: E731
        pkg["run_main"](_keyed_flow(pkg, pkg["Source"](inp), build, out))
        return sorted(out)

    for accel in ("1", "0"):
        want, got = _each(case, accel)
        assert want == [("apple", 2), ("banana", 3)]
        assert got == want


def test_accelerated_min_max_fallback_non_numeric(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")

    def case(pkg):
        out = []
        build = lambda s: pkg["op"].min_final("min", s)  # noqa: E731
        pkg["run_main"](_keyed_flow(pkg, pkg["Source"]([("k", "zebra"), ("k", "ant")]), build, out))
        return out

    want, got = _each(case)
    assert want == [("k", "ant")]
    assert got == want


def test_stats_final():
    def case(pkg):
        out = []
        inp = [("k", 1.0), ("k", 2.0), ("k", 9.0), ("j", 5.0)]
        build = lambda s: pkg["xla"].stats_final("stats", s)  # noqa: E731
        pkg["run_main"](_keyed_flow(pkg, pkg["Source"](inp), build, out))
        return sorted(out)

    want, got = _each(case)
    assert want == [("j", (5.0, 5.0, 5.0, 1)), ("k", (1.0, 4.0, 9.0, 3))]
    assert got == want


def test_accelerated_recovery_cross_tier(tmp_path, monkeypatch):
    """A crash mid-stream on the device tier resumes on the host tier
    from its snapshots."""

    def case(pkg):
        rc = recovery_config(pkg, tmp_path / pkg["name"])
        inp = [("a", 5), ("a", 3), pkg["Source"].ABORT(), ("a", 40)]
        out = []
        flow = _keyed_flow(pkg, pkg["Source"](inp), lambda s: pkg["op"].max_final("max", s), out)
        monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")
        pkg["run_main"](flow, epoch_interval=ZERO_TD, recovery_config=rc)
        first = list(out)
        monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "0")
        pkg["run_main"](flow, epoch_interval=ZERO_TD, recovery_config=rc)
        return first, out

    want, got = _each(case)
    assert want == ([], [("a", 40)])
    assert got == want


def test_device_agg_state_growth():
    """5,000 keys, past the first table, folded twice."""

    def case(pkg):
        agg = AGG_STATES[pkg["name"]]("sum")
        n = 5000
        keys = np.array([f"k{i:05d}" for i in range(n)])
        values = np.ones(n, dtype=np.float32)
        agg.update(keys, values)
        agg.update(keys, values)
        return dict(agg.finalize())

    want, got = _each(case)
    assert len(want) == 5000 and want["k00000"] == 2.0 and want["k04999"] == 2.0
    assert got == want


def test_int64_overflow_falls_back_to_host():
    big = 1 << 40

    def case(pkg):
        out = []
        build = lambda s: pkg["op"].reduce_final("sum", s, pkg["xla"].SUM)  # noqa: E731
        pkg["run_main"](_keyed_flow(pkg, pkg["Source"]([("k", big), ("k", big)]), build, out))
        return out

    want, got = _each(case)
    assert want == [("k", 2 * big)]  # exact, through the host fall-back
    assert got == want


def test_value_scale_string_key_path():
    def case(pkg):
        ab = pkg["Batch"]({"key": np.array(["a", "a"]), "value": np.array([15, 23], np.int16)}, value_scale=0.1)
        agg = AGG_STATES[pkg["name"]]("sum")
        agg.update_batch(ab)
        return dict(agg.finalize())["a"], ab.to_pylist()[0]

    (want_sum, want_item), (got_sum, got_item) = _each(case)
    assert abs(want_sum - 3.8) < 1e-5 and abs(got_sum - 3.8) < 1e-5
    assert abs(got_sum - want_sum) <= 1e-5
    assert want_item == ("a", 1.5)
    assert got_item == want_item


def test_vocab_must_be_append_only():
    def case(pkg):
        agg = AGG_STATES[pkg["name"]]("sum")

        def batch(vocab):
            return pkg["Batch"](
                {"key_id": np.array([0], np.int16), "value": np.array([1.0])}, key_vocab=np.array(vocab)
            )

        agg.update_batch(batch(["london", "paris"]))
        with pytest.raises(TypeError, match="append-only") as info:
            agg.update_batch(batch(["paris", "london"]))  # reordered
        return str(info.value).replace(pkg["name"], "bytewax_tpu")

    want, got = _each(case)
    assert got == want


def test_redistributed_columnar_batch_reaches_accel(monkeypatch):
    """Strided per-lane column views from a columnar redistribute still
    run the keyed fold on two lanes."""
    monkeypatch.setenv("BYTEWAX_TPU_ACCEL", "1")

    def case(pkg):
        keys = np.array([f"k{i % 3}" for i in range(300)])
        batch = pkg["Batch"]({"key": keys, "value": np.ones(300)})

        def build(s):
            s = pkg["op"].redistribute("shuffle", s)
            return pkg["op"].reduce_final("sum", s, pkg["xla"].SUM)

        out = []
        pkg["cluster_main"](_keyed_flow(pkg, pkg["ArraySource"]([batch]), build, out), [], 0, worker_count_per_proc=2)
        return sorted(out)

    want, got = _each(case)
    assert want == [("k0", 100.0), ("k1", 100.0), ("k2", 100.0)]
    assert got == want
