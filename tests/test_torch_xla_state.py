"""The torch port's ``DeviceAggState`` against the JAX package's.

Both states take the same rows, made with numpy from a seed, through
the same methods; their finals, snapshots and errors must agree:
exactly for integer state, counts, min and max, and to
``rtol=atol=1e-5`` for float32 sums.
"""

import os

import numpy as np
import pytest
import torch

from bytewax_tpu.engine.arrays import ArrayBatch as RefBatch
from bytewax_tpu.engine.xla import DeviceAggState as RefState
from bytewax_tpu.engine.xla import NonNumericValues as RefNonNumeric
from bytewax_tpu_torch.engine.arrays import ArrayBatch
from bytewax_tpu_torch.engine.xla import (
    DeviceAggState,
    NonNumericValues,
    load_fields,
)
from bytewax_tpu_torch.utils import force_platform

KINDS = ["count", "max", "mean", "min", "stats", "sum"]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    saved = os.environ.get("BYTEWAX_TPU_PLATFORM")
    force_platform("cpu")
    yield
    if saved is None:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    else:
        os.environ["BYTEWAX_TPU_PLATFORM"] = saved


def _close(g, w):
    if isinstance(w, int) and not isinstance(w, bool):
        return g == w and isinstance(g, int)
    return abs(g - w) <= 1e-5 + 1e-5 * abs(w)


def _exact_fields(kind: str):
    """Which positions of a kind's final value are exact (min, max,
    count) and which are float sums (sum, mean)."""
    return {
        "count": (True,),
        "min": (True,),
        "max": (True,),
        "sum": (False,),
        "mean": (False,),
        "stats": (True, False, True, True),
    }[kind]


def assert_same_finals(kind: str, got, want, exact_all: bool = False):
    assert [k for k, _ in got] == [k for k, _ in want]
    exact = _exact_fields(kind)
    for (key, g), (_, w) in zip(got, want):
        gs = g if isinstance(g, tuple) else (g,)
        ws = w if isinstance(w, tuple) else (w,)
        assert len(gs) == len(ws), key
        for i, (gv, wv) in enumerate(zip(gs, ws)):
            if exact[i] or exact_all:
                assert gv == wv and type(gv) is type(wv), (key, g, w)
            else:
                assert _close(gv, wv), (key, g, w)


def _rows(rng, n: int, n_keys: int, integer: bool):
    keys = np.array([f"k{i:03d}" for i in rng.randint(0, n_keys, size=n)])
    if integer:
        return keys, rng.randint(-1000, 1000, size=n).astype(np.int64)
    return keys, (rng.randn(n) * 30).astype(np.float64)


def _pair(kind: str):
    return DeviceAggState(kind, device=CPU), RefState(kind)


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("kind", KINDS)
def test_update_matches_reference(kind, integer):
    port, ref = _pair(kind)
    rng = np.random.RandomState(1)
    for _ in range(3):
        keys, vals = _rows(rng, 500, 50, integer)
        assert sorted(port.update(keys, vals)) == sorted(ref.update(keys, vals))
    assert port.dtype == (torch.int32 if integer else torch.float32)
    assert_same_finals(kind, port.finalize(), ref.finalize(), exact_all=integer)
    assert port.finalize() == [] and ref.finalize() == []


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("kind", KINDS)
def test_update_items_matches_reference(kind, integer):
    port, ref = _pair(kind)
    rng = np.random.RandomState(2)
    for _ in range(3):
        keys, vals = _rows(rng, 400, 40, integer)
        items = list(zip(keys.tolist(), vals.tolist()))
        assert port.update_items(items) == ref.update_items(items)
    assert_same_finals(kind, port.finalize(), ref.finalize(), exact_all=integer)


def _batches(cls, mode: str, rng, n_stations: int = 60):
    vocab = np.array([f"st{i:03d}" for i in range(n_stations)])
    out = []
    for _ in range(3):
        n = 700
        ids = rng.randint(0, n_stations, size=n).astype(np.int16)
        deci = rng.randint(-999, 1000, size=n).astype(np.int16)
        if mode == "packed":
            out.append(
                cls({"key_id": ids, "value": deci}, key_vocab=vocab, value_scale=0.1)
            )
        elif mode == "vocab":
            out.append(
                cls(
                    {"key_id": ids, "value": deci.astype(np.float32) * 0.5},
                    key_vocab=vocab,
                )
            )
        else:
            out.append(
                cls({"key": vocab[ids], "value": deci.astype(np.float64) * 0.25})
            )
    return out


@pytest.mark.parametrize("mode", ["packed", "vocab", "key"])
@pytest.mark.parametrize("kind", ["stats", "sum", "count"])
def test_update_batch_matches_reference(kind, mode):
    port, ref = _pair(kind)
    for pb, rb in zip(
        _batches(ArrayBatch, mode, np.random.RandomState(3)),
        _batches(RefBatch, mode, np.random.RandomState(3)),
    ):
        assert sorted(port.update_batch(pb)) == sorted(ref.update_batch(rb))
    assert_same_finals(kind, port.finalize(), ref.finalize())


def test_growth_past_the_first_table():
    port, ref = _pair("stats")
    n = 1500  # more keys than the first 1024-slot table holds
    keys = np.array([f"k{i:05d}" for i in range(n)])
    vals = np.arange(n, dtype=np.float32)
    for _ in range(2):
        port.update(keys, vals)
        ref.update(keys, vals)
    assert port.capacity == ref.capacity == 2048
    # The old scratch slot (1023) became a real slot and was cleared.
    assert_same_finals("stats", port.finalize(), ref.finalize())


def test_discard_then_reallocate():
    port, ref = _pair("sum")
    rng = np.random.RandomState(4)
    keys, vals = _rows(rng, 300, 30, integer=False)
    for st in (port, ref):
        st.update(keys, vals)
        for k in ("k001", "k002", "k003"):
            st.discard(k)
    before = len(port.slot_keys)
    new_keys = np.array(["new_a", "new_b", "k002"] * 10)
    new_vals = np.linspace(-3, 3, 30)
    port.update(new_keys, new_vals)
    ref.update(new_keys, new_vals)
    assert len(port.slot_keys) == before  # freed slots were reused
    assert sorted(port.keys()) == sorted(ref.keys())
    assert_same_finals("sum", port.finalize(), ref.finalize())


@pytest.mark.parametrize("kind", KINDS)
def test_snapshots_for_match_reference(kind):
    port, ref = _pair(kind)
    rng = np.random.RandomState(5)
    keys, vals = _rows(rng, 400, 20, integer=False)
    port.update(keys, vals)
    ref.update(keys, vals)
    ask = ["k000", "k007", "missing", "k019"]
    got, want = port.snapshots_for(ask), ref.snapshots_for(ask)
    assert [k for k, _ in got] == ask
    for (_, g), (_, w) in zip(got, want):
        if w is None:
            assert g is None
            continue
        gs = g if isinstance(g, tuple) else (g,)
        ws = w if isinstance(w, tuple) else (w,)
        assert all(_close(a, b) for a, b in zip(gs, ws)), (g, w)
    assert port.demotion_snapshots() == port.snapshots_for(port.keys())


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("kind", ["stats", "sum", "min"])
def test_load_fields_carries_reference_state(kind, integer):
    rng = np.random.RandomState(6)
    ref = RefState(kind)
    keys, vals = _rows(rng, 500, 40, integer)
    ref.update(keys, vals)
    ref.discard("k005")  # a freed slot travels as None
    fields = {name: np.asarray(arr) for name, arr in ref._fields.items()}
    port = load_fields(kind, fields, ref.slot_keys, CPU)
    assert port.dtype == (torch.int32 if integer else torch.float32)
    assert sorted(port.keys()) == sorted(ref.keys())
    for _ in range(2):
        keys, vals = _rows(rng, 500, 45, integer)
        port.update(keys, vals)
        ref.update(keys, vals)
    assert_same_finals(kind, port.finalize(), ref.finalize(), exact_all=integer)


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("kind", ["stats", "mean", "count", "max"])
def test_load_many_carries_reference_snapshots(kind, integer):
    # The cross-tier resume contract: the port resumes from the JAX
    # package's snapshots and then folds like a JAX state resumed from
    # the same snapshots (exactly, types included), and like the state
    # that never stopped (in value).
    rng = np.random.RandomState(7)

    def rows(n_keys):
        keys, vals = _rows(rng, 500, n_keys, integer)
        if kind == "count":  # count_final folds ones
            vals = np.ones_like(vals)
        return keys, vals

    ref = RefState(kind)
    ref.update(*rows(40))
    snaps = ref.snapshots_for(ref.keys())
    port = DeviceAggState(kind, device=CPU)
    port.load_many(snaps)
    resumed = RefState(kind)
    resumed.load_many(snaps)
    for _ in range(2):
        keys, vals = rows(45)
        for st in (port, ref, resumed):
            st.update(keys, vals)
    got = port.finalize()
    assert_same_finals(kind, got, resumed.finalize(), exact_all=integer)
    want = ref.finalize()
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        gs = g if isinstance(g, tuple) else (g,)
        ws = w if isinstance(w, tuple) else (w,)
        assert all(_close(float(a), float(b)) for a, b in zip(gs, ws)), (g, w)


def test_wide_integers_raise_non_numeric():
    keys = np.array(["a", "b"])
    vals = np.array([1, 2**40], dtype=np.int64)
    with pytest.raises(RefNonNumeric):
        RefState("sum").update(keys, vals)
    port = DeviceAggState("sum", device=CPU)
    with pytest.raises(NonNumericValues):
        port.update(keys, vals)
    assert port.finalize() == []


def test_float_after_int_lock_raises():
    keys = np.array(["a", "b"])
    port, ref = _pair("sum")
    for st in (port, ref):
        st.update(keys, np.array([1, 2], dtype=np.int64))
    floats = np.array([0.5, 1.0])
    with pytest.raises(TypeError, match="locked"):
        ref.update(keys, floats)
    with pytest.raises(TypeError, match="locked"):
        port.update(keys, floats)
    # Integral floats still fold into the int32 state.
    port.update(keys, np.array([3.0, 4.0]))
    ref.update(keys, np.array([3.0, 4.0]))
    assert port.finalize() == ref.finalize() == [("a", 4), ("b", 6)]


def test_state_tensors_live_on_the_state_device():
    port = DeviceAggState("stats")  # device from BYTEWAX_TPU_PLATFORM=cpu
    assert port.device == CPU
    port.update(np.array(["a"]), np.array([1.0]))
    assert all(t.device == CPU for t in port._fields.values())
    assert port._fields["min"].dtype == torch.float32


def test_quantized_batch_with_a_wide_vocab_dequantizes():
    # A vocabulary past 2^15 ids cannot ride the int16 packed transfer;
    # its fixed-point values still fold scaled (held to a float64
    # oracle: the JAX package folds them unscaled on this path).
    n_stations = 40_000
    vocab = np.array([f"s{i}" for i in range(n_stations)])
    rng = np.random.RandomState(8)
    ids = rng.randint(0, n_stations, size=5000).astype(np.int32)
    deci = rng.randint(-999, 1000, size=5000).astype(np.int16)
    port = DeviceAggState("stats", device=CPU)
    port.update_batch(
        ArrayBatch({"key_id": ids, "value": deci}, key_vocab=vocab, value_scale=0.1)
    )
    got = dict(port.finalize())
    for i in np.unique(ids)[:50].tolist():
        q = deci[ids == i].astype(np.float64)
        mn, mean, mx, count = got[f"s{i}"]
        assert count == len(q)
        assert mn == pytest.approx(q.min() * 0.1, abs=1e-5)
        assert mx == pytest.approx(q.max() * 0.1, abs=1e-5)
        assert mean == pytest.approx(q.mean() * 0.1, abs=1e-4)
