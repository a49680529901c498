"""The columnar wire codec, the route accumulator, the vocab session
and the quantized aggregate codec (``engine/wire.py``) of the torch
port, held against the JAX package: every case of
``tests/test_wire.py``.

Frames cross packages both ways: each message is encoded by both
packages, the frames must be byte for byte the same, and each
package's frame is decoded by both (a port's ``ArrayBatch`` from a JAX
frame and back).  The agg-codec frames of ``encode_agg`` cross the
same way, and their quantization bounds hold for both.  Exact
everywhere: the codec moves bytes, it computes nothing but the
quantization, which both packages do in numpy alike.
"""

import numpy as np
import pytest

from tests.test_torch_both import (  # noqa: F401
    BOTH,
    JAX,
    TORCH,
    ZERO_TD,
    both,
    fresh_faults,
    port_on_cpu,
    unsharded,
)


@pytest.fixture(autouse=True)
def _fresh_wire_mode(monkeypatch):
    monkeypatch.delenv("BYTEWAX_TPU_WIRE", raising=False)
    monkeypatch.delenv("BYTEWAX_TPU_GSYNC_QUANT", raising=False)
    for m in BOTH:
        m.wire.reconfigure()
    yield
    for m in BOTH:
        m.wire.reconfigure()


def _batches_equal(a, b) -> None:
    assert set(a.cols) == set(b.cols)
    for name in a.cols:
        x, y = np.asarray(a.cols[name]), np.asarray(b.cols[name])
        assert x.dtype == y.dtype, name
        assert np.array_equal(x, y), name
    if a.key_vocab is None:
        assert b.key_vocab is None
    elif isinstance(a.key_vocab, np.ndarray):
        assert np.array_equal(np.asarray(a.key_vocab), np.asarray(b.key_vocab))
        assert np.asarray(a.key_vocab).dtype == np.asarray(b.key_vocab).dtype
    else:
        assert b.key_vocab == a.key_vocab
    assert a.value_scale == b.value_scale


def _crossed(make):
    """Encodes ``make(m)`` with each package (the frames must be equal
    byte for byte) and decodes the frame with each package; returns
    the frame and ``[(decoder, message), ...]``."""
    frames = [m.wire.encode(make(m)) for m in BOTH]
    assert frames[0] == frames[1]
    return frames[1], [(m, m.wire.decode(f)) for f in frames for m in BOTH]


# -- codec round trips: every ingest-tier column dtype ------------------

COLS = [
    np.arange(64, dtype=np.int64),
    np.arange(64, dtype=np.int32),
    np.arange(64, dtype=np.uint16),
    np.linspace(0.0, 1.0, 64, dtype=np.float64),
    np.linspace(0.0, 1.0, 64, dtype=np.float32),
    np.arange(64, dtype=np.int16),
    (np.arange(64) % 2).astype(bool),
    np.datetime64("2022-01-01", "us") + np.arange(64).astype("timedelta64[s]"),
    (1_640_995_200_000_000 + np.arange(64) * 1_000_000).astype(np.int64),
    (1_640_995_200_000_000 + np.arange(64) * 1_000_000).astype(np.float64),
    np.timedelta64(1, "ms") * np.arange(64),
]
IDS = ["i8", "i4", "u2", "f8", "f4", "i2", "bool", "dt64us", "ts-us-int",
       "ts-us-float", "td64"]


@pytest.mark.parametrize("col", COLS, ids=IDS)
def test_roundtrip_every_ingest_dtype(col):
    def make(m):
        return ("route", "flow.s", (3, m.ArrayBatch({
            "key_id": np.arange(64, dtype=np.int32), "value": col})))

    data, outs = _crossed(make)
    assert data[:1] != b"\x80"
    want = make(TORCH)[2][1]
    for m, (kind, sid, (w, got)) in outs:
        assert (kind, sid, w) == ("route", "flow.s", 3)
        assert isinstance(got, m.ArrayBatch)
        _batches_equal(want, got)


def test_roundtrip_bytes_columns_with_trailing_nuls():
    keys = np.array([b"a\x00b", b"\x00", b"c", b""], dtype="S5")
    vals = np.array([b"x\x00\x00", b"yy", b"\x00z", b"w"], dtype="S3")

    def make(m):
        return ("deliver", 2, "up", (1, m.ArrayBatch({"key": keys, "value": vals})))

    _data, outs = _crossed(make)
    for _m, (kind, op_idx, port, (w, got)) in outs:
        assert (kind, op_idx, port, w) == ("deliver", 2, "up", 1)
        _batches_equal(make(TORCH)[3][1], got)
        assert got.cols["key"].dtype == np.dtype("S5")
        assert got.cols["key"].tobytes() == keys.tobytes()


def test_roundtrip_unicode_keys_vocab_and_scale():
    vocab = np.array(["alpha", "beta", "gamma"])

    def make(m):
        return ("deliver", 5, "up", (7, m.ArrayBatch(
            {
                "key_id": np.array([0, 2, 1, 0], dtype=np.int32),
                "ts": np.datetime64("2024-06-01", "us")
                + np.arange(4).astype("timedelta64[ms]"),
                "value": np.array([10, 20, 30, 40], dtype=np.int16),
            },
            key_vocab=vocab,
            value_scale=0.1,
        )))

    _data, outs = _crossed(make)
    for m, out in outs:
        _batches_equal(make(m)[3][1], out[3][1])
        assert out[3][1].to_pylist() == make(JAX)[3][1].to_pylist()


def test_decode_is_zero_copy_for_raw_columns():
    for m in BOTH:
        batch = m.ArrayBatch({"value": np.arange(1024, dtype=np.float64)})
        data = m.wire.encode(("route", "s", (0, batch)))
        for dec in BOTH:
            got = dec.wire.decode(data)[2][1].cols["value"]
            assert got.flags.writeable is False
            assert got.base is not None


def test_object_columns_fall_back_per_column():
    payloads = np.array([{"a": 1}, {"b": 2}], dtype=object)

    def make(m):
        return ("route", "s", (1, m.ArrayBatch({"key": np.array(["x", "y"]),
                                                "value": payloads})))

    data, outs = _crossed(make)
    assert data[:4] == b"\xb5BXW"
    for _m, out in outs:
        got = out[2][1]
        assert np.array_equal(np.asarray(got.cols["key"]), np.array(["x", "y"]))
        assert got.cols["value"].dtype == object
        assert list(got.cols["value"]) == [{"a": 1}, {"b": 2}]


def test_list_vocab_and_nonbatch_payloads_fall_back():
    def make(m):
        return ("route", "s", (0, m.ArrayBatch(
            {"key_id": np.array([0, 1], dtype=np.int32)}, key_vocab=["k0", "k1"])))

    _data, outs = _crossed(make)
    for _m, out in outs:
        assert out[2][1].key_vocab == ["k0", "k1"]
    for msg in (
        ("gsync", 3, 1, {"stop": False}),
        ("route", "s", (1, [("k", 1.0), ("k2", 2.0)])),
        ("close_epoch", 9, False),
        ("__bytewax_tpu_hb__",),
    ):
        data, outs = _crossed(lambda m: msg)
        assert data[:1] == b"\x80"
        assert all(out == msg for _m, out in outs)


def test_pickle_mode_disables_columnar(monkeypatch):
    monkeypatch.setenv("BYTEWAX_TPU_WIRE", "pickle")
    for m in BOTH:
        m.wire.reconfigure()
        assert m.wire.wire_mode() == "pickle"
        batch = m.ArrayBatch({"value": np.arange(8.0)})
        data = m.wire.encode(("route", "s", (0, batch)))
        assert data[:1] == b"\x80"
        got = m.wire.decode(data)[2][1]
        assert np.array_equal(got.cols["value"], batch.cols["value"])


def _typed_error(m, fn):
    with pytest.raises(m.errors.WireFormatError) as info:
        fn()
    return str(info.value)


def test_unknown_version_raises_typed():
    def case(m):
        batch = m.ArrayBatch({"value": np.arange(4.0)})
        data = bytearray(m.wire.encode(("route", "s", (0, batch))))
        assert data[:4] == b"\xb5BXW"
        data[4] = 99
        msg = _typed_error(m, lambda: m.wire.decode(bytes(data)))
        assert "version 99" in msg
        return msg

    want, got = both(case)
    assert got == want


def test_truncated_frame_raises_typed():
    def case(m):
        batch = m.ArrayBatch({"value": np.arange(64.0)})
        data = m.wire.encode(("route", "s", (0, batch)))
        msg = _typed_error(m, lambda: m.wire.decode(data[: len(data) - 16]))
        assert "truncated" in msg
        return msg

    want, got = both(case)
    assert got == want


def test_property_random_numeric_roundtrips():
    rng = np.random.RandomState(7)
    dtypes = [np.int64, np.int32, np.float64, np.float32, np.uint8]
    for trial in range(25):
        n = int(rng.randint(1, 200))
        cols = {
            "key_id": rng.randint(0, 16, size=n).astype(np.int32),
            "value": rng.randint(0, 1000, size=n).astype(dtypes[trial % len(dtypes)]),
        }
        if trial % 2:
            cols["ts"] = np.datetime64("2023-01-01", "us") + rng.randint(
                0, 10**9, size=n
            ).astype("timedelta64[us]")
        vocab = None
        if trial % 3 == 0:
            vocab = np.array([f"key-{i}" for i in range(16)], dtype="S8")
        scale = 0.5 if trial % 5 == 0 else None

        def make(m):
            return ("route", f"s{trial}", (trial, m.ArrayBatch(
                cols, key_vocab=vocab, value_scale=scale)))

        _data, outs = _crossed(make)
        for m, out in outs:
            assert out[1] == f"s{trial}" and out[2][0] == trial
            _batches_equal(make(m)[2][1], out[2][1])


def test_strided_view_columns_encode_contiguous():
    base = np.arange(100, dtype=np.float64)
    _data, outs = _crossed(
        lambda m: ("route", "s", (0, m.ArrayBatch({"value": base[1::3]})))
    )
    for _m, out in outs:
        assert np.array_equal(out[2][1].cols["value"], base[1::3])


# -- the route accumulator ---------------------------------------------


def _vb(m, keys, vals, vocab=None, scale=None):
    return m.ArrayBatch(
        {
            "key_id": np.asarray(keys, dtype=np.int32),
            "value": np.asarray(vals, dtype=np.float64),
        },
        key_vocab=vocab,
        value_scale=scale,
    )


def _drain(acc):
    frames = []
    while acc.pending():
        frames.append(acc.peek())
        acc.pop()
    return frames


def _view(frames):
    """Frames as plain values: keys, row counts, values and scales."""
    out = []
    for key, items in frames:
        if isinstance(items, list):
            out.append((key, items))
        else:
            out.append((key, len(items), items.cols["value"].tolist(), items.value_scale))
    return out


def test_accumulator_merges_compatible_runs():
    def case(m):
        acc = m.wire.RouteAccumulator()
        vocab = np.array(["a", "b"])
        for k, v in ((0, 1.0), (1, 2.0), (0, 3.0)):
            acc.add(1, "s", 4, _vb(m, [k], [v], vocab))
        frames = _drain(acc)
        assert not acc.pending()
        return _view(frames)

    want, got = both(case)
    assert got == want == [(("route", 1, "s", 4), 3, [1.0, 2.0, 3.0], None)]


def test_accumulator_keeps_incompatible_slices_apart():
    def case(m):
        acc = m.wire.RouteAccumulator()
        acc.add(1, "s", 4, _vb(m, [0], [1.0]))
        acc.add(1, "s", 4, _vb(m, [0], [2.0], scale=0.1))
        acc.add(1, "s", 5, _vb(m, [0], [3.0]))
        acc.add(2, "s", 4, _vb(m, [0], [4.0]))
        return _view(_drain(acc))

    want, got = both(case)
    assert got == want
    assert [(f[0][1], f[0][3]) for f in got] == [(1, 4), (1, 4), (1, 5), (2, 4)]
    assert got[0][3] is None and got[1][3] == 0.1


def test_accumulator_merges_item_lists_too():
    def case(m):
        acc = m.wire.RouteAccumulator()
        acc.add(0, "s", 1, [("k", 1)])
        acc.add(0, "s", 1, [("k", 2), ("j", 3)])
        items = acc.peek()[1]
        acc.pop()
        return items, acc.peek()

    want, got = both(case)
    assert got == want == ([("k", 1), ("k", 2), ("j", 3)], None)


def test_accumulator_peek_is_stable_until_pop():
    for m in BOTH:
        acc = m.wire.RouteAccumulator()
        acc.add(1, "s", 4, _vb(m, [0], [1.0]))
        first = acc.peek()
        assert acc.peek() is first
        assert acc.pending()
        acc.pop()
        assert not acc.pending() and acc.peek() is None


def test_accumulator_add_after_peek_invalidates_head():
    def case(m):
        acc = m.wire.RouteAccumulator()
        acc.add(1, "s", 4, _vb(m, [0], [1.0]))
        before = len(acc.peek()[1])
        acc.add(1, "s", 4, _vb(m, [1], [2.0]))
        return before, len(acc.peek()[1])

    want, got = both(case)
    assert got == want == (1, 2)


def test_accumulator_deliver_buckets_coalesce_apart_from_route():
    def case(m):
        acc = m.wire.RouteAccumulator()
        acc.add_deliver(1, 7, "up", 3, _vb(m, [0], [1.0]))
        acc.add(1, "s", 3, _vb(m, [0], [2.0]))
        acc.add_deliver(1, 7, "up", 3, _vb(m, [1], [3.0]))
        acc.add_deliver(1, 8, "up", 3, _vb(m, [1], [4.0]))
        return _view(_drain(acc))

    want, got = both(case)
    assert got == want
    assert [f[0] for f in got] == [
        ("deliver", 1, 7, "up", 3),
        ("route", 1, "s", 3),
        ("deliver", 1, 8, "up", 3),
    ]
    assert got[0][2] == [1.0, 3.0]


# -- the vocab/schema session cache -------------------------------------


@pytest.mark.parametrize("tx_pkg,rx_pkg", [(JAX, TORCH), (TORCH, JAX), (TORCH, TORCH)],
                         ids=repr)
def test_vocab_session_ships_once_then_refs(tx_pkg, rx_pkg):
    tx, rx = tx_pkg.wire.WireSession(), rx_pkg.wire.WireSession()
    vocab = np.array([f"key-{i:04d}" for i in range(512)])
    d1 = tx_pkg.wire.encode(("route", "s", (1, _vb(tx_pkg, [0, 1], [1.0, 2.0], vocab))), tx, 9)
    d2 = tx_pkg.wire.encode(("route", "s", (1, _vb(tx_pkg, [2, 3], [3.0, 4.0], vocab))), tx, 9)
    assert len(d2) < len(d1) - len(vocab.tobytes()) // 2
    got1 = rx_pkg.wire.decode(d1, rx, 9)[2][1]
    got2 = rx_pkg.wire.decode(d2, rx, 9)[2][1]
    assert np.array_equal(np.asarray(got1.key_vocab), vocab)
    assert np.array_equal(np.asarray(got2.key_vocab), vocab)
    assert got2.key_vocab is got1.key_vocab


def test_vocab_session_invalidates_on_growth_and_scopes_streams():
    def case(m):
        tx, rx = m.wire.WireSession(), m.wire.WireSession()
        vocab = ["a", "b"]
        d1 = m.wire.encode(("route", "s", (0, _vb(m, [0], [1.0], vocab))), tx, 3)
        vocab.append("c")
        d2 = m.wire.encode(("route", "s", (0, _vb(m, [2], [2.0], vocab))), tx, 3)
        d3 = m.wire.encode(("route", "t", (0, _vb(m, [0], [3.0], vocab))), tx, 3)
        got = [m.wire.decode(d, rx, 3)[2][1].key_vocab for d in (d1, d2, d3)]
        return [d1, d2, d3], got

    want, got = both(case)
    assert got == want
    assert got[1] == [["a", "b"], ["a", "b", "c"], ["a", "b", "c"]]


def test_vocab_ref_without_defining_frame_raises_typed():
    def case(m):
        tx = m.wire.WireSession()
        vocab = np.array(["a", "b"])
        m.wire.encode(("route", "s", (0, _vb(m, [0], [1.0], vocab))), tx, 1)
        ref = m.wire.encode(("route", "s", (1, _vb(m, [1], [2.0], vocab))), tx, 1)
        fresh = _typed_error(m, lambda: m.wire.decode(ref, m.wire.WireSession(), 1))
        none = _typed_error(m, lambda: m.wire.decode(ref))
        assert "generation" in fresh and "session" in none
        return fresh, none

    want, got = both(case)
    assert got == want


def test_vocab_session_not_armed_without_session():
    def case(m):
        vocab = np.array(["a", "b"])
        d1 = m.wire.encode(("route", "s", (0, _vb(m, [0], [1.0], vocab))))
        d2 = m.wire.encode(("route", "s", (1, _vb(m, [1], [2.0], vocab))))
        assert abs(len(d1) - len(d2)) <= 8
        assert m.wire.decode(d2)[2][1].key_vocab is not None
        return d1, d2

    want, got = both(case)
    assert got == want


# -- the quantized gsync aggregate codec --------------------------------


def _partial_cols(n=2000, seed=11):
    rng = np.random.RandomState(seed)
    return {
        "key": np.array([f"k{i:05d}" for i in range(n)]),
        "min": rng.randn(n) * 100.0,
        "max": rng.randn(n) * 100.0 + 500.0,
        "sum": rng.randn(n) * 1e4,
        "count": rng.randint(1, 1000, size=n).astype(np.int64),
    }


def _decode_all(m, frames):
    dec = {}
    for frame in frames:
        for name, arr in m.wire.decode_agg(frame).items():
            dec.setdefault(name, []).append(arr)
    return {k: np.concatenate(v) for k, v in dec.items()}


@pytest.mark.parametrize("quant", ["off", "bf16", "int8"])
def test_agg_codec_roundtrip_bounds(quant):
    cols = _partial_cols()
    frames = {m.label: m.wire.encode_agg(cols, quant) for m in BOTH}
    assert frames["jax"] == frames["torch"]
    for enc in BOTH:
        for m in BOTH:
            dec = _decode_all(m, frames[enc.label])
            assert np.array_equal(dec["key"], cols["key"])
            assert dec["count"].dtype.kind == "i"
            assert np.array_equal(dec["count"], cols["count"])
            for name in ("min", "max", "sum"):
                orig, got = cols[name], dec[name]
                if quant == "off":
                    assert np.array_equal(got, orig)
                elif quant == "int8":
                    nb = -(-len(orig) // 1024)
                    padded = np.zeros(nb * 1024)
                    padded[: len(orig)] = orig
                    bound = np.repeat(
                        np.abs(padded.reshape(nb, 1024)).max(axis=1) / 254.0, 1024
                    )[: len(orig)]
                    assert np.all(np.abs(got - orig) <= bound + 1e-9), name
                else:
                    denom = np.maximum(np.abs(orig), 1e-30)
                    assert np.all(np.abs(got - orig) / denom <= 2.0**-8), name


def test_agg_codec_all_int_columns_exact_under_int8():
    cols = {
        "key": np.array(["a", "b", "c"]),
        "sum": np.array([10**12, -(10**12), 7], dtype=np.int64),
        "count": np.array([3, 4, 5], dtype=np.int64),
    }
    frames = [m.wire.encode_agg(cols, "int8") for m in BOTH]
    assert frames[0] == frames[1]
    for m in BOTH:
        (frame,) = frames[0]
        dec = m.wire.decode_agg(frame)
        assert np.array_equal(dec["sum"], cols["sum"])
        assert np.array_equal(dec["count"], cols["count"])


def test_agg_codec_int8_shrinks_floats():
    cols = _partial_cols(n=8192)

    def case(m):
        return [sum(len(f) for f in m.wire.encode_agg(cols, q)) for q in ("off", "int8", "bf16")]

    want, got = both(case)
    assert got == want
    exact, int8, bf16 = got
    assert int8 <= 0.5 * exact
    assert bf16 < exact


def test_agg_codec_chunks_oversized_column_sets():
    n = (1 << 16) + 123
    cols = {
        "key": np.array([f"k{i}" for i in range(n)]),
        "sum": np.arange(n, dtype=np.float64),
    }
    frames = [m.wire.encode_agg(cols, "off") for m in BOTH]
    assert frames[0] == frames[1] and len(frames[1]) == 2
    for m in BOTH:
        dec = np.concatenate([m.wire.decode_agg(f)["sum"] for f in frames[0]])
        assert np.array_equal(dec, cols["sum"])


def test_agg_codec_unknown_version_raises_typed():
    def case(m):
        (frame,) = m.wire.encode_agg({"sum": np.arange(4.0)}, "int8")
        bad = bytearray(frame)
        bad[4] = 99
        a = _typed_error(m, lambda: m.wire.decode_agg(bytes(bad)))
        b = _typed_error(m, lambda: m.wire.decode_agg(b"\x80nonsense"))
        assert "version 99" in a and "aggregate" in b
        return a, b

    want, got = both(case)
    assert got == want


def test_gsync_quant_knob_is_validated(monkeypatch):
    def case(m):
        monkeypatch.setenv("BYTEWAX_TPU_GSYNC_QUANT", "int4")
        m.wire.reconfigure()
        with pytest.raises(ValueError, match="int4") as info:
            m.wire.gsync_quant()
        monkeypatch.setenv("BYTEWAX_TPU_GSYNC_QUANT", "bf16")
        m.wire.reconfigure()
        return str(info.value), m.wire.gsync_quant()

    want, got = both(case)
    assert got == want
    assert got[1] == "bf16"


# -- the driver's zero-row skip + in-process exchange parity ------------


def test_ship_route_skips_zero_row_entries():
    def case(m):
        class _Probe(m.driver._Driver):
            def __init__(self):
                self.wpp = 1
                self.local_lo = 0
                self.local_hi = 1
                self._ship_acc = m.wire.RouteAccumulator()
                self.sent = [0, 0]

        d = _Probe()
        d.ship_route("s", (1, []))
        d.ship_route("s", (1, m.ArrayBatch({"value": np.empty(0, dtype=np.float64)})))
        empty = d._ship_acc.pending()
        d.ship_route("s", (1, [("k", 1)]))
        return empty, d._ship_acc.pending(), d.sent

    want, got = both(case)
    assert got == want == (False, True, [0, 0])


def test_wire_status_shape():
    def case(m):
        m.wire.encode(("route", "s", (0, _vb(m, [0], [1.0]))))
        st = m.flight.wire_status()
        assert st["encode"]["columnar"]["frames"] >= 1
        return {op: {c: sorted(v) for c, v in cs.items()} for op, cs in st.items()}

    want, got = both(case)
    assert got == want
    assert set(got) == {"encode", "decode"}
    for op in got.values():
        assert set(op) == {"columnar", "pickle"}
        for c in op.values():
            assert c == ["bytes", "frames", "seconds"]


def test_cluster_entrypoints_exchange_equality(entry_point_name):
    n, n_keys = 2000, 16
    rng = np.random.RandomState(3)
    key_ids = rng.randint(0, n_keys, size=n).astype(np.int32)
    vals = rng.rand(n)
    vocab = np.array([f"user-{i:03d}" for i in range(n_keys)])

    def case(m):
        class _Part(m.inputs.StatelessSourcePartition):
            def __init__(self, worker_index):
                self._batches = (
                    [
                        m.ArrayBatch(
                            {"key_id": key_ids[i : i + 256], "value": vals[i : i + 256]},
                            key_vocab=vocab,
                        )
                        for i in range(0, n, 256)
                    ]
                    if worker_index == 0
                    else []
                )

            def next_batch(self):
                if not self._batches:
                    raise StopIteration()
                return self._batches.pop(0)

        class Src(m.inputs.DynamicSource):
            def build(self, step_id, worker_index, worker_count):
                return _Part(worker_index)

        out = []
        flow = m.Dataflow("wire_parity_df")
        s = m.op.input("inp", flow, Src())
        summed = m.op.reduce_final("sum", s, lambda a, b: a + b)
        m.op.output("out", summed, m.TestingSink(out))
        m.entry(entry_point_name)(flow, epoch_interval=ZERO_TD)
        return dict(out)

    want, got = both(case)
    oracle = {}
    for k, v in zip(key_ids, vals):
        key = f"user-{int(k):03d}"
        oracle[key] = oracle.get(key, 0.0) + float(v)
    assert set(got) == set(want) == set(oracle)
    for k in oracle:
        assert got[k] == pytest.approx(oracle[k])
        assert got[k] == pytest.approx(want[k], rel=1e-12)
