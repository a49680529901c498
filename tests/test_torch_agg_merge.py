"""The quantized gsync merge of the cluster-wide exchange tier against
the JAX package, in one process.

The same inputs, made from a numpy seed (the frames of the kernel's
card tests, ``tests/test_torch_kernel_cuda.py``), go through the JAX package's
``engine/xla.py`` ``agg_merge_fn``/``agg_merge_table`` (jitted on the
CPU) and the port's plain ``agg_merge``/``agg_merge_table``, and
through both packages' ``GlobalAggState._seal_merge`` and its host and
device folds (states built with ``__new__``: no distributed runtime is
needed).  Every comparison is exact: each slot takes one combine a
frame, so no sum depends on an order (NaN compares equal to NaN).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bytewax_tpu.engine import sharded_state as jss
from bytewax_tpu.engine import wire as jwire
from bytewax_tpu.engine import xla as jxla
from bytewax_tpu.ops.segment import AGG_KINDS as JAX_AGG_KINDS
from bytewax_tpu_torch.engine import sharded_state as tss
from bytewax_tpu_torch.engine import xla as txla
from bytewax_tpu_torch.ops.segment import AGG_KINDS
from test_torch_kernel_cuda import ROUND_FIELDS, _merge_case, _round_case

CAP = 4096
OPS = ("add", "min", "max")
ENCS = ("raw", "int8", "bf16")
DTYPES = ("int32", "float32")
IDENTITY = {"add": 0.0, "min": float("inf"), "max": float("-inf")}


def _torch_parts(parts):
    return [torch.from_numpy(np.array(p)) for p in parts]


def _jax_parts(enc, parts):
    """The JAX program takes bf16 upper halves as uint16."""
    if enc == "bf16":
        return [jnp.asarray(parts[0].view(np.uint16))]
    return [jnp.asarray(p) for p in parts]


@pytest.mark.parametrize(
    "op,enc,dtype", list(itertools.product(OPS, ENCS, DTYPES)), ids="-".join
)
def test_plain_merge_equals_agg_merge_fn(op, enc, dtype):
    padded, n = 8192, 8000
    table, gidx, parts = _merge_case(op, enc, dtype, padded, n, seed=len(op) * 7 + len(enc))
    fn = jxla.agg_merge_fn(op, enc, dtype, padded)
    want = np.asarray(fn(jnp.asarray(table), jnp.asarray(gidx), n, *_jax_parts(enc, parts)))
    got = txla.agg_merge(
        torch.from_numpy(table.copy()), torch.from_numpy(gidx), n, enc, _torch_parts(parts), op
    )
    assert got.dtype == txla._TABLE_DTYPES[dtype]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_merge_table_equals_agg_merge_table(op, dtype):
    want = np.asarray(jxla.agg_merge_table(3 * CAP, IDENTITY[op], dtype))
    got = txla.agg_merge_table(3 * CAP, IDENTITY[op], dtype).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if dtype == "int32" and op != "add":
        # ±inf saturates to the int32 extremes.
        assert abs(int(got[0])) >= 2**31 - 1


def test_plain_merge_refuses_a_repeated_target():
    table = txla.agg_merge_table(2 * CAP, 0.0, "float32")
    gidx = torch.tensor([3, 7, 3, CAP - 1], dtype=torch.int32)
    vals = torch.ones(4, dtype=torch.float32)
    with pytest.raises(ValueError, match="unique"):
        txla.agg_merge(table, gidx, 3, "raw", [vals], "add")
    with pytest.raises(ValueError, match="outside"):
        txla.agg_merge(table, torch.tensor([2 * CAP], dtype=torch.int32), 1, "raw", [vals], "add")
    # Rows from n on are padding and are not read.
    txla.agg_merge(table, gidx, 2, "raw", [vals], "add")
    assert table[3].item() == table[7].item() == 1.0


# -- the tier's sealing and folds, both packages on the same frames ----------


def _states(kind, n_shards, keys, quant_int, demoted):
    """The JAX package's and the port's ``GlobalAggState`` built with
    ``__new__``, with the same key placement."""
    out = []
    for mod in (jss, tss):
        st = mod.GlobalAggState.__new__(mod.GlobalAggState)
        st.kind_name = kind
        st.kind = (AGG_KINDS if mod is tss else JAX_AGG_KINDS)[kind]
        st.n_shards = n_shards
        st.cap_per_shard = CAP
        st.key_to_kid = {k: (i // n_shards) * n_shards + i % n_shards for i, k in enumerate(keys)}
        st._quant_int = quant_int
        st._merge_demoted = demoted
        st._host_fields = None
        st._dev_fields = None
        st._lane = None
        st.device = torch.device("cpu")
        out.append(st)
    return out


def _peer_frames(keys, quant, ints, seed):
    """Two peers' partial frames over overlapping key sets."""
    rng = np.random.default_rng(seed)
    frames = []
    for peer in range(2):
        mine = sorted(rng.choice(keys, len(keys) * 2 // 3, replace=False).tolist())
        n = len(mine)
        if ints:
            lo = rng.integers(-5000, 5000, n)
            cols = {"min": lo, "max": lo + rng.integers(0, 900, n), "sum": rng.integers(-(10**6), 10**6, n)}
        else:
            lo = rng.normal(0, 400, n)
            cols = {"min": lo, "max": lo + rng.random(n) * 900, "sum": rng.normal(0, 1e5, n)}
            cols["min"][:2] = [np.nan, -np.inf]
        cols = {"key": np.array(mine), **cols, "count": rng.integers(1, 500, n).astype(np.int64)}
        frames.append(jwire.encode_agg(cols, quant))
    return frames


@pytest.mark.parametrize(
    "quant,ints", [("int8", False), ("bf16", False), ("int8", True)], ids=["int8", "bf16", "int8-exact"]
)
def test_sealed_merge_matches_the_reference_host_and_device(quant, ints):
    keys = [f"st{i:05d}" for i in range(5000)]
    frames = _peer_frames(keys, quant, ints, seed=11)
    # The host fold: float64 blocks, the same np.*.at order.
    jst, tst = _states("stats", 2, keys, quant_int=ints, demoted=True)
    jsealed, tsealed = jst._seal_merge(frames), tst._seal_merge(frames)
    assert jsealed["device"] is tsealed["device"] is False
    jst._apply_merge(jsealed)
    tst._apply_merge(tsealed)
    assert set(jst._host_fields) == set(tst._host_fields)
    for name, arr in jst._host_fields.items():
        np.testing.assert_array_equal(tst._host_fields[name], arr)
    # The device fold: the JAX program on the CPU against the port's
    # plain merge (the JAX package pads each frame; the port does not).
    jst, tst = _states("stats", 2, keys, quant_int=ints, demoted=False)
    for _ in range(2):  # two rounds into the same tables
        jsealed, tsealed = jst._seal_merge(frames), tst._seal_merge(frames)
        assert jsealed["device"] is tsealed["device"] is True
        jst._apply_merge(jsealed)
        tst._apply_merge(tsealed)
    for name, table in jst._dev_fields.items():
        got = tst._dev_fields[name]
        assert str(got.dtype).endswith(str(table.dtype))
        np.testing.assert_array_equal(got.numpy(), np.asarray(table))
    np.testing.assert_array_equal(
        tst._fetch_dev_fields()["sum"], np.asarray(jst._dev_fields["sum"]).astype(np.float64)
    )


def test_merge_tables_promote_like_the_reference():
    # An all-integer round folds on int32 tables; the first round that
    # is not promotes the value tables to float32, in round order.
    keys = [f"st{i:05d}" for i in range(3000)]
    states = _states("stats", 4, keys, quant_int=True, demoted=False)
    for ints in (True, False):
        frames = _peer_frames(keys, "int8", ints, seed=5)
        for st in states:
            st._quant_int = ints
            st._apply_merge(st._seal_merge(frames))
    jst, tst = states
    for name, table in jst._dev_fields.items():
        got = tst._dev_fields[name]
        assert str(got.dtype).endswith(str(table.dtype))
        np.testing.assert_array_equal(got.numpy(), np.asarray(table))
    assert tst._dev_fields["count"].dtype == torch.int32
    assert tst._dev_fields["sum"].dtype == torch.float32


def test_sealing_refuses_a_frame_that_names_a_key_twice():
    keys = ["a", "b", "c"]
    (_jst, tst) = _states("sum", 2, keys, quant_int=False, demoted=False)
    frames = jwire.encode_agg({"key": np.array(["a", "b", "a"]), "sum": np.array([1.0, 2.0, 3.0])}, "int8")
    with pytest.raises(AssertionError, match="twice"):
        tst._seal_merge([frames])


# -- a whole round: every frame, every field ----------------------------------


def _jax_round(tables, spec, frames):
    """The JAX package's fold of a round: ``agg_merge_fn`` a (frame,
    field), on each frame's padded arrays."""
    out = [jnp.asarray(t) for t in tables]
    for gidx, n, parts_of in frames:
        for k, ((op, enc, dtype), (_enc, parts)) in enumerate(zip(spec, parts_of)):
            if str(out[k].dtype) != dtype:
                out[k] = out[k].astype(jnp.dtype(dtype))
            fn = jxla.agg_merge_fn(op, enc, dtype, len(gidx))
            out[k] = fn(out[k], jnp.asarray(gidx), n, *_jax_parts(enc, parts))
    return [np.asarray(t) for t in out]


def _frame_by_frame(tables, spec, frames):
    """``agg_merge_plain`` a frame and a field at a time, on the frames'
    own arrays."""
    out = [torch.from_numpy(t.copy()) for t in tables]
    for gidx, n, parts_of in frames:
        for k, ((op, _enc, dtype), (enc, parts)) in enumerate(zip(spec, parts_of)):
            if out[k].dtype != txla._TABLE_DTYPES[dtype]:
                out[k] = out[k].to(txla._TABLE_DTYPES[dtype])
            txla.agg_merge_plain(out[k], torch.from_numpy(gidx), n, enc, _torch_parts(parts), op)
    return out


def _round_plain(tables, spec, frames):
    out = [torch.from_numpy(t.copy()) for t in tables]
    rnd = txla.pack_merge_round(frames, len(spec))
    txla.agg_merge_round(out, [op for op, _e, _d in spec], rnd)
    return out


@pytest.mark.parametrize("n_frames", [1, 2, 4])
@pytest.mark.parametrize("fields", sorted(ROUND_FIELDS))
def test_round_plain_equals_frame_by_frame_and_agg_merge_fn(fields, n_frames):
    spec = ROUND_FIELDS[fields]
    tables, frames = _round_case(spec, n_frames, seed=7 * n_frames)
    got = _round_plain(tables, spec, frames)
    by_frame = _frame_by_frame(tables, spec, frames)
    jax_out = _jax_round(tables, spec, frames)
    for k in range(len(spec)):
        assert got[k].dtype == txla._TABLE_DTYPES[spec[k][2]]
        assert torch.equal(got[k].view(torch.int32), by_frame[k].view(torch.int32)), k
        np.testing.assert_array_equal(got[k].numpy(), jax_out[k])


def test_round_after_an_int32_to_float32_promotion():
    # An all-integer round on int32 tables, then a quantized one after
    # the value tables promote to float32 (the host step before the
    # launch), as the tier does at its first round that is not
    # all-integer.
    exact = ROUND_FIELDS["exact_int32"]
    quant = ROUND_FIELDS["stats_int8"]
    tables, frames = _round_case(exact, 2, seed=3)
    _t, later = _round_case(quant, 2, seed=4)
    got = _round_plain(tables, exact, frames)
    promoted = [t.to(txla._TABLE_DTYPES[dtype]) for t, (_o, _e, dtype) in zip(got, quant)]
    got = _round_plain([t.numpy() for t in promoted], quant, later)
    jax_out = _jax_round(_jax_round(tables, exact, frames), quant, later)
    by_frame = _frame_by_frame([t.numpy() for t in _frame_by_frame(tables, exact, frames)], quant, later)
    for k, (_op, _enc, dtype) in enumerate(quant):
        assert got[k].dtype == txla._TABLE_DTYPES[dtype]
        assert torch.equal(got[k].view(torch.int32), by_frame[k].view(torch.int32)), k
        np.testing.assert_array_equal(got[k].numpy(), jax_out[k])


def test_round_plain_names_the_frame_at_fault():
    spec = ROUND_FIELDS["stats_bf16"]
    tables, frames = _round_case(spec, 3, seed=5)
    gidx, n, parts = frames[1]
    bad = gidx.copy()
    bad[7] = bad[3]
    with pytest.raises(ValueError, match="frame 1: .*unique"):
        _round_plain(tables, spec, [frames[0], (bad, n, parts), frames[2]])
    out = frames[2][0].copy()
    out[0] = tables[0].shape[0]
    with pytest.raises(ValueError, match="frame 2: .*outside"):
        _round_plain(tables, spec, [frames[0], frames[1], (out,) + frames[2][1:]])


def _per_field_sealing(st, frames):
    """What the tier sealed a device round into before a round became
    one buffer: a frame's int32 targets, its row count, and a field's
    parts as separate arrays (raw cast to the table dtype)."""
    from bytewax_tpu_torch.engine import wire as twire

    sealed = []
    for frame in (fr for peer in frames for fr in peer):
        parts = twire.decode_agg_parts(frame)
        keys = parts["key"][1]
        gidx = np.array([st._global_idx(st.key_to_kid[k]) for k in keys.tolist()], dtype=np.int32)
        fields = {}
        for name in st.kind.fields:
            enc, p = parts[name]
            want = st._merge_dtype(name)
            if enc == "int8":
                arrays = tuple(np.array(a) for a in p)
            elif enc == "bf16":
                arrays = (np.array(p).view(np.int16),)
            else:
                arrays = (np.asarray(p).astype(np.dtype(want)),)
            fields[name] = (enc, arrays, want)
        sealed.append((gidx, len(keys), fields))
    return sealed


@pytest.mark.parametrize(
    "quant,ints", [("int8", False), ("bf16", False), ("int8", True)], ids=["int8", "bf16", "int8-exact"]
)
def test_sealed_round_packs_the_per_field_sealing(quant, ints):
    keys = [f"st{i:05d}" for i in range(3000)]
    frames = _peer_frames(keys, quant, ints, seed=17)
    _jst, tst = _states("stats", 4, keys, quant_int=ints, demoted=False)
    sealed = tst._seal_merge(frames)
    rnd = sealed["round"]
    want = _per_field_sealing(tst, frames)
    assert rnd.n_frames == len(want) >= 2 and rnd.n_fields == len(tst.kind.fields)
    assert sealed["dtypes"] == [tst._merge_dtype(name) for name in tst.kind.fields]
    for f, (gidx, n, fields) in enumerate(want):
        got_gidx, got_n = rnd.frame(f)
        assert got_n == n
        np.testing.assert_array_equal(got_gidx.numpy(), gidx)
        for k, name in enumerate(tst.kind.fields):
            enc, arrays, table_dtype = fields[name]
            got_enc, got_parts = rnd.field(f, k, txla._TABLE_DTYPES[table_dtype])
            assert got_enc == enc
            assert len(got_parts) == len(arrays)
            for g, w in zip(got_parts, arrays):
                assert g.numpy().dtype == w.dtype
                np.testing.assert_array_equal(g.numpy().view(np.uint8), w.view(np.uint8))
