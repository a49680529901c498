"""The torch port's segment fold against the JAX package's.

Same inputs, made with numpy from a seed, go through the JAX
``update_fields*`` (and the Pallas kernel in interpret mode, float32)
and the port's entry points on CPU tensors, which run the plain
PyTorch version.  Integer state, counts, min and max must agree
exactly; float32 sums to ``rtol=atol=1e-5``, the bar the JAX package
holds between its own two folds (``tests/test_pallas_fold.py``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bytewax_tpu.ops import segment as ref_seg
from bytewax_tpu.ops.pallas_fold import update_fields_pallas
from bytewax_tpu_torch.ops import fold_kernel
from bytewax_tpu_torch.ops import segment as seg
from bytewax_tpu_torch.utils import force_platform

KINDS = sorted(seg.AGG_KINDS)
DTYPES = {"float32": (np.float32, torch.float32), "int32": (np.int32, torch.int32)}
N_ROWS = 1000
PADDED = 1024
SCALE = 0.1


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    saved = os.environ.get("BYTEWAX_TPU_PLATFORM")
    force_platform("cpu")
    yield
    if saved is None:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    else:
        os.environ["BYTEWAX_TPU_PLATFORM"] = saved


def _batch(rng, capacity: int, np_dtype):
    """One padded micro-batch for all three row sources: ``N_ROWS``
    real rows, then padding rows aimed at the scratch slot (slot
    mode) or at the sentinel id (vocab and packed modes).  The id→slot
    table also sends some real ids to scratch, as unseen ids are."""
    n_map = min(capacity, 300)
    ext_to_slot = rng.randint(0, capacity - 1, size=n_map).astype(np.int32)
    ext_to_slot[rng.rand(n_map) < 0.1] = capacity - 1
    ext_to_slot[-1] = capacity - 1  # the sentinel
    slots = np.full(PADDED, capacity - 1, dtype=np.int32)
    slots[:N_ROWS] = rng.randint(0, capacity - 1, size=N_ROWS)
    ids = np.full(PADDED, n_map - 1, dtype=np.int16)
    ids[:N_ROWS] = rng.randint(0, n_map, size=N_ROWS)
    q = np.zeros(PADDED, dtype=np.int16)
    q[:N_ROWS] = rng.randint(-999, 1000, size=N_ROWS)
    vals = np.zeros(PADDED, dtype=np_dtype)
    if np_dtype == np.float32:
        vals[:N_ROWS] = (rng.randn(N_ROWS) * 40).astype(np.float32)
    else:
        vals[:N_ROWS] = rng.randint(-10**6, 10**6, size=N_ROWS)
    return {
        "ext_to_slot": ext_to_slot,
        "slots": slots,
        "ids": ids,
        "packed": np.stack([ids, q]),
        "vals": vals,
    }


def _ref_fold(source, kind, state, b, id_dtype):
    if source == "slot":
        return ref_seg.update_fields(
            kind, state, jnp.asarray(b["slots"]), jnp.asarray(b["vals"])
        )
    if source == "vocab":
        return ref_seg.update_fields_vocab(
            kind,
            state,
            jnp.asarray(b["ext_to_slot"]),
            jnp.asarray(b["ids"].astype(id_dtype)),
            jnp.asarray(b["vals"]),
        )
    return ref_seg.update_fields_packed(
        kind,
        state,
        jnp.asarray(b["ext_to_slot"]),
        jnp.asarray(b["packed"]),
        jnp.float32(SCALE),
    )


def _port_fold(source, kind, state, b, id_dtype):
    if source == "slot":
        return seg.update_fields(
            kind, state, torch.from_numpy(b["slots"]), torch.from_numpy(b["vals"])
        )
    if source == "vocab":
        return seg.update_fields_vocab(
            kind,
            state,
            torch.from_numpy(b["ext_to_slot"]),
            torch.from_numpy(b["ids"].astype(id_dtype)),
            torch.from_numpy(b["vals"]),
        )
    return seg.update_fields_packed(
        kind,
        state,
        torch.from_numpy(b["ext_to_slot"]),
        torch.from_numpy(b["packed"]),
        SCALE,
    )


def assert_fields_match(kind, got, want, dtype_name, tag=""):
    for name, (_init, op_name) in kind.fields.items():
        g = got[name].numpy() if isinstance(got[name], torch.Tensor) else got[name]
        w = np.asarray(want[name])
        assert g.dtype == w.dtype, f"{tag}{name}: {g.dtype} != {w.dtype}"
        if dtype_name == "int32" or op_name != "add" or name == "count":
            np.testing.assert_array_equal(g, w, err_msg=f"{tag}{name}")
        else:
            np.testing.assert_allclose(
                g, w, rtol=1e-5, atol=1e-5, err_msg=f"{tag}{name}"
            )


@pytest.mark.parametrize("capacity", [128, 1024])
@pytest.mark.parametrize("source", ["slot", "vocab", "packed"])
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("kind_name", KINDS)
def test_fold_matches_reference(kind_name, dtype_name, source, capacity):
    np_dtype, t_dtype = DTYPES[dtype_name]
    kind = seg.AGG_KINDS[kind_name]
    ref_kind = ref_seg.AGG_KINDS[kind_name]
    rng = np.random.RandomState(capacity + len(kind_name))
    # int16 ids for the even capacity, int32 for the other: both id
    # widths the vocab source takes.
    id_dtype = np.int16 if capacity == 128 else np.int32
    ref = ref_seg.init_fields(ref_kind, capacity, getattr(jnp, dtype_name))
    port = seg.init_fields(kind, capacity, t_dtype)
    # Two batches: the second folds into a table that already holds
    # state.
    for _ in range(2):
        b = _batch(rng, capacity, np_dtype)
        ref = _ref_fold(source, ref_kind, ref, b, id_dtype)
        out = _port_fold(source, kind, port, b, id_dtype)
        assert out is port  # folds in place
    assert_fields_match(kind, port, ref, dtype_name)
    # The scratch slot keeps the identity.
    for name, (init, _op) in kind.fields.items():
        assert port[name][-1].item() == seg.identity_for(init, t_dtype)


@pytest.mark.parametrize("capacity", [128, 1024])
@pytest.mark.parametrize("kind_name", KINDS)
def test_fold_matches_pallas_interpret(kind_name, capacity):
    kind = seg.AGG_KINDS[kind_name]
    rng = np.random.RandomState(7 + capacity)
    b = _batch(rng, capacity, np.float32)
    want = update_fields_pallas(
        ref_seg.AGG_KINDS[kind_name],
        ref_seg.init_fields(ref_seg.AGG_KINDS[kind_name], capacity),
        jnp.asarray(b["slots"]),
        jnp.asarray(b["vals"]),
    )
    got = seg.update_fields(
        kind,
        seg.init_fields(kind, capacity),
        torch.from_numpy(b["slots"]),
        torch.from_numpy(b["vals"]),
    )
    assert_fields_match(kind, got, want, "float32")


@pytest.mark.parametrize("source", ["slot", "ext16", "ext32"])
@pytest.mark.parametrize("kind_name", ["min", "max", "stats", "sum"])
def test_nan_rows_fold_as_the_reference_does(kind_name, source):
    # A NaN row enters a float32 min/max (and a sum) and a stored NaN
    # stays: three batches, the middle one with NaN rows, some on slots
    # that already hold numbers.  This is the contract the kernel is
    # held to on the card.
    kind = seg.AGG_KINDS[kind_name]
    ref_kind = ref_seg.AGG_KINDS[kind_name]
    capacity = 128
    rng = np.random.RandomState(11 + len(kind_name) + len(source))
    ref_source, id_dtype = {
        "slot": ("slot", np.int16),
        "ext16": ("vocab", np.int16),
        "ext32": ("vocab", np.int32),
    }[source]
    ref = ref_seg.init_fields(ref_kind, capacity)
    port = seg.init_fields(kind, capacity)
    for step in range(3):
        b = _batch(rng, capacity, np.float32)
        if step == 1:
            b["vals"][rng.rand(PADDED) < 0.02] = np.nan
        ref = _ref_fold(ref_source, ref_kind, ref, b, id_dtype)
        _port_fold(ref_source, kind, port, b, id_dtype)
    for name in kind.fields:
        g, w = port[name].numpy(), np.asarray(ref[name])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        if name != "count":
            assert np.isnan(g).any(), f"{name}: no NaN reached the state"
    assert_fields_match(kind, port, ref, "float32")


def test_infinite_identities_and_negative_extrema():
    # Float min/max start at ±inf and must take all-negative values;
    # int32 identities saturate as the JAX package's do.
    kind = seg.AGG_KINDS["stats"]
    for t_dtype, j_dtype in ((torch.float32, jnp.float32), (torch.int32, jnp.int32)):
        port = seg.init_fields(kind, 8, t_dtype)
        ref = ref_seg.init_fields(ref_seg.AGG_KINDS["stats"], 8, j_dtype)
        assert_fields_match(
            kind, port, ref, "int32" if t_dtype == torch.int32 else "float32"
        )
        slots = np.array([0, 0, 1, 7], dtype=np.int32)
        vals = np.array([-5, -3, -9, 100], dtype=np.int32)
        seg.update_fields(
            kind, port, torch.from_numpy(slots), torch.from_numpy(vals)
        )
        assert port["min"][0].item() == -5 and port["max"][0].item() == -3
        assert port["min"][1].item() == -9 and port["max"][1].item() == -9
        assert port["count"].tolist()[:3] == [2, 1, 0]
        # Untouched slot 2 and the scratch slot keep the identities.
        assert port["min"][2].item() == seg.identity_for(float("inf"), t_dtype)
        assert port["max"][7].item() == seg.identity_for(float("-inf"), t_dtype)


def test_combine_stats_matches_reference():
    kind = seg.AGG_KINDS["stats"]
    rng = np.random.RandomState(3)
    a = {n: rng.randn(16).astype(np.float32) for n in kind.fields}
    b = {n: rng.randn(16).astype(np.float32) for n in kind.fields}
    want = ref_seg.combine_stats(
        ref_seg.AGG_KINDS["stats"],
        {n: jnp.asarray(v) for n, v in a.items()},
        {n: jnp.asarray(v) for n, v in b.items()},
    )
    got = seg.combine_stats(
        kind,
        {n: torch.from_numpy(v) for n, v in a.items()},
        {n: torch.from_numpy(v) for n, v in b.items()},
    )
    for n in kind.fields:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


def test_kernel_wrapper_refuses_what_it_cannot_take():
    # The wrapper checks before it builds anything: CPU state, a wrong
    # dtype or a mismatched length raise instead of launching.
    kind = seg.AGG_KINDS["sum"]
    before = fold_kernel.launches
    state = seg.init_fields(kind, 16)
    rows = torch.zeros(4, dtype=torch.int32)
    vals = torch.zeros(4)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        fold_kernel.fold(kind, state, fold_kernel.SRC_SLOT, rows, vals)
    meta = {"sum": torch.zeros(16, device="meta")}
    with pytest.raises(ValueError, match="cuda or cpu"):
        seg.update_fields(kind, meta, rows, vals)
    assert fold_kernel.launches == before
