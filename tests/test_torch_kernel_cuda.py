"""The hand-written kernels (segment fold, segmented scan, shard
bucketing, dequantize-and-merge of a whole gsync round) against their
plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA card every case skips (the kernel has
no CPU mode; the CPU tests hold the plain version to the JAX package).
This file imports neither ``jax`` nor ``bytewax_tpu``, so it runs on a
machine with only the port installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py

Values are multiples of 0.5 and the packed scale is ±0.5, so every
float32 sum here is exact in any order and the kernel must match the
plain version exactly, atomics or not.  NaN must sit in the same
slots.  Capacity 1024 fits one block's shared table; 16384 splits it
over 4 block ranges and 70001 (odd) over 18 for four fields.
"""

import numpy as np
import pytest
import torch

from bytewax_tpu_torch.ops import fold_kernel
from bytewax_tpu_torch.ops import segment as seg

SCALE = 0.5
N_ROWS = 1 << 16
SOURCES = {
    "slot": fold_kernel.SRC_SLOT,
    "ext16": fold_kernel.SRC_EXT16,
    "ext32": fold_kernel.SRC_EXT32,
    "packed": fold_kernel.SRC_PACKED,
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(capacity: int, integer: bool, span: int = 2000, seed=None):
    """Rows for every source: slots over the whole table (scratch
    too), an id->slot table that sends some ids to scratch, and values
    ``k * 0.5`` (or ``k``) for ``|k| < span``."""
    rng = np.random.RandomState(capacity if seed is None else seed)
    n_map = min(capacity, 20000)
    ext_to_slot = rng.randint(0, capacity - 1, size=n_map).astype(np.int32)
    ext_to_slot[rng.rand(n_map) < 0.1] = capacity - 1  # unseen ids
    ext_to_slot[-1] = capacity - 1  # the sentinel
    slots = rng.randint(0, capacity, size=N_ROWS).astype(np.int32)
    ids = rng.randint(0, n_map, size=N_ROWS).astype(np.int32)
    q = rng.randint(-span, span, size=N_ROWS).astype(np.int16)
    vals = rng.randint(-span, span, size=N_ROWS)
    vals = vals.astype(np.int32) if integer else (vals * 0.5).astype(np.float32)
    return {
        "ext_to_slot": ext_to_slot,
        "slots": slots,
        "ids": ids,
        "q": q,
        "vals": vals,
    }


def _on(dev, inp):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ids = inp["ids"]
    return {
        "ext_to_slot": t(inp["ext_to_slot"]),
        "slots": t(inp["slots"]),
        "ext16": t(ids.astype(np.int16)),
        "ext32": t(ids),
        "packed": t(np.stack([ids.astype(np.int16), inp["q"]])),
        "vals": t(inp["vals"]),
    }


def _plain_rows(source, inp, scale):
    if source == "slot":
        return inp["slots"], inp["vals"]
    if source == "packed":
        slots = seg.slots_of(inp["ext_to_slot"], inp["packed"][0])
        return slots, seg.dequantize(inp["packed"], scale)
    return seg.slots_of(inp["ext_to_slot"], inp[source]), inp["vals"]


def _kernel_fold(source, kind, state, inp, scale):
    """One fold through the entry points."""
    if source == "slot":
        seg.update_fields(kind, state, inp["slots"], inp["vals"])
    elif source == "packed":
        seg.update_fields_packed(kind, state, inp["ext_to_slot"], inp["packed"], scale)
    else:
        seg.update_fields_vocab(kind, state, inp["ext_to_slot"], inp[source], inp["vals"])


def _same(got, want, tag):
    """Equal, and NaN in the same places."""
    if got.is_floating_point():
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan), f"{tag}: NaN in other slots"
        got, want = got[~nan], want[~nan]
    assert torch.equal(got, want), f"{tag}: {int((got != want).sum())} slots differ"


def _check_all_kinds(dev, source, inp, dtype, capacity, scale=SCALE):
    slots, vals = _plain_rows(source, inp, scale)
    base_slots, base_vals = inp["slots"], inp["vals"]
    if dtype != inp["vals"].dtype:
        base_vals = base_vals.to(dtype)
    for kind_name, kind in seg.AGG_KINDS.items():
        got = seg.init_fields(kind, capacity, dtype, dev)
        # Start from a table that already holds state.
        seg.fold_plain(kind, got, base_slots, base_vals)
        want = {k: v.clone() for k, v in got.items()}
        before = fold_kernel.launches
        _kernel_fold(source, kind, got, inp, scale)
        assert fold_kernel.launches == before + 1
        seg.fold_plain(kind, want, slots, vals)
        torch.cuda.synchronize()
        for name in kind.fields:
            _same(got[name], want[name], f"{kind_name}/{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [1024, 16384, 70001])
@pytest.mark.parametrize("source", sorted(SOURCES))
@pytest.mark.parametrize("integer", [False, True], ids=["float32", "int32"])
def test_kernel_matches_plain_on_card(dev, integer, source, capacity):
    dtype = torch.int32 if integer else torch.float32
    inp = _on(dev, _inputs(capacity, integer))
    _check_all_kinds(dev, source, inp, dtype, capacity)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [1024, 16384])
@pytest.mark.parametrize("source", ["slot", "ext16", "ext32"])
def test_nan_rows_match_plain_on_card(dev, source, capacity):
    raw = _inputs(capacity, False, seed=capacity + 1)
    rng = np.random.RandomState(5)
    raw["vals"][rng.rand(N_ROWS) < 0.001] = np.nan
    inp = _on(dev, raw)
    _check_all_kinds(dev, source, inp, torch.float32, capacity)
    # And NaN really reached a min field through the kernel.
    kind = seg.AGG_KINDS["min"]
    got = seg.init_fields(kind, capacity, torch.float32, dev)
    _kernel_fold(source, kind, got, inp, SCALE)
    assert bool(torch.isnan(got["min"]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("source", sorted(SOURCES))
@pytest.mark.parametrize("integer", [False, True], ids=["float32", "int32"])
def test_all_rows_on_one_slot(dev, integer, source):
    # The worst case for shared-memory contention: every row folds into
    # slot 3.  Small values keep every float32 sum exact.
    capacity = 1024
    raw = _inputs(capacity, integer, span=8)
    raw["slots"][:] = 3
    raw["ext_to_slot"][:-1] = 3
    raw["ids"][:] = 7
    dtype = torch.int32 if integer else torch.float32
    _check_all_kinds(dev, source, _on(dev, raw), dtype, capacity)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.5, -0.5, 0.0, float("inf"), float("nan")])
def test_packed_scales(dev, scale):
    # A negative scale swaps min and max of q; zero, inf and NaN fold
    # row by row in float32 (q * inf is NaN for q = 0).
    capacity = 1024
    inp = _on(dev, _inputs(capacity, False, seed=9))
    _check_all_kinds(dev, "packed", inp, torch.float32, capacity, scale=scale)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [32768, 131072])
@pytest.mark.parametrize("integer", [False, True], ids=["float32", "int32"])
def test_slot_rows_at_window_capacities(dev, integer, capacity):
    # The rows a windowed fold sends through ``update_ids``: slots over
    # a large table, then slots freed by window closes reset to the
    # identity and reused within the next fold.
    dtype = torch.int32 if integer else torch.float32
    raw = _inputs(capacity, integer, seed=capacity + 2)
    inp = _on(dev, raw)
    _check_all_kinds(dev, "slot", inp, dtype, capacity)
    reused = torch.from_numpy(np.unique(raw["slots"][:4096] % (capacity - 1)).astype(np.int64)).to(dev)
    for kind_name, kind in seg.AGG_KINDS.items():
        got = seg.init_fields(kind, capacity, dtype, dev)
        _kernel_fold("slot", kind, got, inp, SCALE)
        want = {k: v.clone() for k, v in got.items()}
        for name, (init, _op) in kind.fields.items():
            ident = seg.identity_for(init, dtype)
            got[name].index_fill_(0, reused, ident)
            want[name].index_fill_(0, reused, ident)
        _kernel_fold("slot", kind, got, inp, SCALE)
        seg.fold_plain(kind, want, inp["slots"], inp["vals"])
        torch.cuda.synchronize()
        for name in kind.fields:
            _same(got[name], want[name], f"reuse/{kind_name}/{name}")


@pytest.mark.cuda
def test_fold_times_its_launches_by_events_off_the_device_timeline(dev):
    # Each launch lies between two CUDA timing events that resolve,
    # once complete and never waited for, into fold_device_seconds;
    # the launcher holds the stream until both and the kernel are
    # queued, so a pair holds the kernel and a few microseconds of the
    # card's own, not the launch's latency (about 60 us under the
    # profiler).  Its range bytewax.fold is a host record with no
    # device mirror and no counter of its own, and no synchronize runs
    # inside it.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bytewax_tpu_torch.engine import flight
    from bytewax_tpu_torch.ops import fold_kernel

    capacity = 16384
    kind = seg.AGG_KINDS["stats"]
    inp = _on(dev, _inputs(capacity, False))
    state = seg.init_fields(kind, capacity, torch.float32, dev)
    times = flight.DEVICE_TIMES
    torch.cuda.synchronize()
    times.resolve()
    assert len(times) == 0
    counters = flight.RECORDER.counters
    before = counters.get("fold_device_seconds", 0.0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            _kernel_fold("packed", kind, state, inp, SCALE)
        torch.cuda.synchronize()
    assert len(times) == 8
    assert times.resolve() == 8
    event_s = counters["fold_device_seconds"] - before
    events = list(prof.events())
    assert not [e.name for e in events if e.device_type == DeviceType.CUDA and e.name.startswith("bytewax.")]
    ranges = [e for e in events if e.name == "bytewax.fold"]
    assert len(ranges) == 8
    assert all(e.device_type == DeviceType.CPU and not e.is_user_annotation for e in ranges)
    inside = [
        e.name
        for e in events
        if "ynchronize" in e.name
        and any(r.time_range.start <= e.time_range.start <= r.time_range.end for r in ranges)
    ]
    assert not inside, inside
    kernel_s = 1e-6 * sum(
        e.time_range.end - e.time_range.start
        for e in events
        if e.device_type == DeviceType.CUDA and "fold" in e.name
    )
    assert kernel_s > 0
    assert not fold_kernel._untimed
    assert 0.95 * kernel_s <= event_s <= kernel_s + 8 * 20e-6, (event_s, kernel_s)
    assert "fold_seconds" not in counters


# -- the segmented-scan kernel (csrc/segment_scan.cu) ------------------------
#
# Each built-in kind's kernel instance against its plain version on the
# card, from the same table and rows.  Counts and extrema must match
# exactly (NaN in the same places); the float32 Welford and EMA states
# and outputs differ by rounding only (the kernel merges in a tree, the
# plain versions in another order): z within 1e-4 of max(1, |z|), the
# EMA within 1e-4 relative, mean, m2 and s within 1e-5 relative.

from bytewax_tpu_torch.ops import scan as scan_ops  # noqa: E402
from bytewax_tpu_torch.ops import scan_kernel  # noqa: E402

SCAN_KINDS = {
    "welford": lambda: scan_ops.WelfordZScore(3.0),
    "ema": lambda: scan_ops.Ema(0.3),
    "ema_alpha1": lambda: scan_ops.Ema(1.0),
    "ema_tiny": lambda: scan_ops.Ema(1e-8),
    "extrema": lambda: scan_ops.RunningExtrema(),
}
#: name -> (rows, keys, capacity)
SCAN_LAYOUTS = {
    "many_keys": (1 << 16, 600, 1024),
    "one_key": (1 << 16, 1, 1024),
    "one_row_segments": (1 << 16, 1 << 16, 1 << 17),
    # The single pass's ragged last tile, and a call below one tile.
    "ragged": ((1 << 16) + 37, 600, 1024),
    "below_a_tile": (5, 2, 1024),
}


def _scan_table(kind, capacity, dev, resumed, rng):
    fields = {
        name: torch.full((capacity,), init, dtype=dtype, device=dev)
        for name, (init, dtype) in kind.fields.items()
    }
    if not resumed:
        return fields
    m = capacity - 1
    if kind.kernel == "welford":
        count = rng.randint(0, 40, m)
        fields["count"][:m] = torch.from_numpy(count.astype(np.int32)).to(dev)
        fields["mean"][:m] = torch.from_numpy((rng.randn(m) * 5 + 20).astype(np.float32)).to(dev)
        m2 = (rng.rand(m) * 30 * np.maximum(count - 1, 0)).astype(np.float32)
        fields["m2"][:m] = torch.from_numpy(m2).to(dev)
    elif kind.kernel == "ema":
        count = rng.randint(0, 40, m)
        fields["count"][:m] = torch.from_numpy(count.astype(np.int32)).to(dev)
        s = (rng.randn(m) * 5 + 20) * (1 - (1 - kind.alpha) ** count)
        fields["s"][:m] = torch.from_numpy(s.astype(np.float32)).to(dev)
    else:
        lo = rng.randn(m) * 5 + 20
        fields["mn"][:m] = torch.from_numpy(lo.astype(np.float32)).to(dev)
        fields["mx"][:m] = torch.from_numpy((lo + rng.rand(m) * 10).astype(np.float32)).to(dev)
    return fields


def _scan_rows(n, n_keys, capacity, dev, rng, nan_share=0.0):
    """Grouped rows: ``n_keys`` keys on distinct slots of the table
    (scratch excluded), each key's rows contiguous."""
    keys = np.sort(rng.randint(0, n_keys, n))
    slot_of = rng.permutation(capacity - 1)[:n_keys].astype(np.int32)
    vals = (rng.randn(n) * 5 + 20).astype(np.float32)
    vals[rng.rand(n) < nan_share] = np.nan
    return (
        torch.from_numpy(slot_of[keys]).to(dev),
        torch.from_numpy(vals).to(dev),
    )


def _close(got, want, rtol, what):
    err = (got.double() - want.double()).abs() / want.double().abs().clamp(min=1.0)
    assert float(err.max()) <= rtol, f"{what}: error {float(err.max())}"


def _check_scan(kind, fields, slots, vals):
    want = {k: v.clone() for k, v in fields.items()}
    before = scan_kernel.launches
    got_outs, _ = kind.run(fields, slots, vals)
    assert scan_kernel.launches == before + 1
    want_outs, _ = kind.plain(want, slots, vals)
    torch.cuda.synchronize()
    # The plain versions write their non-tail rows to the scratch slot.
    real = slice(0, fields[next(iter(fields))].shape[0] - 1)
    for name, (_init, dtype) in kind.fields.items():
        g, w = fields[name][real], want[name][real]
        if dtype == torch.int32 or kind.kernel == "extrema":
            _same(g, w, name)
        else:
            _close(g, w, 1e-5, name)
    for i, (g, w) in enumerate(zip(got_outs, want_outs)):
        if kind.kernel == "extrema":
            _same(g, w, f"out{i}")
        elif kind.kernel == "welford":
            _close(g, w, 1e-4, "z")
        else:
            _close(g, w, 1e-4, "ema")


@pytest.mark.cuda
@pytest.mark.parametrize("resumed", [False, True], ids=["fresh", "resumed"])
@pytest.mark.parametrize("layout", sorted(SCAN_LAYOUTS))
@pytest.mark.parametrize("name", sorted(SCAN_KINDS))
def test_scan_kernel_matches_plain_on_card(dev, name, layout, resumed):
    kind = SCAN_KINDS[name]()
    n, n_keys, capacity = SCAN_LAYOUTS[layout]
    rng = np.random.RandomState(n_keys + 7 * resumed)
    fields = _scan_table(kind, capacity, dev, resumed, rng)
    slots, vals = _scan_rows(n, n_keys, capacity, dev, rng)
    _check_scan(kind, fields, slots, vals)


@pytest.mark.cuda
def test_scan_kernel_nan_rows_propagate_in_extrema(dev):
    kind = scan_ops.RunningExtrema()
    rng = np.random.RandomState(3)
    fields = _scan_table(kind, 1024, dev, True, rng)
    slots, vals = _scan_rows(1 << 16, 600, 1024, dev, rng, nan_share=1e-3)
    _check_scan(kind, fields, slots, vals)
    assert bool(torch.isnan(fields["mn"]).any())


@pytest.mark.cuda
def test_scan_kernel_keeps_m2_zero_over_equal_values(dev):
    # Each key's rows all carry one value (repeating across keys): m2
    # must stay exactly 0 and every z exactly 0, in this batch and the
    # next, which carries the state in.
    kind = scan_ops.WelfordZScore(3.0)
    rng = np.random.RandomState(4)
    fields = _scan_table(kind, 1024, dev, False, rng)
    keys = np.sort(rng.randint(0, 600, 1 << 16))
    slots = torch.from_numpy(keys.astype(np.int32)).to(dev)
    vals = torch.from_numpy((keys % 7 * 1.5).astype(np.float32)).to(dev)
    for _ in range(2):
        (z,), _ = kind.run(fields, slots, vals)
        torch.cuda.synchronize()
        assert float(z.abs().max()) == 0.0
        assert float(fields["m2"].abs().max()) == 0.0


@pytest.mark.cuda
def test_scan_kernel_count_stays_exact_past_fp24(dev):
    kind = scan_ops.WelfordZScore(3.0)
    fields = _scan_table(kind, 16, dev, False, None)
    fields["count"][3] = 1 << 24
    fields["m2"][3] = 1000.0
    slots = torch.full((5,), 3, dtype=torch.int32, device=dev)
    kind.run(fields, slots, torch.ones(5, device=dev))
    torch.cuda.synchronize()
    assert int(fields["count"][3]) == (1 << 24) + 5


# -- the single-pass kernel's edges --------------------------------------------
#
# One launch a call, tiles of 2048 rows claimed in order, status words
# tagged with a sequence number kept on the card (the ragged and
# sub-tile sizes are layouts above): pointers that are not 16-byte
# aligned (the scalar-load path), more tiles than the card holds at
# once (one key, so every look-back walks), calls back to back on one
# stream with no sync between them, and calls replayed in a CUDA graph.


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCAN_KINDS))
def test_scan_kernel_unaligned_rows(dev, name):
    kind = SCAN_KINDS[name]()
    rng = np.random.RandomState(12)
    fields = _scan_table(kind, 1024, dev, True, rng)
    slots, vals = _scan_rows((1 << 16) + 1, 600, 1024, dev, rng)
    slots, vals = slots[1:], vals[1:]
    assert slots.data_ptr() % 16 and vals.data_ptr() % 16
    _check_scan(kind, fields, slots, vals)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["welford", "extrema"])
def test_scan_kernel_more_tiles_than_resident(dev, name):
    kind = SCAN_KINDS[name]()
    rng = np.random.RandomState(13)
    fields = _scan_table(kind, 16, dev, True, rng)
    slots, vals = _scan_rows(1 << 22, 1, 16, dev, rng)
    _check_scan(kind, fields, slots, vals)


@pytest.mark.cuda
def test_scan_kernel_back_to_back_calls(dev):
    # Calls of different instances and sizes on one stream, no sync
    # between them; each then held against its plain version from the
    # table it started from.
    rng = np.random.RandomState(14)
    calls = []
    for name, n, n_keys in (
        ("welford", 1 << 20, 10_000),
        ("ema", 5, 2),
        ("extrema", (1 << 20) + 37, 1),
        ("welford", 3000, 3000),
        ("ema_alpha1", 1 << 18, 600),
    ):
        kind = SCAN_KINDS[name]()
        capacity = 1 << 15 if n_keys >= 600 else 1024
        fields = _scan_table(kind, capacity, dev, True, rng)
        slots, vals = _scan_rows(n, n_keys, capacity, dev, rng)
        calls.append((kind, fields, {k: v.clone() for k, v in fields.items()}, slots, vals))
    before = scan_kernel.launches
    outs = [kind.run(fields, slots, vals)[0] for kind, fields, _w, slots, vals in calls]
    assert scan_kernel.launches == before + len(calls)
    torch.cuda.synchronize()
    for (kind, fields, want, slots, vals), got_outs in zip(calls, outs):
        want_outs, _ = kind.plain(want, slots, vals)
        real = slice(0, fields[next(iter(fields))].shape[0] - 1)
        for name, (_init, dtype) in kind.fields.items():
            if dtype == torch.int32 or kind.kernel == "extrema":
                _same(fields[name][real], want[name][real], name)
            else:
                _close(fields[name][real], want[name][real], 1e-5, name)
        for g, w in zip(got_outs, want_outs):
            if kind.kernel == "extrema":
                _same(g, w, "out")
            else:
                _close(g, w, 1e-4, kind.kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["welford", "extrema"])
def test_scan_kernel_replayed_in_a_cuda_graph(dev, name):
    # Three calls captured once and replayed twice: six scans of the
    # same rows, each carrying the last one's table in.
    kind = SCAN_KINDS[name]()
    rng = np.random.RandomState(15)
    fields = _scan_table(kind, 1024, dev, True, rng)
    slots, vals = _scan_rows(1 << 16, 600, 1024, dev, rng)
    want = {k: v.clone() for k, v in fields.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kind.run(fields, slots, vals)  # builds, and sizes the workspace
    torch.cuda.current_stream().wait_stream(side)
    kind.plain(want, slots, vals)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(3):
            outs, _ = kind.run(fields, slots, vals)
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    for _ in range(6):
        want_outs, _ = kind.plain(want, slots, vals)
    real = slice(0, 1023)
    for fname, (_init, dtype) in kind.fields.items():
        if dtype == torch.int32 or kind.kernel == "extrema":
            _same(fields[fname][real], want[fname][real], fname)
        else:
            _close(fields[fname][real], want[fname][real], 1e-5, fname)
    for g, w in zip(outs, want_outs):
        if kind.kernel == "extrema":
            _same(g, w, "out")
        else:
            _close(g, w, 1e-4, "z")


# -- the shard-bucketing kernel (csrc/shard_bucket.cu) ------------------------
#
# A permutation with counts: the kernel must equal its plain version
# exactly, every lane, count and drop.  The shapes are chip_smoke.py's
# phase-11 checks at 2^16 rows: 2, 4 and 8 shards; keys uniform over
# 10,000 and over 2^20, and one hot key on half the rows; a capacity at
# the true bucket maximum and one at half of it (rows dropped).

from bytewax_tpu_torch.ops import bucket_kernel  # noqa: E402
from bytewax_tpu_torch.parallel import exchange  # noqa: E402
from bytewax_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

BUCKET_ROWS = 1 << 16
BUCKET_DISTS = ("uniform_10k", "uniform_2p20", "hot_half")


def _bucket_rows(dist: str, total: int, seed: int):
    rng = np.random.RandomState(seed)
    span = 10_000 if dist != "uniform_2p20" else 1 << 20
    keys = rng.randint(0, span, size=total)
    if dist == "hot_half":
        keys[rng.rand(total) < 0.5] = 4321
    vals = rng.randn(total).astype(np.float32)
    valid = np.ones(total, dtype=bool)
    valid[-(total // 7) :] = False  # a padded tail, as the states send
    return keys.astype(np.int32), vals, valid


def _bucket_both(dev, lanes, n_shards, capacity, **kw):
    before = bucket_kernel.launches
    got = exchange.bucket_blocks(lanes, n_shards, capacity, **kw)
    assert bucket_kernel.launches == before + 1
    want = exchange.bucket_blocks_plain(lanes, n_shards, capacity, **kw)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("out", "counts", "dropped")):
        assert g.shape == w.shape, name
        assert torch.equal(g, w), f"{name}: {int((g != w).sum())} entries differ"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("tight", [True, False], ids=["at_max", "under_max"])
@pytest.mark.parametrize("flags", [0, exchange.DECODE, exchange.DECODE | exchange.POS])
@pytest.mark.parametrize("dist", BUCKET_DISTS)
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_bucket_kernel_matches_plain_on_card(dev, n_shards, dist, flags, tight):
    keys, vals, valid = _bucket_rows(dist, BUCKET_ROWS, seed=n_shards)
    n = BUCKET_ROWS // n_shards
    kt = torch.from_numpy(keys).to(dev).view(n_shards, n)
    vt = torch.from_numpy(vals).to(dev).view(torch.int32).view(n_shards, n)
    ok = torch.from_numpy(valid).to(dev).view(n_shards, n)
    _out, counts, _drop = exchange.bucket_blocks_plain([kt], n_shards, n, valid=ok)
    top = int(counts.max())
    capacity = top if tight else max(1, top // 2)
    _out, _counts, dropped = _bucket_both(
        dev, [kt, vt], n_shards, capacity, valid=ok, flags=flags, pad0=77, pos_base=5, pos_pad=-3
    )
    assert (int(dropped.sum()) == 0) == tight


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 4096, 4097, 10_000])
def test_bucket_kernel_ragged_sizes(dev, n):
    # Fewer rows than one tile, one chunk exactly, a ragged last
    # chunk; three blocks; explicit shard ids, some out of range.
    rng = np.random.RandomState(n)
    sid = torch.from_numpy(rng.randint(-1, 7, size=3 * n).astype(np.int32)).to(dev).view(3, n)
    lane = torch.from_numpy(rng.randint(0, 1 << 30, size=3 * n).astype(np.int32)).to(dev)
    _bucket_both(dev, [lane.view(3, n)], 6, max(1, n // 2), shard_ids=sid)


@pytest.mark.cuda
def test_bucket_by_shard_on_card_matches_the_cpu(dev):
    # The JAX-shaped entry point: [n, 3] float32 rows (a strided lane
    # each), explicit shard ids, a valid mask.
    rng = np.random.RandomState(3)
    n = 5000
    sid = rng.randint(0, 8, size=n).astype(np.int32)
    rows = rng.randn(n, 3).astype(np.float32)
    valid = rng.rand(n) < 0.9
    before = bucket_kernel.launches
    got = exchange.bucket_by_shard(
        torch.from_numpy(sid).to(dev), torch.from_numpy(rows).to(dev), torch.from_numpy(valid).to(dev), 8, 700
    )
    assert bucket_kernel.launches == before + 1
    want = exchange.bucket_by_shard(torch.from_numpy(sid), torch.from_numpy(rows), torch.from_numpy(valid), 8, 700)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_bucket_kernel_refuses_more_than_64_shards(dev):
    lane = torch.zeros((1, 16), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shards"):
        bucket_kernel.bucket([lane], 65, 4)


def _card_mesh_against_the_cpu(card):
    """Sharded aggregation and scan states on ``card`` against eight
    shards of the CPU: the fold's values are multiples of 0.5 (exact
    sums in any order) and the scan's outputs within 1e-4."""
    from bytewax_tpu_torch.engine.sharded_state import ShardedAggState, ShardedScanState
    from bytewax_tpu_torch.ops.scan import WelfordZScore

    cpu = make_mesh(devices=[torch.device("cpu")] * 8)
    n_card = card.shape["shard"]
    rng = np.random.RandomState(9)
    keys = np.array([f"k{i}" for i in rng.randint(0, 3000, size=40_000)])
    vals = rng.randint(-400, 400, size=40_000) * 0.5
    agg = [ShardedAggState("stats", m, cap_per_shard=64) for m in (card, cpu)]
    scan = [ShardedScanState(WelfordZScore(2.0), m, cap_per_shard=64) for m in (card, cpu)]
    folds, scans = fold_kernel.launches, scan_kernel.launches
    emits = []
    for i in range(0, len(keys), 10_000):
        for st in agg:
            st.update(keys[i : i + 10_000], vals[i : i + 10_000])
        emits.append([st.update(keys[i : i + 10_000], vals[i : i + 10_000])[1] for st in scan])
    assert fold_kernel.launches - folds == 4 * n_card
    assert scan_kernel.launches - scans >= 4 * n_card
    assert agg[0].finalize() == agg[1].finalize()
    for on_card, on_cpu in emits:
        np.testing.assert_allclose(on_card.outs[0], on_cpu.outs[0], atol=1e-4)


@pytest.mark.cuda
def test_sharded_states_on_a_card_mesh_match_the_cpu(dev):
    # Four shards of cuda:0: one bucketing call, views for the exchange.
    _card_mesh_against_the_cpu(make_mesh(devices=[torch.device("cuda", 0)] * 4))


@pytest.mark.cuda
@pytest.mark.parametrize("repeat", [1, 2], ids=["a_shard_a_card", "two_shards_a_card"])
def test_sharded_states_over_every_card_match_the_cpu(dev, repeat):
    # Every card of the host, once or twice each in runs: one bucketing
    # call a card, and copies between cards for the exchange.
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    cards = [torch.device("cuda", i) for i in range(n) for _ in range(repeat)]
    _card_mesh_against_the_cpu(make_mesh(devices=cards))


# -- the dequantize-and-merge kernel (csrc/agg_merge.cu) --------------------

MERGE_OPS = ("add", "min", "max")
MERGE_ENCS = ("raw", "int8", "bf16")
MERGE_DTYPES = ("int32", "float32")


def _merge_case(op, enc, dtype, padded, n, seed):
    """One frame's field and a table (``padded // 4095`` shards of 4096
    slots): unique real targets, padding aimed at shard 0's scratch
    slot, NaN, ±inf and negative values among the rows, some slots of
    the table already folded (a NaN one among them)."""
    from bytewax_tpu_torch.engine import xla as txla

    rng = np.random.default_rng(seed)
    size = 4096 * max(2, -(-padded // 4095))
    gidx = np.full(padded, 4095, dtype=np.int32)
    gidx[:n] = rng.permutation(np.setdiff1d(np.arange(size), np.arange(4095, size, 4096)))[:n]
    init = {"add": 0.0, "min": float("inf"), "max": float("-inf")}[op]
    table = txla.agg_merge_table(size, init, dtype).numpy()
    touched = rng.choice(size, size // 3, replace=False)
    touched = touched[touched % 4096 != 4095]
    if dtype == "float32":
        table[touched] = rng.normal(0, 300, len(touched)).astype(np.float32)
        table[touched[:3]] = [np.nan, np.inf, -np.inf]
    else:
        table[touched] = rng.integers(-(2**20), 2**20, len(touched))
    if enc == "raw":
        if dtype == "float32":
            vals = rng.normal(0, 300, padded).astype(np.float32)
            vals[: min(n, 6)] = [np.nan, np.inf, -np.inf, -0.0, 0.0, -1.5][: min(n, 6)]
        else:
            vals = rng.integers(-(2**31), 2**31, padded, dtype=np.int64).astype(np.int32)
        parts = (vals,)
    elif enc == "int8":
        scales = (rng.random(-(-padded // 1024)) * 4).astype(np.float32)
        scales[0] = np.inf if dtype == "float32" else 3e7
        q = rng.integers(-127, 128, padded).astype(np.int8)
        parts = (scales, q)
    else:
        f = rng.normal(0, 3e3, padded).astype(np.float32)
        f[: min(n, 6)] = [np.nan, np.inf, -np.inf, 3e9, -3e9, -2.75][: min(n, 6)]
        parts = ((f.view(np.uint32) >> 16).astype(np.uint16).view(np.int16),)
    return table, gidx, parts


def _bits(t):
    return t.cpu().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", MERGE_DTYPES)
@pytest.mark.parametrize("enc", MERGE_ENCS)
@pytest.mark.parametrize("op", MERGE_OPS)
def test_merge_kernel_matches_plain_bit_for_bit(dev, op, enc, dtype):
    from bytewax_tpu_torch.engine import xla as txla
    from bytewax_tpu_torch.ops import merge_kernel

    for padded, n in ((8192, 8190), (16384, 12001), (8192, 1)):
        table, gidx, parts = _merge_case(op, enc, dtype, padded, n, seed=padded + n)
        g = torch.from_numpy(gidx).to(dev)
        p = [torch.from_numpy(a).to(dev) for a in parts]
        want = txla.agg_merge_plain(torch.from_numpy(table.copy()).to(dev), g, n, enc, p, op)
        outs = []
        for _ in range(2):
            before = merge_kernel.launches
            got = txla.agg_merge(torch.from_numpy(table.copy()).to(dev), g, n, enc, p, op)
            assert merge_kernel.launches == before + 1
            outs.append(_bits(got))
        assert torch.equal(outs[0], outs[1]), "two runs differ"
        assert torch.equal(outs[0], _bits(want)), (op, enc, dtype, padded, n)


@pytest.mark.cuda
def test_merge_kernel_refuses_a_repeated_target(dev):
    from bytewax_tpu_torch.engine import xla as txla

    table = txla.agg_merge_table(8192, 0.0, "float32", dev)
    gidx = torch.tensor([3, 7, 3], dtype=torch.int32, device=dev)
    vals = torch.ones(3, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="repeat"):
        txla.agg_merge(table, gidx, 3, "raw", [vals], "add")
    with pytest.raises(ValueError, match="outside"):
        txla.agg_merge(table, torch.tensor([9000], dtype=torch.int32, device=dev), 1, "raw", [vals], "add")
    # The padding past n is not read: a repeated target there is fine.
    txla.agg_merge(table, gidx, 2, "raw", [vals], "add")


# -- a whole gsync round in one launch ---------------------------------------

#: Fields of the rounds: (op, encoding, table dtype) a field, as the
#: tier's stats rounds ship them, and mixes of every encoding.
ROUND_FIELDS = {
    "stats_int8": (("min", "int8", "float32"), ("max", "int8", "float32"),
                   ("add", "int8", "float32"), ("add", "raw", "int32")),
    "stats_bf16": (("min", "bf16", "float32"), ("max", "bf16", "float32"),
                   ("add", "bf16", "float32"), ("add", "raw", "int32")),
    "exact_int32": (("min", "raw", "int32"), ("max", "raw", "int32"),
                    ("add", "raw", "int32"), ("add", "raw", "int32")),
    "mixed": (("add", "raw", "float32"), ("min", "int8", "int32"), ("max", "bf16", "int32")),
}
#: Frames of a round: (padded length, real rows), in peer order.
ROUND_FRAMES = ((8192, 8190), (16384, 16380), (8192, 1), (8192, 5000))


def _round_case(fields, n_frames, seed):
    """A round of ``n_frames`` frames over ``fields``: the tables (numpy,
    a third of their slots folded already) and, per frame, the padded
    targets, the real row count and each field's ``(enc, parts)``
    padded to the frame's length.  Frames share slots, so a slot takes
    several frames' rows, in order."""
    tables, frames = None, []
    for f in range(n_frames):
        padded, n = ROUND_FRAMES[f % len(ROUND_FRAMES)]
        gidx, parts_of = None, []
        for k, (op, enc, dtype) in enumerate(fields):
            table, g, parts = _merge_case(op, enc, dtype, 16384, min(n, 16380), seed + 31 * f + k)
            if f == 0:
                tables = (tables or []) + [table]
            gidx = g[:padded] if gidx is None else gidx
            parts_of.append((enc, tuple(_pad_part(enc, p, padded) for p in parts)))
        frames.append((gidx, n, parts_of))
    return tables, frames


def _pad_part(enc, part, padded):
    if enc == "int8" and part.dtype == np.float32:
        return part[: -(-padded // 1024)]
    return part[:padded]


def _round_on(dev, frames):
    from bytewax_tpu_torch.engine import xla as txla

    return txla.pack_merge_round(frames, len(frames[0][2]), pin=dev.type == "cuda").to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n_frames", [1, 2, 4])
@pytest.mark.parametrize("fields", sorted(ROUND_FIELDS))
def test_round_merge_matches_plain_bit_for_bit(dev, fields, n_frames):
    from bytewax_tpu_torch.engine import xla as txla
    from bytewax_tpu_torch.ops import merge_kernel

    spec = ROUND_FIELDS[fields]
    tables, frames = _round_case(spec, n_frames, seed=7 * n_frames)
    ops = [op for op, _enc, _dt in spec]
    rnd = _round_on(dev, frames)
    # The plain version on the card too: the NaN an inf - inf makes has
    # other bits on the host's CPU.
    want = [torch.from_numpy(t.copy()).to(dev) for t in tables]
    txla.agg_merge_round_plain(want, ops, rnd)
    outs = []
    for _ in range(2):
        got = [torch.from_numpy(t.copy()).to(dev) for t in tables]
        before = merge_kernel.launches
        txla.agg_merge_round(got, ops, rnd)
        assert merge_kernel.launches == before + 1
        outs.append([_bits(g) for g in got])
    for k in range(len(spec)):
        assert torch.equal(outs[0][k], outs[1][k]), "two runs differ"
        assert torch.equal(outs[0][k], _bits(want[k])), (fields, n_frames, k)


@pytest.mark.cuda
def test_round_merge_names_the_frame_at_fault(dev):
    from bytewax_tpu_torch.engine import xla as txla

    spec = ROUND_FIELDS["stats_int8"]
    tables, frames = _round_case(spec, 3, seed=5)
    ops = [op for op, _enc, _dt in spec]
    gidx, n, parts = frames[1]
    bad = gidx.copy()
    bad[7] = bad[3]
    frames[1] = (bad, n, parts)
    got = [torch.from_numpy(t.copy()).to(dev) for t in tables]
    with pytest.raises(ValueError, match="frame 1 .*repeat"):
        txla.agg_merge_round(got, ops, _round_on(dev, frames))
    out = gidx.copy()
    out[0] = tables[0].shape[0]
    frames[1] = (gidx, n, parts)
    frames[2] = (out, frames[2][1], frames[2][2])
    with pytest.raises(ValueError, match="frame 2 .*outside"):
        txla.agg_merge_round(got, ops, _round_on(dev, frames))


# -- the one-pass bucketing: edges, back-to-back calls, graphs, layout -------


def _bucket_lanes(dev, n_blocks, n, seed, span=10_000):
    rng = np.random.RandomState(seed)
    keys = torch.from_numpy(rng.randint(0, span, size=(n_blocks, n)).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.randint(-(2**31), 2**31, size=(n_blocks, n), dtype=np.int64).astype(np.int32))
    ok = torch.from_numpy(rng.rand(n_blocks, n) < 0.9).to(dev)
    return [keys, vals.to(dev)], ok


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_shards", [(0, 4), (1, 64), (4095, 64), (4097, 1), (5000, 64), (70_001, 7)])
def test_bucket_kernel_edge_sizes(dev, n, n_shards):
    # No rows, one row, one row short of a chunk and one past it, one
    # shard, 64 shards; two blocks, every flag.
    lanes, ok = _bucket_lanes(dev, 2, n, seed=n + n_shards)
    capacity = max(1, 2 * n // n_shards)
    _bucket_both(dev, lanes, n_shards, capacity, valid=ok, flags=exchange.DECODE | exchange.POS,
                 pad0=-2, pos_base=3, pos_pad=-4)


@pytest.mark.cuda
def test_bucket_kernel_more_chunks_than_resident(dev):
    # 2^24 rows in one block: 4,096 chunks, more than the card holds at
    # once, so chunks look back on chunks that finished long before.
    lanes, ok = _bucket_lanes(dev, 1, 1 << 24, seed=11)
    _o, raw, _d = exchange.bucket_blocks_plain(lanes[:1], 4, 1 << 24, valid=ok)
    _bucket_both(dev, lanes, 4, int(raw.max()), valid=ok, flags=exchange.DECODE, pad0=5)


@pytest.mark.cuda
def test_bucket_kernel_back_to_back_calls_need_no_reset(dev):
    # Calls of different shapes issued with no sync between them, on one
    # workspace: each call's status words carry its own tag.
    shapes = ((4, 1 << 18, 4), (2, 5000, 64), (4, 1 << 18, 4), (1, 3, 2))
    cases, got = [], []
    for i, (n_blocks, n, n_shards) in enumerate(shapes):
        lanes, ok = _bucket_lanes(dev, n_blocks, n, seed=i)
        kw = dict(valid=ok, flags=exchange.DECODE | exchange.POS, pad0=7, pos_pad=-1)
        cases.append((lanes, n_shards, max(1, n // n_shards), kw))
        got.append(exchange.bucket_blocks(lanes, n_shards, max(1, n // n_shards), **kw))
    torch.cuda.synchronize()
    for (lanes, n_shards, capacity, kw), g in zip(cases, got):
        want = exchange.bucket_blocks_plain(lanes, n_shards, capacity, **kw)
        for a, b in zip(g, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_bucket_kernel_replayed_in_a_cuda_graph(dev):
    lanes, ok = _bucket_lanes(dev, 4, 1 << 16, seed=3)
    kw = dict(valid=ok, flags=exchange.DECODE, pad0=9)
    want = exchange.bucket_blocks_plain(lanes, 4, 1 << 14, **kw)
    exchange.bucket_blocks(lanes, 4, 1 << 14, **kw)  # the workspace, before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = exchange.bucket_blocks(lanes, 4, 1 << 14, **kw)
    for _ in range(3):
        for g in got:
            g.fill_(-123)
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("procs,local", [(2, 1), (2, 4), (8, 8)])
def test_bucket_kernel_peer_major_layout(dev, procs, local):
    # The cluster-wide exchange's layout, written by the kernel: the
    # plain version's, and the old transpose of the destination-major
    # output.
    lanes, ok = _bucket_lanes(dev, local, 3000, seed=procs + local)
    n_shards = procs * local
    kw = dict(valid=ok, flags=exchange.DECODE | exchange.POS, pad0=-1, pos_pad=-2)
    out, _c, _d = _bucket_both(dev, lanes, n_shards, 3000 // n_shards + 40, peers=procs, **kw)
    flat = exchange.bucket_blocks(lanes, n_shards, 3000 // n_shards + 40, **kw)[0]
    n_out = flat.shape[0]
    old = flat.view(n_out, procs, local, local, flat.shape[-1]).transpose(0, 1).contiguous()
    assert torch.equal(out, old)
