"""A CPU model of the one-pass shard-bucketing kernel
(``bytewax_tpu_torch/csrc/shard_bucket.cu``), held to the plain version
and to the JAX package.

The kernel cannot run here (no nvcc, no card), so this models its
schedule, block by block, and finds a fault in the algorithm before the
card does:

- the grid is ``blocks`` blocks (the card's resident blocks), and every
  block takes tickets from the workspace's counter until none is left;
  tickets below ``n_blocks * chunks`` are row items, chunk ``c`` of
  source block ``b`` for ticket ``c * n_blocks + b``, and the later
  tickets are padding items;
- a row block ranks its rows as the kernel's warps do (``__match_any_sync``
  groups of 32 lanes, a ``[warp][shard]`` running count), publishes its
  per-shard counts at once (status A, or P for chunk 0), looks back
  over its block's earlier chunks a shard at a time, a window of words
  at once (the kernel's warp reads 32), down to the first P,
  publishes its P, sorts its rows by shard into a chunk-local buffer and
  writes each bucket's run;
- a padding block waits for the last chunk's P of its (block, shard) and
  fills its span past the count;
- status words are 64 bits, ``tag << 32 | P << 31 | count``, tagged with
  the call's sequence number, kept across calls in ``work`` as the
  workspace keeps them, never cleared; the block that finishes last
  resets the ticket counter and bumps the sequence number.

The blocks' steps interleave in a random order, at most ``resident``
blocks started and unfinished at a time (fewer than the grid where
other work holds SMs; blocks start in a random launch order).  A
schedule in which every started block waits while no other can start
is a deadlock and fails the model; two wrong designs (one item a block,
chosen by its launch index; padding tickets before row tickets) show
that the check fires.  Every output position must be
written exactly once.  The chunk here is 2 warps of 3 rows a lane (192
rows), a padding block fills 40 positions and a look-back window reads
4 words, so small inputs span many chunks, padding blocks and windows;
the kernel's are 16 warps of 8 rows, 4,096 and 32.

Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bytewax_tpu.parallel import exchange as ref_exchange
from bytewax_tpu_torch.parallel import exchange
from bytewax_tpu_torch.parallel.exchange import DECODE, POS
from bytewax_tpu_torch.utils import force_platform

P_BIT = 1 << 31
COUNT = P_BIT - 1
MASK32 = (1 << 32) - 1
#: (warps, rows a lane, padding span, look-back window) of the
#: modelled blocks.
GEOMETRY = (2, 3, 40, 4)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    force_platform("cpu")
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "0")


def _fresh_work():
    return {"next": 0, "done": 0, "calls": 0, "status": np.zeros(0, dtype=np.uint64)}


def _word(tag: int, p: bool, count: int) -> np.uint64:
    return np.uint64((tag << 32) | (P_BIT if p else 0) | count)


def _model_bucket(
    lanes,
    n_shards,
    capacity,
    shard_ids=None,
    valid=None,
    flags=0,
    pad0=0,
    pos_base=0,
    pos_pad=0,
    peers=1,
    *,
    work,
    rng,
    resident,
    blocks=6,
    roles="ticket",
    geometry=GEOMETRY,
):
    """One kernel call, modelled; returns ``(out, counts, dropped)`` as
    :func:`exchange.bucket_blocks_plain` does."""
    warps, rows, pad_span, window = geometry
    chunk = warps * 32 * rows
    n_blocks, n = lanes[0].shape
    S = n_shards
    lane_np = [lane.numpy().astype(np.int64) for lane in lanes]
    sid_np = None if shard_ids is None else shard_ids.numpy().astype(np.int64)
    ok_np = None if valid is None else valid.numpy()
    chunks = -(-n // chunk)
    pieces = -(-capacity // pad_span) if capacity > 0 else 1
    row_blocks = chunks * n_blocks
    items = row_blocks + pieces * n_blocks * S
    # The kernel's grid: the card's resident blocks, at most one an item
    # (one an item for the launch-index design).
    grid = items if roles == "launch_index" else min(items, blocks)
    n_out = len(lanes) + (1 if flags & POS else 0)
    local = S // peers
    lane_stride = local * n_blocks * capacity
    total = n_out * S * n_blocks * capacity
    out = np.zeros(total, dtype=np.int64)
    written = np.zeros(total, dtype=np.int64)
    counts = np.full((n_blocks, S), -1, dtype=np.int64)
    dropped = np.full(n_blocks, -1, dtype=np.int64)
    words = n_blocks * chunks * S
    if len(work["status"]) < words:  # a grown workspace is zeroed
        work.update(_fresh_work())
        work["status"] = np.zeros(words, dtype=np.uint64)
    status = work["status"]

    def base(s, b):
        peer, d = divmod(s, local)
        return ((peer * n_out * local + d) * n_blocks + b) * capacity

    def write(at, value):
        written[at] += 1
        assert written[at] == 1, "an output position was written twice"
        out[at] = value

    def shard_of(b, i):
        if i >= n or (ok_np is not None and not ok_np[b, i]):
            return -1
        s = int(sid_np[b, i]) if sid_np is not None else int(np.fmod(lane_np[0][b, i], S))
        return s if 0 <= s < S else -1

    def row_block(t, tag):
        b, c = t % n_blocks, t // n_blocks
        i0 = c * chunk
        wc = np.zeros((warps, S), dtype=np.int64)
        rowinfo = []  # (warp, shard, rank in the warp's run, row)
        for w in range(warps):
            for r in range(rows):
                idx = [i0 + w * 32 * rows + r * 32 + lane for lane in range(32)]
                sh = np.array([shard_of(b, i) for i in idx])
                for lane in range(32):
                    s = sh[lane]
                    if s >= 0:
                        rank = wc[w, s] + int((sh[:lane] == s).sum())
                        rowinfo.append((w, s, rank, idx[lane]))
                for s in set(sh[sh >= 0].tolist()):
                    wc[w, s] += int((sh == s).sum())
        yield True
        woff = np.cumsum(wc, axis=0) - wc
        tot = wc.sum(axis=0)
        for s in range(S):
            status[(b * chunks + c) * S + s] = _word(tag, c == 0, int(tot[s]))
        yield True
        pre = np.zeros(S, dtype=np.int64)
        if c > 0:
            top = [c - 1] * S
            acc = [0] * S
            open_shards = set(range(S))
            while open_shards:
                progressed = False
                for s in rng.permutation(sorted(open_shards)).tolist():
                    # A window of earlier chunks' words at once; before
                    # chunk 0, as if a P of 0.
                    ks = [top[s] - j for j in range(window)]
                    words = [int(status[(b * chunks + k) * S + s]) if k >= 0 else P_BIT for k in ks]
                    ready = [k < 0 or (w >> 32) == tag for k, w in zip(ks, words)]
                    stops = [r and bool(w & P_BIT) for r, w in zip(ready, words)]
                    need = stops.index(True) + 1 if any(stops) else window
                    if not all(ready[:need]):
                        continue
                    progressed = True
                    acc[s] += sum(w & COUNT for w in words[:need])
                    if any(stops):
                        pre[s] = acc[s]
                        status[(b * chunks + c) * S + s] = _word(tag, True, acc[s] + int(tot[s]))
                        open_shards.discard(s)
                    else:
                        top[s] -= window
                yield progressed
        if c == chunks - 1:
            incl = pre + tot
            counts[b] = np.minimum(incl, capacity)
            dropped[b] = int(np.maximum(incl - capacity, 0).sum())
        yield True
        coff = np.cumsum(tot) - tot
        placed = int(tot.sum())
        sorted_vals = np.full((n_out, placed), -(1 << 40), dtype=np.int64)
        sorted_shard = np.full(placed, -1, dtype=np.int64)
        for w, s, rank, i in rowinfo:
            pos = coff[s] + woff[w, s] + rank
            assert sorted_shard[pos] == -1, "two rows took one sorted position"
            sorted_shard[pos] = s
            for k in range(len(lanes)):
                v = int(lane_np[k][b, i])
                if k == 0 and flags & DECODE:
                    v = v // S if v >= 0 else -((-v) // S)  # C's truncation
                sorted_vals[k, pos] = v
            if flags & POS:
                sorted_vals[-1, pos] = pos_base + b * n + i
        assert (sorted_shard >= 0).all()
        yield True
        for j in rng.permutation(placed).tolist():  # threads in any order
            s = int(sorted_shard[j])
            rank = pre[s] + j - coff[s]
            if rank < capacity:
                for k in range(n_out):
                    write(base(s, b) + k * lane_stride + rank, sorted_vals[k, j])
        yield True

    def pad_block(p, tag):
        piece, bucket = p % pieces, p // pieces
        s, b = bucket % S, bucket // S
        tot = 0
        if chunks > 0:
            last = (b * chunks + chunks - 1) * S + s
            while True:
                w = int(status[last])
                if (w >> 32) == tag and w & P_BIT:
                    break
                yield False
            tot = w & COUNT
        elif piece == 0:
            counts[b, s] = 0
            if s == 0:
                dropped[b] = 0
        cnt = min(tot, capacity)
        lo, hi = max(piece * pad_span, cnt), min((piece + 1) * pad_span, capacity)
        for r in range(lo, hi):
            for k in range(n_out):
                v = pad0 if k == 0 and flags & DECODE else (pos_pad if flags & POS and k == n_out - 1 else 0)
                write(base(s, b) + k * lane_stride + r, v)
        yield True

    def block(launch_index):
        tag = (work["calls"] + 1) & MASK32
        while True:
            if roles == "ticket":
                t = work["next"]
                work["next"] += 1
            elif roles == "launch_index":  # one item a block, by its index
                t = launch_index if work["next"] <= launch_index else items
                work["next"] = max(work["next"], launch_index + 1)
            else:  # "pad_first": padding tickets before row tickets
                t = (work["next"] + row_blocks) % items if work["next"] < items else items
                work["next"] += 1
            yield True
            if t >= items:
                break
            yield from row_block(t, tag) if t < row_blocks else pad_block(t - row_blocks, tag)
            if roles == "launch_index":
                break
        work["done"] += 1
        if work["done"] == grid:
            calls = work["calls"] + 1
            work.update(next=0, done=0, calls=calls + (1 if ((calls + 1) & MASK32) == 0 else 0))

    launch_order = rng.permutation(grid).tolist()
    live = []
    started = 0
    while started < grid or live:
        options = list(range(len(live)))
        if started < grid and len(live) < resident:
            options.append(-1)
        moved = False
        for pick in rng.permutation(options).tolist():
            if pick == -1:
                live.append(block(launch_order[started]))
                started += 1
                moved = True
                break
            try:
                if next(live[pick]):
                    moved = True
                    break
            except StopIteration:
                live.pop(pick)
                moved = True
                break
        assert moved, "deadlock: every started block waits, and no other can start"
    assert (written == 1).all(), "an output position was never written"
    shape = exchange.bucket_kernel.out_shape(n_out, S, n_blocks, capacity, peers)
    return (
        torch.from_numpy(out.astype(np.int32)).view(shape),
        torch.from_numpy(counts.astype(np.int32)),
        torch.from_numpy(dropped.astype(np.int32)),
    )


def _case(n_blocks, n, n_shards, seed, span=10_000, given_ids=False, mask=True):
    rng = np.random.RandomState(seed)
    keys = rng.randint(-3 if given_ids else 0, span, size=(n_blocks, n)).astype(np.int32)
    vals = rng.randint(-(2**31), 2**31, size=(n_blocks, n), dtype=np.int64).astype(np.int32)
    lanes = [torch.from_numpy(keys), torch.from_numpy(vals)]
    sid = None
    if given_ids:
        sid = torch.from_numpy(rng.randint(-1, n_shards + 1, size=(n_blocks, n)).astype(np.int32))
    ok = torch.from_numpy(rng.rand(n_blocks, n) < 0.85) if mask else None
    return lanes, sid, ok


def _same(got, want):
    for g, w, what in zip(got, want, ("out", "counts", "dropped")):
        assert g.shape == w.shape, what
        assert torch.equal(g, w), f"{what}: {int((g != w).sum())} entries differ"


#: (blocks, rows a block, shards, flags, peers, shard ids given, valid
#: mask, capacity as a share of the true maximum)
MODEL_CASES = {
    "one_shard": (1, 500, 1, 0, 1, False, True, 1.0),
    "ragged_three_shards_ids": (2, 777, 3, 0, 1, True, True, 1.0),
    "eight_shards_under_max": (3, 1000, 8, DECODE | POS, 1, False, True, 0.5),
    "sixty_four_shards_no_mask": (2, 2000, 64, DECODE, 1, False, False, 1.0),
    "four_lanes_of_one_chunk": (1, 192, 5, POS, 1, False, True, 0.7),
    "peer_major": (2, 900, 6, DECODE | POS, 3, False, True, 1.0),
    "peer_major_under_max": (4, 333, 8, DECODE, 4, True, True, 0.4),
    "no_rows": (2, 0, 4, DECODE | POS, 2, False, True, 1.0),
    "one_row": (3, 1, 4, DECODE | POS, 1, False, True, 1.0),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_model_matches_the_plain_version(name, seed):
    n_blocks, n, n_shards, flags, peers, given, mask, share = MODEL_CASES[name]
    lanes, sid, ok = _case(n_blocks, n, n_shards, seed, given_ids=given, mask=mask)
    if name == "four_lanes_of_one_chunk":
        lanes = lanes + [lanes[1] ^ 5, lanes[0] * 3]
    _o, raw, _d = exchange.bucket_blocks_plain(lanes[:1], n_shards, max(1, n), shard_ids=sid, valid=ok)
    capacity = max(1, int(int(raw.max()) * share)) if n else 3
    kw = dict(shard_ids=sid, valid=ok, flags=flags, pad0=-7, pos_base=11, pos_pad=-5, peers=peers)
    want = exchange.bucket_blocks_plain(lanes, n_shards, capacity, **kw)
    rng = np.random.RandomState(100 + seed)
    work = _fresh_work()
    for resident, blocks in ((1, 4), (3, 3), (64, 40)):
        got = _model_bucket(lanes, n_shards, capacity, **kw, work=work, rng=rng, resident=resident, blocks=blocks)
        _same(got, want)
    if share < 1.0:
        assert int(want[2].sum()) > 0


def test_back_to_back_calls_need_no_reset():
    # Three calls on one workspace, each of another shape: the status
    # words of the call before hold an older tag, and are never read as
    # current.  The first call leaves words in every slot the later ones
    # read.
    rng = np.random.RandomState(7)
    work = _fresh_work()
    for n_blocks, n, n_shards in ((2, 3000, 16), (3, 1500, 7), (2, 3000, 16)):
        lanes, sid, ok = _case(n_blocks, n, n_shards, seed=n_shards)
        kw = dict(valid=ok, flags=DECODE, pad0=9)
        want = exchange.bucket_blocks_plain(lanes, n_shards, 120, **kw)
        before = work["calls"]
        _same(_model_bucket(lanes, n_shards, 120, **kw, work=work, rng=rng, resident=5), want)
        assert work["calls"] == before + 1 and work["next"] == work["done"] == 0


def test_sequence_numbers_skip_a_tag_a_zeroed_word_would_match():
    rng = np.random.RandomState(3)
    work = _fresh_work()
    lanes, _sid, ok = _case(1, 400, 4, seed=3)
    want = exchange.bucket_blocks_plain(lanes, 4, 200, valid=ok)
    _model_bucket(lanes, 4, 200, valid=ok, work=work, rng=rng, resident=4)
    work["calls"] = 2**32 - 2  # this call's tag is 2^32 - 1
    _same(_model_bucket(lanes, 4, 200, valid=ok, work=work, rng=rng, resident=4), want)
    assert work["calls"] == 2**32  # the next tag is 1, never 0
    work["status"][:] = 0
    _same(_model_bucket(lanes, 4, 200, valid=ok, work=work, rng=rng, resident=4), want)


@pytest.mark.parametrize("roles", ["launch_index", "pad_first"])
def test_the_model_fails_a_schedule_that_deadlocks(roles):
    # Two wrong designs: a block's chunk taken from its launch index
    # (a block can wait on a chunk that never gets an SM), and padding
    # tickets handed out before row tickets (padding blocks fill every
    # SM and wait on rows no block holds).  One resident block.
    lanes, _sid, ok = _case(2, 1000, 4, seed=1)
    with pytest.raises(AssertionError, match="deadlock"):
        for seed in range(20):
            _model_bucket(lanes, 4, 400, valid=ok, work=_fresh_work(), rng=np.random.RandomState(seed),
                          resident=1, roles=roles)


@pytest.mark.parametrize("case", ["uniform", "skewed", "over_capacity"])
def test_model_through_bucket_by_shard_matches_the_jax_package(case, monkeypatch):
    # The JAX-shaped entry point, its bucketing done by the model.
    rng = np.random.RandomState(5)
    n, n_shards = 1500, 8
    shard_ids = rng.randint(0, n_shards, size=n).astype(np.int32)
    if case == "skewed":
        shard_ids[rng.rand(n) < 0.9] = 3
    values = rng.randn(n, 3).astype(np.float32)
    valid = rng.rand(n) < 0.8
    top = int(np.bincount(shard_ids[valid], minlength=n_shards).max())
    capacity = top // 2 if case == "over_capacity" else top
    work = _fresh_work()
    model_rng = np.random.RandomState(9)

    def modelled(lanes, n_shards, capacity, **kw):
        lanes = [lane.contiguous().view(torch.int32) for lane in lanes]
        return _model_bucket(lanes, n_shards, capacity, **kw, work=work, rng=model_rng, resident=6)

    monkeypatch.setattr(exchange, "bucket_blocks_plain", modelled)
    port = exchange.bucket_by_shard(
        torch.from_numpy(shard_ids), torch.from_numpy(values), torch.from_numpy(valid), n_shards, capacity
    )
    ref = ref_exchange.bucket_by_shard(
        jnp.asarray(shard_ids), jnp.asarray(values), jnp.asarray(valid), n_shards, capacity
    )
    assert work["calls"] == 1
    for p, r in zip(port, ref):
        assert p.shape == np.asarray(r).shape
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    assert (int(port[2]) > 0) == (case == "over_capacity")
