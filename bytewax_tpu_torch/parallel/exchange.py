"""Keyed exchange over the device mesh.

The JAX package buckets each device's rows by target shard with a
stable sort and exchanges the buckets with ``jax.lax.all_to_all`` inside
one compiled step.  Here the bucketing is the hand-written Hopper kernel
``csrc/shard_bucket.cu`` on a CUDA tensor (bound in
:mod:`bytewax_tpu_torch.ops.bucket_kernel`) and the plain PyTorch
version below on a CPU tensor, and the exchange is a device-to-device
copy per (source device, destination device) pair: a view where both
shards share a device.

Across processes (the cluster-wide exchange tier,
``BYTEWAX_TPU_DISTRIBUTED=1``) :func:`exchange_procs` buckets each
process's blocks over every process's shards with the same kernel and
ships each peer its slice with one ``all_to_all_single`` over
``torch.distributed``: NCCL between cards of their own, else gloo,
staged through pinned host memory where the buffers lie on a card
(:class:`bytewax_tpu_torch.parallel.mesh.World`).

Buckets are fixed-capacity; the capacity is a per-step micro-batch
bound, not a global limit — ``engine/sharded_state.py`` sizes it to the
batch's exact per-(source, destination) maximum (over the cluster, for
the cross-process exchange), so its exchanges never drop a row.
"""

from typing import List, Optional, Sequence, Tuple

import torch

from bytewax_tpu_torch.engine import flight as _flight
from bytewax_tpu_torch.ops import bucket_kernel
from bytewax_tpu_torch.ops.bucket_kernel import DECODE, POS
from bytewax_tpu_torch.parallel.mesh import SHARD_AXIS, Mesh, World

__all__ = [
    "DECODE",
    "POS",
    "all_to_all_procs",
    "bucket_blocks",
    "bucket_blocks_plain",
    "bucket_by_shard",
    "exchange_procs",
    "exchange_rows",
    "keyed_all_to_all",
]


def bucket_blocks_plain(
    lanes: Sequence[torch.Tensor],
    n_shards: int,
    capacity: int,
    shard_ids: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    flags: int = 0,
    pad0: int = 0,
    pos_base: int = 0,
    pos_pad: int = 0,
    peers: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the shard-bucketing kernel: the JAX
    package's algorithm (a stable sort by shard, ``bincount``,
    ``cumsum`` and one indexed write), per source block.

    ``lanes`` are ``[blocks, rows]`` tensors of one dtype (int32 with
    :data:`DECODE` or :data:`POS`).  Returns ``(out [n_out, n_shards,
    blocks, capacity], counts [blocks, n_shards], dropped [blocks])``
    with the kernel's layout and semantics (``csrc/shard_bucket.cu``);
    with ``peers`` above 1, ``out`` is peer-major, ``[peers, n_out,
    n_shards // peers, blocks, capacity]``, each peer's destinations one
    contiguous slice.  A row goes to its shard's bucket of its block, in
    row order; rows that are not valid, or whose shard (``shard_ids``,
    else lane 0 modulo ``n_shards``, truncated as in C) lies outside
    ``[0, n_shards)``, go nowhere; rows past the capacity count in
    ``dropped``; empty positions hold 0, ``pad0`` in lane 0 with
    :data:`DECODE` and ``pos_pad`` in the position lane."""
    n_blocks, n = lanes[0].shape
    dev = lanes[0].device
    if shard_ids is None:
        sid = torch.fmod(lanes[0].to(torch.int64), n_shards)
    else:
        sid = shard_ids.to(torch.int64)
    ok = (sid >= 0) & (sid < n_shards)
    if valid is not None:
        ok &= valid
    # Rows that go nowhere take the overflow bin n_shards; block b's
    # bins are b * (n_shards + 1) .. + n_shards.
    bins = n_shards + 1
    block = torch.arange(n_blocks, device=dev, dtype=torch.int64)[:, None]
    flat = (torch.where(ok, sid, n_shards) + block * bins).reshape(-1)
    order = torch.sort(flat, stable=True).indices
    raw = torch.bincount(flat, minlength=n_blocks * bins)
    starts = torch.cumsum(raw, 0) - raw
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(flat.shape[0], device=dev) - starts[flat[order]]
    raw_counts = raw.view(n_blocks, bins)[:, :n_shards]
    counts = raw_counts.clamp(max=capacity)
    dropped = (raw_counts - counts).sum(dim=1)
    keep = ok.reshape(-1) & (rank < capacity)
    n_out = len(lanes) + (1 if flags & POS else 0)
    # Position of (lane 0, shard, block, rank) in the flat output, whose
    # layout is [peer][lane][shard of the peer][block][rank]; lane k is
    # k * lane_stride further on.  Rows that are not kept go to a spare
    # last position.
    local = n_shards // peers
    lane_stride = local * n_blocks * capacity
    total = n_out * n_shards * n_blocks * capacity
    src = block.expand(n_blocks, n).reshape(-1)
    shard = flat - src * bins
    peer = torch.div(shard, local, rounding_mode="floor")
    at = ((peer * n_out * local + (shard - peer * local)) * n_blocks + src) * capacity + rank
    out = torch.zeros(total + 1, dtype=lanes[0].dtype, device=dev)
    view = out[:total].view(peers, n_out, local, n_blocks, capacity)
    if flags & DECODE:
        view[:, 0] = pad0
    if flags & POS:
        view[:, -1] = pos_pad
    for k, lane in enumerate(lanes):
        v = lane.reshape(-1)
        if k == 0 and flags & DECODE:
            v = torch.div(v, n_shards, rounding_mode="trunc")
        out[torch.where(keep, at + k * lane_stride, total)] = v.to(out.dtype)
    if flags & POS:
        dest = torch.where(keep, at + (n_out - 1) * lane_stride, total)
        out[dest] = (pos_base + torch.arange(n_blocks * n, device=dev)).to(out.dtype)
    shape = bucket_kernel.out_shape(n_out, n_shards, n_blocks, capacity, peers)
    return out[:total].view(shape), counts.to(torch.int32), dropped.to(torch.int32)


def bucket_blocks(
    lanes: Sequence[torch.Tensor],
    n_shards: int,
    capacity: int,
    shard_ids: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    flags: int = 0,
    pad0: int = 0,
    pos_base: int = 0,
    pos_pad: int = 0,
    peers: int = 1,
):
    """Bucket ``[blocks, rows]`` lanes by shard: the Hopper kernel on a
    CUDA tensor (int32 lanes), the plain version on a CPU tensor; see
    :func:`bucket_blocks_plain` for the layout and semantics."""
    dev = lanes[0].device
    kwargs = dict(
        shard_ids=shard_ids,
        valid=valid,
        flags=flags,
        pad0=pad0,
        pos_base=pos_base,
        pos_pad=pos_pad,
        peers=peers,
    )
    if dev.type == "cuda":
        return bucket_kernel.bucket(list(lanes), n_shards, capacity, **kwargs)
    if dev.type == "cpu":
        return bucket_blocks_plain(lanes, n_shards, capacity, **kwargs)
    msg = f"the shard bucketing runs on cuda or cpu tensors, not {dev}"
    raise ValueError(msg)


def _as_lanes(values: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``[n, ...]`` rows as ``[1, n]`` lanes, int32 bit patterns on the
    card (the kernel moves 4-byte words), and the ``[n, width]`` view."""
    n = values.shape[0]
    rows = values.reshape(n, -1)
    if rows.device.type == "cuda":
        if rows.element_size() != 4:
            msg = f"the card's bucketing moves 4-byte values, not {values.dtype}"
            raise TypeError(msg)
        rows = rows.contiguous().view(torch.int32)
    return [rows[:, k].unsqueeze(0) for k in range(rows.shape[1])], rows


def bucket_by_shard(
    shard_ids: torch.Tensor,
    values: torch.Tensor,
    valid: torch.Tensor,
    n_shards: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group rows into fixed-capacity per-shard buckets, stably.

    :arg shard_ids: ``[n]`` int32 target shard per row.
    :arg values: ``[n, ...]`` row payloads (4-byte types on the card).
    :arg valid: ``[n]`` bool mask of real (non-padding) rows.
    :arg n_shards: Number of buckets.
    :arg capacity: Rows per bucket.  Rows past a bucket's capacity do
        not fit and are counted in ``dropped``.
    :returns: ``(buckets [n_shards, capacity, ...], counts [n_shards],
        dropped [])``; bucket slots beyond the count are zero.
    """
    lanes, rows = _as_lanes(values)
    out, counts, dropped = bucket_blocks(
        lanes,
        n_shards,
        capacity,
        shard_ids=shard_ids.to(torch.int32).unsqueeze(0),
        valid=valid.to(torch.bool).unsqueeze(0),
    )
    # [width, n_shards, 1, capacity] -> [n_shards, capacity, width]
    buckets = out[:, :, 0, :].permute(1, 2, 0).contiguous()
    if buckets.dtype != values.dtype:
        buckets = buckets.view(values.dtype)
    buckets = buckets.reshape((n_shards, capacity) + tuple(values.shape[1:]))
    return buckets, counts[0], dropped[0]


def _run_rows(blocks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Equal-length 1-D blocks as one ``[blocks, rows]`` tensor: a view
    where they are consecutive slices of one buffer (as the sharded
    states upload them), else a stacked copy."""
    first = blocks[0]
    if len(blocks) == 1:
        return first.unsqueeze(0)
    n = first.shape[0]
    size = first.element_size()
    if first.is_contiguous() and all(
        b.shape == first.shape
        and b.dtype == first.dtype
        and b.is_contiguous()
        and b.untyped_storage().data_ptr() == first.untyped_storage().data_ptr()
        and b.data_ptr() == first.data_ptr() + i * n * size
        for i, b in enumerate(blocks)
    ):
        return torch.as_strided(first, (len(blocks), n), (n, 1))
    return torch.stack(list(blocks))


def exchange_rows(
    mesh: Mesh,
    capacity: int,
    lanes: Sequence[Sequence[torch.Tensor]],
    shard_ids: Optional[Sequence[torch.Tensor]] = None,
    valid: Optional[Sequence[torch.Tensor]] = None,
    flags: int = 0,
    pad0: int = 0,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """Ship rows to their owner shard.

    ``lanes[k][s]`` is lane ``k`` (int32 on the card) of source block
    ``s``, on ``mesh.devices[s]``; every block has the same number of
    rows.  Each run of source blocks on one device is bucketed by one
    call (:func:`bucket_blocks`), then destination ``d`` receives
    ``recv[d] = [n_out, n_sources, capacity]`` on ``mesh.devices[d]``:
    a view of the bucket output where that is one call's on the same
    device, else copied there.  With :data:`POS` a row's position is its
    index over all blocks, and empty positions hold the row count.
    Returns ``(recv, counts, dropped)`` with ``counts`` ``[n_sources,
    n_shards]`` and ``dropped`` ``[n_sources]`` on the first shard's
    device (the bucket call's own outputs where there is one call)."""
    n_shards = mesh.shape[SHARD_AXIS]
    n = lanes[0][0].shape[0]
    outs, counts, drops = [], [], []
    for run in mesh.runs():
        rows = [_run_rows([lane[s] for s in run]) for lane in lanes]
        sid = None if shard_ids is None else _run_rows([shard_ids[s] for s in run])
        ok = None if valid is None else _run_rows([valid[s] for s in run])
        out, cnt, drop = bucket_blocks(
            rows,
            n_shards,
            capacity,
            shard_ids=sid,
            valid=ok,
            flags=flags,
            pad0=pad0,
            pos_base=run.start * n,
            pos_pad=n_shards * n,
        )
        outs.append(out)
        counts.append(cnt)
        drops.append(drop)
    recv = [
        outs[0][:, d]
        if len(outs) == 1 and outs[0].device == dev
        else torch.cat([o[:, d].to(dev) for o in outs], dim=1)
        for d, dev in enumerate(mesh.devices)
    ]
    if len(outs) == 1:
        return recv, counts[0], drops[0]
    first = mesh.devices[0]
    return recv, torch.cat([c.to(first) for c in counts]), torch.cat([x.to(first) for x in drops])


def keyed_all_to_all(
    mesh: Mesh,
    capacity: int,
    shard_ids: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    valid: Sequence[torch.Tensor],
):
    """Exchange rows to their owning shard.

    Source block ``s`` (``shard_ids[s]``, ``values[s]``, ``valid[s]``,
    the same row count each) lies on ``mesh.devices[s]``.  Returns
    three lists, one entry per destination ``d`` on its device: the
    received rows ``[n_shards * capacity, ...]`` (every source's bucket
    ``d`` in source order), their validity mask, and the number of
    valid rows that fit no bucket over the whole mesh (the same on
    every shard) — callers must check it or size ``capacity`` to the
    true maximum."""
    n_shards = mesh.shape[SHARD_AXIS]
    split = [_as_lanes(v) for v in values]
    width = split[0][1].shape[1]
    lanes = [[lanes_s[k][0] for lanes_s, _rows in split] for k in range(width)]
    recv, counts, dropped = exchange_rows(
        mesh,
        capacity,
        lanes,
        shard_ids=[s.to(torch.int32) for s in shard_ids],
        valid=[v.to(torch.bool) for v in valid],
    )
    like = values[0]
    total = dropped.sum()
    got, masks, drops = [], [], []
    for d, dev in enumerate(mesh.devices):
        rows = recv[d].permute(1, 2, 0).reshape(n_shards * capacity, width)
        if rows.dtype != like.dtype:
            rows = rows.contiguous().view(like.dtype)
        got.append(rows.reshape((n_shards * capacity,) + tuple(like.shape[1:])))
        slots = torch.arange(capacity, device=dev)
        masks.append((slots[None, :] < counts[:, d, None].to(dev)).reshape(-1))
        drops.append(total.to(dev))
    return got, masks, drops


def all_to_all_procs(world: World, send: torch.Tensor) -> torch.Tensor:
    """One ``all_to_all_single`` over the cluster's processes with equal
    splits: ``send[q]`` goes to process ``q``, and the result's ``[q]``
    is what process ``q`` sent this one (``send``'s first dimension is
    the process count).  On NCCL the buffers stay on the card; on gloo
    a buffer on a card is copied to pinned host memory and back."""
    import torch.distributed as dist

    if world.transport == "nccl":
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=world.group)
        return recv
    if send.device.type != "cuda":
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        return recv
    host = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
    host.copy_(send)
    back = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
    dist.all_to_all_single(back, host)
    nbytes = host.numel() * host.element_size()
    _flight.note_transfer("d2h", nbytes)
    _flight.note_transfer("h2d", nbytes)
    return back.to(send.device, non_blocking=True)


def exchange_procs(
    mesh: Mesh,
    world: World,
    capacity: int,
    lanes: Sequence[Sequence[torch.Tensor]],
    valid: Sequence[torch.Tensor],
    flags: int = 0,
    pad0: int = 0,
) -> List[torch.Tensor]:
    """Ship rows to their owner shard over every process's shards.

    ``mesh`` is this process's shards; global shard ``g`` sits on
    process ``g // L`` (``L`` shards a process, the same on each).
    ``lanes[k][s]`` is lane ``k`` of local source block ``s`` and
    ``valid[s]`` its mask, as for :func:`exchange_rows`; a row's owner
    is lane 0 modulo the global shard count.  Each run of blocks on
    one device is bucketed by one kernel call over all ``P * L``
    shards, which lays the buckets out peer-major (each peer's
    destinations one contiguous slice), and one :func:`all_to_all_procs`
    ships that buffer as it is.  Returns, for each local shard ``d``, ``[n_out, P * L,
    capacity]`` on ``mesh.devices[d]``: every global source block's
    bucket ``d``, in process order.  Every process must call this with
    the same ``capacity`` and block length: the splits are equal."""
    n_local = mesh.shape[SHARD_AXIS]
    procs = world.proc_count
    n_shards = procs * n_local
    outs = []
    for run in mesh.runs():
        rows = [_run_rows([lane[s] for s in run]) for lane in lanes]
        ok = _run_rows([valid[s] for s in run])
        out, _counts, _dropped = bucket_blocks(
            rows, n_shards, capacity, valid=ok, flags=flags, pad0=pad0, peers=procs
        )
        outs.append(out)
    home = mesh.devices[0]
    # [peer, lane, dst of the peer, src, cap], the runs' sources joined.
    send = outs[0] if len(outs) == 1 else torch.cat([o.to(home) for o in outs], dim=3)
    n_out = send.shape[1]
    recv = all_to_all_procs(world, send)
    got = []
    for d, dev in enumerate(mesh.devices):
        rows = recv[:, :, d].transpose(0, 1).reshape(n_out, n_shards, capacity)
        got.append(rows if rows.device == dev else rows.to(dev))
    return got
