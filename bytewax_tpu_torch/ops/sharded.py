"""The sharded streaming step: keyed exchange + scatter-combine over a
device mesh.

A micro-batch of ``(key_id, value)`` rows, cut into one source block a
shard, is exchanged so each shard receives the rows whose keys it owns
(``key_id % n_shards``), then folded into that shard's block of the
key-sharded state table.  Three hand-written Hopper kernels do the work
on the card: ``csrc/shard_bucket.cu`` buckets the rows by owner
(:mod:`bytewax_tpu_torch.parallel.exchange`), and each shard's block
folds through ``csrc/segment_fold.cu`` (:mod:`bytewax_tpu_torch.ops.segment`)
or scans through ``csrc/segment_scan.cu`` (:mod:`bytewax_tpu_torch.ops.scan`).
On CPU tensors each runs its plain PyTorch version.  Across processes
(:func:`make_global_step`) the same kernels run around one all-to-all
over ``torch.distributed``.

The JAX package compiles each step as one ``shard_map`` program and
keeps every shape static for XLA; here a step is a Python function over
per-shard tensors, built per call (nothing is cached by shape), and the
scan runs over exactly the rows each shard received where the caller
knows their number.  State updates in place.
"""

from typing import Dict, List, Optional, Sequence

import torch

from bytewax_tpu_torch.ops.segment import AGG_KINDS, AggKind, init_fields, update_fields
from bytewax_tpu_torch.parallel.exchange import DECODE, POS, exchange_procs, exchange_rows
from bytewax_tpu_torch.parallel.mesh import SHARD_AXIS, Mesh, World

__all__ = [
    "init_sharded_fields",
    "make_global_step",
    "init_sharded_scan_fields",
    "make_sharded_scan_step",
    "make_sharded_step",
]

Blocks = List[Dict[str, torch.Tensor]]


def init_sharded_fields(
    kind: AggKind, mesh: Mesh, cap_per_shard: int, dtype=torch.float32
) -> Blocks:
    """State table sharded over the mesh: one block of
    ``cap_per_shard`` slots a shard, block ``d`` on ``mesh.devices[d]``
    (its last slot is scratch)."""
    return [init_fields(kind, cap_per_shard, dtype, dev) for dev in mesh.devices]


def _bits(values: Sequence[torch.Tensor], dtype) -> List[torch.Tensor]:
    """Value blocks as int32 lanes: int32 as they are, float32 bitcast
    (a float lane would round key ids above 2^24, and the exchange must
    not touch the values' bits)."""
    if dtype == torch.int32:
        return [v.to(torch.int32) for v in values]
    return [v.to(torch.float32).view(torch.int32) for v in values]


def make_sharded_step(
    mesh: Mesh,
    kind_name: str,
    cap_per_shard: int,
    exchange_capacity: int,
    dtype=torch.float32,
):
    """Build the sharded update step.

    Returned ``step(fields, key_ids, values, valid) -> fields`` takes
    per-shard lists: ``fields`` from :func:`init_sharded_fields`, and
    source block ``s`` of the rows (``key_ids[s]`` int32,
    ``values[s]``, ``valid[s]`` bool, the same length each) on
    ``mesh.devices[s]``.  Key ownership is ``key_id % n_shards``; a
    key's slot within its owner is ``key_id // n_shards``; the scratch
    slot is the block's last, where the bucketing kernel aims every
    empty position, so it folds nothing.

    ``exchange_capacity`` is the per-(source, destination) bucket size;
    the caller must size it to the batch's true per-bucket maximum (see
    ``engine/sharded_state.py``, which computes it exactly per
    micro-batch): rows beyond it would be dropped.

    ``dtype`` is the accumulator dtype: float32 values ride the
    exchange bitcast to int32, int32 values ride as they are and fold
    exactly.
    """
    kind = AGG_KINDS[kind_name]
    n_shards = mesh.shape[SHARD_AXIS]

    def step(fields: Blocks, key_ids, values, valid) -> Blocks:
        recv, _counts, _dropped = exchange_rows(
            mesh,
            exchange_capacity,
            [[k.to(torch.int32) for k in key_ids], _bits(values, dtype)],
            valid=valid,
            flags=DECODE,
            pad0=cap_per_shard - 1,
        )
        for d in range(n_shards):
            vals = recv[d][1].reshape(-1)
            if dtype != torch.int32:
                vals = vals.view(torch.float32)
            update_fields(kind, fields[d], recv[d][0].reshape(-1), vals)
        return fields

    return step


def make_global_step(
    mesh: Mesh,
    world: World,
    kind_name: str,
    cap_per_shard: int,
    exchange_capacity: int,
    dtype=torch.float32,
):
    """Build the cluster-wide counterpart of :func:`make_sharded_step`:
    the same ``step(fields, key_ids, values, valid) -> fields`` over
    this process's shards (``mesh``), with key ownership ``key_id %
    (P * L)`` over every process's ``L`` shards.  The rows cross
    processes in one all-to-all
    (:func:`bytewax_tpu_torch.parallel.exchange.exchange_procs`), then
    each local shard folds what it received through
    ``csrc/segment_fold.cu`` (scratch rows aim at its last slot and fold
    nothing).  Every process runs the step at the same points with the
    same block length and ``exchange_capacity``."""
    kind = AGG_KINDS[kind_name]
    n_local = mesh.shape[SHARD_AXIS]

    def step(fields: Blocks, key_ids, values, valid) -> Blocks:
        recv = exchange_procs(
            mesh,
            world,
            exchange_capacity,
            [[k.to(torch.int32) for k in key_ids], _bits(values, dtype)],
            valid,
            flags=DECODE,
            pad0=cap_per_shard - 1,
        )
        for d in range(n_local):
            vals = recv[d][1].reshape(-1)
            if dtype != torch.int32:
                vals = vals.view(torch.float32)
            update_fields(kind, fields[d], recv[d][0].reshape(-1), vals)
        return fields

    return step


def init_sharded_scan_fields(scan_kind, mesh: Mesh, cap_per_shard: int) -> Blocks:
    """Scan-state table sharded over the mesh, one column per
    :class:`~bytewax_tpu_torch.ops.scan.ScanKind` field (each with its
    own dtype and identity): one block of ``cap_per_shard`` slots a
    shard, block ``d`` on ``mesh.devices[d]``."""
    return [
        {
            name: torch.full((cap_per_shard,), init, dtype=dtype, device=dev)
            for name, (init, dtype) in scan_kind.fields.items()
        }
        for dev in mesh.devices
    ]


def _lane_encode(col: torch.Tensor) -> torch.Tensor:
    """Encode an output column as an int32 lane (floats bitcast so the
    trip home can't round them; bools and ints widen or narrow)."""
    if col.dtype == torch.bool or not col.dtype.is_floating_point:
        return col.to(torch.int32)
    return col.to(torch.float32).view(torch.int32)


def _lane_decode(lane: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bool or not dtype.is_floating_point:
        return lane.to(dtype)
    return lane.view(torch.float32).to(dtype)


def make_sharded_scan_step(
    mesh: Mesh,
    scan_kind,
    cap_per_shard: int,
    exchange_capacity: int,
):
    """Build the sharded *scan* step: keyed exchange + segmented per-key
    scan + per-row outputs written home.

    Where :func:`make_sharded_step` folds rows into state and returns
    only the state, a scan also emits one output tuple per ROW
    (``stateful_map`` semantics), so the step makes a round trip: rows
    ship to their owner shard (``key_id % n_shards``) carrying their
    position, each shard sorts its received rows by slot (a stable
    sort, so a key's rows keep arrival order across source blocks) and
    runs the kind's segmented scan over its block (``scan_kind.run``),
    and each output is written to its row's position on the first
    shard's device.

    Returned ``step(fields, key_ids, values, valid, recv_rows=None) ->
    (outs, fields)`` takes the per-shard lists of
    :func:`make_sharded_step`; ``outs`` are columns over every row of
    every source block, in block order.  ``recv_rows[d]``, where given,
    is the number of valid rows shard ``d`` receives (the sharded state
    knows it from its sizing): the scan then runs over those rows only,
    which the sort puts first; without it, the empty positions (all on
    the scratch slot, which sorts last) are scanned too, as in JAX.
    Output columns travel as 32-bit lanes: float64 outputs narrow to
    float32 and integers to int32 on the trip home.
    """
    n_shards = mesh.shape[SHARD_AXIS]
    home = mesh.devices[0]

    def step(fields: Blocks, key_ids, values, valid, recv_rows: Optional[Sequence[int]] = None):
        total = n_shards * key_ids[0].shape[0]
        recv, _counts, _dropped = exchange_rows(
            mesh,
            exchange_capacity,
            [[k.to(torch.int32) for k in key_ids], _bits(values, torch.float32)],
            valid=valid,
            flags=DECODE | POS,
            pad0=cap_per_shard - 1,
        )
        buf = None
        dtypes = None
        for d in range(n_shards):
            slots = recv[d][0].reshape(-1)
            order = torch.sort(slots, stable=True).indices
            if recv_rows is not None:
                order = order[: recv_rows[d]]
            if order.shape[0] == 0:
                continue
            vals = recv[d][1].reshape(-1).view(torch.float32)
            outs, fields[d] = scan_kind.run(fields[d], slots[order], vals[order])
            if buf is None:
                dtypes = [o.dtype for o in outs]
                buf = torch.zeros((len(outs), total + 1), dtype=torch.int32, device=home)
            lanes = torch.stack([_lane_encode(o) for o in outs])
            pos = recv[d][2].reshape(-1)[order]
            buf[:, pos.to(home)] = lanes.to(home)
        if buf is None:
            return (), fields
        return tuple(_lane_decode(buf[j, :total], dt) for j, dt in enumerate(dtypes)), fields

    return step
