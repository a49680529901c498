"""Device kernels for keyed aggregation.

Per-key aggregation state lives in device tensors indexed by a
host-assigned slot id, and a whole micro-batch of ``(slot, value)``
rows folds into every field of an :class:`AggKind` in one call.  The
last slot of every table is scratch: rows aimed at it (padding, ids
the vocabulary does not know) fold nothing.

Each entry point has two implementations of the same function:

- on a CUDA tensor, the hand-written Hopper kernel
  ``csrc/segment_fold.cu`` (bound in :mod:`bytewax_tpu_torch.ops.fold_kernel`);
- on a CPU tensor, the plain PyTorch version below (``index_add_``
  and ``scatter_reduce_``), which the tests hold against the JAX
  package and against which the kernel is held on the card.

State folds in place: the entry points return the same dict they were
given.
"""

from typing import Dict, Tuple

import torch

__all__ = [
    "AGG_KINDS",
    "AggKind",
    "combine_stats",
    "dequantize",
    "fold_plain",
    "identity_for",
    "init_fields",
    "slots_of",
    "update_fields",
    "update_fields_packed",
    "update_fields_vocab",
]


class AggKind:
    """Declarative reduction: named state fields, how a batch folds
    into them, and how a final value is read out.

    ``fields`` maps field name to ``(init_value, scatter_op)`` where
    scatter_op is one of ``"add" | "min" | "max"``.
    """

    def __init__(self, name: str, fields: Dict[str, Tuple[float, str]]):
        self.name = name
        self.fields = fields

    def __repr__(self) -> str:
        return f"AggKind({self.name!r})"


AGG_KINDS: Dict[str, AggKind] = {
    "sum": AggKind("sum", {"sum": (0.0, "add")}),
    "count": AggKind("count", {"count": (0.0, "add")}),
    "min": AggKind("min", {"min": (float("inf"), "min")}),
    "max": AggKind("max", {"max": (float("-inf"), "max")}),
    "mean": AggKind("mean", {"sum": (0.0, "add"), "count": (0.0, "add")}),
    # 1BRC-style: min/mean/max in one pass.
    "stats": AggKind(
        "stats",
        {
            "min": (float("inf"), "min"),
            "max": (float("-inf"), "max"),
            "sum": (0.0, "add"),
            "count": (0.0, "add"),
        },
    ),
}


def identity_for(init: float, dtype: torch.dtype):
    """The fold identity as a Python scalar of the accumulator dtype
    (±inf saturates to the integer min/max for integer dtypes)."""
    if dtype.is_floating_point:
        return float(init)
    info = torch.iinfo(dtype)
    if init == float("inf"):
        return info.max
    if init == float("-inf"):
        return info.min
    return int(init)


def init_fields(
    kind: AggKind, capacity: int, dtype=torch.float32, device="cpu"
) -> Dict[str, torch.Tensor]:
    """Fresh state tensors for ``capacity`` slots."""
    return {
        name: torch.full(
            (capacity,), identity_for(init, dtype), dtype=dtype, device=device
        )
        for name, (init, _op) in kind.fields.items()
    }


def slots_of(ext_to_slot: torch.Tensor, ext_ids: torch.Tensor) -> torch.Tensor:
    """Gather slots for external ids the way the JAX package's gather
    does: negative ids count from the end, the rest clamp into the
    table."""
    n = ext_to_slot.shape[0]
    ids = ext_ids.long()
    ids = torch.where(ids < 0, ids + n, ids).clamp_(0, n - 1)
    return ext_to_slot[ids]


def fold_plain(
    kind: AggKind,
    state: Dict[str, torch.Tensor],
    slot_ids: torch.Tensor,
    values: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """The plain PyTorch fold of ``(slot, value)`` rows into every
    field of ``kind``, in place.

    Rows whose slot is the scratch slot ``capacity - 1`` (or lies
    outside the table) are masked to the fold identity, as the JAX
    package's ``update_fields`` masks them, so the scratch slot keeps
    its value.
    """
    capacity = next(iter(state.values())).shape[0]
    slots = slot_ids.long()
    valid = (slots >= 0) & (slots < capacity - 1)
    idx = torch.where(valid, slots, capacity - 1)
    for name, (init, op_name) in kind.fields.items():
        arr = state[name]
        if name == "count":
            contrib = valid.to(arr.dtype)
        else:
            contrib = values.to(arr.dtype)
        if op_name == "add":
            arr.index_add_(0, idx, torch.where(valid, contrib, 0))
        elif op_name in ("min", "max"):
            ident = identity_for(init, arr.dtype)
            arr.scatter_reduce_(
                0,
                idx,
                torch.where(valid, contrib, ident),
                "amin" if op_name == "min" else "amax",
                include_self=True,
            )
        else:  # pragma: no cover
            msg = f"unknown scatter op {op_name!r}"
            raise ValueError(msg)
    return state


def _on_card(state: Dict[str, torch.Tensor]) -> bool:
    """True for CUDA state (the kernel), False for CPU state (the
    plain version); any other device raises."""
    dev = next(iter(state.values())).device
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    msg = f"the segment fold runs on cuda or cpu tensors, not {dev}"
    raise ValueError(msg)


def update_fields(
    kind: AggKind,
    state: Dict[str, torch.Tensor],
    slot_ids: torch.Tensor,
    values: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Fold a micro-batch of ``(slot, value)`` rows into the state.

    Padding rows carry ``slot_id == capacity - 1`` (the reserved
    scratch slot) and fold nothing."""
    if _on_card(state):
        from bytewax_tpu_torch.ops import fold_kernel

        dtype = next(iter(state.values())).dtype
        fold_kernel.fold(
            kind,
            state,
            fold_kernel.SRC_SLOT,
            slot_ids.to(torch.int32),
            values.to(dtype),
        )
        return state
    return fold_plain(kind, state, slot_ids, values)


def update_fields_vocab(
    kind: AggKind,
    state: Dict[str, torch.Tensor],
    ext_to_slot: torch.Tensor,
    ext_ids: torch.Tensor,
    values: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Dictionary-encoded fold: rows carry external vocabulary ids
    (int16 or int32); the id→slot mapping lives on the device so the
    host ships only the raw ``(id, value)`` columns.  Ids mapping to
    the scratch slot (unseen ids, the padding sentinel) fold
    nothing."""
    if _on_card(state):
        from bytewax_tpu_torch.ops import fold_kernel

        dtype = next(iter(state.values())).dtype
        source = (
            fold_kernel.SRC_EXT16
            if ext_ids.dtype == torch.int16
            else fold_kernel.SRC_EXT32
        )
        fold_kernel.fold(
            kind,
            state,
            source,
            ext_ids,
            values.to(dtype),
            ext_to_slot=ext_to_slot,
        )
        return state
    return fold_plain(kind, state, slots_of(ext_to_slot, ext_ids), values)


def dequantize(packed: torch.Tensor, scale: float) -> torch.Tensor:
    """Row 1 of a packed ``[2, n]`` int16 batch times the float32
    ``scale``, in float32."""
    return packed[1].to(torch.float32) * torch.tensor(
        scale, dtype=torch.float32, device=packed.device
    )


def update_fields_packed(
    kind: AggKind,
    state: Dict[str, torch.Tensor],
    ext_to_slot: torch.Tensor,
    packed: torch.Tensor,
    scale: float,
) -> Dict[str, torch.Tensor]:
    """Quantized single-transfer fold: ``packed`` is ``[2, n]`` int16
    with row 0 the external ids and row 1 the quantized values
    (``value = float32(packed[1]) * float32(scale)``).  Halves
    host→device bytes for fixed-point data (e.g. 1BRC deci-degree
    temperatures)."""
    if _on_card(state):
        from bytewax_tpu_torch.ops import fold_kernel

        fold_kernel.fold(
            kind,
            state,
            fold_kernel.SRC_PACKED,
            packed,
            None,
            ext_to_slot=ext_to_slot,
            scale=scale,
        )
        return state
    return fold_plain(
        kind, state, slots_of(ext_to_slot, packed[0]), dequantize(packed, scale)
    )


def combine_stats(
    kind: AggKind,
    state: Dict[str, torch.Tensor],
    other: Dict[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """Merge two state dicts field-wise (for shard rebalancing and
    snapshot merging)."""
    out = {}
    for name, (_init, op_name) in kind.fields.items():
        if op_name == "add":
            out[name] = state[name] + other[name]
        elif op_name == "min":
            out[name] = torch.minimum(state[name], other[name])
        else:
            out[name] = torch.maximum(state[name], other[name])
    return out
