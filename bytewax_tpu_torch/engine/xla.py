"""Device-resident keyed aggregation state.

Replaces per-key Python logic objects with slot-table device tensors
for the recognized reduction kinds (see
:mod:`bytewax_tpu_torch.ops.segment`).  The host keeps the key→slot
vocabulary; values fold in on the device; snapshots copy back only
when a drain point asks, preserving the recovery contract of the host
tier (states are interchangeable between tiers, and with the JAX
package's device tier).

Every host→device copy casts explicitly to the accumulator dtype
(int32 or float32): the JAX package runs with 64-bit types off, so
its transfers narrow silently, and the port narrows the same way.
"""

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bytewax_tpu_torch.engine import flight as _flight
from bytewax_tpu_torch.engine.arrays import ArrayBatch, KeyEncoder, VocabMaps
from bytewax_tpu_torch.ops.segment import (
    AGG_KINDS,
    identity_for,
    init_fields,
    update_fields,
    update_fields_packed,
    update_fields_vocab,
)

__all__ = [
    "AccelSpec",
    "DeviceAggState",
    "NonNumericValues",
    "MergeRound",
    "agg_merge",
    "agg_merge_plain",
    "agg_merge_round",
    "agg_merge_round_plain",
    "agg_merge_table",
    "load_fields",
    "pack_merge_round",
]

_MIN_CAPACITY = 1024

#: Accumulator dtypes and their host (numpy) carriers.
_NP_OF = {torch.float32: np.float32, torch.int32: np.int32}


class NonNumericValues(TypeError):
    """Values are not device-foldable; the caller should fall back to
    the host tier (distinct from malformed-batch errors, which must
    surface)."""


class AccelSpec:
    """Annotation on a core ``stateful_batch`` op: lower it to a
    device aggregation of this kind instead of per-key Python logics."""

    def __init__(self, kind: str):
        if kind not in AGG_KINDS:
            msg = f"unknown aggregation kind {kind!r}"
            raise ValueError(msg)
        self.kind = kind

    def __repr__(self) -> str:
        return f"AccelSpec({self.kind!r})"


def _final_of(kind: str, fields: Dict[str, np.ndarray], i: int):
    if kind == "sum":
        return fields["sum"][i].item()
    if kind == "count":
        return int(fields["count"][i].item())
    if kind == "min":
        return fields["min"][i].item()
    if kind == "max":
        return fields["max"][i].item()
    if kind == "mean":
        count = fields["count"][i].item()
        return fields["sum"][i].item() / count if count else 0.0
    if kind == "stats":
        count = fields["count"][i].item()
        mean = fields["sum"][i].item() / count if count else 0.0
        return (
            fields["min"][i].item(),
            mean,
            fields["max"][i].item(),
            int(count),
        )
    raise AssertionError(kind)


def _snaps_of(
    kind: str, fields: Dict[str, np.ndarray], idx: np.ndarray
) -> List[Any]:
    """Host-format snapshots of the slots ``idx``: one gather a
    field."""
    # Single-field kinds snapshot the bare scalar so host-tier logics
    # can resume from device snapshots and vice versa.
    if kind in ("sum", "min", "max"):
        return fields[next(iter(fields))][idx].tolist()
    count = fields["count"][idx].astype(np.int64).tolist()
    if kind == "count":
        return count
    if kind == "mean":
        return list(zip(fields["sum"][idx].tolist(), count))
    if kind == "stats":
        return list(
            zip(
                fields["min"][idx].tolist(),
                fields["max"][idx].tolist(),
                fields["sum"][idx].tolist(),
                count,
            )
        )
    raise AssertionError(kind)


def _zip_held(
    keys: List[str],
    ids: List[Optional[int]],
    snapshot_ids: Callable[[np.ndarray], List[Any]],
) -> List[Tuple[str, Any]]:
    """``(key, snapshot)`` of each key, None where its id is None."""
    held = [i for i, at in enumerate(ids) if at is not None]
    snaps: List[Any] = [None] * len(keys)
    if held:
        got = snapshot_ids(np.array([ids[i] for i in held], dtype=np.int64))
        for i, snap in zip(held, got):
            snaps[i] = snap
    return list(zip(keys, snaps))


class DeviceAggState:
    """Slot-table aggregation state for one stateful step, on
    ``device`` (default: the device :func:`bytewax_tpu_torch.utils.device`
    selects).

    The last slot of the table is scratch for rows that fold nothing;
    keys occupy slots ``0..capacity-2``.  Tables double when full.
    Folds update the state tensors in place.
    """

    def __init__(self, kind: str, device: Optional[torch.device] = None):
        if device is None:
            from bytewax_tpu_torch.utils import device as _device

            device = _device()
        self.kind_name = kind
        self.kind = AGG_KINDS[kind]
        self.device = torch.device(device)
        self.capacity = _MIN_CAPACITY
        self.key_to_slot: Dict[str, int] = {}
        self.slot_keys: List[Optional[str]] = []
        self._free: List[int] = []
        self._pending_reset: List[int] = []
        self.dtype = torch.float32
        self._fields: Optional[Dict[str, torch.Tensor]] = None
        # Dictionary-encoded fast path: external id -> slot table,
        # mirrored on device so raw (id, value) columns are all the
        # host ships per batch; one table per vocabulary lineage (this
        # process's and each peer's, engine/arrays.py PeerVocab).
        self._vocab = VocabMaps(dtype=np.int32)
        self._dev_maps: Dict[Optional[int], torch.Tensor] = {}
        # Automatic encoder for plain string key columns: steady
        # state is one searchsorted per batch, no per-row hashing.
        self._enc = KeyEncoder()
        # One-pass itemized promotion (native kv_encode): dense ids
        # assigned in first-sight order, mapped to slots via one
        # gather per batch.
        self._iddict: Dict[str, int] = {}
        self._id_keys: List[str] = []
        self._id_to_slot = np.empty(0, dtype=np.int32)

    def _to_device(self, arr: np.ndarray, dtype) -> torch.Tensor:
        """Copy a host array to the device in exactly ``dtype``.  A
        blocking copy of a private host buffer: the caller may reuse
        ``arr`` as soon as this returns.  The flight recorder's span
        ``dispatch_copy``."""
        with _flight.span("dispatch_copy"):
            host = np.require(arr, dtype=dtype, requirements=("C", "W"))
            return torch.from_numpy(host).to(self.device)

    # -- slot management ---------------------------------------------------

    def _ensure_fields(self) -> None:
        if self._fields is None:
            self._fields = init_fields(
                self.kind, self.capacity, self.dtype, self.device
            )
            self._pending_reset.clear()
        else:
            self._apply_resets()

    def _grow_to(self, needed: int) -> None:
        new_cap = self.capacity
        while new_cap - 1 < needed:
            new_cap *= 2
        if new_cap == self.capacity:
            return
        # The scratch slot moves to the new last index; any device
        # id→slot table pointing at the old scratch is stale.
        self._dev_maps.clear()
        self._ensure_fields()
        grown = {}
        for name, (init, _op) in self.kind.fields.items():
            old = self._fields[name]
            ident = identity_for(init, old.dtype)
            # The old scratch slot becomes a real slot: clear it.
            old[self.capacity - 1] = ident
            pad = torch.full(
                (new_cap - self.capacity,),
                ident,
                dtype=old.dtype,
                device=self.device,
            )
            grown[name] = torch.cat([old, pad])
        self._fields = grown
        self.capacity = new_cap

    def alloc(self, key: str) -> int:
        """Assign (or return) the slot for a key, reusing freed slots."""
        slot = self.key_to_slot.get(key)
        if slot is not None:
            return slot
        if self._free:
            slot = self._free.pop()
            self._pending_reset.append(slot)
            self.slot_keys[slot] = key
        else:
            self._grow_to(len(self.slot_keys) + 2)
            slot = len(self.slot_keys)
            self.slot_keys.append(key)
        self.key_to_slot[key] = slot
        return slot

    def discard(self, key: str) -> None:
        """Release a key's slot for reuse (its state is reset when the
        slot is reallocated)."""
        slot = self._release(key)
        if slot is not None and self._vocab.drop_ids([slot]):
            # The on-device id→slot table still routes the dropped
            # external id to this (now reusable) slot; rebuild it
            # on the next vocab sync.
            self._dev_maps.clear()

    def _release(self, key: str) -> Optional[int]:
        """Free a key's slot WITHOUT the vocab drop (extract_keys
        batches that into one pass); returns the freed slot."""
        slot = self.key_to_slot.pop(key, None)
        if slot is not None:
            self.slot_keys[slot] = None  # type: ignore[call-overload]
            self._free.append(slot)
            self._enc.drop(key)
            self._forget_itemized()
        return slot

    def _forget_itemized(self) -> None:
        if self._iddict:
            # Dense ids must stay collision-free (kv_encode assigns
            # len(dict)), so a discard invalidates the itemized cache
            # wholesale; keys re-intern to their existing slots on the
            # next batch.
            self._iddict = {}
            self._id_keys = []
            self._id_to_slot = np.empty(0, dtype=np.int32)

    def _apply_resets(self) -> None:
        if self._fields is None:
            self._pending_reset.clear()
            return
        if not self._pending_reset:
            return
        slots = self._to_device(np.asarray(self._pending_reset), np.int64)
        for name, (init, _op) in self.kind.fields.items():
            arr = self._fields[name]
            arr.index_fill_(0, slots, identity_for(init, arr.dtype))
        self._pending_reset.clear()

    def update_slots(self, slot_ids: np.ndarray, values: np.ndarray) -> None:
        """Fold rows into pre-allocated slots (fast path for callers
        managing their own key→slot mapping via :meth:`alloc`)."""
        values = self._pick_dtype(values)
        self._ensure_fields()
        self._scatter(slot_ids, values)

    # The id-based fold surface: ids are whatever :meth:`alloc`
    # returned.
    update_ids = update_slots

    # -- updates -----------------------------------------------------------

    def _pick_dtype(self, values: np.ndarray) -> np.ndarray:
        """Choose the accumulator dtype; integer inputs that don't fit
        32 bits fall back to the exact host tier.  Per-key integer
        sums exceeding 2^31 are out of scope for the device tier —
        use a plain Python reducer for bigint arithmetic."""
        if np.issubdtype(values.dtype, np.integer):
            if values.dtype.itemsize > 4:
                if len(values) and (
                    values.max() > np.iinfo(np.int32).max
                    or values.min() < np.iinfo(np.int32).min
                ):
                    msg = (
                        "device-accelerated reduction over integers "
                        "wider than 32 bits is not exact; pass a plain "
                        "Python reducer"
                    )
                    raise NonNumericValues(msg)
                values = values.astype(np.int32)
            if self._fields is None:
                self.dtype = torch.int32
        elif self.dtype == torch.int32 and len(values):
            # A float batch after the accumulator locked to int32
            # would otherwise be silently truncated by the host-side
            # cast into the int32 carrier.  Integral in-range floats
            # (e.g. the count path's ones after resuming an int
            # snapshot) cast losslessly and pass through.
            if (
                np.any(values % 1)
                or values.max() > np.iinfo(np.int32).max
                or values.min() < np.iinfo(np.int32).min
            ):
                msg = (
                    "non-integral float values arrived after earlier "
                    "batches locked this step's device state to an "
                    "integer dtype; pass a plain Python reducer for "
                    "mixed int/float streams"
                )
                raise TypeError(msg)
        return values

    def update_items(self, items: List[Any]):
        """One-pass itemized fast path: native ``kv_encode`` walks
        each ``(key, value)`` tuple exactly once (dict-encode + value
        fill), then one gather maps dense ids to slots and one
        kernel launch folds the batch.  Returns the touched keys, or
        None when the native module is unavailable (caller falls
        back).  Raises :class:`NonNumericValues` for rows the device
        tier can't take, with no state mutated."""
        from bytewax_tpu_torch.native import kv_encode as _kv_encode

        n = len(items)
        ids = np.empty(n, dtype=np.int32)
        vals = np.empty(n, dtype=np.float64)
        ivals = np.empty(n, dtype=np.int64)
        try:
            with _flight.span("dispatch_vocab"):
                res = _kv_encode(items, self._iddict, ids, vals, ivals)
        except TypeError as ex:
            raise NonNumericValues(str(ex)) from ex
        if res is None:
            return None
        new_keys, all_int = res
        if all_int:
            # Preserve the exact-integer accumulator the per-item
            # path would have picked: the int64 lane is filled
            # directly by the C pass (a float64 round-trip would
            # round integers past 2^53).
            vals = ivals
        try:
            vals = self._pick_dtype(vals)
        except (NonNumericValues, TypeError):
            # Undo the C pass's id assignments so a host fallback
            # (or any caller that survives the error) sees a
            # genuinely untouched state.
            for k in new_keys:
                self._iddict.pop(k, None)
            raise
        if new_keys:
            self._id_keys.extend(new_keys)
            self._id_to_slot = np.concatenate(
                [
                    self._id_to_slot,
                    np.fromiter(
                        (self.alloc(k) for k in new_keys),
                        dtype=np.int32,
                        count=len(new_keys),
                    ),
                ]
            )
        self._ensure_fields()
        self._scatter(self._id_to_slot[ids], vals)
        with _flight.span("dispatch_vocab"):
            counts = np.bincount(ids, minlength=len(self._id_keys))
            return [
                self._id_keys[i] for i in np.nonzero(counts)[0].tolist()
            ]

    def update(self, keys: np.ndarray, values: np.ndarray) -> List[str]:
        """Fold ``(key, value)`` rows in; returns the unique keys
        touched (for epoch snapshot bookkeeping)."""
        keys = np.asarray(keys)
        values = np.asarray(values)
        if values.dtype == object or values.dtype.kind in "US":
            msg = (
                "device-accelerated reduction requires numeric values; "
                "pass a plain Python reducer for non-numeric data"
            )
            raise NonNumericValues(msg)
        values = self._pick_dtype(values)
        with _flight.span("dispatch_vocab"):
            row_slots = self._enc.encode(
                keys, lambda ks: [self.alloc(k) for k in ks]
            )
        self._ensure_fields()
        self._scatter(row_slots, values)
        with _flight.span("dispatch_vocab"):
            return [
                self.slot_keys[s] for s in np.unique(row_slots).tolist()
            ]

    def _scatter(self, slot_ids: np.ndarray, values: np.ndarray) -> None:
        slots = self._to_device(slot_ids, np.int32)
        vals = self._to_device(values, _NP_OF[self.dtype])
        _flight.note_transfer("h2d", slots.nbytes + vals.nbytes)
        update_fields(self.kind, self._fields, slots, vals)

    def _fetch(self) -> Dict[str, np.ndarray]:
        """One stacked device→host copy for all fields (blocking: it
        waits for every fold queued before it)."""
        names = list(self.kind.fields)
        stacked = torch.stack([self._fields[name] for name in names])
        host = stacked.cpu().numpy()
        _flight.note_transfer("d2h", host.nbytes)
        return {name: host[i] for i, name in enumerate(names)}

    def _sync_vocab(self, ids: np.ndarray, vocab: np.ndarray):
        """Assign slots for newly-seen external ids (alloc reuses a
        recovery-resumed slot if one exists) and refresh the on-device
        id→slot table of the vocabulary's lineage; returns the touched
        unique ids, the lineage's map and its device table."""
        had_new = []

        def alloc_many(keys):
            had_new.extend(keys)
            # alloc reuses a recovery-resumed slot if one exists.
            return [self.alloc(key) for key in keys]

        with _flight.span("dispatch_vocab"):
            origin, vmap, fresh = self._vocab.of(vocab)
            uniq = vmap.sync(ids, vocab, alloc_many)
        dev_map = self._dev_maps.get(origin)
        if had_new or fresh or dev_map is None:
            # Rebuild the device table: unseen ids and the sentinel
            # (index len(vocab)) route to the scratch slot.
            table = np.append(vmap.table, -1)
            table = np.where(table < 0, self.capacity - 1, table)
            dev_map = self._dev_maps[origin] = self._to_device(table, np.int32)
            _flight.note_transfer("h2d", dev_map.nbytes)
        return uniq, vmap, dev_map

    def update_batch(self, batch: ArrayBatch) -> List[str]:
        if "key_id" in batch.cols and batch.key_vocab is not None:
            ids = batch.numpy("key_id")
            values = batch.numpy("value")
            quantized = (
                batch.value_scale is not None
                and values.dtype == np.int16
            )
            if (
                batch.value_scale is not None
                and self.dtype != torch.float32
            ):
                msg = (
                    "fixed-point (value_scale) batches need a float "
                    "accumulator, but earlier batches locked this "
                    "step's state to an integer dtype"
                )
                raise TypeError(msg)
            if batch.value_scale is not None and not quantized:
                # Fixed-point values in a non-int16 carrier: dequantize
                # host-side into the (float) accumulator dtype.
                values = (values * batch.value_scale).astype(np.float32)
            elif not quantized:
                values = self._pick_dtype(values)
            uniq, vmap, dev_map = self._sync_vocab(ids, batch.key_vocab)
            self._ensure_fields()
            n = len(values)
            sentinel = len(vmap.table)
            if quantized and sentinel < 2**15:
                # Fixed-point fast path: one int16 [2, n] transfer.
                with _flight.span("dispatch_copy"):
                    packed = np.empty((2, n), dtype=np.int16)
                    packed[0] = ids
                    packed[1] = values
                dev_packed = self._to_device(packed, np.int16)
                _flight.note_transfer("h2d", dev_packed.nbytes)
                update_fields_packed(
                    self.kind,
                    self._fields,
                    dev_map,
                    dev_packed,
                    float(np.float32(batch.value_scale)),
                )
            else:
                id_dtype = np.int16 if sentinel < 2**15 else np.int32
                dev_ids = self._to_device(ids, id_dtype)
                if quantized:
                    values = values.astype(np.float32) * np.float32(
                        batch.value_scale
                    )
                dev_vals = self._to_device(values, _NP_OF[self.dtype])
                _flight.note_transfer(
                    "h2d", dev_ids.nbytes + dev_vals.nbytes
                )
                update_fields_vocab(
                    self.kind, self._fields, dev_map, dev_ids, dev_vals
                )
            with _flight.span("dispatch_vocab"):
                return [str(vmap.vocab[e]) for e in uniq.tolist()]
        if "key" in batch.cols:
            values = batch.numpy("value")
            if batch.value_scale is not None:
                values = (values * batch.value_scale).astype(np.float32)
            return self.update(batch.numpy("key"), values)
        msg = (
            "columnar batch feeding an accelerated keyed aggregation "
            "needs a 'key' or dictionary-encoded 'key_id' column"
        )
        raise TypeError(msg)

    # -- recovery ----------------------------------------------------------

    def _field_vals(self, state: Any) -> Dict[str, float]:
        """Decompose a host-format snapshot into per-field scalars."""
        kind = self.kind_name
        if kind in ("sum", "min", "max", "count"):
            name = "count" if kind == "count" else next(iter(self.kind.fields))
            return {name: float(state)}
        if kind == "mean":
            total, count = state
            return {"sum": float(total), "count": float(count)}
        mn, mx, total, count = state  # stats
        return {
            "min": float(mn),
            "max": float(mx),
            "sum": float(total),
            "count": float(count),
        }

    def _maybe_lock_int(self, state: Any) -> None:
        if (
            self.kind_name in ("sum", "min", "max", "count")
            and isinstance(state, int)
            and self._fields is None
        ):
            self.dtype = torch.int32

    def load(self, key: str, state: Any) -> None:
        """Install a resumed snapshot for a key (host-tier format).
        Slot assignment goes through :meth:`alloc` so freed (evicted/
        discarded) slots are reused instead of growing the table."""
        self.load_many([(key, state)])

    def load_many(self, items: List[Tuple[str, Any]]) -> None:
        """Batched resume: ONE indexed write per field for a whole
        page of host-format snapshots."""
        if not items:
            return
        self._maybe_lock_int(items[0][1])
        names = list(self.kind.fields)
        np_dtype = _NP_OF[self.dtype]
        cols = {name: np.empty(len(items), dtype=np_dtype) for name in names}
        slots = np.empty(len(items), dtype=np.int64)
        for i, (key, state) in enumerate(items):
            fv = self._field_vals(state)
            # alloc reuses freed (evicted/discarded) slots and grows
            # on demand; pending resets apply in _ensure_fields below,
            # BEFORE the write installs the resumed values.
            slots[i] = self.alloc(key)
            for name in names:
                cols[name][i] = fv[name]
        self._ensure_fields()
        _flight.note_transfer(
            "h2d",
            slots.nbytes + sum(c.nbytes for c in cols.values()),
        )
        dev_slots = self._to_device(slots, np.int64)
        for name in names:
            self._fields[name][dev_slots] = self._to_device(
                cols[name], np_dtype
            )

    def snapshots_for(self, keys: List[str]) -> List[Tuple[str, Any]]:
        """Host-format snapshots of specific keys (one device→host
        copy)."""
        slots = [self.key_to_slot.get(key) for key in keys]
        return _zip_held(keys, slots, self.snapshot_ids)

    def snapshot_ids(self, slots: np.ndarray) -> List[Any]:
        """Host-format snapshots of the keys holding ``slots`` (what
        :meth:`alloc` returned), in their order: one device→host copy
        and one gather a field, whatever the number of slots."""
        if self._fields is None:
            return [None] * len(slots)
        return _snaps_of(self.kind_name, self._fetch(), slots)

    def release_ids(self, slots: np.ndarray) -> None:
        """Release the keys holding ``slots`` (:meth:`extract_keys` by
        slot): one pass each over the encoder and the vocab maps for
        the batch."""
        if not len(slots):
            return
        freed = slots.tolist()
        keys, key_to_slot = self.slot_keys, self.key_to_slot
        for slot in freed:
            del key_to_slot[keys[slot]]
            keys[slot] = None
        self._free.extend(freed)
        self._enc.drop_ids(slots)
        self._forget_itemized()
        if self._vocab.drop_ids(slots):
            self._dev_maps.clear()

    # -- finalization ------------------------------------------------------

    def finalize(self) -> List[Tuple[str, Any]]:
        """Emit ``(key, final_value)`` for every live key, sorted by
        key (matching the host tier's EOF ordering), and clear."""
        if not self.slot_keys:
            return []
        self._ensure_fields()
        host = self._fetch()
        out = [
            (key, _final_of(self.kind_name, host, self.key_to_slot[key]))
            for key in sorted(self.key_to_slot)
        ]
        self.key_to_slot.clear()
        self.slot_keys.clear()
        self._fields = None
        self._vocab = VocabMaps(dtype=np.int32)
        self._dev_maps = {}
        self._enc.clear()
        self._iddict = {}
        self._id_keys = []
        self._id_to_slot = np.empty(0, dtype=np.int32)
        return out

    def keys(self) -> List[str]:
        return [k for k in self.slot_keys if k is not None]

    def flush(self) -> None:
        """Block until every queued fold has run on the device.
        ``update*`` only enqueue kernels; the engine's pipeline
        (``engine/pipeline.py``) defers all host readbacks to drain
        points, and this is the state-level wait those drain points
        (snapshot, demotion, EOF) rest on."""
        if self._fields is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def demotion_snapshots(self) -> List[Tuple[str, Any]]:
        """Every live key's host-format snapshot — the full-state
        drain the driver uses to demote this step to the host tier
        after repeated device faults (host logics rebuild from these
        exactly as a recovery resume would)."""
        return self.snapshots_for(self.keys())

    # -- residency (engine/residency.py) ------------------------------------

    def extract_keys(self, keys: List[str]) -> List[Tuple[str, Any]]:
        """Snapshot AND release the given keys (one device→host copy
        for the batch): the residency manager's eviction surface.
        Released slots reset lazily on reuse; keys with no folded
        state release with no snapshot.  The vocab drop runs as ONE
        vectorized pass over the whole victim batch.  Callers own the
        drain-point scheduling — no fold referencing these slots may
        be in flight."""
        snaps = self.snapshots_for(keys)
        slots = [
            s for s in (self._release(key) for key in keys)
            if s is not None
        ]
        if slots and self._vocab.drop_ids(slots):
            self._dev_maps.clear()
        return [(k, s) for k, s in snaps if s is not None]

    def inject_keys(self, items: List[Tuple[str, Any]]) -> None:
        """Reinstall previously-extracted keys (host-format snapshots,
        one indexed write per field) — the residency-fault restore
        path."""
        self.load_many(items)


def load_fields(
    kind: str,
    fields: Dict[str, np.ndarray],
    slot_keys: Sequence[Optional[str]],
    device: Optional[torch.device] = None,
) -> DeviceAggState:
    """Build a :class:`DeviceAggState` from another slot table's field
    arrays (for example ``np.asarray`` of the JAX package's
    ``DeviceAggState._fields``) and its ``slot_keys`` (``None`` for a
    freed slot), so that the new state computes what the old one
    would.  The arrays are int32 or float32, all of one capacity, with
    the scratch slot last."""
    state = DeviceAggState(kind, device=device)
    arrays = {name: np.asarray(fields[name]) for name in state.kind.fields}
    first = next(iter(arrays.values()))
    dtypes = {a.dtype for a in arrays.values()}
    lengths = {a.shape for a in arrays.values()}
    if len(dtypes) != 1 or first.dtype not in (np.float32, np.int32):
        msg = f"field arrays must share one dtype, int32 or float32: {dtypes}"
        raise TypeError(msg)
    if len(lengths) != 1 or first.ndim != 1:
        msg = f"field arrays must be 1-D of one length: {lengths}"
        raise ValueError(msg)
    capacity = first.shape[0]
    if len(slot_keys) > capacity - 1:
        msg = (
            f"{len(slot_keys)} slots do not fit a table of {capacity} "
            "(the last slot is scratch)"
        )
        raise ValueError(msg)
    state.dtype = torch.int32 if first.dtype == np.int32 else torch.float32
    state.capacity = capacity
    state._fields = {
        name: state._to_device(arr, arr.dtype) for name, arr in arrays.items()
    }
    state.slot_keys = list(slot_keys)
    state.key_to_slot = {
        key: slot for slot, key in enumerate(state.slot_keys) if key is not None
    }
    # Freed slots hold stale values; they reset on reuse, as they
    # would have in the original table.
    state._free = [
        slot for slot, key in enumerate(state.slot_keys) if key is None
    ]
    return state


# -- global-exchange device merge ---------------------------------------------
#
# The quantized gsync rounds of the cluster-wide exchange tier
# (engine/sharded_state.py ``GlobalAggState``) ship each process's
# per-key partial aggregates inside the metadata round; every process
# folds every peer's frame into device-resident merge tables, so the
# merged aggregate stays on the card between closes and the only
# per-round host traffic is the wire-width frames themselves.  On a
# CUDA table the fold is the hand-written kernel ``csrc/agg_merge.cu``
# (:mod:`bytewax_tpu_torch.ops.merge_kernel`), one launch for a whole
# round (every frame, every field), from one buffer that the host packs
# (:func:`pack_merge_round`) and uploads in one copy; on a CPU table it
# is the plain version below.  The JAX package compiles one program per
# (op, encoding, dtype, padded length) (``agg_merge_fn``) and runs it a
# (frame, field); here nothing is compiled per shape.

_TABLE_DTYPES = {"int32": torch.int32, "float32": torch.float32}
_INT32_LO, _INT32_HI = -(2**31), 2**31 - 1


def agg_merge_table(
    size: int, init: float, table_dtype: str, device="cpu"
) -> torch.Tensor:
    """A fresh merge table of ``size`` slots on ``device``, set to the
    field's fold identity (±inf saturates for int32)."""
    dtype = _TABLE_DTYPES[table_dtype]
    return torch.full((size,), identity_for(init, dtype), dtype=dtype, device=device)


def _dequantize_part(enc: str, parts: Sequence[torch.Tensor], n: int, dtype) -> torch.Tensor:
    """Rows ``[0, n)`` of a frame's part as ``dtype``: the kernel's
    arithmetic (one float32 product for int8, the upper half of a
    float32 for bf16; to int32 by truncation that saturates and takes
    NaN to 0, as XLA's convert does)."""
    if enc == "raw":
        return parts[0][:n].to(dtype)
    if enc == "int8":
        scales, q = parts
        rows = torch.arange(n, device=q.device) // 1024
        vals = q[:n].to(torch.float32) * scales[rows]
    else:
        (hi,) = parts
        vals = ((hi[:n].to(torch.int32) & 0xFFFF) << 16).view(torch.float32)
    if dtype == torch.float32:
        return vals
    wide = torch.nan_to_num(vals.to(torch.float64), nan=0.0)
    return wide.clamp(_INT32_LO, _INT32_HI).trunc().to(torch.int32)


def agg_merge_plain(
    table: torch.Tensor,
    gidx: torch.Tensor,
    n: int,
    enc: str,
    parts: Sequence[torch.Tensor],
    op: str,
) -> torch.Tensor:
    """The plain PyTorch version of the merge kernel, in place: rows
    ``[0, n)`` of one frame's field dequantized, then combined into
    ``table[gidx[i]]`` by ``op`` (float min and max propagate NaN: a NaN
    row replaces any number and a stored NaN stays).  Rows from ``n`` on
    are padding and are not read; on a table whose padding target holds
    the identity, as the tier's scratch slot does, that is the JAX
    package's fold of the identity there.  A frame's real targets must
    be unique table slots (each slot takes one combine a frame, so the
    result does not depend on order); this raises otherwise."""
    n = int(n)
    idx = gidx[:n].long()
    size = table.shape[0]
    if n and (int(idx.min()) < 0 or int(idx.max()) >= size):
        msg = f"agg_merge: a target lies outside the {size}-slot table"
        raise ValueError(msg)
    if n and int(torch.bincount(idx, minlength=size).max()) > 1:
        msg = "agg_merge: a frame's real targets must be unique table slots"
        raise ValueError(msg)
    vals = _dequantize_part(enc, parts, n, table.dtype)
    old = table[idx]
    if op == "add":
        new = old + vals
    elif op in ("min", "max"):
        better = vals < old if op == "min" else vals > old
        if table.dtype.is_floating_point:
            better = ~torch.isnan(old) & (torch.isnan(vals) | better)
        new = torch.where(better, vals, old)
    else:
        msg = f"unknown merge op {op!r}"
        raise ValueError(msg)
    table[idx] = new
    return table


def agg_merge(
    table: torch.Tensor,
    gidx: torch.Tensor,
    n: int,
    enc: str,
    parts: Sequence[torch.Tensor],
    op: str,
) -> torch.Tensor:
    """Fold one frame's field into a merge table in place: the kernel
    on a CUDA table, the plain version (:func:`agg_merge_plain`) on a
    CPU table; see :func:`bytewax_tpu_torch.ops.merge_kernel.merge`
    for the arguments."""
    if table.device.type == "cuda":
        from bytewax_tpu_torch.ops import merge_kernel

        merge_kernel.merge(table, gidx, n, enc, parts, op)
        return table
    if table.device.type == "cpu":
        return agg_merge_plain(table, gidx, n, enc, parts, op)
    msg = f"the merge runs on cuda or cpu tensors, not {table.device}"
    raise ValueError(msg)


#: Encodings of a round's parts, as ``csrc/agg_merge.cu`` numbers them.
_MERGE_ENCODINGS = ("raw", "int8", "bf16")
_ITEMSIZE = {torch.int8: 1, torch.int16: 2, torch.int32: 4, torch.float32: 4, torch.int64: 8}


def _aligned(n: int) -> int:
    return (n + 15) & ~15


class MergeRound:
    """One gsync round's frames, packed for the merge: one byte buffer
    (``buf``, on the host, pinned for an upload, or on a device) that
    starts with the descriptor block, int64 ``[n_frames][2 + 3 *
    n_fields]`` (a frame's targets' offset and row count, then each
    field's encoding and its two parts' offsets; -1 for an absent
    part), followed by every frame's int32 targets and its fields'
    parts, each at a 16-byte-aligned offset from the buffer's start.
    ``desc`` keeps the descriptor block on the host as well."""

    __slots__ = ("_desc_view", "buf", "desc", "n_fields", "n_frames")

    def __init__(self, buf: torch.Tensor, desc: np.ndarray, n_frames: int, n_fields: int):
        self.buf = buf
        self.desc = desc
        self.n_frames = n_frames
        self.n_fields = n_fields
        self._desc_view = None

    @property
    def nbytes(self) -> int:
        return self.buf.numel()

    @property
    def max_rows(self) -> int:
        """The most real rows of a frame of the round."""
        return int(self.desc[:, 1].max()) if self.n_frames else 0

    def _at(self, offset: int, count: int, dtype) -> torch.Tensor:
        return self.buf[offset : offset + count * _ITEMSIZE[dtype]].view(dtype)

    def frame(self, f: int) -> Tuple[torch.Tensor, int]:
        """Frame ``f``'s targets (int32) and real row count."""
        gidx_at, n = (int(x) for x in self.desc[f, :2])
        return self._at(gidx_at, n, torch.int32), n

    def field(self, f: int, k: int, dtype=torch.float32) -> Tuple[str, List[torch.Tensor]]:
        """Frame ``f``'s part of field ``k``: ``(enc, parts)``, views of
        the buffer, as :func:`agg_merge_plain` takes them (a raw part in
        ``dtype``, its table's)."""
        n = int(self.desc[f, 1])
        code, p0, p1 = (int(x) for x in self.desc[f, 2 + 3 * k : 5 + 3 * k])
        enc = _MERGE_ENCODINGS[code]
        if enc == "int8":
            return enc, [self._at(p0, -(-n // 1024), torch.float32), self._at(p1, n, torch.int8)]
        if enc == "bf16":
            return enc, [self._at(p0, n, torch.int16)]
        return enc, [self._at(p0, n, dtype)]

    def desc_tensor(self) -> torch.Tensor:
        """The descriptor block, an int64 view of the buffer."""
        if self._desc_view is None:
            self._desc_view = self._at(0, self.desc.size, torch.int64)
        return self._desc_view

    def to(self, device) -> "MergeRound":
        """The round with its buffer on ``device``: one copy, which does
        not wait where the buffer is pinned."""
        if self.buf.device == torch.device(device):
            return self
        return MergeRound(self.buf.to(device, non_blocking=True), self.desc, self.n_frames, self.n_fields)


def pack_merge_round(frames: Sequence[Any], n_fields: int, pin: bool = False) -> MergeRound:
    """Pack a round's frames into one buffer (:class:`MergeRound`).

    ``frames`` are ``(gidx int32 [n], n, fields)`` with ``fields`` one
    ``(enc, arrays)`` a field: ``raw`` one array, already in its table's
    dtype (int32 or float32); ``int8`` ``(scales float32, q int8)``;
    ``bf16`` one int16 array of upper halves.  ``pin`` puts the buffer
    in pinned host memory, for an upload that does not wait."""
    width = 2 + 3 * n_fields
    desc = np.full((len(frames), width), -1, dtype=np.int64)
    at = _aligned(desc.nbytes)
    pieces = []
    for f, (gidx, n, fields) in enumerate(frames):
        if len(fields) != n_fields:
            msg = f"frame {f} has {len(fields)} fields, the round {n_fields}"
            raise ValueError(msg)
        desc[f, :2] = (at, n)
        pieces.append((at, np.ascontiguousarray(gidx[:n], dtype=np.int32)))
        at = _aligned(at + 4 * n)
        for k, (enc, arrays) in enumerate(fields):
            desc[f, 2 + 3 * k] = _MERGE_ENCODINGS.index(enc)
            for j, arr in enumerate(arrays):
                arr = np.ascontiguousarray(arr)
                desc[f, 3 + 3 * k + j] = at
                pieces.append((at, arr))
                at = _aligned(at + arr.nbytes)
    buf = torch.empty(at, dtype=torch.uint8, pin_memory=pin)
    host = buf.numpy()
    host[: desc.nbytes] = desc.view(np.uint8).reshape(-1)
    for offset, arr in pieces:
        host[offset : offset + arr.nbytes] = arr.view(np.uint8).reshape(-1)
    return MergeRound(buf, desc, len(frames), n_fields)


def _check_frame_targets(gidx: torch.Tensor, n: int, size: int, f: int) -> None:
    idx = gidx[:n].long()
    if n and (int(idx.min()) < 0 or int(idx.max()) >= size):
        msg = f"agg_merge: frame {f}: a target lies outside the {size}-slot table"
        raise ValueError(msg)
    if n and int(torch.bincount(idx, minlength=size).max()) > 1:
        msg = f"agg_merge: frame {f}: a frame's real targets must be unique table slots"
        raise ValueError(msg)


def agg_merge_round_plain(
    tables: Sequence[torch.Tensor], ops: Sequence[str], rnd: MergeRound
) -> Sequence[torch.Tensor]:
    """The plain PyTorch version of the round merge, in place: every
    frame of ``rnd`` in order, and within a frame every field ``k``
    folded into ``tables[k]`` by ``ops[k]`` (:func:`agg_merge_plain`).
    Raises, naming the frame, at the first frame whose real targets
    repeat or lie outside the tables."""
    size = tables[0].shape[0]
    for f in range(rnd.n_frames):
        gidx, n = rnd.frame(f)
        _check_frame_targets(gidx, n, size, f)
        for k, (table, op) in enumerate(zip(tables, ops)):
            enc, parts = rnd.field(f, k, table.dtype)
            agg_merge_plain(table, gidx, n, enc, parts, op)
    return tables


def agg_merge_round(
    tables: Sequence[torch.Tensor], ops: Sequence[str], rnd: MergeRound
) -> Sequence[torch.Tensor]:
    """Fold one round into ``tables`` in place: the kernel on CUDA
    tables (``rnd`` on their device; one launch, one read-back), the
    plain version (:func:`agg_merge_round_plain`) on CPU tables."""
    dev = tables[0].device
    if dev.type == "cuda":
        from bytewax_tpu_torch.ops import merge_kernel

        if rnd.n_frames:
            merge_kernel.merge_round(
                tables, ops, rnd.desc_tensor(), rnd.n_frames, rnd.buf.data_ptr(), rnd.max_rows
            )
        return tables
    if dev.type == "cpu":
        return agg_merge_round_plain(tables, ops, rnd)
    msg = f"the merge runs on cuda or cpu tensors, not {dev}"
    raise ValueError(msg)
