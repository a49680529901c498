"""Device-resident per-key scan state (``stateful_map`` lowering).

:class:`bytewax_tpu_torch.engine.xla.DeviceAggState` accelerates keyed
aggregations (emit at EOF or window close); this module accelerates
the per-item-emitting ``stateful_map`` shape for any
:class:`bytewax_tpu_torch.ops.scan.ScanKind`: per-key state lives in
slot-table tensors on :func:`bytewax_tpu_torch.utils.device` (one
column per kind field), each micro-batch is grouped by key on the host
and folded through one segmented scan (:mod:`bytewax_tpu_torch.ops.scan`:
the Hopper kernel on the card for the built-in kinds), and every row's
output comes from the kind's ``emit``: the host tier's
one-mapper-call-per-item semantics at device batch speed.

The state container is generic over the kind's declared fields:
snapshots are host-format tuples in field order (``(count, mean,
m2)`` for z-score), interchangeable with the host tier and with the
JAX package's stores.
"""

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bytewax_tpu_torch.engine import flight as _flight
from bytewax_tpu_torch.engine.arrays import ArrayBatch, factorize_keys
from bytewax_tpu_torch.engine.xla import NonNumericValues
from bytewax_tpu_torch.ops.scan import ScanKind

__all__ = ["ScanAccelSpec", "DeviceScanState", "ScanEmit", "ScanUpdates"]

_MIN_CAPACITY = 1024


def _require_numeric(values: np.ndarray) -> None:
    if values.dtype == object or values.dtype.kind in "USb":
        msg = (
            "device-accelerated stateful_map requires numeric "
            "values; arbitrary-state mappers run on the host tier"
        )
        raise NonNumericValues(msg)


def _batch_keys(batch: ArrayBatch) -> np.ndarray:
    """The key strings of a columnar batch feeding a scan step."""
    if "value" not in batch.cols:
        msg = (
            "columnar batch feeding an accelerated stateful_map "
            "needs a 'value' column"
        )
        raise TypeError(msg)
    if "key_id" in batch.cols and batch.key_vocab is not None:
        vocab = np.asarray(batch.key_vocab)
        return vocab[batch.numpy("key_id")]
    if "key" in batch.cols:
        return batch.numpy("key")
    msg = (
        "columnar batch feeding an accelerated stateful_map "
        "needs a 'key' or dictionary-encoded 'key_id' column"
    )
    raise TypeError(msg)


class ScanAccelSpec:
    """Annotation on a core ``stateful_batch``: lower the enclosing
    ``stateful_map`` to a device segmented scan of this kind."""

    def __init__(self, kind: ScanKind):
        if not isinstance(kind, ScanKind):
            msg = (
                "ScanAccelSpec takes a bytewax_tpu_torch.ops.scan.ScanKind "
                f"instance; got {kind!r}"
            )
            raise TypeError(msg)
        self.kind = kind

    def make_state(self):
        from bytewax_tpu_torch.engine.sharded_state import make_scan_state

        return make_scan_state(self.kind)

    def __repr__(self) -> str:
        return f"ScanAccelSpec({self.kind!r})"


class ScanEmit:
    """One micro-batch's per-row outputs, in emission order (rows
    grouped by key, groups in first-appearance order, original order
    within each group: the host tier's per-batch emission order).
    ``outs`` holds the kind's output columns (e.g. ``(z, anomaly)``
    for z-score)."""

    __slots__ = ("keys", "values", "outs", "codes", "uniq")

    def __init__(self, keys, values, outs, codes, uniq):
        self.keys = keys  # np[str], emission order
        self.values = values  # np, original dtype
        self.outs = outs  # tuple of np columns, emission order
        self.codes = codes  # np.int64 group code per row (emission order)
        self.uniq = uniq  # list[str], one per group code

    def items(self) -> List[Tuple[str, Tuple]]:
        cols = [col.tolist() for col in self.outs]
        return list(
            zip(
                self.keys.tolist(),
                zip(self.values.tolist(), *cols),
            )
        )


class ScanUpdates:
    """The scan-state update surface, shared by the single-device and
    mesh-sharded tiers.  Hosts provide ``alloc(key) -> id`` and
    ``scan_rows(ids, values) -> outs``, the per-row output columns in
    row order (both callers feed pre-grouped rows, so row order IS the
    grouped emission order)."""

    def update_grouped(
        self, uniq: List[str], lens: List[int], values: np.ndarray
    ) -> Tuple[np.ndarray, ...]:
        """Fold pre-grouped rows in: ``values`` holds each key's rows
        contiguously (group g = ``uniq[g]``, ``lens[g]`` rows);
        returns the per-row output columns in the same order."""
        _require_numeric(values)
        id_of = np.fromiter(
            (self.alloc(k) for k in uniq), dtype=np.int32, count=len(uniq)
        )
        return self.scan_rows(np.repeat(id_of, lens), values)

    def update(
        self, keys: np.ndarray, values: np.ndarray
    ) -> Tuple[List[str], ScanEmit]:
        """Fold ``(key, value)`` rows in; returns the unique keys
        touched plus the per-row outputs in grouped emission order."""
        keys = np.asarray(keys)
        values = np.asarray(values)
        _require_numeric(values)
        codes, uniq = factorize_keys(keys)
        uniq_list = [str(k) for k in uniq.tolist()]
        id_of = np.fromiter(
            (self.alloc(k) for k in uniq_list),
            dtype=np.int32,
            count=len(uniq_list),
        )
        order = np.argsort(codes, kind="stable")
        codes_s = codes[order]
        vals_s = values[order]
        outs = self.scan_rows(id_of[codes_s], vals_s)
        emit = ScanEmit(keys[order], vals_s, outs, codes_s, uniq_list)
        return uniq_list, emit


class DeviceScanState(ScanUpdates):
    """Slot-table scan state for one lowered ``stateful_map`` step, on
    ``device`` (default: :func:`bytewax_tpu_torch.utils.device`).

    Keys occupy slots ``0..capacity-2``; the last slot is scratch (the
    plain versions aim their non-tail writes at it).  Tables double
    when full.  A freed slot is reset to the kind's identities when it
    is reused: resets gather in a list and land in one indexed write
    per field before the next dispatch.  Field columns, identities,
    the scan and the snapshot layout all come from the
    :class:`~bytewax_tpu_torch.ops.scan.ScanKind`.

    >>> import numpy as np
    >>> import torch
    >>> from bytewax_tpu_torch.ops.scan import WelfordZScore
    >>> st = DeviceScanState(WelfordZScore(2.0), device=torch.device("cpu"))
    >>> touched, emit = st.update(np.array(["a", "b", "a"]), np.array([1.0, 5.0, 3.0]))
    >>> emit.items()
    [('a', (1.0, 0.0, False)), ('a', (3.0, 0.0, False)), ('b', (5.0, 0.0, False))]
    >>> st.snapshots_for(["a", "c"])
    [('a', (2, 2.0, 2.0)), ('c', None)]
    """

    def __init__(self, kind: ScanKind, device: Optional[torch.device] = None):
        if device is None:
            from bytewax_tpu_torch.utils import device as _device

            device = _device()
        self.kind = kind
        self.device = torch.device(device)
        self.capacity = _MIN_CAPACITY
        self.key_to_slot: Dict[str, int] = {}
        self.slot_keys: List[Optional[str]] = []
        self._free: List[int] = []
        self._pending_reset: List[int] = []
        self._fields: Optional[Dict[str, torch.Tensor]] = None

    def _to_device(self, arr: np.ndarray, dtype) -> torch.Tensor:
        """Copy a host array to the device in exactly ``dtype`` (a
        private host buffer: the caller may reuse ``arr``)."""
        host = np.require(arr, dtype=dtype, requirements=("C", "W"))
        return torch.from_numpy(host).to(self.device)

    # -- slot management ---------------------------------------------------

    def _ensure_fields(self) -> None:
        """Materialize the tables, and apply pending slot resets."""
        if self._fields is None:
            self._fields = {
                name: torch.full((self.capacity,), init, dtype=dtype, device=self.device)
                for name, (init, dtype) in self.kind.fields.items()
            }
            self._pending_reset.clear()
            return
        if self._pending_reset:
            slots = self._to_device(np.asarray(self._pending_reset), np.int64)
            for name, (init, _dtype) in self.kind.fields.items():
                self._fields[name].index_fill_(0, slots, init)
            self._pending_reset.clear()

    def _grow_to(self, needed: int) -> None:
        new_cap = self.capacity
        while new_cap - 1 < needed:
            new_cap *= 2
        if new_cap == self.capacity:
            return
        if self._fields is not None:
            grown = {}
            for name, arr in self._fields.items():
                init = self.kind.fields[name][0]
                # The old scratch slot becomes a real slot: clear it
                # back to the field's identity.
                arr[self.capacity - 1] = init
                pad = torch.full(
                    (new_cap - self.capacity,), init, dtype=arr.dtype, device=self.device
                )
                grown[name] = torch.cat([arr, pad])
            self._fields = grown
        self.capacity = new_cap

    def alloc(self, key: str) -> int:
        slot = self.key_to_slot.get(key)
        if slot is not None:
            return slot
        if self._free:
            slot = self._free.pop()
            self.slot_keys[slot] = key
            # Freed slots keep stale state until the batched reset.
            self._pending_reset.append(slot)
        else:
            self._grow_to(len(self.slot_keys) + 2)
            slot = len(self.slot_keys)
            self.slot_keys.append(key)
        self.key_to_slot[key] = slot
        return slot

    def keys(self) -> List[str]:
        return [k for k in self.slot_keys if k is not None]

    # -- updates -----------------------------------------------------------

    def scan_rows(
        self, row_slots: np.ndarray, values: np.ndarray
    ) -> Tuple[np.ndarray, ...]:
        """Run the kind's scan over pre-grouped rows (all rows of a
        slot contiguous); returns the kind's per-row output columns
        (host numpy, finished by ``kind.post``)."""
        self._ensure_fields()
        if len(values) == 0:
            return ()
        slots = self._to_device(row_slots, np.int32)
        vals = self._to_device(values, np.float32)
        _flight.note_transfer("h2d", slots.nbytes + vals.nbytes)
        outs, self._fields = self.kind.run(self._fields, slots, vals)
        host_outs = _to_host(outs)
        _flight.note_transfer("d2h", sum(o.nbytes for o in host_outs))
        return self.kind.post(host_outs)

    # -- recovery ----------------------------------------------------------

    def _fetch_slots(self, slots: List[int]) -> List[np.ndarray]:
        """Field columns at ``slots``, with one device→host copy (the
        columns gathered and joined as bytes on the device)."""
        idx = self._to_device(np.asarray(slots), np.int64)
        cols = [self._fields[name][idx] for name in self.kind.fields]
        joined = torch.cat([c.view(torch.uint8) for c in cols]).cpu().numpy()
        _flight.note_transfer("d2h", joined.nbytes)
        out = []
        at = 0
        for c in cols:
            size = c.numel() * c.element_size()
            host_dtype = torch.empty(0, dtype=c.dtype).numpy().dtype
            out.append(joined[at : at + size].view(host_dtype))
            at += size
        return out

    def load_many(self, items: List[Tuple[str, Any]]) -> None:
        """Batched resume: one indexed write per field per page of
        host-format field-order state tuples."""
        if not items:
            return
        field_items = list(self.kind.fields.items())
        self._grow_to(len(self.key_to_slot) + len(items) + 1)
        cols = [
            np.empty(len(items), dtype=torch.empty(0, dtype=dtype).numpy().dtype)
            for _name, (_init, dtype) in field_items
        ]
        slots = np.empty(len(items), dtype=np.int64)
        for i, (key, state) in enumerate(items):
            slots[i] = self.alloc(key)
            for j, part in enumerate(state):
                cols[j][i] = part
        # Pending resets of reused slots land before the loaded state.
        self._ensure_fields()
        dev_slots = self._to_device(slots, np.int64)
        for (name, _spec), col in zip(field_items, cols):
            self._fields[name][dev_slots] = torch.from_numpy(col).to(self.device)

    def snapshots_for(self, keys: List[str]) -> List[Tuple[str, Any]]:
        """Host-format snapshots (one device→host copy for the call)."""
        if self._fields is None or not keys:
            return [(k, None) for k in keys]
        self._ensure_fields()
        present = [(i, self.key_to_slot[k]) for i, k in enumerate(keys) if k in self.key_to_slot]
        out: List[Tuple[str, Any]] = [(k, None) for k in keys]
        if not present:
            return out
        host = self._fetch_slots([slot for _i, slot in present])
        for j, (i, _slot) in enumerate(present):
            out[i] = (keys[i], self.kind.snapshot_of(tuple(col[j] for col in host)))
        return out

    def flush(self) -> None:
        """Block until every dispatched scan has run on the device."""
        if self._fields is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def demotion_snapshots(self) -> List[Tuple[str, Any]]:
        """Full-state drain for device→host demotion (see
        ``DeviceAggState.demotion_snapshots``)."""
        return self.snapshots_for(self.keys())

    def discard(self, key: str) -> None:
        slot = self.key_to_slot.pop(key, None)
        if slot is not None:
            self.slot_keys[slot] = None
            self._free.append(slot)

    # -- residency (engine/residency.py) ------------------------------------

    def extract_keys(self, keys: List[str]) -> List[Tuple[str, Any]]:
        """Snapshot AND release the given keys: the residency
        manager's eviction surface.  Freed slots reset to the kind's
        identities on reuse."""
        snaps = self.snapshots_for(keys)
        for key in keys:
            self.discard(key)
        return [(k, s) for k, s in snaps if s is not None]

    def inject_keys(self, items: List[Tuple[str, Any]]) -> None:
        """Reinstall previously-extracted keys (field-order host
        tuples, one indexed write per field): the residency-fault
        restore path."""
        self.load_many(items)


def _to_host(outs: Tuple[torch.Tensor, ...]) -> Tuple[np.ndarray, ...]:
    """Output columns to host numpy: one copy when they share a dtype
    (the built-in kinds' float32 columns), else one per column."""
    if len({o.dtype for o in outs}) == 1:
        return tuple(torch.stack(list(outs)).cpu().numpy())
    return tuple(o.cpu().numpy() for o in outs)
