"""Tier selection for keyed aggregation and scan state, and the
mesh-sharded tiers.

The JAX package picks, most-capable first, a cluster-wide exchange tier
(``BYTEWAX_TPU_DISTRIBUTED=1``), a per-process mesh-sharded tier (more
than one local device), or a single-device slot table.  The port has
the last two: :class:`ShardedAggState` and :class:`ShardedScanState`
keep per-key state as a slot table sharded over a device mesh
(:mod:`bytewax_tpu_torch.parallel.mesh`; ``cap_per_shard`` slots a
shard, block *d* on device *d*), and each micro-batch runs one step
that buckets rows by owner shard (``csrc/shard_bucket.cu``), ships each
shard its rows, and folds (``csrc/segment_fold.cu``) or scans
(``csrc/segment_scan.cu``) them into the shard's block
(:mod:`bytewax_tpu_torch.ops.sharded`).  The cluster-wide tier is not
ported yet, and ``BYTEWAX_TPU_DISTRIBUTED=1`` is refused.

This is the keyed shuffle of the reference collapsed into the step:
``hash(key) → worker → routed_exchange → per-key callback`` becomes
``hash(key) → shard → bucket → fold``, with no host hop on the
exchange.

Snapshots stay in the host tier's per-key scalar format, so recovery
is interchangeable between the host tier, the single-device tier, any
mesh size, and the JAX package's stores.

The exchange never drops rows: the host sizes each dispatch's bucket
capacity to the batch's exact per-(source, destination) maximum
(power-of-two quantized, as in the JAX package).
"""

import math
import os
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bytewax_tpu_torch.engine import flight as _flight
from bytewax_tpu_torch.engine.arrays import ArrayBatch, KeyEncoder, VocabMaps
from bytewax_tpu_torch.engine.scan_accel import ScanUpdates, _to_host
from bytewax_tpu_torch.engine.xla import (
    _NP_OF,
    DeviceAggState,
    NonNumericValues,
    _final_of,
    _snap_of,
)
from bytewax_tpu_torch.ops.segment import AGG_KINDS, identity_for
from bytewax_tpu_torch.parallel.mesh import SHARD_AXIS, Mesh, local_devices, make_mesh

__all__ = [
    "ShardedAggState",
    "ShardedScanState",
    "make_agg_state",
    "make_scan_state",
]

_MIN_CAP_PER_SHARD = 128
_MIN_ROWS_PER_SHARD = 64


def _refuse_distributed(what: str) -> None:
    if os.environ.get("BYTEWAX_TPU_DISTRIBUTED") == "1":
        msg = (
            "BYTEWAX_TPU_DISTRIBUTED=1: the torch port has no "
            f"distributed {what} tier yet (ROADMAP queue A item 9, "
            "multi-GPU tiers); unset it to run on this process's devices"
        )
        raise NotImplementedError(msg)


def _shard_devices() -> Optional[List[torch.device]]:
    """The local devices to shard one step's state over, or None for
    single-device execution.

    ``BYTEWAX_TPU_SHARD`` overrides: ``0`` forces single-device,
    ``auto``/unset uses all local devices, an integer uses that many.
    Without a usable device this raises, as the single-device tier
    does: the device tier never carries on silently on the CPU.
    """
    want = os.environ.get("BYTEWAX_TPU_SHARD", "auto")
    if want == "0":
        return None
    if want not in ("auto", ""):
        try:
            limit = int(want)
        except ValueError:
            limit = -1
        if limit < 0:
            msg = (
                f"BYTEWAX_TPU_SHARD={want!r} is not valid; use '0' "
                "(single device), 'auto', or a device count"
            )
            raise ValueError(msg) from None
    else:
        limit = None
    devices = local_devices()
    if limit is not None:
        devices = devices[:limit]
    return devices if len(devices) > 1 else None


def make_agg_state(kind: str, driver=None):
    """Build aggregation state for one stateful step.

    Tier selection, most-capable first:

    - **per-process mesh** (:class:`ShardedAggState`) when
      :func:`_shard_devices` gives more than one device;
    - **single-device slot table** otherwise.

    ``BYTEWAX_TPU_DISTRIBUTED=1`` asks for the cluster-wide exchange
    tier, which the port does not have yet; it raises rather than
    silently giving each process a private table.
    """
    _refuse_distributed("aggregation")
    devices = _shard_devices()
    if devices is None:
        return DeviceAggState(kind)
    return ShardedAggState(kind, make_mesh(devices=devices))


def make_scan_state(scan_kind):
    """Build ``stateful_map`` scan state for one step: mesh-sharded
    (exchange + per-shard segmented scan + outputs home) when more
    than one local device is available, single-device otherwise.
    ``BYTEWAX_TPU_DISTRIBUTED=1`` raises, as for aggregations."""
    from bytewax_tpu_torch.engine.scan_accel import DeviceScanState

    _refuse_distributed("scan")
    devices = _shard_devices()
    if devices is None:
        return DeviceScanState(scan_kind)
    return ShardedScanState(scan_kind, make_mesh(devices=devices))


def _pow2(n: int, floor: int) -> int:
    return 1 << max(floor, math.ceil(math.log2(max(n, 1))))


class _ShardedSlots:
    """Key placement shared by the sharded state tiers.

    A key's owner shard is ``adler32(key) % n_shards`` (the same
    family of stable hash the host tier routes with); its slot within
    the owner is assigned densely per shard.  The wire id is
    ``kid = slot * n_shards + shard`` so a step recovers both with one
    mod/div.  Each shard's last slot is scratch for padding rows;
    blocks double on demand (key ids stay stable — only the scratch
    index moves, and the old scratch is reset to each field's
    identity), and freed slots reset lazily via the pending-reset
    list.

    Hosts set ``mesh`` / ``n_shards`` / ``cap_per_shard``, call
    :meth:`_init_slots`, and implement :meth:`_iter_fields` yielding
    ``(name, identity, dtype)`` per state column.  ``_fields`` is the
    list of per-shard blocks (``{name: tensor}`` on the shard's
    device), None until the first update or load.
    """

    def _init_slots(self) -> None:
        self.key_to_kid: Dict[str, int] = {}
        #: per-shard count of assigned slots
        self._shard_fill = [0] * self.n_shards
        #: per-shard free (discarded) slot lists
        self._free: List[List[int]] = [[] for _ in range(self.n_shards)]
        #: global indices (shard * cap_per_shard + slot) to reset
        self._pending_reset: List[int] = []
        self._fields: Optional[List[Dict[str, torch.Tensor]]] = None
        #: The first shard's device (where outputs and snapshots meet).
        self.device = self.mesh.devices[0]

    def _iter_fields(self):
        """``(name, identity, dtype)`` per state column."""
        raise NotImplementedError

    @property
    def capacity(self) -> int:
        """Slots over every block (each block's last is scratch)."""
        return self.n_shards * self.cap_per_shard

    def _owner(self, key: str) -> int:
        return zlib.adler32(key.encode()) % self.n_shards

    def alloc(self, key: str) -> int:
        """Assign (or return) the wire key id for a key."""
        kid = self.key_to_kid.get(key)
        if kid is not None:
            return kid
        shard = self._owner(key)
        if self._free[shard]:
            slot = self._free[shard].pop()
            self._pending_reset.append(shard * self.cap_per_shard + slot)
        else:
            slot = self._shard_fill[shard]
            if slot >= self.cap_per_shard - 1:
                self._grow()
            self._shard_fill[shard] += 1
        kid = slot * self.n_shards + shard
        self.key_to_kid[key] = kid
        self._on_alloc(key, kid)
        return kid

    def _on_alloc(self, key: str, kid: int) -> None:
        """Hook: bookkeeping for a newly-assigned key."""

    def discard(self, key: str) -> None:
        kid = self._release(key)
        if kid is not None:
            self._drop_vocab_ids([kid])

    def _release(self, key: str) -> Optional[int]:
        """Free a key's slot WITHOUT the vocab drop (extract_keys
        batches that into one pass); returns the freed wire id."""
        kid = self.key_to_kid.pop(key, None)
        if kid is not None:
            shard, slot = kid % self.n_shards, kid // self.n_shards
            self._free[shard].append(slot)
            self._on_discard(key, kid)
        return kid

    def _on_discard(self, key: str, kid: int) -> None:
        """Hook: bookkeeping for a released key."""

    def _drop_vocab_ids(self, kids: List[int]) -> None:
        """Hook: un-map released wire ids from any external-id vocab
        (one vectorized pass per batch of kids)."""

    def _global_idx(self, kid: int) -> int:
        shard, slot = kid % self.n_shards, kid // self.n_shards
        return shard * self.cap_per_shard + slot

    def _grow(self) -> None:
        """Double every shard's block.  Key ids are unchanged; only
        the per-shard scratch slot (the block's last) moves, and the
        old scratch becomes a real slot (reset to identity)."""
        old_cap = self.cap_per_shard
        new_cap = old_cap * 2
        if self._fields is not None:
            grown = []
            for block in self._fields:
                out = {}
                for name, ident, dtype in self._iter_fields():
                    old = block[name]
                    old[old_cap - 1] = ident
                    pad = torch.full((new_cap - old_cap,), ident, dtype=dtype, device=old.device)
                    out[name] = torch.cat([old, pad])
                grown.append(out)
            self._fields = grown
        # Remap pending resets (global idx of the OLD layout; the
        # shard/slot split survives via the old capacity).
        self._pending_reset = [
            (idx // old_cap) * new_cap + (idx % old_cap) for idx in self._pending_reset
        ]
        self.cap_per_shard = new_cap

    def _by_shard(self, idxs: np.ndarray):
        """``(shard, positions, slots)`` for global indices, one entry
        per shard that has any."""
        shards = idxs // self.cap_per_shard
        for shard in np.unique(shards).tolist():
            at = np.nonzero(shards == shard)[0]
            yield shard, at, idxs[at] - shard * self.cap_per_shard

    def _ensure_fields(self) -> None:
        if self._fields is None:
            self._fields = [
                {
                    name: torch.full((self.cap_per_shard,), ident, dtype=dtype, device=dev)
                    for name, ident, dtype in self._iter_fields()
                }
                for dev in self.mesh.devices
            ]
            self._pending_reset.clear()
        elif self._pending_reset:
            idxs = np.asarray(self._pending_reset, dtype=np.int64)
            for shard, _at, slots in self._by_shard(idxs):
                block = self._fields[shard]
                dev_slots = torch.from_numpy(slots).to(self.mesh.devices[shard])
                for name, ident, _dtype in self._iter_fields():
                    block[name].index_fill_(0, dev_slots, ident)
            self._pending_reset.clear()

    def _install(self, idxs: np.ndarray, cols: Dict[str, np.ndarray]) -> None:
        """Write ``cols[name][i]`` at global index ``idxs[i]``: one
        indexed write per field per shard."""
        for shard, at, slots in self._by_shard(idxs):
            dev = self.mesh.devices[shard]
            dev_slots = torch.from_numpy(slots).to(dev)
            block = self._fields[shard]
            for name, col in cols.items():
                block[name][dev_slots] = torch.from_numpy(np.ascontiguousarray(col[at])).to(dev)

    def _fetch(self) -> Dict[str, np.ndarray]:
        """Every field over every block, ``[n_shards * cap_per_shard]``
        host arrays indexed by :meth:`_global_idx`; one device→host copy
        where the blocks share a device and the fields a dtype."""
        names = [name for name, _ident, _dtype in self._iter_fields()]
        out: Dict[str, np.ndarray] = {}
        for dtype in {self._fields[0][name].dtype for name in names}:
            group = [name for name in names if self._fields[0][name].dtype == dtype]
            joined = torch.cat(
                [torch.stack([b[name] for name in group]).to(self.device) for b in self._fields],
                dim=1,
            )
            host = joined.cpu().numpy()
            _flight.note_transfer("d2h", host.nbytes)
            out.update({name: host[i] for i, name in enumerate(group)})
        return out

    def _to_blocks(self, arr: np.ndarray, rows_per_shard: int) -> List[torch.Tensor]:
        """A host array cut into per-shard source blocks on the shards'
        devices: one copy per run of shards on one device, each block a
        view of it."""
        blocks: List[torch.Tensor] = []
        for run in self.mesh.runs():
            part = np.ascontiguousarray(arr[run.start * rows_per_shard : run.stop * rows_per_shard])
            t = torch.from_numpy(part).to(self.mesh.devices[run.start])
            blocks.extend(t.view(len(run), rows_per_shard).unbind(0))
        return blocks

    def _sizing(self, kids: np.ndarray) -> Tuple[int, int, np.ndarray]:
        """``(rows_per_shard, capacity, pair_counts)``: the source
        block length (a power of two), and the exact per-(source
        block, destination) bucket maximum, power-of-two quantized, so
        the exchange never drops a row however skewed the keys."""
        n = len(kids)
        rows_per_shard = _pow2(-(-n // self.n_shards), int(math.log2(_MIN_ROWS_PER_SHARD)))
        dest = kids % self.n_shards
        block_of = np.arange(n) // rows_per_shard
        pair_counts = np.bincount(
            block_of * self.n_shards + dest, minlength=self.n_shards * self.n_shards
        )
        return rows_per_shard, _pow2(int(pair_counts.max()), 4), pair_counts

    def _padded(self, kids: np.ndarray, values: np.ndarray, dtype, rows_per_shard: int):
        """Source blocks of kids, values and the valid mask, padded to
        ``rows_per_shard`` rows a shard."""
        n = len(kids)
        total = rows_per_shard * self.n_shards
        kids_p = np.zeros(total, dtype=np.int32)
        kids_p[:n] = kids
        vals_p = np.zeros(total, dtype=dtype)
        vals_p[:n] = values
        valid_p = np.zeros(total, dtype=bool)
        valid_p[:n] = True
        _flight.note_transfer("h2d", kids_p.nbytes + vals_p.nbytes + valid_p.nbytes)
        return (
            self._to_blocks(kids_p, rows_per_shard),
            self._to_blocks(vals_p, rows_per_shard),
            self._to_blocks(valid_p, rows_per_shard),
        )

    def keys(self) -> List[str]:
        return list(self.key_to_kid)

    def flush(self) -> None:
        """Block until every dispatched step has run on the mesh's
        cards (see ``xla.DeviceAggState.flush``)."""
        if self._fields is not None:
            for dev in set(self.mesh.devices):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)

    def demotion_snapshots(self) -> List[Tuple[str, Any]]:
        """Full-state drain for device→host demotion (subclasses
        supply ``snapshots_for``); see
        ``xla.DeviceAggState.demotion_snapshots``."""
        return self.snapshots_for(self.keys())

    # -- residency (engine/residency.py) ------------------------------------

    def extract_keys(self, keys: List[str]) -> List[Tuple[str, Any]]:
        """Snapshot AND release the given keys — the residency
        manager's eviction surface (see
        ``xla.DeviceAggState.extract_keys``).  Freed per-shard slots
        reset lazily via the pending-reset list on reuse; the vocab
        drop runs as ONE vectorized pass for the whole victim batch."""
        snaps = self.snapshots_for(keys)
        kids = [k for k in (self._release(key) for key in keys) if k is not None]
        if kids:
            self._drop_vocab_ids(kids)
        return [(k, s) for k, s in snaps if s is not None]

    def inject_keys(self, items: List[Tuple[str, Any]]) -> None:
        """Reinstall previously-extracted keys (host-format
        snapshots, one indexed write per field per shard) — the
        residency-fault restore path (subclasses supply
        ``load_many``)."""
        self.load_many(items)


class ShardedAggState(_ShardedSlots):
    """Slot-table aggregation state sharded over a device mesh.

    Duck-types the ``DeviceAggState`` surface the engine driver uses
    (``update`` / ``update_batch`` / ``update_items`` / ``update_ids`` /
    ``alloc`` / ``load_many`` / ``snapshots_for`` / ``finalize`` /
    ``keys``).  Key placement and wire ids are :class:`_ShardedSlots`'.
    Dictionary-encoded batches map through one vocabulary map per
    lineage (this process's and each peer's,
    ``engine/arrays.py`` ``VocabMaps``), as the single-device tier does.
    """

    def __init__(self, kind: str, mesh: Mesh, cap_per_shard: int = _MIN_CAP_PER_SHARD):
        self.kind_name = kind
        self.kind = AGG_KINDS[kind]
        self.mesh = mesh
        self.n_shards = mesh.shape[SHARD_AXIS]
        self.cap_per_shard = cap_per_shard
        self.dtype = torch.float32
        self._init_slots()
        # Dictionary-encoded fast path: external id -> wire key id, one
        # map per vocabulary lineage.
        self._vocab = VocabMaps(dtype=np.int32)
        # Automatic encoder for plain string key columns plus the
        # kid -> key reverse map it needs for touched-key reporting.
        self._enc = KeyEncoder()
        self._kid_key: Dict[int, str] = {}
        # One-pass itemized promotion (native kv_encode): dense ids
        # in first-sight order, mapped to wire kids via one gather.
        self._iddict: Dict[str, int] = {}
        self._id_keys: List[str] = []
        self._id_to_kid = np.empty(0, dtype=np.int32)

    # -- key placement hooks (_ShardedSlots) --------------------------------

    def _iter_fields(self):
        return [
            (name, identity_for(init, self.dtype), self.dtype)
            for name, (init, _op) in self.kind.fields.items()
        ]

    def _on_alloc(self, key: str, kid: int) -> None:
        self._kid_key[kid] = key

    def _on_discard(self, key: str, kid: int) -> None:
        self._kid_key.pop(kid, None)
        self._enc.drop(key)
        if self._iddict:
            # Dense ids must stay collision-free (kv_encode assigns
            # len(dict)): a discard resets the itemized cache (see
            # DeviceAggState._release).
            self._iddict = {}
            self._id_keys = []
            self._id_to_kid = np.empty(0, dtype=np.int32)

    def _drop_vocab_ids(self, kids: List[int]) -> None:
        # Each lineage's table maps a key's external id to its (now
        # reusable) wire id; drop them so a post-evict return of the
        # key re-allocs instead of folding into a reassigned slot.
        self._vocab.drop_ids(kids)

    # -- dtype policy: the single-device tier's --------------------------------

    _pick_dtype = DeviceAggState._pick_dtype
    _maybe_lock_int = DeviceAggState._maybe_lock_int
    _field_vals = DeviceAggState._field_vals

    # -- updates -------------------------------------------------------------

    def _dispatch(self, kids: np.ndarray, values: np.ndarray) -> None:
        """Run one exchange + fold over the mesh."""
        from bytewax_tpu_torch.ops.sharded import make_sharded_step

        if len(kids) == 0:
            return
        self._ensure_fields()
        rows_per_shard, capacity, _pairs = self._sizing(kids)
        blocks = self._padded(kids, values, _NP_OF[self.dtype], rows_per_shard)
        step = make_sharded_step(
            self.mesh, self.kind_name, self.cap_per_shard, capacity, dtype=self.dtype
        )
        self._fields = step(self._fields, *blocks)

    def update_ids(self, kids: np.ndarray, values: np.ndarray) -> None:
        """Fold rows into pre-allocated wire ids (the id-based fold
        surface shared with ``DeviceAggState``: ids are whatever
        :meth:`alloc` returned)."""
        values = self._pick_dtype(np.asarray(values))
        self._dispatch(np.asarray(kids, dtype=np.int32), values)

    def update_items(self, items) -> Optional[List[str]]:
        """One-pass itemized fast path over native ``kv_encode``; see
        ``DeviceAggState.update_items`` (same contract: returns
        touched keys, None without the native module, raises
        NonNumericValues with no state mutated)."""
        from bytewax_tpu_torch.native import kv_encode as _kv_encode

        n = len(items)
        ids = np.empty(n, dtype=np.int32)
        vals = np.empty(n, dtype=np.float64)
        ivals = np.empty(n, dtype=np.int64)
        try:
            res = _kv_encode(items, self._iddict, ids, vals, ivals)
        except TypeError as ex:
            raise NonNumericValues(str(ex)) from ex
        if res is None:
            return None
        new_keys, all_int = res
        if all_int:
            # Exact int64 lane from the C pass (no float round-trip).
            vals = ivals
        try:
            vals = self._pick_dtype(vals)
        except (NonNumericValues, TypeError):
            for k in new_keys:
                self._iddict.pop(k, None)
            raise
        if new_keys:
            self._id_keys.extend(new_keys)
            self._id_to_kid = np.concatenate(
                [
                    self._id_to_kid,
                    np.fromiter(
                        (self.alloc(k) for k in new_keys),
                        dtype=np.int32,
                        count=len(new_keys),
                    ),
                ]
            )
        self._dispatch(self._id_to_kid[ids], vals)
        counts = np.bincount(ids, minlength=len(self._id_keys))
        return [self._id_keys[i] for i in np.nonzero(counts)[0].tolist()]

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
        kids = self._enc.encode(keys, lambda ks: [self.alloc(k) for k in ks])
        self._dispatch(kids.astype(np.int32, copy=False), values)
        return [self._kid_key[k] for k in np.unique(kids).tolist()]

    def update_batch(self, batch: ArrayBatch) -> List[str]:
        if "key_id" in batch.cols and batch.key_vocab is not None:
            ids = batch.numpy("key_id")
            values = batch.numpy("value")
            if batch.value_scale is not None:
                if self.dtype != torch.float32:
                    msg = (
                        "fixed-point (value_scale) batches need a float "
                        "accumulator, but earlier batches locked this "
                        "step's state to an integer dtype"
                    )
                    raise TypeError(msg)
                values = (values * batch.value_scale).astype(np.float32)
            else:
                values = self._pick_dtype(values)
            _origin, vmap, _fresh = self._vocab.of(batch.key_vocab)
            uniq = vmap.sync(
                ids.astype(np.int64),
                batch.key_vocab,
                lambda keys: [self.alloc(k) for k in keys],
            )
            self._dispatch(vmap.table[ids], values)
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

    # -- recovery ------------------------------------------------------------

    def load(self, key: str, state: Any) -> None:
        """Install a resumed snapshot for a key (host-tier format,
        identical to ``DeviceAggState.load``)."""
        self.load_many([(key, state)])

    def load_many(self, items) -> None:
        """Batched resume: one indexed write per field per shard for a
        page (mirrors ``DeviceAggState.load_many``).  Wire ids are
        resolved after every alloc so capacity growth mid-page can't
        skew the global indices."""
        if not items:
            return
        self._maybe_lock_int(items[0][1])
        names = list(self.kind.fields)
        cols = {name: np.empty(len(items), dtype=_NP_OF[self.dtype]) for name in names}
        kids = []
        for i, (key, state) in enumerate(items):
            fv = self._field_vals(state)
            kids.append(self.alloc(key))
            for name in names:
                cols[name][i] = fv[name]
        self._ensure_fields()
        idxs = np.fromiter((self._global_idx(k) for k in kids), dtype=np.int64, count=len(kids))
        _flight.note_transfer("h2d", idxs.nbytes + sum(c.nbytes for c in cols.values()))
        self._install(idxs, cols)

    def snapshots_for(self, keys: List[str]) -> List[Tuple[str, Any]]:
        """Host-format snapshots of specific keys (one device→host
        copy)."""
        if self._fields is None or not keys:
            return [(k, None) for k in keys]
        host = self._fetch()
        out = []
        for key in keys:
            kid = self.key_to_kid.get(key)
            if kid is None:
                out.append((key, None))
            else:
                out.append((key, _snap_of(self.kind_name, host, self._global_idx(kid))))
        return out

    # -- finalization --------------------------------------------------------

    def finalize(self) -> List[Tuple[str, Any]]:
        """Emit ``(key, final_value)`` for every live key, sorted by
        key (matching the host tier's EOF ordering), and clear."""
        if not self.key_to_kid:
            return []
        self._ensure_fields()
        host = self._fetch()
        out = [
            (key, _final_of(self.kind_name, host, self._global_idx(self.key_to_kid[key])))
            for key in sorted(self.key_to_kid)
        ]
        self.key_to_kid.clear()
        self._shard_fill = [0] * self.n_shards
        self._free = [[] for _ in range(self.n_shards)]
        self._fields = None
        self._vocab = VocabMaps(dtype=np.int32)
        self._enc.clear()
        self._kid_key.clear()
        self._iddict = {}
        self._id_keys = []
        self._id_to_kid = np.empty(0, dtype=np.int32)
        return out


class ShardedScanState(_ShardedSlots, ScanUpdates):
    """Mesh-sharded per-key scan state (``stateful_map`` lowering).

    The multi-device sibling of
    :class:`bytewax_tpu_torch.engine.scan_accel.DeviceScanState`:
    per-key state columns (one per :class:`~bytewax_tpu_torch.ops.scan.ScanKind`
    field) live sharded over the mesh, and each micro-batch runs one
    step that exchanges rows to their owner shard, runs the kind's
    segmented scan against the local block, and writes each row's
    output to its position (:func:`bytewax_tpu_torch.ops.sharded.make_sharded_scan_step`).

    Key placement and wire ids follow :class:`ShardedAggState`;
    snapshots stay in the host tier's field-order tuple format, so
    recovery interchanges between the host tier, the single-device
    tier, and any mesh size.
    """

    def __init__(self, scan_kind, mesh: Mesh, cap_per_shard: int = _MIN_CAP_PER_SHARD):
        self.kind = scan_kind
        self.mesh = mesh
        self.n_shards = mesh.shape[SHARD_AXIS]
        self.cap_per_shard = cap_per_shard
        self._init_slots()

    def _iter_fields(self):
        return [(name, init, dtype) for name, (init, dtype) in self.kind.fields.items()]

    # -- updates -------------------------------------------------------------

    def scan_rows(self, kids: np.ndarray, values: np.ndarray) -> Tuple[np.ndarray, ...]:
        """One exchange + scan + trip home (the :class:`ScanUpdates`
        hook); outputs are aligned with the input rows (finished by
        ``kind.post``), which both callers feed pre-grouped."""
        from bytewax_tpu_torch.ops.sharded import make_sharded_scan_step

        n = len(kids)
        self._ensure_fields()
        if n == 0:
            return ()
        rows_per_shard, capacity, pairs = self._sizing(kids)
        blocks = self._padded(kids, values, np.float32, rows_per_shard)
        step = make_sharded_scan_step(self.mesh, self.kind, self.cap_per_shard, capacity)
        recv_rows = pairs.reshape(self.n_shards, self.n_shards).sum(axis=0).tolist()
        outs, self._fields = step(self._fields, *blocks, recv_rows=recv_rows)
        host = _to_host(tuple(o[:n] for o in outs))
        _flight.note_transfer("d2h", sum(o.nbytes for o in host))
        return self.kind.post(host)

    # -- recovery ------------------------------------------------------------

    def load(self, key: str, state: Any) -> None:
        self.load_many([(key, state)])

    def load_many(self, items: List[Tuple[str, Any]]) -> None:
        """Batched resume from host-format field-order tuples: one
        indexed write per field per shard (wire ids resolved after
        every alloc so capacity growth mid-page can't skew indices)."""
        if not items:
            return
        field_items = list(self.kind.fields.items())
        cols = {
            name: np.empty(len(items), dtype=torch.empty(0, dtype=dtype).numpy().dtype)
            for name, (_init, dtype) in field_items
        }
        kids = []
        for i, (key, state) in enumerate(items):
            kids.append(self.alloc(key))
            for (name, _spec), part in zip(field_items, state):
                cols[name][i] = part
        self._ensure_fields()
        idxs = np.fromiter((self._global_idx(k) for k in kids), dtype=np.int64, count=len(kids))
        self._install(idxs, cols)

    def snapshots_for(self, keys: List[str]) -> List[Tuple[str, Any]]:
        if self._fields is None or not keys:
            return [(k, None) for k in keys]
        self._ensure_fields()
        names = tuple(self.kind.fields)
        host = self._fetch()
        out = []
        for key in keys:
            kid = self.key_to_kid.get(key)
            if kid is None:
                out.append((key, None))
            else:
                idx = self._global_idx(kid)
                out.append((key, self.kind.snapshot_of(tuple(host[nm][idx] for nm in names))))
        return out
