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
(:mod:`bytewax_tpu_torch.ops.sharded`).  :class:`GlobalAggState` is the
cluster-wide tier: keyed rows buffer on the process that ingested them
and, at each epoch close, one all-to-all over ``torch.distributed``
routes them over every process's shards and the fold kernel folds them;
or, quantized, pre-reduced partial frames ride the gsync metadata round
and fold through ``csrc/agg_merge.cu``.

This is the keyed shuffle of the reference collapsed into the step:
``hash(key) → worker → routed_exchange → per-key callback`` becomes
``hash(key) → shard → bucket → fold``, with no host hop on the
exchange.

Snapshots of the per-process tiers stay in the host tier's per-key
scalar format, so recovery is interchangeable between the host tier,
the single-device tier, any mesh size, and the JAX package's stores.
The cluster-wide tier writes its own rows instead (sealed rounds and
full-aggregate baselines, in the JAX package's format), which resume
only into that tier.

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
from bytewax_tpu_torch.engine import wire as _wire
from bytewax_tpu_torch.engine.arrays import ArrayBatch, KeyEncoder, VocabMaps
from bytewax_tpu_torch.engine.scan_accel import ScanUpdates, _to_host
from bytewax_tpu_torch.engine.xla import (
    _NP_OF,
    DeviceAggState,
    NonNumericValues,
    _final_of,
    _snaps_of,
    _zip_held,
)
from bytewax_tpu_torch.ops.segment import AGG_KINDS, identity_for
from bytewax_tpu_torch.parallel.mesh import SHARD_AXIS, Mesh, local_devices, make_mesh

__all__ = [
    "GlobalAggState",
    "ShardedAggState",
    "ShardedScanState",
    "make_agg_state",
    "make_scan_state",
]

_MIN_CAP_PER_SHARD = 128
_MIN_ROWS_PER_SHARD = 64

#: Store row-key prefixes of the cluster-wide tier's own recovery rows
#: (its store-composable overlap), the JAX package's: NUL-prefixed so
#: they never collide with user keys.  The rows ride the recovery
#: ``snaps`` format; the keys are salted a process
#: (:meth:`GlobalAggState._mine_local_key`) so that route-scoped resume
#: reads give each process exactly its own rows.
_GSYNC_KEY_PREFIX = "\x00gsync-"
_GSYNC_BASE_KEY = "\x00gsync-base\x00"
_GSYNC_ROUND_KEY = "\x00gsync-round\x00"


def _gsync_overlap() -> bool:
    """Whether the cluster-wide tier double-buffers its exchange rounds
    (``BYTEWAX_TPU_GSYNC_OVERLAP``, default off: the lock-step tier)."""
    return os.environ.get("BYTEWAX_TPU_GSYNC_OVERLAP", "0") not in ("", "0")


def _gsync_depth() -> int:
    """How many overlapped exchange rounds may be in flight on the
    collective lane (``BYTEWAX_TPU_GSYNC_DEPTH``, default 1: double
    buffered).  Only read under ``BYTEWAX_TPU_GSYNC_OVERLAP=1``."""
    raw = os.environ.get("BYTEWAX_TPU_GSYNC_DEPTH", "1") or "1"
    try:
        depth = int(raw)
    except ValueError:
        msg = (
            f"BYTEWAX_TPU_GSYNC_DEPTH={raw!r} is not an integer; use "
            "the in-flight exchange-round bound (1 = double-buffered)"
        )
        raise ValueError(msg) from None
    return max(1, depth)


def _gsync_baseline_every() -> int:
    """With a recovery store under ``BYTEWAX_TPU_GSYNC_OVERLAP=1``, how
    many data-bearing exchange rounds ride between full-aggregate
    baseline rows (``BYTEWAX_TPU_GSYNC_BASELINE_EVERY``, default 8):
    resume replays at most this many sealed rounds on top of the latest
    baseline."""
    raw = os.environ.get("BYTEWAX_TPU_GSYNC_BASELINE_EVERY", "8") or "8"
    try:
        every = int(raw)
    except ValueError:
        msg = (
            f"BYTEWAX_TPU_GSYNC_BASELINE_EVERY={raw!r} is not an "
            "integer; use the rounds-per-baseline cadence"
        )
        raise ValueError(msg) from None
    return max(1, every)


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

    Tier selection, most-capable first, as the JAX package picks:

    - **cluster-wide exchange** (:class:`GlobalAggState`) when the
      driver has a cluster mesh, ``BYTEWAX_TPU_DISTRIBUTED=1``,
      ``BYTEWAX_TPU_GLOBAL_EXCHANGE`` is not ``0``, ``torch.distributed``
      is up and spans exactly the cluster's processes (more than one),
      and the flow has no recovery store, or has one and
      ``BYTEWAX_TPU_GSYNC_OVERLAP=1`` is set (the store-composable
      overlap: the tier snapshots its sealed rounds in recovery
      ``snaps`` rows and replays them on resume);
    - **per-process mesh** (:class:`ShardedAggState`) when
      :func:`_shard_devices` gives more than one device;
    - **single-device slot table** otherwise.

    The choice must be the same on every process: a failed probe of the
    distributed runtime raises rather than leave this process alone on
    another tier while its peers block in the collective flush.
    """
    if (
        driver is not None
        and driver.comm is not None
        and (driver.store is None or _gsync_overlap())
        and os.environ.get("BYTEWAX_TPU_DISTRIBUTED") == "1"
        and os.environ.get("BYTEWAX_TPU_GLOBAL_EXCHANGE", "1") != "0"
    ):
        try:
            import torch.distributed as dist

            from bytewax_tpu_torch.parallel.mesh import distributed_is_initialized

            eligible = (
                distributed_is_initialized()
                and dist.get_world_size() == driver.proc_count
                and dist.get_world_size() > 1
            )
        except Exception as ex:  # noqa: BLE001 — probe failed HERE only
            msg = (
                "BYTEWAX_TPU_DISTRIBUTED=1 is set but probing the "
                f"torch.distributed runtime failed on this process ({ex}); "
                "a silent per-process downgrade would deadlock the "
                "peers' collective flushes — fix the backend or run "
                "the whole cluster with BYTEWAX_TPU_GLOBAL_EXCHANGE=0"
            )
            raise RuntimeError(msg) from ex
        if eligible:
            return GlobalAggState(kind, driver)
    devices = _shard_devices()
    if devices is None:
        return DeviceAggState(kind)
    return ShardedAggState(kind, make_mesh(devices=devices))


def make_scan_state(scan_kind):
    """Build ``stateful_map`` scan state for one step: mesh-sharded
    (exchange + per-shard segmented scan + outputs home) when more
    than one local device is available, single-device otherwise.  Scans
    stay on these per-process tiers under ``BYTEWAX_TPU_DISTRIBUTED=1``,
    as in the JAX package."""
    from bytewax_tpu_torch.engine.scan_accel import DeviceScanState

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
        return _blocks_of(self.mesh, arr, rows_per_shard)

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
        kids = [self.key_to_kid.get(key) for key in keys]
        return _zip_held(keys, kids, self.snapshot_ids)

    def snapshot_ids(self, kids: np.ndarray) -> List[Any]:
        """Host-format snapshots of the keys holding wire ids ``kids``
        (see ``xla.DeviceAggState.snapshot_ids``)."""
        if self._fields is None:
            return [None] * len(kids)
        kids = np.asarray(kids, dtype=np.int64)
        idxs = (kids % self.n_shards) * self.cap_per_shard + kids // self.n_shards
        return _snaps_of(self.kind_name, self._fetch(), idxs)

    def release_ids(self, kids: np.ndarray) -> None:
        """Release the keys holding wire ids ``kids`` with one vocab
        drop for the batch (see ``xla.DeviceAggState.release_ids``)."""
        keys = self._kid_key
        for kid in kids.tolist():
            self._release(keys[kid])
        if len(kids):
            self._drop_vocab_ids(kids.tolist())

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


def _blocks_of(mesh: Mesh, arr: np.ndarray, rows_per_shard: int) -> List[torch.Tensor]:
    """A host array cut into per-shard source blocks on the shards'
    devices: one copy per run of shards on one device, each block a
    view of it."""
    blocks: List[torch.Tensor] = []
    for run in mesh.runs():
        part = np.ascontiguousarray(arr[run.start * rows_per_shard : run.stop * rows_per_shard])
        t = torch.from_numpy(part).to(mesh.devices[run.start])
        blocks.extend(t.view(len(run), rows_per_shard).unbind(0))
    return blocks


def _discard_result(_res) -> None:
    """Collective-lane finalize: the sealed task mutates the state it
    owns in place; nothing surfaces at finalize."""


class GlobalAggState:
    """Cluster-spanning keyed aggregation over every process's devices.

    Rows buffer on the process that ingested them and, at every epoch
    close (a point all processes reach in the same order through the
    close broadcast), one all-to-all over ``torch.distributed`` routes
    them to their owner shard and the fold kernel folds them
    (:func:`bytewax_tpu_torch.ops.sharded.make_global_step`).  The TCP
    mesh carries only a small metadata round per flush (new keys, row
    counts, the dtype vote) through ``driver.global_sync``.

    Key placement is lane-aligned: a key's owner shard lives on the
    process that owns the key's worker lane (``route_hash %
    worker_count``), spread over that process's shards, so emission at
    EOF needs no extra routing hop.  Slot assignment is deterministic
    (merged new keys in sorted order), so every process holds the same
    key→kid map without negotiation.

    With ``BYTEWAX_TPU_GSYNC_QUANT`` armed, buffered rows pre-reduce per
    key, and block-quantized partial frames ride the metadata round
    instead (``engine/wire.py``); every process folds every peer's frame
    into merge tables on its first device
    (:func:`bytewax_tpu_torch.engine.xla.agg_merge`, ``csrc/agg_merge.cu``
    on a card), or on the host under ``BYTEWAX_TPU_WIRE=pickle``.

    With ``BYTEWAX_TPU_GSYNC_OVERLAP=1`` the sealed exchange of a close
    runs on one ordered lane a driver (``BYTEWAX_TPU_GSYNC_DEPTH`` rounds
    in flight) while the run loop computes later epochs.

    With a recovery store (only under the overlap, ``make_agg_state``)
    the tier's durable unit is the sealed round: every data-bearing
    round stashes a row of this process's part of it, and every
    ``BYTEWAX_TPU_GSYNC_BASELINE_EVERY`` rounds a fenced full-aggregate
    baseline row replaces the round rows it covers.  Resume installs the
    latest baseline and replays the rounds after it at the first flush,
    through the same kernels.  The rows are the JAX package's, so a
    store crosses between the packages both ways.
    """

    global_exchange = True

    #: Per-shard slot capacity; keys-per-shard beyond this raise (the
    #: blocks would have to be resized collectively).
    CAP_PER_SHARD = 4096
    #: Rows per device per exchange step: big flushes run as repeats of
    #: this shape, so exchange buffers stay bounded.
    CHUNK_PER_DEV = 1 << 18

    def __init__(self, kind_name: str, driver):
        from bytewax_tpu_torch.parallel.mesh import world

        self.kind_name = kind_name
        self.kind = AGG_KINDS[kind_name]
        self.driver = driver
        w = world()
        if w is None or w.proc_count != driver.proc_count:
            msg = (
                "the cluster-wide exchange needs the torch.distributed "
                "world that the driver joins at start-up under "
                "BYTEWAX_TPU_DISTRIBUTED=1; it has not been joined"
            )
            raise RuntimeError(msg)
        missing = [p for p, ds in enumerate(w.devices) if ds is None]
        if missing:
            msg = (
                f"the cluster-wide exchange needs a device on every "
                f"process; process(es) {missing} have none (no CUDA card, "
                "and BYTEWAX_TPU_PLATFORM=cpu was not asked for)"
            )
            raise RuntimeError(msg)
        counts = {len(ds) for ds in w.devices}
        if len(counts) != 1:
            msg = (
                "the global-mesh exchange needs the same local device "
                f"count on every process; got "
                f"{ {p: len(ds) for p, ds in enumerate(w.devices)} } — run "
                "with BYTEWAX_TPU_GLOBAL_EXCHANGE=0 or equalize "
                "the cards each process sees"
            )
            raise RuntimeError(msg)
        self.world = w
        self.local_devs = counts.pop()
        self.n_shards = self.local_devs * w.proc_count
        #: proc id -> the global shard indices of its devices.
        self._proc_shards = {
            p: list(range(p * self.local_devs, (p + 1) * self.local_devs))
            for p in range(w.proc_count)
        }
        self.cap_per_shard = self.CAP_PER_SHARD
        self.mesh = make_mesh(devices=w.local)
        #: Where the quantized mode's merge tables live.
        self.device = self.mesh.devices[0]
        #: Full global key→kid map, identical on every process.
        self.key_to_kid: Dict[str, int] = {}
        self._shard_fill = [0] * self.n_shards
        #: Buffered local rows awaiting the next flush, dictionary
        #: encoded: per-row dense local ids into ``_dense_keys``.
        self._buf_ids: List[np.ndarray] = []
        self._buf_vals: List[np.ndarray] = []
        self._buf_all_int = True
        self._dense_keys: List[str] = []
        self._dense_map: Dict[str, int] = {}
        self._vocab = VocabMaps(dtype=np.int32)
        self._fields: Optional[List[Dict[str, torch.Tensor]]] = None
        self.dtype = None  # decided collectively at the first flush
        self._round = 0
        self._steps: Dict[Tuple[int, int, Any], Any] = {}
        #: Quantized aggregate exchange: the mode, agreed at every flush.
        self._quant = _wire.gsync_quant()
        #: Host-side merged partial fields (quant mode), indexed like
        #: the device blocks (``n_shards * cap_per_shard``).
        self._host_fields: Optional[Dict[str, np.ndarray]] = None
        #: Whether every merged flush so far was all-integer.
        self._quant_int = True
        #: Device merge tables (quant mode); ``_merge_demoted`` pins the
        #: host fold (``BYTEWAX_TPU_WIRE=pickle``, or an exact integer
        #: part the int32 tables cannot hold).
        self._dev_fields: Optional[Dict[str, torch.Tensor]] = None
        self._merge_demoted = _wire.wire_mode() == "pickle"
        #: The store-composable overlap: data-bearing rounds so far,
        #: the round rows not yet covered by a baseline, rows waiting
        #: for the next epoch snapshot, resumed rows waiting for the
        #: first flush, and whether a baseline row is live.
        self._data_rounds = 0
        self._outstanding_rounds: List[str] = []
        self._pending_snap_rows: List[Tuple[str, Any]] = []
        self._resume_rows: List[Tuple[str, Any]] = []
        self._base_written = False
        #: The overlapped exchange lane, one a driver, shared by every
        #: step of this tier: seal order is the agreed round order, so
        #: the collectives launch in the same sequence on every process.
        self._lane = None
        if _gsync_overlap():
            if getattr(driver, "_gsync_lane", None) is None:
                from bytewax_tpu_torch.engine.pipeline import DevicePipeline

                driver._gsync_lane = DevicePipeline(
                    "gsync", depth=_gsync_depth() + 1, phase="collective_lane"
                )
            self._lane = driver._gsync_lane

    # -- placement -----------------------------------------------------------

    def _owner_shard(self, key: str) -> int:
        h = zlib.adler32(key.encode())
        w = h % self.driver.worker_count
        p = self.driver.owner_proc(w)
        shards = self._proc_shards[p]
        return shards[(h // max(1, self.driver.worker_count)) % len(shards)]

    def _global_idx(self, kid: int) -> int:
        shard, slot = kid % self.n_shards, kid // self.n_shards
        return shard * self.cap_per_shard + slot

    def _bind_device(self) -> None:
        """Make this tier's first card the current device of the calling
        thread (the current CUDA device is per thread, and the lane runs
        on its own)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    # -- buffering update surface -------------------------------------------

    def _dense_alloc(self, keys: List[str]) -> List[int]:
        out = []
        for k in keys:
            did = self._dense_map.get(k)
            if did is None:
                did = len(self._dense_keys)
                self._dense_map[k] = did
                self._dense_keys.append(k)
            out.append(did)
        return out

    def _check_values(self, values: np.ndarray) -> None:
        if values.dtype == object or values.dtype.kind in "US":
            msg = (
                "device-accelerated reduction requires numeric values; "
                "pass a plain Python reducer for non-numeric data"
            )
            raise NonNumericValues(msg)
        if np.issubdtype(values.dtype, np.integer):
            if values.dtype.itemsize > 4 and len(values) and (
                values.max() > np.iinfo(np.int32).max or values.min() < np.iinfo(np.int32).min
            ):
                msg = (
                    "device-accelerated reduction over integers wider "
                    "than 32 bits is not exact; pass a plain Python "
                    "reducer"
                )
                raise NonNumericValues(msg)
        elif self.dtype == torch.int32:
            # Integral in-range floats after an int lock cast losslessly
            # at flush; anything else would silently truncate.
            if len(values) and (
                np.any(values % 1)
                or values.max() > np.iinfo(np.int32).max
                or values.min() < np.iinfo(np.int32).min
            ):
                msg = (
                    "non-integral float values arrived after earlier "
                    "batches locked this step's global state to an "
                    "integer dtype; pass a plain Python reducer for "
                    "mixed int/float streams"
                )
                raise TypeError(msg)
        else:
            self._buf_all_int = False

    def update(self, keys: np.ndarray, values: np.ndarray) -> List[str]:
        from bytewax_tpu_torch.engine.arrays import factorize_keys

        keys = np.asarray(keys)
        values = np.asarray(values)
        self._check_values(values)
        codes, uniq = factorize_keys(keys)
        uniq_list = [str(k) for k in uniq.tolist()]
        dense_of = np.asarray(self._dense_alloc(uniq_list), dtype=np.int32)
        self._buf_ids.append(dense_of[codes])
        self._buf_vals.append(values.astype(np.float64))
        return uniq_list

    def update_items(self, items) -> Optional[List[str]]:
        # The driver promotes itemized rows itself when this returns
        # None.
        return None

    def update_batch(self, batch: ArrayBatch) -> List[str]:
        values = batch.numpy("value")
        if batch.value_scale is not None:
            values = values * batch.value_scale
        if "key_id" in batch.cols and batch.key_vocab is not None:
            # Dictionary-encoded: external ids map to dense ids through
            # the lineage's append-only vocabulary map.
            ids = batch.numpy("key_id").astype(np.int64)
            self._check_values(values)
            _origin, vmap, _fresh = self._vocab.of(batch.key_vocab)
            uniq_ext = vmap.sync(ids, batch.key_vocab, self._dense_alloc)
            self._buf_ids.append(vmap.table[ids])
            self._buf_vals.append(values.astype(np.float64))
            return [str(vmap.vocab[e]) for e in uniq_ext.tolist()]
        if "key" in batch.cols:
            return self.update(batch.numpy("key"), values)
        msg = (
            "columnar batch feeding an accelerated keyed "
            "aggregation needs a 'key' or dictionary-encoded "
            "'key_id' column"
        )
        raise TypeError(msg)

    def keys(self) -> List[str]:
        known = set(self.key_to_kid)
        known.update(self._dense_keys)
        return sorted(known)

    def discard(self, key: str) -> None:  # pragma: no cover - EOF clears
        self.key_to_kid.pop(key, None)

    # -- the collective flush -------------------------------------------------

    def _assign_kids(self, new_keys: List[str]) -> None:
        for k in new_keys:
            if k in self.key_to_kid:
                continue
            shard = self._owner_shard(k)
            slot = self._shard_fill[shard]
            if slot >= self.cap_per_shard - 1:
                msg = (
                    f"global-exchange shard {shard} is full "
                    f"({self.cap_per_shard - 1} keys; the last slot "
                    "is exchange scratch); raise "
                    "GlobalAggState.CAP_PER_SHARD"
                )
                raise RuntimeError(msg)
            self._shard_fill[shard] = slot + 1
            self.key_to_kid[k] = slot * self.n_shards + shard

    def _ensure_fields(self) -> None:
        from bytewax_tpu_torch.ops.sharded import init_sharded_fields

        if self._fields is None:
            self._fields = init_sharded_fields(self.kind, self.mesh, self.cap_per_shard, self.dtype)

    def _step_for(self, rows_per_dev: int, capacity: int):
        from bytewax_tpu_torch.ops.sharded import make_global_step

        # dtype is part of the key: finalize() resets the dtype and the
        # next lock may pick the other one.
        key = (rows_per_dev, capacity, self.dtype)
        step = self._steps.get(key)
        if step is None:
            step = make_global_step(
                self.mesh, self.world, self.kind_name, self.cap_per_shard, capacity, dtype=self.dtype
            )
            self._steps[key] = step
        return step

    def fence(self) -> None:
        """Wait out every in-flight overlapped round on the (driver
        shared) collective lane: any read of the global result
        (finalize) and the run-ending close; nothing per batch."""
        if self._lane is not None:
            self._lane.flush()

    def lane_status(self) -> Optional[Dict[str, int]]:
        """Collective-lane introspection for /status and /graph: sealed
        rounds in flight and the configured depth; None when the
        lock-step tier runs (no lane)."""
        if self._lane is None:
            return None
        return {"in_flight": len(self._lane), "depth": self._lane.depth - 1}

    def lane_shutdown(self) -> None:
        """Teardown (driver ``pipeline_shutdown``, fault unwinds): stop
        the driver-shared lane.  Pending work exists only on a fault
        path, and its sealed rounds run to their end instead of being
        dropped (a failing one is passed over): a round is sealed only
        after the agreed metadata rounds, so every process sealed it,
        and a peer may be inside its all-to-all already.  Dropped on
        this process, the peer's collective would wait out the
        transport's timeout, or pair with this process's first
        collective after the restart (the world outlives the restart)."""
        lane, self._lane = self._lane, None
        if lane is not None:
            while lane.pending():
                try:
                    lane.flush()
                except Exception:  # noqa: BLE001 — already on a fault path
                    import logging

                    logging.getLogger(__name__).warning(
                        "a sealed gsync round failed while its lane shut down", exc_info=True
                    )
            lane.shutdown()
            if getattr(self.driver, "_gsync_lane", None) is lane:
                self.driver._gsync_lane = None

    def _note_flush(self, n_local: int, total_rows: int, n_steps: int, detail: str) -> None:
        """Record one sealed-and-launched exchange round (flight ring
        and the debug line, which names the transport)."""
        _flight.RECORDER.record("global_flush", rows=n_local, total_rows=total_rows, steps=n_steps)
        if os.environ.get("BYTEWAX_TPU_GLOBAL_EXCHANGE_DEBUG") == "1":
            import sys

            # One write a line: peers share the stream.
            sys.stderr.write(
                f"global-exchange: proc {self.driver.proc_id} flushed "
                f"{n_local}/{total_rows} rows over {self.n_shards} "
                f"shards in {n_steps} step(s), {detail}; transport "
                f"{self.world.describe()}\n"
            )
            sys.stderr.flush()

    def flush(self) -> None:
        """One collective exchange-and-fold round.  Every process calls
        this the same number of times in the same global order (epoch
        close and the EOF ladder guarantee it); a round where the whole
        cluster has nothing buffered skips the device step but still
        runs the metadata round.  The metadata rounds run here, on the
        main thread; under overlap the sealed device phase runs on the
        lane.  With a store, the first flush of a resumed run replays
        the store's rounds first, and each data-bearing round stashes
        its row (:meth:`_stash_round`)."""
        driver = self.driver
        self._maybe_replay_resume()
        n_local = int(sum(len(a) for a in self._buf_vals))
        local_new = sorted(k for k in self._dense_keys if k not in self.key_to_kid)
        quant = self._quant
        frames = self._local_partial_frames() if quant != "off" else None
        # Every process runs the same sequence of sync rounds, so the
        # driver's monotone counter names the round cluster-wide.
        tag = ("gagg", driver.next_gsync_tag())
        self._round += 1
        replies = driver.global_sync(tag, (local_new, n_local, self._buf_all_int, quant, frames))
        modes = {r[3] for r in replies.values()}
        if len(modes) != 1:
            msg = (
                "cluster processes disagree on BYTEWAX_TPU_GSYNC_QUANT "
                f"({sorted(modes)}); the quantized aggregate exchange "
                "must be armed identically on every process"
            )
            raise RuntimeError(msg)
        merged_new = sorted({k for new, *_rest in replies.values() for k in new})
        total_rows = sum(r[1] for r in replies.values())
        all_int = all(r[2] for r in replies.values())
        self._assign_kids(merged_new)
        if total_rows == 0:
            self._buf_ids.clear()
            self._buf_vals.clear()
            return
        self._data_rounds += 1
        if quant != "off":
            # The partial frames rode the round; seal the merge on main
            # (decode, targets against the main-owned key_to_kid) and
            # fold on the device or the host.
            self._buf_ids.clear()
            self._buf_vals.clear()
            self._quant_int = self._quant_int and all_int
            peer_frames = [replies[pid][4] for pid in sorted(replies)]
            n_frames = sum(len(f or ()) for f in peer_frames)
            sealed = self._seal_merge(peer_frames)

            def merge_task():
                self._apply_merge(sealed)

            # Inline (lock-step) or on the lane; the push site names the
            # task itself, so the analyzer traces it as a lane root.
            if self._lane is None:
                merge_task()
            else:
                self._lane.push(merge_task, _discard_result)
            where = "host" if sealed["device"] is False else "device"
            self._note_flush(
                n_local,
                total_rows,
                1,
                f"{n_frames} quantized partial frame(s) [{quant}, {where} merge]",
            )
            self._stash_round(
                lambda: {
                    "fmt": "quant",
                    "round": self._data_rounds,
                    "frames": peer_frames,
                    "new": merged_new,
                    "all_int": all_int,
                }
            )
            return
        if self.dtype is None:
            self.dtype = torch.int32 if all_int else torch.float32
        elif self.dtype == torch.int32 and not all_int:
            msg = (
                "non-integral float values arrived after earlier "
                "batches locked this step's global state to an "
                "integer dtype; pass a plain Python reducer for "
                "mixed int/float streams"
            )
            raise TypeError(msg)
        self._ensure_fields()

        # Chunk layout, the same on every process (from the synced
        # per-process maximum): big flushes run as fixed-shape steps.
        max_rows = max(n for _new, n, *_rest in replies.values())
        chunk_pd = min(
            _pow2(-(-max_rows // self.local_devs), int(math.log2(_MIN_ROWS_PER_SHARD))),
            self.CHUNK_PER_DEV,
        )
        chunk_rows = chunk_pd * self.local_devs
        n_steps = -(-max_rows // chunk_rows)
        pad_total = n_steps * chunk_rows

        ids_cat = np.concatenate(self._buf_ids) if self._buf_ids else np.empty(0, dtype=np.int32)
        vals_cat = np.concatenate(self._buf_vals) if self._buf_vals else np.empty(0, dtype=np.float64)
        self._buf_ids.clear()
        self._buf_vals.clear()
        # Kid resolution per distinct key, then one gather per row.
        kid_map = self.key_to_kid
        kid_of_dense = np.fromiter(
            (kid_map[k] for k in self._dense_keys), dtype=np.int32, count=len(self._dense_keys)
        )
        kids = kid_of_dense[ids_cat] if len(ids_cat) else np.empty(0, dtype=np.int32)
        kids_p = np.zeros(pad_total, dtype=np.int32)
        kids_p[:n_local] = kids
        vals_p = np.zeros(pad_total, dtype=_NP_OF[self.dtype])
        vals_p[:n_local] = vals_cat
        valid_p = np.zeros(pad_total, dtype=bool)
        valid_p[:n_local] = True

        # Exact exchange capacity: the local per-(step, source block,
        # destination shard) maximum, then one more metadata round for
        # the cluster's maximum, so every split of the all-to-all has
        # the same size and no row is dropped.
        idx = np.arange(n_local)
        blk = (idx // chunk_rows) * self.local_devs + ((idx % chunk_rows) // chunk_pd)
        pair_counts = np.bincount(
            blk * self.n_shards + (kids % self.n_shards),
            minlength=n_steps * self.local_devs * self.n_shards,
        )
        local_max = int(pair_counts.max()) if len(pair_counts) else 0
        cap_replies = driver.global_sync(("gagg", driver.next_gsync_tag()), local_max)
        capacity = _pow2(max(cap_replies.values()), 4)

        _flight.note_transfer("h2d", kids_p.nbytes + vals_p.nbytes + valid_p.nbytes)
        step = self._step_for(chunk_pd, capacity)

        def exchange_task():
            self._exchange_chunks(step, kids_p, vals_p, valid_p, chunk_rows, chunk_pd, n_steps)

        if self._lane is None:
            exchange_task()
        else:
            self._lane.push(exchange_task, _discard_result)
        self._note_flush(n_local, total_rows, n_steps, f"capacity {capacity}")
        self._stash_round(
            lambda: {
                "fmt": "exact",
                "round": self._data_rounds,
                "kids": kids,
                "vals": vals_cat,
                "new": merged_new,
                "chunk_pd": chunk_pd,
                "capacity": capacity,
                "n_steps": n_steps,
                "dtype": np.dtype(_NP_OF[self.dtype]).name,
                "layout": self._layout_fields(),
            }
        )

    def _exchange_chunks(
        self,
        step,
        kids_p: np.ndarray,
        vals_p: np.ndarray,
        valid_p: np.ndarray,
        chunk_rows: int,
        chunk_pd: int,
        n_steps: int,
    ) -> None:
        """Run one sealed round's chunk sequence (the device phase)."""
        self._bind_device()
        for c in range(n_steps):
            sl = slice(c * chunk_rows, (c + 1) * chunk_rows)
            blocks = [_blocks_of(self.mesh, a[sl], chunk_pd) for a in (kids_p, vals_p, valid_p)]
            self._fields = step(self._fields, *blocks)

    def _local_partial_frames(self) -> List[bytes]:
        """Pre-reduce this process's buffered rows per key and frame the
        partial-aggregate columns for the gsync round: one ``key``
        column (exact) plus one column a state field (``count`` and
        all-integer partials exact, float partials block-quantized per
        the armed mode)."""
        if not self._dense_keys or not self._buf_ids:
            return []
        ids = np.concatenate(self._buf_ids)
        vals = np.concatenate(self._buf_vals)
        if not len(ids):
            return []
        # Remap to the touched dense ids only: work scales with this
        # flush's rows and keys, never with the key history.
        uniq, inv = np.unique(ids, return_inverse=True)
        n_touched = len(uniq)
        dense_keys = self._dense_keys
        cols: Dict[str, np.ndarray] = {"key": np.array([dense_keys[i] for i in uniq.tolist()])}
        counts = np.bincount(inv, minlength=n_touched)
        for name, (_init, op) in self.kind.fields.items():
            if name == "count":
                arr = counts.astype(np.int64)
            else:
                if op == "add":
                    arr = np.bincount(inv, weights=vals, minlength=n_touched)
                elif op == "min":
                    arr = np.full(n_touched, np.inf)
                    np.minimum.at(arr, inv, vals)
                else:
                    arr = np.full(n_touched, -np.inf)
                    np.maximum.at(arr, inv, vals)
                if self._buf_all_int:
                    # All-integer rows ship exact int64 partials.
                    arr = np.rint(arr).astype(np.int64)
            cols[name] = arr
        return _wire.encode_agg(cols, self._quant)

    def _merge_dtype(self, name: str) -> str:
        """Device merge-table dtype for one field: ``count``, and every
        field while the cluster-agreed all-int lock holds, folds on
        int32 tables; once any peer ships floats the value fields
        promote to float32."""
        if name == "count" or self._quant_int:
            return "int32"
        return "float32"

    def _seal_merge(self, peer_frames: List[Any]) -> Dict[str, Any]:
        """Seal one quantized round's merge on the main thread: decode
        every peer frame's raw parts and resolve scatter targets
        against ``key_to_kid`` (the sealed task never reads main
        state).  Decides device or host by the sticky
        ``_merge_demoted`` flag: an exact integer part that the int32
        tables cannot hold demotes the merge to the host fold for the
        rest of the run (the same on every process: the frames are the
        same).  Device-bound parts keep their length: the port has no
        shape ladder (``engine/batching.py``), and the kernel takes any
        row count.  A device-bound round is packed into one buffer
        (:func:`~bytewax_tpu_torch.engine.xla.pack_merge_round`, pinned
        where the tables lie on a card), each field's table dtype
        decided once for the round.  Each frame's real targets are
        asserted unique: the merge kernel folds one row a slot and
        refuses a frame that repeats one."""
        from bytewax_tpu_torch.engine import xla as _xla

        decoded = []
        for frames in peer_frames:
            for frame in frames or ():
                parts = _wire.decode_agg_parts(frame)
                kp = parts.get("key")
                if kp is None or not len(kp[1]):
                    continue
                decoded.append((kp[1], {n: parts[n] for n in self.kind.fields}))
        if not self._merge_demoted and self._needs_host_fold(decoded):
            self._demote_merge()
        kid_map = self.key_to_kid
        size = self.n_shards * self.cap_per_shard
        names = list(self.kind.fields)
        dtypes = [self._merge_dtype(name) for name in names]
        sealed = []
        for keys, fields in decoded:
            n = len(keys)
            gidx = np.fromiter(
                (self._global_idx(kid_map[k]) for k in keys.tolist()), dtype=np.int64, count=n
            )
            if np.bincount(gidx, minlength=size).max() > 1:
                msg = "a gsync partial frame names one key twice"
                raise AssertionError(msg)
            if self._merge_demoted:
                sealed.append((gidx, fields))
                continue
            parts_of = []
            for name, want in zip(names, dtypes):
                enc, parts = fields[name]
                if enc == "int8":
                    arrays = tuple(parts)
                elif enc == "bf16":
                    arrays = (np.asarray(parts).view(np.int16),)
                else:  # raw, cast to the table dtype (lossless:
                    # _needs_host_fold demoted anything that is not)
                    arrays = (np.asarray(parts).astype(np.dtype(want)),)
                parts_of.append((enc, arrays))
            sealed.append((gidx.astype(np.int32), n, parts_of))
        if self._merge_demoted:
            return {"device": False, "frames": sealed}
        rnd = _xla.pack_merge_round(sealed, len(names), pin=self.device.type == "cuda")
        _flight.note_transfer("h2d", rnd.nbytes)
        _flight.RECORDER.count("gsync_merge_h2d_bytes", rnd.nbytes)
        return {"device": True, "round": rnd, "dtypes": dtypes}

    def _needs_host_fold(self, decoded: List[Any]) -> bool:
        """Whether an exact part of this round cannot fold on the
        device tables: an integer column bound for an int32 table whose
        values overflow it."""
        info = np.iinfo(np.int32)
        for _keys, fields in decoded:
            for name in self.kind.fields:
                enc, parts = fields[name]
                if enc != "raw" or self._merge_dtype(name) != "int32":
                    continue
                arr = np.asarray(parts)
                if arr.dtype.kind not in "iu":
                    return True
                if arr.dtype.itemsize > 4 and len(arr) and (arr.max() > info.max or arr.min() < info.min):
                    return True
        return False

    def _demote_merge(self) -> None:
        """Sticky demotion to the host fold (main thread): fence any
        in-flight device merge, fetch the device tables into the host
        blocks, and fold on the host from here on."""
        self._merge_demoted = True
        if self._dev_fields is None:
            return
        self.fence()
        self._host_fields = self._fetch_dev_fields()
        self._dev_fields = None

    def _fetch_dev_fields(self) -> Dict[str, np.ndarray]:
        """One device→host fetch of the merge tables (float64 host
        blocks): the device merge's only d2h (finalize, demotion)."""
        host = {}
        d2h = 0
        for name, table in self._dev_fields.items():
            raw = table.cpu().numpy()
            d2h += raw.nbytes
            host[name] = raw.astype(np.float64)
        _flight.note_transfer("d2h", d2h)
        _flight.RECORDER.count("gsync_fetch_d2h_bytes", d2h)
        return host

    def _apply_merge(self, sealed: Dict[str, Any]) -> None:
        """Fold one sealed round (on the lane under overlap, inline
        otherwise).  Every process folds the same frames in the same
        order, so the merged tables stay the same on every process."""
        if sealed["device"]:
            self._apply_merge_device(sealed["round"], sealed["dtypes"])
        else:
            self._apply_merge_host(sealed["frames"])

    def _apply_merge_host(self, sealed_frames: List[Any]) -> None:
        """The host fold (``BYTEWAX_TPU_WIRE=pickle``, and the oracle in
        tests): dequantize each part to float64 and scatter into host
        field blocks."""
        if self._host_fields is None:
            size = self.n_shards * self.cap_per_shard
            self._host_fields = {
                name: np.full(size, init, dtype=np.float64)
                for name, (init, _op) in self.kind.fields.items()
            }
        host_bytes = 0
        for gidx, fields in sealed_frames:
            for name, (_init, op) in self.kind.fields.items():
                enc, parts = fields[name]
                vals = np.asarray(_wire.dequant_part(enc, parts), dtype=np.float64)
                host_bytes += vals.nbytes
                tgt = self._host_fields[name]
                if op == "add":
                    np.add.at(tgt, gidx, vals)
                elif op == "min":
                    np.minimum.at(tgt, gidx, vals)
                else:
                    np.maximum.at(tgt, gidx, vals)
        _flight.RECORDER.count("gsync_merge_host_bytes", host_bytes)

    def _apply_merge_device(self, rnd, dtypes: List[str]) -> None:
        """The device fold: upload the sealed round's packed buffer in
        one copy and dequantize, merge and scatter every frame's fields
        on the device in one launch
        (:func:`~bytewax_tpu_torch.engine.xla.agg_merge_round`), frames
        in peer order; the tables stay on the device between closes."""
        from bytewax_tpu_torch.engine import xla as _xla

        if not rnd.n_frames:
            return
        self._bind_device()
        size = self.n_shards * self.cap_per_shard
        if self._dev_fields is None:
            self._dev_fields = {}
        tables = self._dev_fields
        dev = self.device
        ops = []
        for (name, (init, op)), want in zip(self.kind.fields.items(), dtypes):
            table = tables.get(name)
            if table is None:
                table = _xla.agg_merge_table(size, init, want, dev)
            elif table.dtype != _xla._TABLE_DTYPES[want]:
                # The int32 → float32 promotion at the first round that
                # is not all-integer, in round order: the same on every
                # process, and before the launch, so a round never
                # mixes table dtypes.
                table = table.to(torch.float32)
            tables[name] = table
            ops.append(op)
        _xla.agg_merge_round([tables[name] for name in self.kind.fields], ops, rnd.to(dev))

    # -- the store-composable overlap -----------------------------------------

    def _mine_local_key(self, base: str) -> str:
        """A deterministic store row key from ``base`` whose worker lane
        (``adler32 % worker_count``: the route the store stamps and the
        driver's resume reads scope by) is one of this process's, so the
        row comes back to the process that wrote it."""
        d = self.driver
        salt = 0
        while True:
            key = f"{base}{salt}"
            if d.is_local(zlib.adler32(key.encode()) % d.worker_count):
                return key
            salt += 1

    def _base_key(self) -> str:
        return self._mine_local_key(_GSYNC_BASE_KEY)

    def _round_key(self, round_no: int) -> str:
        return self._mine_local_key(f"{_GSYNC_ROUND_KEY}{round_no:08d}\x00")

    def _stash_round(self, payload_fn) -> None:
        """With a recovery store, make this data-bearing round durable:
        stash a round row for this close's snapshot, or, every
        ``BYTEWAX_TPU_GSYNC_BASELINE_EVERY`` rounds, fence the lane (the
        captured table must hold every sealed round) and stash a
        full-aggregate baseline row instead (the same key each time, so
        the store's latest row supersedes), with tombstones for the
        round rows it covers.  The decision derives from agreed values,
        so every process stashes rows for the same rounds."""
        if self.driver.store is None:
            return
        if self._data_rounds % _gsync_baseline_every() == 0:
            self.fence()
            self._pending_snap_rows.append((self._base_key(), self._capture_baseline()))
            self._base_written = True
            self._pending_snap_rows.extend((k, None) for k in self._outstanding_rounds)
            self._outstanding_rounds = []
            return
        key = self._round_key(self._data_rounds)
        self._pending_snap_rows.append((key, payload_fn()))
        self._outstanding_rounds.append(key)

    def _layout(self) -> str:
        return (
            f"{self.n_shards} shard(s) of {self.cap_per_shard} slots, "
            f"{self.local_devs} a process"
        )

    def _layout_fields(self) -> Dict[str, int]:
        """What an exact round row's ``kids`` and chunk layout depend
        on: a kid is ``slot * n_shards + shard``, and each process
        buckets its chunks over its own shards.  The JAX package reads
        round rows by key and passes over this one."""
        return {
            "procs": self.driver.proc_count,
            "shards": self.n_shards,
            "cap": self.cap_per_shard,
            "local_devs": self.local_devs,
        }

    def _check_round_layout(self, payload: Dict[str, Any]) -> None:
        """Refuse an exact round row sealed by a cluster of another
        layout (its kids would fold into other keys' slots here).  A
        row with no layout, as the JAX package writes it, replays as
        before."""
        theirs = payload.get("layout")
        if payload["fmt"] != "exact" or theirs is None or theirs == self._layout_fields():
            return
        msg = (
            "the global-exchange tier cannot replay the store's round "
            f"{payload['round']}: it was laid out for {theirs['shards']} "
            f"shard(s) of {theirs['cap']} slots, {theirs['local_devs']} a "
            f"process, over {theirs['procs']} process(es), this cluster "
            f"has {self._layout()} over {self.driver.proc_count} "
            "process(es); resume with the device count a process the "
            "store was written with, or run with "
            "BYTEWAX_TPU_GLOBAL_EXCHANGE=0"
        )
        raise RuntimeError(msg)

    def _capture_baseline(self) -> Dict[str, Any]:
        """The full merged aggregate (the caller fenced the lane) in the
        JAX package's host format, so that a baseline written by either
        package installs in the other: quantized, ``fields`` holds a
        float64 table a field over every shard; exact, ``blocks`` holds
        ``{field: {global offset: block}}`` of this process's shards."""
        base: Dict[str, Any] = {
            "round": self._data_rounds,
            "key_to_kid": dict(self.key_to_kid),
            "shard_fill": list(self._shard_fill),
            "procs": self.driver.proc_count,
        }
        if self._quant != "off":
            if self._dev_fields is not None:
                fields = self._fetch_dev_fields()
            elif self._host_fields is not None:
                fields = {n: a.copy() for n, a in self._host_fields.items()}
            else:
                fields = None
            base.update(fmt="quant", fields=fields, quant_int=self._quant_int)
            return base
        blocks = None
        if self._fields is not None:
            cap = self.cap_per_shard
            lo = self._proc_shards[self.driver.proc_id][0]
            blocks = {
                name: {(lo + d) * cap: flat[d * cap : (d + 1) * cap] for d in range(self.local_devs)}
                for name, flat in self._local_host_fields().items()
            }
        base.update(
            fmt="exact",
            blocks=blocks,
            dtype=np.dtype(_NP_OF[self.dtype]).name if self.dtype is not None else None,
        )
        return base

    def _check_baseline_layout(self, base: Dict[str, Any]) -> None:
        """Refuse a baseline laid out for another cluster: another
        process count (as the JAX package refuses), or the same count
        over another number of shards or slots, whose kids and table
        offsets would land in the wrong slots here."""
        if base.get("procs") != self.driver.proc_count:
            msg = (
                "the global-exchange tier cannot rescale on resume: "
                f"the store's baseline was written by {base.get('procs')} "
                f"process(es), this cluster runs {self.driver.proc_count}; "
                "resume at the original size or run with "
                "BYTEWAX_TPU_GLOBAL_EXCHANGE=0"
            )
            raise RuntimeError(msg)
        shards = len(base["shard_fill"])
        cap = None
        if base["fmt"] == "quant" and base["fields"] is not None:
            cap = len(next(iter(base["fields"].values()))) // max(shards, 1)
        elif base["fmt"] == "exact" and base["blocks"] is not None:
            cap = len(next(iter(next(iter(base["blocks"].values())).values())))
        if shards != self.n_shards or cap not in (None, self.cap_per_shard):
            theirs = f"{shards} shard(s)" + (f" of {cap} slots" if cap is not None else "")
            msg = (
                "the global-exchange tier cannot install the store's "
                f"baseline: it was laid out for {theirs} over "
                f"{base['procs']} process(es), this cluster has "
                f"{self._layout()}; resume with the device count a "
                "process the store was written with, or run with "
                "BYTEWAX_TPU_GLOBAL_EXCHANGE=0"
            )
            raise RuntimeError(msg)

    def _install_baseline(self, base: Dict[str, Any]) -> None:
        """Install a baseline row (see :meth:`_capture_baseline`): one
        host→device copy a field (a run of shards on one device),
        never one a block."""
        self._check_baseline_layout(base)
        self.key_to_kid = dict(base["key_to_kid"])
        self._shard_fill = list(base["shard_fill"])
        self._data_rounds = base["round"]
        self._base_written = True
        if base["fmt"] == "quant":
            self._quant_int = base["quant_int"]
            fields = base["fields"]
            if fields is None:
                return
            if self._merge_demoted:
                self._host_fields = {n: np.asarray(a, dtype=np.float64) for n, a in fields.items()}
                return
            self._bind_device()
            self._dev_fields = {}
            h2d = 0
            for name, arr in fields.items():
                host = np.ascontiguousarray(np.asarray(arr).astype(self._merge_dtype(name)))
                h2d += host.nbytes
                self._dev_fields[name] = torch.from_numpy(host).to(self.device)
            _flight.note_transfer("h2d", h2d)
            return
        if base["dtype"] is not None:
            self.dtype = torch.int32 if base["dtype"] == "int32" else torch.float32
        blocks = base["blocks"]
        if blocks is None:
            return
        cap = self.cap_per_shard
        lo = self._proc_shards[self.driver.proc_id][0]
        starts = [(lo + d) * cap for d in range(self.local_devs)]
        per_field = {}
        h2d = 0
        for name in self.kind.fields:
            per = blocks[name]
            missing = [start for start in starts if start not in per]
            if missing:
                msg = (
                    "the global-exchange tier cannot install the store's "
                    f"baseline: it holds no block at offset(s) {missing} "
                    f"of field {name!r}, which this process's shards "
                    f"cover ({self._layout()})"
                )
                raise RuntimeError(msg)
            host = np.concatenate([np.asarray(per[start]) for start in starts]).astype(_NP_OF[self.dtype])
            h2d += host.nbytes
            per_field[name] = _blocks_of(self.mesh, host, cap)
        _flight.note_transfer("h2d", h2d)
        self._fields = [{name: per_field[name][d] for name in self.kind.fields} for d in range(self.local_devs)]

    def _maybe_replay_resume(self) -> None:
        """Install the resumed rows at the first flush, a point every
        process reaches in the same order, so the replayed collective
        rounds launch in the same sequence on every process: the latest
        baseline, then, in round order, every round row after it."""
        if not self._resume_rows:
            return
        import time

        t0 = time.perf_counter()
        rows, self._resume_rows = self._resume_rows, []
        baseline = None
        rounds = []
        for key, payload in rows:
            if key.startswith(_GSYNC_BASE_KEY):
                if baseline is None or payload["round"] > baseline["round"]:
                    baseline = payload
            else:
                rounds.append(payload)
        # Every row is checked before anything installs.
        for payload in rounds:
            self._check_round_layout(payload)
        base_no = 0
        if baseline is not None:
            self._install_baseline(baseline)
            base_no = baseline["round"]
            _flight.RECORDER.count("gsync_baseline_installs")
        replayed = []
        for payload in sorted(rounds, key=lambda p: p["round"]):
            if payload["round"] <= base_no:
                continue
            self._replay_round(payload)
            replayed.append(payload["round"])
            self._outstanding_rounds.append(self._round_key(payload["round"]))
            self._data_rounds = max(self._data_rounds, payload["round"])
        self._data_rounds = max(self._data_rounds, base_no)
        seconds = time.perf_counter() - t0
        _flight.RECORDER.count("gsync_replayed_rounds", len(replayed))
        _flight.RECORDER.count("gsync_replay_seconds", seconds)
        if os.environ.get("BYTEWAX_TPU_GLOBAL_EXCHANGE_DEBUG") == "1":
            import sys

            sys.stderr.write(
                f"global-exchange: proc {self.driver.proc_id} resumed "
                f"baseline round {base_no if baseline is not None else None}, "
                f"replayed rounds {replayed} in {seconds:.3f}s\n"
            )
            sys.stderr.flush()

    def _replay_round(self, payload: Dict[str, Any]) -> None:
        """Run one sealed round again from its row, inline (replay comes
        before anything rides the lane): a quantized round through one
        merge launch, an exact round through the bucket and fold
        kernels around the all-to-all, with the chunk layout and
        capacity it was sealed with (every process replays the same
        rounds, so the collectives pair up)."""
        self._assign_kids(payload["new"])
        if payload["fmt"] == "quant":
            self._quant_int = self._quant_int and payload["all_int"]
            self._apply_merge(self._seal_merge(payload["frames"]))
            return
        if self.dtype is None:
            self.dtype = torch.int32 if payload["dtype"] == "int32" else torch.float32
        self._ensure_fields()
        chunk_pd = payload["chunk_pd"]
        n_steps = payload["n_steps"]
        chunk_rows = chunk_pd * self.local_devs
        pad_total = n_steps * chunk_rows
        kids = np.asarray(payload["kids"])
        n_local = len(kids)
        kids_p = np.zeros(pad_total, dtype=np.int32)
        kids_p[:n_local] = kids
        vals_p = np.zeros(pad_total, dtype=_NP_OF[self.dtype])
        vals_p[:n_local] = payload["vals"]
        valid_p = np.zeros(pad_total, dtype=bool)
        valid_p[:n_local] = True
        _flight.note_transfer("h2d", kids_p.nbytes + vals_p.nbytes + valid_p.nbytes)
        step = self._step_for(chunk_pd, payload["capacity"])
        self._exchange_chunks(step, kids_p, vals_p, valid_p, chunk_rows, chunk_pd, n_steps)

    # -- recovery / emission --------------------------------------------------

    def load(self, key: str, state: Any) -> None:
        self.load_many([(key, state)])

    def load_many(self, items) -> None:
        """Defer resumed store rows for replay at the first flush.  Only
        the tier's own rows (sealed rounds and baselines) resume: a
        store of user-key rows from a per-process tier cannot page into
        this tier (kids are a cluster-wide agreement, and resume reads
        are route-scoped).  Nothing falls back to another tier: peers
        that built this one would block in its collectives."""
        for key, state in items:
            if not key.startswith(_GSYNC_KEY_PREFIX):
                msg = (
                    "the global-exchange tier cannot resume "
                    "user-key state written by another tier "
                    f"(got row {key!r}); resume this store with "
                    "BYTEWAX_TPU_GLOBAL_EXCHANGE=0"
                )
                raise RuntimeError(msg)
            self._resume_rows.append((key, state))

    def snapshots_for(self, keys: List[str]) -> List[Tuple[str, Any]]:
        if self.driver.store is None:
            # The epoch snapshot pass discards these.
            return [(k, None) for k in keys]
        # The tier's durable unit is the sealed round or baseline row,
        # never a user key's (the state lies merged on the device; a
        # per-key row would force the fence the overlap avoids).
        rows, self._pending_snap_rows = self._pending_snap_rows, []
        tombstones = sum(1 for _k, p in rows if p is None)
        _flight.RECORDER.count("gsync_store_rows", len(rows) - tombstones)
        _flight.RECORDER.count("gsync_store_tombstones", tombstones)
        return rows

    def _local_host_fields(self) -> Dict[str, np.ndarray]:
        """Every field over this process's shards, ``[local_devs *
        cap_per_shard]`` host arrays from the first local shard's
        global offset on."""
        out: Dict[str, np.ndarray] = {}
        d2h = 0
        for name in self.kind.fields:
            host = torch.cat([block[name].to(self.device) for block in self._fields]).cpu().numpy()
            d2h += host.nbytes
            out[name] = host
        _flight.note_transfer("d2h", d2h)
        _flight.RECORDER.count("gsync_fetch_d2h_bytes", d2h)
        return out

    def _exactify(self, val: Any) -> Any:
        """Re-integerize a quant-mode final value when every merged
        flush was all-integer, matching the exact tier's int lock."""
        if not self._quant_int:
            return val
        if self.kind_name in ("sum", "min", "max"):
            return int(val)
        if self.kind_name == "stats":
            mn, mean, mx, count = val
            return (int(mn), mean, int(mx), count)
        return val

    def finalize(self) -> List[Tuple[str, Any]]:
        """Flush the tail rows (collective: the EOF ladder has every
        process here), fence the lane, then emit ``(key, final)`` for
        the keys whose owner shard is this process's (lane-aligned
        placement makes those its emission keys), sorted by key."""
        self.flush()
        self.fence()
        out: List[Tuple[str, Any]] = []
        my_shards = set(self._proc_shards[self.driver.proc_id])
        if self._quant != "off":
            if self._dev_fields is not None:
                self._host_fields = self._fetch_dev_fields()
                self._dev_fields = None
            if self._host_fields is not None:
                for key in sorted(self.key_to_kid):
                    kid = self.key_to_kid[key]
                    if kid % self.n_shards in my_shards:
                        final = _final_of(self.kind_name, self._host_fields, self._global_idx(kid))
                        out.append((key, self._exactify(final)))
        elif self._fields is not None and self.key_to_kid:
            blocks = self._local_host_fields()
            lo = min(my_shards) * self.cap_per_shard
            for key in sorted(self.key_to_kid):
                kid = self.key_to_kid[key]
                if kid % self.n_shards in my_shards:
                    out.append((key, _final_of(self.kind_name, blocks, self._global_idx(kid) - lo)))
        if self.driver.store is not None:
            # The aggregate was just emitted and resets: this close's
            # own unwritten round rows drop, the durable rounds and the
            # baseline get tombstones (a store resumed after EOF
            # replays nothing).
            dropped = {k for k, p in self._pending_snap_rows if p is not None}
            self._pending_snap_rows = [(k, p) for k, p in self._pending_snap_rows if p is None]
            self._pending_snap_rows.extend((k, None) for k in self._outstanding_rounds if k not in dropped)
            self._outstanding_rounds = []
            if self._base_written:
                self._pending_snap_rows.append((self._base_key(), None))
                self._base_written = False
        self.key_to_kid.clear()
        self._shard_fill = [0] * self.n_shards
        self._fields = None
        self._host_fields = None
        self._dev_fields = None
        self.dtype = None
        self._buf_all_int = True
        self._quant_int = True
        self._dense_keys = []
        self._dense_map = {}
        self._vocab = VocabMaps(dtype=np.int32)
        return out
