"""Tiered key-state residency: budgeted HBM, host-RAM eviction, disk
spill.

The device tiers keep per-key state in slot tables that grow with key
cardinality (``engine/xla.py`` doubles, ``engine/sharded_state.py``
hard-raises at ``cap_per_shard``), so a run serving more keys than the
accelerator's memory either OOMs HBM or refuses the workload.  This
module makes HBM a *budgeted cache* over a larger host/disk-resident
state universe — the KV-cache-paging move every inference server makes,
and the explicit-residency-tier architecture Exoshuffle argues for
(disk spill as a first-class tier, arxiv 2203.05072):

- **Device tier** — at most ``BYTEWAX_TPU_STATE_BUDGET`` hot keys per
  step stay resident in the slot tables.  Unset (the default) means
  unbounded: the manager is never constructed and the engine is
  byte-identical to the pre-residency code.
- **Host tier** — cold keys are *evicted* (LRU by last-touched epoch,
  second chance on re-touch) into host-format logic snapshots — the
  SAME cross-tier snapshot-interchange format recovery and demotion
  already use (docs/recovery.md), so an evicted key's state is exactly
  what a resume would install.
- **Disk tier** — truly cold keys spill to a SQLite store under
  ``BYTEWAX_TPU_SPILL_DIR`` whose rows reuse the recovery store's
  ``snaps`` format (``(step_id, state_key, epoch, ser_change)``,
  pickled), so spilled state is plain recovery data: epoch snapshots
  read through the manager return the identical host-format state for
  resident, evicted, and spilled keys alike, and ``resume_from()``
  recovery covers every tier unchanged.

Scheduling contract (docs/performance.md): evictions and restores are
*host readbacks* and therefore run only at the dispatch pipeline's
drain points — the driver flushes a step's pipeline before the manager
touches the slot tables, so no in-flight fold can reference a
reclaimed slot.  A batch touching an evicted key is a *residency
fault*: the driver restores the key (``inject_keys``) before the
delivery dispatches, behind the pinned ``residency_restore`` chaos
site — the :class:`~bytewax_tpu_torch.errors.DeviceFault` it can inject is
raised before any device state mutates, so the driver's existing
retry/demotion handling applies unchanged.

The collective global-exchange tier is excluded exactly like demotion:
per-process eviction there would desynchronize the collective step
shapes, so ``global_exchange = True`` states are never wrapped (and
the BTX-SNAPSHOT analyzer rule proves they implement no residency
surface).  Eviction is process-local — no new comm frame kinds.
"""

import os
import pickle
import sqlite3
import time
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from bytewax_tpu_torch.engine import faults as _faults
from bytewax_tpu_torch.engine import flight as _flight
from bytewax_tpu_torch.engine.arrays import ArrayBatch

__all__ = [
    "ResidentKeyState",
    "SpillStore",
    "maybe_wrap",
    "state_budget",
]


def state_budget() -> Optional[int]:
    """The configured per-step device-resident key budget, or None
    (unbounded — today's behavior, residency never engages)."""
    raw = os.environ.get("BYTEWAX_TPU_STATE_BUDGET", "")
    if not raw.strip():
        return None
    try:
        budget = int(raw)
    except ValueError:
        msg = (
            f"BYTEWAX_TPU_STATE_BUDGET={raw!r} is not an integer; use "
            "a per-step device-resident key count (unset = unbounded)"
        )
        raise ValueError(msg) from None
    if budget < 1:
        msg = (
            f"BYTEWAX_TPU_STATE_BUDGET={budget} must be >= 1 "
            "(unset = unbounded)"
        )
        raise ValueError(msg)
    return budget


def maybe_wrap(
    step_id: str, state: Any, worker_count: Optional[int] = None
) -> Any:
    """Wrap a device-tier key-state object in a residency manager when
    a budget is configured.  Returns ``state`` unchanged when the
    budget is unset (byte-identical engine) or the state is the
    collective global-exchange tier (per-process eviction would
    desynchronize the collective step shapes — same exclusion as
    demotion).  ``worker_count`` stamps spilled rows' ``route`` home
    lane (the recovery snaps-format column); None leaves them
    unrouted (-1)."""
    if state is None:
        return None
    budget = state_budget()
    if budget is None or getattr(state, "global_exchange", False):
        return state
    return ResidentKeyState(
        step_id, state, budget, worker_count=worker_count
    )


def _final_of_snap(kind: str, snap: Any) -> Any:
    """EOF final value from a host-format aggregation snapshot (the
    cold-tier sibling of ``xla._final_of``, which reads slot rows)."""
    if kind in ("sum", "min", "max"):
        return snap
    if kind == "count":
        return int(snap)
    if kind == "mean":
        total, count = snap
        return total / count if count else 0.0
    mn, mx, total, count = snap  # stats
    count = int(count)
    mean = total / count if count else 0.0
    return (mn, mean, mx, count)


def _entry_keys(items: Any) -> List[str]:
    """The distinct key strings one delivery entry can touch (host
    data only — column uniques / item firsts).  Best effort on
    malformed rows: anything this can't key, the fold itself rejects
    with its own step-qualified error before any state mutates."""
    if isinstance(items, ArrayBatch):
        cols = items.cols
        try:
            if "key_id" in cols and items.key_vocab is not None:
                ids = items.numpy("key_id")
                if not len(ids):
                    return []
                vocab = np.asarray(items.key_vocab)
                return [
                    str(k) for k in vocab[np.unique(ids)].tolist()
                ]
            if "key" in cols:
                return [
                    str(k)
                    for k in np.unique(items.numpy("key")).tolist()
                ]
        except (IndexError, TypeError, ValueError):
            return []
        return []
    out = []
    seen = set()
    for item in items:
        try:
            k, _v = item
        except (TypeError, ValueError):
            continue
        if isinstance(k, str) and k not in seen:
            seen.add(k)
            out.append(k)
    return out


#: Same ``snaps`` DDL as the recovery store (recovery_store._SCHEMA):
#: the spill tier IS recovery-format rows — including the ``route``
#: home-lane column — just process-local and keyed by the live
#: execution's epoch, so the rescale-on-resume migration routine
#: (:func:`bytewax_tpu_torch.engine.recovery_store.rescale_snaps_rows`)
#: applies to spill files unchanged.
_SPILL_SCHEMA = """
CREATE TABLE IF NOT EXISTS snaps (
    step_id TEXT NOT NULL,
    state_key TEXT NOT NULL,
    epoch INTEGER NOT NULL,
    ser_change BLOB,
    route INTEGER NOT NULL DEFAULT -1,
    PRIMARY KEY (step_id, state_key, epoch)
);
"""


class SpillStore:
    """Disk tier for one step's spilled key state.

    One SQLite file per (process, step) under the spill dir; rows
    reuse the recovery store's ``snaps`` format — ``(step_id,
    state_key, epoch, ser_change)`` with pickled host-format state —
    so the disk tier speaks the exact serialization the recovery
    store does.  The file is ephemeral per execution: a restart
    resumes spilled keys from the *recovery* store (their epoch
    snapshots read through the manager carried the same state), never
    from a previous process's spill file.
    """

    def __init__(
        self,
        db_dir: str,
        step_id: str,
        worker_count: Optional[int] = None,
    ):
        from bytewax_tpu_torch.engine.recovery_store import ensure_route_column

        path = Path(db_dir)
        path.mkdir(parents=True, exist_ok=True)
        tag = zlib.adler32(step_id.encode("utf-8")) & 0xFFFFFFFF
        self._path = path / f"spill-{os.getpid()}-{tag:08x}.sqlite3"
        self._con = sqlite3.connect(self._path, isolation_level=None)
        self._con.execute("PRAGMA journal_mode = WAL")
        self._con.execute("PRAGMA busy_timeout = 5000")
        self._con.execute("PRAGMA synchronous = NORMAL")
        self._con.executescript(_SPILL_SCHEMA)
        ensure_route_column(self._con)
        self.step_id = step_id
        #: Worker count the rows' ``route`` column is stamped under
        #: (None = unrouted rows, route -1 — the recovery-format
        #: "unknown home" marker).
        self.worker_count = worker_count
        # Purge any rows a previous execution left behind: the file
        # name reuses the pid, so a supervised restart (same process)
        # or a crashed run would otherwise leave stale higher-epoch
        # rows that shadow this execution's spills in get()'s
        # ORDER BY epoch DESC.  Spill state is ephemeral per
        # execution — restarts resume from the RECOVERY store.
        self._con.execute(
            "DELETE FROM snaps WHERE step_id = ?", (step_id,)
        )

    def put_many(
        self, items: Iterable[Tuple[str, Any]], epoch: int
    ) -> int:
        """Write host-format snapshots; returns serialized bytes."""
        from bytewax_tpu_torch.engine.recovery_store import route_of

        nbytes = 0
        for key, state in items:
            ser = pickle.dumps(state)
            nbytes += len(ser)
            self._con.execute(
                "INSERT OR REPLACE INTO snaps "
                "(step_id, state_key, epoch, ser_change, route) "
                "VALUES (?, ?, ?, ?, ?)",
                (
                    self.step_id,
                    key,
                    epoch,
                    ser,
                    route_of(key, self.worker_count)
                    if self.worker_count
                    else -1,
                ),
            )
        return nbytes

    def get(self, key: str) -> Any:
        row = self._con.execute(
            "SELECT ser_change FROM snaps WHERE step_id = ? AND "
            "state_key = ? ORDER BY epoch DESC LIMIT 1",
            (self.step_id, key),
        ).fetchone()
        if row is None:
            msg = (
                f"spilled state for key {key!r} of step "
                f"{self.step_id!r} is missing from {self._path}"
            )
            raise KeyError(msg)
        return pickle.loads(row[0])

    def delete(self, key: str) -> None:
        self._con.execute(
            "DELETE FROM snaps WHERE step_id = ? AND state_key = ?",
            (self.step_id, key),
        )

    def clear(self) -> None:
        self._con.execute(
            "DELETE FROM snaps WHERE step_id = ?", (self.step_id,)
        )

    def rescale(
        self, new_worker_count: int, partial: bool = False
    ) -> int:
        """Re-stamp spilled rows' home lanes for a new worker count —
        the spill tier speaks the recovery ``snaps`` row format, so it
        migrates through the SAME routine the recovery partitions do,
        including the delta-only ``partial`` mode (rows whose home
        lane does not change are never rewritten).  Spill files are
        per-execution ephemeral (a restart — and a live
        reconfiguration, which unwinds to the same run-startup
        re-entry — resumes spilled keys from the *recovery* store),
        so the engine never calls this on the resume path; it exists
        so the format contract stays closed: any snaps-format file in
        the system is rescalable."""
        from bytewax_tpu_torch.engine.recovery_store import rescale_snaps_rows

        migrated = rescale_snaps_rows(
            self._con, new_worker_count, partial=partial
        )
        self.worker_count = new_worker_count
        return migrated

    def close(self) -> None:
        self._con.close()


class ResidentKeyState:
    """Per-step residency manager over a device-tier key-state object.

    Duck-types the inner state's whole surface (``__getattr__``
    delegation for the fold paths — ``update*`` stay exactly the inner
    tier's methods) and overrides the key-lifecycle surface so the
    driver sees ONE state object whose keys happen to live in three
    tiers:

    - ``snapshots_for`` / ``demotion_snapshots`` / ``keys`` merge the
      resident, evicted, and spilled tiers (epoch snapshots and
      demotion therefore cover every key regardless of residency);
    - ``load_many`` installs resume pages device-side up to the
      budget and parks the remainder cold;
    - ``finalize`` merges resident finals with finals computed from
      cold snapshots, in the host tier's sorted-by-key EOF order.

    Threading: ALL manager bookkeeping runs on the driver's main
    thread.  The driver calls :meth:`prepare_entries` before a
    delivery dispatches (restores are preceded by a pipeline flush —
    a drain point — so no in-flight fold can observe the injection)
    and :meth:`evict_to_budget` only after flushing the pipeline.
    """

    def __init__(
        self,
        step_id: str,
        inner: Any,
        budget: int,
        worker_count: Optional[int] = None,
    ):
        self._inner = inner
        self.step_id = step_id
        self.budget = budget
        spill_dir = os.environ.get("BYTEWAX_TPU_SPILL_DIR", "").strip()
        raw_host = os.environ.get(
            "BYTEWAX_TPU_HOST_STATE_BUDGET", ""
        ).strip()
        #: Host-tier snapshot count before spilling engages; beyond
        #: it, the coldest host-tier keys go to disk.  Unbounded when
        #: no spill dir is configured (host RAM is then the floor).
        self.host_budget = (
            int(raw_host) if raw_host else 8 * budget
        ) if spill_dir else None
        self._spill = (
            SpillStore(spill_dir, step_id, worker_count=worker_count)
            if spill_dir
            else None
        )
        #: Host tier: key -> host-format snapshot, insertion-ordered
        #: (oldest eviction first — the spill candidate order).
        self._evicted: Dict[str, Any] = {}
        #: Keys currently on disk.
        self._spilled: set = set()
        #: Resident-key LRU metadata: key -> [last_touch_epoch, ref]
        #: (ref = touched again since it became a candidate: second
        #: chance).
        self._meta: Dict[str, List] = {}
        self._epoch = 0
        self.evictions = 0
        self.restores = 0
        self.spill_bytes = 0

    def __getattr__(self, name: str) -> Any:
        # Fold surfaces (update*, flush, alloc, ...) are the inner
        # tier's own bound methods — the hot path pays one attribute
        # indirection, no per-row manager code.
        return getattr(self._inner, name)

    # -- bookkeeping ------------------------------------------------------

    def _resident_map(self) -> Optional[Dict[str, int]]:
        inner = self._inner
        m = getattr(inner, "key_to_slot", None)
        if m is None:
            m = getattr(inner, "key_to_kid", None)
        return m

    def _resident_count(self) -> int:
        m = self._resident_map()
        return len(m) if m is not None else len(self._inner.keys())

    def _note_resident(self) -> None:
        n = self._resident_count()
        _flight.note_resident(self.step_id, n)

    def over_budget(self) -> bool:
        return self._resident_count() > self.budget

    def _touch(self, keys: Iterable[str], epoch: int) -> None:
        meta = self._meta
        for k in keys:
            m = meta.get(k)
            if m is None:
                meta[k] = [epoch, False]
            else:
                m[0] = epoch
                m[1] = True  # re-touch: second chance on eviction

    # -- residency faults (restore before dispatch) -----------------------

    def prepare_entries(
        self, entries: List[Tuple[int, Any]], epoch: int, flush: Callable[[], None]
    ) -> None:
        """Driver hook, main thread, before one delivery dispatches:
        restore any evicted/spilled key the delivery touches and
        record LRU touches."""
        keys: List[str] = []
        for _w, items in entries:
            keys.extend(_entry_keys(items))
        self.prepare(keys, epoch, flush)

    def prepare(
        self, keys: List[str], epoch: int, flush: Callable[[], None]
    ) -> None:
        self._epoch = epoch
        uniq = list(dict.fromkeys(keys))
        needed = [
            k
            for k in uniq
            if k in self._evicted or k in self._spilled
        ]
        resident = self._resident_map()
        incoming = sum(
            1
            for k in uniq
            if resident is None or k not in resident
        )
        over = self._resident_count() + incoming - self.budget
        if needed:
            # The pinned chaos site fires BEFORE any state mutates
            # (neither the caches nor the slot tables have been
            # touched — eviction and injection both come after), so
            # an injected DeviceFault lands in the driver's
            # retry/demotion handling with the delivery fully
            # replayable.
            _faults.fire(
                "residency_restore",
                step=self.step_id,
                keys=len(needed),
            )
        if needed or over > 0:
            # Drain point: no in-flight fold may share the slot
            # tables with the eviction/injection below.
            flush()
        if over > 0:
            # Make room for EVERY key this delivery brings on device
            # (restores and brand-new allocs alike) before the fold,
            # so the budget holds at delivery boundaries — never
            # evicting the delivery's own keys (a victim in the
            # delivery would fold into a fresh slot while its state
            # sat in the cache, splitting the key).
            self._evict(over, frozenset(uniq), epoch)
        if needed:
            t0 = time.monotonic()
            items: List[Tuple[str, Any]] = []
            for k in needed:
                if k in self._evicted:
                    items.append((k, self._evicted.pop(k)))
                else:
                    state = self._spill.get(k)
                    self._spill.delete(k)
                    self._spilled.discard(k)
                    items.append((k, state))
            self._inner.inject_keys(items)
            self.restores += len(items)
            _flight.note_residency_restore(
                self.step_id, len(items), time.monotonic() - t0
            )
        self._touch(keys, epoch)
        self._note_resident()

    # -- eviction (drain points only) --------------------------------------

    def evict_to_budget(self, epoch: int) -> None:
        """Evict cold resident keys until the device tier is back at
        the budget.  Caller MUST have drained the step's dispatch
        pipeline first."""
        self._epoch = epoch
        self._evict(
            self._resident_count() - self.budget, frozenset(), epoch
        )
        self._note_resident()

    def _evict(
        self, excess: int, protect: frozenset, epoch: int
    ) -> None:
        """Move up to ``excess`` cold resident keys to the host tier
        (pipeline already drained by the caller).  Victim order is
        LRU by last-touched epoch; a key re-touched since it last
        survived a scan gets one second chance (its ref bit is
        cleared instead of evicting); ``protect``\\ ed keys (the
        in-flight delivery's own) are never victims."""
        if excess <= 0:
            return
        t0 = time.monotonic()
        inner = self._inner
        resident = self._resident_map()
        victims: List[str] = []
        passed: List[str] = []
        for key, m in sorted(
            self._meta.items(), key=lambda kv: kv[1][0]
        ):
            if len(victims) >= excess:
                break
            if resident is not None and key not in resident:
                # Stale metadata (discarded/finalized elsewhere).
                del self._meta[key]
                continue
            if key in protect:
                continue
            if m[1]:
                m[1] = False
                passed.append(key)
                continue
            victims.append(key)
        for key in passed:
            if len(victims) >= excess:
                break
            victims.append(key)
        if resident is not None and len(victims) < excess:
            # Keys resident without metadata (e.g. installed by a
            # resume page): oldest-unknown first.
            known = set(self._meta)
            for key in resident:
                if len(victims) >= excess:
                    break
                if (
                    key not in known
                    and key not in protect
                    and key not in victims
                ):
                    victims.append(key)
        if not victims:
            return
        items = inner.extract_keys(victims)
        for key in victims:
            self._meta.pop(key, None)
        for key, snap in items:
            self._evicted[key] = snap
        self.evictions += len(victims)
        _flight.note_eviction(self.step_id, len(victims), "host")
        self._spill_overflow(epoch)
        # Ledger: eviction is a drain-point host readback — the
        # extract + host-cache insert + any disk spill it triggered.
        _flight.note_phase(
            "evict", self.step_id, time.monotonic() - t0, t0=t0
        )

    def _spill_overflow(self, epoch: int) -> None:
        if self._spill is None or self.host_budget is None:
            return
        overflow = len(self._evicted) - self.host_budget
        if overflow <= 0:
            return
        cold = []
        for key in list(self._evicted)[:overflow]:
            cold.append((key, self._evicted.pop(key)))
            self._spilled.add(key)
        nbytes = self._spill.put_many(cold, epoch)
        self.spill_bytes += nbytes
        _flight.note_eviction(self.step_id, len(cold), "disk")
        _flight.note_spill(self.step_id, nbytes)

    # -- key lifecycle (merged over the three tiers) -----------------------

    def keys(self) -> List[str]:
        out = list(self._inner.keys())
        out.extend(self._evicted)
        out.extend(self._spilled)
        return out

    def snapshots_for(
        self, keys: List[str]
    ) -> List[Tuple[str, Any]]:
        """Host-format snapshots regardless of residency tier — the
        property that keeps recovery (and therefore ``resume_from()``)
        covering evicted and spilled keys unchanged."""
        resident_req = [
            k
            for k in keys
            if k not in self._evicted and k not in self._spilled
        ]
        resident = dict(self._inner.snapshots_for(resident_req))
        out = []
        for key in keys:
            if key in self._evicted:
                out.append((key, self._evicted[key]))
            elif key in self._spilled:
                out.append((key, self._spill.get(key)))
            else:
                out.append((key, resident.get(key)))
        return out

    def load_many(self, items: List[Tuple[str, Any]]) -> None:
        """Resume paging: install device-side up to the budget, park
        the remainder cold (they restore on first touch)."""
        if not items:
            return
        room = max(self.budget - self._resident_count(), 0)
        head = items[:room]
        if head:
            self._inner.load_many(head)
            for key, _state in head:
                self._meta.setdefault(key, [self._epoch, False])
        for key, state in items[room:]:
            self._evicted[key] = state
        self._spill_overflow(self._epoch)
        self._note_resident()

    def load(self, key: str, state: Any) -> None:
        self.load_many([(key, state)])

    def discard(self, key: str) -> None:
        self._meta.pop(key, None)
        if self._evicted.pop(key, None) is not None:
            return
        if key in self._spilled:
            self._spilled.discard(key)
            self._spill.delete(key)
            return
        self._inner.discard(key)

    def finalize(self) -> List[Tuple[str, Any]]:
        """EOF emission over every tier, in the host tier's
        sorted-by-key order, then clear."""
        kind = self._inner.kind_name
        out = list(self._inner.finalize())
        for key in list(self._evicted):
            out.append(
                (key, _final_of_snap(kind, self._evicted.pop(key)))
            )
        for key in sorted(self._spilled):
            out.append((key, _final_of_snap(kind, self._spill.get(key))))
        self._spilled.clear()
        if self._spill is not None:
            self._spill.clear()
        self._meta.clear()
        out.sort(key=lambda kv: kv[0])
        self._note_resident()
        return out

    def demotion_snapshots(self) -> List[Tuple[str, Any]]:
        """Device→host demotion drains EVERY tier: the host logics
        that replace this state must own evicted and spilled keys
        too."""
        out = list(self._inner.demotion_snapshots())
        out.extend(self._evicted.items())
        for key in sorted(self._spilled):
            out.append((key, self._spill.get(key)))
        return out

    def flush(self) -> None:
        self._inner.flush()

    # Residency surface passthrough (the wrapper is itself a valid
    # device-tier state under the BTX-SNAPSHOT pairing rule).
    def extract_keys(self, keys: List[str]) -> List[Tuple[str, Any]]:
        extracted = self._inner.extract_keys(
            [
                k
                for k in keys
                if k not in self._evicted and k not in self._spilled
            ]
        )
        for key in keys:
            self._meta.pop(key, None)
        out = dict(extracted)
        for key in keys:
            if key in self._evicted:
                out[key] = self._evicted.pop(key)
            elif key in self._spilled:
                out[key] = self._spill.get(key)
                self._spill.delete(key)
                self._spilled.discard(key)
        return list(out.items())

    def inject_keys(self, items: List[Tuple[str, Any]]) -> None:
        self._inner.inject_keys(items)
        for key, _state in items:
            self._meta.setdefault(key, [self._epoch, False])

    # -- observability ------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The ``/status`` residency section for this step."""
        return {
            "budget": self.budget,
            "host_budget": self.host_budget,
            "resident": self._resident_count(),
            "evicted": len(self._evicted),
            "spilled": len(self._spilled),
            "evictions": self.evictions,
            "restores": self.restores,
            "spill_bytes": self.spill_bytes,
        }
