"""SQLite-backed recovery store and resume-epoch calculation.

Store format parity with the reference engine
(upstream bytewax ``src/recovery.rs:456-531`` schema,
``:1180-1275`` resume math, ``:948-989`` GC); implementation is our
own, host-side Python over :mod:`sqlite3`.  Device state arrives here
already materialized (the driver calls ``jax.device_get`` on sharded
state pytrees at epoch close before serializing).

Tables per ``part-{i}.sqlite3``:

- ``parts(part_index, part_count)`` — identity, written at init.
- ``exs(ex_num, worker_index, worker_count, resume_epoch)`` — one row
  per (execution, worker), written at execution start.
- ``fronts(ex_num, worker_index, epoch)`` — worker frontier, upserted
  at every epoch close.
- ``commits(epoch)`` — GC watermark for this partition.
- ``snaps(step_id, state_key, epoch, ser_change, route)`` — pickled
  state changes; ``NULL`` ``ser_change`` is a discard marker.
  ``route`` is the key's home worker lane under the writing
  execution's worker count (``adler32(state_key) % worker_count`` —
  the driver's keyed-routing hash), so each resuming process reads
  only its own rows instead of streaming every partition's whole
  state.  ``route`` is only valid for the worker count that stamped
  it: resuming at a different count must either refuse
  (:class:`WorkerCountMismatchError`) or migrate every row to the new
  modulus first (:meth:`RecoveryStore.rescale`, run at startup — the
  one globally-ordered re-entry point).  The residency spill tier
  (``engine/residency.py``) reuses this exact row format, including
  ``route``, and migrates through the same
  :func:`rescale_snaps_rows` routine.
"""

import os
import sqlite3
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from bytewax_tpu_torch.engine import faults as _faults

__all__ = [
    "InconsistentPartitionsError",
    "MissingPartitionsError",
    "NoPartitionsError",
    "RecoveryStore",
    "ResumeFrom",
    "WorkerCountMismatchError",
    "ensure_route_column",
    "init_db_dir",
    "rescale_snaps_rows",
    "route_of",
]

_SCHEMA = """
CREATE TABLE IF NOT EXISTS parts (
    part_index INTEGER NOT NULL,
    part_count INTEGER NOT NULL,
    PRIMARY KEY (part_index)
);
CREATE TABLE IF NOT EXISTS exs (
    ex_num INTEGER NOT NULL,
    worker_index INTEGER NOT NULL,
    worker_count INTEGER NOT NULL,
    resume_epoch INTEGER NOT NULL,
    PRIMARY KEY (ex_num, worker_index)
);
CREATE TABLE IF NOT EXISTS fronts (
    ex_num INTEGER NOT NULL,
    worker_index INTEGER NOT NULL,
    epoch INTEGER NOT NULL,
    PRIMARY KEY (ex_num, worker_index)
);
CREATE TABLE IF NOT EXISTS commits (
    epoch INTEGER NOT NULL,
    PRIMARY KEY (epoch)
);
CREATE TABLE IF NOT EXISTS snaps (
    step_id TEXT NOT NULL,
    state_key TEXT NOT NULL,
    epoch INTEGER NOT NULL,
    ser_change BLOB,
    route INTEGER NOT NULL DEFAULT -1,
    PRIMARY KEY (step_id, state_key, epoch)
);
"""


def ensure_route_column(con: sqlite3.Connection) -> None:
    """Upgrade a pre-routing ``snaps`` table in place: rows written by
    an older store get ``route = -1`` (unknown), which every reader
    includes regardless of its route filter — the engine's in-memory
    ownership check still applies, so legacy rows resume exactly as
    before, just without the read-scoping win."""
    cols = [row[1] for row in con.execute("PRAGMA table_info(snaps)")]
    if "route" not in cols:
        con.execute(
            "ALTER TABLE snaps ADD COLUMN route INTEGER NOT NULL DEFAULT -1"
        )


class NoPartitionsError(FileNotFoundError):
    """Raised when no recovery partitions are found in the recovery
    directory; it was probably not initialized with
    :func:`init_db_dir` first."""


class MissingPartitionsError(FileNotFoundError):
    """Raised when an incomplete set of recovery partitions is found."""


class InconsistentPartitionsError(ValueError):
    """Raised when the recovery partitions contain inconsistent data:
    state needed to resume was already garbage collected in some
    partition.  Your ``backup_interval`` is probably shorter than the
    time between your backups."""


class WorkerCountMismatchError(ValueError):
    """Raised when a recovery store written by N workers is resumed by
    a cluster with M != N workers and rescale-on-resume is not
    enabled.  Keyed snapshot rows are route-stamped with the writing
    execution's worker modulus, so resuming at a different size
    without migrating them would silently mis-route (drop) keyed
    state.  Rerun with ``--rescale`` / ``BYTEWAX_TPU_RESCALE=1`` to
    migrate the store to the new worker count at run startup."""

    def __init__(self, stored_counts, actual_count: int):
        stored = sorted(set(stored_counts))
        shown = stored[0] if len(stored) == 1 else stored
        msg = (
            f"recovery store was last written by an execution with "
            f"{shown} worker(s), but this cluster has "
            f"{actual_count}; resuming would route keyed snapshot "
            "rows with a stale modulus and silently lose state.  "
            "Enable rescale-on-resume with --rescale / "
            "BYTEWAX_TPU_RESCALE=1 (the store is migrated to the new "
            "worker count at run startup), or restart with the "
            "original worker count."
        )
        super().__init__(msg)
        self.stored_counts = tuple(stored)
        self.actual_count = actual_count


def _connect(path: Path) -> sqlite3.Connection:
    # check_same_thread=False: the async checkpoint committer lane
    # (docs/recovery.md "Asynchronous incremental checkpoints") runs
    # write_epoch on its single worker thread.  The handle is still
    # never used concurrently — the main thread hands a sealed delta
    # to at most one in-flight commit and fences it before the next
    # touch (BTX-THREAD pins the lane to exactly that one call) — and
    # the linked SQLite is THREADSAFE=1 (serialized) regardless.
    con = sqlite3.connect(
        path, isolation_level=None, check_same_thread=False
    )
    # Litestream/backup friendly, matching the reference's pragmas
    # (src/recovery.rs:521-531).
    con.execute("PRAGMA journal_mode = WAL")
    con.execute("PRAGMA busy_timeout = 5000")
    con.execute("PRAGMA synchronous = NORMAL")
    return con


def init_db_dir(db_dir: Union[str, Path], count: int) -> None:
    """Create a set of empty recovery partitions.

    :arg db_dir: Directory to create partitions in; must exist.
    :arg count: Number of partitions to create.
    """
    db_dir = Path(db_dir)
    if not db_dir.is_dir():
        msg = f"recovery DB dir {str(db_dir)!r} does not exist"
        raise NotADirectoryError(msg)
    for i in range(count):
        con = _connect(db_dir / f"part-{i}.sqlite3")
        try:
            con.executescript(_SCHEMA)
            con.execute(
                "INSERT OR REPLACE INTO parts (part_index, part_count) VALUES (?, ?)",
                (i, count),
            )
        finally:
            con.close()


class ResumeFrom:
    """Where to resume processing: execution number and epoch.

    ``stored_worker_counts`` carries the worker count(s) recorded by
    the execution being resumed (empty for a fresh store; more than
    one value only after a crash mid-rescale, which the next rescale
    pass heals idempotently)."""

    def __init__(
        self,
        ex_num: int,
        resume_epoch: int,
        stored_worker_counts: Tuple[int, ...] = (),
    ):
        self.ex_num = ex_num
        self.resume_epoch = resume_epoch
        self.stored_worker_counts = tuple(sorted(set(stored_worker_counts)))

    def __repr__(self) -> str:
        return f"ResumeFrom(ex_num={self.ex_num}, resume_epoch={self.resume_epoch})"


#: Epoch the very first execution starts at.
INIT_EPOCH = 1


def _stable_hash(key: str) -> int:
    return zlib.adler32(key.encode("utf-8"))


def route_of(state_key: str, worker_count: int) -> int:
    """The home worker lane of a state key — the same
    ``adler32 % worker_count`` hash the driver routes keyed exchanges
    with, so a route-filtered resume read returns exactly the keys
    the reading process owns."""
    return _stable_hash(state_key) % worker_count


def rescale_snaps_rows(
    con: sqlite3.Connection,
    new_worker_count: int,
    page_size: int = 1000,
    partial: bool = False,
) -> int:
    """Re-stamp ``snaps`` rows' ``route`` for a new worker count,
    paging over distinct state keys so migration memory stays bounded
    by the page.  Works on any ``snaps``-format SQLite — the recovery
    partitions and the residency spill tier share the row format AND
    this migration routine.  Returns the number of distinct keys
    whose rows were rewritten.  The caller owns the transaction (the
    recovery store wraps all partitions in one all-or-nothing
    transaction; see :meth:`RecoveryStore.rescale`).

    ``partial`` is the delta-only mode (docs/recovery.md "Live
    partial rescale"): a key whose stamped route ALREADY equals its
    home lane under the new modulus is skipped entirely — no UPDATE
    touches its rows, so migration write cost scales with the keys
    that actually move, not the store.  The stamped ``route`` column
    IS the old placement, so no old-count parameter is needed, and
    the mode is self-healing: legacy ``-1`` stamps and mixed stamps
    left by a crash mid-migration never compare equal to the new
    route, so they are always rewritten (re-running the migration is
    idempotent in both modes)."""
    migrated = 0
    last = ""
    while True:
        # MIN/MAX expose whether every row of a key already carries
        # one (the new) route; anything mixed or stale rewrites.
        rows = con.execute(
            "SELECT state_key, MIN(route), MAX(route) FROM snaps "
            "WHERE state_key > ? GROUP BY state_key "
            "ORDER BY state_key LIMIT ?",
            (last, page_size),
        ).fetchall()
        if not rows:
            return migrated
        last = rows[-1][0]
        updates = []
        for key, route_lo, route_hi in rows:
            new_route = route_of(key, new_worker_count)
            if partial and route_lo == route_hi == new_route:
                continue  # home lane unchanged: leave the rows alone
            updates.append((new_route, key))
        if updates:
            con.executemany(
                "UPDATE snaps SET route = ? WHERE state_key = ?",
                updates,
            )
        migrated += len(updates)


class RecoveryStore:
    """Open handle on all recovery partitions of a dataflow."""

    def __init__(self, db_dir: Union[str, Path]):
        db_dir = Path(db_dir)
        paths = sorted(db_dir.glob("part-*.sqlite3"))
        if not paths:
            msg = (
                f"no recovery partitions found in {str(db_dir)!r}; "
                "init the recovery store with "
                "`python -m bytewax_tpu_torch.recovery` first"
            )
            raise NoPartitionsError(msg)
        self._cons: Dict[int, sqlite3.Connection] = {}
        part_count: Optional[int] = None
        for path in paths:
            con = _connect(path)
            con.executescript(_SCHEMA)
            ensure_route_column(con)
            row = con.execute(
                "SELECT part_index, part_count FROM parts"
            ).fetchone()
            if row is None:
                con.close()
                msg = f"recovery partition {str(path)!r} has no identity row"
                raise MissingPartitionsError(msg)
            idx, count = row
            if part_count is None:
                part_count = count
            elif part_count != count:
                msg = (
                    f"recovery partitions in {str(db_dir)!r} disagree on "
                    f"partition count ({part_count} vs {count})"
                )
                raise InconsistentPartitionsError(msg)
            self._cons[idx] = con
        assert part_count is not None
        missing = set(range(part_count)) - set(self._cons)
        if missing:
            msg = (
                f"missing recovery partitions {sorted(missing)} of "
                f"{part_count} in {str(db_dir)!r}"
            )
            raise MissingPartitionsError(msg)
        self.part_count = part_count

    def close(self) -> None:
        for con in self._cons.values():
            con.close()

    def _part_for_key(self, step_id: str, state_key: str) -> sqlite3.Connection:
        return self._cons[
            _stable_hash(f"{step_id}\x00{state_key}") % self.part_count
        ]

    def _part_for_worker(self, worker_index: int) -> sqlite3.Connection:
        return self._cons[worker_index % self.part_count]

    # -- resume calculation ------------------------------------------------

    def resume_from(
        self,
        worker_count: Optional[int] = None,
        allow_rescale: bool = False,
    ) -> ResumeFrom:
        """Compute the next execution number and the epoch to resume at.

        Mirrors the reference's resume SQL
        (``src/recovery.rs:1180-1275``): the resume epoch is the
        minimum over workers of each worker's latest frontier in the
        most recent execution; inconsistent GC raises.

        When the caller passes its ``worker_count``, it is reconciled
        against the count the resumed execution recorded: a mismatch
        raises :class:`WorkerCountMismatchError` unless
        ``allow_rescale`` is set, in which case the stored count(s)
        ride back on ``ResumeFrom.stored_worker_counts`` and the
        caller must run :meth:`rescale` before reading any keyed
        snapshots.
        """
        exs: List[Tuple[int, int, int, int]] = []
        fronts: List[Tuple[int, int, int]] = []
        for con in self._cons.values():
            exs.extend(
                con.execute(
                    "SELECT ex_num, worker_index, worker_count, resume_epoch "
                    "FROM exs"
                ).fetchall()
            )
            fronts.extend(
                con.execute(
                    "SELECT ex_num, worker_index, epoch FROM fronts"
                ).fetchall()
            )

        if not exs:
            resume = ResumeFrom(0, INIT_EPOCH)
        else:
            last_ex = max(row[0] for row in exs)
            last_rows = [row for row in exs if row[0] == last_ex]
            stored_counts = tuple(sorted({row[2] for row in last_rows}))
            if (
                worker_count is not None
                and stored_counts != (worker_count,)
                and not allow_rescale
            ):
                raise WorkerCountMismatchError(
                    stored_counts, worker_count
                )
            front_by_worker: Dict[int, int] = {}
            for ex_num, worker_index, epoch in fronts:
                if ex_num == last_ex:
                    front_by_worker[worker_index] = max(
                        front_by_worker.get(worker_index, 0), epoch
                    )
            worker_epochs = []
            for _ex, worker_index, _count, start_epoch in last_rows:
                worker_epochs.append(
                    front_by_worker.get(worker_index, start_epoch)
                )
            # Workers of the last execution whose exs row is lost
            # (e.g. a partition was restored from a stale backup)
            # simply don't constrain the minimum; the commit check
            # below catches true inconsistency.
            resume = ResumeFrom(
                last_ex + 1, min(worker_epochs), stored_counts
            )

        for idx, con in self._cons.items():
            row = con.execute("SELECT MAX(epoch) FROM commits").fetchone()
            commit_epoch = row[0] if row and row[0] is not None else None
            if commit_epoch is not None and commit_epoch >= resume.resume_epoch:
                msg = (
                    f"recovery partition {idx} already garbage-collected "
                    f"state up to epoch {commit_epoch}, but the computed "
                    f"resume epoch is {resume.resume_epoch}; partitions are "
                    "from inconsistent backups"
                )
                raise InconsistentPartitionsError(msg)
        return resume

    #: Page size for snapshot resume reads (reference pages its
    #: snapshot SQL the same way: ``src/recovery.rs:817-882``,
    #: ``:1160-1163``).
    SNAP_PAGE = 1000

    def iter_snaps(
        self,
        before_epoch: int,
        step_ids: Optional[List[str]] = None,
        page_size: Optional[int] = None,
        routes: Optional[List[int]] = None,
    ):
        """Yield ``(step_id, state_key, ser_change)`` for the latest
        state change per (step, key) strictly before an epoch, reading
        ``page_size`` rows per SQL query (keyset pagination), so
        resume memory is bounded by the page — not the total state
        size.  Discard markers are skipped.  Each (step, key) lives in
        exactly one partition file (snapshots are key-hash
        partitioned on write), so partitions stream independently.

        ``routes`` scopes the read to rows whose home worker lane is
        in the list (each resuming process passes its own lanes, so a
        rescaled cluster reads 1/M of the state per process instead
        of all of it M times).  Rows with an unknown route (``-1``,
        written by a pre-routing store) are always included; callers
        keep their own ownership filter as the correctness backstop.
        Routes are only meaningful when they were stamped (or
        migrated) under the caller's worker count — the
        ``resume_from()`` reconciliation guarantees that before any
        routed read happens."""
        if page_size is None:
            page_size = self.SNAP_PAGE
        conds = ["epoch < ?", "(step_id, state_key) > (?, ?)"]
        filt = ""
        if step_ids is not None:
            filt = "step_id IN (%s)" % ",".join("?" * len(step_ids))
            conds.append(filt)
        if routes is not None:
            conds.append(
                "(route < 0 OR route IN (%s))"
                % ",".join("?" * len(routes))
            )
        sql = (
            "SELECT s.step_id, s.state_key, s.ser_change "
            "FROM snaps s JOIN ("
            "  SELECT step_id, state_key, MAX(epoch) AS epoch FROM snaps "
            f"  WHERE {' AND '.join(conds)} "
            "  GROUP BY step_id, state_key "
            "  ORDER BY step_id, state_key LIMIT ?"
            ") latest ON s.step_id = latest.step_id "
            "AND s.state_key = latest.state_key "
            "AND s.epoch = latest.epoch "
            "ORDER BY s.step_id, s.state_key"
        )
        for con in self._cons.values():
            last = ("", "")
            while True:
                args: List = [before_epoch, *last]
                if step_ids is not None:
                    args += list(step_ids)
                if routes is not None:
                    args += list(routes)
                rows = con.execute(sql, (*args, page_size)).fetchall()
                if not rows:
                    break
                last = (rows[-1][0], rows[-1][1])
                for step_id, state_key, ser_change in rows:
                    if ser_change is not None:
                        yield step_id, state_key, ser_change

    def load_snaps(self, before_epoch: int) -> Dict[Tuple[str, str], bytes]:
        """Load the latest state change per (step, key) strictly before
        an epoch into one dict.  Prefer :meth:`iter_snaps` for keyed
        state — this materializes everything at once."""
        return {
            (step_id, state_key): ser
            for step_id, state_key, ser in self.iter_snaps(before_epoch)
        }

    # -- write path --------------------------------------------------------

    def write_ex_started(
        self,
        ex_num: int,
        worker_count: int,
        resume_epoch: int,
        workers: Optional[range] = None,
    ) -> None:
        """Record that an execution started, before any epoch closes.
        In a cluster each process writes rows only for its own
        workers."""
        for worker_index in workers if workers is not None else range(
            worker_count
        ):
            con = self._part_for_worker(worker_index)
            con.execute(
                "INSERT OR REPLACE INTO exs "
                "(ex_num, worker_index, worker_count, resume_epoch) "
                "VALUES (?, ?, ?, ?)",
                (ex_num, worker_index, worker_count, resume_epoch),
            )

    def write_epoch(
        self,
        ex_num: int,
        worker_count: int,
        epoch: int,
        snaps: List[Tuple[str, str, Optional[bytes]]],
        commit_epoch: Optional[int],
        workers: Optional[range] = None,
        do_commit: bool = True,
    ) -> None:
        """Durably close an epoch: write snapshots, advance worker
        frontiers to ``epoch + 1``, then advance the commit watermark
        and garbage collect superseded snapshots.  In a cluster each
        process writes its own workers' frontiers and only the
        coordinator commits/GCs."""
        # Acquire write locks upfront in a fixed partition order so
        # concurrent cluster processes serialize instead of
        # deadlocking across the multi-file transaction.
        for _idx, con in sorted(self._cons.items()):
            con.execute("BEGIN IMMEDIATE")
        try:
            # Chaos site: a fault here (error/crash) lands inside the
            # multi-partition transaction, so the except-arm's ROLLBACK
            # proves snapshot writes are all-or-nothing.
            _faults.fire("snapshot.write")
            for step_id, state_key, ser_change in snaps:
                con = self._part_for_key(step_id, state_key)
                con.execute(
                    "INSERT OR REPLACE INTO snaps "
                    "(step_id, state_key, epoch, ser_change, route) "
                    "VALUES (?, ?, ?, ?, ?)",
                    (
                        step_id,
                        state_key,
                        epoch,
                        ser_change,
                        route_of(state_key, worker_count),
                    ),
                )
            for worker_index in workers if workers is not None else range(
                worker_count
            ):
                con = self._part_for_worker(worker_index)
                con.execute(
                    "INSERT OR REPLACE INTO fronts (ex_num, worker_index, epoch) "
                    "VALUES (?, ?, ?)",
                    (ex_num, worker_index, epoch + 1),
                )
            if do_commit and commit_epoch is not None and commit_epoch > 0:
                for con in self._cons.values():
                    con.execute(
                        "INSERT OR REPLACE INTO commits (epoch) VALUES (?)",
                        (commit_epoch,),
                    )
                    con.execute("DELETE FROM commits WHERE epoch < ?", (commit_epoch,))
                    # GC: drop snaps superseded by a newer snap at or
                    # before the commit watermark.
                    con.execute(
                        "DELETE FROM snaps WHERE EXISTS ("
                        "  SELECT 1 FROM snaps newer "
                        "  WHERE newer.step_id = snaps.step_id "
                        "  AND newer.state_key = snaps.state_key "
                        "  AND newer.epoch > snaps.epoch "
                        "  AND newer.epoch <= ?"
                        ")",
                        (commit_epoch,),
                    )
                    # Discard markers at/below the watermark with
                    # nothing older left are themselves dead weight.
                    con.execute(
                        "DELETE FROM snaps WHERE ser_change IS NULL "
                        "AND epoch <= ? AND NOT EXISTS ("
                        "  SELECT 1 FROM snaps older "
                        "  WHERE older.step_id = snaps.step_id "
                        "  AND older.state_key = snaps.state_key "
                        "  AND older.epoch < snaps.epoch"
                        ")",
                        (commit_epoch,),
                    )
            # Chaos site at the commit point: everything is written
            # but nothing durable yet — a crash here is the classic
            # torn-epoch window, and resume must land on the previous
            # close.
            _faults.fire("snapshot.commit")
        except BaseException:
            for con in self._cons.values():
                con.execute("ROLLBACK")
            raise
        else:
            for con in self._cons.values():
                con.execute("COMMIT")

    # -- rescale-on-resume -------------------------------------------------

    def rescale(
        self,
        new_worker_count: int,
        ex_num: Optional[int] = None,
        partial: bool = False,
    ) -> int:
        """Migrate the store to a new worker count: re-stamp keyed
        snapshot rows' routes for the M-worker modulus and rewrite
        the resumed execution's ``exs`` provenance to the new count,
        in ONE all-partition transaction (the write_epoch locking
        pattern) so a crash mid-migration rolls back whole — the
        supervisor's retry re-enters at run startup and re-runs the
        migration from scratch.  The pinned ``rescale_migrate`` fault
        site fires before any row moves.  Idempotent: re-running it
        (e.g. after a crash that committed only some partitions)
        recomputes the same routes.  Returns the number of distinct
        state keys whose rows were rewritten.

        ``partial`` is the delta-only mode (see
        :func:`rescale_snaps_rows`): keys whose home lane does not
        change under old→new are never touched, so the migration —
        and the returned count, which feeds
        ``bytewax_rescale_migrated_keys`` — scales with the delta,
        not the store.  Semantics are identical either way; the live
        rescale path always passes ``partial=True``.

        May run ONLY at run startup — the one globally-ordered
        re-entry point (a live reconfiguration re-enters exactly
        there) — and before any process reads keyed snapshots (the
        driver's startup agreement round orders peers behind the
        coordinator's migration).
        """
        for _idx, con in sorted(self._cons.items()):
            con.execute("BEGIN IMMEDIATE")
        migrated = 0
        try:
            # Chaos site: fires inside the transaction, before any row
            # moves, so an injected error/crash proves mid-migration
            # faults retry cleanly under the supervisor.
            _faults.fire("rescale_migrate")
            for con in self._cons.values():
                migrated += rescale_snaps_rows(
                    con,
                    new_worker_count,
                    page_size=self.SNAP_PAGE,
                    partial=partial,
                )
                if ex_num is not None and ex_num >= 0:
                    con.execute(
                        "UPDATE exs SET worker_count = ? "
                        "WHERE ex_num = ?",
                        (new_worker_count, ex_num),
                    )
        except BaseException:
            for con in self._cons.values():
                con.execute("ROLLBACK")
            raise
        else:
            for con in self._cons.values():
                con.execute("COMMIT")
        return migrated
