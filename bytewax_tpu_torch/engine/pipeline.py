"""Bounded asynchronous device-dispatch pipeline.

The device tier used to run lock-step: every delivery did its host
routing, folded on device, and then *blocked* on the host readbacks
(due-window snapshot fetches, scan output columns, touched-key lists)
before the driver could touch the next batch — so the host router and
the accelerator took turns idling.  A :class:`DevicePipeline` breaks
that lock-step with the classic double-buffered overlap (the
pipelined-shuffle shape of Exoshuffle, arxiv 2203.05072; DrJAX's
observation that JAX async dispatch carries aggregation without
per-step synchronization, arxiv 2403.07128):

- The **main thread** keeps everything that must stay ordered with the
  rest of the dataflow: cluster routing/splits, vocab sync, watermark
  bookkeeping, and every ``emit`` downstream.
- Each delivery's **device phase** (slot allocation, padding,
  ``device_put``, the fold kernel, due-window snapshot fetches, scan
  output materialization, event *construction*) is packaged as one
  ordered task and handed to a single worker thread, so batch N's
  kernel and readback overlap batch N+1's host ingest.
- Host-visible results (downstream emissions, touched keys) are parked
  with the task and surface only at **finalize**, on the main thread,
  in submission order.

Depth (``BYTEWAX_TPU_PIPELINE_DEPTH``, default 2) bounds the in-flight
deliveries; at depth 1 the task runs inline on the main thread at
submit — byte-identical to the pre-pipeline engine.  Every host
readback therefore happens at an explicit **drain point**: the next
submit over depth, window-close/notify, epoch close (before
snapshots), the EOF ladder, demotion (``demotion_snapshots()`` first
drains), and any gsync-bearing path (the collective global-exchange
tier never enters the pipeline at all).  See docs/performance.md.

Contract notes (docs/contracts.md): the pipeline adds **no send
surface and no control-frame kinds** — tasks are process-local device
work; anything cluster-visible still rides ``ship_deliver`` /
``ship_route`` / ``global_sync`` from the main thread.  The
``faults.fire("device_dispatch")`` site stays on the main thread and
precedes task creation, so an injected :class:`DeviceFault` is raised
before any device state mutates; a fault surfacing at a drain point
(a worker-raised XLA error) propagates from :meth:`flush`/:meth:`submit`
into the same retry/demotion path.
"""

import os
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Tuple

from bytewax_tpu_torch.engine import flight as _flight

__all__ = ["DevicePipeline", "pipeline_depth"]


def pipeline_depth() -> int:
    """The configured pipeline depth (min 1).  Depth 1 disables the
    worker thread entirely: tasks run inline at submit, preserving the
    pre-pipeline engine's exact operation order."""
    raw = os.environ.get("BYTEWAX_TPU_PIPELINE_DEPTH", "2") or "2"
    try:
        depth = int(raw)
    except ValueError:
        msg = (
            f"BYTEWAX_TPU_PIPELINE_DEPTH={raw!r} is not an integer; "
            "use 1 (synchronous) or the in-flight delivery bound"
        )
        raise ValueError(msg) from None
    return max(1, depth)


class DevicePipeline:
    """Ordered bounded task pipeline for one device-tier step.

    ``submit(task, finalize)`` runs ``task()`` (the device phase) off
    the main thread and later calls ``finalize(result)`` on the main
    thread, in submission order.  ``submit`` first makes room: when
    the pipeline already holds ``depth - 1`` pending tasks it
    finalizes the oldest (blocking on its device work if needed), so
    at most ``depth`` deliveries are ever in flight.

    Exceptions raised by a task propagate on the main thread at the
    drain point that collects it (``submit``/``flush``/
    ``finalize_ready``) — callers route them into the same
    retry/demotion handling as a synchronous fault.  A task that
    raised is dropped from the queue (its ``finalize`` never runs).
    """

    __slots__ = ("depth", "step_id", "phase", "_pending", "_pool")

    def __init__(
        self,
        step_id: str,
        depth: Optional[int] = None,
        phase: str = "device",
    ):
        self.depth = pipeline_depth() if depth is None else max(1, depth)
        self.step_id = step_id
        #: Ledger phase the worker's task time is attributed to.
        #: ``"device"`` is the per-delivery dispatch pipeline;
        #: ``"collective_lane"`` is the overlapped global-exchange
        #: lane (docs/performance.md "Overlapped collectives") — its
        #: seconds land in the ledger's gsync/collective bucket on
        #: their own lane instead of inflating the main-thread close
        #: window, so ``derive_rescale_hint``'s signals stay truthful.
        #: ``"snapshot_lane"`` is the asynchronous checkpoint
        #: committer lane (docs/recovery.md "Asynchronous incremental
        #: checkpoints") — same off-main-window treatment, snapshot
        #: fraction bucket.
        self.phase = phase
        #: (future, finalize, submit_monotonic) in submission order.
        self._pending: deque = deque()
        self._pool: Optional[ThreadPoolExecutor] = None

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        return len(self._pending)

    def pending(self) -> bool:
        return bool(self._pending)

    # -- submission --------------------------------------------------------

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            # ONE worker: tasks must execute in submission order (the
            # device slot tables are handed off between tasks, never
            # shared concurrently).
            self._pool = ThreadPoolExecutor(
                max_workers=1,
                thread_name_prefix=f"btx-pipe-{self.step_id}",
            )
        return self._pool

    def make_room(self) -> None:
        """Finalize the oldest pending tasks until another delivery
        fits under the depth bound.  Callers run this BEFORE preparing
        the next delivery so a finalizer that re-routes work (a
        host-tier fallback) is observed before anything new enters
        the pipeline — at the default depth 2 every finalizer
        therefore runs before any later task starts."""
        while len(self._pending) >= max(1, self.depth - 1):
            self._finalize_oldest()

    def push(
        self,
        task: Callable[[], Any],
        finalize: Callable[[Any], None],
    ) -> None:
        """Hand one delivery's device phase to the worker;
        ``finalize(result)`` fires on the caller's thread at a later
        drain point.  At depth 1 the task runs inline — identical
        operation order to the pre-pipeline engine, no worker thread.
        Makes room first, so the depth bound holds even for
        multi-entry deliveries that push several phases."""
        if self.depth <= 1:
            t0 = time.monotonic()
            result = self._run(task)
            dur = time.monotonic() - t0
            # Inline (lock-step) mode folds ON the main thread: lane 0,
            # so the seconds charge the enclosing host frame instead of
            # double-counting against it as overlapped worker time.
            _flight.note_phase(
                self.phase, self.step_id, dur, t0=t0, lane=0
            )
            finalize(result)
            _flight.note_source_lag(
                self.step_id, "processing", time.monotonic() - t0
            )
            _flight.DEVICE_TIMES.resolve()
            return
        self.make_room()
        fut = self._ensure_pool().submit(self._timed, task)
        self._pending.append((fut, finalize, time.monotonic()))

    def _run(self, task: Callable[[], Any]) -> Any:
        """Run one task as the profiler range of this lane's phase
        (``bytewax.device`` for the dispatch pipeline)."""
        rng = _flight.open_range(self.phase)
        try:
            return task()
        finally:
            _flight.close_range(rng)

    def _timed(self, task: Callable[[], Any]) -> Tuple[float, float, Any]:
        """Worker-side wrapper: stamp the device phase's wall
        interval so the ledger's ``device`` lane is recorded (on the
        main thread, at finalize) with the worker's real timing."""
        t0 = time.monotonic()
        result = self._run(task)
        return t0, time.monotonic() - t0, result

    #: ``make_room()`` + append, under one name for direct callers.
    submit = push

    # -- draining ----------------------------------------------------------

    def _finalize_oldest(self) -> None:
        fut, finalize, t_submit = self._pending.popleft()
        device = self.phase == "device"
        t0 = time.monotonic()
        rng = _flight.open_range("flush") if device else None
        try:
            dev_t0, dev_dur, result = fut.result()
        finally:
            _flight.close_range(rng)
            stalled = time.monotonic() - t0
            if stalled > 0.0005:
                if device:
                    _flight.note_pipeline_stall(self.step_id, stalled)
                elif self.phase == "snapshot_lane":
                    # Checkpoint-fence waits are durability pressure
                    # (the previous epoch's async commit hasn't landed
                    # yet), not device-flush pressure: own counter so
                    # the rescale hint's flush-stall signal stays
                    # truthful (docs/recovery.md "Asynchronous
                    # incremental checkpoints").
                    _flight.RECORDER.count(
                        "snapshot_fence_stall_seconds", stalled
                    )
                else:
                    # Collective-fence waits are gsync pressure, not
                    # device-flush pressure: keep them out of the
                    # rescale hint's flush-stall signal (the wait is
                    # already visible as main-thread collective time).
                    _flight.RECORDER.count(
                        "collective_fence_stall_seconds", stalled
                    )
        # Ledger: the worker phase's wall interval (worker lane — it
        # overlaps host time and never charges the enclosing phase),
        # then the host-side finalize (emission routing, touched-key
        # absorption: the readback surfacing point).
        _flight.note_phase(
            self.phase, self.step_id, dev_dur, t0=dev_t0, lane=1
        )
        tf = time.monotonic()
        rng = _flight.open_range("readback") if device else None
        try:
            finalize(result)
        finally:
            _flight.close_range(rng)
        now = time.monotonic()
        if device:
            _flight.note_phase(
                "readback", self.step_id, now - tf, t0=tf
            )
        # Ingest→emit latency of this delivery through the pipeline
        # (submit to finalized emissions).
        _flight.note_source_lag(
            self.step_id, "processing", now - t_submit
        )
        # A drain point on the main thread: launches whose events
        # completed meanwhile resolve into their device seconds.
        _flight.DEVICE_TIMES.resolve()

    def finalize_ready(self) -> None:
        """Finalize completed tasks without blocking on running ones —
        the liveness hook the driver calls every loop so emissions and
        notify hints keep flowing while the stream idles."""
        while self._pending and self._pending[0][0].done():
            self._finalize_oldest()

    def flush(self) -> None:
        """Drain point: block until every pending task has finalized.

        Called before anything reads or hands off the device-tier
        state the worker owns between submit and finalize — epoch
        snapshots, window-close/notify, the EOF ladder, demotion, and
        (driver-level) before any gsync round.
        """
        if not self._pending:
            return
        _flight.note_flush_depth(self.step_id, len(self._pending))
        _flight.RECORDER.record(
            "pipeline_flush", step=self.step_id, pending=len(self._pending)
        )
        while self._pending:
            self._finalize_oldest()

    def drop_pending(self) -> List[Tuple[Future, Callable, float]]:
        """Abandon pending tasks (after a fault already propagated):
        waits for the worker to go quiet but runs no finalizers;
        returns what was dropped so callers can count it."""
        dropped = list(self._pending)
        self._pending.clear()
        for fut, _fin, _t in dropped:
            # Unstarted tasks skip entirely; a running one is waited
            # for (CancelledError/task errors are already surfaced or
            # moot on this teardown path).
            fut.cancel()
            try:
                fut.result()
            except BaseException:  # noqa: BLE001 — already surfaced
                pass
        return dropped

    def shutdown(self) -> None:
        """Stop the worker (idempotent).  Pending tasks are flushed by
        the caller first; this only tears the thread down."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)
