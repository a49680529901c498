"""Low-level input interfaces and input helpers.

If you want pre-built connectors, see :mod:`bytewax_tpu_torch.connectors`.

API parity with the reference (upstream bytewax ``pysrc/bytewax/inputs.py``);
implementation is our own.  Sources are driven host-side by the engine; the
engine batches their output into device micro-batches.

Batch-native sources (docs/performance.md "Columnar ingest"):
``next_batch`` may return a :class:`ColumnarBatch` — a record batch of
equal-length NumPy column arrays, optionally with ``key``/``key_id``,
``ts``, and ``value`` columns — instead of (or interleaved with) item
lists.  A columnar batch flows intact through routing, the cluster
exchange, and the device tier with zero per-row Python work; host-tier
steps that genuinely need Python objects itemize it on contact.  The
protocol is strictly additive: itemized sources work unchanged, and
one partition may mix itemized and columnar batches freely.
"""

import asyncio
import itertools
from abc import ABC, abstractmethod
from datetime import datetime, timedelta, timezone
from typing import (
    Any,
    AsyncIterator,
    Callable,
    Generic,
    Iterable,
    Iterator,
    List,
    Optional,
    TypeVar,
)

from bytewax_tpu_torch.engine.arrays import ArrayBatch as ColumnarBatch

X = TypeVar("X")
S = TypeVar("S")
Sn = TypeVar("Sn")

__all__ = [
    "AbortExecution",
    "ColumnarBatch",
    "DynamicSource",
    "FixedPartitionedSource",
    "SimplePollingSource",
    "Source",
    "StatefulSourcePartition",
    "StatelessSourcePartition",
    "batch",
    "batch_async",
    "batch_getter",
    "batch_getter_ex",
]


class AbortExecution(RuntimeError):
    """Raise this from ``next_batch`` to abort the whole execution
    immediately, without a final snapshot (simulates a hard crash for
    recovery testing).

    :class:`bytewax_tpu_torch.testing.TestingSource` raises it at the
    ``ABORT`` sentinel; the engine stops the execution there (no items
    past the sentinel, no final snapshot).  Each sentinel triggers
    only once, so re-running the same flow continues past it:

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("abort_eg")
    >>> src = TestingSource([1, TestingSource.ABORT(), 2])
    >>> s = op.input("inp", flow, src)
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [1]
    >>> run_main(flow)  # replays; the abort is spent
    >>> out
    [1, 1, 2]

    Reference parity: ``src/inputs.rs:99-104``.
    """


class Source(ABC, Generic[X]):  # noqa: B024
    """Where a dataflow gets input data from.

    Do not subclass this directly; subclass
    :class:`FixedPartitionedSource` or :class:`DynamicSource`.
    """


class StatefulSourcePartition(ABC, Generic[X, S]):
    """Input partition that maintains recoverable state.

    ``next_batch`` must never block: return an empty iterable if there
    are no items yet, and use :meth:`next_awake` to schedule polling.

    Connector-edge resilience (docs/recovery.md): raise
    :class:`bytewax_tpu_torch.errors.TransientSourceError` from
    ``next_batch`` — *before* advancing the read position — for
    failures worth retrying in place; the engine re-polls with capped
    jittered backoff (``BYTEWAX_TPU_IO_RETRIES``), quarantines the
    partition after exhaustion when ``BYTEWAX_TPU_QUARANTINE=1``, and
    otherwise escalates to the restartable-fault path.  Common
    transient ``OSError``s/timeouts are classified automatically.  A
    partition may additionally implement ``drain_dead_letters() ->
    List[dict]`` (the ``on_error="dlq"`` policy on the built-in
    connectors): the engine drains it after every poll and captures
    the records — poison rows the partition consumed but could not
    decode — into the dead-letter queue with provenance, in the epoch
    whose snapshots cover the consumed offsets.
    """

    @abstractmethod
    def next_batch(self) -> Iterable[X]:
        """Attempt to get the next batch of input items, non-blocking.

        May return a :class:`ColumnarBatch` instead of an item list
        (batch-native protocol — the batch rides the engine's columnar
        fast path without itemizing); itemized and columnar batches
        may be mixed freely across calls.

        Raise :class:`StopIteration` when complete (EOF).
        """
        ...

    def next_awake(self) -> Optional[datetime]:
        """Next system time this partition should be polled.

        ``None`` (default) means poll again as soon as possible (the
        engine applies a short cooldown after empty batches, matching
        the reference's 1 ms: ``src/inputs.rs:38``).
        """
        return None

    @abstractmethod
    def snapshot(self) -> S:
        """Snapshot the position of the next read of this partition.

        This will be returned to you via ``build_part``'s
        ``resume_state`` on resume; the source must resume reading
        *exactly* at this position for exactly-once semantics.
        """
        ...

    def close(self) -> None:
        """Cleanup this partition on EOF or shutdown."""
        return None


class FixedPartitionedSource(Source[X], Generic[X, S]):
    """An input source with a fixed number of independent partitions.

    Partitions are distributed across workers; state is snapshotted and
    routed back on resume and rescale.

    A source reading two lists as two resumable partitions:

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.inputs import (
    ...     FixedPartitionedSource, StatefulSourcePartition,
    ... )
    >>> from bytewax_tpu_torch.testing import TestingSink, run_main
    >>> DATA = {"p0": [1, 2], "p1": [10]}
    >>> class ListPart(StatefulSourcePartition):
    ...     def __init__(self, items, at):
    ...         self._items, self._at = items, at
    ...     def next_batch(self):
    ...         if self._at >= len(self._items):
    ...             raise StopIteration()
    ...         self._at += 1
    ...         return [self._items[self._at - 1]]
    ...     def snapshot(self):
    ...         return self._at
    >>> class ListSource(FixedPartitionedSource):
    ...     def list_parts(self):
    ...         return sorted(DATA)
    ...     def build_part(self, step_id, for_part, resume_state):
    ...         return ListPart(DATA[for_part], resume_state or 0)
    >>> flow = Dataflow("fixed_part_eg")
    >>> s = op.input("inp", flow, ListSource())
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> sorted(out)
    [1, 2, 10]
    """

    @abstractmethod
    def list_parts(self) -> List[str]:
        """List all local partition ids.  Must be deterministic and
        unique across the whole cluster."""
        ...

    @abstractmethod
    def build_part(
        self,
        step_id: str,
        for_part: str,
        resume_state: Optional[S],
    ) -> StatefulSourcePartition[X, S]:
        """Build anew or resume an input partition."""
        ...


class StatelessSourcePartition(ABC, Generic[X]):
    """Input partition that does not maintain recoverable state."""

    @abstractmethod
    def next_batch(self) -> Iterable[X]:
        """Attempt to get the next batch of input items, non-blocking.

        May return a :class:`ColumnarBatch` instead of an item list
        (see :class:`StatefulSourcePartition.next_batch`).

        Raise :class:`StopIteration` when complete (EOF).
        """
        ...

    def next_awake(self) -> Optional[datetime]:
        """Next system time this partition should be polled."""
        return None

    def close(self) -> None:
        """Cleanup this partition on EOF or shutdown."""
        return None


class DynamicSource(Source[X]):
    """An input source where all workers can read distinct items.

    Reads are not recoverable; designed for ephemeral sources.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.inputs import DynamicSource, StatelessSourcePartition
    >>> from bytewax_tpu_torch.testing import TestingSink, run_main
    >>> class StridePart(StatelessSourcePartition):
    ...     def __init__(self, start, step):
    ...         self._nums = iter(range(start, 4, step))
    ...     def next_batch(self):
    ...         return [next(self._nums)]  # StopIteration = EOF
    >>> class StrideSource(DynamicSource):
    ...     def build(self, step_id, worker_index, worker_count):
    ...         return StridePart(worker_index, worker_count)
    >>> flow = Dataflow("dynamic_eg")
    >>> s = op.input("inp", flow, StrideSource())
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> sorted(out)
    [0, 1, 2, 3]
    """

    @abstractmethod
    def build(
        self, step_id: str, worker_index: int, worker_count: int
    ) -> StatelessSourcePartition[X]:
        """Build an input partition for a worker.

        Use ``worker_index``/``worker_count`` to avoid duplicate reads.
        """
        ...


class _SimplePollingPartition(StatefulSourcePartition[X, Any]):
    def __init__(
        self,
        interval: timedelta,
        align_to: Optional[datetime],
        getter: Callable[[], Optional[X]],
        snapshotter: Callable[[], Any],
    ):
        self._interval = interval
        self._getter = getter
        self._snapshotter = snapshotter
        now = datetime.now(timezone.utc)
        if align_to is not None and align_to > now:
            self._next_awake = align_to
        elif align_to is not None:
            # Next aligned instant after now.
            behind = (now - align_to) // interval
            self._next_awake = align_to + interval * (behind + 1)
        else:
            self._next_awake = now

    def next_batch(self) -> List[X]:
        self._next_awake += self._interval
        try:
            item = self._getter()
        except SimplePollingSource.Retry as ex:
            self._next_awake = datetime.now(timezone.utc) + ex.timeout
            return []
        if item is None:
            return []
        return [item]

    def next_awake(self) -> Optional[datetime]:
        return self._next_awake

    def snapshot(self) -> Any:
        return self._snapshotter()


class SimplePollingSource(FixedPartitionedSource[X, Any]):
    """Calls a user-defined function at a regular interval.

    Subclass and implement :meth:`next_item`.  Raise
    :class:`SimplePollingSource.Retry` to retry sooner than the
    interval.

    >>> from datetime import timedelta
    >>> from bytewax_tpu_torch.inputs import SimplePollingSource
    >>> class CounterSource(SimplePollingSource):
    ...     def __init__(self):
    ...         super().__init__(interval=timedelta(seconds=10))
    ...         self.n = 0
    ...     def next_item(self):
    ...         self.n += 1
    ...         return self.n
    >>> src = CounterSource()
    >>> src.list_parts()
    ['singleton']
    >>> part = src.build_part("poll", "singleton", None)
    >>> part.next_batch()
    [1]

    Reference parity: ``inputs.py:333``.
    """

    class Retry(Exception):
        """Raise from ``next_item`` to retry after a timeout."""

        def __init__(self, timeout: timedelta):
            self.timeout = timeout

    def __init__(self, interval: timedelta, align_to: Optional[datetime] = None):
        if interval < timedelta(seconds=0):
            msg = "interval must be positive"
            raise ValueError(msg)
        self._interval = interval
        self._align_to = align_to

    def list_parts(self) -> List[str]:
        return ["singleton"]

    def build_part(
        self, step_id: str, for_part: str, resume_state: Optional[Any]
    ) -> _SimplePollingPartition[X]:
        if resume_state is not None:
            self.resume(resume_state)
        return _SimplePollingPartition(
            self._interval, self._align_to, self.next_item, self.snapshot
        )

    @abstractmethod
    def next_item(self) -> Optional[X]:
        """Fetch the next item; return ``None`` if nothing new."""
        ...

    def snapshot(self) -> Any:
        """Snapshot the position of the next read (returned to
        :meth:`resume` on the next execution).  Return a state that
        resumes reading *after* the last emitted item.  Defaults to
        ``None`` (stateless polling)."""
        return None

    def resume(self, resume_state: Any) -> None:
        """Reset the position of the next read; called once before
        :meth:`next_item` when this execution is a resume.

        Reference parity: ``inputs.py:443``.
        """
        return None


def batch(ib: Iterable[X], batch_size: int) -> Iterator[List[X]]:
    """Batch an iterable into lists of up to ``batch_size``.

    >>> from bytewax_tpu_torch.inputs import batch
    >>> list(batch(range(5), 2))
    [[0, 1], [2, 3], [4]]
    """
    it = iter(ib)
    while True:
        chunk = list(itertools.islice(it, batch_size))
        if not chunk:
            return
        yield chunk


def batch_getter(
    getter: Callable[[], X], batch_size: int, yield_on: Optional[X] = None
) -> Iterator[List[X]]:
    """Batch a getter that returns a sentinel when no more items.

    >>> from bytewax_tpu_torch.inputs import batch_getter
    >>> items = [1, 2, 3]
    >>> def getter():
    ...     return items.pop(0) if items else None
    >>> it = batch_getter(getter, 2)
    >>> next(it), next(it)
    ([1, 2], [3])
    """
    while True:
        chunk: List[X] = []
        while len(chunk) < batch_size:
            item = getter()
            if item == yield_on:
                break
            chunk.append(item)
        yield chunk


def batch_getter_ex(
    getter: Callable[[], X], batch_size: int, yield_ex=IndexError
) -> Iterator[List[X]]:
    """Batch a getter that raises an exception when no more items.

    Shaped for stdlib ``queue.Queue.get_nowait`` (raises ``Empty``):

    >>> import queue
    >>> from bytewax_tpu_torch.inputs import batch_getter_ex
    >>> q = queue.Queue()
    >>> for i in range(3):
    ...     q.put(i)
    >>> it = batch_getter_ex(q.get_nowait, 2, yield_ex=queue.Empty)
    >>> next(it), next(it)
    ([0, 1], [2])
    """
    while True:
        chunk: List[X] = []
        while len(chunk) < batch_size:
            try:
                chunk.append(getter())
            except yield_ex:
                break
        yield chunk


def batch_async(
    aib: AsyncIterator[X],
    timeout: timedelta,
    batch_size: int,
    loop: Optional[asyncio.AbstractEventLoop] = None,
) -> Iterator[List[X]]:
    """Batch an async iterator from within a sync ``next_batch``.

    Gathers up to ``batch_size`` items, waiting at most ``timeout``;
    yields possibly-empty batches without blocking forever.

    >>> from datetime import timedelta
    >>> from bytewax_tpu_torch.inputs import batch_async
    >>> async def gen():
    ...     for i in range(3):
    ...         yield i
    >>> list(batch_async(gen(), timeout=timedelta(seconds=1), batch_size=2))
    [[0, 1], [2]]

    Reference parity: ``inputs.py:546``.
    """
    loop = loop if loop is not None else asyncio.new_event_loop()
    pending: List[asyncio.Task] = []
    eof = False

    async def gather() -> List[X]:
        nonlocal eof
        chunk: List[X] = []
        deadline = loop.time() + timeout.total_seconds()
        while len(chunk) < batch_size:
            remaining = deadline - loop.time()
            if remaining <= 0:
                break
            # Resume the in-flight anext from a previous timeout, if any;
            # shield keeps it alive across wait_for cancellation.
            task = pending.pop() if pending else loop.create_task(
                aib.__anext__()  # type: ignore[arg-type]
            )
            try:
                item = await asyncio.wait_for(
                    asyncio.shield(task), timeout=remaining
                )
            except asyncio.TimeoutError:
                pending.append(task)
                break
            except StopAsyncIteration:
                eof = True
                break
            chunk.append(item)
        return chunk

    while True:
        chunk = loop.run_until_complete(gather())
        if chunk or not eof:
            yield chunk
        if eof:
            return
