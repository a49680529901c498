"""Helper tools for testing dataflows.

API parity with the reference (upstream bytewax ``pysrc/bytewax/testing.py``);
implementation is our own.
"""

from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from itertools import islice
from typing import Any, Iterable, Iterator, List, Optional, TypeVar, Union

from bytewax_tpu_torch.inputs import (
    AbortExecution,
    FixedPartitionedSource,
    StatefulSourcePartition,
)
from bytewax_tpu_torch.outputs import DynamicSink, StatelessSinkPartition
from bytewax_tpu_torch.engine.driver import cluster_main, run_main

X = TypeVar("X")

__all__ = [
    "TestingSink",
    "TestingSource",
    "TimeTestingGetter",
    "cluster_main",
    "ffwd_iter",
    "poll_next_batch",
    "run_main",
]


@dataclass
class TimeTestingGetter:
    """Wrapper providing a modifiable fake clock for unit tests.

    >>> from datetime import datetime, timedelta, timezone
    >>> from bytewax_tpu_torch.testing import TimeTestingGetter
    >>> t = TimeTestingGetter(datetime(2024, 1, 1, tzinfo=timezone.utc))
    >>> t.advance(timedelta(minutes=5))
    >>> t.get().minute
    5
    """

    now: datetime

    def advance(self, td: timedelta) -> None:
        """Advance the current time by ``td``."""
        self.now += td

    def get(self) -> datetime:
        """Return the "current time"."""
        return self.now


def ffwd_iter(it: Iterator[Any], n: int) -> None:
    """Skip a stateful iterator forward ``n`` items.

    >>> from bytewax_tpu_torch.testing import ffwd_iter
    >>> it = iter(range(5))
    >>> ffwd_iter(it, 3)
    >>> next(it)
    3
    """
    next(islice(it, n, n), None)


class TestingSource(FixedPartitionedSource[X, int]):
    """Produce input from a Python iterable; unit testing only.

    The iterable may contain in-band control sentinels: :class:`EOF`
    stops this execution (the next resumes after it), :class:`ABORT`
    simulates a crash (triggers once; the next execution replays from
    the last snapshot), :class:`PAUSE` stops emitting for a duration.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("testing_source_eg")
    >>> s = op.input("inp", flow, TestingSource(["a", "b"], batch_size=2))
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    ['a', 'b']
    """

    __test__ = False

    @dataclass
    class EOF:
        """Signal the input to EOF; the next execution continues from
        the item after this."""

    @dataclass
    class ABORT:
        """Abort the execution when the input reaches this item.

        Each abort only triggers once; skipped on resume.  Not usable
        in multi-worker executions.
        """

        _triggered: bool = False

    @dataclass
    class PAUSE:
        """Signal this input to not emit items for a duration."""

        for_duration: timedelta = field(default_factory=timedelta)

    def __init__(
        self,
        ib: Iterable[Union[X, EOF, ABORT, PAUSE]],
        batch_size: int = 1,
    ):
        self._ib = ib
        self._batch_size = batch_size

    def list_parts(self) -> List[str]:
        return ["iterable"]

    def build_part(
        self, step_id: str, for_part: str, resume_state: Optional[int]
    ) -> "_IterSourcePartition[X]":
        return _IterSourcePartition(self._ib, self._batch_size, resume_state)


class _IterSourcePartition(StatefulSourcePartition[X, int]):
    def __init__(
        self,
        ib: Iterable,
        batch_size: int,
        resume_state: Optional[int],
    ):
        self._start_idx = 0 if resume_state is None else resume_state
        self._batch_size = batch_size
        self._next_awake: Optional[datetime] = None
        if type(ib) is list:
            # List inputs take a sliced fast path in next_batch: the
            # common benchmark/test shape must not pay a per-item
            # Python loop in the source.  One isinstance scan up
            # front decides (exact iterator-path semantics, incl.
            # sentinel subclasses); sentinels appended to the list
            # after construction are not supported on this path.
            self._lst: Optional[List] = ib
            self._idx = self._start_idx
            self._it = iter(())
            has_sentinel = None
            if len(ib) >= 4096:
                # Long lists (the benchmark shape) take the C scan;
                # short ones stay pure Python so constructing a tiny
                # test source never triggers the lazy native build.
                from bytewax_tpu_torch.native import any_isinstance

                has_sentinel = any_isinstance(ib, self._SENTINELS)
            if has_sentinel is None:  # short list / no toolchain
                has_sentinel = any(
                    isinstance(x, self._SENTINELS) for x in ib
                )
            self._lst_clean = not has_sentinel
        else:
            self._lst = None
            self._it = iter(ib)
            ffwd_iter(self._it, self._start_idx)
        self._raise: Optional[Exception] = None

    _SENTINELS = (TestingSource.EOF, TestingSource.ABORT, TestingSource.PAUSE)

    def _next_batch_list(self) -> List[X]:
        lst = self._lst
        i = self._idx
        if self._lst_clean:
            # Sentinel-free list: the slice is the batch.
            chunk = lst[i : i + self._batch_size]
            if not chunk:
                raise StopIteration()
            self._idx = i + len(chunk)
            self._start_idx += len(chunk)
            return chunk
        # Sentinels present: per-item semantics identical to the
        # iterator path, including its snapshot-index accounting.
        batch: List[X] = []
        append = batch.append
        size = self._batch_size
        sentinels = self._SENTINELS
        while self._idx < len(lst):
            item = lst[self._idx]
            self._idx += 1
            if not isinstance(item, sentinels):
                append(item)
                if len(batch) >= size:
                    break
            elif isinstance(item, TestingSource.EOF):
                self._raise = StopIteration()
                # Skip over the sentinel on continuation.
                self._start_idx += 1
                break
            elif isinstance(item, TestingSource.ABORT):
                if not item._triggered:
                    self._raise = AbortExecution()
                    item._triggered = True
                    break
            else:  # PAUSE
                now = datetime.now(tz=timezone.utc)
                self._next_awake = now + item.for_duration
                break
        if batch or self._raise is not None or self._next_awake is not None:
            self._start_idx += len(batch)
            return batch
        raise StopIteration()

    def next_batch(self) -> List[X]:
        if self._raise is not None:
            raise self._raise
        self._next_awake = None
        if self._lst is not None:
            return self._next_batch_list()

        batch: List[X] = []
        append = batch.append
        size = self._batch_size
        sentinels = self._SENTINELS
        for item in self._it:
            if not isinstance(item, sentinels):
                append(item)
                if len(batch) >= size:
                    break
            elif isinstance(item, TestingSource.EOF):
                self._raise = StopIteration()
                # Skip over the sentinel on continuation.
                self._start_idx += 1
                break
            elif isinstance(item, TestingSource.ABORT):
                if not item._triggered:
                    self._raise = AbortExecution()
                    item._triggered = True
                    break
            else:  # PAUSE
                now = datetime.now(tz=timezone.utc)
                self._next_awake = now + item.for_duration
                break

        if batch or self._raise is not None or self._next_awake is not None:
            self._start_idx += len(batch)
            return batch
        raise StopIteration()

    def next_awake(self) -> Optional[datetime]:
        return self._next_awake

    def snapshot(self) -> int:
        return self._start_idx


class _ListSinkPartition(StatelessSinkPartition[X]):
    def __init__(self, ls: List[X]):
        self._ls = ls

    def write_batch(self, items: List[X]) -> None:
        self._ls += items


class TestingSink(DynamicSink[X]):
    """Append each output item to a list; unit testing only.

    The list is not cleared between executions.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("testing_sink_eg")
    >>> s = op.input("inp", flow, TestingSource([1, 2]))
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [1, 2]
    """

    __test__ = False

    def __init__(self, ls: List[X]):
        self._ls = ls

    def build(
        self, step_id: str, worker_index: int, worker_count: int
    ) -> _ListSinkPartition[X]:
        return _ListSinkPartition(self._ls)


def poll_next_batch(
    part: StatefulSourcePartition, timeout: timedelta = timedelta(seconds=5)
) -> Any:
    """Repeatedly poll a partition until it returns a batch.

    A batch-native partition's :class:`~bytewax_tpu_torch.inputs.ColumnarBatch`
    is returned as-is; item batches come back as lists.

    >>> from bytewax_tpu_torch.testing import TestingSource, poll_next_batch
    >>> src = TestingSource([1, 2], batch_size=2)
    >>> part = src.build_part("eg", "iterable", None)
    >>> poll_next_batch(part)
    [1, 2]
    """
    from bytewax_tpu_torch.inputs import ColumnarBatch

    batch: Any = []
    start = datetime.now(timezone.utc)
    while len(batch) <= 0:
        if datetime.now(timezone.utc) - start > timeout:
            raise TimeoutError()
        batch = part.next_batch()
        if not isinstance(batch, ColumnarBatch):
            batch = list(batch)
    return batch


def _cluster_test_main() -> None:
    """``python -m bytewax_tpu_torch.testing``: spawn a localhost
    cluster of subprocesses running the given flow (parity with
    upstream bytewax ``pysrc/bytewax/testing.py:311-343``).  Each child
    runs ``python -m bytewax_tpu_torch.run``; on one host they share
    its one card (``cuda:0``) unless ``BYTEWAX_TPU_PLATFORM=cpu``."""
    import os
    import socket
    import subprocess
    import sys

    from bytewax_tpu_torch.run import _create_arg_parser

    parser = _create_arg_parser()
    parser.prog = "python -m bytewax_tpu_torch.testing"
    parser.add_argument(
        "-p",
        "--processes",
        type=int,
        default=1,
        help="Number of local processes to spawn",
    )
    args = parser.parse_args()

    if args.processes == 1 and (args.workers_per_process or 1) == 1:
        from bytewax_tpu_torch.run import _main as run_main_cli

        passthrough = [sys.argv[0], args.import_str]
        if args.recovery_directory is not None:
            passthrough += ["-r", str(args.recovery_directory)]
        if args.snapshot_interval is not None:
            passthrough += ["-s", str(args.snapshot_interval.total_seconds())]
        if args.backup_interval is not None:
            passthrough += ["-b", str(args.backup_interval.total_seconds())]
        if args.rescale:
            passthrough += ["--rescale"]
        sys.argv = passthrough
        run_main_cli()
        return

    # Allocate each worker's port and HOLD it (SO_REUSEPORT, not
    # listening) until the children have spawned: closing before the
    # child rebinds would let any concurrent process steal the port.
    addresses = []
    holders = []
    for _ in range(args.processes):
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if hasattr(socket, "SO_REUSEPORT"):
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.bind(("127.0.0.1", 0))
        holders.append(s)
        addresses.append(f"127.0.0.1:{s.getsockname()[1]}")

    procs = []
    for proc_id in range(args.processes):
        env = dict(os.environ)
        # The children must rebind the ports this parent is holding;
        # production binds stay exclusive (see engine/comm.py).
        env["BYTEWAX_TPU_REUSEPORT"] = "1"
        env["BYTEWAX_ADDRESSES"] = ";".join(addresses)
        env["BYTEWAX_PROCESS_ID"] = str(proc_id)
        if args.workers_per_process:
            env["BYTEWAX_WORKERS_PER_PROCESS"] = str(args.workers_per_process)
        cmd = [sys.executable, "-m", "bytewax_tpu_torch.run", args.import_str]
        if args.recovery_directory is not None:
            cmd += ["-r", str(args.recovery_directory)]
        if args.snapshot_interval is not None:
            cmd += ["-s", str(args.snapshot_interval.total_seconds())]
        if args.backup_interval is not None:
            cmd += ["-b", str(args.backup_interval.total_seconds())]
        if args.rescale:
            cmd += ["--rescale"]
        procs.append(subprocess.Popen(cmd, env=env))

    exit_code = 0
    try:
        for proc in procs:
            proc.wait()
            exit_code = exit_code or proc.returncode
        for holder in holders:
            holder.close()
    except KeyboardInterrupt:
        for proc in procs:
            proc.terminate()
        for proc in procs:
            proc.wait()
        exit_code = 130
    sys.exit(exit_code)


if __name__ == "__main__":
    _cluster_test_main()
