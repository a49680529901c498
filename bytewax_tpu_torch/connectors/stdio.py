"""Connectors to console IO.

Reference parity: upstream bytewax ``pysrc/bytewax/connectors/stdio.py``
(plus a batch-native stdin source; the reference has none).
"""

import os
import select
import sys
from typing import Any, List, Optional, Union

from bytewax_tpu_torch.inputs import (
    ColumnarBatch,
    DynamicSource,
    StatelessSourcePartition,
)
from bytewax_tpu_torch.outputs import DynamicSink, StatelessSinkPartition

__all__ = ["StdInSource", "StdOutSink"]


class _PrintSinkPartition(StatelessSinkPartition[Any]):
    def write_batch(self, items: List[Any]) -> None:
        if not items:
            return
        sys.stdout.write("\n".join(map(str, items)))
        sys.stdout.write("\n")
        sys.stdout.flush()

    def write_array_batch(self, batch: ColumnarBatch) -> None:
        """Columnar deliveries print without itemizing first: a
        single-column batch joins the column in one vectorized pass;
        multi-column batches degrade through ``to_pylist``."""
        if len(batch.cols) == 1:
            col = batch.numpy(next(iter(batch.cols)))
            if len(col):
                sys.stdout.write("\n".join(col.astype(str).tolist()))
                sys.stdout.write("\n")
                sys.stdout.flush()
            return
        self.write_batch(batch.to_pylist())


class StdOutSink(DynamicSink[Any]):
    """Write each output item to stdout on that worker, one per line.

    Items must be convertible with ``str``.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.connectors.stdio import StdOutSink
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSource, run_main
    >>> flow = Dataflow("stdout_eg")
    >>> s = op.input("inp", flow, TestingSource(["hello"]))
    >>> op.output("out", s, StdOutSink())
    >>> run_main(flow)
    hello
    """

    def build(
        self, step_id: str, worker_index: int, worker_count: int
    ) -> _PrintSinkPartition:
        return _PrintSinkPartition()


class _StdInPartition(StatelessSourcePartition[Any]):
    """Both modes read raw fd chunks through one ``LineBatcher``; the
    mode only picks the emission form (columnar batch vs. ``str``
    items).  Reading the fd directly keeps the ``select`` gate
    truthful — a text-layer ``readline`` would drain several lines
    into Python's stdio buffer and return one, stranding the rest
    behind a not-ready fd until new bytes arrive."""

    def __init__(
        self,
        columnar: bool,
        chunk_bytes: int,
        stream,
        on_error: str = "raise",
    ):
        from bytewax_tpu_torch.ops.text import LineBatcher

        self._stream = stream
        self._chunk_bytes = chunk_bytes
        self._columnar = columnar
        self._done = False
        self._lines = LineBatcher(on_error=on_error)
        try:
            self._fd: Optional[int] = stream.fileno()
        except (AttributeError, OSError, ValueError):
            # Not a real fd (tests feed a BytesIO/StringIO): reads
            # can't block, so poll greedily.
            self._fd = None

    def _readable(self) -> bool:
        if self._fd is None:
            return True
        try:
            ready, _, _ = select.select([self._fd], [], [], 0)
        except (OSError, ValueError):
            return True
        return bool(ready)

    def _read_chunk(self) -> bytes:
        if self._fd is not None:
            return os.read(self._fd, self._chunk_bytes)
        raw = self._stream.read(self._chunk_bytes)
        if isinstance(raw, str):
            # Text-mode fallback streams (tests feed a StringIO).
            raw = raw.encode("utf-8")
        return raw or b""

    def next_batch(self) -> Union[ColumnarBatch, List[str]]:
        if self._done:
            raise StopIteration()
        if not self._readable():
            return []
        raw = self._read_chunk()
        if not raw:
            self._done = True
            out = self._lines.flush()
        else:
            out = self._lines.feed(raw)
        if out is None:
            if self._done:
                raise StopIteration()
            return []
        return out if self._columnar else out.cols["line"].tolist()

    def drain_dead_letters(self) -> List[dict]:
        dead, self._lines.dead = self._lines.dead, []
        return dead


class StdInSource(DynamicSource[Any]):
    """Read lines from stdin on worker 0.

    Itemized by default (one ``str`` line per item, trailing newline
    stripped; each poll emits every line a ``chunk_bytes`` read
    completed).  ``columnar=True`` emits the same lines as
    vectorized-split :class:`~bytewax_tpu_torch.inputs.ColumnarBatch` line
    batches instead (docs/performance.md "Columnar ingest") — no
    per-row Python on the hot path.  Reads are non-blocking
    (``select`` on a real fd); not recoverable — stdin has no
    resumable position.

    Connector-edge resilience (docs/recovery.md): transient read
    ``OSError``s (EINTR/EAGAIN from a pipe) are retried by the
    engine's poll-boundary ladder automatically;
    ``on_error="dlq"`` additionally dead-letters undecodable lines
    instead of killing the run.
    """

    def __init__(
        self,
        columnar: bool = False,
        chunk_bytes: int = 1 << 16,
        on_error: str = "raise",
    ):
        if on_error not in ("raise", "dlq"):
            msg = f"on_error must be 'raise' or 'dlq'; got {on_error!r}"
            raise ValueError(msg)
        self._columnar = columnar
        self._chunk_bytes = chunk_bytes
        self._on_error = on_error

    def build(
        self, step_id: str, worker_index: int, worker_count: int
    ) -> _StdInPartition:
        if worker_index != 0:
            return _EmptyPartition()
        stream = getattr(sys.stdin, "buffer", sys.stdin)
        return _StdInPartition(
            self._columnar,
            self._chunk_bytes,
            stream,
            on_error=self._on_error,
        )


class _EmptyPartition(StatelessSourcePartition[Any]):
    def next_batch(self) -> List[Any]:
        raise StopIteration()
