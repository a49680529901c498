"""What every feed and flow of the benchmark shares: the log of what
a source handed over, the port's source classes a feed builds on, and
a sink that stamps each write.

Every feed logs what it handed over (the ring entry of each batch),
so the reference can work out again exactly which rows the
port saw.
"""

import time
from typing import List, Optional

import numpy as np

from bytewax_tpu_torch.inputs import DynamicSource, StatelessSourcePartition
from bytewax_tpu_torch.outputs import DynamicSink, StatelessSinkPartition

__all__ = ["Handed", "Part", "Source", "TimedSink"]


class Handed:
    """What a source handed over: per batch the block (a global block
    or a file; the ring entry is its index modulo the ring), and the
    rows in all."""

    def __init__(self):
        #: When the stream started: the first poll.
        self.first: Optional[float] = None
        self.block: List[int] = []
        #: When each batch was handed over.
        self.times: List[float] = []
        self.rows = 0

    def start(self) -> float:
        if self.first is None:
            self.first = time.perf_counter()
        return self.first

    def add(self, block: int, rows: int) -> None:
        self.block.append(block)
        self.times.append(time.perf_counter())
        self.rows += rows


class Part(StatelessSourcePartition):
    """A source partition whose batches come from ``next_fn``."""

    def __init__(self, next_fn):
        self._next = next_fn

    def next_batch(self):
        return self._next()


class Source(DynamicSource):
    """Worker 0 reads the stream; other lanes read nothing."""

    def __init__(self, make_part):
        self._make = make_part

    def build(self, step_id, worker_index, worker_count):
        if worker_index == 0:
            return self._make()
        return Part(_stop)


def _stop():
    raise StopIteration()


class TimedSink(DynamicSink):
    """Keeps each write's wall time (``perf_counter``) and its items,
    packed at once by ``pack`` into a numeric array (one row an item),
    so the run holds no Python object per result: a heap of retained
    tuples would make the interpreter's full collections, and the
    pauses they cause, grow through the window."""

    def __init__(self, pack):
        self._pack = pack
        self.writes: List[tuple] = []

    def build(self, step_id, worker_index, worker_count):
        sink = self

        class _Write(StatelessSinkPartition):
            def write_batch(self, items):
                now = time.perf_counter()
                sink.writes.append((now, sink._pack(items)))

        return _Write()

    def rows(self) -> np.ndarray:
        """Every item's packed row, in arrival order."""
        if not self.writes:
            return self._pack([])
        return np.concatenate([rows for _t, rows in self.writes])

    @property
    def last(self) -> Optional[float]:
        return self.writes[-1][0] if self.writes else None
