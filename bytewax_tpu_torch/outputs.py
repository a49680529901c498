"""Low-level output interfaces.

If you want pre-built connectors, see :mod:`bytewax_tpu_torch.connectors`.

API parity with the reference (upstream bytewax ``pysrc/bytewax/outputs.py``);
implementation is our own.
"""

import zlib
from abc import ABC, abstractmethod
from typing import Generic, List, Optional, Tuple, TypeVar

X = TypeVar("X")
S = TypeVar("S")

__all__ = [
    "DynamicSink",
    "FixedPartitionedSink",
    "Sink",
    "StatefulSinkPartition",
    "StatelessSinkPartition",
]


class Sink(ABC, Generic[X]):  # noqa: B024
    """Where the dataflow writes output data.

    Do not subclass this directly; subclass
    :class:`FixedPartitionedSink` or :class:`DynamicSink`.
    """


class StatefulSinkPartition(ABC, Generic[X, S]):
    """Output partition that maintains recoverable state."""

    @abstractmethod
    def write_batch(self, values: List[X]) -> None:
        """Write a batch of output values; called with all values
        routed to this partition in epoch order."""
        ...

    @abstractmethod
    def snapshot(self) -> S:
        """Snapshot the resume position; returned via ``build_part``'s
        ``resume_state`` on resume.  The sink must de-duplicate (or
        truncate) writes after this position for exactly-once output."""
        ...

    def close(self) -> None:
        """Cleanup this partition on EOF or shutdown."""
        return None


class FixedPartitionedSink(Sink[Tuple[str, X]], Generic[X, S]):
    """An output sink with a fixed number of independent partitions.

    Partitions are distributed across workers; state is snapshotted and
    routed back on resume and rescale.

    A two-partition sink routing ``(key, value)`` pairs by key:

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.outputs import (
    ...     FixedPartitionedSink, StatefulSinkPartition,
    ... )
    >>> from bytewax_tpu_torch.testing import TestingSource, run_main
    >>> written = {"p0": [], "p1": []}
    >>> class DictPart(StatefulSinkPartition):
    ...     def __init__(self, ls):
    ...         self._ls = ls
    ...     def write_batch(self, values):
    ...         self._ls.extend(values)
    ...     def snapshot(self):
    ...         return None
    >>> class DictSink(FixedPartitionedSink):
    ...     def list_parts(self):
    ...         return sorted(written)
    ...     def part_fn(self, item_key):
    ...         return int(item_key)
    ...     def build_part(self, step_id, for_part, resume_state):
    ...         return DictPart(written[for_part])
    >>> flow = Dataflow("fixed_sink_eg")
    >>> s = op.input("inp", flow, TestingSource([("0", "a"), ("1", "b")]))
    >>> op.output("out", s, DictSink())
    >>> run_main(flow)
    >>> written
    {'p0': ['a'], 'p1': ['b']}
    """

    @abstractmethod
    def list_parts(self) -> List[str]:
        """List all local partition ids; deterministic and unique
        across the cluster."""
        ...

    def part_fn(self, item_key: str) -> int:
        """Route incoming ``(key, value)`` pairs to partitions.

        The returned int is wrapped modulo the partition count.  The
        default is :func:`zlib.adler32` of the UTF-8 key — a hash that
        is consistent across processes/hosts, unlike builtin ``hash``
        (reference makes the same choice: ``outputs.py:100-127``).
        """
        return zlib.adler32(item_key.encode())

    @abstractmethod
    def build_part(
        self,
        step_id: str,
        for_part: str,
        resume_state: Optional[S],
    ) -> StatefulSinkPartition[X, S]:
        """Build anew or resume an output partition."""
        ...


class StatelessSinkPartition(ABC, Generic[X]):
    """Output partition that does not maintain recoverable state."""

    @abstractmethod
    def write_batch(self, items: List[X]) -> None:
        """Write a batch of output items."""
        ...

    def close(self) -> None:
        """Cleanup this partition on EOF or shutdown."""
        return None


class DynamicSink(Sink[X]):
    """An output sink where all workers write items concurrently.

    A sink that collects items into a shared list:

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.outputs import DynamicSink, StatelessSinkPartition
    >>> from bytewax_tpu_torch.testing import TestingSource, run_main
    >>> class ListPart(StatelessSinkPartition):
    ...     def __init__(self, ls):
    ...         self._ls = ls
    ...     def write_batch(self, items):
    ...         self._ls.extend(items)
    >>> class ListSink(DynamicSink):
    ...     def __init__(self, ls):
    ...         self._ls = ls
    ...     def build(self, step_id, worker_index, worker_count):
    ...         return ListPart(self._ls)
    >>> flow = Dataflow("dynamic_sink_eg")
    >>> s = op.input("inp", flow, TestingSource([1, 2]))
    >>> out = []
    >>> op.output("out", s, ListSink(out))
    >>> run_main(flow)
    >>> out
    [1, 2]
    """

    @abstractmethod
    def build(
        self, step_id: str, worker_index: int, worker_count: int
    ) -> StatelessSinkPartition[X]:
        """Build an output partition for a worker."""
        ...
