"""The 1BRC (one-billion-row challenge) flow: per-station
min/mean/max over a measurements stream.

Reference workload: upstream bytewax ``examples/1brc.py``.  Two tiers
share one graph shape:

- :func:`brc_flow` — host tier, Python ``(station, temp)`` items
  (capability parity with the reference's per-item path);
- :func:`brc_flow_columnar` — XLA tier, dictionary-encoded columnar
  micro-batches folded on device.
"""

from typing import Any, Iterable, List, Optional

import numpy as np

import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch import xla
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.engine.arrays import ArrayBatch
from bytewax_tpu_torch.inputs import (
    DynamicSource,
    FixedPartitionedSource,
    StatefulSourcePartition,
    StatelessSourcePartition,
)
from bytewax_tpu_torch.outputs import Sink

__all__ = [
    "ArrayBatchSource",
    "BrcFileSource",
    "brc_flow",
    "brc_flow_columnar",
    "generate_batches",
]


class _QueuePartition(StatelessSourcePartition):
    def __init__(self, batches: Iterable[Any]):
        self._it = iter(batches)

    def next_batch(self):
        try:
            return next(self._it)
        except StopIteration:
            raise StopIteration() from None


class ArrayBatchSource(DynamicSource):
    """Emit an iterable of pre-built batches (columnar or lists).

    Worker 0 reads everything; use one source per worker lane for
    parallel feeds.
    """

    def __init__(self, batches: Iterable[Any]):
        self._batches = batches

    def build(self, step_id: str, worker_index: int, worker_count: int):
        if worker_index == 0:
            return _QueuePartition(self._batches)
        return _QueuePartition(())


def brc_flow(source, sink: Sink) -> Dataflow:
    """Host-tier 1BRC: items are ``(station, temp)`` tuples."""
    flow = Dataflow("brc")
    s = op.input("inp", flow, source)
    stats = xla.stats_final("stats", s)
    rounded = op.map_value(
        "round",
        stats,
        lambda s4: (round(s4[0], 1), round(s4[1], 1), round(s4[2], 1)),
    )
    op.output("out", rounded, sink)
    return flow


def brc_flow_columnar(source, sink: Sink) -> Dataflow:
    """XLA-tier 1BRC: micro-batches with dictionary-encoded stations."""
    return brc_flow(source, sink)


class _BrcFilePartition(StatefulSourcePartition):
    def __init__(
        self,
        path,
        start: int,
        end: int,
        chunk_bytes: int,
        parser,
        resume_state: Optional[int],
    ):
        self._f = open(path, "rb")
        self._pos = resume_state if resume_state is not None else start
        self._end = end
        self._chunk_bytes = chunk_bytes
        # One parser is shared by all partitions of the source so the
        # station vocabulary (and its ids) is consistent across them.
        self._parser = parser
        self._carry = b""

    def next_batch(self) -> ArrayBatch:
        if self._pos >= self._end and not self._carry:
            raise StopIteration()
        self._f.seek(self._pos)
        want = min(self._chunk_bytes, self._end - self._pos)
        raw = self._carry + self._f.read(want)
        self._pos += want
        if not raw:
            raise StopIteration()
        if self._pos >= self._end:
            cut = len(raw)
            if not raw.endswith(b"\n"):
                raw += b"\n"
                cut = len(raw)
        else:
            cut = self._parser.split_point(raw)
        chunk, self._carry = raw[:cut], raw[cut:]
        ids, temps = self._parser.parse(chunk)
        vocab = self._parser.vocab()
        return ArrayBatch(
            {"key_id": ids, "value": temps},
            key_vocab=vocab,
            value_scale=0.1,
        )

    def snapshot(self) -> int:
        # Resume from the start of the unconsumed carry bytes.
        return self._pos - len(self._carry)

    def close(self) -> None:
        self._f.close()


class BrcFileSource(FixedPartitionedSource):
    """Read a 1BRC measurements file with the native C++ parser into
    dictionary-encoded columnar micro-batches.

    The file is split into ``part_count`` byte ranges (each aligned to
    line boundaries at read time) — the unit of parallelism, like the
    reference's worker-split byte ranges (``examples/1brc.py``).
    """

    def __init__(
        self,
        path,
        part_count: int = 1,
        chunk_bytes: int = 16 << 20,
    ):
        import os as _os

        from bytewax_tpu_torch.native import BrcParser

        self._path = path
        self._size = _os.stat(path).st_size
        self._part_count = part_count
        self._chunk_bytes = chunk_bytes
        self._parser = BrcParser()

    def list_parts(self) -> List[str]:
        return [f"range-{i:04d}" for i in range(self._part_count)]

    def build_part(self, step_id, for_part, resume_state):
        idx = int(for_part.rsplit("-", 1)[1])
        per = self._size // self._part_count
        start = idx * per
        end = self._size if idx == self._part_count - 1 else (idx + 1) * per
        if idx > 0:
            # Skip the partial first line; the previous range reads
            # past its end to finish it.
            with open(self._path, "rb") as f:
                f.seek(start)
                start += len(f.readline())
        if idx < self._part_count - 1:
            with open(self._path, "rb") as f:
                f.seek(end)
                end += len(f.readline())
        return _BrcFilePartition(
            self._path, start, end, self._chunk_bytes, self._parser, resume_state
        )


def generate_batches(
    n_rows: int,
    batch_rows: int,
    n_stations: int = 413,
    seed: int = 0,
) -> List[ArrayBatch]:
    """Synthesize 1BRC-shaped columnar data."""
    rng = np.random.RandomState(seed)
    vocab = np.array([f"station_{i:04d}" for i in range(n_stations)])
    batches = []
    made = 0
    while made < n_rows:
        n = min(batch_rows, n_rows - made)
        # Real 1BRC temperatures have exactly one decimal: int16
        # deci-degrees are the lossless wire format (value_scale=0.1).
        deci = np.clip(
            np.round(rng.randn(n) * 100 + 120), -999, 999
        ).astype(np.int16)
        batches.append(
            ArrayBatch(
                {
                    "key_id": rng.randint(
                        0, n_stations, size=n, dtype=np.int16
                    ),
                    "value": deci,
                },
                key_vocab=vocab,
                value_scale=0.1,
            )
        )
        made += n
    return batches
