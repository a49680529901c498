"""Connectors for writing local-first demo dataflows.

Reference parity: upstream bytewax ``pysrc/bytewax/connectors/demo.py``
(plus a batch-native columnar mode; the reference emits per item).
"""

import random
from datetime import datetime, timedelta, timezone
from typing import Any, List, Optional, Tuple

import numpy as np

from bytewax_tpu_torch.inputs import (
    ColumnarBatch,
    FixedPartitionedSource,
    StatefulSourcePartition,
)

__all__ = ["RandomMetricSource"]


class _RandomMetricPartition(
    StatefulSourcePartition[Tuple[str, float], Tuple[int, float, Any]]
):
    def __init__(
        self,
        metric_name: str,
        interval: timedelta,
        count: int,
        next_random: "random.Random",
        resume_state: Optional[Tuple[int, float, Any]],
    ):
        self._metric_name = metric_name
        self._interval = interval
        self._count = count
        self._rand = next_random
        if resume_state:
            emitted, value, rng_state = resume_state
            if isinstance(rng_state, dict):
                # The mirror of _BatchMetricPartition's guard: a dict
                # rng slot is a numpy bit-generator state.
                msg = (
                    "resume state was written by the batch-native "
                    "RandomMetricSource (batch_size>1) whose numpy "
                    "generator sequence differs — start a new "
                    "recovery store"
                )
                raise ValueError(msg)
            # Continue the RNG sequence from the snapshot; rebuilding
            # from the seed would replay already-applied deltas.
            self._rand.setstate(rng_state)
        else:
            emitted, value = 0, 0.0
        self._emitted = emitted
        self._value = value
        self._next_awake = datetime.now(timezone.utc)

    def next_batch(self) -> List[Tuple[str, float]]:
        if self._emitted >= self._count:
            raise StopIteration()
        self._value += self._rand.uniform(-1.0, 1.0)
        self._emitted += 1
        self._next_awake += self._interval
        return [(self._metric_name, self._value)]

    def next_awake(self) -> Optional[datetime]:
        return self._next_awake

    def snapshot(self) -> Tuple[int, float, Any]:
        return (self._emitted, self._value, self._rand.getstate())


class _BatchMetricPartition(
    StatefulSourcePartition[ColumnarBatch, Tuple[int, float, Any]]
):
    """Batch-native random walk: one vectorized ``cumsum`` per poll
    emits a ``ColumnarBatch({"key", "ts", "value"})`` of up to
    ``batch_size`` steps (the ``ts`` column carries each step's
    scheduled emission time, so source-lag accounting and event-time
    windows see the same timeline the itemized source produces).
    Snapshot layout matches the itemized partition — ``(emitted,
    value, rng_state)`` — with the numpy bit-generator state dict in
    the rng slot; the two modes are distinguished (and kept
    non-interchangeable) by that state type."""

    def __init__(
        self,
        metric_name: str,
        interval: timedelta,
        count: int,
        batch_size: int,
        seed: Optional[int],
        resume_state: Optional[Tuple[int, float, Any]],
    ):
        self._metric_name = metric_name
        self._interval = interval
        self._count = count
        self._batch_size = batch_size
        self._rng = np.random.default_rng(seed)
        if resume_state:
            emitted, value, rng_state = resume_state
            if not isinstance(rng_state, dict):
                msg = (
                    "resume state was written by the itemized "
                    "RandomMetricSource; batch_size>1 uses a numpy "
                    "generator whose sequence differs — start a new "
                    "recovery store"
                )
                raise ValueError(msg)
            self._rng.bit_generator.state = rng_state
        else:
            emitted, value = 0, 0.0
        self._emitted = emitted
        self._value = value
        self._next_awake = datetime.now(timezone.utc)

    def next_batch(self) -> ColumnarBatch:
        if self._emitted >= self._count:
            raise StopIteration()
        n = min(self._batch_size, self._count - self._emitted)
        deltas = self._rng.uniform(-1.0, 1.0, size=n)
        values = self._value + np.cumsum(deltas)
        step_us = max(
            int(self._interval.total_seconds() * 1e6), 0
        )
        base = np.datetime64(
            self._next_awake.replace(tzinfo=None), "us"
        )
        ts = base + np.arange(n) * np.timedelta64(1, "us") * step_us
        self._value = float(values[-1])
        self._emitted += n
        self._next_awake += self._interval * n
        return ColumnarBatch(
            {
                "key": np.full(n, self._metric_name),
                "ts": ts,
                "value": values,
            }
        )

    def next_awake(self) -> Optional[datetime]:
        return self._next_awake

    def snapshot(self) -> Tuple[int, float, Any]:
        return (
            self._emitted,
            self._value,
            self._rng.bit_generator.state,
        )


class RandomMetricSource(FixedPartitionedSource):
    """Demo source of randomly-walking ``(metric_name, value)`` pairs
    at a fixed interval.

    With ``batch_size > 1`` the partition is batch-native: each poll
    emits one :class:`~bytewax_tpu_torch.inputs.ColumnarBatch` of up to
    ``batch_size`` walk steps with ``key``/``ts``/``value`` columns
    (vectorized generation, no per-row Python; the ``ts`` column
    carries each step's scheduled emission time).  The two modes use
    different RNGs, so their walks — and their recovery snapshots —
    are not interchangeable.

    >>> from datetime import timedelta
    >>> from bytewax_tpu_torch.connectors.demo import RandomMetricSource
    >>> from bytewax_tpu_torch.testing import poll_next_batch
    >>> src = RandomMetricSource(
    ...     "cpu", interval=timedelta(0), count=3, seed=42
    ... )
    >>> src.list_parts()
    ['cpu']
    >>> part = src.build_part("demo", "cpu", None)
    >>> [(k, type(v).__name__) for k, v in poll_next_batch(part)]
    [('cpu', 'float')]
    >>> batched = RandomMetricSource(
    ...     "cpu", interval=timedelta(0), count=3, seed=42, batch_size=8
    ... )
    >>> part = batched.build_part("demo", "cpu", None)
    >>> sorted(poll_next_batch(part).cols)
    ['key', 'ts', 'value']
    """

    def __init__(
        self,
        metric_name: str,
        interval: timedelta = timedelta(seconds=0.7),
        count: int = 100,
        seed: Optional[int] = None,
        batch_size: int = 1,
    ):
        self._metric_name = metric_name
        self._interval = interval
        self._count = count
        self._seed = seed
        self._batch_size = batch_size

    def list_parts(self) -> List[str]:
        return [self._metric_name]

    def build_part(
        self,
        step_id: str,
        for_part: str,
        resume_state: Optional[Tuple[int, float, Any]],
    ) -> StatefulSourcePartition:
        if self._batch_size > 1:
            return _BatchMetricPartition(
                self._metric_name,
                self._interval,
                self._count,
                self._batch_size,
                self._seed,
                resume_state,
            )
        return _RandomMetricPartition(
            self._metric_name,
            self._interval,
            self._count,
            random.Random(self._seed),
            resume_state,
        )
