"""Public device-tier API: columnar batches and recognized reducers.

The host tier runs any Python; this module is the opt-in fast path:

- :class:`ArrayBatch` — a columnar micro-batch that flows through the
  same dataflow graph as Python items but stays as arrays end-to-end;
- :data:`SUM` / :data:`MIN` / :data:`MAX` — reducers that behave like
  plain Python callables on the host tier but that the engine
  recognizes and lowers to the device segment fold over a slot table
  (see ``bytewax_tpu_torch/ops/segment.py``);
- :data:`MEAN` / :data:`STATS` — structured window folds (markers; the
  port runs windows on the host tier so far);
- :func:`stats_final` — min/mean/max in one pass (the 1BRC shape).
"""

from typing import Any, Callable, Optional

from bytewax_tpu_torch.dataflow import KeyedStream, operator
from bytewax_tpu_torch.engine.arrays import ArrayBatch, TsValue, column_ts

__all__ = [
    "ArrayBatch",
    "TsValue",
    "column_ts",
    "MAX",
    "MEAN",
    "MIN",
    "Reducer",
    "STATS",
    "SUM",
    "WindowFold",
    "stats_final",
]


class Reducer:
    """A binary combiner with a device lowering.

    Callable like a plain function (host tier uses it directly);
    ``kind`` names the device scatter-combine the engine lowers to
    when values are numeric.
    """

    def __init__(self, kind: str, fn: Callable[[Any, Any], Any]):
        self.kind = kind
        self._fn = fn

    def __call__(self, a, b):
        return self._fn(a, b)

    def __repr__(self) -> str:
        return f"bytewax_tpu_torch.xla.{self.kind.upper()}"


SUM = Reducer("sum", lambda a, b: a + b)
MIN = Reducer("min", lambda a, b: min(a, b))
MAX = Reducer("max", lambda a, b: max(a, b))


class WindowFold:
    """A windowed fold with a device lowering.

    Unlike a :class:`Reducer` (a binary combine over values), a
    ``WindowFold`` folds values into a structured accumulator —
    ``mean`` keeps ``(sum, count)``, ``stats`` keeps ``(min, max,
    sum, count)`` — which is exactly a row of the device tier's slot
    table, so ``fold_window(step, up, clock, windower,
    MEAN.make_acc, MEAN, MEAN.merge)`` lowers to one scatter-combine
    per micro-batch.  On the host tier it is a plain callable folder.

    The window emits the raw accumulator at close (both tiers);
    apply :meth:`finalize` downstream for the human-facing value, or
    use the :func:`bytewax_tpu_torch.operators.windowing.mean_window` /
    ``stats_window`` wrappers which do it for you.
    """

    def __init__(self, kind: str, make_acc, fold, merge, finalize):
        self.kind = kind
        self.make_acc = make_acc
        self._fold = fold
        self.merge = merge
        self.finalize = finalize

    def __call__(self, acc, v):
        return self._fold(acc, v)

    def __repr__(self) -> str:
        return f"bytewax_tpu_torch.xla.{self.kind.upper()}"


MEAN = WindowFold(
    "mean",
    lambda: (0.0, 0),
    lambda a, v: (a[0] + v, a[1] + 1),
    lambda a, b: (a[0] + b[0], a[1] + b[1]),
    lambda a: a[0] / a[1] if a[1] else 0.0,
)

STATS = WindowFold(
    "stats",
    lambda: (float("inf"), float("-inf"), 0.0, 0),
    lambda a, v: (min(a[0], v), max(a[1], v), a[2] + v, a[3] + 1),
    lambda a, b: (
        min(a[0], b[0]),
        max(a[1], b[1]),
        a[2] + b[2],
        a[3] + b[3],
    ),
    lambda a: (a[0], a[2] / a[3] if a[3] else 0.0, a[1], a[3]),
)


class _StatsState:
    __slots__ = ("mn", "mx", "total", "count")

    def __init__(self, mn, mx, total, count):
        self.mn, self.mx, self.total, self.count = mn, mx, total, count


@operator
def stats_final(
    step_id: str,
    up: KeyedStream,
    ordered_emit: bool = True,
) -> KeyedStream:
    """Min/mean/max/count per key over the whole stream, emitted at
    EOF as ``(key, (min, mean, max, count))``.

    This is the 1BRC aggregation shape; the engine lowers it to a
    single fused scatter-combine per micro-batch over key-sharded
    device state.
    """
    import bytewax_tpu_torch.operators as op
    from bytewax_tpu_torch.operators import StatefulBatchLogic

    class _StatsBatchLogic(StatefulBatchLogic):
        def __init__(self, state: Optional[tuple]):
            if state is None:
                self.s = _StatsState(float("inf"), float("-inf"), 0.0, 0)
            else:
                mn, mx, total, count = state
                self.s = _StatsState(mn, mx, total, count)

        def on_batch(self, values):
            # Fold the whole key-batch with C-speed builtins; the
            # up-front float() comprehension keeps the per-item
            # coercion semantics (numeric strings fold, junk raises).
            fv = [float(v) for v in values]
            s = self.s
            mn = min(fv)
            mx = max(fv)
            if mn == mn and mx == mx:
                if mn < s.mn:
                    s.mn = mn
                if mx > s.mx:
                    s.mx = mx
            else:
                # A NaN poisoned the builtins (min/max return NaN
                # when it leads).  Per-item comparisons reproduce the
                # per-item fold exactly: NaN never wins a comparison,
                # real values still update the extrema.
                for v in fv:
                    if v < s.mn:
                        s.mn = v
                    if v > s.mx:
                        s.mx = v
            s.total += sum(fv)
            s.count += len(fv)
            return ((), StatefulBatchLogic.RETAIN)

        def on_eof(self):
            s = self.s
            mean = s.total / s.count if s.count else 0.0
            return (
                ((s.mn, mean, s.mx, s.count),),
                StatefulBatchLogic.DISCARD,
            )

        def snapshot(self):
            s = self.s
            return (s.mn, s.mx, s.total, s.count)

    def shim_builder(resume_state):
        return _StatsBatchLogic(resume_state)

    # Nest the core step under a "stateful" scope so the flattened
    # step id (...<step>.stateful.stateful_batch) is unchanged from
    # the per-item implementation this replaced — snapshots in
    # existing recovery stores keep resolving.
    from bytewax_tpu_torch.dataflow import operator as _operator

    @_operator
    def stateful(step_id: str, up: KeyedStream) -> KeyedStream:
        return op.stateful_batch("stateful_batch", up, shim_builder)

    return stateful("stateful", up)
