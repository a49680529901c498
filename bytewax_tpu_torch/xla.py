"""Public device-tier API: columnar batches, torch UDFs, recognized
reducers and scans.

The host tier runs any Python; this module is the opt-in fast path:

- :class:`ArrayBatch` — a columnar micro-batch that flows through the
  same dataflow graph as Python items but stays as arrays end-to-end;
- :func:`jit_batch` / :class:`TorchUDF` / :func:`map_batch` — wrap a
  cols→cols torch function so ``flat_map_batch`` applies it to the
  numeric columns on the device tier's device;
- :data:`SUM` / :data:`MIN` / :data:`MAX` — reducers that behave like
  plain Python callables on the host tier but that the engine
  recognizes and lowers to the device segment fold over a slot table
  (see ``bytewax_tpu_torch/ops/segment.py``);
- :data:`MEAN` / :data:`STATS` — structured window folds;
- :class:`ScanMap` (:func:`zscore`, :func:`ema`,
  :func:`running_extrema`, :func:`torch_stateful_map`) — ``stateful_map``
  mappers the engine lowers to a device segmented scan
  (``bytewax_tpu_torch/ops/scan.py``);
- :func:`stats_final` — min/mean/max in one pass (the 1BRC shape).
"""

from typing import Any, Callable, Dict, Optional

from bytewax_tpu_torch.dataflow import KeyedStream, Stream, operator
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
    "ScanMap",
    "TorchUDF",
    "WindowFold",
    "ema",
    "jit_batch",
    "map_batch",
    "running_extrema",
    "stats_final",
    "torch_stateful_map",
    "zscore",
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


class ScanMap:
    """A ``stateful_map`` mapper with a device lowering.

    Callable like a plain ``(state, value) -> (state, emit)`` mapper
    (the host tier uses it directly); :meth:`device_kind` returns the
    :class:`bytewax_tpu_torch.ops.scan.ScanKind` the engine lowers to
    when values are numeric, or ``None`` to stay on the host tier.
    State is a plain tuple in the kind's field order, interchangeable
    between tiers through recovery snapshots.

    Subclass this to register a new device scan in user code: give the
    host semantics in ``__call__`` and return a ``ScanKind`` (built-in
    or your own) from ``device_kind``; no engine change is needed.
    Any mapper runs on the host tier, and any monoid-expressible mapper
    also runs at device batch speed through this hook.
    """

    kind: str = "?"

    def device_kind(self):
        """The ``ScanKind`` to lower to, or None for host-only."""
        return None


class _ZScoreMap(ScanMap):
    """Per-key rolling z-score (the anomaly-detector shape): state is
    a Welford triple ``(count, mean, m2)``; each value emits
    ``(value, z, is_anomaly)`` scored against the state *before* the
    value folds in."""

    kind = "zscore"

    def __init__(self, threshold: float):
        self.threshold = float(threshold)

    def __call__(self, state, value):
        if state is None:
            count, mean, m2 = 0, 0.0, 0.0
        else:
            count, mean, m2 = state
        if count >= 2 and m2 > 0:
            std = (m2 / (count - 1)) ** 0.5
            z = (value - mean) / std if std > 0 else 0.0
        else:
            z = 0.0
        is_anomaly = abs(z) > self.threshold
        # Welford online update.
        count += 1
        delta = value - mean
        mean += delta / count
        m2 += delta * (value - mean)
        return (count, mean, m2), (value, z, is_anomaly)

    def device_kind(self):
        from bytewax_tpu_torch.ops.scan import WelfordZScore

        return WelfordZScore(self.threshold)

    def __repr__(self) -> str:
        return f"bytewax_tpu_torch.xla.zscore({self.threshold})"


def zscore(threshold: float = 3.0) -> ScanMap:
    """A ``stateful_map`` mapper computing each key's rolling z-score
    with per-key online mean/variance (Welford) state.

    Emits ``(value, z, abs(z) > threshold)`` per item.  The engine
    lowers it to one segmented scan per micro-batch on the device tier;
    the host tier runs it as a plain mapper with identical semantics.

    >>> from bytewax_tpu_torch import xla
    >>> mapper = xla.zscore(2.0)
    >>> state, out = mapper(None, 1.0)
    >>> state, out
    ((1, 1.0, 0.0), (1.0, 0.0, False))
    """
    return _ZScoreMap(threshold)


class _EmaMap(ScanMap):
    """Per-key debiased exponential moving average: state is
    ``(count, s)`` with ``s`` the biased accumulator; each value
    emits ``(value, ema)`` with the debiased mean *after* folding the
    value in (so a key's first value emits itself)."""

    kind = "ema"

    def __init__(self, alpha: float):
        if not 0.0 < alpha <= 1.0:
            msg = f"ema alpha must be in (0, 1], got {alpha}"
            raise ValueError(msg)
        self.alpha = float(alpha)

    def __call__(self, state, value):
        count, s = (0, 0.0) if state is None else state
        count += 1
        s = s * (1.0 - self.alpha) + self.alpha * value
        ema = s / (1.0 - (1.0 - self.alpha) ** count)
        return (count, s), (value, ema)

    def device_kind(self):
        from bytewax_tpu_torch.ops.scan import Ema

        return Ema(self.alpha)

    def __repr__(self) -> str:
        return f"bytewax_tpu_torch.xla.ema({self.alpha})"


def ema(alpha: float) -> ScanMap:
    """A ``stateful_map`` mapper computing each key's debiased
    exponential moving average (smoothing factor ``alpha``).

    Emits ``(value, ema)`` per item.  The engine lowers it to one
    segmented scan per micro-batch (the EMA recurrence is an
    associative affine composition); the host tier runs it as a plain
    mapper with identical semantics.
    """
    return _EmaMap(alpha)


class _RunningExtremaMap(ScanMap):
    """Per-key running min/max: state ``(mn, mx)``; each value emits
    ``(value, min_so_far, max_so_far)`` including the value itself."""

    kind = "extrema"

    def __call__(self, state, value):
        mn, mx = (float("inf"), float("-inf")) if state is None else state
        mn = value if value < mn else mn
        mx = value if value > mx else mx
        return (mn, mx), (value, mn, mx)

    def device_kind(self):
        from bytewax_tpu_torch.ops.scan import RunningExtrema

        return RunningExtrema()

    def __repr__(self) -> str:
        return "bytewax_tpu_torch.xla.running_extrema()"


def running_extrema() -> ScanMap:
    """A ``stateful_map`` mapper tracking each key's running min and
    max.  Emits ``(value, min_so_far, max_so_far)`` per item; lowers
    to the device segmented scan like :func:`zscore`."""
    return _RunningExtremaMap()


class _TorchStatefulMap(ScanMap):
    """Torch-UDF ``stateful_map`` mapper: any torch function over
    per-key scalar state runs batched across keys on the device tier
    (:class:`~bytewax_tpu_torch.ops.scan.TorchUdfScan`) and per item on
    the host tier: identical semantics, interchangeable snapshots."""

    kind = "torch_udf"

    def __init__(self, fn: Callable, init: tuple):
        self.fn = fn
        self.init = tuple(init)

    def __call__(self, state, value):
        import torch

        from bytewax_tpu_torch.ops.scan import field_dtype

        state = self.init if state is None else tuple(state)
        # The function sees what the device tier gives it: 0-d tensors
        # of the fields' dtypes and a float32 value.
        args = tuple(
            torch.tensor(s, dtype=field_dtype(i)) for s, i in zip(state, self.init)
        )
        new_state, outs = self.fn(args, torch.tensor(value, dtype=torch.float32))
        if len(new_state) != len(self.init):
            msg = (
                f"torch_stateful_map fn returned {len(new_state)} "
                f"state fields; init declared {len(self.init)}"
            )
            raise TypeError(msg)
        if not isinstance(outs, tuple):
            outs = (outs,)

        def scalar(x, like):
            # type(like) rebuilds the exact host scalar per field,
            # bool included: a bool init field always snapshots as a
            # Python bool, never a 0.0/1.0 float carrier.
            x = x.item() if hasattr(x, "item") else x
            return type(like)(x)

        host_state = tuple(scalar(ns, i) for ns, i in zip(new_state, self.init))
        host_outs = tuple(x.item() if hasattr(x, "item") else x for x in outs)
        return host_state, (value, *host_outs)

    def device_kind(self):
        from bytewax_tpu_torch.ops.scan import TorchUdfScan

        return TorchUdfScan(self.fn, self.init)

    def __repr__(self) -> str:
        return f"bytewax_tpu_torch.xla.torch_stateful_map({self.fn!r})"


def torch_stateful_map(fn: Callable, init: tuple) -> ScanMap:
    """A ``stateful_map`` mapper from any torch per-key function: the
    UDF tier that the monoid kinds (:func:`zscore`, :func:`ema`, ...)
    do not cover.

    ``fn(state_tuple, value) -> (state_tuple, outs)`` over 0-d tensors
    with torch ops; ``init`` is the per-key initial state tuple (Python
    floats/ints/bools fix each field's dtype: float32, int32, bool).
    Each item emits ``(value, *outs)``.  The device tier runs ``fn``
    under ``torch.func.vmap`` across the keys of a micro-batch, one step
    per row of the longest key run; the host tier runs it per item
    with identical semantics, and snapshots interchange between tiers.

    >>> import torch
    >>> from bytewax_tpu_torch import xla
    >>> def capped_total(state, v):
    ...     (total,) = state
    ...     total = torch.clamp(total + v, max=100.0)
    ...     return (total,), (total,)
    >>> mapper = xla.torch_stateful_map(capped_total, (0.0,))
    >>> mapper(None, 3.0)
    ((3.0,), (3.0, 3.0))
    """
    import torch

    from bytewax_tpu_torch.ops.scan import field_dtype

    mapper = _TorchStatefulMap(fn, init)
    # Fail at construction, not mid-stream: one vmap call over zeros
    # surfaces Python control flow on batched state, wrong state arity
    # and shape bugs where the user wrote them (such a function would
    # otherwise run on the host tier and fail only on the device tier).
    state = tuple(torch.zeros(2, dtype=field_dtype(v)) for v in mapper.init)
    try:
        state_out, _outs = torch.func.vmap(fn)(state, torch.zeros(2))
    except Exception as ex:  # noqa: BLE001 — surface as a clear TypeError
        msg = (
            "torch_stateful_map requires a (state_tuple, value) -> "
            "(state_tuple, outs) function of torch ops that vmap can "
            "batch (no Python control flow on state); tracing failed: "
            f"{ex}"
        )
        raise TypeError(msg) from ex
    if len(state_out) != len(mapper.init):
        msg = (
            f"torch_stateful_map fn returns {len(state_out)} state "
            f"fields; init declares {len(mapper.init)}"
        )
        raise TypeError(msg)
    return mapper


class TorchUDF:
    """Wrap a ``cols -> cols`` torch function for use as a
    ``flat_map_batch`` mapper over :class:`ArrayBatch` batches.

    The function receives the numeric columns as a dict of tensors on
    the device tier's device (:func:`bytewax_tpu_torch.utils.device`)
    and returns a dict of tensors, which come back as numpy columns.
    Non-numeric columns (e.g. string keys) bypass the function and are
    re-attached unchanged, so the row count must be preserved when they
    exist.  Python-item batches are rejected: pair this with a columnar
    source.

    >>> import numpy as np
    >>> from bytewax_tpu_torch import xla
    >>> udf = xla.jit_batch(lambda cols: {"y": cols["x"] * 2})
    >>> udf(xla.ArrayBatch({"x": np.arange(3.0)})).cols["y"]
    array([0., 2., 4.])
    """

    def __init__(self, fn: Callable[[Dict[str, Any]], Dict[str, Any]]):
        self._fn = fn

    def __call__(self, batch):
        import numpy as np
        import torch

        from bytewax_tpu_torch.utils import device

        if not isinstance(batch, ArrayBatch):
            msg = (
                "TorchUDF mappers require columnar ArrayBatch input; "
                f"got {type(batch)!r} — use a columnar source or a "
                "plain Python mapper"
            )
            raise TypeError(msg)
        dev = device()
        numeric = {}
        passthrough = {}
        for name, col in batch.cols.items():
            arr = np.asarray(col)
            if arr.dtype.kind in "USO":
                passthrough[name] = col
            else:
                numeric[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
        out = {}
        if numeric:
            for name, col in self._fn(numeric).items():
                out[name] = torch.as_tensor(col).cpu().numpy()
        for name, col in passthrough.items():
            if name not in out:
                out[name] = col
        result = ArrayBatch(out)
        if passthrough and len(result) != len(batch):
            msg = (
                "TorchUDF changed the row count while non-numeric "
                "columns were carried through; filter/expand must "
                "happen before string columns are attached"
            )
            raise ValueError(msg)
        return result


def jit_batch(fn: Callable[[Dict[str, Any]], Dict[str, Any]]) -> TorchUDF:
    """Decorator form of :class:`TorchUDF` (the name is the JAX
    package's; the port runs the function eagerly)."""
    return TorchUDF(fn)


@operator
def map_batch(
    step_id: str,
    up: Stream,
    fn: Callable[[Dict[str, Any]], Dict[str, Any]],
) -> Stream:
    """Apply a torch cols→cols function to each columnar micro-batch."""
    import bytewax_tpu_torch.operators as op

    return op.flat_map_batch("flat_map_batch", up, TorchUDF(fn))


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
