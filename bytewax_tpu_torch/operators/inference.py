"""Streaming ML inference operator (``op.infer``).

``infer`` scores each upstream ``(key, features)`` row through a
user-supplied torch ``apply_fn(params, x)`` over a broadcast params
pytree — the production "feature pipeline → score → route-on-score"
serving shape.  The step lowers to the device tier: batched forward
passes on the device, on the shared dispatch pipeline, with the params
snapshot-covered, demotable to a host numpy apply, and hot-swappable
at an agreed epoch close via ``driver.update_params()`` /
``POST /model``.
"""

from typing import Any, Callable, Iterable, List, Optional, Tuple

from bytewax_tpu_torch.dataflow import KeyedStream, operator

from bytewax_tpu_torch.operators import (
    StatefulBatchLogic,
    stateful_batch,
)

__all__ = ["infer"]


class _HostScoreLogic(StatefulBatchLogic):
    """Per-key host fallback used only if an infer core step ever
    runs through the generic stateful_batch runtime (it normally gets
    the dedicated infer runtime, both tiers included); scores each
    row through the host apply so semantics never depend on which
    runtime picked the step up."""

    def __init__(self, spec: Any, resume_state: Optional[Any]):
        from bytewax_tpu_torch.engine.infer import HostInferState

        self._state = HostInferState(spec, resume_state)

    def on_batch(self, values: List[Any]) -> Tuple[Iterable[Any], bool]:
        from bytewax_tpu_torch.engine.infer import extract_features

        _keys, feats = extract_features([("", v) for v in values])
        cols = self._state.score_rows(feats)
        if len(cols) == 1:
            emits = list(cols[0].tolist())
        else:
            emits = list(zip(*(c.tolist() for c in cols)))
        return (emits, StatefulBatchLogic.RETAIN)

    def snapshot(self) -> Any:
        return None


@operator
def infer(
    step_id: str,
    up: KeyedStream,
    apply_fn: Callable[[Any, Any], Any],
    params: Any,
    host_apply: Optional[Callable[[Any, Any], Any]] = None,
) -> KeyedStream:
    """Score each upstream row through a torch model forward pass.

    Upstream items are ``(key, features)`` 2-tuples where ``features``
    is a numeric scalar or fixed-width tuple/list (columnar
    ``ArrayBatch`` deliveries feed their ``value`` column); the engine
    batches rows into a float32 ``[N, F]`` matrix and calls
    ``apply_fn(params, x)`` with ``x`` and the params as tensors on the
    device tier's device.  The output is ``(key, out)`` per row, in row
    order: a 1-column apply emits bare scalars, a multi-column apply (a
    ``[N, K]`` tensor or tuple of ``[N]`` tensors) emits tuples.

    ``params`` is broadcast state: identical on every worker,
    snapshot-covered for recovery, and hot-swappable mid-run at an
    agreed epoch close (``driver.update_params()`` / ``POST /model``).
    ``host_apply`` optionally supplies a pure-numpy twin used after
    device demotion (and makes the host tier independent of the
    accelerator entirely).

    >>> import numpy as np
    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main
    >>> flow = Dataflow("infer_eg")
    >>> s = op.input("inp", flow, TestingSource([("a", 2.0), ("b", 3.0)]))
    >>> s = op.infer(
    ...     "score", s, lambda p, x: x[:, 0] * p["w"], {"w": np.float32(10.0)}
    ... )
    >>> out = []
    >>> op.output("out", s, TestingSink(out))
    >>> run_main(flow)
    >>> out
    [('a', 20.0), ('b', 30.0)]

    :arg step_id: Unique ID.
    :arg up: Keyed stream of ``(key, features)`` rows.
    :arg apply_fn: ``apply_fn(params, x)`` over a ``[N, F]`` float32
        batch of tensors, with torch ops.
    :arg params: Initial params pytree (dict/list/tuple of arrays).
    :arg host_apply: Optional numpy twin of ``apply_fn`` for the host
        tier.
    :returns: Keyed stream of ``(key, score)`` rows.
    """
    if not callable(apply_fn):
        msg = f"apply_fn of infer {step_id!r} must be callable"
        raise TypeError(msg)
    if host_apply is not None and not callable(host_apply):
        msg = f"host_apply of infer {step_id!r} must be callable"
        raise TypeError(msg)
    # Validate the pytree eagerly so a bad params object fails at
    # build time, not at first dispatch.
    from bytewax_tpu_torch.engine.infer import InferAccelSpec

    spec = InferAccelSpec(apply_fn, params, host_apply)

    def shim_builder(resume_state: Optional[Any]) -> _HostScoreLogic:
        return _HostScoreLogic(spec, resume_state)

    shim_builder.__wrapped__ = apply_fn
    return stateful_batch("stateful_batch", up, shim_builder)
