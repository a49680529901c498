"""Micro-batch shaping for the ingest fast path.

Adaptive micro-batch coalescing lives here (docs/performance.md
"Columnar ingest").  The JAX package also pads every device dispatch
to a power-of-two bucket ladder here, to bound its compiled shapes;
the port runs eagerly and its kernels take any row count, so it has
no ladder.

- **Adaptive micro-batch coalescing** (:func:`coalesce_target`,
  :func:`can_merge`, :func:`merge_batches`): sources that trickle
  rows (Kafka polls, line files, row-at-a-time feeds) are re-batched
  at ingest — the driver keeps polling a ready partition until the
  accumulated batch reaches the target row count, merging
  consecutive compatible batches into one delivery.  Batch size
  adapts to availability by construction: a saturated source fills
  the target; a slow source ships whatever one poll returned.  The
  engine arms this automatically for inputs whose plan feeds a
  device-tier step (the flatten pass's ``_accel_bound`` annotation);
  ``BYTEWAX_TPU_INGEST_TARGET_ROWS`` forces it on for every input
  (``0`` disables it everywhere).

Everything here is process-local: no comm frames, no sync rounds
(pinned by ``tests/test_comm_invariants.py``).
"""

import os
from typing import Any, List, Sequence

import numpy as np

from bytewax_tpu_torch.engine.arrays import ArrayBatch

__all__ = [
    "can_merge",
    "coalesce_target",
    "merge_batches",
]

#: Default coalescing target for device-bound inputs (rows).  Chosen
#: to amortize per-dispatch overhead (host→device copy, kernel
#: launch) without holding rows long enough to matter for latency —
#: coalescing never crosses a poll boundary, so an idle source still
#: ships immediately.
_DEFAULT_TARGET_ROWS = 65536

#: How many extra ``next_batch`` calls one poll may make while
#: coalescing — a backstop so a source yielding single rows can't pin
#: the run loop (65536 single-row calls) inside one poll.
COALESCE_MAX_POLLS = 256


def coalesce_target(accel_bound: bool) -> int:
    """Coalescing target rows for one input step; 0 = coalescing off.

    ``BYTEWAX_TPU_INGEST_TARGET_ROWS`` wins when set (``0`` disables
    everywhere); otherwise device-bound inputs (the flatten pass saw a
    device-tier consumer downstream) default on, host-only inputs
    default off — re-batching buys nothing when no host→device copy or
    kernel launch is being amortized.
    """
    env = os.environ.get("BYTEWAX_TPU_INGEST_TARGET_ROWS")
    if env is not None and env != "":
        return max(0, int(env))
    if os.environ.get("BYTEWAX_TPU_STATE_BUDGET"):
        # Budgeted residency (docs/state-residency.md) sizes each
        # delivery's key set against the device budget at prepare();
        # coalescing multiplies per-delivery key cardinality, so
        # budgeted runs keep source batch granularity unless the
        # operator forces a target explicitly.
        return 0
    return _DEFAULT_TARGET_ROWS if accel_bound else 0


def _vocab_compatible(a: ArrayBatch, b: ArrayBatch) -> bool:
    if a.key_vocab is None and b.key_vocab is None:
        return True
    if a.key_vocab is None or b.key_vocab is None:
        return False
    # Identity only: the append-only vocab contract means a LATER
    # batch's vocab may extend an earlier one, but verifying extension
    # costs a prefix scan per merge — sources that haven't grown their
    # vocab hand the same object to consecutive batches, so identity
    # covers the steady state, and a growth step simply starts a new
    # merge group.
    return a.key_vocab is b.key_vocab


def can_merge(a: Any, b: Any) -> bool:
    """Whether two consecutive source batches may merge into one
    delivery without changing what any consumer observes."""
    if isinstance(a, list) and isinstance(b, list):
        return True
    if isinstance(a, ArrayBatch) and isinstance(b, ArrayBatch):
        return (
            set(a.cols) == set(b.cols)
            and a.value_scale == b.value_scale
            and _vocab_compatible(a, b)
        )
    return False


def merge_batches(batches: Sequence[Any]) -> Any:
    """Merge compatible consecutive batches (see :func:`can_merge`)
    into one: lists concatenate; columnar batches concatenate per
    column (order preserved), keeping the LAST batch's vocab — under
    the append-only contract it covers every earlier id."""
    if len(batches) == 1:
        return batches[0]
    first = batches[0]
    if isinstance(first, list):
        out: List[Any] = []
        for b in batches:
            out.extend(b)
        return out
    cols = {
        name: np.concatenate(
            [np.asarray(b.cols[name]) for b in batches]
        )
        for name in first.cols
    }
    return ArrayBatch(
        cols,
        key_vocab=batches[-1].key_vocab,
        value_scale=first.value_scale,
    )
