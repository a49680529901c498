"""Segmented per-key running scans with per-row emission.

The reference's ``stateful_map`` calls the user mapper once per item.
For numeric state the same computation is one device pass per
micro-batch: the host groups rows by key into contiguous segments and
a segmented scan over the state monoid yields every row's running
state.

The device contract is :class:`ScanKind`, a monoid (``lift`` /
``merge`` / ``emit`` over per-field slot-table columns, as torch
tensors).  Every kind has a plain PyTorch version (:meth:`ScanKind.plain`):
the generic segmented doubling scan over ``merge``
(:func:`generic_scan_body`), or a specialized body where one exists, as
the z-score kind's pivot-shifted prefix-sum program
(:func:`zscore_scan_body`).  On a CUDA table the built-in kinds run the
hand-written Hopper kernel ``csrc/segment_scan.cu`` (instance named by
:attr:`ScanKind.kernel`, bound in :mod:`bytewax_tpu_torch.ops.scan_kernel`);
a kind registered in user code runs its plain version there, its one
device path.  The tests and the CPU use the plain versions, and the
card holds the kernel against them.

Registering a new kind needs no engine change: the driver, snapshots
and emission are generic over the kind's declared fields and outputs.
State tables are updated in place; ``run`` returns the per-row output
columns and the same field dict.
"""

import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "WELFORD_FIELDS",
    "Ema",
    "RunningExtrema",
    "ScanKind",
    "TorchUdfScan",
    "WelfordZScore",
    "field_dtype",
    "generic_scan_body",
    "welford_merge",
    "zscore_scan_body",
]

#: name -> (init, dtype) of the per-key Welford state row.
WELFORD_FIELDS = {
    "count": (0, torch.int32),
    "mean": (0.0, torch.float32),
    "m2": (0.0, torch.float32),
}

Fields = Dict[str, torch.Tensor]
Cols = Tuple[torch.Tensor, ...]


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA table, False for a CPU one; any other device
    raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    msg = f"the segmented scan runs on cuda or cpu tensors, not {t.device}"
    raise ValueError(msg)


def _seg_start(slots: torch.Tensor) -> torch.Tensor:
    """True at every segment head (row 0 and each change of slot)."""
    start = torch.ones(slots.shape[0], dtype=torch.bool, device=slots.device)
    start[1:] = slots[1:] != slots[:-1]
    return start


def _seg_end(slots: torch.Tensor) -> torch.Tensor:
    """True at every segment tail (each change of slot and the last
    row)."""
    end = torch.ones(slots.shape[0], dtype=torch.bool, device=slots.device)
    end[:-1] = slots[1:] != slots[:-1]
    return end


class ScanKind:
    """Device contract for a ``stateful_map`` lowering.

    A kind is a monoid over per-key state rows plus a per-row
    emission:

    - :attr:`fields`: ordered ``{name: (identity, torch dtype)}`` of
      the slot-table columns.  The field order is the host snapshot
      tuple order: the host-tier mapper's state tuple and the device
      tier's per-slot row are the same tuple, so recovery snapshots
      interchange between tiers (and with the JAX package).
    - :meth:`lift`: one row's state contribution (elementwise).
    - :meth:`merge`: associative combine of two state tuples;
      ``merge(s, identity) == s``.
    - :meth:`emit`: per-row outputs from each row's pre-update state,
      post-update state and value.
    - :meth:`post`: optional host finisher over the numpy outputs
      (e.g. a float64 threshold compare).

    Subclasses carry their parameters (threshold, alpha, ...) as
    instance attributes.  See :class:`Ema` for a minimal example: a
    kind defined in a user module lowers exactly like the built-ins.
    """

    #: kind name (diagnostics / reprs).
    name: str = "?"
    #: ordered {field: (identity, dtype)}; also the snapshot order.
    fields: Dict[str, Tuple[Any, torch.dtype]] = {}
    #: The ``csrc/segment_scan.cu`` instance that runs this kind on the
    #: card; None runs the plain version there.
    kernel: Optional[str] = None

    def lift(self, values: torch.Tensor) -> Cols:
        raise NotImplementedError

    def merge(self, a: Cols, b: Cols) -> Cols:
        raise NotImplementedError

    def emit(self, pre: Cols, post: Cols, values: torch.Tensor) -> Cols:
        raise NotImplementedError

    def post(self, outs: Tuple[np.ndarray, ...]) -> Tuple[np.ndarray, ...]:
        """Host-side finisher over the outputs (identity by default)."""
        return outs

    def kernel_params(self) -> Tuple[float, float]:
        """``(alpha, log_q)`` for the kernel (only EMA uses them)."""
        return 0.0, 0.0

    def plain(self, fields: Fields, slots: torch.Tensor, values: torch.Tensor):
        """The plain PyTorch version of one micro-batch: the generic
        segmented doubling scan.  Works on any device."""
        return generic_scan_body(self)(fields, slots, values)

    def run(self, fields: Fields, slots: torch.Tensor, values: torch.Tensor):
        """One micro-batch of grouped rows: the kernel on a CUDA table
        for a kind that has one, else the plain version.  Updates
        ``fields`` in place; returns ``(outs, fields)``."""
        first = fields[next(iter(self.fields))]
        if self.kernel is not None and _on_card(first):
            from bytewax_tpu_torch.ops import scan_kernel

            return scan_kernel.scan(self, fields, slots, values), fields
        return self.plain(fields, slots, values)

    # -- snapshot plumbing (generic over the field table) -----------------

    def snapshot_of(self, row: Tuple) -> Tuple:
        """Host-format state tuple from one slot row (exact Python
        bools / ints / floats, in field order).  The bool branch comes
        first, so a bool field snapshots as a bool and a host-tier
        resume sees ``True`` where its mapper kept ``True``."""
        out = []
        for (_name, (_init, dtype)), v in zip(self.fields.items(), row):
            if dtype == torch.bool:
                out.append(bool(v))
            elif not dtype.is_floating_point:
                out.append(int(v))
            else:
                out.append(float(v))
        return tuple(out)

    def __repr__(self) -> str:
        return f"ScanKind({self.name!r})"


def _segmented_inclusive(merge: Callable, flags: torch.Tensor, cols: Cols) -> Cols:
    """Hillis–Steele inclusive scan of the state columns ``cols`` under
    the segmented operator ``(fa, sa) . (fb, sb) = (fa | fb, fb ? sb :
    merge(sa, sb))``: ``ceil(log2 n)`` rounds of tensor ops."""
    n = flags.shape[0]
    flag = flags
    st = cols
    d = 1
    while d < n:
        fb = flag[d:]
        left = tuple(x[:-d] for x in st)
        right = tuple(x[d:] for x in st)
        merged = merge(left, right)
        st = tuple(
            torch.cat([x[:d], torch.where(fb, r, m.to(x.dtype))])
            for x, r, m in zip(st, right, merged)
        )
        flag = torch.cat([flag[:d], flag[:-d] | fb])
        d *= 2
    return st


def _sums(a: Cols, b: Cols) -> Cols:
    return tuple(x + y for x, y in zip(a, b))


def generic_scan_body(kind: ScanKind) -> Callable:
    """The plain generic program for a kind: a flagged segmented
    doubling scan over the kind's state monoid (the counterpart of the
    JAX package's ``jax.lax.associative_scan`` body).

    ``slots`` must be grouped (all rows of a key contiguous).  Returns
    the kind's per-row outputs and the slot tables; each segment's tail
    writes ``table carry ⊕ inclusive in-batch state`` back, every other
    row writes the scratch slot ``capacity - 1``.
    """
    names = tuple(kind.fields)
    inits = tuple(init for init, _ in kind.fields.values())

    def run(fields: Fields, slots: torch.Tensor, values: torch.Tensor):
        capacity = fields[names[0]].shape[0]
        idx = slots.long()
        seg_start = _seg_start(slots)
        incl = _segmented_inclusive(kind.merge, seg_start, kind.lift(values))

        def shifted(x, ident):
            prev = torch.cat([torch.full((1,), ident, dtype=x.dtype, device=x.device), x[:-1]])
            return torch.where(seg_start, torch.full_like(x, ident), prev)

        excl = tuple(shifted(x, i) for x, i in zip(incl, inits))
        carry = tuple(fields[nm][idx] for nm in names)
        pre = kind.merge(carry, excl)
        post = kind.merge(carry, incl)
        outs = kind.emit(pre, post, values)
        dest = torch.where(_seg_end(slots), idx, capacity - 1)
        for nm, p in zip(names, post):
            fields[nm][dest] = p.to(fields[nm].dtype)
        return outs, fields

    return run


def welford_merge(a: Cols, b: Cols) -> Cols:
    """Chan's parallel Welford merge: combine two ``(count, mean,
    m2)`` summaries of disjoint samples.  Associative, identity
    ``(0, 0, 0)``."""
    na, ma, m2a = a
    nb, mb, m2b = b
    n = na + nb
    f = ma.dtype
    nf = n.to(f)
    naf = na.to(f)
    nbf = nb.to(f)
    safe = torch.where(n > 0, nf, torch.ones_like(nf))
    delta = mb - ma
    mean = ma + delta * nbf / safe
    m2 = m2a + m2b + delta * delta * naf * nbf / safe
    return n, mean, m2


def zscore_scan_body(
    state: Fields, slots: torch.Tensor, values: torch.Tensor
) -> Tuple[Cols, Fields]:
    """One micro-batch of the per-key rolling z-score: the plain
    version of the :class:`WelfordZScore` kind.

    ``slots`` must be grouped.  Returns per-row ``z``, computed against
    each row's pre-update state as the host mapper does, and the slot
    tables updated in place.  The threshold compare happens on the host.

    The running Welford state comes from segmented prefix sums of
    pivot-shifted values (the segment head's value is the pivot, so the
    ``sumsq - sum²/n`` form stays well-conditioned), merged with each
    key's table state by Chan's combine.  The prefix sums restart at
    each head (a doubling scan), where the JAX package's subtract
    batch-wide cumsums.  Counts are int32 end to end
    (a float32 count freezes at 2^24), cast to float only for the
    divisions.  The tables' float dtype sets the arithmetic's.
    """
    count_t, mean_t, m2_t = state["count"], state["mean"], state["m2"]
    capacity = count_t.shape[0]
    n = slots.shape[0]
    f = mean_t.dtype
    vals = values.to(f)
    idx_s = slots.long()

    seg_start = _seg_start(slots)
    idx = torch.arange(n, device=slots.device)
    # Broadcast each segment head's index to its rows: arange is
    # monotone, so a running max of head indices does it.
    head_idx = torch.cummax(torch.where(seg_start, idx, 0), 0).values
    pivot = vals[head_idx]
    d = vals - pivot

    def shifted(col):
        """The exclusive prefix from the inclusive one: the row
        before's, 0 at heads."""
        excl = torch.cat([torch.zeros_like(col[:1]), col[:-1]])
        return torch.where(seg_start, torch.zeros_like(col), excl)

    # Exclusive in-segment prefix sums of (1, d, d²): prior rows of
    # this key in the batch, the count in exact int32.  They restart
    # at each head.  (The JAX package takes batch-wide cumsums minus
    # their value at the head: that cancels, and a segment's small
    # sums, e.g. the squares of two near-equal values, lose most of
    # their digits; ROADMAP C.)
    ones = torch.ones(n, dtype=torch.int32, device=slots.device)
    pn_i, ps, pq = (
        shifted(c) for c in _segmented_inclusive(_sums, seg_start, (ones, d, d * d))
    )

    def around_pivot(cnt_f, s, q):
        """(mean, m2) of a shifted prefix sum triple."""
        safe = torch.clamp(cnt_f, min=1.0)
        return pivot + s / safe, q - s * s / safe

    def chan_merge(n0_i, mean0, m20, nb_i, mean_b, m2_b):
        nt_i = n0_i + nb_i
        n0f = n0_i.to(f)
        nbf = nb_i.to(f)
        safe = torch.clamp(nt_i.to(f), min=1.0)
        delta = mean_b - mean0
        mean = mean0 + delta * nbf / safe
        m2 = m20 + m2_b + delta * delta * n0f * nbf / safe
        return nt_i, mean, m2

    n0_i = count_t[idx_s]
    mean0 = mean_t[idx_s]
    m20 = m2_t[idx_s]

    # Pre-update state per row = table carry ⊕ in-batch prefix.
    mean_b, m2_b = around_pivot(pn_i.to(f), ps, pq)
    p_n, p_mean, p_m2 = chan_merge(n0_i, mean0, m20, pn_i, mean_b, m2_b)

    have_var = (p_n >= 2) & (p_m2 > 0)
    denom = torch.sqrt(p_m2 / torch.clamp(p_n.to(f) - 1, min=1.0))
    z = torch.where(have_var, (vals - p_mean) / denom, torch.zeros_like(vals))

    # Segment tails write table carry ⊕ inclusive in-batch state back;
    # every other row writes the scratch slot.
    mean_i, m2_i = around_pivot(pn_i.to(f) + 1, ps + d, pq + d * d)
    s_n, s_mean, s_m2 = chan_merge(n0_i, mean0, m20, pn_i + 1, mean_i, m2_i)
    dest = torch.where(_seg_end(slots), idx_s, capacity - 1)
    count_t[dest] = s_n.to(count_t.dtype)
    mean_t[dest] = s_mean
    m2_t[dest] = s_m2
    return (z,), state


class WelfordZScore(ScanKind):
    """Per-key rolling z-score over Welford ``(count, mean, m2)``
    state; emits ``(value, z, abs(z) > threshold)`` per row, z scored
    against the pre-update state.  Its plain version is the specialized
    pivot-shifted body (:func:`zscore_scan_body`); on the card it runs
    the kernel's ``welford`` instance."""

    name = "zscore"
    fields = WELFORD_FIELDS
    kernel = "welford"

    def __init__(self, threshold: float):
        self.threshold = float(threshold)

    def lift(self, values):
        n = values.shape[0]
        return (
            torch.ones(n, dtype=torch.int32, device=values.device),
            values,
            torch.zeros(n, dtype=values.dtype, device=values.device),
        )

    def merge(self, a, b):
        return welford_merge(a, b)

    def emit(self, pre, post, values):
        p_n, p_mean, p_m2 = pre
        f = p_mean.dtype
        have_var = (p_n >= 2) & (p_m2 > 0)
        denom = torch.sqrt(p_m2 / torch.clamp(p_n.to(f) - 1, min=1.0))
        z = torch.where(have_var, (values - p_mean) / denom, torch.zeros_like(p_mean))
        return (z,)

    def plain(self, fields, slots, values):
        return zscore_scan_body(fields, slots, values)

    def post(self, outs):
        (z,) = outs
        # The flag compare runs in float64 so borderline rows classify
        # identically to the host tier (which compares in f64).
        return z, np.abs(z.astype(np.float64)) > self.threshold


class Ema(ScanKind):
    """Per-key debiased exponential moving average.

    State is ``(count, s)`` with ``s`` the biased accumulator
    ``s ← (1-alpha)·s + alpha·v``; each row emits ``(value, ema)``
    with the debiased ``ema = s / (1 - (1-alpha)^count)`` after folding
    the row in, so the first value of a key emits itself.  The merge
    ``(n₁+n₂, s₁·(1-alpha)^{n₂} + s₂)`` is associative.
    """

    name = "ema"
    fields = {
        "count": (0, torch.int32),
        "s": (0.0, torch.float32),
    }
    kernel = "ema"

    def __init__(self, alpha: float):
        if not 0.0 < alpha <= 1.0:
            msg = f"ema alpha must be in (0, 1], got {alpha}"
            raise ValueError(msg)
        self.alpha = float(alpha)
        # (1-alpha)^n and 1-(1-alpha)^n go through exp/expm1 of
        # n·log1p(-alpha) (the log in float64 here): the naive power
        # rounds 1-alpha to 1.0 in float32 for alpha < ~6e-8, which
        # freezes the decay and collapses the debias factor to 0.
        self._log_q = float("-inf") if alpha == 1.0 else math.log1p(-alpha)

    def kernel_params(self):
        return self.alpha, self._log_q

    def lift(self, values):
        n = values.shape[0]
        return (
            torch.ones(n, dtype=torch.int32, device=values.device),
            self.alpha * values,
        )

    def merge(self, a, b):
        n1, s1 = a
        n2, s2 = b
        f = s1.dtype
        # Guard n2 == 0: 0 · -inf is NaN for alpha == 1.
        decay = torch.where(
            n2 > 0, torch.exp(n2.to(f) * self._log_q), torch.ones((), dtype=f, device=s1.device)
        )
        return n1 + n2, s1 * decay + s2

    def emit(self, pre, post, values):
        n, s = post
        f = s.dtype
        bias = -torch.expm1(n.to(f) * self._log_q)
        return (s / torch.clamp(bias, min=torch.finfo(f).tiny),)


class RunningExtrema(ScanKind):
    """Per-key running min/max: state ``(mn, mx)``, each row emits
    ``(value, min_so_far, max_so_far)`` including the row itself.  NaN
    propagates (``torch.minimum``/``torch.maximum``), as in the JAX
    package's device tier.

    >>> import torch
    >>> from bytewax_tpu_torch.ops.scan import RunningExtrema
    >>> fields = {"mn": torch.full((4,), float("inf")), "mx": torch.full((4,), float("-inf"))}
    >>> slots = torch.tensor([0, 0, 2], dtype=torch.int32)
    >>> (mn, mx), _ = RunningExtrema().run(fields, slots, torch.tensor([3.0, 1.0, 5.0]))
    >>> mn.tolist(), mx.tolist(), fields["mn"][:3].tolist()
    ([3.0, 1.0, 5.0], [3.0, 3.0, 5.0], [1.0, inf, 5.0])
    """

    name = "extrema"
    fields = {
        "mn": (float("inf"), torch.float32),
        "mx": (float("-inf"), torch.float32),
    }
    kernel = "extrema"

    def lift(self, values):
        return values, values

    def merge(self, a, b):
        return torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1])

    def emit(self, pre, post, values):
        return post


def field_dtype(v: Any) -> torch.dtype:
    """A UDF state field's dtype from its initial value's Python type."""
    if isinstance(v, bool):
        return torch.bool
    if isinstance(v, int):
        return torch.int32
    return torch.float32


class TorchUdfScan(ScanKind):
    """Any torch per-key mapper on the device tier: the traceable-UDF
    tier for ``stateful_map`` (the counterpart of the JAX package's
    ``JaxUdfScan``, which runs ``lax.scan`` over the rows).

    An arbitrary mapper has no associative structure to exploit, but
    keys are independent and rows keep their order within a key.  So
    the grouped rows are laid out as ``[keys, max_run]`` and the batch
    takes ``max_run`` steps, each one ``torch.func.vmap`` of ``fn``
    across all keys: no per-row Python, sequential only along each
    key's run (a batch whose rows all share one key takes one step a
    row).

    ``fn(state_tuple, value) -> (state_tuple, outs)`` over scalar
    tensors; ``init`` gives each field's initial value and, by Python
    type, its dtype (float → float32, int → int32, bool → bool).  Each
    row emits ``(value, *outs)``.  Snapshots are the plain state tuple
    in field order, interchangeable with the host tier.
    """

    name = "torch_udf"

    def __init__(self, fn: Callable, init: Tuple):
        self.fn = fn
        self.init = tuple(init)
        self.fields = {f"s{i}": (v, field_dtype(v)) for i, v in enumerate(self.init)}
        self._vstep = torch.func.vmap(self._step)

    def _step(self, state, value):
        new_state, outs = self.fn(state, value)
        if len(new_state) != len(state):
            msg = (
                f"torch_stateful_map fn returned {len(new_state)} state "
                f"fields; init declared {len(state)}"
            )
            raise TypeError(msg)
        if not isinstance(outs, tuple):
            outs = (outs,)
        return tuple(new_state), outs

    def plain(self, fields, slots, values):
        names = tuple(self.fields)
        n = slots.shape[0]
        dev = slots.device
        seg_start = _seg_start(slots)
        heads = torch.nonzero(seg_start).flatten()
        seg_id = torch.cumsum(seg_start, 0) - 1
        lens = torch.diff(heads, append=torch.tensor([n], device=dev))
        pos = torch.arange(n, device=dev) - heads[seg_id]
        n_keys = heads.shape[0]
        max_run = int(lens.max())
        grid = torch.zeros((n_keys, max_run), dtype=values.dtype, device=dev)
        grid[seg_id, pos] = values
        key_slots = slots[heads].long()
        state = tuple(fields[nm][key_slots] for nm in names)
        out_grids = None
        for t in range(max_run):
            live = lens > t
            new_state, outs = self._vstep(state, grid[:, t])
            state = tuple(
                torch.where(live, ns.to(s.dtype), s) for ns, s in zip(new_state, state)
            )
            if out_grids is None:
                out_grids = [
                    torch.empty((n_keys, max_run), dtype=o.dtype, device=dev) for o in outs
                ]
            for g, o in zip(out_grids, outs):
                g[:, t] = o
        for nm, s in zip(names, state):
            fields[nm][key_slots] = s
        return tuple(g[seg_id, pos] for g in out_grids), fields
