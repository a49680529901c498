"""Host-tier execution engine.

A single-process driver interprets the 9-core-operator plan with *W*
logical worker lanes (the analog of the reference's worker threads,
upstream bytewax ``src/worker.rs:68-159``): source partitions and keyed
state are deterministically assigned to lanes, keyed exchanges re-tag
lanes exactly like the reference's ``routed_exchange``
(``src/timely.rs:806-812``), and a global epoch clock drives eager
processing, ``notify_at`` wakeups, EOF, and snapshot-at-epoch-close
semantics (the reference's ``EagerNotificator``,
``src/timely.rs:169-270``).

This tier is the *correctness oracle* and the arbitrary-Python-UDF
path.  The XLA tier (:mod:`bytewax_tpu_torch.engine.xla`) accelerates
eligible segments of the same plan on the device mesh; both tiers share
this driver's epoch/recovery bookkeeping.
"""

import hashlib
import os
import pickle
import random
import threading
import time
import zlib
from collections import deque
from datetime import datetime, timedelta, timezone
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from bytewax_tpu_torch.dataflow import Dataflow, Operator
from bytewax_tpu_torch.engine import backoff as _backoff
from bytewax_tpu_torch.engine import batching as _batching
from bytewax_tpu_torch.engine import faults as _faults
from bytewax_tpu_torch.engine import flight as _flight
from bytewax_tpu_torch.engine import flowmap as _flowmap
from bytewax_tpu_torch.engine import wire as _wire
from bytewax_tpu_torch.engine.arrays import (
    ArrayBatch,
    PeerVocab,
    factorize_keys,
    peer_vocab,
)
from bytewax_tpu_torch.engine.dlq import DeadLetterQueue
from bytewax_tpu_torch.errors import (
    ClusterPeerDead,
    DeviceFault,
    EpochStalled,
    GracefulStop,
    TransientIOError,
    TransientSinkError,
    TransientSourceError,
    is_transient_io_error,
    note_context,
)
from bytewax_tpu_torch.engine.flatten import Plan, flatten
from bytewax_tpu_torch.engine.recovery_store import RecoveryStore, ResumeFrom, loads
from bytewax_tpu_torch.engine.residency import ResidentKeyState, maybe_wrap
from bytewax_tpu_torch.engine.xla import AccelSpec, DeviceAggState, NonNumericValues
from bytewax_tpu_torch.inputs import (
    AbortExecution,
    DynamicSource,
    FixedPartitionedSource,
)
from bytewax_tpu_torch.native import (
    bucket_adler as _native_bucket_adler,
    group_kv as _native_group_kv,
    scan_emit as _native_scan_emit,
    scan_fill_values as _native_scan_fill,
)
from bytewax_tpu_torch.tracing import span as _span, spans_active as _spans_active
from bytewax_tpu_torch.outputs import DynamicSink, FixedPartitionedSink

__all__ = [
    "cluster_main",
    "request_stop",
    "reset_stop",
    "run_main",
    "stop_requested",
    "update_params",
]

_EMPTY_COOLDOWN = timedelta(milliseconds=1)
_DEFAULT_EPOCH_INTERVAL = timedelta(seconds=10)
#: Seconds a process waits for its peers to join torch.distributed
#: (BYTEWAX_TPU_DISTRIBUTED=1), and for each collective after.
_DIST_INIT_TIMEOUT_S = 60.0

Entry = Tuple[int, List[Any]]  # (worker lane, items)


def _route_hash(key: str) -> int:
    """Deterministic cross-process key hash (like the reference's use
    of a consistent hash for routing; builtin ``hash`` is salted)."""
    return zlib.adler32(key.encode("utf-8"))


def _py_scan_emit(groups, outs):
    """Python emission of scan output columns over an insertion-
    ordered group dict — same layout as the native ``scan_emit``,
    without its dtype limits."""
    cols = [np.asarray(o).tolist() for o in outs]
    out_items = []
    pos = 0
    for key, values in groups.items():
        for v in values:
            out_items.append((key, (v, *(c[pos] for c in cols))))
            pos += 1
    return out_items


def _route_hashes_of(strs) -> np.ndarray:
    """Vectorized ``_route_hash`` over an iterable of keys (hashes
    only the iterable — callers hash unique keys / vocab entries, not
    every row)."""
    return np.fromiter(
        (zlib.adler32(str(s).encode("utf-8")) for s in strs),
        dtype=np.int64,
        count=len(strs),
    )


def _now() -> datetime:
    return datetime.now(timezone.utc)


def _batch_event_lag_s(items: Any, now: datetime) -> Optional[float]:
    """Event-time lag of one source batch at ingest: wall-clock now
    minus the freshest event timestamp the batch carries (``ts``
    column on a columnar batch; a trailing datetime/TsValue row on an
    itemized one — sources emit in arrival order, so the last row is
    the freshest).  None when the batch carries no discoverable event
    time; the watermark trails this by the clock's configured wait."""
    try:
        if isinstance(items, ArrayBatch):
            col = items.cols.get("ts")
            if col is None:
                return None
            arr = np.asarray(col)
            if not len(arr):
                return None
            if np.issubdtype(arr.dtype, np.datetime64):
                latest = arr.max().astype("datetime64[us]")
                if np.isnat(latest):
                    # A NaT (missing timestamp) propagates through
                    # max() and would turn the lag into NaN — which
                    # json.dumps renders as a bare token no
                    # spec-compliant parser accepts, poisoning
                    # /status cluster-wide.
                    return None
                now64 = np.datetime64(now.replace(tzinfo=None), "us")
                return float((now64 - latest) / np.timedelta64(1, "s"))
            if np.issubdtype(arr.dtype, np.integer) or np.issubdtype(
                arr.dtype, np.floating
            ):
                # Numeric ts columns are microseconds since epoch —
                # the ArrayBatch convention (_ts_datetimes) the
                # batch-native connectors emit.  NaN propagates
                # through max() like NaT would; reject it the same
                # way.
                latest_us = float(arr.max())
                if latest_us != latest_us:  # NaN
                    return None
                return now.timestamp() - latest_us / 1e6
            return None
        last = items[-1]
    except (TypeError, IndexError, KeyError, ValueError):
        return None
    value = last
    if isinstance(last, tuple) and len(last) == 2:
        value = last[1]
    ts = value if isinstance(value, datetime) else None
    if ts is None:
        ts = getattr(value, "ts", None)
        if not isinstance(ts, datetime):
            return None
    if ts.tzinfo is None:
        return None
    return (now - ts).total_seconds()


def _extract_kv(item: Any, step_id: str) -> Tuple[str, Any]:
    try:
        k, v = item
    except (TypeError, ValueError) as ex:
        msg = (
            f"step {step_id!r} requires `(key, value)` 2-tuple from "
            f"upstream for routing; got a {type(item)!r} instead"
        )
        raise TypeError(msg) from ex
    if not isinstance(k, str):
        msg = (
            f"step {step_id!r} requires `str` keys in `(key, value)` "
            f"from upstream; got a {type(k)!r} instead"
        )
        raise TypeError(msg)
    return k, v


class _Abort(Exception):
    """Internal: a source requested hard abort."""


#: Faults the supervisor may heal by restarting the worker from the
#: last committed epoch: peer death / torn mesh (ClusterPeerDead is a
#: ConnectionError), a wedged epoch protocol, injected chaos faults,
#: device faults that escaped demotion (the collective global-
#: exchange tier cannot demote per-process), and connector-edge
#: transient I/O faults that exhausted the in-place retry budget
#: (docs/recovery.md "Connector-edge resilience" — whole-cluster
#: restart is the escalation path, not the first response).
_RESTARTABLE = (
    ConnectionError,
    EpochStalled,
    _faults.InjectedFault,
    DeviceFault,
    TransientIOError,
)


def _max_restarts() -> int:
    return int(os.environ.get("BYTEWAX_TPU_MAX_RESTARTS", "0") or 0)


#: Cooperative stop flag for this process (docs/recovery.md "Graceful
#: drain-to-stop").  An Event, not a driver attribute, because the
#: setters live outside the driver's lifetime: the CLI's
#: SIGTERM/SIGINT handlers install before the driver exists, the API
#: server's ``POST /stop`` runs on its own thread, and a supervised
#: restart rebuilds the driver while the request must survive.
_STOP_EVENT = threading.Event()


def request_stop(source: str = "api") -> None:
    """Request a graceful drain-to-stop of the execution running (or
    about to run) in this process.

    The run loop observes the flag and drains to a stop at the next
    epoch close — a globally-ordered, pipeline-drained point: the
    epoch's snapshots and DLQ flush commit exactly as usual, in a
    cluster every process agrees on the stop via the existing
    epoch-close sync round (no new control-frame kinds), and the
    entry point returns a typed :class:`~bytewax_tpu_torch.errors.GracefulStop`
    instead of unwinding through the restart supervisor.  Safe to
    call from any thread or signal handler.
    """
    already = _STOP_EVENT.is_set()
    _STOP_EVENT.set()
    if not already:
        _flight.note_stop_requested(source)


def stop_requested() -> bool:
    """Whether a graceful stop has been requested on this process."""
    return _STOP_EVENT.is_set()


def reset_stop() -> None:
    """Clear a pending stop request (entry points consume it
    implicitly when they return — a stop targets one execution, not
    the process forever; a request made BEFORE the entry point is
    honored by that execution at its first epoch close)."""
    _STOP_EVENT.clear()


#: Pending live-reconfiguration target for this process
#: (docs/recovery.md "Live partial rescale"): ``(addresses tuple,
#: workers_per_process or None)``.  Module-level like ``_STOP_EVENT``
#: — the setters (the API server's ``POST /reconfigure``, embedders)
#: live outside the driver's lifetime, and the request must survive
#: an in-process supervised restart until an epoch close consumes it.
_RECONFIG_LOCK = threading.Lock()
_RECONFIG_TARGET: Optional[Tuple[Tuple[str, ...], Optional[int]]] = None


def request_reconfigure(
    addresses: List[str],
    workers_per_process: Optional[int] = None,
    source: str = "api",
) -> None:
    """Request a LIVE cluster membership change: at the next epoch
    close every process proposes its pending target on the existing
    close sync round, and once the whole cluster has the same target
    the close commits as usual and each process unwinds to the
    run-startup re-entry point — rebuilding against the new address
    list (or retiring, when its process id falls outside it) without
    leaving the process.  Keyed state re-shards there through the
    delta-only store migration (docs/recovery.md "Live partial
    rescale").  Safe to call from any thread.

    ``addresses`` is the full new cluster address list (empty list =
    a single process with no mesh); ``workers_per_process`` changes
    the per-process lane count too (``None`` keeps the current one).
    """
    global _RECONFIG_TARGET
    addrs = tuple(str(a) for a in addresses)
    wpp = None
    if workers_per_process is not None:
        wpp = int(workers_per_process)
        if wpp < 1:
            msg = f"workers_per_process must be >= 1 (got {wpp})"
            raise ValueError(msg)
    with _RECONFIG_LOCK:
        _RECONFIG_TARGET = (addrs, wpp)
    _flight.note_reconfigure_requested(len(addrs), wpp, source)


def _pending_reconfigure() -> Optional[
    Tuple[Tuple[str, ...], Optional[int]]
]:
    with _RECONFIG_LOCK:
        return _RECONFIG_TARGET


def reset_reconfigure() -> None:
    """Clear a pending reconfigure request (entry points consume it
    implicitly when they return — like a stop request, it targets one
    execution, not the process forever)."""
    global _RECONFIG_TARGET
    with _RECONFIG_LOCK:
        _RECONFIG_TARGET = None


def _consume_reconfigure(
    spec: Tuple[Tuple[str, ...], int]
) -> None:
    """Clear the pending target iff it still matches the spec just
    acted on (a NEWER request posted mid-close — different addresses
    OR a different explicit lane count — must survive for the next
    close).  A pending ``wpp=None`` ("keep mine") matches whatever
    lane count the agreement substituted for it."""
    global _RECONFIG_TARGET
    with _RECONFIG_LOCK:
        if _RECONFIG_TARGET is None:
            return
        addrs, wpp = _RECONFIG_TARGET
        if addrs == spec[0] and (wpp is None or wpp == spec[1]):
            _RECONFIG_TARGET = None


#: Pending broadcast-params update for this process's infer steps
#: (docs/inference.md): ``(step_id or None for every infer step,
#: digest, normalized params pytree)``.  Module-level like the stop
#: flag and the reconfigure target — the setters (``POST /model``,
#: embedders) outlive the driver, and the request must survive an
#: in-process supervised restart until an agreed epoch close installs
#: it (that survival IS the exactly-once story: a crash between the
#: agreement and the install replays the close and re-agrees).
_MODEL_LOCK = threading.Lock()
_MODEL_TARGET: Optional[Tuple[Optional[str], str, Any]] = None


def update_params(
    params: Any,
    step_id: Optional[str] = None,
    source: str = "api",
) -> str:
    """Request a hot swap of an ``op.infer`` step's broadcast params.

    The pending update rides the EXISTING epoch-close sync payload
    (like the stop vote and the reconfigure target — no new
    control-frame kinds): once every process proposes the same
    ``(step_id, digest)`` the agreed close installs the new params on
    every worker before the next epoch opens, so the whole cluster
    swaps at one globally-ordered point.  Params never cross the mesh
    — each process is handed the pytree locally (the HTTP body, an
    embedder call) and the digest agreement proves they match.

    ``step_id`` targets one infer step by its core step id (``None``
    = every infer step whose params tree is compatible).  Returns the
    content digest recorded for the swap.  Safe to call from any
    thread.
    """
    global _MODEL_TARGET
    from bytewax_tpu_torch.engine.infer import normalize_params, params_digest

    normalized = normalize_params(params)
    digest = params_digest(normalized)
    with _MODEL_LOCK:
        _MODEL_TARGET = (step_id, digest, normalized)
    _flight.note_params_requested(step_id, digest, source)
    return digest


def _pending_params() -> Optional[Tuple[Optional[str], str, Any]]:
    with _MODEL_LOCK:
        return _MODEL_TARGET


def reset_params_update() -> None:
    """Clear a pending params update (entry points consume it
    implicitly when they return — like a stop request, it targets one
    execution, not the process forever)."""
    global _MODEL_TARGET
    with _MODEL_LOCK:
        _MODEL_TARGET = None


def _consume_params(spec: Tuple[Optional[str], str]) -> None:
    """Clear the pending update iff it still matches the
    ``(step_id, digest)`` just installed (a NEWER update posted
    mid-close must survive for the next close)."""
    global _MODEL_TARGET
    with _MODEL_LOCK:
        if _MODEL_TARGET is None:
            return
        if (_MODEL_TARGET[0], _MODEL_TARGET[1]) == spec:
            _MODEL_TARGET = None


class _Reconfigure:
    """Internal completion status of a run that agreed a live
    membership change: ``_supervised`` intercepts it and re-enters
    run startup in-process at the new shape (or returns a
    :class:`~bytewax_tpu_torch.errors.GracefulStop` when this process
    retires).  Never escapes the entry points."""

    __slots__ = ("addresses", "wpp", "epoch")

    def __init__(
        self, addresses: List[str], wpp: int, epoch: int
    ):
        self.addresses = list(addresses)
        self.wpp = wpp
        self.epoch = epoch

    def __repr__(self) -> str:
        return (
            f"_Reconfigure(addresses={len(self.addresses)}, "
            f"wpp={self.wpp}, epoch={self.epoch})"
        )


#: rescale_hint thresholds (docs/recovery.md): an epoch close whose
#: p99 exceeds this fraction of the epoch interval means snapshots
#: are eating the processing budget; flush stalls above this fraction
#: mean the host is waiting on the device pipeline; more than this
#: many residency restores per epoch means the working set thrashes
#: the device budget; sustained spill traffic above this byte rate
#: (while restores are non-negligible) means state actively pages
#: through the disk tier.  Below the QUIET thresholds with more than
#: one worker, the cluster is oversized.  All signals are lifetime
#: per-epoch-close averages off cumulative counters, so the quiet
#: bounds are small-but-nonzero: a one-off warm-up stall/spill decays
#: below them as closes accumulate instead of pinning the advice
#: forever.
_HINT_CLOSE_FRAC = 0.5
_HINT_STALL_FRAC = 0.2
_HINT_RESTORES_PER_CLOSE = 1.0
_HINT_SPILL_BYTES_PER_CLOSE = 4096.0
_HINT_QUIET_CLOSE_FRAC = 0.05
_HINT_QUIET_STALL_FRAC = 0.01
_HINT_QUIET_RESTORES = 0.1
_HINT_QUIET_SPILL_BYTES = 256.0
#: Ledger-fraction thresholds: epochs whose attributed time is mostly
#: device folds + pipeline flush stalls are compute-saturated (grow);
#: epochs mostly spent waiting in the cluster barrier mean THIS
#: process is ahead of its peers — growing it buys nothing (hold, or
#: shrink when everything else is quiet too).
_HINT_DEVICE_FRAC = 0.5
_HINT_BARRIER_FRAC = 0.5


def derive_rescale_hint(
    *,
    worker_count: int,
    epoch_interval_s: float,
    close_p99_s: Optional[float],
    stall_s_per_close: float,
    restores_per_close: float,
    spill_bytes_per_close: float = 0.0,
    snapshot_stall_s_per_close: float = 0.0,
    phase_fractions: Optional[Dict[str, float]] = None,
    bottleneck: Optional[Tuple[str, str]] = None,
) -> Tuple[str, List[str]]:
    """Pure rescale advice from the engine's load signals.

    Returns ``(advice, reasons)`` where advice is ``"grow"`` (the
    cluster is saturated: stop it and relaunch with more processes
    and ``--rescale``), ``"shrink"`` (it is idle enough that fewer
    processes would do), or ``"hold"``.  Signals are per-epoch-close
    averages so the advice is rate-based, not run-length-based; with
    no closes recorded yet everything reads zero and the advice is
    ``hold``.  Deliberately conservative: ``shrink`` needs EVERY
    signal quiet, ``grow`` needs any one loud.

    ``phase_fractions`` is the epoch ledger's measured attribution
    (:func:`bytewax_tpu_torch.engine.flight.ledger_fractions`), when
    available: device-or-flush-dominated epochs are their own grow
    reason, and barrier-dominated epochs veto grow (this process is
    waiting on its peers — more of it won't help) and count toward
    shrink instead.

    ``bottleneck`` is the flow map's step attribution
    (:func:`bytewax_tpu_torch.engine.flowmap.derive_bottleneck`), when one
    was derived: a ``(step_id, why)`` pair appended verbatim as a
    step-scoped reason, so the advice names WHERE the pressure is,
    not just that there is some."""
    def _scoped(
        advice: str, reasons: List[str]
    ) -> Tuple[str, List[str]]:
        # The step attribution annotates WHATEVER the advice is — it
        # names where the pressure sits but is never itself a grow
        # trigger (a step dominating a quiet flow is normal).
        if bottleneck is not None:
            step_id, why = bottleneck
            reasons = list(reasons) + [
                f"bottleneck step {step_id!r}: {why}"
            ]
        return advice, reasons

    reasons: List[str] = []
    if (
        close_p99_s is not None
        and epoch_interval_s > 0
        and close_p99_s > _HINT_CLOSE_FRAC * epoch_interval_s
    ):
        reasons.append(
            f"epoch_close_p99 {close_p99_s:.3f}s exceeds "
            f"{_HINT_CLOSE_FRAC:.0%} of the {epoch_interval_s:g}s "
            "epoch interval"
        )
    if (
        epoch_interval_s > 0
        and stall_s_per_close > _HINT_STALL_FRAC * epoch_interval_s
    ):
        reasons.append(
            f"pipeline flush stalls {stall_s_per_close:.3f}s/epoch "
            f"exceed {_HINT_STALL_FRAC:.0%} of the epoch interval"
        )
    if (
        epoch_interval_s > 0
        and snapshot_stall_s_per_close
        > _HINT_STALL_FRAC * epoch_interval_s
    ):
        # Async checkpointing moved snapshot+commit off the close
        # window, so a durability-bound flow now shows up as fence
        # stalls instead of a loud close — it must still read as
        # pressure, never as quiet (docs/recovery.md "Asynchronous
        # incremental checkpoints").
        reasons.append(
            f"snapshot fence stalls {snapshot_stall_s_per_close:.3f}"
            f"s/epoch exceed {_HINT_STALL_FRAC:.0%} of the epoch "
            "interval: checkpoint durability trails the close rate"
        )
    if restores_per_close > _HINT_RESTORES_PER_CLOSE:
        reasons.append(
            f"{restores_per_close:.1f} residency restores/epoch: the "
            "keyed working set thrashes the device state budget"
        )
    if (
        spill_bytes_per_close > _HINT_SPILL_BYTES_PER_CLOSE
        and restores_per_close > _HINT_QUIET_RESTORES
    ):
        reasons.append(
            f"{spill_bytes_per_close:.0f} spill bytes/epoch alongside "
            "restores: state is actively paging through the disk tier"
        )
    fractions = phase_fractions or {}
    device_frac = fractions.get("device", 0.0) + fractions.get(
        "flush", 0.0
    )
    barrier_frac = fractions.get("barrier", 0.0)
    if device_frac > _HINT_DEVICE_FRAC:
        reasons.append(
            f"ledger: {device_frac:.0%} of attributed epoch time is "
            "device folds + pipeline flush stalls — the device tier "
            "is the measured bottleneck"
        )
    barrier_bound = barrier_frac > _HINT_BARRIER_FRAC
    if reasons:
        if barrier_bound:
            # The attribution says this process spends its epochs
            # waiting for peers — its own loud signals are skew, not
            # saturation, and a grow would add more waiters.
            return _scoped(
                "hold",
                [
                    f"ledger: {barrier_frac:.0%} of attributed epoch "
                    "time is barrier wait — this process is ahead of "
                    "its peers; growing would add waiters, not "
                    "throughput"
                ]
                + reasons,
            )
        return _scoped("grow", reasons)
    if (
        worker_count > 1
        and epoch_interval_s > 0
        and close_p99_s is not None
        and close_p99_s < _HINT_QUIET_CLOSE_FRAC * epoch_interval_s
        and stall_s_per_close
        < _HINT_QUIET_STALL_FRAC * epoch_interval_s
        and snapshot_stall_s_per_close
        < _HINT_QUIET_STALL_FRAC * epoch_interval_s
        and restores_per_close < _HINT_QUIET_RESTORES
        and spill_bytes_per_close < _HINT_QUIET_SPILL_BYTES
    ):
        return _scoped(
            "shrink",
            [
                f"epoch_close_p99 {close_p99_s:.3f}s is under "
                f"{_HINT_QUIET_CLOSE_FRAC:.0%} of the epoch interval "
                "with negligible pipeline stalls and residency "
                "pressure"
            ],
        )
    if barrier_bound and worker_count > 1:
        return _scoped(
            "shrink",
            [
                f"ledger: {barrier_frac:.0%} of attributed epoch time "
                "is barrier wait — the cluster is skewed or oversized "
                "for the load; fewer processes may do"
            ],
        )
    return _scoped("hold", reasons)


def _backoff_delay(
    base: float, attempt: int, rng: random.Random
) -> float:
    """Capped exponential restart backoff with per-process jitter —
    the supervisor's view of the shared helper
    (:mod:`bytewax_tpu_torch.engine.backoff`, also used by the comm dial
    loop and the connector-edge I/O retry).

    The jitter factor is drawn uniformly from [0.5, 1.5) off a
    per-``proc_id``-seeded stream: without it, every process of a
    crashed cluster sleeps the *identical* deterministic delay and
    redials simultaneously — a thundering-herd handshake (and one
    dial-timeout round) on every generation bump."""
    return _backoff.backoff_delay(base, attempt, rng=rng)


def _supervised(
    make: Callable[..., "_Driver"], proc_id: int = 0
) -> Optional[GracefulStop]:
    """Run a driver under the restart supervisor.  Returns the
    driver's completion status: a typed
    :class:`~bytewax_tpu_torch.errors.GracefulStop` after a cooperative
    drain-to-stop, ``None`` after an EOF completion.

    ``make(generation, reconfig)`` builds a fresh driver (re-opening
    the recovery store recomputes ``resume_from()``, so each
    generation resumes from the last committed epoch); ``reconfig``
    is ``None`` normally, or the :class:`_Reconfigure` a live
    membership change agreed — the factory then builds against the
    NEW address list / lane count with rescale-on-resume forced on.
    Restartable faults are retried up to
    ``BYTEWAX_TPU_MAX_RESTARTS`` times *per failure burst* (default
    0 — supervision off, faults propagate exactly as before) with
    capped exponential backoff starting at
    ``BYTEWAX_TPU_RESTART_BACKOFF_S``, jittered per process (seeded
    by ``proc_id``, so restart schedules are deterministic per
    process but desynchronized across the cluster).

    A live reconfiguration (docs/recovery.md "Live partial rescale")
    unwinds HERE, not to the OS: the run loop returns
    :class:`_Reconfigure` after committing the agreed epoch close,
    and this loop re-enters run startup in-process — the same
    globally-ordered re-entry point a supervised restart uses, so the
    "re-shard only at run startup" contract holds by construction.  A
    process whose id falls outside the new address list retires with
    a :class:`~bytewax_tpu_torch.errors.GracefulStop` instead (its keyed
    state reaches the survivors through the delta store migration).

    The budget and backoff are burst-scoped (the Erlang/k8s
    crash-loop intensity model): an execution that stays healthy for
    ``BYTEWAX_TPU_RESTART_RESET_S`` (default 300s) before failing
    resets both, so sporadic faults over a long-running flow never
    escalate to the backoff cap or exhaust the budget — only a rapid
    crash loop does.

    Restarts re-enter at run startup — a globally-ordered point (mesh
    handshake + the unconditional "fcfg" sync round), so the restarted
    cluster performs the same sequence of sync rounds from scratch and
    the gsync/barrier contract holds across generations.  Run startup
    is also where rescale-on-resume happens: a supervised cluster
    stopped at N processes and relaunched at M re-shards its keyed
    state there, before any epoch processing (docs/recovery.md).
    """
    max_restarts = _max_restarts()
    reset_s = float(
        os.environ.get("BYTEWAX_TPU_RESTART_RESET_S", "300") or 300
    )
    rng = _backoff.seeded_rng("restart", proc_id)
    attempt = 0
    generation = 0
    reconfig: Optional[_Reconfigure] = None
    try:
        while True:
            started = time.monotonic()
            try:
                result = make(generation, reconfig).run()
                if isinstance(result, _Reconfigure):
                    if proc_id >= max(len(result.addresses), 1):
                        # This process retires: the agreed close
                        # committed its state, the delta migration
                        # re-routes it to the survivors, and the
                        # supervisor reaps a clean exit.
                        _flight.note_graceful_stop(result.epoch)
                        return GracefulStop(
                            result.epoch,
                            generation=generation,
                            proc_id=proc_id,
                        )
                    # Re-enter run startup in-process at the new
                    # shape: a new fenced generation, the startup
                    # agreement round, the (now delta-only) store
                    # migration, fresh runtime builds — everything a
                    # process relaunch would do, minus the process.
                    reconfig = result
                    generation += 1
                    attempt = 0  # a reconfiguration is not a fault
                    continue
                return result
            except _RESTARTABLE as ex:
                # Crash post-mortem (BYTEWAX_TPU_POSTMORTEM_DIR): the
                # flight ring tail, counters, and the in-flight
                # epoch's ledger, written before any restart decision
                # so the evidence survives whether this burst
                # restarts or gives up.  ``generation`` is still the
                # generation that failed.
                _flight.write_postmortem(
                    proc_id, generation, type(ex).__name__, str(ex)
                )
                if time.monotonic() - started >= reset_s:
                    attempt = 0  # healthy run: new failure burst
                if attempt >= max_restarts:
                    raise
                attempt += 1
                generation += 1
                base = float(
                    os.environ.get(
                        "BYTEWAX_TPU_RESTART_BACKOFF_S", "0.5"
                    )
                    or 0.5
                )
                delay = _backoff_delay(base, attempt, rng)
                _flight.note_restart(attempt, type(ex).__name__, delay)
                import logging

                logging.getLogger(__name__).warning(
                    "worker fault (%s: %s); supervised restart %d/%d "
                    "in %.2fs",
                    type(ex).__name__,
                    ex,
                    attempt,
                    max_restarts,
                    delay,
                )
                time.sleep(delay)
    finally:
        # A stop request targets one execution: consume it when this
        # invocation ends (graceful stop, EOF, or a fatal unwind) so
        # it cannot leak into the next entry-point call.  It is NOT
        # cleared at entry — a request that arrived before the run
        # loop existed (a k8s SIGTERM during the slow jax/flow
        # import, an embedder calling request_stop() just before
        # run_main) must stop that execution at its first epoch
        # close — and it deliberately survives supervised restarts
        # within the invocation.
        _STOP_EVENT.clear()
        reset_reconfigure()
        reset_params_update()


class _StepError(RuntimeError):
    """User code in a step raised; carries context like the
    reference's error chaining (``src/errors.rs``)."""


def _reraise(
    step_id: str,
    what: str,
    ex: BaseException,
    fn: Optional[Callable] = None,
) -> None:
    """Re-raise a user exception with location-tracked engine context
    (the reference's ``src/errors.rs`` chaining): the failing step,
    the engine call site that caught it, and — when the caller passes
    the user callable — the def site of the code that raised."""
    note_context(
        ex, f"error calling {what} in step {step_id!r}", fn=fn, _depth=2
    )
    raise ex


class _OpRt:
    """Base runtime for one core operator."""

    def __init__(self, op: Operator, driver: "_Driver"):
        self.op = op
        self.driver = driver
        self.eof = False
        #: port name -> queued entries
        self.queues: Dict[str, List[Entry]] = {
            port: [] for port in op.ups.keys()
        }
        # Per-worker cached Prometheus counter children (metric-name
        # parity with the reference: src/operators.rs:154-167).
        self._m_inp: Dict[int, Any] = {}
        self._m_out: Dict[int, Any] = {}
        self._m_timers: Dict[str, Any] = {}

    def _timer(self, stem: str, w: Optional[int] = None) -> Any:
        """Cached duration-histogram child for this step (with_timer!
        parity: every user-code call site records its duration,
        src/metrics/mod.rs:8-16).  ``w`` is the worker lane the call
        is attributed to (matching the item counters' label); sites
        without a natural lane use the process's first."""
        if w is None:
            w = self.driver.local_lo
        key = (stem, w)
        h = self._m_timers.get(key)
        if h is None:
            from bytewax_tpu_torch._metrics import DURATION_HISTOGRAMS

            h = DURATION_HISTOGRAMS[stem].labels(self.op.step_id, str(w))
            self._m_timers[key] = h
        return h

    def _count_inp(self, w: int, n: int) -> None:
        c = self._m_inp.get(w)
        if c is None:
            from bytewax_tpu_torch._metrics import item_inp_count

            c = item_inp_count.labels(self.op.step_id, str(w))
            self._m_inp[w] = c
        c.inc(n)
        # Flow map: ledger-style dict add at a point the per-batch
        # path already touches (main thread only; sealed per epoch).
        _flowmap.FLOWMAP.add_rows(self.op.step_id, "in", n)

    def _count_out(self, w: int, n: int) -> None:
        c = self._m_out.get(w)
        if c is None:
            from bytewax_tpu_torch._metrics import item_out_count

            c = item_out_count.labels(self.op.step_id, str(w))
            self._m_out[w] = c
        c.inc(n)
        _flowmap.FLOWMAP.add_rows(self.op.step_id, "out", n)

    def queued(self) -> bool:
        return any(q for q in self.queues.values())

    def ups_eof(self) -> bool:
        ups = self.op.up_streams()
        return all(
            self.driver.rts[self.driver.plan.producer[s.stream_id]].eof
            for s in ups
        )

    def drain(self) -> None:
        if not any(self.queues.values()):
            return
        # Ledger: everything the main thread does to move this step's
        # queued deliveries (routing, host folds, pipeline submits) is
        # the "host" phase; nested leaf phases (flush stalls, restores,
        # evictions, readbacks) subtract so the sums stay disjoint.
        with _flight.phase("host", self.op.step_id):
            for port, q in self.queues.items():
                if q:
                    entries, self.queues[port] = q, []
                    for w, items in entries:
                        self._count_inp(w, len(items))
                    if self.driver.trace_ops:
                        # Per-activation spans, like the reference's
                        # debug_span!("operator") (src/operators.rs:184) —
                        # only when a backend/DEBUG logging wants them.
                        with _span(
                            "operator",
                            step_id=self.op.step_id,
                            port=port,
                            entries=len(entries),
                        ):
                            self.process(port, entries)
                    else:
                        self.process(port, entries)

    def process(self, port: str, entries: List[Entry]) -> None:
        raise NotImplementedError()

    def advance(self, now: datetime) -> None:
        """Timer-driven work (notify wakeups); default none."""

    def on_upstream_eof(self) -> None:
        """All upstreams are EOF and queues are drained."""

    def emit(self, port: str, entry: Entry) -> None:
        if not len(entry[1]):
            return
        self._count_out(entry[0], len(entry[1]))
        stream = self.op.downs[port]
        _flowmap.FLOWMAP.add_edge(stream.stream_id, len(entry[1]))
        self.driver.route(stream.stream_id, entry)

    # -- epoch snapshot hooks ---------------------------------------------

    def pipeline_flush(self) -> None:
        """Drain this op's device-dispatch pipeline (no-op for ops
        without one).  The driver calls it before every globally-
        ordered point that reads state or syncs — epoch close, the
        EOF ladder — so no snapshot or gsync round can observe a step
        mid-pipeline."""

    def pre_close(self) -> None:
        """Runs at the start of every epoch close, before snapshots —
        on every cluster process, in the same global order (the
        close_epoch broadcast serializes it), so collective device
        steps (the global-mesh exchange flush) may run here."""

    def epoch_snaps(self) -> List[Tuple[str, Optional[Any]]]:
        """Return (state_key, state-or-None) changed this epoch."""
        return []

    def epoch_forget(self) -> None:
        """Close an epoch with no recovery store: forget what changed
        in it (by default by building the snapshots, as a store would
        take them)."""
        self.epoch_snaps()

    def close(self) -> None:
        """Shutdown cleanup at clean EOF."""


class _InputRt(_OpRt):
    def __init__(self, op: Operator, driver: "_Driver"):
        super().__init__(op, driver)
        source = op.conf["source"]
        self.step_id = op.step_id
        self.parts: Dict[str, Any] = {}
        self.part_worker: Dict[str, int] = {}
        self.next_awake: Dict[str, Optional[datetime]] = {}
        self.pending_snaps: List[Tuple[str, Any]] = []
        # Adaptive micro-batch coalescing (engine/batching.py): keep
        # polling a ready partition within ONE poll pass until the
        # accumulated delivery reaches the target row count, merging
        # compatible consecutive batches.  Armed by default only when
        # the plan routes this input to a device-tier step (the
        # flatten pass's _accel_bound annotation); 0 = off.  Never
        # crosses a poll boundary, so snapshots still cover every
        # emitted row and an idle source ships immediately.
        self.coalesce_rows = _batching.coalesce_target(
            bool(op.conf.get("_accel_bound")) and driver.accel
        )
        #: Exceptions raised by a coalescing (non-first) next_batch
        #: call, re-raised at this partition's NEXT poll — the rows
        #: accumulated before it must flow (and be processed) first,
        #: exactly as they would have without coalescing.
        self._deferred: Dict[str, BaseException] = {}
        # -- connector-edge resilience (docs/recovery.md) -----------------
        #: Consecutive transient poll failures per partition (the I/O
        #: retry ladder; reset by any successful poll).
        self._io_fails: Dict[str, int] = {}
        self._last_io_error: Dict[str, str] = {}
        #: Partitions parked by quarantine: retry budget spent,
        #: snapshot frozen at the last good offset, re-probed on a
        #: capped backoff schedule while everything else keeps
        #: flowing.  name -> {since, fails, last_error}.
        self._quarantined: Dict[str, Dict[str, Any]] = {}
        # A fresh runtime has no parked partitions: zero the step's
        # quarantine gauge so a partition parked by a PREVIOUS
        # incarnation in this process (supervised restart, live
        # rescale rebuild) never lingers as a phantom — across a
        # rescale its ownership may have moved entirely, and the new
        # owner resumes it from the store's last-good-offset snapshot
        # and re-quarantines it itself if it is still sick.
        _flight.note_quarantine_reset(op.step_id)
        if isinstance(source, FixedPartitionedSource):
            # All processes see the same sorted name set, so the
            # partition→worker assignment is globally consistent;
            # each process builds only the partitions it owns
            # (the reference's assign_primaries: src/timely.rs:572-707).
            names = sorted(set(source.list_parts()))
            for i, name in enumerate(names):
                w = i % driver.worker_count
                if not driver.is_local(w):
                    continue
                resume = driver.resume_state(op.step_id, name)
                try:
                    part = source.build_part(op.step_id, name, resume)
                except BaseException as ex:  # noqa: BLE001
                    _reraise(op.step_id, "`build_part`", ex)
                self.parts[name] = part
                self.part_worker[name] = w
                # Respect the partition's initial schedule (e.g.
                # SimplePollingSource align_to), like the reference
                # does right after build_part (src/inputs.rs:354-362).
                self.next_awake[name] = part.next_awake()
            self.stateful = True
        elif isinstance(source, DynamicSource):
            for w in range(driver.local_lo, driver.local_hi):
                name = f"worker-{w}"
                try:
                    part = source.build(op.step_id, w, driver.worker_count)
                except BaseException as ex:  # noqa: BLE001
                    _reraise(op.step_id, "`build`", ex)
                self.parts[name] = part
                self.part_worker[name] = w
                self.next_awake[name] = part.next_awake()
            self.stateful = False
        else:
            msg = (
                f"source of step {op.step_id!r} must be a "
                "FixedPartitionedSource or DynamicSource; "
                f"got {source!r}"
            )
            raise TypeError(msg)

    def process(self, port: str, entries: List[Entry]) -> None:
        raise AssertionError("input ops have no upstreams")

    def _absorb_poll_fault(
        self, name: str, ex: BaseException, now: datetime
    ) -> None:
        """One transient ``next_batch`` failure on partition ``name``
        (typed :class:`TransientSourceError` or the default
        ``OSError``/timeout classification — see
        :func:`bytewax_tpu_torch.errors.is_transient_io_error`).

        Inside the retry budget, schedules the re-poll via
        ``next_awake`` after a capped jittered exponential backoff —
        non-blocking, so every other partition and the rest of the
        dataflow keep flowing.  Past the budget, either parks the
        partition in quarantine (``BYTEWAX_TPU_QUARANTINE=1``:
        snapshot frozen at the last good offset, re-probed on the
        backoff schedule capped at
        ``BYTEWAX_TPU_QUARANTINE_REPROBE_S``) or escalates a
        restartable :class:`TransientSourceError` into the
        supervisor path.
        """
        driver = self.driver
        step_id = self.op.step_id
        fails = self._io_fails.get(name, 0) + 1
        self._io_fails[name] = fails
        err = f"{type(ex).__name__}: {ex}"
        self._last_io_error[name] = err
        quarantined = name in self._quarantined
        if fails <= driver.io_retries or quarantined:
            cap = (
                driver.quarantine_cap_s
                if quarantined
                else driver.io_backoff_cap_s
            )
            delay = _backoff.backoff_delay(
                driver.io_backoff_s,
                fails,
                rng=driver._io_rng,
                cap=cap,
            )
            if quarantined:
                self._quarantined[name].update(
                    fails=fails, last_error=err
                )
            _flight.note_io_retry(
                step_id,
                "source",
                fails,
                delay,
                type(ex).__name__,
                part=name,
            )
            self.next_awake[name] = now + timedelta(seconds=delay)
            return
        if driver.quarantine:
            delay = _backoff.backoff_delay(
                driver.io_backoff_s,
                fails,
                rng=driver._io_rng,
                cap=driver.quarantine_cap_s,
            )
            self._quarantined[name] = {
                "since": time.monotonic(),
                "fails": fails,
                "last_error": err,
            }
            _flight.note_quarantine(
                step_id, name, len(self._quarantined), fails, err
            )
            self.next_awake[name] = now + timedelta(seconds=delay)
            return
        esc = TransientSourceError(
            f"source partition {name!r} of step {step_id!r} failed "
            f"{fails} consecutive polls (BYTEWAX_TPU_IO_RETRIES="
            f"{driver.io_retries} exhausted); last error: {err}"
        )
        esc.__cause__ = ex
        _reraise(step_id, "`next_batch`", esc)

    def _io_heal(self, name: str) -> None:
        """Any successful poll (even an empty batch) resets the
        partition's retry ladder and lifts its quarantine."""
        if name in self._io_fails:
            del self._io_fails[name]
            self._last_io_error.pop(name, None)
        info = self._quarantined.pop(name, None)
        if info is not None:
            _flight.note_unquarantine(
                self.op.step_id,
                name,
                len(self._quarantined),
                time.monotonic() - info["since"],
            )

    def _drain_dead(self, name: str, part: Any) -> int:
        """Forward connector-captured poison records (partitions with
        a ``drain_dead_letters()`` hook — the ``on_error="dlq"``
        policy) to the driver's dead-letter queue, stamped with the
        CURRENT epoch: the same epoch whose source snapshots cover
        the offsets consumed alongside them, so the DLQ flush/resume
        truncation pairing keeps dead letters exactly-once."""
        drain = getattr(part, "drain_dead_letters", None)
        if drain is None:
            return 0
        dead = drain()
        if dead:
            self.driver.dlq.capture(
                self.op.step_id, name, dead, self.driver.epoch
            )
        return len(dead)

    def source_health(self) -> Dict[str, Any]:
        """Per-partition connector health (the ``/status``
        ``source_health`` section)."""
        out: Dict[str, Any] = {}
        for name in self.parts:
            info = self._quarantined.get(name)
            if info is not None:
                out[name] = {
                    "state": "quarantined",
                    "consecutive_failures": info["fails"],
                    "last_error": info["last_error"],
                    "parked_s": round(
                        time.monotonic() - info["since"], 3
                    ),
                }
            elif self._io_fails.get(name):
                out[name] = {
                    "state": "retrying",
                    "consecutive_failures": self._io_fails[name],
                    "last_error": self._last_io_error.get(name),
                }
            else:
                out[name] = {"state": "ok"}
        return out

    def _coalesce(self, name: str, part: Any, first: Any, now: datetime):
        """Keep polling one ready partition until the accumulated
        delivery reaches the coalescing target (or the source goes
        quiet), grouping consecutive compatible batches; returns the
        ordered list of (merged) batches to emit.  An exception from
        a non-first call is deferred to the partition's next poll so
        the rows gathered before it flow first."""
        groups: List[List[Any]] = [[first]]
        rows = len(first)
        target = self.coalesce_rows
        polls = 0
        timer = self._timer(
            "inp_part_next_batch", self.part_worker.get(name)
        )
        while rows < target and polls < _batching.COALESCE_MAX_POLLS:
            na = part.next_awake()
            if na is not None and na > now:
                break
            polls += 1
            try:
                # Every next_batch call is behind the pinned site —
                # coalescing polls included, so chaos soaks cover the
                # deferred-transient path too.  An injected error
                # here defers like any coalescing-poll failure: the
                # rows already gathered flow first.
                _faults.fire(
                    "source_poll", step=self.op.step_id, part=name
                )
                with timer.time():
                    nxt = part.next_batch()
                if not isinstance(nxt, (list, ArrayBatch)):
                    nxt = list(nxt)
            except BaseException as ex:  # noqa: BLE001
                # Includes StopIteration (EOF) and AbortExecution:
                # both re-raise at the next poll, after this pass's
                # rows were processed — matching the uncoalesced
                # engine's ordering exactly.
                self._deferred[name] = ex
                break
            if not len(nxt):
                break
            if _batching.can_merge(groups[-1][-1], nxt):
                groups[-1].append(nxt)
            else:
                groups.append([nxt])
            rows += len(nxt)
        if polls:
            _flight.RECORDER.count("ingest_coalesced_polls", polls)
        return [_batching.merge_batches(g) for g in groups]

    def poll(self, now: datetime) -> bool:
        progressed = False
        polled = False
        t0 = time.monotonic()
        rng = _flight.open_range("ingest")
        try:
            for name in list(self.parts.keys()):
                part = self.parts[name]
                na = self.next_awake[name]
                if na is not None and na > now:
                    continue
                polled = True
                deferred = self._deferred.pop(name, None)
                if deferred is not None:
                    if isinstance(deferred, StopIteration):
                        self._drain_dead(name, part)
                        # An EOFing partition leaves the health map:
                        # clear any retry/quarantine state so the
                        # gauge doesn't report a phantom parked
                        # partition forever.
                        self._io_heal(name)
                        if self.stateful:
                            self.pending_snaps.append(
                                (name, part.snapshot())
                            )
                        part.close()
                        del self.parts[name]
                        progressed = True
                        continue
                    if isinstance(deferred, AbortExecution):
                        raise _Abort() from None
                    if is_transient_io_error(deferred):
                        # A coalescing poll failed transiently after
                        # its pass's rows flowed: same retry ladder
                        # as a boundary-poll failure.
                        self._absorb_poll_fault(name, deferred, now)
                        continue
                    _reraise(self.op.step_id, "`next_batch`", deferred)
                try:
                    # The pinned connector-edge fault site: fired
                    # before the poll touches the source, so an
                    # injected transient error consumed nothing and
                    # the retry is exact (docs/recovery.md).
                    _faults.fire(
                        "source_poll", step=self.op.step_id, part=name
                    )
                    with self._timer(
                        "inp_part_next_batch", self.part_worker.get(name)
                    ).time():
                        batch = part.next_batch()
                    if not isinstance(batch, (list, ArrayBatch)):
                        batch = list(batch)
                except StopIteration:
                    self._drain_dead(name, part)
                    # Clear retry/quarantine state on the way out
                    # (see the deferred-EOF branch above).
                    self._io_heal(name)
                    if self.stateful:
                        self.pending_snaps.append((name, part.snapshot()))
                    part.close()
                    del self.parts[name]
                    progressed = True
                    continue
                except AbortExecution:
                    raise _Abort() from None
                except BaseException as ex:  # noqa: BLE001
                    if is_transient_io_error(ex):
                        self._absorb_poll_fault(name, ex, now)
                        continue
                    _reraise(self.op.step_id, "`next_batch`", ex)
                self._io_heal(name)
                emitted = len(batch) > 0
                if emitted:
                    if self.coalesce_rows > 1 and len(batch) < (
                        self.coalesce_rows
                    ):
                        batches = self._coalesce(name, part, batch, now)
                    else:
                        batches = [batch]
                    w = self.part_worker[name]
                    for b in batches:
                        self.emit("down", (w, b))
                        _flight.RECORDER.count(
                            "ingest_rows_columnar"
                            if isinstance(b, ArrayBatch)
                            else "ingest_rows_itemized",
                            len(b),
                        )
                    progressed = True
                    lag = _batch_event_lag_s(batches[-1], now)
                    if lag is not None:
                        _flight.note_source_lag(
                            self.op.step_id, "event_time", lag
                        )
                if self._drain_dead(name, part):
                    # Poison records consumed offsets this pass; make
                    # sure an epoch closes over them promptly so the
                    # DLQ flush pairs with the covering snapshot.
                    progressed = True
                if name in self._deferred:
                    # Deliver the deferred raise promptly.
                    part_na: Optional[datetime] = None
                else:
                    part_na = part.next_awake()
                    if part_na is None and not emitted:
                        part_na = now + _EMPTY_COOLDOWN
                self.next_awake[name] = part_na
        finally:
            _flight.close_range(rng)
            if polled:
                _flight.note_phase(
                    "ingest",
                    self.op.step_id,
                    time.monotonic() - t0,
                    t0=t0,
                )
        if not self.parts:
            self.eof = True
        return progressed

    def next_poll_at(self) -> Optional[datetime]:
        times = [t for t in self.next_awake.values() if t is not None]
        if len(times) < len(self.parts):
            return None  # some part is ready now
        return min(times) if times else None

    def epoch_snaps(self) -> List[Tuple[str, Optional[Any]]]:
        if not self.stateful:
            return []
        snaps, self.pending_snaps = self.pending_snaps, []
        for name, part in self.parts.items():
            try:
                with self._timer(
                    "snapshot", self.part_worker.get(name)
                ).time():
                    snaps.append((name, part.snapshot()))
            except BaseException as ex:  # noqa: BLE001
                _reraise(self.op.step_id, "`snapshot`", ex)
        return snaps

    def close(self) -> None:
        for part in self.parts.values():
            part.close()
        self.parts.clear()
        if self._quarantined:
            # Runtime teardown (graceful stop, live-rescale rebuild):
            # the parked set dies with this runtime — its last good
            # offsets are already in the store (epoch snapshots cover
            # frozen partitions every close), so the NEXT owner
            # resumes each partition from there.  Zero the gauge so
            # the old owner never reports a phantom parked partition.
            self._quarantined.clear()
            _flight.note_quarantine_reset(self.op.step_id)


class _FlatMapBatchRt(_OpRt):
    def __init__(self, op: Operator, driver: "_Driver"):
        super().__init__(op, driver)
        self.mapper: Callable = op.conf["mapper"]

    def process(self, port: str, entries: List[Entry]) -> None:
        for w, items in entries:
            try:
                with self._timer("flat_map_batch", w).time(), _flight.span(
                    "mapper"
                ):
                    out = self.mapper(items)
                if not isinstance(out, (list, ArrayBatch)):
                    out = list(out)
            except BaseException as ex:  # noqa: BLE001
                _reraise(self.op.step_id, "the mapper", ex, self.mapper)
            self.emit("down", (w, out))


class _BranchRt(_OpRt):
    def __init__(self, op: Operator, driver: "_Driver"):
        super().__init__(op, driver)
        self.predicate: Callable = op.conf["predicate"]

    def process(self, port: str, entries: List[Entry]) -> None:
        for w, items in entries:
            if isinstance(items, ArrayBatch):
                items = items.to_pylist()
            trues, falses = [], []
            for item in items:
                try:
                    keep = self.predicate(item)
                except BaseException as ex:  # noqa: BLE001
                    _reraise(self.op.step_id, "the predicate", ex, self.predicate)
                (trues if keep else falses).append(item)
            self.emit("trues", (w, trues))
            self.emit("falses", (w, falses))


class _MergeRt(_OpRt):
    def process(self, port: str, entries: List[Entry]) -> None:
        for entry in entries:
            self.emit("down", entry)


class _RedistributeRt(_OpRt):
    def __init__(self, op: Operator, driver: "_Driver"):
        super().__init__(op, driver)
        self._rr = 0

    def process(self, port: str, entries: List[Entry]) -> None:
        driver = self.driver
        w_count = driver.worker_count
        stream_id = self.op.downs["down"].stream_id

        def dispatch(w: int, group: Any) -> None:
            if driver.is_local(w):
                self.emit("down", (w, group))
            else:
                self._count_out(w, len(group))
                driver.ship_route(stream_id, (w, group))

        for _w, items in entries:
            n = len(items)
            if not n:
                continue
            start = self._rr
            self._rr = (start + n) % w_count
            if isinstance(items, ArrayBatch):
                # Columnar rebalance: strided column views per lane —
                # the batch stays columnar through the rebalance.
                for w in range(w_count):
                    off = (w - start) % w_count
                    if off >= n:
                        continue
                    dispatch(
                        w,
                        ArrayBatch(
                            {
                                name: np.asarray(col)[off::w_count]
                                for name, col in items.cols.items()
                            },
                            key_vocab=items.key_vocab,
                            value_scale=items.value_scale,
                        ),
                    )
                continue
            # Item i of this delivery goes to lane (start + i) %
            # w_count; one C-level slice per lane instead of a Python
            # append per item.
            for w in range(w_count):
                off = (w - start) % w_count
                if off >= n:
                    continue
                dispatch(w, items[off::w_count])


class _InspectDebugRt(_OpRt):
    def __init__(self, op: Operator, driver: "_Driver"):
        super().__init__(op, driver)
        self.inspector: Callable = op.conf["inspector"]

    def process(self, port: str, entries: List[Entry]) -> None:
        epoch = self.driver.epoch
        for w, items in entries:
            if isinstance(items, ArrayBatch):
                items = items.to_pylist()
            for item in items:
                try:
                    self.inspector(self.op.step_id, item, epoch, w)
                except BaseException as ex:  # noqa: BLE001
                    _reraise(self.op.step_id, "the inspector", ex, self.inspector)
            self.emit("down", (w, items))


class _NoopRt(_OpRt):
    def process(self, port: str, entries: List[Entry]) -> None:
        for entry in entries:
            self.emit("down", entry)


class _StatefulBatchRt(_OpRt):
    def __init__(self, op: Operator, driver: "_Driver"):
        super().__init__(op, driver)
        self.builder: Callable = op.conf["builder"]
        self.logics: Dict[str, Any] = {}
        self.sched: Dict[str, datetime] = {}
        self.awoken: Set[str] = set()
        # Cached route hashes for columnar cluster splits, per
        # vocabulary lineage (None: this process's own; else the
        # sending peer's, engine/arrays.py PeerVocab): (vocab, hashes).
        self._vh: Dict[Optional[int], Tuple[Any, np.ndarray]] = {}
        # Recognized aggregation shapes fold on device instead of in
        # per-key Python logics (annotated by the flatten-time
        # lowering pass; same snapshots, same EOF emission order).
        self.agg: Optional[DeviceAggState] = None
        self.wagg = None
        self.sagg = None
        #: Device-tier broadcast-params scoring state (``op.infer``
        #: lowering; engine/infer.py).  Only ever non-None on the
        #: :class:`_InferRt` subclass the factory picks for infer
        #: steps.
        self.iagg = None
        #: Consecutive device-dispatch faults on this step; at
        #: ``driver.demote_after`` the step is demoted to the host
        #: tier (state migrated) for the rest of the execution.
        self._dev_faults = 0
        #: Demotion reason once demoted (also surfaced in /status).
        self.demoted: Optional[str] = None
        #: Bounded asynchronous dispatch pipeline (device tiers only;
        #: the collective global-exchange tier stays synchronous).
        self._pipe = None
        #: Latest window notify hint, computed by the deferred device
        #: phase — ``notify_at`` reads worker-owned state, so while
        #: the pipeline holds work the driver consults this instead.
        self._wagg_hint: Optional[datetime] = None
        spec = op.conf.get("_accel")
        if driver.accel:
            from bytewax_tpu_torch.engine.scan_accel import ScanAccelSpec
            from bytewax_tpu_torch.engine.window_accel import WindowAccelSpec

            if isinstance(spec, AccelSpec):
                from bytewax_tpu_torch.engine.sharded_state import (
                    make_agg_state,
                )

                # Keyed aggregation: a mesh-sharded slot table when
                # this process has more than one device, else a
                # single-device one.
                self.agg = make_agg_state(spec.kind, driver=driver)
            elif isinstance(spec, WindowAccelSpec):
                # Sliding/tumbling or session device windower, per
                # the spec subtype.
                self.wagg = spec.make_state()
            elif isinstance(spec, ScanAccelSpec):
                # Per-row-emitting stateful_map lowering (segmented
                # device scan over per-key numeric state).
                self.sagg = spec.make_state()
            elif type(spec).__name__ == "InferAccelSpec" and (
                os.environ.get("BYTEWAX_TPU_INFER_DEVICE", "1") != "0"
            ):
                # Batched model scoring (op.infer): the forward pass
                # over broadcast params on the device.  The knob forces
                # the host numpy apply without disabling every other
                # device tier the flow may carry.
                self.iagg = spec.make_state()
        # Tiered key-state residency (docs/state-residency.md): with
        # BYTEWAX_TPU_STATE_BUDGET set, the keyed-aggregation and scan
        # tiers wrap in a manager that bounds device-resident keys,
        # evicting cold keys to host snapshots / the disk spill store.
        # Unset budget returns the state unchanged (byte-identical
        # engine).  The collective global-exchange tier is excluded
        # inside maybe_wrap, exactly like demotion; the window tier
        # exposes extract/inject but is not driver-evicted yet.  The
        # worker count stamps spilled rows' route column (recovery
        # snaps-format parity).
        self.agg = maybe_wrap(
            op.step_id, self.agg, worker_count=driver.worker_count
        )
        self.sagg = maybe_wrap(
            op.step_id, self.sagg, worker_count=driver.worker_count
        )
        #: The step's residency manager, or None when unbudgeted.
        self._res: Optional[ResidentKeyState] = next(
            (
                s
                for s in (self.agg, self.sagg)
                if isinstance(s, ResidentKeyState)
            ),
            None,
        )
        if (
            self.wagg is not None
            or self.sagg is not None
            or self.iagg is not None
            or (
                self.agg is not None
                and not getattr(self.agg, "global_exchange", False)
            )
        ):
            # Asynchronous double-buffered dispatch: batch N+1's
            # routing/encode overlaps batch N's device phase (fold +
            # readbacks), which runs on the pipeline's worker.  The
            # global-exchange tier is excluded: its flush is a cluster
            # collective and must stay on the globally-ordered path.
            from bytewax_tpu_torch.engine.pipeline import (
                DevicePipeline,
                pipeline_depth,
            )

            # With a residency budget armed the pipeline is capped at
            # depth 2: _dispatch_device's make_room then fully drains
            # before each dispatch, so the manager's resident-key
            # counts (read on this thread in prepare/over_budget) are
            # never stale against a fold still running on the worker —
            # at depth >= 3 a pending fold could alloc keys past the
            # budget unseen.
            depth = (
                min(pipeline_depth(), 2)
                if self._res is not None
                else None
            )
            self._pipe = DevicePipeline(op.step_id, depth=depth)
            _flight.note_pipeline_depth(op.step_id, self._pipe.depth)
        # Stream resumed states in store pages (never materialize the
        # whole keyed state as one dict — reference pages its resume
        # reads too, src/recovery.rs:817-882).  Device state installs
        # per page with one indexed write per field (a per-key load is
        # a device write per key); window state too, a page's open
        # windows at once (the JAX package writes them one window at a
        # time).  Eagerly rebuilding host logics per resumed key keeps
        # EOF-driven emission (fold_final etc.) firing even with no new
        # input (reference: src/operators.rs:976-1006).
        page: List[Tuple[str, Any]] = []
        pager = next(
            (s for s in (self.agg, self.sagg, self.wagg) if s is not None),
            None,
        )
        if type(spec).__name__ != "InferAccelSpec":
            # Infer steps skip the per-key resume walk: their one
            # broadcast-state row restores route-agnostically in
            # _InferRt.__init__ (building a host logic from it here
            # would shadow the params with a bogus keyed state).
            for key, state in driver.iter_resume_states(op.step_id):
                if not driver.is_local(
                    _route_hash(key) % driver.worker_count
                ):
                    continue
                if pager is not None:
                    page.append((key, state))
                    if len(page) >= 4096:
                        pager.load_many(page)
                        page = []
                else:
                    logic = self._build(state)
                    self.logics[key] = logic
                    self._resched(key, logic)
            if page:
                pager.load_many(page)

    # -- dispatch pipeline -------------------------------------------------

    def _pipe_pending(self) -> bool:
        return self._pipe is not None and self._pipe.pending()

    def pipeline_flush(self) -> None:
        """Drain point: block until every in-flight device phase has
        finalized (emissions routed, touched keys absorbed, notify
        hints refreshed).  A fault surfacing here propagates exactly
        like a synchronous device fault would have."""
        if self._pipe is not None:
            self._pipe.flush()

    def _pipe_shutdown(self) -> None:
        if self._pipe is not None:
            self._pipe.drop_pending()
            self._pipe.shutdown()
            self._pipe = None
        # The global tier's overlapped collective lane tears down
        # with the dispatch pipelines (clean exits have already
        # fenced it; a fault unwind runs its sealed rounds out).
        if self.agg is not None:
            lane_shutdown = getattr(self.agg, "lane_shutdown", None)
            if lane_shutdown is not None:
                lane_shutdown()

    pipeline_shutdown = _pipe_shutdown

    def collective_fence(self) -> None:
        """Drain the global tier's overlapped exchange lane (no-op
        for every other tier).  Called from the run-ending epoch
        close — a stop/reconfigure agreement means no next close will
        fence it, so the round must land before teardown."""
        if self.agg is not None:
            fence = getattr(self.agg, "fence", None)
            if fence is not None:
                fence()

    def queued(self) -> bool:
        # In-flight pipeline work counts as queued: the epoch barrier
        # and EOF ladder must not consider this step drained while a
        # device phase (and its pending emissions) is outstanding.
        return super().queued() or self._pipe_pending()

    def drain(self) -> None:
        if self._pipe is not None:
            # Completed device phases finalize without blocking, so
            # emissions keep streaming while the source idles and the
            # pipeline self-drains within a loop iteration of the
            # device going quiet.
            self._pipe.finalize_ready()
        super().drain()

    # -- host logics -------------------------------------------------------

    def _build(self, state: Optional[Any]) -> Any:
        try:
            return self.builder(state)
        except BaseException as ex:  # noqa: BLE001
            _reraise(self.op.step_id, "the logic builder", ex, self.builder)

    def _resched(self, key: str, logic: Any) -> None:
        try:
            with self._timer("stateful_batch_notify_at").time():
                at = logic.notify_at()
        except BaseException as ex:  # noqa: BLE001
            _reraise(self.op.step_id, "`notify_at`", ex)
        if at is not None:
            if at.tzinfo is None:
                msg = (
                    f"`notify_at` return value in step {self.op.step_id!r} "
                    "must be timezone-aware"
                )
                raise ValueError(msg)
            self.sched[key] = at
        else:
            self.sched.pop(key, None)

    def _handle(
        self, key: str, emits: Any, discard: bool, out: Dict[int, List[Any]]
    ) -> None:
        w_home = _route_hash(key) % self.driver.worker_count
        bucket = out.setdefault(w_home, [])
        for x in emits:
            bucket.append((key, x))
        self.awoken.add(key)
        if discard:
            self.logics.pop(key, None)
            self.sched.pop(key, None)
        else:
            logic = self.logics.get(key)
            if logic is not None:
                self._resched(key, logic)

    def _flush(self, out: Dict[int, List[Any]]) -> None:
        for w, items in out.items():
            self.emit("down", (w, items))

    def _batch_dests(
        self, batch: ArrayBatch, w_count: int
    ) -> Optional[np.ndarray]:
        """Per-row home worker of a columnar batch, computed with one
        table lookup (hashes touch unique keys / vocab entries only);
        None when the batch has no key column to route on."""
        if "key_id" in batch.cols and batch.key_vocab is not None:
            vocab = batch.key_vocab
            origin = vocab.origin if isinstance(vocab, PeerVocab) else None
            ref, vh = self._vh.get(origin, (None, None))
            # Identity AND length: a list vocab grown in place keeps
            # its identity (VocabMap deliberately tolerates that), so
            # the hash cache must refresh when the length moves.
            if vocab is not ref or len(vocab) != len(vh):
                arr = np.asarray(vocab)
                prev = len(vh) if vh is not None else 0
                if (
                    prev
                    and len(arr) >= prev
                    # Append-only growth (VocabMap enforces it): the
                    # hashed prefix is reusable — spot-check one
                    # entry, hash only the new suffix.
                    and _route_hash(str(arr[prev - 1])) == vh[prev - 1]
                    and _route_hash(str(arr[0])) == vh[0]
                ):
                    if len(arr) > prev:
                        vh = np.concatenate(
                            [vh, _route_hashes_of(arr[prev:].tolist())]
                        )
                else:
                    vh = _route_hashes_of(arr.tolist())
                self._vh[origin] = (vocab, vh)
            ids = batch.numpy("key_id")
            return (vh % w_count)[ids]
        if "key" in batch.cols:
            keys = batch.numpy("key")
            inverse, uniq = factorize_keys(keys)
            return (_route_hashes_of(uniq.tolist()) % w_count)[inverse]
        return None

    def _split_remote_columnar(
        self, w: int, batch: ArrayBatch, local: List[Entry]
    ) -> bool:
        """Split one columnar delivery by destination process, keeping
        every piece columnar (the device fast path survives the
        cluster exchange); False when the batch can't be routed
        columnar and must degrade to items."""
        driver = self.driver
        dests = self._batch_dests(batch, driver.worker_count)
        if dests is None:
            return False
        local_mask = (dests >= driver.local_lo) & (dests < driver.local_hi)
        if local_mask.all():
            local.append((w, batch))
            return True

        def sub(mask: np.ndarray) -> ArrayBatch:
            return ArrayBatch(
                {name: np.asarray(col)[mask] for name, col in batch.cols.items()},
                key_vocab=batch.key_vocab,
                value_scale=batch.value_scale,
            )

        if local_mask.any():
            local.append((w, sub(local_mask)))
        remote_procs = np.unique(dests[~local_mask] // driver.wpp)
        for proc in remote_procs.tolist():
            lo = proc * driver.wpp
            mask = (dests >= lo) & (dests < lo + driver.wpp)
            driver.ship_deliver(self.idx, "up", (lo, sub(mask)))
        return True

    def _split_remote(self, entries: List[Entry]) -> List[Entry]:
        """In a cluster, re-group each delivery's rows by the home
        worker of their key and ship non-local groups to their owner
        (the reference's routed_exchange, src/timely.rs:806-812);
        returns the locally-owned remainder.  Columnar batches split
        columnar (vectorized destinations, one sub-batch per process);
        item lists bucket in one native pass when available."""
        driver = self.driver
        if driver.comm is None:
            return entries
        if self.agg is not None and getattr(
            self.agg, "global_exchange", False
        ):
            # The global-mesh tier routes rows to their owner shard
            # inside the collective exchange step at epoch close —
            # keyed rows never ride the host TCP mesh (which keeps
            # the control plane and non-columnar traffic only).
            return entries
        w_count = driver.worker_count
        local: List[Entry] = []
        for _w, items in entries:
            if isinstance(items, ArrayBatch):
                if self._split_remote_columnar(_w, items, local):
                    continue
                items = items.to_pylist()
            buckets: Optional[List[List[Any]]] = None
            if type(items) is list:
                try:
                    buckets = _native_bucket_adler(items, w_count)
                except TypeError:
                    # Rows that are not exact str-keyed 2-tuples take
                    # the general loop below for its permissive
                    # unpacking and step-qualified errors.
                    buckets = None
            if buckets is None:
                by_w: Dict[int, List[Any]] = {}
                for item in items:
                    k, _v = _extract_kv(item, self.op.step_id)
                    by_w.setdefault(
                        _route_hash(k) % w_count, []
                    ).append(item)
                buckets = [by_w.get(w, []) for w in range(w_count)]
            for w, group in enumerate(buckets):
                if not group:
                    continue
                if driver.is_local(w):
                    local.append((w, group))
                else:
                    driver.ship_deliver(self.idx, "up", (w, group))
        return local

    def _emit_window_events(self, events: List[Tuple[str, Any]]) -> None:
        out: Dict[int, List[Any]] = {}
        w_count = self.driver.worker_count
        for key, ev in events:
            out.setdefault(_route_hash(key) % w_count, []).append((key, ev))
            self.awoken.add(key)
        self._flush(out)

    def _wagg_empty(self) -> bool:
        """Whether the device windower holds no state — including
        anything still in flight on the dispatch pipeline (pending
        device phases imply state; the fold structures they own must
        not be read from this thread while they run)."""
        return not self._pipe_pending() and self.wagg.is_empty()

    def _push_window_task(self, late_events, device_phase) -> None:
        """Route one ingest's deferred device phase (fold + due scan
        + event construction) through the pipeline; finalize emits the
        late and close events downstream in submission order."""
        step_id = self.op.step_id

        def task():
            try:
                return device_phase()
            except DeviceFault:
                raise
            except BaseException as ex:  # noqa: BLE001
                _reraise(step_id, "the device window fold", ex)

        def finalize(res) -> None:
            closes, hint = res
            self._wagg_hint = hint
            self._emit_window_events(late_events + closes)

        if self._pipe is None:
            finalize(task())
        else:
            self._pipe.push(task, finalize)

    def _process_window_accel(self, entries: List[Entry]) -> None:
        assert self.wagg is not None
        for i, (_w, items) in enumerate(entries):
            if (
                isinstance(items, ArrayBatch)
                and "ts" in items.cols
                and (
                    self.wagg.spec.kind == "count"
                    or "value" in items.cols
                )
            ):
                try:
                    with self._timer("stateful_batch_on_batch").time():
                        late, phase = self.wagg.on_batch_columnar(items)
                except BaseException as ex:  # noqa: BLE001
                    _reraise(
                        self.op.step_id, "the device window fold", ex
                    )
                self._push_window_task(late, phase)
                continue
            if isinstance(items, ArrayBatch):
                items = items.to_pylist()
            if type(items) is list and items:
                # Itemized promotion: one native pass turns
                # (key, datetime) / (key, TsValue) rows into id/ts/
                # value columns feeding the vectorized ingest — the
                # same pattern as _process_scan_accel.  Rows that
                # can't promote fall through to the per-item path
                # (or, for numeric folds with no state yet, to the
                # host tier, which re-runs the fold per item with its
                # own step-qualified errors).
                ingest = None
                try:
                    with self._timer("stateful_batch_on_batch").time():
                        ingest = self.wagg.on_batch_items(items)
                except NonNumericValues:
                    if (
                        self.wagg.spec.kind != "count"
                        and self._wagg_empty()
                        and not self.logics
                    ):
                        self.wagg = None
                        # bytewax: allow[BTX-DRAIN] — host-tier fallback teardown: _wagg_empty() just proved the pipeline idle and the windower stateless, so there is nothing to drain
                        self._pipe_shutdown()
                        self.process("up", entries[i:])
                        return
                except BaseException as ex:  # noqa: BLE001
                    _reraise(
                        self.op.step_id, "the device window fold", ex
                    )
                if ingest is not None:
                    self._push_window_task(*ingest)
                    continue
            if (
                self.wagg.spec.kind != "count"
                and self._wagg_empty()
                and not self.logics
            ):
                # Numeric windowed folds with no native toolchain
                # only run on device for columnar key/ts/value
                # batches; itemized deliveries can't promise
                # timestamp-bearing numeric values, so permanently
                # fall back to the host tier before any device state
                # exists.
                self.wagg = None
                # bytewax: allow[BTX-DRAIN] — host-tier fallback teardown: _wagg_empty() just proved the pipeline idle and the windower stateless, so there is nothing to drain
                self._pipe_shutdown()
                self.process("up", entries[i:])
                return
            keys: List[str] = []
            values: List[Any] = []
            for item in items:
                k, v = _extract_kv(item, self.op.step_id)
                keys.append(k)
                values.append(v)
            if not keys:
                continue
            try:
                with self._timer("stateful_batch_on_batch").time():
                    ingest = self.wagg.on_batch(keys, values)
            except BaseException as ex:  # noqa: BLE001
                _reraise(self.op.step_id, "the device window fold", ex)
            self._push_window_task(*ingest)

    def process(self, port: str, entries: List[Entry]) -> None:
        entries = self._split_remote(entries)
        if (
            self.wagg is not None
            or self.agg is not None
            or self.sagg is not None
        ):
            if self._dispatch_device(entries):
                return
            # Demoted mid-delivery: fall through — the host loop
            # below now owns the migrated state and must still take
            # this (already split) delivery.
        out: Dict[int, List[Any]] = {}
        for _w, items in entries:
            if isinstance(items, ArrayBatch):
                items = items.to_pylist()
            groups: Optional[Dict[str, List[Any]]] = None
            if type(items) is list:
                try:
                    # Native one-pass grouping (None when no toolchain).
                    groups = _native_group_kv(items)
                except TypeError:
                    # Rows that are not exact str-keyed 2-tuples take
                    # the general loop for its permissive unpacking
                    # and step-qualified errors.
                    groups = None
            if groups is None:
                groups = {}
                for item in items:
                    k, v = _extract_kv(item, self.op.step_id)
                    groups.setdefault(k, []).append(v)
            for key, values in groups.items():
                logic = self.logics.get(key)
                if logic is None:
                    logic = self._build(None)
                    self.logics[key] = logic
                w_home = _route_hash(key) % self.driver.worker_count
                try:
                    with self._timer(
                        "stateful_batch_on_batch", w_home
                    ).time():
                        emits, discard = logic.on_batch(values)
                except BaseException as ex:  # noqa: BLE001
                    _reraise(self.op.step_id, "`on_batch`", ex)
                self._handle(key, emits, discard, out)
        self._flush(out)

    def _dispatch_device(self, entries: List[Entry]) -> bool:
        """Run one delivery through the device tier, healing flaky
        dispatches: a :class:`DeviceFault` (raised before any device
        state mutates — the injector's contract) is retried in place,
        and ``driver.demote_after`` consecutive faults demote this
        step to the host tier for the rest of the execution.  Returns
        True when the device tier handled the delivery; False after a
        demotion (the caller's host path takes the delivery).

        With the dispatch pipeline armed, the fault site still fires
        on this thread BEFORE the delivery enters the pipeline, and a
        fault surfacing at the ``make_room`` drain point (an in-flight
        device phase failed) lands in this same retry/demotion
        handling."""
        while True:
            # Device-tier dispatch: visible as its own span (nested
            # under the per-activation "operator" span) so OTLP traces
            # show where the device tier starts, and as a ring event.
            _flight.RECORDER.record(
                "device_dispatch",
                step=self.op.step_id,
                entries=len(entries),
            )
            try:
                _faults.fire("device_dispatch", step=self.op.step_id)
                if self._pipe is not None:
                    # Drain point: over-depth device phases finalize
                    # here, BEFORE this delivery is prepared, so a
                    # finalizer that demotes the tier to the host path
                    # (a parked fallback) is observed first.
                    self._pipe.make_room()
                    if (
                        self.wagg is None
                        and self.agg is None
                        and self.sagg is None
                        and self.iagg is None
                    ):
                        return False
                if self.driver.trace_ops:
                    with _span(
                        "device_dispatch", step_id=self.op.step_id
                    ):
                        self._process_device(entries)
                else:
                    self._process_device(entries)
            except DeviceFault as ex:
                self._dev_faults += 1
                if self._dev_faults < self.driver.demote_after:
                    continue  # transient: retry the same delivery
                if self.agg is not None and getattr(
                    self.agg, "global_exchange", False
                ):
                    # The global tier's flush is COLLECTIVE: demoting
                    # one process would leave its peers blocking in
                    # the exchange forever.  Unwind instead — the
                    # supervisor restarts the whole cluster (or run
                    # with BYTEWAX_TPU_GLOBAL_EXCHANGE=0).
                    _reraise(
                        self.op.step_id, "the device aggregation", ex
                    )
                self._demote(str(ex))
                return False
            else:
                self._dev_faults = 0
                if self._res is not None and self._res.over_budget():
                    # Eviction runs only at a drain point: quiesce the
                    # in-flight device phases first so no deferred
                    # fold can reference a reclaimed slot, then demote
                    # this step's coldest keys off device.  Runs in
                    # the try's else arm so an eviction-side error is
                    # never mistaken for a retryable dispatch fault
                    # (the delivery already folded — a retry would
                    # double-count it).
                    # bytewax: allow[BTX-DRAIN] — this IS a drain point: the flush right here quiesces every in-flight phase before the eviction below reclaims slots
                    self.pipeline_flush()
                    # bytewax: allow[BTX-DRAIN] — eviction immediately after the full flush above; the budget check runs post-fold by design (docs/state-residency.md)
                    self._res.evict_to_budget(self.driver.epoch)
                return True

    def _demote(self, reason: str) -> None:
        """Migrate this step's device-tier state into host logics and
        run on the host tier from here on.  Snapshot formats are
        cross-tier interchangeable, so each device snapshot rebuilds
        a host logic exactly as a recovery resume would."""
        # Drain the pipeline first: in-flight device phases must fold
        # and their emissions must route before the state is migrated
        # (``demotion_snapshots()`` reads the very structures the
        # worker owns mid-task).  A fault here unwinds to the
        # supervisor — with the device tier failing repeatedly there
        # is no safe local recovery beyond the restart path.
        self.pipeline_flush()
        self._pipe_shutdown()
        if self.wagg is not None:
            state = self.wagg
            # Keys the device tier touched since the last close must
            # stay snapshot-tracked by the host tier.
            self.awoken.update(state.touched)
        elif self.agg is not None:
            state = self.agg
        else:
            state = self.sagg
        if state is None:
            # A drained finalizer already fell this step back to the
            # host tier (and migrated nothing — fallbacks only fire on
            # empty state); the host path owns it now.
            self.demoted = reason
            _flight.note_demotion(self.op.step_id, reason, 0)
            return
        pairs = state.demotion_snapshots()
        # demotion_snapshots on a residency-managed state drains EVERY
        # tier (resident, evicted, spilled); the host logics own the
        # keys now, so the manager retires with the device state.
        self.wagg = self.agg = self.sagg = None
        self._res = None
        migrated = 0
        for key, snap in pairs:
            if snap is None:
                continue  # empty state: host tier builds on demand
            logic = self._build(snap)
            self.logics[key] = logic
            self._resched(key, logic)
            migrated += 1
        self.demoted = reason
        _flight.note_demotion(self.op.step_id, reason, migrated)

    def _process_device(self, entries: List[Entry]) -> None:
        """Route a delivery to whichever device-tier state this step
        lowered to.  The fallback paths inside may null the state and
        re-enter :meth:`process` for the host tier."""
        if self.wagg is not None:
            self._process_window_accel(entries)
        elif self.agg is not None:
            self._process_accel(entries)
        else:
            self._process_scan_accel(entries)

    def _process_accel(self, entries: List[Entry]) -> None:
        assert self.agg is not None
        if self._res is not None:
            # Residency faults resolve BEFORE dispatch, on this
            # thread: a delivery touching an evicted/spilled key
            # restores it (behind the pinned residency_restore chaos
            # site, which fires before any state mutates — a DeviceFault
            # there unwinds into the retry/demotion handling with the
            # delivery fully replayable).  Restores flush the pipeline
            # first; pure touches are dict updates.
            # bytewax: allow[BTX-DRAIN] — restore-before-dispatch: prepare_entries flushes the pipeline (the callback) before any slot moves, making this call site its own drain point
            self._res.prepare_entries(
                entries, self.driver.epoch, self.pipeline_flush
            )
        if self._pipe is None:
            # The collective global-exchange tier never pipelines: it
            # only buffers here (the exchange runs at the globally-
            # ordered flush), so deferral buys nothing and ordering
            # must stay exact.
            self._accel_finalize(self._accel_fold(self.agg, entries))
            return
        agg = self.agg
        self._pipe.push(
            lambda: self._accel_fold(agg, entries),
            self._accel_finalize,
        )

    def _accel_fold(self, agg, entries: List[Entry]):
        """Device phase of one keyed-aggregation delivery (runs on
        the pipeline worker when deferred): fold every entry into the
        slot table.  Returns ``(touched_keys, fallback_rest,
        parked_error)`` — errors park instead of raising so the
        finalize step can run the exact host-fallback logic on the
        main thread, in submission order."""
        touched_all: List[str] = []
        for i, (_w, items) in enumerate(entries):
            try:
                with self._timer("stateful_batch_on_batch").time():
                    if isinstance(items, ArrayBatch):
                        touched = agg.update_batch(items)
                    else:
                        if not items:
                            continue
                        touched = None
                        if type(items) is list:
                            # One-pass itemized→columnar promotion
                            # (native kv_encode) — no per-item Python
                            # at the accel boundary.  NonNumericValues
                            # (malformed rows / non-numeric values)
                            # parks for the fallback handling in
                            # _accel_finalize; None means no native
                            # toolchain.
                            touched = agg.update_items(items)
                        if touched is None:
                            keys = []
                            values = []
                            for item in items:
                                k, v = _extract_kv(item, self.op.step_id)
                                keys.append(k)
                                values.append(v)
                            touched = agg.update(
                                np.asarray(keys), np.asarray(values)
                            )
            except (NonNumericValues, TypeError) as ex:
                return touched_all, entries[i:], ex
            touched_all.extend(touched)
        return touched_all, None, None

    def _accel_finalize(self, res) -> None:
        """Finalize one keyed-aggregation delivery on the main
        thread: absorb touched keys for snapshot bookkeeping and run
        the fallback/error handling exactly as the synchronous engine
        did."""
        touched, rest, err = res
        self.awoken.update(touched)
        if err is None:
            return
        if isinstance(err, NonNumericValues):
            if self.agg is None:
                # The tier already fell back to the host path while
                # this phase was in flight (only reachable at depth >
                # 2); the unfolded remainder takes the host path too.
                self.process("up", rest)
                return
            if getattr(self.agg, "global_exchange", False):
                # The global tier's flush is COLLECTIVE: a local
                # fallback would leave the peers blocking in the
                # exchange forever.  Fail fast with direction
                # (the raising process's abort broadcast unblocks
                # any peer already waiting in a sync round).
                msg = (
                    f"{err} — the cluster-wide device exchange "
                    "cannot fall back per-process; run this flow "
                    "with BYTEWAX_TPU_GLOBAL_EXCHANGE=0"
                )
                _reraise(
                    self.op.step_id,
                    "the device aggregation",
                    NonNumericValues(msg),
                )
            if (
                not self._pipe_pending()
                and not self.agg.keys()
                and not self.logics
            ):
                # Non-numeric values: permanently fall back to the
                # host tier before any device state exists.  The
                # pending guard mirrors the scan/window tiers: at
                # depth > 2 a newer delivery may already be in flight
                # — its fold implies state, so the silent fallback
                # becomes the step-qualified error below instead of
                # dropping it.  (keys() on a residency-managed state
                # counts evicted/spilled keys too, so the fallback
                # never strands cold state.)
                self.agg = None
                self._res = None
                # bytewax: allow[BTX-DRAIN] — host-tier fallback teardown: the pending/keys/logics guard just proved the pipeline idle and the state empty
                self._pipe_shutdown()
                self.process("up", rest)
                return
        _reraise(self.op.step_id, "the device aggregation", err)

    def _process_scan_accel(self, entries: List[Entry]) -> None:
        assert self.sagg is not None
        if self._res is not None:
            # See _process_accel: restore evicted keys before the
            # delivery dispatches (scan outputs read per-key state, so
            # the restore must land before the fold).
            # bytewax: allow[BTX-DRAIN] — restore-before-dispatch: prepare_entries flushes the pipeline (the callback) before any slot moves, making this call site its own drain point
            self._res.prepare_entries(
                entries, self.driver.epoch, self.pipeline_flush
            )
        for i, (_w, items) in enumerate(entries):
            try:
                with self._timer("stateful_batch_on_batch").time():
                    phase = self._scan_batch(items)
            except NonNumericValues as ex:
                if (
                    not self._pipe_pending()
                    and not self.sagg.keys()
                    and not self.logics
                ):
                    # Rows the device scan can't take (non-numeric
                    # values, malformed tuples): permanently fall
                    # back to the host tier before any device state
                    # exists — it re-runs the mapper per item and
                    # raises the step-qualified errors.  (keys() on a
                    # residency-managed state counts evicted/spilled
                    # keys, so cold state blocks the silent fallback.)
                    self.sagg = None
                    self._res = None
                    # bytewax: allow[BTX-DRAIN] — host-tier fallback teardown: the pending/keys/logics guard just proved the pipeline idle and the state empty
                    self._pipe_shutdown()
                    self.process("up", entries[i:])
                    return
                _reraise(self.op.step_id, "the device scan", ex)
            except TypeError as ex:
                _reraise(self.op.step_id, "the device scan", ex)
            if phase is None:
                continue
            self._push_scan_task(phase)

    def _push_scan_task(self, phase) -> None:
        """Route one delivery's scan phase (segmented device scan +
        output materialization + emission construction) through the
        pipeline; finalize emits the per-row outputs downstream."""
        step_id = self.op.step_id

        def task():
            try:
                return phase()
            except DeviceFault:
                raise
            except BaseException as ex:  # noqa: BLE001
                _reraise(step_id, "the device scan", ex)

        def finalize(res) -> None:
            touched, out_items, uniq, codes = res
            self.awoken.update(touched)
            self._emit_scan(out_items, uniq, codes)

        if self._pipe is None:
            finalize(task())
        else:
            self._pipe.push(task, finalize)

    def _scan_batch(self, items: Any):
        """Host phase of one delivery through the device scan:
        grouping/promotion plus every check that can reject the rows.
        Returns None for an empty delivery, else a zero-arg device
        phase producing ``(touched, out_items, uniq_keys, per-row
        group codes)`` — safe to defer because all
        :class:`NonNumericValues` conditions are decided HERE, on the
        caller's thread, before any device state mutates."""
        from bytewax_tpu_torch.engine.scan_accel import (
            _batch_keys,
            _require_numeric,
        )

        sagg = self.sagg
        if isinstance(items, ArrayBatch):
            keys = _batch_keys(items)
            values = items._scaled_values()
            _require_numeric(values)

            def batch_phase():
                touched, emit = sagg.update(keys, values)
                return touched, emit.items(), emit.uniq, emit.codes

            return batch_phase
        if not items:
            return None
        if type(items) is list:
            try:
                groups = _native_group_kv(items)
            except TypeError as ex:
                raise NonNumericValues(str(ex)) from ex
            if groups is not None:
                vals = np.empty(len(items), dtype=np.float64)
                try:
                    lens = _native_scan_fill(groups, vals)
                except TypeError as ex:
                    raise NonNumericValues(str(ex)) from ex
                uniq = list(groups)

                def grouped_phase():
                    outs = sagg.update_grouped(uniq, lens, vals)
                    try:
                        out_items = _native_scan_emit(
                            groups,
                            tuple(
                                np.ascontiguousarray(o) for o in outs
                            ),
                        )
                    except (TypeError, ValueError):
                        # A kind emitted a column layout the native
                        # emitter doesn't take (odd dtype, >8
                        # columns): the device state is already
                        # updated, so emit in Python rather than fail
                        # the step — matching the no-toolchain
                        # behavior for the same flow.
                        out_items = _py_scan_emit(groups, outs)
                    codes = np.repeat(np.arange(len(lens)), lens)
                    return uniq, out_items, uniq, codes

                return grouped_phase
        # No native toolchain: per-item promotion, Python emission.
        keys = []
        values = []
        for item in items:
            k, v = _extract_kv(item, self.op.step_id)
            keys.append(k)
            values.append(v)
        keys_arr = np.asarray(keys)
        vals_arr = np.asarray(values)
        _require_numeric(vals_arr)

        def item_phase():
            touched, emit = sagg.update(keys_arr, vals_arr)
            return touched, emit.items(), emit.uniq, emit.codes

        return item_phase

    def _emit_scan(
        self, out_items: List[Any], uniq: List[str], codes: np.ndarray
    ) -> None:
        w_count = self.driver.worker_count
        if w_count == 1:
            self.emit("down", (0, out_items))
            return
        dest_u = _route_hashes_of(uniq) % w_count
        dests = dest_u[codes]
        for d in np.unique(dests).tolist():
            idx = np.nonzero(dests == d)[0].tolist()
            self.emit("down", (d, [out_items[j] for j in idx]))

    def advance(self, now: datetime) -> None:
        if self._pipe is not None:
            self._pipe.finalize_ready()
        if self.wagg is not None:
            # While device phases are in flight, the windower's open
            # set belongs to the worker — consult the notify hint the
            # last finalized phase computed instead.
            if self._pipe_pending():
                at = self._wagg_hint
            else:
                at = self.wagg.notify_at()
            if at is not None and at <= now:
                # Window close is a drain point: quiesce the pipeline,
                # then scan/close synchronously as before.  Host-phase
                # ledger time (the flush stall inside subtracts as its
                # own leaf).
                with _flight.phase("host", self.op.step_id):
                    self.pipeline_flush()
                    try:
                        with self._timer(
                            "stateful_batch_on_notify"
                        ).time():
                            events = self.wagg.on_notify()
                    except BaseException as ex:  # noqa: BLE001
                        _reraise(
                            self.op.step_id, "the device window fold", ex
                        )
                    self._emit_window_events(events)
            return
        due = sorted(
            (key for key, at in self.sched.items() if at <= now)
        )
        if not due:
            return
        out: Dict[int, List[Any]] = {}
        for key in due:
            logic = self.logics.get(key)
            if logic is None:
                self.sched.pop(key, None)
                continue
            self.sched.pop(key, None)
            w_home = _route_hash(key) % self.driver.worker_count
            try:
                with self._timer("stateful_batch_on_notify", w_home).time():
                    emits, discard = logic.on_notify()
            except BaseException as ex:  # noqa: BLE001
                _reraise(self.op.step_id, "`on_notify`", ex)
            self._handle(key, emits, discard, out)
        self._flush(out)

    def pre_close(self) -> None:
        # Drain the dispatch pipeline before anything collective: no
        # gsync round may run with this process still mid-pipeline
        # (the driver also flushes every op before the pre_close pass;
        # this keeps the step safe if called directly).
        self.pipeline_flush()
        if self.agg is not None and getattr(
            self.agg, "global_exchange", False
        ):
            # Collective: every cluster process enters the flush for
            # the same epoch (the close broadcast ordered us here).
            with self._timer("stateful_batch_flush").time():
                self.agg.flush()

    def on_upstream_eof(self) -> None:
        # EOF is a drain point: pending device phases must fold and
        # emit before the EOF emissions below, preserving stream
        # order.
        self.pipeline_flush()
        if self.wagg is not None:
            try:
                with self._timer("stateful_batch_on_eof").time():
                    events = self.wagg.on_eof()
            except BaseException as ex:  # noqa: BLE001
                _reraise(self.op.step_id, "the device window fold", ex)
            self._emit_window_events(events)
            return
        if self.sagg is not None:
            # stateful_map emits per item only; EOF emits nothing and
            # retains state (host-tier StatefulLogic.on_eof default).
            return
        if self.agg is not None:
            out: Dict[int, List[Any]] = {}
            w_count = self.driver.worker_count
            with self._timer("stateful_batch_on_eof").time():
                finalized = self.agg.finalize()
            for key, value in finalized:
                out.setdefault(_route_hash(key) % w_count, []).append(
                    (key, value)
                )
                self.awoken.add(key)  # discard markers at epoch close
            self._flush(out)
            return
        out = {}
        for key in sorted(self.logics.keys()):
            logic = self.logics[key]
            w_home = _route_hash(key) % self.driver.worker_count
            try:
                with self._timer("stateful_batch_on_eof", w_home).time():
                    emits, discard = logic.on_eof()
            except BaseException as ex:  # noqa: BLE001
                _reraise(self.op.step_id, "`on_eof`", ex)
            self._handle(key, emits, discard, out)
        self._flush(out)

    def next_notify_at(self) -> Optional[datetime]:
        if self.wagg is not None:
            if self._pipe_pending():
                return self._wagg_hint
            return self.wagg.notify_at()
        return min(self.sched.values()) if self.sched else None

    def epoch_forget(self) -> None:
        """With no store, a device windower's close only clears which
        keys changed: building their snapshots (a device readback and
        a ``_WindowSnapshot`` a key) would hold the stream for
        seconds at 10^5 open keys, and the windower's watermarks run
        on with the host's time meanwhile, so on-time rows of the next
        batch would turn late."""
        if self.wagg is None:
            self.epoch_snaps()
            return
        self.pipeline_flush()
        self.awoken.clear()
        self.wagg.touched.clear()

    def epoch_snaps(self) -> List[Tuple[str, Optional[Any]]]:
        # Snapshots only ever read post-flush state: the driver
        # drains every pipeline before the close (and the cluster
        # barrier refuses to close while any step reports in-flight
        # work), so this flush is a no-op backstop.
        self.pipeline_flush()
        if self.wagg is not None:
            with self._timer("snapshot").time():
                snaps = self.wagg.snapshots_for(
                    sorted(self.awoken | self.wagg.touched)
                )
            self.awoken.clear()
            self.wagg.touched.clear()
            return snaps
        if self.agg is not None or self.sagg is not None:
            state = self.agg if self.agg is not None else self.sagg
            with self._timer("snapshot").time():
                snaps = state.snapshots_for(sorted(self.awoken))
            self.awoken.clear()
            return snaps
        snaps: List[Tuple[str, Optional[Any]]] = []
        for key in sorted(self.awoken):
            logic = self.logics.get(key)
            if logic is None:
                snaps.append((key, None))
            else:
                w_home = _route_hash(key) % self.driver.worker_count
                try:
                    with self._timer("snapshot", w_home).time():
                        snaps.append((key, logic.snapshot()))
                except BaseException as ex:  # noqa: BLE001
                    _reraise(self.op.step_id, "`snapshot`", ex)
        self.awoken.clear()
        return snaps


class _InferRt(_StatefulBatchRt):
    """Runtime for ``op.infer`` core steps: batched model scoring
    over broadcast params (engine/infer.py, docs/inference.md).

    Unlike every other stateful runtime the state here is BROADCAST —
    one params pytree, identical on every worker — so deliveries are
    never split/re-routed by key (rows score where they land;
    emissions re-route downstream), the per-key resume walk is
    skipped in favor of one route-agnostic ``"_params"`` row, and
    only the row's route owner writes it at epoch close.  The device
    tier (``self.iagg``) runs the jitted forward pass on the shared
    dispatch pipeline; demotion and accel-off runs carry the same
    generation to a host numpy apply (``self._host_infer``).  Params
    swaps commit ONLY from the epoch-close agreement
    (:meth:`_Driver._apply_params_swap`) — a drain point, so no
    in-flight device phase can observe a half-installed tree.
    """

    def __init__(self, op: Operator, driver: "_Driver"):
        super().__init__(op, driver)
        from bytewax_tpu_torch.engine.infer import PARAMS_KEY

        self.spec = op.conf["_accel"]
        #: Host-tier scorer: live from the start when the device tier
        #: is off (accel disabled / BYTEWAX_TPU_INFER_DEVICE=0), else
        #: built at demotion from the device snapshot.
        self._host_infer = (
            None
            if self.iagg is not None
            else self.spec.make_host_state()
        )
        #: (epoch, digest) of the last committed swap, for /status.
        self.last_swap: Optional[Tuple[int, str]] = None
        snap = driver.resume_state(op.step_id, PARAMS_KEY)
        if snap is not None:
            self._holder().load_state(snap)
            #: True while the live params lack a durable snaps row.
            self._params_dirty = False
        else:
            # Fresh run: write the generation-0 row at the first
            # close so resume restores the exact initial params.
            self._params_dirty = True
        _flight.note_params_generation(
            op.step_id, self._holder().generation
        )

    def _holder(self):
        """The live params holder — whichever tier owns scoring."""
        return self.iagg if self.iagg is not None else self._host_infer

    def process(self, port: str, entries: List[Entry]) -> None:
        # NO _split_remote: scoring is stateless per row over
        # broadcast params, so rows score wherever they land and only
        # the OUTPUT re-routes by key (downstream keyed steps still
        # see correctly-routed deliveries).
        if self.iagg is not None:
            if self._dispatch_device(entries):
                return
            # Demoted mid-delivery: the host apply (seeded from the
            # device snapshot) takes this same delivery.
        self._process_host(entries)

    def _process_device(self, entries: List[Entry]) -> None:
        assert self.iagg is not None
        for _w, items in entries:
            try:
                with self._timer("stateful_batch_on_batch").time():
                    phase = self._infer_batch(items)
            except NonNumericValues as ex:
                _reraise(self.op.step_id, "the infer features", ex)
            except TypeError as ex:
                _reraise(self.op.step_id, "the infer features", ex)
            if phase is None:
                continue
            self._push_infer_task(phase)

    def _infer_batch(self, items: Any):
        """Host phase of one delivery: feature extraction plus every
        check that can reject the rows runs HERE, on the caller's
        thread, before anything enters the pipeline.  Returns None
        for an empty delivery, else a zero-arg sealed device phase
        producing ``(keys, out_items)``."""
        from bytewax_tpu_torch.engine.infer import (
            assemble_items,
            extract_features,
        )

        keys, feats = extract_features(items)
        if not len(keys):
            return None
        iagg = self.iagg

        def batch_phase():
            cols = iagg.score_rows(feats)
            return keys, assemble_items(keys, cols)

        return batch_phase

    def _push_infer_task(self, phase) -> None:
        """Route one delivery's scoring phase (padded jitted forward
        pass + readback + output assembly) through the pipeline;
        finalize emits the per-row outputs downstream."""
        step_id = self.op.step_id

        def task():
            try:
                return phase()
            except DeviceFault:
                raise
            except BaseException as ex:  # noqa: BLE001
                _reraise(step_id, "the model apply", ex)

        def finalize(res) -> None:
            keys, out_items = res
            _flight.note_infer_rows(step_id, len(out_items))
            self._emit_infer(keys, out_items)

        if self._pipe is None:
            finalize(task())
        else:
            self._pipe.push(task, finalize)

    def _process_host(self, entries: List[Entry]) -> None:
        from bytewax_tpu_torch.engine.infer import (
            assemble_items,
            extract_features,
        )

        for _w, items in entries:
            try:
                with self._timer("stateful_batch_on_batch").time():
                    keys, feats = extract_features(items)
                    if not len(keys):
                        continue
                    cols = self._host_infer.score_rows(feats)
            except NonNumericValues as ex:
                _reraise(self.op.step_id, "the infer features", ex)
            except TypeError as ex:
                _reraise(self.op.step_id, "the infer features", ex)
            except BaseException as ex:  # noqa: BLE001
                _reraise(self.op.step_id, "the model apply", ex)
            out_items = assemble_items(keys, cols)
            _flight.note_infer_rows(self.op.step_id, len(out_items))
            self._emit_infer(keys, out_items)

    def _emit_infer(self, keys, out_items: List[Any]) -> None:
        """Emit scored rows, re-routed by key hash (the input was
        taken wherever it landed, so routing correctness for any
        keyed consumer downstream is restored here)."""
        w_count = self.driver.worker_count
        if w_count == 1:
            self.emit("down", (0, out_items))
            return
        dests = _route_hashes_of(list(keys)) % w_count
        for d in np.unique(dests).tolist():
            idx = np.nonzero(dests == d)[0].tolist()
            self.emit("down", (d, [out_items[j] for j in idx]))

    def _demote(self, reason: str) -> None:
        """Demote scoring to the host numpy apply, carrying the
        broadcast params across tiers through the same snapshot
        format recovery uses — the params generation survives
        demotion exactly."""
        from bytewax_tpu_torch.engine.infer import PARAMS_KEY

        self.pipeline_flush()
        self._pipe_shutdown()
        pairs = dict(self.iagg.demotion_snapshots())
        self.iagg = None
        self._host_infer = self.spec.make_host_state(
            pairs.get(PARAMS_KEY)
        )
        self.demoted = reason
        _flight.note_demotion(self.op.step_id, reason, 1)

    def install_params(
        self, params: Any, digest: str, epoch: int
    ) -> bool:
        """Install an agreed params update into whichever tier is
        live.  Called ONLY from the epoch-close swap commit (a drain
        point — the pipeline is quiesced, so no in-flight phase reads
        the tree mid-swap).  False (tree mismatch) leaves the
        incumbent params untouched."""
        holder = self._holder()
        ok = holder.install(params, digest, epoch)
        if ok:
            self._params_dirty = True
            self.last_swap = (epoch, digest)
            _flight.note_params_swap(
                self.op.step_id, epoch, digest, holder.generation
            )
        return ok

    def live_tier(self) -> str:
        """Which tier scores right now (the /graph overlay hook)."""
        return "device" if self.iagg is not None else "host"

    def infer_status(self) -> Dict[str, Any]:
        holder = self._holder()
        return {
            "tier": self.live_tier(),
            "generation": holder.generation,
            "digest": holder.digest,
            "last_swap": (
                list(self.last_swap) if self.last_swap else None
            ),
        }

    def epoch_snaps(self) -> List[Tuple[str, Optional[Any]]]:
        # Same backstop as the base: snapshots only read post-flush
        # state.
        self.pipeline_flush()
        self.awoken.clear()
        if not self._params_dirty:
            return []
        from bytewax_tpu_torch.engine.infer import PARAMS_KEY

        # Broadcast state: every process holds identical params, so
        # exactly one row is durable — written by the key's route
        # owner (the store route-stamps rows by key hash; resume
        # reads the row back route-agnostically on every process).
        self._params_dirty = False
        owner = _route_hash(PARAMS_KEY) % self.driver.worker_count
        if not self.driver.is_local(owner):
            return []
        with self._timer("snapshot").time():
            return [(PARAMS_KEY, self._holder().snapshot_state())]


def _stateful_batch_rt(op: Operator, driver: "_Driver"):
    """Runtime factory for core ``stateful_batch`` steps: infer-
    annotated steps get the dedicated broadcast-params runtime (it
    owns BOTH tiers — the host fallback logic in
    operators/inference.py exists only as a safety net), everything
    else the generic per-key runtime."""
    if type(op.conf.get("_accel")).__name__ == "InferAccelSpec":
        return _InferRt(op, driver)
    return _StatefulBatchRt(op, driver)


class _OutputRt(_OpRt):
    def __init__(self, op: Operator, driver: "_Driver"):
        super().__init__(op, driver)
        sink = op.conf["sink"]
        self.parts: Dict[str, Any] = {}
        self.pending_snaps: List[Tuple[str, Any]] = []
        if isinstance(sink, FixedPartitionedSink):
            self.stateful = True
            # Keep the sink's declared order (dedup only): part_fn
            # indexes into this list, so sorting would break the
            # assign_file -> file_namer correspondence for >=10 parts.
            self.part_names = list(dict.fromkeys(sink.list_parts()))
            if not self.part_names:
                msg = f"sink of step {op.step_id!r} has no partitions"
                raise ValueError(msg)
            self.part_fn = sink.part_fn
            # The default part_fn is adler32-of-key, which the native
            # bucketer computes in one pass over the whole delivery —
            # the reference flags this exact per-item exchange closure
            # as a hot spot (src/outputs.rs:189-198).
            # Compare the bound method's underlying function so an
            # instance-level part_fn override is respected (a plain
            # function assigned on the instance has no __func__).
            self._default_part_fn = (
                getattr(sink.part_fn, "__func__", None)
                is FixedPartitionedSink.part_fn
            )
            self.part_owner = {
                name: i % driver.worker_count
                for i, name in enumerate(self.part_names)
            }
            for name in self.part_names:
                if not driver.is_local(self.part_owner[name]):
                    continue
                resume = driver.resume_state(op.step_id, name)
                try:
                    self.parts[name] = sink.build_part(
                        op.step_id, name, resume
                    )
                except BaseException as ex:  # noqa: BLE001
                    _reraise(op.step_id, "`build_part`", ex)
        elif isinstance(sink, DynamicSink):
            self.stateful = False
            for w in range(driver.local_lo, driver.local_hi):
                try:
                    self.parts[f"worker-{w}"] = sink.build(
                        op.step_id, w, driver.worker_count
                    )
                except BaseException as ex:  # noqa: BLE001
                    _reraise(op.step_id, "`build`", ex)
        else:
            msg = (
                f"sink of step {op.step_id!r} must be a "
                f"FixedPartitionedSink or DynamicSink; got {sink!r}"
            )
            raise TypeError(msg)

    def _write_retry(
        self,
        name: str,
        worker: Optional[int],
        write: Callable[[], None],
    ) -> None:
        """Run one sink ``write_batch`` through the connector-edge
        retry ladder (docs/recovery.md): typed
        :class:`TransientIOError` failures are retried in place with
        capped jittered exponential backoff — strictly before this
        epoch's snapshot commit, so exactly-once output is untouched.
        ONLY the typed family retries here (unlike the source side's
        broad ``OSError`` classification): a retried ``write_batch``
        sees the same values again, and only a sink that raises the
        typed error has opted into the nothing-durably-written /
        deduplicating contract that makes the re-send safe — a plain
        mid-batch ``OSError`` may have landed half the rows, so it
        keeps unwinding to the supervisor and the truncating-sink
        replay.  Exhaustion escalates a restartable
        :class:`TransientSinkError` to the supervisor path; the
        pinned ``sink_write`` fault site fires before every attempt.
        """
        driver = self.driver
        step_id = self.op.step_id
        ladder = _backoff.Backoff(
            driver.io_backoff_s,
            cap=driver.io_backoff_cap_s,
            rng=driver._io_rng,
        )
        while True:
            try:
                _faults.fire("sink_write", step=step_id, part=name)
                with self._timer(
                    "out_part_write_batch", worker
                ).time():
                    write()
                return
            except BaseException as ex:  # noqa: BLE001
                if not isinstance(ex, TransientIOError):
                    _reraise(step_id, "`write_batch`", ex)
                delay = ladder.next_delay()
                if ladder.failures > driver.io_retries:
                    esc = TransientSinkError(
                        f"sink partition {name!r} of step "
                        f"{step_id!r} failed {ladder.failures} "
                        "consecutive writes (BYTEWAX_TPU_IO_RETRIES="
                        f"{driver.io_retries} exhausted); last "
                        f"error: {type(ex).__name__}: {ex}"
                    )
                    esc.__cause__ = ex
                    _reraise(step_id, "`write_batch`", esc)
                _flight.note_io_retry(
                    step_id,
                    "sink",
                    ladder.failures,
                    delay,
                    type(ex).__name__,
                    part=name,
                )
                time.sleep(delay)

    def process(self, port: str, entries: List[Entry]) -> None:
        if self.stateful:
            driver = self.driver
            count = len(self.part_names)
            for _w, items in entries:
                if isinstance(items, ArrayBatch):
                    items = items.to_pylist()
                buckets: Dict[str, List[Any]] = {}
                ship: Dict[int, List[Any]] = {}
                groups: Optional[List[List[Any]]] = None
                if self._default_part_fn and type(items) is list:
                    try:
                        # One native pass replaces a part_fn call per
                        # item for the default adler32 routing.
                        groups = _native_bucket_adler(items, count)
                    except TypeError:
                        groups = None
                if groups is not None:
                    for idx, group in enumerate(groups):
                        if not group:
                            continue
                        name = self.part_names[idx]
                        owner = self.part_owner[name]
                        if driver.is_local(owner):
                            buckets[name] = [item[1] for item in group]
                        else:
                            ship.setdefault(owner, []).extend(group)
                else:
                    for item in items:
                        k, v = _extract_kv(item, self.op.step_id)
                        try:
                            idx = self.part_fn(k) % count
                        except BaseException as ex:  # noqa: BLE001
                            _reraise(self.op.step_id, "`part_fn`", ex)
                        name = self.part_names[idx]
                        owner = self.part_owner[name]
                        if driver.is_local(owner):
                            buckets.setdefault(name, []).append(v)
                        else:
                            # Ship the original (key, value) item to
                            # the partition's owner; it re-runs
                            # part_fn there.
                            ship.setdefault(owner, []).append(item)
                for owner, group in ship.items():
                    driver.ship_deliver(self.idx, "up", (owner, group))
                for name, values in buckets.items():
                    self._write_retry(
                        name,
                        self.part_owner[name],
                        lambda part=self.parts[name], values=values: (
                            part.write_batch(values)
                        ),
                    )
        else:
            for w, items in entries:
                part = self.parts[f"worker-{w}"]

                def _write(part=part, items=items) -> None:
                    if isinstance(items, ArrayBatch):
                        writer = getattr(
                            part, "write_array_batch", None
                        )
                        if writer is not None:
                            writer(items)
                        else:
                            part.write_batch(items.to_pylist())
                    else:
                        part.write_batch(items)

                self._write_retry(f"worker-{w}", w, _write)

    def epoch_snaps(self) -> List[Tuple[str, Optional[Any]]]:
        if not self.stateful:
            return []
        snaps = []
        for name, part in self.parts.items():
            try:
                with self._timer(
                    "snapshot", self.part_owner[name]
                ).time():
                    snaps.append((name, part.snapshot()))
            except BaseException as ex:  # noqa: BLE001
                _reraise(self.op.step_id, "`snapshot`", ex)
        return snaps

    def close(self) -> None:
        for part in self.parts.values():
            part.close()
        self.parts.clear()


_RT_FOR = {
    "input": _InputRt,
    "flat_map_batch": _FlatMapBatchRt,
    "branch": _BranchRt,
    "merge": _MergeRt,
    "redistribute": _RedistributeRt,
    "inspect_debug": _InspectDebugRt,
    "stateful_batch": _stateful_batch_rt,
    "output": _OutputRt,
    "_noop": _NoopRt,
}


class _Driver:
    def __init__(
        self,
        flow: Dataflow,
        *,
        worker_count: int,
        epoch_interval: Optional[timedelta],
        recovery_config: Optional[Any],
        addresses: Optional[List[str]] = None,
        proc_id: int = 0,
        generation: int = 0,
        force_rescale: bool = False,
    ):
        self.plan: Plan = flatten(flow)
        #: Supervised-restart generation; tags every cluster frame so
        #: traffic from a dead generation is fenced (see engine/comm).
        self.generation = generation
        #: The configured cluster address list (empty when meshless);
        #: the live-reconfigure agreement compares pending targets
        #: against this so a stale request for the CURRENT shape is a
        #: no-op instead of a pointless rebuild.
        self.addresses: List[str] = list(addresses) if addresses else []
        # ``worker_count`` is per process; lanes are globally
        # numbered so keyed routing is identical on every process.
        self.wpp = worker_count
        self.proc_id = proc_id
        self.proc_count = len(addresses) if addresses else 1
        if not 0 <= proc_id < self.proc_count:
            msg = (
                f"process id {proc_id} is out of range for a cluster "
                f"of {self.proc_count} address(es)"
            )
            raise ValueError(msg)
        self.worker_count = worker_count * self.proc_count
        self.local_lo = proc_id * worker_count
        self.local_hi = self.local_lo + worker_count
        # API-server port offset: this process's rank among processes
        # on the SAME host, so co-located processes (localhost
        # testing) don't collide while one-process-per-host
        # deployments (k8s StatefulSets) keep the fixed configured
        # port on every pod.
        self.api_port_offset = 0
        if addresses:
            host = addresses[proc_id].rpartition(":")[0]
            self.api_port_offset = sum(
                1
                for a in addresses[:proc_id]
                if a.rpartition(":")[0] == host
            )
        # Arm the chaos injector for this process before any site can
        # fire (the mesh handshake below is the first hot path).
        _faults.configure(proc_id)
        self.comm = None
        if self.proc_count > 1:
            from bytewax_tpu_torch.engine.comm import Comm

            self.comm = Comm(addresses, proc_id, generation=generation)
        #: Per peer, the tagged views of the vocabularies its columnar
        #: frames carried lately (``_from_peer``).
        self._peer_vocabs: Dict[int, List[Tuple[Any, PeerVocab]]] = {}
        #: Per-peer coalescing of ship_route slices (engine/wire.py;
        #: docs/performance.md "Columnar exchange"): same-(peer,
        #: stream, lane) slices merge under the ingest coalescer's
        #: can_merge rules and ship as one frame at ship_flush —
        #: called at every poll boundary and before every drain
        #: point, so the count-matched barrier sees exactly the
        #: frames that hit the wire.  ``BYTEWAX_TPU_WIRE=pickle``
        #: restores the legacy wire wholesale — whole-frame pickle
        #: AND one frame per routed slice — which is also the
        #: comparison baseline bench.py measures.
        self._ship_acc = (
            _wire.RouteAccumulator()
            if self.comm is not None
            and _wire.wire_mode() == "columnar"
            else None
        )
        self.sent = [0] * self.proc_count
        self.rcvd = [0] * self.proc_count
        #: gsync frames from peers ahead of this process's sync round.
        self._gsync_stash: Dict[Any, List[Tuple[int, Any]]] = {}
        #: data/control frames received mid-sync, replayed by _pump.
        self._pump_stash: List[Tuple[int, Any]] = []
        self._gsync_seq = 0
        worker_count = self.worker_count
        self.epoch_interval = (
            epoch_interval
            if epoch_interval is not None
            else _DEFAULT_EPOCH_INTERVAL
        )
        if self.epoch_interval < timedelta(0):
            msg = "epoch_interval must be non-negative"
            raise ValueError(msg)

        # Device acceleration of recognized aggregations; disable with
        # BYTEWAX_TPU_ACCEL=0 to force the host-tier oracle.
        self.accel = os.environ.get("BYTEWAX_TPU_ACCEL", "1") != "0"

        # Per-operator activation spans only when someone is looking.
        self.trace_ops = _spans_active()

        # BYTEWAX_TPU_PLATFORM picks the torch device the device tier
        # builds its state on (utils.device): unset means cuda:0, and
        # ``cpu`` runs it on the CPU.  Validated here so a typo fails
        # at startup rather than at the first device step.
        plat = os.environ.get("BYTEWAX_TPU_PLATFORM")
        if plat:
            from bytewax_tpu_torch.utils import force_platform

            force_platform(plat)

        # Multi-process runs with BYTEWAX_TPU_DISTRIBUTED=1 join one
        # torch.distributed world (gloo) before any device state is
        # built, so the cluster-wide exchange tier can route keyed rows
        # over every process's devices while the host TCP mesh carries
        # the control plane.  The coordinator defaults to process 0's
        # host on the cluster port + 1711, as in the JAX package;
        # override with BYTEWAX_TPU_COORDINATOR.  A peer that never
        # joins fails the run after _DIST_INIT_TIMEOUT_S.
        if (
            os.environ.get("BYTEWAX_TPU_DISTRIBUTED") == "1"
            and self.proc_count > 1
        ):
            from bytewax_tpu_torch.parallel.mesh import init_world

            coord = os.environ.get("BYTEWAX_TPU_COORDINATOR")
            if not coord:
                # A deterministic coordinator port from the cluster
                # port, folded into the registered-port range so high
                # ephemeral cluster ports can't produce an invalid
                # (>65535) address.  Collisions with unrelated
                # listeners remain possible — set
                # BYTEWAX_TPU_COORDINATOR explicitly on shared hosts.
                host, _, port = addresses[0].rpartition(":")
                cport = 1024 + (int(port) + 1711) % 60000
                coord = f"{host or '127.0.0.1'}:{cport}"
            init_world(proc_id, self.proc_count, coord, _DIST_INIT_TIMEOUT_S)

        self.store: Optional[RecoveryStore] = None
        self._loads: Dict[Tuple[str, str], bytes] = {}
        resume = ResumeFrom(0, 1)
        #: Rescale-on-resume opt-in (--rescale / BYTEWAX_TPU_RESCALE):
        #: without it, resuming a store written by a different worker
        #: count refuses with WorkerCountMismatchError instead of
        #: reading keyed rows with a stale route modulus.
        #: ``force_rescale`` is the live-reconfigure re-entry: the
        #: cluster just AGREED a membership change at an epoch close,
        #: so the migration is part of the agreed move, not an
        #: operator opt-in.
        self.rescale_enabled = force_rescale or os.environ.get(
            "BYTEWAX_TPU_RESCALE", "0"
        ) not in ("", "0")
        #: Worker count(s) the resumed execution was written with,
        #: when they differ from this cluster's (the startup rescale
        #: phase migrates the store before any keyed snapshot is
        #: read); None when no rescale is needed.
        self._rescale_from: Optional[Tuple[int, ...]] = None
        if recovery_config is not None:
            self.store = RecoveryStore(recovery_config.db_dir)
            resume = self.store.resume_from(
                worker_count=self.worker_count,
                allow_rescale=self.rescale_enabled,
            )
            if resume.stored_worker_counts not in (
                (),
                (self.worker_count,),
            ):
                self._rescale_from = resume.stored_worker_counts
            # Eagerly load only input/output partition states (a
            # bounded handful, needed at build_part time); unbounded
            # keyed stateful snapshots stream in store pages via
            # iter_resume_states instead, so resume memory stays
            # bounded however large the state.
            io_steps = [
                op.step_id
                for op in self.plan.ops
                if op.name in ("input", "output")
                # Infer steps carry exactly one broadcast-state row
                # ("_params") that must restore on EVERY process
                # regardless of which route owner wrote it — eager
                # and route-agnostic, like the io partition states.
                or type(op.conf.get("_accel")).__name__
                == "InferAccelSpec"
            ]
            if io_steps:
                self._loads = {
                    (sid, key): ser
                    for sid, key, ser in self.store.iter_snaps(
                        resume.resume_epoch, step_ids=io_steps
                    )
                }
            ei = self.epoch_interval.total_seconds()
            backup = recovery_config.backup_interval.total_seconds()
            if ei > 0:
                self._commit_delay: Optional[int] = int(-(-backup // ei))
            elif backup <= 0:
                self._commit_delay = 0
            else:
                # Zero-length epochs close every loop iteration, so no
                # finite epoch delay honors a wall-clock backup
                # interval; retain everything (never commit/GC).
                self._commit_delay = None
        self.resume = resume
        self.epoch = resume.resume_epoch
        _faults.set_epoch(self.epoch)

        #: Demote a device-tier step to the host tier after this many
        #: consecutive device faults on one step (retried in place:
        #: DeviceFault guarantees no device state was mutated).
        self.demote_after = max(
            1, int(os.environ.get("BYTEWAX_TPU_DEMOTE_AFTER", "3") or 3)
        )
        #: Epoch-progress watchdog (s beyond the epoch interval with
        #: no epoch close in a clustered run); 0 disables.  Heals
        #: wedged barriers (e.g. an injected frame drop broke the
        #: count-matched quiescence check) by unwinding into the
        #: supervisor instead of hanging forever.
        self.stall_s = float(
            os.environ.get("BYTEWAX_TPU_EPOCH_STALL_S", "0") or 0.0
        )

        # -- connector-edge resilience (docs/recovery.md) -----------------
        #: In-place retries per source-partition poll / sink write
        #: before a transient I/O fault escalates to the restartable-
        #: fault/supervisor path.
        self.io_retries = max(
            0, int(os.environ.get("BYTEWAX_TPU_IO_RETRIES", "3") or 3)
        )
        #: Base of the capped jittered exponential I/O retry backoff.
        self.io_backoff_s = float(
            os.environ.get("BYTEWAX_TPU_IO_BACKOFF_S", "0.05") or 0.05
        )
        #: Per-attempt retry delay ceiling (source retries schedule
        #: the next poll; sink retries sleep in place, so the cap
        #: also bounds the longest single stall before escalation).
        self.io_backoff_cap_s = float(
            os.environ.get("BYTEWAX_TPU_IO_BACKOFF_CAP_S", "5") or 5
        )
        #: Opt-in per-partition quarantine: after retry exhaustion on
        #: one source partition, park it (snapshot frozen at the last
        #: good offset) and re-probe on a capped backoff schedule
        #: while the rest of the dataflow keeps flowing.
        self.quarantine = os.environ.get(
            "BYTEWAX_TPU_QUARANTINE", "0"
        ) not in ("", "0")
        #: Re-probe delay ceiling for quarantined partitions (the
        #: retry ladder keeps climbing into quarantine, capped here).
        self.quarantine_cap_s = float(
            os.environ.get("BYTEWAX_TPU_QUARANTINE_REPROBE_S", "30")
            or 30
        )
        #: One jitter stream for every connector-edge retry in this
        #: process (deterministic per proc, desynchronized across the
        #: cluster — same contract as the restart supervisor's).
        self._io_rng = _backoff.seeded_rng("io", proc_id)
        #: Dead-letter queue (engine/dlq.py): poison records from
        #: connectors with ``on_error="dlq"``, epoch-buffered and
        #: flushed at epoch close before the snapshot commit.  The
        #: resume truncation mirrors the truncating-sink contract so
        #: replayed epochs recapture instead of duplicating.
        self.dlq = DeadLetterQueue(proc_id)
        self.dlq.truncate_for_resume(
            resume.resume_epoch, proc_count=self.proc_count
        )

        self.rts: List[_OpRt] = []
        #: /healthz readiness: True once run startup (mesh handshake,
        #: agreement round, rescale migration, runtime builds) is done.
        self._ready = False
        #: Set when an epoch close's sync round agreed the cluster
        #: stops (any process voted stop): every process breaks out of
        #: its run loop after that close and returns GracefulStop.
        self._stop_agreed = False
        #: Set (to the agreed target spec) when an epoch close's sync
        #: round agreed a live membership change: every process breaks
        #: out after that (committed) close and unwinds to the
        #: run-startup re-entry in ``_supervised`` — rebuild or
        #: retire, no process restart (docs/recovery.md "Live partial
        #: rescale").
        self._reconfig_agreed: Optional[
            Tuple[Tuple[str, ...], int]
        ] = None
        #: True while the startup rescale migration is pending/running
        #: on this process (including peers blocked in the post-"fcfg"
        #: wait): /healthz then reports a distinct ``migrating`` state
        #: so external supervisors don't misread a long migration as a
        #: wedged child.
        self._migrating = self._rescale_from is not None
        #: Recent rescale-hint advice, appended at epoch close (rate
        #: limited) so an external autoscaler's K-consecutive-poll
        #: hysteresis reads the engine's own history instead of
        #: re-deriving it from raw signals (docs/recovery.md).
        self._hint_log: deque = deque(maxlen=64)
        self._last_hint_at = float("-inf")

        # -- incremental asynchronous checkpoints (docs/recovery.md
        # "Asynchronous incremental checkpoints").  Both knobs default
        # OFF; unset keeps the close sequence byte-identical.
        #: Run the SQLite snapshot write+commit on an ordered
        #: committer lane while the next epoch computes (at most one
        #: commit in flight; the next close fences the previous one).
        self.ckpt_async = self.store is not None and os.environ.get(
            "BYTEWAX_TPU_CKPT_ASYNC", "0"
        ) not in ("", "0")
        #: Write only snapshot rows whose serialized state changed
        #: since the last close (latest-row-per-key resume reads make
        #: the skipped rows authoritative).
        self.ckpt_delta = self.store is not None and os.environ.get(
            "BYTEWAX_TPU_CKPT_DELTA", "0"
        ) not in ("", "0")
        #: Under a retain-everything commit schedule
        #: (``_commit_delay is None``), force a commit/GC pass every K
        #: closes so a delta chain compacts back to one authoritative
        #: row per key; 0 = off.
        self.ckpt_compact_every = max(
            0,
            int(
                os.environ.get("BYTEWAX_TPU_CKPT_COMPACT_EVERY", "0")
                or 0
            ),
        )
        #: Ordered checkpoint committer lane (depth 2 = at most one
        #: commit in flight; ``make_room`` at push IS the
        #: previous-commit fence).  Ledger phase ``snapshot_lane``
        #: keeps its seconds off the main-thread close window.
        self._ckpt_lane = None
        if self.ckpt_async:
            from bytewax_tpu_torch.engine.pipeline import DevicePipeline

            self._ckpt_lane = DevicePipeline(
                "ckpt", depth=2, phase="snapshot_lane"
            )
        #: Newest epoch whose snapshot commit is durable on disk (this
        #: process's view; resume_epoch - 1 covers "nothing from this
        #: execution yet"), and the newest epoch whose snapshot set
        #: was sealed at a close — their difference is the replay
        #: window a crash right now would incur.
        self._durable_epoch = resume.resume_epoch - 1
        self._ckpt_sealed_epoch = resume.resume_epoch - 1
        #: Last-written content digest per (step_id, state_key) for
        #: the delta filter; empty after every (re)start so the first
        #: close of an execution writes everything it sees.
        self._ckpt_digests: Dict[Tuple[str, str], bytes] = {}

    # -- cluster topology --------------------------------------------------

    def is_local(self, w: int) -> bool:
        return self.local_lo <= w < self.local_hi

    def owner_proc(self, w: int) -> int:
        return w // self.wpp

    def ship_deliver(self, op_idx: int, port: str, entry: Entry) -> None:
        """Send an entry to the process owning its worker lane; it is
        injected into the same op's input queue there.

        Like ``ship_route``: zero-row slices never hit the wire, and
        non-empty keyed split slices accumulate per (peer, op, port,
        lane) in the ship accumulator — coalescing under the same
        ``can_merge`` rules — and go out as merged frames at the next
        ``ship_flush`` (poll boundary / drain point)."""
        w, items = entry
        try:
            if len(items) == 0:
                return
        except TypeError:
            pass
        dest = self.owner_proc(w)
        acc = self._ship_acc
        if acc is not None:
            acc.add_deliver(dest, op_idx, port, w, items)
            return
        self.sent[dest] += 1
        self.comm.send(dest, ("deliver", op_idx, port, entry))
        rows, nbytes = _flowmap.payload_size(items)
        _flowmap.FLOWMAP.add_wire(
            dest,
            f"{self.plan.ops[op_idx].step_id}.{port}",
            rows,
            nbytes,
        )

    def ship_route(self, stream_id: str, entry: Entry) -> None:
        """Send an entry to its lane's owner, routed to the stream's
        consumers there.

        Zero-row slices never hit the wire (an empty group is a no-op
        at every consumer, so skipping it is unobservable — and not
        sending means not counting, so the barrier stays matched).
        Non-empty slices accumulate per (peer, stream, lane) in the
        route accumulator and ship as merged frames at the next
        ``ship_flush`` (poll boundary / drain point)."""
        w, items = entry
        try:
            if len(items) == 0:
                return
        except TypeError:
            pass
        acc = self._ship_acc
        if acc is not None:
            acc.add(self.owner_proc(w), stream_id, w, items)
            return
        dest = self.owner_proc(w)
        self.sent[dest] += 1
        self.comm.send(dest, ("route", stream_id, entry))
        rows, nbytes = _flowmap.payload_size(items)
        _flowmap.FLOWMAP.add_wire(dest, stream_id, rows, nbytes)

    def ship_flush(self) -> None:
        """Put every accumulated frame — routed slices and keyed
        split deliveries alike — on the wire.  Drain-point
        machinery (BTX-DRAIN): called from the run loop's poll
        boundary, epoch-close entry, and the EOF ladder — never from a
        per-batch path — so the sent counts the quiescence reports
        carry always reflect what actually left this process.  Frames
        are counted as they go out, and the ``comm.send`` fault site
        fires before each run leaves the accumulator's pending set, so
        an injected error unwinds with the rows still pending instead
        of silently dropping them."""
        acc = self._ship_acc
        if acc is None:
            return
        while True:
            frame = acc.peek()
            if frame is None:
                return
            key, items = frame
            if key[0] == "route":
                _kind, dest, stream_id, w = key
                self.sent[dest] += 1
                self.comm.send(dest, ("route", stream_id, (w, items)))
            else:
                _kind, dest, op_idx, port, w = key
                stream_id = f"{self.plan.ops[op_idx].step_id}.{port}"
                self.sent[dest] += 1
                self.comm.send(
                    dest, ("deliver", op_idx, port, (w, items))
                )
            # Flow map: per-peer traffic per stream, attributed at the
            # drain point the frame actually leaves from (dict adds,
            # sealed per epoch; sizes are the payload's own column
            # buffers — the codec's exact wire split stays in
            # bytewax_wire_bytes_count).
            rows, nbytes = _flowmap.payload_size(items)
            _flowmap.FLOWMAP.add_wire(dest, stream_id, rows, nbytes)
            acc.pop()

    def resume_state(self, step_id: str, state_key: str) -> Optional[Any]:
        ser = self._loads.get((step_id, state_key))
        return loads(ser) if ser is not None else None

    def iter_resume_states(self, step_id: str):
        """Stream ``(key, state)`` resume pairs for a stateful step in
        store pages — memory bounded by the page size, not the keyed
        state size.  Reads are route-scoped to this process's worker
        lanes (rows are route-stamped at write time and migrated by
        the startup rescale phase when the worker count changed), so
        a resuming cluster reads ~1/M of the keyed state per process;
        the caller's ``is_local`` check stays the correctness
        backstop."""
        if self.store is None:
            return
        for _sid, key, ser in self.store.iter_snaps(
            self.resume.resume_epoch,
            step_ids=[step_id],
            routes=list(range(self.local_lo, self.local_hi)),
        ):
            yield key, loads(ser)

    def _from_peer(self, src: int, entry: Entry) -> Entry:
        """A peer's dictionary-encoded batch carries ids of the peer's
        own vocabulary: tag the vocabulary with its sender
        (engine/arrays.py ``PeerVocab``) so that no device state or
        route cache takes them as ids of this process's.  One tagged
        view per (peer, vocabulary object), so an unchanged vocabulary
        keeps its identity from frame to frame."""
        w, items = entry
        if (
            type(items) is not ArrayBatch
            or items.key_vocab is None
            or "key_id" not in items.cols
        ):
            return entry
        vocab = items.key_vocab
        seen = self._peer_vocabs.setdefault(src, [])
        for orig, tagged in seen:
            if orig is vocab and len(tagged) == len(vocab):
                break
        else:
            tagged = peer_vocab(vocab, src)
            seen.insert(0, (vocab, tagged))
            del seen[4:]
        return (
            w,
            ArrayBatch(
                items.cols, key_vocab=tagged, value_scale=items.value_scale
            ),
        )

    def route(self, stream_id: str, entry: Entry) -> None:
        for ci, port in self.plan.consumers.get(stream_id, []):
            self.rts[ci].queues[port].append(entry)
        self._progressed = True

    def _ledger_phase(self, phase: str, step_id: str = "*") -> Any:
        """Time one engine phase into the epoch ledger (exclusive of
        phases nested inside it), as the profiler range
        ``bytewax.<phase>`` while one records — and, when a tracing
        backend is active, as a nested OTLP span on the existing
        tracing path."""
        return _flight.phase(phase, step_id, otlp=self.trace_ops)

    def _close_epoch(self, workers: Optional[range] = None) -> None:
        from bytewax_tpu_torch.tracing import span

        closing = self.epoch
        # Ledger phases accrued from here to the seal (inside
        # note_epoch_close) form the close-window breakdown, whose sum
        # tracks the epoch_close_duration_seconds observation below.
        _flight.RECORDER.mark_close()
        t0 = time.monotonic()
        with span("epoch_close", epoch=closing):
            self._close_epoch_inner(workers)
        dt = time.monotonic() - t0
        from bytewax_tpu_torch._metrics import epoch_close_duration_seconds

        epoch_close_duration_seconds.observe(dt)
        # Seal the flow map BEFORE the ledger seal: the Perfetto dump
        # inside note_epoch_close reads the just-sealed record for its
        # counter tracks, and next close's telemetry piggyback ships
        # it cluster-wide (one epoch behind, exactly like the ledger).
        self._flowmap_close(closing)
        _flight.RECORDER.note_epoch_close(closing, dt)
        # Rescale-hint history: one advice sample per wall-clock
        # second at most (interval-0 flows close per loop iteration;
        # the percentile math must stay off that hot path), appended
        # at the close — the main thread — and read racily by
        # /status like every other observability surface.
        now_hint = time.monotonic()
        if now_hint - self._last_hint_at >= 1.0:
            self._last_hint_at = now_hint
            advice, _reasons, signals = self._hint_advice()
            bn = signals.get("bottleneck")
            self._hint_log.append(
                {
                    "epoch": closing,
                    "advice": advice,
                    "bottleneck": bn["step"] if bn else None,
                    "t": time.time(),
                }
            )
        if self._gc_managed:
            # Deterministic collection points: the cycle collector is
            # off during the hot loop (its periodic full scans over a
            # growing item heap dominate per-item cost at device-tier
            # rates and spike latency mid-epoch — the reference's
            # native engine has no GC on the hot path at all,
            # src/worker.rs run loop); collect at epoch close, rate-
            # limited so epoch_interval=0 flows don't collect per
            # batch.  Plain refcounting still frees the (acyclic)
            # item churn immediately.
            import gc
            import time as _time

            now_m = _time.monotonic()
            if now_m - self._last_gc >= 1.0:
                gc.collect()
                self._last_gc = _time.monotonic()

    def _flowmap_close(self, closing: int) -> None:
        """Sample the close-time flow-map gauges (device-resident
        footprint, per-step watermark lag) and seal this epoch's flow
        record (docs/observability.md "Flow map").  Runs at the
        epoch-close drain point on the main thread — pipelines are
        quiesced, so the slot tables and watermark arrays are safe to
        read."""
        fm = _flowmap.FLOWMAP
        for rt in self.rts:
            states = [
                s
                for s in (
                    getattr(rt, "agg", None),
                    getattr(rt, "wagg", None),
                    getattr(rt, "sagg", None),
                )
                if s is not None
            ]
            if not states:
                continue
            keys = 0
            nbytes = 0
            for st in states:
                k, b = _flowmap.device_footprint(st)
                keys = max(keys, k)
                nbytes += b
            if keys or nbytes:
                fm.set_device(rt.op.step_id, keys, nbytes)
            wagg = getattr(rt, "wagg", None)
            if wagg is not None:
                lag = _flowmap.watermark_lag_s(wagg)
                if lag is not None:
                    fm.set_lag(rt.op.step_id, lag)
        fm.seal(
            closing,
            queue_depth=dict(_flight.RECORDER._flush_depth),
        )

    def _close_epoch_inner(self, workers: Optional[range] = None) -> None:
        # The route accumulator flushes before anything else this
        # close does: emissions must land in the epoch whose
        # snapshots cover them, and every sync round below must run
        # with nothing pending on this process.  Normally a no-op —
        # the run loop's poll-boundary flush already drained it.
        self.ship_flush()
        # Dispatch pipelines drain before ANY sync round this close
        # performs (the pre_close collective flushes, the telemetry
        # piggyback): no gsync point may be reached with this process
        # still mid-pipeline.  Normally a no-op — the run loop (and
        # the cluster barrier's drained check) already quiesced them.
        with self._ledger_phase("close_flush"):
            for rt in self.rts:
                rt.pipeline_flush()
        # Collective pre-close hooks next: every process reaches this
        # point exactly once per epoch (close_epoch broadcast), so
        # global-mesh exchange flushes align across the cluster.
        with self._ledger_phase("collective"):
            for rt in self.rts:
                rt.pre_close()
        # Dead-letter flush BEFORE the snapshot commit: the appended
        # rows carry this epoch's stamp, and the resume truncation
        # drops rows of any epoch that did not commit — so a crash in
        # the commit window replays the epoch and recaptures them,
        # never duplicating (docs/recovery.md "Connector-edge
        # resilience").
        self.dlq.flush()
        self._ckpt_seal(workers)
        pending_reconfig = self._reconfig_spec(_pending_reconfigure())
        pending_model = _pending_params()
        # The vote is (step_id, digest) only — the params tree itself
        # NEVER rides the wire (each process installs from its own
        # pending copy, exactly like the reconfigure target's address
        # list), so the swap adds zero new send surface.
        model_vote = (
            (pending_model[0], pending_model[1])
            if pending_model is not None
            else None
        )
        if self.comm is not None:
            # Epoch-close sync round: the graceful-stop vote, the
            # live-reconfigure proposal, and the telemetry piggyback.
            # One gsync round at a globally-ordered point (every
            # process reaches this exactly once per close_epoch
            # broadcast), UNCONDITIONAL so the stop vote always has a
            # ride — the startup "fcfg" round now only gates whether
            # the summary payload is populated, not whether the round
            # runs, keeping the round sequence identical across
            # processes by construction.  Any process voting stop
            # stops the whole cluster after this (already committed)
            # close; a membership change happens only once EVERY
            # process carries the SAME pending target (the supervisor
            # posts it to each child, so partial delivery just defers
            # the move to a later close); no new control-frame kinds
            # either way.
            payload = {
                "stop": _STOP_EVENT.is_set(),
                "reconfig": pending_reconfig,
                "model": model_vote,
                "summary": (
                    _flight.RECORDER.summary(self.epoch)
                    if self._flight_sync
                    else None
                ),
            }
            replies = self.global_sync(
                ("fstat", self.next_gsync_tag()), payload
            )
            if any(r["stop"] for r in replies.values()):
                self._stop_agreed = True
            else:
                specs = {
                    r.get("reconfig") for r in replies.values()
                }
                if len(specs) == 1 and None not in specs:
                    self._agree_reconfigure(specs.pop())
                # Params hot-swap rides the same round: commits only
                # once EVERY process carries the SAME pending
                # (step, digest) — partial delivery defers the swap
                # to a later close, exactly like the reconfigure
                # target.  A close that agreed a membership change
                # skips the swap (the pending target survives the
                # in-process re-entry and lands at the new
                # generation's first close).
                models = {r.get("model") for r in replies.values()}
                if (
                    self._reconfig_agreed is None
                    and len(models) == 1
                    and None not in models
                ):
                    self._apply_params_swap(models.pop())
            if self._flight_sync:
                _flight.RECORDER.cluster = {
                    pid: r["summary"]
                    for pid, r in sorted(replies.items())
                }
        elif _STOP_EVENT.is_set():
            # Single process (or in-process lanes): nothing to agree
            # with — the close that just committed is the stop point.
            self._stop_agreed = True
        elif pending_reconfig is not None:
            self._agree_reconfigure(pending_reconfig)
        elif model_vote is not None:
            # Single process: this close is trivially the agreed one.
            self._apply_params_swap(model_vote)
        if self._stop_agreed or self._reconfig_agreed is not None:
            # Run-ending close: no next close will fence the global
            # tier's overlapped exchange round, so land it HERE —
            # every process agreed the same ending close, so the
            # fence is symmetric and the teardown never races an
            # in-flight collective.
            for rt in self.rts:
                fence = getattr(rt, "collective_fence", None)
                if fence is not None:
                    fence()
            # Same for the checkpoint committer lane: the agreed
            # ending close's commit must be durable before any
            # process tears down (resume then replays ZERO epochs —
            # the GracefulStop contract).
            self._ckpt_fence()
        self.epoch += 1
        _faults.set_epoch(self.epoch)
        _flight.RECORDER.record("epoch_open", epoch=self.epoch)

    #: Content digest standing in for a discard marker (``None``
    #: serialization) in the delta filter's per-key digest map.
    _CKPT_TOMBSTONE = b"\x00tombstone"

    def _ckpt_seal(self, workers: Optional[range] = None) -> None:
        """Seal this close's snapshot set at the drain point and hand
        it to durability (docs/recovery.md "Asynchronous incremental
        checkpoints").  Drain-only: called from ``_close_epoch_inner``
        with pipelines quiesced, so the state read here is the
        consistent image of the closing epoch.

        With ``BYTEWAX_TPU_CKPT_DELTA=1`` rows whose serialized state
        is unchanged since the last written row are skipped (resume's
        latest-row-per-key reads keep the stored row authoritative).
        With ``BYTEWAX_TPU_CKPT_ASYNC=1`` the SQLite write+commit runs
        as an ordered task on the committer lane while the next epoch
        computes — pushing the next seal fences the previous commit
        (at most one in flight), so the durable frontier never trails
        the closed frontier by more than one epoch.  The pinned
        ``snapshot_seal`` fault site fires after the seal is immutable
        and before anything is handed to either path."""
        if self.store is None:
            with self._ledger_phase("snapshot"):
                for rt in self.rts:
                    rt.epoch_forget()
            return
        snaps: List[Tuple[str, str, Optional[bytes]]] = []
        with self._ledger_phase("snapshot"):
            for rt in self.rts:
                sid = rt.op.step_id
                for state_key, state in rt.epoch_snaps():
                    ser = (
                        pickle.dumps(state) if state is not None else None
                    )
                    if self.ckpt_delta:
                        digest = (
                            hashlib.blake2b(
                                ser, digest_size=16
                            ).digest()
                            if ser is not None
                            else self._CKPT_TOMBSTONE
                        )
                        dkey = (sid, state_key)
                        if self._ckpt_digests.get(dkey) == digest:
                            continue  # latest stored row still matches
                        self._ckpt_digests[dkey] = digest
                    snaps.append((sid, state_key, ser))
        _flight.RECORDER.record(
            "snapshot", epoch=self.epoch, states=len(snaps)
        )
        if self._commit_delay is None:
            commit_epoch = None
            if (
                self.ckpt_compact_every
                and self.epoch % self.ckpt_compact_every == 0
            ):
                # Retain-everything schedule: periodically force the
                # commit/GC pass anyway so an unbounded delta chain
                # compacts back to one authoritative row per key
                # (rescale migration and resume reads then touch one
                # row, and the store stops growing).
                commit_epoch = self.epoch
        else:
            commit_epoch = self.epoch - self._commit_delay
        if commit_epoch is not None:
            if self.comm is not None:
                # Peers write their frontier for this epoch in
                # separate transactions after the coordinator's; a
                # crash in that window must not have GC'd past their
                # previous frontier.  The same one-epoch margin covers
                # an async peer whose previous commit is still in
                # flight (the per-close fence bounds the skew at 1).
                commit_epoch -= 1
            commit_epoch = commit_epoch if commit_epoch > 0 else None
        # The sealed delta is immutable from here on; the site fires
        # before the inline write (sync) or the lane handoff (async),
        # so an injected crash proves the seal→commit window resumes
        # from the previous durable close.  Unarmed: one no-op call.
        _faults.fire("snapshot_seal")
        sealed_epoch = self.epoch
        if self._ckpt_lane is None:
            with self._ledger_phase("commit"):
                self.store.write_epoch(
                    self.resume.ex_num,
                    self.worker_count,
                    sealed_epoch,
                    snaps,
                    commit_epoch,
                    workers=workers,
                    # In a cluster only the coordinator commits/GCs,
                    # after its own frontier write.
                    do_commit=self.proc_id == 0,
                )
            self._durable_epoch = sealed_epoch
            return
        store = self.store
        ex_num = self.resume.ex_num
        worker_count = self.worker_count
        do_commit = self.proc_id == 0

        def commit_task() -> int:
            # Worker-lane root (BTX-THREAD: pinned carve-out to the
            # recovery store ONLY): one pre-bound durable write, no
            # emission, no comm, no shared engine state.
            store.write_epoch(
                ex_num,
                worker_count,
                sealed_epoch,
                snaps,
                commit_epoch,
                workers=workers,
                do_commit=do_commit,
            )
            return sealed_epoch

        def commit_done(epoch: int) -> None:
            # Finalizer: main thread, at the next fence/drain point.
            self._durable_epoch = epoch
            _flight.note_snapshot_lag(
                epoch, max(0, self._ckpt_sealed_epoch - epoch)
            )

        self._ckpt_sealed_epoch = sealed_epoch
        # push() makes room first: at depth 2 that IS the fence on the
        # previous epoch's commit (stall seconds land in
        # snapshot_fence_stall_seconds via the lane's phase).
        self._ckpt_lane.push(commit_task, commit_done)
        _flight.note_snapshot_lag(
            self._durable_epoch,
            max(0, sealed_epoch - self._durable_epoch),
        )

    def _ckpt_fence(self) -> None:
        """Block until every pending checkpoint commit is durable.
        Drain-only: the run-ending close (stop/reconfigure), the
        post-loop clean exit in ``run()``, and teardown — a normal
        close fences implicitly through ``push``'s make_room."""
        if self._ckpt_lane is not None:
            self._ckpt_lane.flush()

    def _ckpt_shutdown(self) -> None:
        """Stop the committer lane's worker (idempotent).  Clean
        exits fenced via ``_ckpt_fence`` already; a fault unwind
        abandons the in-flight commit (it either already committed,
        or its transaction rolled back — resume replays that one
        epoch) and goes quiet before the store handle closes."""
        if self._ckpt_lane is not None:
            self._ckpt_lane.drop_pending()
            self._ckpt_lane.shutdown()

    def _pump(self, timeout: float = 0.0) -> None:
        """Receive cluster messages: inject shipped data, apply
        control decisions.

        Messages drain through the stash queue one at a time: a
        handler may BLOCK inside a collective sync (the EOF ladder's
        global-exchange finalize), during which a peer's gsync frame
        may already sit behind it in this very batch — the sync's own
        receive loop pulls from the stash, so queued frames stay
        reachable mid-handler."""
        self._pump_stash.extend(self.comm.recv_ready(timeout))
        while self._pump_stash:
            _src, msg = self._pump_stash.pop(0)
            self._handle_ctrl(_src, msg)

    def _handle_ctrl(self, _src: int, msg: tuple) -> None:
        kind = msg[0]
        if kind == "deliver":
            _kind, op_idx, port, entry = msg
            self.rcvd[_src] += 1
            self.rts[op_idx].queues[port].append(self._from_peer(_src, entry))
            self._progressed = True
        elif kind == "route":
            _kind, stream_id, entry = msg
            self.rcvd[_src] += 1
            self.route(stream_id, self._from_peer(_src, entry))
        elif kind == "report_msg":
            self._reports[_src] = msg[1]
        elif kind == "hold":
            if not self._holding:
                self._hold_t0 = time.monotonic()
                _faults.fire("barrier")
                _flight.RECORDER.record(
                    "barrier_enter", epoch=self.epoch, gen=msg[1]
                )
            self._holding = True
            self._gen = msg[1]
        elif kind == "eof_step":
            self._apply_eof_step(msg[1])
            self._gen = msg[2]
        elif kind == "close_epoch":
            self._pending_close = msg[1:]  # (epoch, final)
        elif kind == "gsync":
            # A peer already inside a global-exchange sync round; park
            # its payload for this process's matching global_sync call
            # (rounds are globally ordered, so it can only be for a
            # round this process has not entered yet).
            _kind, tag, pid, payload = msg
            self._gsync_stash.setdefault(tag, []).append((pid, payload))
        elif kind == "abort":
            raise _Abort()
        else:  # pragma: no cover
            raise AssertionError(f"unknown ctrl message {msg!r}")

    def next_gsync_tag(self) -> int:
        """Monotone sync-round id.  Sync rounds run only at
        globally-ordered points, so every process draws the same
        sequence — the id names the round identically cluster-wide."""
        self._gsync_seq += 1
        return self._gsync_seq

    def global_sync(self, tag: Any, payload: Any) -> Dict[int, Any]:
        """Exchange one (small, control-plane) payload per process —
        the metadata round preceding a global-mesh collective step
        (new keys, row counts, dtype votes).  Blocking: returns
        ``{proc_id: payload}`` for every process.

        May only be called at globally-ordered points (epoch close /
        the EOF ladder), where every process performs the same
        sequence of sync rounds; ``tag`` identifies the round so
        frames from a peer that is already one skipped-collective
        round ahead park in the stash instead of corrupting this one.
        Data-plane frames arriving mid-sync are stashed for the next
        ``_pump`` — counting (sent/rcvd) is untouched, so the epoch
        barrier's in-flight accounting stays exact.
        """
        t0 = time.monotonic()
        self.comm.broadcast(("gsync", tag, self.proc_id, payload))
        got = {self.proc_id: payload}
        for pid, pl in self._gsync_stash.pop(tag, []):
            got[pid] = pl

        def absorb(msg: tuple) -> bool:
            if msg[0] != "gsync":
                return False
            if msg[1] == tag:
                got[msg[2]] = msg[3]
            else:
                self._gsync_stash.setdefault(msg[1], []).append(
                    (msg[2], msg[3])
                )
            return True

        # Frames that were queued behind the handler we're blocking
        # inside of (this sync may run mid-_pump) — including a peer's
        # abort, which must cut the sync short, not wait out the
        # heartbeat limit.
        remaining = []
        for src, msg in self._pump_stash:
            if absorb(msg):
                continue
            if msg[0] == "abort":
                raise _Abort()
            remaining.append((src, msg))
        self._pump_stash[:] = remaining
        while len(got) < self.proc_count:
            try:
                frames = self.comm.recv_ready(0.01)
            except ClusterPeerDead as ex:
                # A peer whose payload for THIS round already arrived
                # has completed the round: its socket closing is a
                # benign exit, not a death — the terminal sync round
                # (a final close, a graceful stop, a retiring
                # process's last close) ends with every process
                # leaving whenever it has collected all replies, and
                # at 3+ processes a fast finisher's FIN can overtake
                # a slow peer's payload frame on a DIFFERENT socket.
                # Keep collecting; a peer that died BEFORE delivering
                # its payload still raises (it can never complete the
                # round), unwinding to the supervisor as before.
                # recv_ready raises for an ARBITRARY suspect (first
                # closed peer, or first heartbeat-silent peer), so a
                # benign exit must not shadow a real death: check
                # every closed AND every heartbeat-stale peer, not
                # just the reported one.
                if ex.peer not in got:
                    raise
                dead = sorted(
                    p
                    for p in (
                        self.comm.closed_peers()
                        | self.comm.stale_peers()
                    )
                    if p not in got
                )
                if dead:
                    msg = (
                        f"cluster peer {dead[0]} went away before "
                        "completing the sync round"
                    )
                    raise ClusterPeerDead(msg, peer=dead[0]) from ex
                continue
            for _src, msg in frames:
                if absorb(msg):
                    continue
                if msg[0] == "abort":
                    raise _Abort()
                self._pump_stash.append((_src, msg))
        dt = time.monotonic() - t0
        _flight.note_gsync(tag, dt)
        # Ledger: a leaf phase — when this round runs inside a timed
        # parent (the pre_close collective flush), the parent records
        # exclusive time and this stays its own line.
        _flight.note_phase("gsync", "*", dt, t0=t0)
        return got

    def _apply_eof_step(self, k: int) -> None:
        rt = self.rts[k]
        if not rt.eof:
            rt.drain()
            if rt.op.up_streams():
                rt.on_upstream_eof()
                rt.drain()
            rt.eof = True
        if self.comm is not None:
            # EOF-ladder drains can route: flush before the ladder's
            # next count-matched report so the shipped frames are
            # counted in the same generation that produced them.
            self.ship_flush()
        self._eof_k = k + 1
        self._progressed = True

    def _local_report(self, want_close: bool) -> tuple:
        drained = all(not rt.queued() for rt in self.rts)
        sources_eof = all(
            rt.eof for rt in self.rts if isinstance(rt, _InputRt)
        )
        return (
            want_close,
            sources_eof,
            drained,
            self._eof_k,
            tuple(self.sent),
            tuple(self.rcvd),
            self._gen,
        )

    def _coord_decide(self) -> None:
        """Proc 0: act when every process is drained and the global
        sent/received message matrix matches (no data in flight).

        Reports are generation-tagged: only reports issued after the
        current hold/eof_step broadcast count, so a pair of mutually
        stale-but-consistent reports (both predating an in-flight
        send) can never satisfy the barrier.
        """
        reports = self._reports
        if len(reports) < self.proc_count:
            return
        all_sources_eof = all(r[1] for r in reports.values())
        any_want_close = any(r[0] for r in reports.values())
        if not self._holding:
            if any_want_close or all_sources_eof:
                # Quiesce sources/timers; everything after this
                # broadcast reports with the new generation.
                self._gen += 1
                self.comm.broadcast(("hold", self._gen))
                self._holding = True
                self._hold_t0 = time.monotonic()
                _faults.fire("barrier")
                _flight.RECORDER.record(
                    "barrier_enter", epoch=self.epoch, gen=self._gen
                )
            return
        if not all(
            r[2] and r[6] == self._gen for r in reports.values()
        ):
            return
        for i in range(self.proc_count):
            for j in range(self.proc_count):
                if i == j:
                    continue
                if reports[i][4][j] != reports[j][5][i]:
                    return  # data still in flight
        min_eof_k = min(r[3] for r in reports.values())
        if all_sources_eof:
            if min_eof_k < len(self.rts):
                # Advance the EOF ladder one (topologically ordered)
                # op at a time so eof emissions fully propagate —
                # including across processes — before downstream ops
                # see EOF.
                self._gen += 1
                self.comm.broadcast(("eof_step", min_eof_k, self._gen))
                self._apply_eof_step(min_eof_k)
                self._reports = {self.proc_id: self._local_report(False)}
            else:
                self.comm.broadcast(("close_epoch", self.epoch, True))
                self._pending_close = (self.epoch, True)
        elif any_want_close:
            self.comm.broadcast(("close_epoch", self.epoch, False))
            self._pending_close = (self.epoch, False)

    def _drain_pipelines(self) -> bool:
        """Flush every step's dispatch pipeline; True when any held
        in-flight work (callers then re-drain queues before closing
        the epoch, so the flushed emissions stay in this epoch)."""
        pending = False
        for rt in self.rts:
            if getattr(rt, "_pipe", None) is not None and rt._pipe.pending():
                pending = True
                rt.pipeline_flush()
        return pending

    def _reconfig_spec(
        self,
        pending: Optional[Tuple[Tuple[str, ...], Optional[int]]],
    ) -> Optional[Tuple[Tuple[str, ...], int]]:
        """Normalize this process's pending reconfigure request into
        the comparable spec the close round exchanges: the full new
        address tuple plus an explicit lane count (an unset
        ``workers_per_process`` means "keep mine" — every process has
        the same current ``wpp``, so substitution is agreement-safe).
        """
        if pending is None:
            return None
        addrs, wpp = pending
        return (addrs, wpp if wpp is not None else self.wpp)

    def _apply_params_swap(
        self, spec: Tuple[Optional[str], str]
    ) -> None:
        """The close round just proved every process carries the same
        pending params update (``(step_id, digest)``): install it from
        the LOCAL pending copy into every matching infer runtime,
        then consume the target.

        The pinned ``params_swap`` fault site fires FIRST — before any
        runtime mutates and before the target is consumed — so an
        injected crash restarts (supervised, in-process) with the
        module-level pending target intact and the swap lands exactly
        once at the next agreed close.  Runs at a drain point (every
        pipeline quiesced by this close), so no in-flight device
        phase can observe a half-installed tree; the new params score
        the FIRST delivery of the next epoch."""
        pending = _pending_params()
        if pending is None or (pending[0], pending[1]) != spec:
            # A newer local update raced the agreement: keep it
            # pending — it rides a later close once every process
            # holds it.
            return
        step_id, digest, params = pending
        _faults.fire("params_swap", step=step_id or "")
        swapped = False
        for rt in self.rts:
            install = getattr(rt, "install_params", None)
            if install is None:
                continue
            if step_id is not None and rt.op.step_id not in (
                step_id,
                f"{step_id}.stateful_batch",
            ):
                continue
            if install(params, digest, self.epoch):
                swapped = True
        _consume_params(spec)
        if not swapped:
            # No runtime took the tree (no infer step matched, or the
            # pytree structure/shapes mismatch the incumbent): the
            # run continues on the incumbent params — surface the
            # rejection in the flight ring rather than unwind.
            _flight.RECORDER.record(
                "params_swap_rejected",
                step=step_id or "",
                digest=digest,
                epoch=self.epoch,
            )

    def _agree_reconfigure(
        self, spec: Tuple[Tuple[str, ...], int]
    ) -> None:
        """The close round just proved every process carries the same
        pending membership target: consume it, and — unless it names
        the shape the cluster already has — arm the post-close unwind
        to the run-startup re-entry point."""
        import logging

        addrs, wpp = spec
        _consume_reconfigure((addrs, wpp))
        if self.store is None:
            # Without a recovery store the rebuild would resume from
            # NOTHING: keyed state zeroed, sources replayed from the
            # start — a silent correctness loss, not a resize.
            # Refuse deterministically (every process shares the
            # store config, so the whole cluster refuses together).
            logging.getLogger(__name__).warning(
                "refusing live reconfigure: no recovery store is "
                "configured, so a membership change would discard "
                "keyed state and replay sources; run with a "
                "recovery directory (-r) to resize live"
            )
            return
        if os.environ.get("BYTEWAX_TPU_DISTRIBUTED") == "1":
            # torch.distributed pins the world size at
            # init_process_group and is not re-initialized in this
            # process: survivors would rebuild against a stale world
            # size while the joiner dials a coordinator that expects
            # the old one.  Resize through the full drain-to-stop
            # relaunch instead, as the JAX package does.
            logging.getLogger(__name__).warning(
                "refusing live reconfigure under "
                "BYTEWAX_TPU_DISTRIBUTED=1: the torch.distributed "
                "runtime cannot change world size in-process; use "
                "the drain-to-stop path "
                "(BYTEWAX_TPU_AUTOSCALE_LIVE=0)"
            )
            return
        same_addrs = list(addrs) == self.addresses or (
            # A 1-address list and an empty one are both "no mesh".
            len(addrs) <= 1 and len(self.addresses) <= 1
        )
        if same_addrs and wpp == self.wpp:
            return  # stale request for the current shape: no-op
        self._reconfig_agreed = (addrs, wpp)
        _flight.note_reconfigure(len(addrs), wpp, self.epoch)
        logging.getLogger(__name__).warning(
            "live reconfigure agreed at epoch %d: %d -> %d "
            "process(es), %d lane(s)/process; re-entering run "
            "startup in-process",
            self.epoch,
            self.proc_count,
            max(len(addrs), 1),
            wpp,
        )

    def _startup_rescale(self, clustered: bool) -> None:
        """Migrate the recovery store to this cluster's worker count
        when the resumed execution was written by a different one.

        Runs at run startup — the one globally-ordered re-entry point
        — after the startup agreement round proved every process
        observes the same old→new mapping, and before ANY runtime
        builds (no process may read keyed snapshots mid-migration).
        The coordinator migrates (one all-partition transaction,
        ``rescale_migrate`` fault site fired before any row moves);
        peers block in a gsync round until the migration committed.
        Whether the round runs is decided by the agreed view, so
        every process performs the same sequence of sync rounds.
        """
        if self.store is None or self._rescale_from is None:
            return
        migrated = 0
        if self.proc_id == 0:
            t0 = time.monotonic()
            # Delta-only (docs/recovery.md "Live partial rescale"):
            # only rows whose home lane actually changes under the
            # old→new modulus are rewritten, so the migration — and
            # bytewax_rescale_migrated_keys — scales with the moved
            # keys, not the store.  Semantically identical to the
            # full rewrite (the stamped route column IS the old
            # placement); legacy/mixed stamps always rewrite.
            migrated = self.store.rescale(
                self.worker_count,
                ex_num=self.resume.ex_num - 1,
                partial=True,
            )
            _flight.note_rescale(
                self._rescale_from,
                self.worker_count,
                migrated,
                time.monotonic() - t0,
            )
            import logging

            logging.getLogger(__name__).warning(
                "rescaled recovery store from %s worker(s) to %d "
                "(%d keyed snapshot rows re-routed)",
                "/".join(map(str, self._rescale_from)),
                self.worker_count,
                migrated,
            )
        if clustered:
            # Ordinary gsync round (an existing frame kind at a
            # globally-ordered point): peers wait here until the
            # coordinator's migration transaction committed, then all
            # resume reads see the new routing.  A coordinator fault
            # mid-migration closes the mesh; peers observe the socket
            # close and restart under their supervisors — retrying
            # the (rolled-back, idempotent) migration from scratch.
            self.global_sync(
                ("rescaled", self.next_gsync_tag()), migrated
            )
        self._rescale_from = None
        self._migrating = False

    def _hint_advice(
        self,
    ) -> Tuple[str, List[str], Dict[str, Any]]:
        """One rescale-advice sample: ``(advice, reasons, signals)``
        from the engine's current load signals (the pure
        :func:`derive_rescale_hint` over the flight counters and the
        epoch ledger's attribution)."""
        rec = _flight.RECORDER
        counters = rec.counters
        closes = max(int(counters.get("epoch_close_count", 0)), 1)
        pct = rec.epoch_close_percentiles()
        close_p99_s = pct[1] if pct is not None else None
        stall_s_per_close = (
            counters.get("pipeline_flush_stall_seconds", 0.0) / closes
        )
        # Checkpoint-fence waits are tracked apart from device flush
        # stalls on purpose: they are durability pressure, and the
        # hint must see them even though the async close window no
        # longer contains snapshot+commit time.
        snapshot_stall_s_per_close = (
            counters.get("snapshot_fence_stall_seconds", 0.0) / closes
        )
        restores_per_close = (
            counters.get("residency_restore_count", 0.0) / closes
        )
        spill_bytes_per_close = (
            counters.get("state_spill_bytes", 0.0) / closes
        )
        interval_s = self.epoch_interval.total_seconds()
        # Attribution-backed advice: the epoch ledger's measured
        # phase split, not just the loose rate signals.
        phase_fractions = _flight.ledger_fractions()
        bottleneck = self._derive_bottleneck()
        advice, reasons = derive_rescale_hint(
            worker_count=self.worker_count,
            epoch_interval_s=interval_s,
            close_p99_s=close_p99_s,
            stall_s_per_close=stall_s_per_close,
            restores_per_close=restores_per_close,
            spill_bytes_per_close=spill_bytes_per_close,
            snapshot_stall_s_per_close=snapshot_stall_s_per_close,
            phase_fractions=phase_fractions,
            bottleneck=bottleneck,
        )
        signals = {
            "worker_count": self.worker_count,
            "epoch_interval_s": interval_s,
            "epoch_close_p99_s": close_p99_s,
            "flush_stall_s_per_close": round(stall_s_per_close, 6),
            "snapshot_fence_stall_s_per_close": round(
                snapshot_stall_s_per_close, 6
            ),
            "restores_per_close": round(restores_per_close, 3),
            "spill_bytes_per_close": round(spill_bytes_per_close, 1),
            "epoch_closes": int(counters.get("epoch_close_count", 0)),
            "phase_fractions": phase_fractions,
            "bottleneck": (
                {"step": bottleneck[0], "why": bottleneck[1]}
                if bottleneck is not None
                else None
            ),
        }
        return advice, reasons, signals

    def _step_edge_pairs(self) -> List[Tuple[str, str]]:
        """(src_step, dst_step) pairs of the lowered topology, cached
        — the plan never changes within a generation."""
        pairs = self.__dict__.get("_step_edge_cache")
        if pairs is None:
            topo = _flowmap.topology(self.plan)
            pairs = [
                (e["src"], e["dst"])
                for e in topo["edges"]
                if e["src"] is not None
            ]
            self.__dict__["_step_edge_cache"] = pairs
        return pairs

    def _derive_bottleneck(self) -> Optional[Tuple[str, str]]:
        """Step-scoped bottleneck attribution: the pure
        :func:`bytewax_tpu_torch.engine.flowmap.derive_bottleneck` over the
        latest sealed epoch ledger (per-step busy seconds, drain-point
        queue depths) and flow-map record (watermark lag), restricted
        to THIS plan's step ids (the process-global recorders may
        still carry a previous execution's steps).  Read racily off
        whichever thread asks — observability, like every hint
        signal."""
        ledger = _flight.RECORDER.last_ledger or {}
        fm = _flowmap.FLOWMAP.last or {}
        ids = {op.step_id for op in self.plan.ops}
        steps: Dict[str, Dict[str, Any]] = {}
        for phase_steps in ledger.get("phases", {}).values():
            for step, s in phase_steps.items():
                if step in ids:
                    ent = steps.setdefault(step, {})
                    ent["busy_s"] = ent.get("busy_s", 0.0) + s
        for step, depth in ledger.get(
            "queue_depth_at_drain", {}
        ).items():
            if step in ids:
                steps.setdefault(step, {})["queue_depth"] = depth
        for step, sig in fm.get("steps", {}).items():
            if step in ids and "watermark_lag_s" in sig:
                steps.setdefault(step, {})["lag_s"] = sig[
                    "watermark_lag_s"
                ]
        if not steps:
            return None
        return _flowmap.derive_bottleneck(
            steps, self._step_edge_pairs()
        )

    def _rescale_hint(self) -> Dict[str, Any]:
        """The ``/status`` rescale recommendation (docs/recovery.md):
        a ``grow``/``shrink``/``hold`` advice derived from epoch-close
        latency, pipeline flush stalls, and residency restore/spill
        pressure, for an external autoscaler (or the operator) to
        stop the cluster and relaunch it at a better size with
        ``--rescale``.  ``history`` is the engine's own recent advice
        samples (appended at epoch close, at most one per second), so
        a K-consecutive-poll hysteresis decision reads recorded
        history instead of re-deriving the signals.  Read racily off
        the API-server thread — observability, not the epoch
        protocol."""
        advice, reasons, signals = self._hint_advice()
        return {
            "advice": advice,
            "reasons": reasons,
            "signals": signals,
            "history": _flight.FlightRecorder._copied(
                lambda: list(self._hint_log), []
            ),
        }

    def _ckpt_status(self) -> Dict[str, Any]:
        """Committer-lane visibility for ``/status``, ``/healthz``,
        and crash post-mortems (read racily — observability): the
        durable frontier vs the last sealed close is the replay
        window a crash right now would incur."""
        lag = max(0, self._ckpt_sealed_epoch - self._durable_epoch)
        return {
            "async": self.ckpt_async,
            "delta": self.ckpt_delta,
            "compact_every": self.ckpt_compact_every,
            "durable_epoch": self._durable_epoch,
            "sealed_epoch": self._ckpt_sealed_epoch,
            "lag_epochs": lag,
            "pending_commits": (
                len(self._ckpt_lane)
                if self._ckpt_lane is not None
                else 0
            ),
        }

    def _collective_lane_status(self) -> Optional[Dict[str, int]]:
        """The global tier's exchange-lane window for ``/status`` and
        ``/graph`` (read racily — observability): ``in_flight`` sealed
        rounds on the collective lane and the configured ``depth``
        bound (``BYTEWAX_TPU_GSYNC_DEPTH``).  None when no step runs
        on the collective tier or overlap is off."""
        for rt in self.rts:
            agg = getattr(rt, "agg", None)
            if getattr(agg, "global_exchange", False):
                status = agg.lane_status()
                if status is not None:
                    return status
        return None

    def _status(self) -> Dict[str, Any]:
        """Live ``GET /status`` document (read racily off the API
        server thread — observability, not the epoch protocol)."""
        rts = self.rts
        return {
            "flow_id": self.plan.flow.flow_id,
            "proc_id": self.proc_id,
            "proc_count": self.proc_count,
            "generation": self.generation,
            "demoted_steps": {
                rt.op.step_id: rt.demoted
                for rt in rts
                if getattr(rt, "demoted", None)
            },
            "residency": {
                rt.op.step_id: rt._res.status()
                for rt in rts
                if getattr(rt, "_res", None) is not None
            },
            "worker_count": self.worker_count,
            "workers": [self.local_lo, self.local_hi],
            "source_health": {
                rt.op.step_id: rt.source_health()
                for rt in rts
                if isinstance(rt, _InputRt)
            },
            "dlq": {
                "dir": self.dlq.dir,
                "captured": self.dlq.total,
                "pending_flush": self.dlq.pending_count(),
            },
            "rescale_hint": self._rescale_hint(),
            "checkpoint": self._ckpt_status(),
            "infer": {
                rt.op.step_id: rt.infer_status()
                for rt in rts
                if isinstance(rt, _InferRt)
            },
            "wire": {
                "mode": _wire.wire_mode(),
                "pending_frames": (
                    # Racy read — observability, like every other
                    # field here.
                    self._ship_acc.pending_frames()
                    if self._ship_acc is not None
                    else 0
                ),
                # Per-kind pending breakdown: the generalized
                # accumulator coalesces ship_deliver (peer, op, port,
                # lane) buckets alongside the route buckets — both
                # must be visible, not just the route count.
                "pending": (
                    self._ship_acc.pending_status()
                    if self._ship_acc is not None
                    else None
                ),
                "session": (
                    self.comm._wire_session.status()
                    if self.comm is not None
                    else None
                ),
                **_flight.wire_status(),
            },
            "epoch": self.epoch,
            "stopping": _STOP_EVENT.is_set() or self._stop_agreed,
            "eof": bool(rts) and all(rt.eof for rt in rts),
            "queue_depths": {
                rt.op.step_id: sum(len(q) for q in rt.queues.values())
                for rt in rts
            },
            "ledger": {
                "last": _flight.RECORDER.last_ledger,
                "recent": _flight.RECORDER.ledgers(8),
                # The collective exchange lane's live window: in-flight
                # sealed rounds and the configured depth bound
                # (BYTEWAX_TPU_GSYNC_DEPTH).  None when no global tier
                # (or no overlap lane) is active.  Racy read, like
                # every other field here.
                "collective_lane": self._collective_lane_status(),
                # API-server thread: copy-with-retry, the main thread
                # inserts new phase keys mid-iteration otherwise.
                "phase_totals": {
                    k: round(v, 6)
                    for k, v in _flight.RECORDER._copied(
                        lambda: dict(_flight.RECORDER.phase_totals), {}
                    ).items()
                },
                "phase_fractions": _flight.ledger_fractions(),
                "lag": _flight.RECORDER.ledger_lag(),
            },
            "recorder": _flight.RECORDER.snapshot(),
            "cluster": {
                str(pid): summary
                for pid, summary in _flight.RECORDER.cluster.items()
            },
        }

    def _graph(self) -> Dict[str, Any]:
        """Live ``GET /graph`` document (docs/observability.md "Flow
        map"): the lowered topology — steps with their live tier,
        edges with their ports — annotated with the latest sealed
        flow-map record per process.  This process's record is read
        directly; every peer's arrives on the EXISTING epoch-close
        gsync telemetry piggyback (one epoch behind, like the
        ledger), so any process serves the whole cluster with zero
        new frame kinds.  Read racily off the API-server thread —
        observability, not the epoch protocol."""
        topo = _flowmap.topology(self.plan)
        # Live tier overlay: the static plan cannot see the
        # collective global-exchange state or runtime demotions.
        tiers: Dict[str, str] = {}
        lanes: Dict[str, Optional[Dict[str, int]]] = {}
        for rt in self.rts:
            if isinstance(rt, _InferRt):
                # Infer steps report the tier that actually scores
                # (device until demotion/knob-off, host after).
                tiers[rt.op.step_id] = rt.live_tier()
            elif getattr(rt, "demoted", None):
                tiers[rt.op.step_id] = "host"
            elif getattr(
                getattr(rt, "agg", None), "global_exchange", False
            ):
                tiers[rt.op.step_id] = "collective"
                # The exchange lane's live window rides the
                # tier=collective record (None = overlap off).
                lanes[rt.op.step_id] = rt.agg.lane_status()
        for node in topo["steps"]:
            node["tier"] = tiers.get(node["step_id"], node["tier"])
            if node["step_id"] in lanes:
                node["collective_lane"] = lanes[node["step_id"]]
        sources: Dict[str, Any] = {}
        local = _flowmap.FLOWMAP.summary()
        if local is not None:
            sources[str(self.proc_id)] = local
        for pid, summary in _flight.RECORDER.cluster.items():
            if not isinstance(summary, dict):
                continue
            fmr = summary.get("flowmap")
            if fmr:
                sources.setdefault(str(pid), fmr)
        for node in topo["steps"]:
            node["telemetry"] = {
                pid: fmr["steps"][node["step_id"]]
                for pid, fmr in sources.items()
                if node["step_id"] in fmr.get("steps", {})
            }
        for edge in topo["edges"]:
            edge["telemetry"] = {
                pid: fmr["edges"][edge["stream_id"]]
                for pid, fmr in sources.items()
                if edge["stream_id"] in fmr.get("edges", {})
            }
        bottleneck = self._derive_bottleneck()
        return {
            "flow_id": self.plan.flow.flow_id,
            "proc_id": self.proc_id,
            "proc_count": self.proc_count,
            "epoch": self.epoch,
            "steps": topo["steps"],
            "edges": topo["edges"],
            "wire": {
                pid: fmr.get("wire", {})
                for pid, fmr in sources.items()
            },
            "bottleneck": (
                {"step": bottleneck[0], "why": bottleneck[1]}
                if bottleneck is not None
                else None
            ),
        }

    def _health(self) -> Dict[str, Any]:
        """``GET /healthz`` readiness payload.  Liveness is the HTTP
        server answering at all; readiness means run startup finished
        on this process — the mesh handshake, the "fcfg" agreement
        round, any rescale migration, and the runtime builds all
        completed.  The server now starts BEFORE the startup
        agreement/migration, so a not-yet-ready process distinguishes
        plain ``starting`` from ``migrating`` — the rescale migration
        running (or this peer blocked in the post-"fcfg" wait behind
        the coordinator's migration transaction); external
        supervisors must treat ``migrating`` as live progress, not a
        wedged child (a mid-restart-backoff process still refuses the
        connection — also not ready).  Once a graceful stop is
        requested the state flips to ``draining`` and readiness drops
        (HTTP 503), so external probes/k8s stop routing new work to a
        cluster that is winding down while liveness stays green."""
        draining = _STOP_EVENT.is_set() or self._stop_agreed
        # Replay window the committer lane currently carries.  Lag 1
        # is the steady-state design point of BYTEWAX_TPU_CKPT_ASYNC=1
        # (one commit in flight while the next epoch computes) and
        # stays green; anything above means durability has fallen
        # behind the close rate and readiness degrades — liveness
        # stays up so a supervisor can tell "lagging" from "wedged".
        ckpt_lag = max(0, self._ckpt_sealed_epoch - self._durable_epoch)
        lagging = ckpt_lag > 1
        if draining:
            state = "draining"
        elif not self._ready:
            state = "migrating" if self._migrating else "starting"
        elif lagging:
            state = "checkpoint_lagging"
        else:
            state = "ready"
        return {
            "ready": self._ready and not draining and not lagging,
            "draining": draining,
            "state": state,
            "proc_id": self.proc_id,
            "generation": self.generation,
            "epoch": self.epoch,
            "durable_epoch": self._durable_epoch,
            "snapshot_lag_epochs": ckpt_lag,
        }

    def run(self) -> Optional[Any]:
        clustered = self.comm is not None

        # Flight recorder: ring writes on only when someone can look
        # at them; the compile listener is counters-only and always
        # on.  The epoch-close telemetry piggyback is a sync round
        # every process must enter, so the cluster AGREES on it at
        # startup with one unconditional gsync round (all processes
        # run this exact sequence, making env divergence a disabled
        # piggyback instead of a hung barrier).  The same round
        # carries each process's rescale view (stored worker counts,
        # this cluster's count, the resume point): every process must
        # observe the SAME old→new mapping before any keyed snapshot
        # is read, so a divergent cluster (mismatched -w, stale store
        # view) fails loudly here instead of mis-sharding state.
        _flight.RECORDER.activate(_flight.enabled())
        _flight.RECORDER.proc_id = self.proc_id

        # The API plane comes up BEFORE the startup agreement round
        # and any rescale migration: a peer blocked in the post-"fcfg"
        # wait (or the coordinator mid-migration) answers /healthz
        # with a distinct ``migrating`` state instead of refusing the
        # connection, so an external supervisor's all-ready gate and
        # SIGKILL escalation can tell a long migration from a wedged
        # child (docs/recovery.md "Live partial rescale").
        from bytewax_tpu_torch.engine.webserver import maybe_start_server

        api_server = maybe_start_server(
            self.plan.flow,
            status_fn=self._status,
            port_offset=self.api_port_offset,
            health_fn=self._health,
            stop_fn=lambda: request_stop("http"),
            reconfigure_fn=lambda addrs, wpp: request_reconfigure(
                addrs, wpp, source="http"
            ),
            graph_fn=self._graph,
            model_fn=lambda params, step_id=None: update_params(
                params, step_id, source="http"
            ),
        )
        try:
            if clustered:
                replies = self.global_sync(
                    ("fcfg", self.next_gsync_tag()),
                    {
                        "flight": _flight.enabled(),
                        "rescale": (
                            self._rescale_from,
                            self.worker_count,
                            self.rescale_enabled,
                            self.resume.ex_num,
                            self.resume.resume_epoch,
                        ),
                    },
                )
                self._flight_sync = all(
                    r["flight"] for r in replies.values()
                )
                views = {r["rescale"] for r in replies.values()}
                if len(views) != 1:
                    msg = (
                        "cluster processes disagree on the "
                        f"resume/rescale view {list(views)}: every "
                        "process must see the same recovery store and "
                        "worker count before keyed state is re-sharded"
                    )
                    raise RuntimeError(msg)
            else:
                self._flight_sync = False

            # Rescale-on-resume runs HERE — run startup, the one
            # globally-ordered re-entry point — before any runtime
            # builds (i.e. before any process reads keyed snapshots).
            self._startup_rescale(clustered)

            # Build runtimes (applies resume state).
            for i, op in enumerate(self.plan.ops):
                rt = _RT_FOR[op.name](op, self)
                rt.idx = i
                self.rts.append(rt)

            local_workers = range(self.local_lo, self.local_hi)
            if self.store is not None:
                self.store.write_ex_started(
                    self.resume.ex_num,
                    self.worker_count,
                    self.resume.resume_epoch,
                    workers=local_workers,
                )
        except BaseException:
            # A startup fault (rescale migration, agreement divergence,
            # a builder error) unwinds before the run loop's own
            # finally exists: close the mesh NOW so peers blocked in a
            # startup sync round observe the socket close (and restart
            # under supervision) instead of waiting out the heartbeat.
            for rt in self.rts:
                shutdown = getattr(rt, "pipeline_shutdown", None)
                if shutdown is not None:
                    shutdown()
            self._ckpt_shutdown()
            if api_server is not None:
                api_server.shutdown()
            if clustered:
                self.comm.close()
            if self.store is not None:
                self.store.close()
            raise

        inputs = [rt for rt in self.rts if isinstance(rt, _InputRt)]
        epoch_started = time.monotonic()
        interval_s = self.epoch_interval.total_seconds()
        aborted = False
        self._holding = False
        self._hold_t0: Optional[float] = None
        #: Stall-watchdog clock: when this process started wanting an
        #: epoch close (or holding) without one arriving.
        self._stall_t0: Optional[float] = None
        self._pending_close: Optional[tuple] = None
        self._eof_k = 0
        self._gen = 0
        self._reports: Dict[int, tuple] = {}
        self._last_report: Optional[tuple] = None
        self._ready = True

        # Epoch-aligned garbage collection (see _close_epoch); opt
        # out with BYTEWAX_TPU_GC=auto to keep Python's automatic
        # collector running mid-epoch.
        import gc

        self._gc_managed = (
            os.environ.get("BYTEWAX_TPU_GC", "epoch") == "epoch"
            and gc.isenabled()
        )
        self._last_gc = time.monotonic()
        if self._gc_managed:
            gc.disable()

        try:
            while True:
                self._progressed = False
                now = _now()

                if clustered and self._pending_close is not None:
                    _epoch, final = self._pending_close
                    self._pending_close = None
                    if self._hold_t0 is not None:
                        _flight.note_barrier(
                            time.monotonic() - self._hold_t0
                        )
                        self._hold_t0 = None
                    self._close_epoch(workers=local_workers)
                    self._holding = False
                    self._stall_t0 = None
                    epoch_started = time.monotonic()
                    self._reports = {}
                    self._last_report = None
                    if (
                        final
                        or self._stop_agreed
                        or self._reconfig_agreed is not None
                    ):
                        # EOF, or the close's sync round agreed the
                        # cluster stops (or reconfigures): every
                        # process saw the same votes, so all exit
                        # (resp. unwind to the run-startup re-entry)
                        # after this same committed close.
                        break

                if clustered:
                    self._pump()

                if not (clustered and self._holding):
                    for rt in inputs:
                        if not rt.eof and rt.poll(now):
                            self._progressed = True

                for rt in self.rts:
                    # Due timers fire before newly-arrived data (the
                    # reference's activate_after wakeups run as soon
                    # as due, ahead of later input).
                    if not (clustered and self._holding):
                        rt.advance(now)
                    rt.drain()
                    if (
                        not clustered
                        and not rt.eof
                        and not rt.queued()
                        and not isinstance(rt, _InputRt)
                    ):
                        if rt.op.up_streams() and rt.ups_eof():
                            rt.on_upstream_eof()
                            rt.drain()
                            rt.eof = True

                if clustered:
                    # Poll boundary: routed slices accumulated during
                    # this pass ship NOW — before the quiescence
                    # report below is computed, so the count-matched
                    # barrier can never observe drained queues while
                    # frames still sit in the accumulator.
                    self.ship_flush()

                if self._ckpt_lane is not None:
                    # Liveness: surface a landed commit's finalizer
                    # (durable-epoch/lag bookkeeping) without
                    # blocking on one still in flight.
                    self._ckpt_lane.finalize_ready()

                elapsed = time.monotonic() - epoch_started

                if not clustered:
                    if all(rt.eof for rt in self.rts):
                        self._close_epoch()
                        break
                    if (
                        elapsed >= interval_s
                        and (interval_s > 0 or self._progressed)
                    ) or _STOP_EVENT.is_set():
                        # Quiesce the dispatch pipelines INLINE before
                        # the close (no new input may sneak in
                        # between): each flush emits into downstream
                        # queues, and the drain pass cascades those
                        # emissions to the sinks so this epoch's
                        # snapshots cover them; downstream steps may
                        # push fresh device phases while draining,
                        # hence the loop.
                        while self._drain_pipelines():
                            for rt in self.rts:
                                rt.drain()
                        self._close_epoch()
                        if (
                            self._stop_agreed
                            or self._reconfig_agreed is not None
                        ):
                            # Graceful drain-to-stop (or the live
                            # reconfigure unwind): the close above
                            # committed this epoch's snapshots/DLQ, so
                            # the resume — in-process for a
                            # reconfigure — replays zero epochs.
                            break
                        epoch_started = time.monotonic()
                else:
                    want_close = (
                        elapsed >= interval_s
                        and (
                            interval_s > 0
                            or self._progressed
                            or self._holding
                        )
                    ) or _STOP_EVENT.is_set()
                    if self.stall_s > 0:
                        # Watchdog clock: time spent WANTING an epoch
                        # close (or holding the barrier) without one
                        # arriving — a wedge signature (lost report,
                        # dropped data frame breaking the count-
                        # matched check, a peer stuck in a
                        # collective).  An idle-but-healthy flow
                        # (interval 0, no progress, nothing held)
                        # never arms it.
                        if not (want_close or self._holding):
                            self._stall_t0 = None
                        elif self._stall_t0 is None:
                            self._stall_t0 = time.monotonic()
                        elif (
                            time.monotonic() - self._stall_t0
                            > self.stall_s
                        ):
                            stalled = time.monotonic() - self._stall_t0
                            msg = (
                                f"epoch {self.epoch} wanted to close "
                                f"for {stalled:.1f}s with no close "
                                f"broadcast (> {self.stall_s:.0f}s "
                                "BYTEWAX_TPU_EPOCH_STALL_S watchdog); "
                                "the cluster barrier looks wedged"
                            )
                            raise EpochStalled(
                                msg, epoch=self.epoch, stalled_s=stalled
                            )
                    report = self._local_report(want_close)
                    if self.proc_id == 0:
                        self._reports[0] = report
                        self._coord_decide()
                    elif report != self._last_report:
                        self.comm.send(0, ("report_msg", report))
                        self._last_report = report
                    # A pending close (set by a pumped message or by
                    # _coord_decide) is handled at the top of the next
                    # iteration, before any further pump — peers may
                    # already have closed their sockets by then.

                if self._gc_managed and interval_s > 10.0:
                    # Long/infinite epochs must not defer collection
                    # to an epoch close that may be minutes away
                    # (embedding hosts and other threads still make
                    # cyclic garbage): collect on a flat 10s wall
                    # clock between closes.
                    now_m = time.monotonic()
                    if now_m - self._last_gc >= 10.0:
                        import gc as _gc

                        _gc.collect()
                        self._last_gc = time.monotonic()

                if not self._progressed:
                    waits = []
                    for rt in inputs:
                        if rt.eof:
                            continue
                        at = rt.next_poll_at()
                        if at is not None:
                            waits.append((at - now).total_seconds())
                        else:
                            waits.append(0.0)
                    for rt in self.rts:
                        if isinstance(rt, _StatefulBatchRt):
                            at = rt.next_notify_at()
                            if at is not None:
                                waits.append((at - now).total_seconds())
                    if interval_s > 0:
                        waits.append(interval_s - elapsed)
                    wait = min(waits) if waits else 0.001
                    wait = min(max(wait, 0.0), 0.05)
                    if wait > 0.001 and any(
                        isinstance(rt, _StatefulBatchRt)
                        and rt._pipe_pending()
                        for rt in self.rts
                    ):
                        # An in-flight device phase finalizes on the
                        # next drain pass; idling the full backoff
                        # here would add up to 50ms of emission
                        # latency per pipelined delivery.
                        wait = 0.001
                    if clustered:
                        if wait > 0 and self._pending_close is None:
                            self._pump(timeout=wait)
                    elif wait > 0:
                        time.sleep(wait)
            # Clean exit (EOF, agreed stop, agreed reconfigure): the
            # final close's snapshot commit may still be riding the
            # committer lane — land it before teardown so the next
            # execution resumes past every closed epoch (stop and
            # reconfigure closes already fenced inside the close; a
            # commit fault here propagates restartable like any
            # other).
            self._ckpt_fence()
        except _Abort:
            aborted = True
            if clustered:
                try:
                    self.comm.broadcast(("abort",))
                except Exception:  # noqa: BLE001
                    pass
        except BaseException as ex:
            if clustered:
                supervised_fault = _max_restarts() > 0 and isinstance(
                    ex, _RESTARTABLE
                )
                if not supervised_fault:
                    try:
                        self.comm.broadcast(("abort",))
                    except Exception:  # noqa: BLE001
                        pass
                # Under supervision a restartable fault unwinds
                # ABRUPTLY: no abort broadcast (which would make the
                # peers exit cleanly instead of restarting).  The
                # finally below closes the mesh, so peers observe a
                # socket close — exactly like a real crash — raise
                # ClusterPeerDead, and restart under their own
                # supervisors; the restarted cluster re-forms at the
                # handshake and resumes from the last committed epoch.
            raise
        finally:
            if self._gc_managed:
                gc.enable()
            # Stop pipeline workers before the mesh/store teardown: a
            # clean exit drained them already; a fault unwind waits
            # for the in-flight task to go quiet (no finalizers run)
            # so a supervised restart never races a stale worker.
            for rt in self.rts:
                shutdown = getattr(rt, "pipeline_shutdown", None)
                if shutdown is not None:
                    shutdown()
            # The run's last readbacks (EOF finals, the closing
            # snapshots) waited on every launch: their device times
            # resolve now, without blocking.
            _flight.DEVICE_TIMES.resolve()
            self._ckpt_shutdown()
            if api_server is not None:
                api_server.shutdown()
            if clustered:
                self.comm.close()
            if self.store is not None:
                self.store.close()

        if not aborted:
            for rt in self.rts:
                rt.close()
        if self._stop_agreed:
            status = GracefulStop(
                self.epoch - 1,
                generation=self.generation,
                proc_id=self.proc_id,
            )
            _flight.note_graceful_stop(status.epoch)
            return status
        if self._reconfig_agreed is not None:
            # Internal status: _supervised re-enters run startup
            # in-process at the new shape (or retires this process).
            # The runtimes above closed exactly as a graceful stop's
            # would — the rebuild resumes everything from the store.
            addrs, wpp = self._reconfig_agreed
            return _Reconfigure(list(addrs), wpp, self.epoch - 1)
        return None


def run_main(
    flow: Dataflow,
    *,
    epoch_interval: Optional[timedelta] = None,
    recovery_config: Optional[Any] = None,
) -> Optional[GracefulStop]:
    """Execute a dataflow in the current process with one worker lane.

    Blocks until execution is complete.  Entry-point parity with the
    reference's ``run_main`` (``src/run.rs:114-146``).  Returns
    ``None`` on EOF completion, or a typed
    :class:`~bytewax_tpu_torch.errors.GracefulStop` when a cooperative stop
    request (SIGTERM/SIGINT via the CLI, ``POST /stop``, or
    :func:`request_stop`) drained the execution at an epoch close —
    the resumed store then replays zero epochs.

    :arg flow: Dataflow to run.
    :arg epoch_interval: System time length of each epoch (snapshot
        interval).  Defaults to 10 seconds.
    :arg recovery_config: State recovery config.  Defaults to no
        recovery.

    With ``BYTEWAX_TPU_MAX_RESTARTS`` set, runs under the restart
    supervisor: restartable faults (injected chaos, snapshot
    hiccups) rebuild the driver — which recomputes ``resume_from()``
    — and resume from the last committed epoch with exponential
    backoff.

    Resuming a recovery store written by a different worker count
    refuses with :class:`WorkerCountMismatchError` unless
    rescale-on-resume is enabled (``--rescale`` /
    ``BYTEWAX_TPU_RESCALE=1``), in which case the keyed state is
    re-sharded at startup (docs/recovery.md).
    """
    def _make(gen: int, reconf: Optional["_Reconfigure"] = None):
        addrs = list(reconf.addresses) if reconf is not None else None
        return _Driver(
            flow,
            worker_count=(
                reconf.wpp if reconf is not None and reconf.wpp else 1
            ),
            epoch_interval=epoch_interval,
            recovery_config=recovery_config,
            addresses=addrs if addrs and len(addrs) > 1 else None,
            proc_id=0,
            generation=gen,
            force_rescale=reconf is not None,
        )

    return _supervised(_make, proc_id=0)


def cluster_main(
    flow: Dataflow,
    addresses: List[str],
    proc_id: int,
    *,
    epoch_interval: Optional[timedelta] = None,
    recovery_config: Optional[Any] = None,
    worker_count_per_proc: int = 1,
) -> Optional[GracefulStop]:
    """Execute a dataflow in the current process as part of a cluster.

    Entry-point parity with the reference's ``cluster_main``
    (``src/run.rs:239-351``).  With an empty ``addresses`` list this
    runs all ``worker_count_per_proc`` worker lanes in-process (this
    is how multi-worker semantics are unit tested, mirroring the
    reference's in-process Timely cluster).  With multiple addresses
    the processes form a TCP mesh for keyed exchange and epoch/EOF
    coordination (see :mod:`bytewax_tpu_torch.engine.comm`); launch every
    process with the same flow and its own ``proc_id``.

    With ``BYTEWAX_TPU_MAX_RESTARTS`` set, each process runs under its
    own restart supervisor: peer death (:class:`ClusterPeerDead`), a
    wedged epoch barrier (:class:`EpochStalled`), and injected chaos
    faults tear the mesh down, the restarted processes re-form it with
    a new fenced generation, and execution resumes from the last
    committed epoch.

    A cluster relaunched against a recovery store written by a
    DIFFERENT total worker count (processes × lanes) refuses with
    :class:`WorkerCountMismatchError` unless rescale-on-resume is
    enabled (``--rescale`` / ``BYTEWAX_TPU_RESCALE=1``): the keyed
    state is then re-sharded to the new routing at run startup — the
    one globally-ordered re-entry point — before any epoch
    processing, preserving exactly-once via the truncating-sink
    resume (docs/recovery.md).

    Returns ``None`` on EOF completion, or a typed
    :class:`~bytewax_tpu_torch.errors.GracefulStop` after a cooperative
    drain-to-stop: a stop requested on ANY process rides the
    epoch-close sync round, every process commits the same final
    epoch, and all exit cleanly together (docs/recovery.md "Graceful
    drain-to-stop").
    """
    def _make(gen: int, reconf: Optional["_Reconfigure"] = None):
        addrs = (
            list(reconf.addresses)
            if reconf is not None
            else addresses
        )
        return _Driver(
            flow,
            worker_count=(
                reconf.wpp
                if reconf is not None and reconf.wpp
                else worker_count_per_proc
            ),
            epoch_interval=epoch_interval,
            recovery_config=recovery_config,
            addresses=addrs if addrs and len(addrs) > 1 else None,
            proc_id=proc_id,
            generation=gen,
            force_rescale=reconf is not None,
        )

    return _supervised(_make, proc_id=proc_id)
