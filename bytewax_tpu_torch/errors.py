"""Framework error types and location-tracked error chaining.

The reference implements this in Rust (``src/errors.rs``): a
``PythonException`` trait whose ``raise``/``reraise`` helpers wrap
user exceptions in engine context, tagging every layer with the
``#[track_caller]`` location that added it.  The tpu-native analog
rides Python 3.11+ exception notes: engine layers call
:func:`note_context`, which appends the message plus the annotating
frame's ``file:line``; :func:`callable_location` points at the *user*
callable's def site so operator errors name the lambda that raised,
not just the step.
"""

import errno as _errno
import sys
from typing import Callable, Optional

__all__ = [
    "BytewaxRuntimeError",
    "ClusterPeerDead",
    "DeviceFault",
    "EpochStalled",
    "GracefulStop",
    "TransientIOError",
    "TransientSinkError",
    "TransientSourceError",
    "WireFormatError",
    "callable_location",
    "is_transient_io_error",
    "note_context",
]


class BytewaxRuntimeError(RuntimeError):
    """Raised when the engine encounters a runtime error."""


class ClusterPeerDead(ConnectionError):
    """A cluster peer stopped responding (heartbeat silence) or closed
    its connection mid-run.

    Subclasses :class:`ConnectionError` so existing handlers keep
    working; carries the peer id and how long it was silent so the
    supervisor can log a useful restart reason.  Restartable: the
    supervisor (``BYTEWAX_TPU_MAX_RESTARTS``) tears the mesh down and
    resumes from the last committed epoch.
    """

    # Defaults keep the error picklable: BaseException's reduce
    # replays only self.args (the message); peer/silence_s ride along
    # in __dict__ state.
    def __init__(
        self, msg: str, *, peer: int = -1, silence_s: Optional[float] = None
    ):
        super().__init__(msg)
        self.peer = peer
        self.silence_s = silence_s


class EpochStalled(BytewaxRuntimeError):
    """The clustered epoch protocol made no progress for longer than
    the ``BYTEWAX_TPU_EPOCH_STALL_S`` watchdog limit (e.g. a dropped
    data frame wedged the count-matched barrier).  Restartable."""

    # Defaults for pickle round-trips (see ClusterPeerDead).
    def __init__(
        self, msg: str, *, epoch: int = -1, stalled_s: float = 0.0
    ):
        super().__init__(msg)
        self.epoch = epoch
        self.stalled_s = stalled_s


class GracefulStop:
    """Typed completion status of a cooperative drain-to-stop
    (docs/recovery.md "Graceful drain-to-stop").

    Returned — not raised — by ``run_main``/``cluster_main`` when a
    stop request (SIGTERM/SIGINT, ``POST /stop``, or
    ``engine.driver.request_stop()``) drained the execution: the
    in-flight epoch closed normally (pipelines flushed, DLQ flushed,
    snapshots committed) and every cluster process agreed on the stop
    via the epoch-close sync round, so resuming the recovery store
    replays zero epochs.  ``None`` means the flow ran to EOF instead.

    ``epoch`` is the last epoch that closed (and committed) before
    the exit; a subsequent resume starts at ``epoch + 1``.
    """

    __slots__ = ("epoch", "generation", "proc_id")

    def __init__(
        self, epoch: int, *, generation: int = 0, proc_id: int = 0
    ):
        self.epoch = epoch
        self.generation = generation
        self.proc_id = proc_id

    def __repr__(self) -> str:
        return (
            f"GracefulStop(epoch={self.epoch}, "
            f"generation={self.generation}, proc_id={self.proc_id})"
        )


class DeviceFault(BytewaxRuntimeError):
    """A device-tier dispatch failed before mutating device state (a
    flaky accelerator, or the fault injector's ``device_dispatch``
    site).  The driver retries the dispatch and, after K consecutive
    faults on a step, demotes that step to the host tier for the rest
    of the execution (``BYTEWAX_TPU_DEMOTE_AFTER``).

    Raisers must guarantee no device state was mutated: the driver
    retries the same delivery, so a partially-applied update would
    double-count.
    """


class TransientIOError(BytewaxRuntimeError):
    """A connector-edge I/O operation failed in a way that is worth
    retrying in place (docs/recovery.md "Connector-edge resilience").

    The driver retries the poll/write with capped jittered exponential
    backoff (``BYTEWAX_TPU_IO_RETRIES`` / ``BYTEWAX_TPU_IO_BACKOFF_S``)
    instead of unwinding the whole execution; exhaustion escalates to
    the restartable-fault/supervisor path.  Raisers must guarantee the
    failed call consumed/produced nothing — the engine re-invokes it
    with the same position/values, so a partial effect would
    double-count.
    """


class TransientSourceError(TransientIOError):
    """A source partition's ``next_batch`` failed transiently (broker
    hiccup, EAGAIN, timeout).  Raise it from ``next_batch`` *before*
    advancing the read position: the driver re-polls the partition
    after a backoff while the rest of the dataflow keeps flowing, and
    — with ``BYTEWAX_TPU_QUARANTINE=1`` — parks the partition at its
    last good offset after the retry budget is spent."""


class TransientSinkError(TransientIOError):
    """A sink partition's ``write_batch`` failed transiently.  Raise
    it *before* any of the batch is durably written (or from a sink
    that deduplicates): the driver retries the same batch in place —
    strictly before the epoch's snapshot commit, so exactly-once
    output is untouched — and escalates after the retry budget."""


class WireFormatError(BytewaxRuntimeError):
    """A received cluster-mesh frame claimed the columnar wire
    encoding (docs/performance.md "Columnar exchange") but could not
    be decoded: an unsupported frame version (mixed-version cluster —
    run the rollout on ``BYTEWAX_TPU_WIRE=pickle``), an unknown
    column encoding, or a truncated/corrupted header.  Raised instead
    of guessing at the payload — and deliberately FATAL, not
    supervisor-restartable: the peer would re-send the same encoding
    after a restart (a version skew does not heal by retrying), so a
    restart loop would only hide the operator error the message
    names."""


#: ``OSError`` errnos classified transient by default: interrupted /
#: would-block reads, timeouts, and peer-reset style network failures
#: — the shapes a flaky file descriptor or broker connection produces.
#: Deliberately conservative: permission, missing-file, and
#: out-of-space errors are NOT here (retrying them is a hot loop to
#: nowhere).
TRANSIENT_ERRNOS = frozenset(
    {
        _errno.EAGAIN,
        _errno.EWOULDBLOCK,
        _errno.EINTR,
        _errno.EIO,
        _errno.EBUSY,
        _errno.ETIMEDOUT,
        _errno.ECONNRESET,
        _errno.ECONNABORTED,
        _errno.ECONNREFUSED,
        _errno.EPIPE,
        _errno.ENETDOWN,
        _errno.ENETUNREACH,
        _errno.ENETRESET,
        _errno.EHOSTDOWN,
        _errno.EHOSTUNREACH,
    }
)


def is_transient_io_error(ex: BaseException) -> bool:
    """Whether the connector edge should retry ``ex`` in place.

    True for the typed :class:`TransientIOError` family, for
    ``TimeoutError``, and for any ``OSError`` whose errno is in
    :data:`TRANSIENT_ERRNOS` — except :class:`ClusterPeerDead`, which
    is mesh-liveness (a ``ConnectionError`` subclass), not connector
    I/O, and must keep unwinding to the supervisor.

    >>> from bytewax_tpu_torch.errors import is_transient_io_error
    >>> import errno, os
    >>> is_transient_io_error(OSError(errno.EAGAIN, os.strerror(errno.EAGAIN)))
    True
    >>> is_transient_io_error(OSError(errno.ENOENT, "gone"))
    False
    """
    if isinstance(ex, ClusterPeerDead):
        return False
    if isinstance(ex, (TransientIOError, TimeoutError)):
        return True
    return (
        isinstance(ex, OSError) and ex.errno in TRANSIENT_ERRNOS
    )


def callable_location(f: Callable) -> Optional[str]:
    """Best-effort ``file:line`` of a user callable's definition.

    >>> from bytewax_tpu_torch.errors import callable_location
    >>> def my_mapper(x):
    ...     return x
    >>> callable_location(my_mapper)  # doctest: +ELLIPSIS
    '...:...'
    """
    # Operator-lowering shims mark the user callable they wrap with
    # ``__wrapped__``; report the user's code, not the shim.
    seen = 0
    while hasattr(f, "__wrapped__") and seen < 8:
        f = f.__wrapped__
        seen += 1
    code = getattr(f, "__code__", None)
    if code is None:
        # functools.partial and callable objects: look through to the
        # wrapped function / __call__ method.
        inner = getattr(f, "func", None)
        if inner is None:
            inner = getattr(type(f), "__call__", None)
        code = getattr(inner, "__code__", None)
    if code is None:
        return None
    return f"{code.co_filename}:{code.co_firstlineno}"


def note_context(
    ex: BaseException,
    msg: str,
    *,
    fn: Optional[Callable] = None,
    _depth: int = 1,
) -> None:
    """Attach engine context to ``ex`` as an exception note, tagged
    with the annotating engine frame's ``file:line`` (the analog of
    the reference's ``#[track_caller]`` chaining); with ``fn``, also
    name the user callable's def site.

    ``_depth`` selects which frame to blame: 1 (default) is the
    direct caller; wrappers that annotate on behalf of their own
    caller pass 2.
    """
    add_note = getattr(ex, "add_note", None)
    if add_note is None:
        # Pre-3.11: emulate PEP 678.  ``__notes__`` is just a list of
        # str the 3.11+ traceback printer reads; maintaining it by
        # hand keeps the context inspectable (and our tests passing)
        # on older interpreters, even if 3.10's printer won't render
        # it in tracebacks.
        def add_note(note: str, _ex: BaseException = ex) -> None:
            notes = getattr(_ex, "__notes__", None)
            if notes is None:
                notes = []
                _ex.__notes__ = notes
            notes.append(note)
    try:
        frame = sys._getframe(_depth)
        loc = f" (engine at {frame.f_code.co_filename}:{frame.f_lineno})"
    except ValueError:  # pragma: no cover - frame depth exceeded
        loc = ""
    try:
        add_note(msg + loc)
        if fn is not None:
            floc = callable_location(fn)
            if floc is not None:
                add_note(f"user callable defined at {floc}")
    except TypeError:  # pragma: no cover - frozen exception classes
        pass
