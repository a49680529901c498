"""Per-process engine flight recorder.

The host tier already meters user-code call sites
(:mod:`bytewax_tpu_torch._metrics`); this module is the telemetry floor for
the parts the reference never had — the device tier and the clustered
epoch protocol.  It keeps, per process:

- a bounded in-memory **ring** of structured events (epoch open/close,
  snapshot, barrier enter/exit, gsync round, device dispatch, XLA
  compile, host↔device transfer) — written only when the recorder is
  :func:`enabled` (``BYTEWAX_FLIGHT_RECORDER`` or the dataflow API
  server), so the hot path pays nothing for it otherwise;
- always-on scalar **counters** (plain dict adds — allocation-free),
  mirrored into the Prometheus families in
  :mod:`bytewax_tpu_torch._metrics` so ``GET /metrics`` exposes them;
- a bounded buffer of recent **epoch-close durations** for p50/p99
  reporting (``bench.py`` and the ``/status`` plane);
- the latest **cluster summaries** collected by the gsync piggyback at
  epoch close (see ``engine/driver.py``), so process 0's ``/status``
  shows every process;
- the **epoch ledger**: per-epoch, per-step time attribution
  (always-on dict adds, like the counters).  Instrumented phase
  boundaries in the driver, the dispatch pipeline, and the residency
  manager call :func:`note_phase` with *exclusive* durations — a
  parent phase (an epoch-close sub-phase, a host drain) subtracts the
  gross time of phases nested inside it via the phase stack, so the
  per-epoch sums are disjoint main-thread intervals (the ``device``
  phase is the exception: it is measured on the pipeline worker and
  overlaps the host phases by design).  ``note_epoch_close`` seals
  the accumulating ledger into a per-epoch record carrying the
  full-epoch phase breakdown, the close-window breakdown (whose sum
  tracks ``epoch_close_duration_seconds``), source-lag samples, and
  drain-point queue depths.  Sealed records feed ``/status``, the
  epoch-close gsync piggyback, ``bench.py``'s phase fractions, the
  rescale hint, and — with ``BYTEWAX_TPU_TRACE_DIR`` set — a
  Chrome/Perfetto ``trace_event`` JSON dump per completed epoch;
- **spans** inside the phases (:class:`span`): always-on
  ``<name>_seconds`` counters for parts of a phase — the dispatch
  task's vocabulary work and copies, text decode, user mappers —
  that never enter the ledger (docs/torch-tracing.md);
- **device time** of kernel launches (:data:`DEVICE_TIMES`): CUDA
  event pairs resolved without blocking into ``<name>_device_seconds``.

While a ``torch.profiler`` session records, every ledger phase and
span is also a range ``bytewax.<name>`` on its own thread, on the
profiler's clock (:func:`open_range`).

Thread-safety note: counters are GIL-atomic dict updates read racily
by the API server thread; they are observability data, not an epoch
protocol, and a torn read is harmless.
"""

import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "DEVICE_TIMES",
    "RECORDER",
    "DeviceTimes",
    "FlightRecorder",
    "close_range",
    "enabled",
    "ledger_fractions",
    "note_autoscale",
    "note_barrier",
    "note_comm",
    "note_demotion",
    "note_dlq",
    "note_graceful_stop",
    "note_eviction",
    "note_fault",
    "note_fenced",
    "note_flush_depth",
    "note_gsync",
    "note_io_retry",
    "note_phase",
    "note_pipeline_depth",
    "note_pipeline_stall",
    "note_quarantine",
    "note_quarantine_reset",
    "note_reconfigure",
    "note_reconfigure_requested",
    "note_rescale",
    "note_resident",
    "note_residency_restore",
    "note_restart",
    "note_snapshot_lag",
    "note_source_lag",
    "note_spill",
    "note_stop_requested",
    "note_transfer",
    "note_unquarantine",
    "note_wire",
    "open_range",
    "phase",
    "span",
    "wire_status",
    "write_postmortem",
]

_RING_LEN = int(os.environ.get("BYTEWAX_FLIGHT_RING", 512))
#: Epoch-close durations kept for percentile reporting.
_CLOSE_BUF = 1024
#: Ring events returned in a /status snapshot.
_TAIL = 64
#: Sealed epoch-ledger records kept for /status.
_LEDGER_BUF = 32
#: Phase intervals collected per epoch for the Perfetto dump (beyond
#: this the dump is truncated, never the ledger sums).
_SPAN_CAP = 4096

#: Phases recorded off the main thread (pipeline-worker lanes): they
#: overlap the close window rather than occupying it, so the sealed
#: close breakdown excludes them.  ``collective_lane`` is the
#: overlapped global-exchange round (docs/performance.md "Overlapped
#: collectives"); ``snapshot_lane`` is the asynchronous checkpoint
#: committer (docs/recovery.md "Asynchronous incremental
#: checkpoints").
_OFF_THREAD_PHASES = frozenset(
    {"device", "collective_lane", "snapshot_lane"}
)


def _truthy(name: str) -> bool:
    """Repo convention (matches ``BYTEWAX_TPU_ACCEL``): unset, empty,
    and ``0`` mean off; anything else means on."""
    return os.environ.get(name, "0") not in ("", "0")


def enabled() -> bool:
    """Whether ring recording should be on for this process
    (``BYTEWAX_FLIGHT_RECORDER`` or the dataflow API server being
    enabled).  In clustered runs the driver exchanges this value at
    startup and turns the epoch-close summary sync on only when every
    process agrees."""
    return _truthy("BYTEWAX_FLIGHT_RECORDER") or _truthy(
        "BYTEWAX_DATAFLOW_API_ENABLED"
    )


class FlightRecorder:
    """Bounded ring of engine events + always-on counters."""

    def __init__(self, ring_len: int = _RING_LEN):
        self._ring: deque = deque(maxlen=max(ring_len, 16))
        self.counters: Dict[str, float] = {}
        self._close_s: deque = deque(maxlen=_CLOSE_BUF)
        self.active = False
        #: proc_id -> latest piggybacked summary (clustered runs).
        self.cluster: Dict[int, Any] = {}
        #: Process id stamped by the driver at run start (Perfetto
        #: file names, postmortems).
        self.proc_id = 0
        # -- epoch ledger ------------------------------------------------
        #: (phase, step_id) -> exclusive seconds in the CURRENT epoch.
        self._ledger: Dict[Tuple[str, str], float] = {}
        #: Ledger snapshot taken at close start, for the close-window
        #: breakdown (phases accrued during the close itself).
        self._ledger_pre_close: Optional[Dict[Tuple[str, str], float]] = None
        #: Phase intervals (phase, step, t0_monotonic, gross_s, lane)
        #: for the Perfetto dump; collected only when trace_dir is set.
        self._spans: List[Tuple[str, str, float, float, int]] = []
        #: Nested-phase accounting: each frame accumulates the gross
        #: seconds of phases recorded while it was open, so the parent
        #: records exclusive time.
        self._phase_stack: List[List[float]] = []
        #: Max pending tasks observed at each step's pipeline drain.
        self._flush_depth: Dict[str, int] = {}
        #: (step_id, kind) -> latest source-lag sample in seconds.
        self._lag: Dict[Tuple[str, str], float] = {}
        #: Lifetime per-phase totals (rescale hint, bench fractions).
        self.phase_totals: Dict[str, float] = {}
        #: Latest sealed per-epoch ledger record (also what the
        #: epoch-close gsync piggyback ships).
        self.last_ledger: Optional[Dict[str, Any]] = None
        self._ledgers: deque = deque(maxlen=_LEDGER_BUF)
        self._epoch_t0 = time.monotonic()
        self.trace_dir = (
            os.environ.get("BYTEWAX_TPU_TRACE_DIR", "").strip() or None
        )

    def activate(self, on: bool) -> None:
        self.active = bool(on)
        # Re-read at run start so a supervised restart (same process,
        # fresh driver) honors env changes the same way the ring does.
        self.trace_dir = (
            os.environ.get("BYTEWAX_TPU_TRACE_DIR", "").strip() or None
        )
        # Fresh per-epoch accumulators: a supervised restart must not
        # seal the crashed generation's partial epoch (already in the
        # postmortem) into the new generation's first record, and the
        # first record's wall clock starts at run start, not import.
        # Lifetime state (phase_totals, sealed records, counters)
        # deliberately survives.
        self._ledger = {}
        self._ledger_pre_close = None
        self._spans = []
        self._phase_stack = []
        self._flush_depth = {}
        self._lag = {}
        self._epoch_t0 = time.monotonic()

    # -- hot-path writers --------------------------------------------------

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def record(self, kind: str, **attrs: Any) -> None:
        """Append one structured event to the ring (no-op unless the
        recorder is active — the gate keeps the hot path
        allocation-free by default)."""
        if not self.active:
            return
        self._ring.append((time.time(), kind, attrs))

    # -- epoch ledger ------------------------------------------------------

    def phase_push(self) -> None:
        """Open a parent phase frame: nested phases recorded before
        the matching :meth:`phase_pop` add their gross time here, so
        the parent can record exclusive (self) time."""
        self._phase_stack.append([0.0])

    def phase_pop(self) -> float:
        """Close the innermost parent frame; returns the gross
        seconds of the phases nested inside it."""
        return self._phase_stack.pop()[0]

    def ledger_add(
        self,
        phase: str,
        step_id: str,
        seconds: float,
        gross: Optional[float] = None,
        t0: Optional[float] = None,
        lane: int = 0,
    ) -> None:
        """Accumulate ``seconds`` (exclusive time) into the current
        epoch's ledger.  ``gross`` (default: ``seconds``) is the whole
        interval including nested phases — charged to the enclosing
        phase frame so parents record self time only.  ``lane`` 0 is
        the main thread; other lanes (the pipeline worker) overlap it
        and never charge a parent frame."""
        key = (phase, step_id)
        self._ledger[key] = self._ledger.get(key, 0.0) + seconds
        if gross is None:
            gross = seconds
        if lane == 0 and self._phase_stack:
            self._phase_stack[-1][0] += gross
        if (
            self.trace_dir
            and t0 is not None
            and len(self._spans) < _SPAN_CAP
        ):
            self._spans.append((phase, step_id, t0, gross, lane))

    def mark_close(self) -> None:
        """Driver hook at the start of an epoch close: phases accrued
        from here to the seal form the close-window breakdown."""
        self._ledger_pre_close = dict(self._ledger)

    @staticmethod
    def _nested(
        ledger: Dict[Tuple[str, str], float],
    ) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for (phase, step), s in ledger.items():
            out.setdefault(phase, {})[step] = round(s, 6)
        return out

    def ledger_lag(self) -> Dict[str, float]:
        # Read by the API server thread mid-run: copy-with-retry like
        # every other cross-thread dict read here.
        lag = self._copied(lambda: dict(self._lag), {})
        return {
            f"{kind}[{step}]": round(v, 6)
            for (step, kind), v in lag.items()
        }

    def _seal_ledger(
        self, epoch: int, close_s: float
    ) -> Dict[str, Any]:
        """Turn the accumulating ledger into this epoch's sealed
        record, roll the phase totals, dump the Perfetto trace when
        armed, and reset for the next epoch."""
        now = time.monotonic()
        pre = self._ledger_pre_close or {}
        close_phases: Dict[str, float] = {}
        for (phase, step), s in self._ledger.items():
            if phase in _OFF_THREAD_PHASES:
                continue
            d = s - pre.get((phase, step), 0.0)
            if d > 0:
                close_phases[phase] = close_phases.get(phase, 0.0) + d
        record: Dict[str, Any] = {
            "epoch": epoch,
            "wall_s": round(now - self._epoch_t0, 6),
            "close_s": round(close_s, 6),
            "phases": self._nested(self._ledger),
            "close": {
                k: round(v, 6) for k, v in close_phases.items()
            },
            "lag": self.ledger_lag(),
            "queue_depth_at_drain": dict(self._flush_depth),
        }
        for (phase, _step), s in self._ledger.items():
            self.phase_totals[phase] = (
                self.phase_totals.get(phase, 0.0) + s
            )
        self.last_ledger = record
        self._ledgers.append(record)
        if self.trace_dir:
            self._dump_trace(epoch, self._epoch_t0, now)
        self._ledger = {}
        self._ledger_pre_close = None
        self._spans = []
        self._flush_depth = {}
        self._epoch_t0 = now
        return record

    def _dump_trace(
        self, epoch: int, epoch_t0: float, now: float
    ) -> None:
        """Write this epoch's phase intervals as Chrome/Perfetto
        ``trace_event`` JSON (one file per completed epoch; open in
        ui.perfetto.dev).  Best-effort: a full disk must never fail
        an epoch close."""
        pid = os.getpid()
        events: List[Dict[str, Any]] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "args": {
                    "name": f"bytewax_tpu_torch proc {self.proc_id}"
                },
            },
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": 1,
                "args": {"name": "driver (host)"},
            },
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": 2,
                "args": {"name": "device pipeline"},
            },
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": 3,
                "args": {"name": "collective lane"},
            },
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": 4,
                "args": {"name": "snapshot lane"},
            },
            {
                "name": f"epoch {epoch}",
                "cat": "epoch",
                "ph": "X",
                "ts": epoch_t0 * 1e6,
                "dur": (now - epoch_t0) * 1e6,
                "pid": pid,
                "tid": 1,
            },
        ]
        for phase, step, t0, gross, lane in self._spans:
            events.append(
                {
                    "name": phase,
                    "cat": phase,
                    "ph": "X",
                    "ts": t0 * 1e6,
                    "dur": gross * 1e6,
                    "pid": pid,
                    # The overlapped collectives' ordered lane (and
                    # the checkpoint committer lane) get their own
                    # tracks: their spans overlap the NEXT epoch's
                    # device work, so sharing the device pipeline tid
                    # would render as nonsense nesting.
                    "tid": (
                        3
                        if phase == "collective_lane"
                        else 4
                        if phase == "snapshot_lane"
                        else 1 + lane
                    ),
                    "args": {"step_id": step},
                }
            )
        events.extend(self._counter_events(pid, epoch_t0, now))
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        try:
            os.makedirs(self.trace_dir, exist_ok=True)
            path = os.path.join(
                self.trace_dir,
                f"epoch-p{self.proc_id:02d}-{epoch:08d}.json",
            )
            with open(path, "w") as f:
                # Armed-only path, bounded spans: the JSON-safety
                # sweep keeps a numpy scalar in a span arg from
                # producing an unreadable trace file.
                json.dump(_json_safe(doc), f)
        except OSError:
            import logging

            logging.getLogger(__name__).debug(
                "could not write Perfetto trace for epoch %d", epoch
            )

    def _counter_events(
        self, pid: int, epoch_t0: float, now: float
    ) -> List[Dict[str, Any]]:
        """Perfetto counter tracks (``ph:"C"``) from the flow map's
        just-sealed epoch record: per-step rows/s, queue depth at
        drain, and watermark lag on the same timeline as the phase
        spans.  Two monotone samples per track (epoch open and close)
        so each epoch renders as a level, not a dot."""
        from bytewax_tpu_torch.engine.flowmap import FLOWMAP

        record = FLOWMAP.last
        if not record:
            return []
        events: List[Dict[str, Any]] = []

        def track(name: str, values: Dict[str, Any]) -> None:
            values = _json_safe(values)
            for ts in (epoch_t0 * 1e6, now * 1e6):
                events.append(
                    {
                        "name": name,
                        "ph": "C",
                        "ts": ts,
                        "pid": pid,
                        "args": values,
                    }
                )

        for step, sig in record.get("steps", {}).items():
            rates = {
                d: sig[f"rate_{d}_per_s"]
                for d in ("in", "out")
                if f"rate_{d}_per_s" in sig
            }
            if rates:
                track(f"rows/s {step}", rates)
            if "queue_depth_at_drain" in sig:
                track(
                    f"queue {step}",
                    {"depth": sig["queue_depth_at_drain"]},
                )
            if "watermark_lag_s" in sig:
                track(
                    f"lag {step}",
                    {"seconds": sig["watermark_lag_s"]},
                )
        return events

    def note_epoch_close(self, epoch: int, seconds: float) -> None:
        self.count("epoch_close_count")
        self.count("epoch_close_seconds", seconds)
        # The percentile buffer is always on (one float into a
        # bounded deque) so readers like bench.py get close latency
        # percentiles without turning on ring recording — which would
        # perturb the very hot loops being measured.
        self._close_s.append(seconds)
        self._seal_ledger(epoch, seconds)
        self.record(
            "epoch_close", epoch=epoch, seconds=round(seconds, 6)
        )

    # -- readers -----------------------------------------------------------
    #
    # Readers run on the API-server thread while the driver thread
    # appends; copies retry on the (rare) mutated-during-iteration
    # race instead of locking the hot-path writers.

    @staticmethod
    def _copied(fn, default):
        for _ in range(4):
            try:
                return fn()
            except RuntimeError:
                continue
        return default

    def epoch_close_percentiles(
        self,
    ) -> Optional[Tuple[float, float, int]]:
        """``(p50_seconds, p99_seconds, n)`` over the recent closes, or
        None before the first recorded close."""
        xs = sorted(self._copied(lambda: list(self._close_s), []))
        if not xs:
            return None
        n = len(xs)
        return xs[n // 2], xs[min(n - 1, int(n * 0.99))], n

    def tail(self, n: int = _TAIL) -> list:
        events = self._copied(lambda: list(self._ring), [])
        return [
            {"t": round(t, 6), "kind": kind, **attrs}
            for t, kind, attrs in events[-n:]
        ]

    def ledgers(self, n: int = _LEDGER_BUF) -> list:
        """The most recent sealed per-epoch ledger records."""
        return self._copied(lambda: list(self._ledgers), [])[-n:]

    def snapshot(self) -> Dict[str, Any]:
        """Full local view for ``GET /status``."""
        out: Dict[str, Any] = {
            "enabled": self.active,
            "counters": self._copied(lambda: dict(self.counters), {}),
            "tail": self.tail(),
        }
        pct = self.epoch_close_percentiles()
        if pct is not None:
            p50, p99, n = pct
            out["epoch_close_ms"] = {
                "p50": round(p50 * 1e3, 3),
                "p99": round(p99 * 1e3, 3),
                "count": n,
            }
        if self.last_ledger is not None:
            out["ledger"] = self.last_ledger
        return out

    def summary(self, epoch: int) -> Dict[str, Any]:
        """Compact per-process summary for the epoch-close gsync
        piggyback — counters, close percentiles, and the latest
        sealed epoch ledger (control-plane sized: no ring events; the
        ledger is a bounded handful of phase/step floats)."""
        out: Dict[str, Any] = {
            "epoch": epoch,
            "counters": self._copied(lambda: dict(self.counters), {}),
        }
        pct = self.epoch_close_percentiles()
        if pct is not None:
            p50, p99, n = pct
            out["epoch_close_ms"] = {
                "p50": round(p50 * 1e3, 3),
                "p99": round(p99 * 1e3, 3),
                "count": n,
            }
        if self.last_ledger is not None:
            out["ledger"] = self.last_ledger
        from bytewax_tpu_torch.engine.flowmap import FLOWMAP

        fm = FLOWMAP.summary()
        if fm is not None:
            out["flowmap"] = fm
        return out


RECORDER = FlightRecorder()


def _json_safe(obj: Any) -> Any:
    """Recursively convert a telemetry document to plain JSON-able
    types: numpy scalars to Python scalars, arrays to lists,
    datetime64/datetime to ISO strings, non-finite floats to None,
    non-string dict keys to strings.  Shared by the webserver
    payloads, crash postmortems, and the Perfetto writer so every
    observability surface is JSON-safe by construction — a numpy
    scalar deep in a status section must never 500 ``/status``."""
    import datetime as _dt
    import math

    import numpy as np

    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, (np.datetime64, np.timedelta64)):
        return str(obj)
    if isinstance(obj, np.generic):
        return _json_safe(obj.item())
    if isinstance(obj, np.ndarray):
        return [_json_safe(x) for x in obj.tolist()]
    if isinstance(obj, (_dt.datetime, _dt.date, _dt.time)):
        return obj.isoformat()
    if isinstance(obj, _dt.timedelta):
        return obj.total_seconds()
    if isinstance(obj, dict):
        return {
            (k if isinstance(k, str) else str(k)): _json_safe(v)
            for k, v in obj.items()
        }
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [_json_safe(x) for x in obj]
    if isinstance(obj, bytes):
        return obj.decode("utf-8", "replace")
    return str(obj)

# Cached Prometheus label children (one labels() resolution per
# distinct label set, not per event).
_transfer_children: Dict[str, Any] = {}
_comm_children: Dict[Tuple[str, str, int], Any] = {}
_lock = threading.Lock()


def note_transfer(direction: str, nbytes: int) -> None:
    """One host↔device transfer of ``nbytes`` (direction ``h2d`` or
    ``d2h``)."""
    child = _transfer_children.get(direction)
    if child is None:
        from bytewax_tpu_torch._metrics import device_transfer_bytes

        with _lock:
            child = _transfer_children.setdefault(
                direction, device_transfer_bytes.labels(direction)
            )
    child.inc(nbytes)
    RECORDER.count(f"device_transfer_bytes_{direction}", nbytes)
    RECORDER.record("transfer", direction=direction, bytes=int(nbytes))


def note_comm(direction: str, peer: int, nbytes: int) -> None:
    """One cluster-mesh frame to/from ``peer`` (direction ``tx`` or
    ``rx``); counters only — frames are too hot for ring events."""
    key = ("frames", direction, peer)
    frames = _comm_children.get(key)
    if frames is None:
        from bytewax_tpu_torch._metrics import comm_bytes, comm_frames

        with _lock:
            frames = _comm_children.setdefault(
                key, comm_frames.labels(str(peer), direction)
            )
            _comm_children.setdefault(
                ("bytes", direction, peer),
                comm_bytes.labels(str(peer), direction),
            )
    frames.inc()
    _comm_children[("bytes", direction, peer)].inc(nbytes)
    RECORDER.count(f"comm_frames_{direction}")
    RECORDER.count(f"comm_bytes_{direction}", nbytes)


_wire_children: Dict[Tuple[str, str], Any] = {}


def note_wire(op: str, codec: str, nbytes: int, seconds: float) -> None:
    """One wire-codec pass over a cluster-mesh payload (``op``
    ``encode``/``decode``, ``codec`` ``columnar``/``pickle``);
    counters only — frames are too hot for ring events."""
    key = (op, codec)
    # Both label children live under ONE key (installed atomically
    # under the lock): a second driver thread racing first use must
    # never observe a half-initialized pair.
    pair = _wire_children.get(key)
    if pair is None:
        from bytewax_tpu_torch._metrics import (
            wire_bytes_count,
            wire_codec_seconds,
        )

        with _lock:
            pair = _wire_children.setdefault(
                key,
                (
                    wire_codec_seconds.labels(codec, op),
                    wire_bytes_count.labels(
                        codec, "tx" if op == "encode" else "rx"
                    ),
                ),
            )
    secs, bts = pair
    secs.inc(seconds)
    bts.inc(nbytes)
    RECORDER.count(f"wire_{op}_frames_{codec}")
    RECORDER.count(f"wire_{op}_bytes_{codec}", nbytes)
    RECORDER.count(f"wire_{op}_seconds_{codec}", seconds)


def wire_status() -> Dict[str, Any]:
    """The ``/status`` wire section: per-direction frame/byte/time
    totals split by codec (docs/observability.md)."""
    c = RECORDER.counters
    out: Dict[str, Any] = {}
    for op in ("encode", "decode"):
        out[op] = {
            codec: {
                "frames": int(c.get(f"wire_{op}_frames_{codec}", 0)),
                "bytes": int(c.get(f"wire_{op}_bytes_{codec}", 0)),
                "seconds": round(
                    c.get(f"wire_{op}_seconds_{codec}", 0.0), 6
                ),
            }
            for codec in ("columnar", "pickle")
        }
    return out


def note_gsync(tag: Any, seconds: float) -> None:
    """One completed global_sync round (blocked ``seconds``)."""
    from bytewax_tpu_torch._metrics import gsync_round_count

    gsync_round_count.inc()
    RECORDER.count("gsync_round_count")
    RECORDER.count("gsync_wait_seconds", seconds)
    RECORDER.record(
        "gsync", tag=str(tag), seconds=round(seconds, 6)
    )


def note_fault(site: str, kind: str, **ctx: Any) -> None:
    """One injected fault fired at a named site (see
    :mod:`bytewax_tpu_torch.engine.faults`)."""
    from bytewax_tpu_torch._metrics import fault_injected_count

    fault_injected_count.labels(site, kind).inc()
    RECORDER.count("fault_injected_count")
    # ``kind`` is the ring event's own field name; the fault kind
    # rides as ``fault``.
    RECORDER.record("fault_injected", site=site, fault=kind, **ctx)


def note_fenced(peer: int, gen: int) -> None:
    """One dead-generation frame discarded by the comm fence."""
    from bytewax_tpu_torch._metrics import comm_fenced_frames

    comm_fenced_frames.inc()
    RECORDER.count("comm_fenced_frames")
    RECORDER.record("frame_fenced", peer=peer, gen=gen)


def note_restart(attempt: int, cause: str, backoff_s: float) -> None:
    """The supervisor is restarting this worker after a restartable
    fault; also stamps ``restart_at`` so ``bench.py`` can measure
    kill-to-first-epoch-close recovery latency."""
    from bytewax_tpu_torch._metrics import worker_restart_count

    worker_restart_count.inc()
    RECORDER.count("worker_restart_count")
    RECORDER.counters["last_restart_at"] = time.time()
    RECORDER.record(
        "restart", attempt=attempt, cause=cause, backoff_s=backoff_s
    )


def note_stop_requested(source: str) -> None:
    """A cooperative stop was requested on this process (``signal``,
    ``http`` for ``POST /stop``, or ``api`` for a direct
    ``request_stop()`` call); the run loop drains to a stop at the
    next epoch close."""
    RECORDER.count("stop_requested_count")
    RECORDER.counters["stop_requested_at"] = time.time()
    RECORDER.record("stop_requested", source=source)


def note_graceful_stop(epoch: int) -> None:
    """The execution drained to a clean stop: epoch ``epoch`` closed
    (snapshots + DLQ committed), the cluster agreed on the stop vote,
    and the process exits with a :class:`~bytewax_tpu_torch.errors.GracefulStop`
    status — a resume replays zero epochs."""
    RECORDER.count("graceful_stop_count")
    RECORDER.record("graceful_stop", epoch=epoch)


def note_autoscale(
    action: str, from_procs: int, to_procs: int, reason: str = ""
) -> None:
    """The outer cluster supervisor (:mod:`bytewax_tpu_torch.supervise`)
    performed one autoscale action: ``grow``/``shrink`` (a coordinated
    graceful stop + relaunch at a new size) or ``relaunch`` (a
    hard-dead child respawned in place)."""
    from bytewax_tpu_torch._metrics import autoscale_actions_count

    autoscale_actions_count.labels(action).inc()
    RECORDER.count("autoscale_actions_count")
    RECORDER.record(
        "autoscale",
        action=action,
        from_procs=from_procs,
        to_procs=to_procs,
        reason=reason,
    )


def note_reconfigure_requested(
    n_addresses: int, wpp: Any, source: str
) -> None:
    """A live cluster reconfiguration was requested on this process
    (``http`` for ``POST /reconfigure``, ``api`` for a direct
    ``request_reconfigure()`` call); the run loop proposes it on the
    next epoch-close sync round (docs/recovery.md "Live partial
    rescale")."""
    RECORDER.count("reconfigure_requested_count")
    RECORDER.record(
        "reconfigure_requested",
        addresses=n_addresses,
        wpp=wpp,
        source=source,
    )


def note_reconfigure(n_addresses: int, wpp: int, epoch: int) -> None:
    """The cluster agreed a live membership change at an epoch close:
    epoch ``epoch`` committed, and this process unwinds to the
    run-startup re-entry point to rebuild at the new size (or retire)
    without leaving the process."""
    RECORDER.count("reconfigure_count")
    RECORDER.record(
        "reconfigure",
        addresses=n_addresses,
        wpp=wpp,
        epoch=epoch,
    )


def note_rescale(
    from_counts: Any, to_count: int, migrated_keys: int, seconds: float
) -> None:
    """One rescale-on-resume migration completed at run startup: the
    recovery store's keyed snapshot rows were re-routed from the old
    worker count(s) to ``to_count``."""
    from bytewax_tpu_torch._metrics import (
        rescale_duration_seconds,
        rescale_migrated_keys,
    )

    rescale_migrated_keys.inc(migrated_keys)
    rescale_duration_seconds.observe(seconds)
    RECORDER.count("rescale_count")
    RECORDER.count("rescale_migrated_keys", migrated_keys)
    RECORDER.count("rescale_duration_seconds", seconds)
    RECORDER.record(
        "rescale",
        from_counts=str(from_counts),
        to_count=to_count,
        keys=migrated_keys,
        seconds=round(seconds, 6),
    )


def note_resident(step_id: str, n: int) -> None:
    """Sample the device-resident key count of one step (taken at the
    residency manager's drain points).  The peak counter is the
    budget-invariant audit: it only ever ratchets up, so a sample that
    exceeded ``BYTEWAX_TPU_STATE_BUDGET`` stays visible."""
    from bytewax_tpu_torch._metrics import state_resident_keys

    state_resident_keys.labels(step_id).set(n)
    key = f"state_resident_keys[{step_id}]"
    RECORDER.counters[key] = n
    peak = f"state_resident_keys_peak[{step_id}]"
    if n > RECORDER.counters.get(peak, 0):
        RECORDER.counters[peak] = n


def note_eviction(step_id: str, n: int, tier: str) -> None:
    """``n`` keys left the device tier for ``tier`` (``host`` RAM
    snapshots or the ``disk`` spill store)."""
    from bytewax_tpu_torch._metrics import state_evictions_count

    state_evictions_count.labels(step_id, tier).inc(n)
    RECORDER.count("state_evictions_count", n)
    RECORDER.record("eviction", step=step_id, keys=n, tier=tier)


def note_residency_restore(step_id: str, n: int, seconds: float) -> None:
    """One residency-fault restore: ``n`` evicted/spilled keys
    reinstated on device before a delivery dispatched."""
    RECORDER.count("residency_restore_count", n)
    RECORDER.count("residency_restore_seconds", seconds)
    RECORDER.record(
        "restore", step=step_id, keys=n, seconds=round(seconds, 6)
    )
    note_phase(
        "restore", step_id, seconds, t0=time.monotonic() - seconds
    )


def note_spill(step_id: str, nbytes: int) -> None:
    """Serialized bytes written to the disk spill store."""
    from bytewax_tpu_torch._metrics import state_spill_bytes

    state_spill_bytes.labels(step_id).inc(nbytes)
    RECORDER.count("state_spill_bytes", nbytes)


_io_retry_children: Dict[Tuple[str, str], Any] = {}
_quarantine_children: Dict[str, Any] = {}


def note_io_retry(
    step_id: str,
    kind: str,
    attempt: int,
    delay_s: float,
    error: str,
    part: str = "",
) -> None:
    """One transient connector-edge I/O failure retried in place
    (``kind`` ``source`` = next_batch re-poll after backoff, ``sink``
    = write_batch re-invoked before the epoch commit)."""
    key = (step_id, kind)
    child = _io_retry_children.get(key)
    if child is None:
        from bytewax_tpu_torch._metrics import io_retries_count

        with _lock:
            child = _io_retry_children.setdefault(
                key, io_retries_count.labels(step_id, kind)
            )
    child.inc()
    RECORDER.count("io_retries_count")
    RECORDER.record(
        "io_retry",
        step=step_id,
        io=kind,
        part=part,
        attempt=attempt,
        delay_s=round(delay_s, 4),
        error=error,
    )


def _quarantine_gauge(step_id: str) -> Any:
    child = _quarantine_children.get(step_id)
    if child is None:
        from bytewax_tpu_torch._metrics import quarantined_partitions

        with _lock:
            child = _quarantine_children.setdefault(
                step_id, quarantined_partitions.labels(step_id)
            )
    return child


def note_quarantine(
    step_id: str, part: str, n_quarantined: int, fails: int, error: str
) -> None:
    """A source partition entered quarantine: retry budget exhausted,
    parked at its last good offset; ``n_quarantined`` is the step's
    resulting quarantined-partition count."""
    _quarantine_gauge(step_id).set(n_quarantined)
    RECORDER.count("quarantine_count")
    RECORDER.counters[f"quarantined_partitions[{step_id}]"] = (
        n_quarantined
    )
    RECORDER.record(
        "quarantine",
        step=step_id,
        part=part,
        fails=fails,
        error=error,
    )


def note_unquarantine(
    step_id: str, part: str, n_quarantined: int, parked_s: float
) -> None:
    """A quarantined partition's re-probe succeeded: it resumes
    polling from the frozen offset."""
    _quarantine_gauge(step_id).set(n_quarantined)
    RECORDER.count("unquarantine_count")
    RECORDER.counters[f"quarantined_partitions[{step_id}]"] = (
        n_quarantined
    )
    RECORDER.record(
        "unquarantine",
        step=step_id,
        part=part,
        parked_s=round(parked_s, 3),
    )


def note_quarantine_reset(step_id: str) -> None:
    """A source runtime was torn down (EOF close, graceful stop, or a
    live-rescale rebuild): zero the step's quarantined-partition
    gauge so a partition parked on the OLD owner never lingers as a
    phantom after its ownership moved — the new owner resumes it from
    the store's last-good-offset snapshot and re-quarantines it
    itself if it is still sick."""
    _quarantine_gauge(step_id).set(0)
    RECORDER.counters[f"quarantined_partitions[{step_id}]"] = 0


def note_dlq(step_id: str, n: int) -> None:
    """``n`` poison records captured into the dead-letter queue."""
    from bytewax_tpu_torch._metrics import dlq_records_count

    dlq_records_count.labels(step_id).inc(n)
    RECORDER.count("dlq_records_count", n)
    RECORDER.record("dlq_capture", step=step_id, records=n)


def note_demotion(step_id: str, reason: str, keys: int) -> None:
    """A stateful step was demoted from the device tier to the host
    tier (``keys`` states migrated)."""
    from bytewax_tpu_torch._metrics import step_demotion_count

    step_demotion_count.labels(step_id).inc()
    RECORDER.count("demotion_count")
    RECORDER.record(
        "demotion", step=step_id, reason=reason, keys=keys
    )


_infer_children: Dict[str, Any] = {}


def note_infer_rows(step_id: str, rows: int) -> None:
    """``rows`` scored through an ``op.infer`` step (either tier);
    incremented on the main thread when a scoring phase finalizes."""
    child = _infer_children.get(step_id)
    if child is None:
        from bytewax_tpu_torch._metrics import infer_rows_count

        with _lock:
            child = _infer_children.setdefault(
                step_id, infer_rows_count.labels(step_id)
            )
    child.inc(rows)
    RECORDER.count("infer_rows_count", rows)


def note_params_generation(step_id: str, generation: int) -> None:
    """The live broadcast-params generation of an ``op.infer`` step
    (set at build/resume and after each committed hot-swap)."""
    from bytewax_tpu_torch._metrics import infer_params_generation

    infer_params_generation.labels(step_id).set(generation)


def note_params_requested(
    step_id: Optional[str], digest: str, source: str
) -> None:
    """A params hot-swap was requested (pending until a cluster-
    agreed epoch close commits it — docs/inference.md)."""
    RECORDER.record(
        "params_requested",
        step=step_id or "",
        digest=digest,
        source=source,
    )


def note_params_swap(
    step_id: str, epoch: int, digest: str, generation: int
) -> None:
    """A params hot-swap committed at the agreed close of ``epoch``
    (the swap epoch + digest land in the ring for audit)."""
    note_params_generation(step_id, generation)
    RECORDER.count("params_swap_count")
    RECORDER.record(
        "params_swap",
        step=step_id,
        epoch=epoch,
        digest=digest,
        generation=generation,
    )


_pipeline_children: Dict[str, Any] = {}


def note_pipeline_depth(step_id: str, depth: int) -> None:
    """A device-tier step armed its dispatch pipeline at ``depth``
    (see :mod:`bytewax_tpu_torch.engine.pipeline`)."""
    from bytewax_tpu_torch._metrics import pipeline_depth

    pipeline_depth.labels(step_id).set(depth)
    RECORDER.counters["pipeline_depth"] = depth
    RECORDER.record("pipeline_armed", step=step_id, depth=depth)


def note_pipeline_stall(step_id: str, seconds: float) -> None:
    """The main thread blocked ``seconds`` at a pipeline drain point
    waiting for in-flight device work to finalize."""
    child = _pipeline_children.get(step_id)
    if child is None:
        from bytewax_tpu_torch._metrics import pipeline_flush_stall_seconds

        with _lock:
            child = _pipeline_children.setdefault(
                step_id, pipeline_flush_stall_seconds.labels(step_id)
            )
    child.inc(seconds)
    RECORDER.count("pipeline_flush_stall_seconds", seconds)
    RECORDER.count("pipeline_flush_stall_count")
    note_phase(
        "flush", step_id, seconds, t0=time.monotonic() - seconds
    )


def note_snapshot_lag(durable_epoch: int, lag_epochs: int) -> None:
    """The checkpoint durable frontier moved (or a close observed
    it): ``durable_epoch`` is the newest epoch whose snapshot commit
    is on disk, ``lag_epochs`` is how many closed epochs are still
    waiting on the committer lane — the replay window a crash right
    now would incur (0 in the synchronous engine, at most 1 with
    ``BYTEWAX_TPU_CKPT_ASYNC=1``; see docs/recovery.md "Asynchronous
    incremental checkpoints")."""
    from bytewax_tpu_torch._metrics import snapshot_lag_epochs

    snapshot_lag_epochs.set(lag_epochs)
    RECORDER.counters["snapshot_durable_epoch"] = durable_epoch
    RECORDER.counters["snapshot_lag_epochs"] = lag_epochs


def note_barrier(seconds: float) -> None:
    """Epoch barrier resolved: time from entering the hold to the
    close broadcast taking effect."""
    from bytewax_tpu_torch._metrics import barrier_wait_seconds

    barrier_wait_seconds.observe(seconds)
    RECORDER.count("barrier_count")
    RECORDER.count("barrier_wait_seconds", seconds)
    RECORDER.record("barrier_exit", seconds=round(seconds, 6))
    note_phase(
        "barrier", "*", seconds, t0=time.monotonic() - seconds
    )


# -- epoch-ledger writers ------------------------------------------------

_phase_children: Dict[Tuple[str, str], Any] = {}
_lag_children: Dict[Tuple[str, str], Any] = {}


def note_phase(
    phase: str,
    step_id: str,
    seconds: float,
    gross: Optional[float] = None,
    t0: Optional[float] = None,
    lane: int = 0,
) -> None:
    """Attribute ``seconds`` of *exclusive* time to one epoch-ledger
    phase of one step (``step_id`` ``*`` = process-wide).  ``gross``
    is the whole interval including nested phases (charged to the
    enclosing phase frame); ``t0`` (monotonic) keys the Perfetto
    interval; ``lane`` 1 marks off-main-thread time (the pipeline
    worker) that must not charge the enclosing main-thread frame."""
    key = (phase, step_id)
    child = _phase_children.get(key)
    if child is None:
        from bytewax_tpu_torch._metrics import epoch_phase_seconds

        with _lock:
            child = _phase_children.setdefault(
                key, epoch_phase_seconds.labels(phase, step_id)
            )
    child.inc(seconds)
    RECORDER.ledger_add(
        phase, step_id, seconds, gross=gross, t0=t0, lane=lane
    )


def note_source_lag(step_id: str, kind: str, seconds: float) -> None:
    """One source-lag sample: ``kind`` ``event_time`` is wall-clock
    now minus the freshest event timestamp a source batch carried at
    ingest; ``processing`` is a delivery's ingest→emit latency
    through a device-tier step's dispatch pipeline."""
    key = (step_id, kind)
    child = _lag_children.get(key)
    if child is None:
        from bytewax_tpu_torch._metrics import source_lag_seconds

        with _lock:
            child = _lag_children.setdefault(
                key, source_lag_seconds.labels(step_id, kind)
            )
    child.set(seconds)
    RECORDER._lag[key] = seconds


def note_flush_depth(step_id: str, depth: int) -> None:
    """Pending-task queue depth observed at a pipeline drain point
    (per-epoch max, sealed into the ledger record)."""
    cur = RECORDER._flush_depth
    if depth > cur.get(step_id, 0):
        cur[step_id] = depth


# -- ranges, spans and phases on the profiler's clock ---------------------


def open_range(name: str) -> Any:
    """Open the range ``bytewax.<name>`` on this thread while a
    ``torch.profiler`` session records, and return it for
    :func:`close_range`; None (and nothing recorded) otherwise.

    The range is a function-scope record, never a user annotation, so
    the profiler draws no mirror of it on the device's timeline: a
    device trace reads the card's activity alone, and the ranges put
    every thread's host intervals on the same clock beside it.  Torch
    is looked up, never imported: no profiler records in a process
    that has not imported it (the supervisor's, say)."""
    profiler = sys.modules.get("torch.autograd.profiler")
    if profiler is None or not profiler._is_profiler_enabled:
        return None
    fast = getattr(
        sys.modules.get("torch._C._profiler"), "_RecordFunctionFast", None
    )
    if fast is None:  # a torch without the fast record: no range
        return None
    rng = fast("bytewax." + name)
    rng.__enter__()
    return rng


def close_range(rng: Any) -> None:
    """Close a range :func:`open_range` returned (None is a no-op)."""
    if rng is not None:
        rng.__exit__(None, None, None)


class span:
    """A timed part of a phase, on any thread: its seconds add to the
    always-on counter ``<name>_seconds``, and it is the range
    ``bytewax.<name>`` while the profiler records.  A span never
    charges a phase frame and never enters the ledger, its sealed
    records or the fractions."""

    __slots__ = ("_counter", "_name", "_rng", "_t0")

    def __init__(self, name: str):
        self._name = name
        self._counter = name + "_seconds"

    def __enter__(self) -> "span":
        self._rng = open_range(self._name)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc: Any) -> bool:
        dt = time.monotonic() - self._t0
        close_range(self._rng)
        RECORDER.count(self._counter, dt)
        return False


class phase:
    """One main-thread epoch-ledger phase: its *exclusive* seconds go
    to :func:`note_phase` (looked up on this module when it ends),
    the gross interval to the enclosing phase frame, and the interval
    is the range ``bytewax.<name>`` while the profiler records.  With
    ``otlp`` it is also an ``epoch_phase`` tracing span."""

    __slots__ = ("_name", "_otlp", "_rec", "_rng", "_step_id", "_t0", "_trace")

    def __init__(self, name: str, step_id: str = "*", otlp: bool = False):
        self._name = name
        self._step_id = step_id
        self._trace = otlp
        self._otlp: Any = None

    def __enter__(self) -> "phase":
        self._rec = RECORDER
        self._rec.phase_push()
        self._rng = open_range(self._name)
        if self._trace:
            from bytewax_tpu_torch.tracing import span as otlp_span

            self._otlp = otlp_span("epoch_phase", phase=self._name)
            self._otlp.__enter__()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc: Any) -> bool:
        try:
            if self._otlp is not None:
                self._otlp.__exit__(*exc)
        finally:
            gross = time.monotonic() - self._t0
            close_range(self._rng)
            note_phase(
                self._name,
                self._step_id,
                max(gross - self._rec.phase_pop(), 0.0),
                gross=gross,
                t0=self._t0,
            )
        return False


# -- device time of kernel launches ----------------------------------------

#: Pending event pairs past which :meth:`DeviceTimes.note` resolves
#: on its own (a tier without drain points still stays bounded).
_DEVICE_PENDING_CAP = 4096


class DeviceTimes:
    """Device seconds of kernel launches, from CUDA event pairs.

    A launch site takes a pair for its device (:meth:`pair`), records
    one event on each side of the launch on its stream, and hands the
    pair over (:meth:`note`) from whatever thread launched.
    :meth:`resolve` pops the oldest pairs whose end event has
    completed — it asks ``query()`` and never waits — adds their
    elapsed time to the counter ``<name>_device_seconds``, and keeps
    the events for reuse on their device.  The engine resolves at the
    dispatch pipeline's drain points and at the end of a run, after
    the readbacks that end it; nothing here synchronizes the device."""

    def __init__(self) -> None:
        #: (name, device, start, end) in launch order; appended from
        #: any thread, popped under ``_lock``.
        self._pending: deque = deque()
        #: device -> resolved pairs for reuse (events belong to the
        #: device they were made on).
        self._free: Dict[Any, List[Tuple[Any, Any]]] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._pending)

    def pair(self, device: Any, make: Any) -> Tuple[Any, Any]:
        """A resolved pair of ``device`` for reuse, or two new events
        from ``make()``."""
        try:
            return self._free[device].pop()
        except (KeyError, IndexError):
            return make(), make()

    def note(self, name: str, device: Any, start: Any, end: Any) -> None:
        """One launch on ``device`` between the recorded events
        ``start`` and ``end``, to be resolved into
        ``<name>_device_seconds``."""
        self._pending.append((name, device, start, end))
        if len(self._pending) >= _DEVICE_PENDING_CAP:
            self.resolve()

    def resolve(self) -> int:
        """Resolve every completed pair at the head of the queue;
        returns how many.  A resolve already running on another
        thread makes this one a no-op."""
        if not self._lock.acquire(blocking=False):
            return 0
        done = 0
        try:
            pending = self._pending
            while pending:
                name, device, start, end = pending[0]
                if not end.query():
                    break
                pending.popleft()
                RECORDER.count(
                    name + "_device_seconds",
                    start.elapsed_time(end) * 1e-3,
                )
                self._free.setdefault(device, []).append((start, end))
                done += 1
        finally:
            self._lock.release()
        return done


DEVICE_TIMES = DeviceTimes()


#: Ledger phases folded into each reported fraction bucket.
_FRACTION_BUCKETS = {
    "host": ("ingest", "host", "readback"),
    "device": ("device",),
    "flush": ("flush", "close_flush"),
    "barrier": ("barrier",),
    "gsync": ("gsync", "collective", "collective_lane"),
    "snapshot": ("snapshot", "commit", "snapshot_lane"),
    "residency": ("restore", "evict"),
}


def ledger_fractions(
    totals: Optional[Dict[str, float]] = None,
) -> Optional[Dict[str, float]]:
    """Fold the lifetime per-phase totals into the coarse
    host/device/flush/barrier/gsync/snapshot/residency buckets and
    normalize to fractions of the attributed time; None before any
    phase was recorded.  Feeds ``bench.py``'s
    ``epoch_phase_fractions`` and the attribution-backed rescale
    hint."""
    if totals is None:
        totals = RECORDER.phase_totals
    buckets = {
        name: sum(totals.get(p, 0.0) for p in phases)
        for name, phases in _FRACTION_BUCKETS.items()
    }
    denom = sum(buckets.values())
    if denom <= 0:
        return None
    return {k: round(v / denom, 4) for k, v in buckets.items()}


def write_postmortem(
    proc_id: int, generation: int, cause: str, detail: str = ""
) -> Optional[str]:
    """Crash post-mortem: dump the flight ring tail, counters, and
    the in-flight epoch's ledger to
    ``BYTEWAX_TPU_POSTMORTEM_DIR/postmortem-<proc>-<gen>.json``
    (best-effort; returns the path, or None when the dir is unset or
    the write failed).  Called by the restart supervisor on a
    restartable fault, before the backoff sleep."""
    pm_dir = os.environ.get(
        "BYTEWAX_TPU_POSTMORTEM_DIR", ""
    ).strip()
    if not pm_dir:
        return None
    rec = RECORDER
    doc = {
        "proc_id": proc_id,
        "generation": generation,
        "cause": cause,
        "detail": detail[:2000],
        "written_at": time.time(),
        "counters": rec._copied(lambda: dict(rec.counters), {}),
        "tail": rec.tail(),
        "ledger": {
            "in_flight": rec._nested(dict(rec._ledger)),
            "last_sealed": rec.last_ledger,
        },
        "lag": rec.ledger_lag(),
        "queue_depth_at_drain": dict(rec._flush_depth),
    }
    try:
        os.makedirs(pm_dir, exist_ok=True)
        path = os.path.join(
            pm_dir, f"postmortem-{proc_id}-{generation}.json"
        )
        with open(path, "w") as f:
            # default=str stays as the backstop for exotic leaf types
            # _json_safe has no rule for.
            json.dump(_json_safe(doc), f, default=str)
    except OSError as ex:
        import logging

        logging.getLogger(__name__).warning(
            "could not write postmortem to %s: %s", pm_dir, ex
        )
        return None
    return path
