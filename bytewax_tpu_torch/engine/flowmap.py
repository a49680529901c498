"""Live flow map: per-step / per-edge telemetry over the lowered plan.

The epoch ledger (``engine/flight.py``) attributes every epoch's wall
time to *phases*; this module attributes every epoch's *flow* to steps
and edges — rows/s in and out, batch sizes, dispatch-pipeline queue
depth at drain, per-step watermark / event-time lag, device-resident
key/byte footprint, and per-peer wire traffic per stream — so the
operator's first question ("which step is the bottleneck?") has a
direct answer (``GET /graph``, docs/observability.md "Flow map").

Discipline mirrors the ledger exactly:

- **Accumulation is ledger-style dict adds** at points the driver
  already touches per batch (``_count_inp`` / ``_count_out`` /
  ``emit``) or per drain (``ship_flush``, epoch close) — no new
  hot-path work, no locks.  Every writer runs on the main thread
  (BTX-THREAD: worker-lane tasks never reach this module), and the
  API-server thread only ever reads the sealed ``last`` record, which
  is swapped in atomically.
- **Counters seal per epoch**: :meth:`FlowMap.seal` runs at every
  epoch close next to the ledger seal, converting the adds into a
  rate-bearing record, mirroring them into the Prometheus step
  families, and resetting for the next epoch.
- **Cluster-wide by piggyback**: the sealed record rides the existing
  epoch-close gsync telemetry summary (``FlightRecorder.summary``) —
  zero new control-frame kinds, zero new send surface.

:func:`derive_bottleneck` is the pure attribution: name the slowest
sustained consumer upstream of the largest queue/lag growth (or, with
no pressure signal, the step dominating attributed busy time).  It
feeds ``derive_rescale_hint`` as a step-scoped reason.
"""

import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "FLOWMAP",
    "FlowMap",
    "derive_bottleneck",
    "device_footprint",
    "payload_size",
    "topology",
    "watermark_lag_s",
]

#: Sealed records kept for trend readers (bounded like the ledger's).
_SEALED_BUF = 32

# Cached Prometheus label children (one labels() resolution per
# distinct label set; seal runs on the main thread only).
_rows_children: Dict[Tuple[str, str], Any] = {}
_lag_children: Dict[str, Any] = {}
_bytes_children: Dict[str, Any] = {}


class FlowMap:
    """Per-epoch flow accumulator + the sealed per-epoch records.

    All mutators run on the driver main thread (batch delivery, drain
    points, epoch close); readers off-thread consume only the sealed
    ``last`` record.
    """

    def __init__(self) -> None:
        #: (step_id, "in"|"out") -> rows accumulated this epoch
        self._rows: Dict[Tuple[str, str], int] = {}
        #: (step_id, "in"|"out") -> batches accumulated this epoch
        self._batches: Dict[Tuple[str, str], int] = {}
        #: stream_id -> rows routed over the edge this epoch
        self._edges: Dict[str, int] = {}
        #: (peer, stream) -> [frames, rows, bytes] shipped this epoch
        self._wire: Dict[Tuple[int, str], List[int]] = {}
        #: step_id -> (resident keys, device bytes), sampled at close
        self._device: Dict[str, Tuple[int, int]] = {}
        #: step_id -> watermark lag seconds, sampled at close
        self._lag: Dict[str, float] = {}
        self._epoch_t0 = time.monotonic()
        #: the latest sealed record (atomically swapped; read racily
        #: by the API-server thread like every observability surface)
        self.last: Optional[Dict[str, Any]] = None
        self._sealed: deque = deque(maxlen=_SEALED_BUF)

    # -- main-thread accumulators (ledger-style dict adds) ---------------

    def add_rows(self, step_id: str, direction: str, n: int) -> None:
        key = (step_id, direction)
        self._rows[key] = self._rows.get(key, 0) + n
        self._batches[key] = self._batches.get(key, 0) + 1

    def add_edge(self, stream_id: str, n: int) -> None:
        self._edges[stream_id] = self._edges.get(stream_id, 0) + n

    def add_wire(
        self, peer: int, stream: str, rows: int, nbytes: int
    ) -> None:
        cell = self._wire.get((peer, stream))
        if cell is None:
            cell = self._wire[(peer, stream)] = [0, 0, 0]
        cell[0] += 1
        cell[1] += rows
        cell[2] += nbytes

    # -- close-time samples (drain points only) --------------------------

    def set_device(self, step_id: str, keys: int, nbytes: int) -> None:
        self._device[step_id] = (int(keys), int(nbytes))

    def set_lag(self, step_id: str, seconds: float) -> None:
        self._lag[step_id] = float(seconds)

    # -- sealing ---------------------------------------------------------

    def seal(
        self,
        epoch: int,
        queue_depth: Optional[Dict[str, int]] = None,
    ) -> Dict[str, Any]:
        """Seal this epoch's adds into a rate-bearing record (called
        at every epoch close, next to the ledger seal), mirror them
        into the Prometheus step families, and reset."""
        now = time.monotonic()
        wall = max(now - self._epoch_t0, 1e-9)
        steps: Dict[str, Dict[str, Any]] = {}
        for (step, direction), rows in self._rows.items():
            ent = steps.setdefault(step, {})
            batches = self._batches.get((step, direction), 0)
            ent[f"rows_{direction}"] = rows
            ent[f"rate_{direction}_per_s"] = round(rows / wall, 3)
            ent[f"batches_{direction}"] = batches
            if batches:
                ent[f"batch_rows_{direction}"] = round(
                    rows / batches, 2
                )
        for step, (keys, nbytes) in self._device.items():
            ent = steps.setdefault(step, {})
            ent["device_keys"] = keys
            ent["device_bytes"] = nbytes
        for step, lag in self._lag.items():
            steps.setdefault(step, {})["watermark_lag_s"] = round(
                lag, 6
            )
        for step, depth in (queue_depth or {}).items():
            steps.setdefault(step, {})["queue_depth_at_drain"] = depth
        record: Dict[str, Any] = {
            "epoch": epoch,
            "wall_s": round(wall, 6),
            "steps": steps,
            "edges": {
                sid: {
                    "rows": rows,
                    "rate_per_s": round(rows / wall, 3),
                }
                for sid, rows in self._edges.items()
            },
            "wire": {
                str(peer): {
                    stream: {
                        "frames": frames,
                        "rows": rows,
                        "bytes": nbytes,
                    }
                    for (p, stream), (
                        frames,
                        rows,
                        nbytes,
                    ) in self._wire.items()
                    if p == peer
                }
                for peer in sorted({p for p, _s in self._wire})
            },
        }
        self._to_prometheus()
        self.last = record
        self._sealed.append(record)
        self._rows = {}
        self._batches = {}
        self._edges = {}
        self._wire = {}
        self._device = {}
        self._lag = {}
        self._epoch_t0 = now
        return record

    def _to_prometheus(self) -> None:
        """Mirror the epoch's adds into the step metric families
        (sealed-per-epoch like the ledger's phase counter: one
        labeled inc/set per step per close, never per batch)."""
        from bytewax_tpu_torch._metrics import (
            step_device_bytes,
            step_rows_count,
            step_watermark_lag_seconds,
        )

        for (step, direction), rows in self._rows.items():
            child = _rows_children.get((step, direction))
            if child is None:
                child = _rows_children[
                    (step, direction)
                ] = step_rows_count.labels(step, direction)
            child.inc(rows)
        for step, lag in self._lag.items():
            child = _lag_children.get(step)
            if child is None:
                child = _lag_children[
                    step
                ] = step_watermark_lag_seconds.labels(step)
            child.set(lag)
        for step, (_keys, nbytes) in self._device.items():
            child = _bytes_children.get(step)
            if child is None:
                child = _bytes_children[
                    step
                ] = step_device_bytes.labels(step)
            child.set(nbytes)

    # -- readers ---------------------------------------------------------

    def summary(self) -> Optional[Dict[str, Any]]:
        """The latest sealed record, for the epoch-close gsync
        telemetry piggyback (control-plane sized: a bounded handful
        of per-step scalars, like the ledger)."""
        return self.last

    def recent(self, n: int = 8) -> List[Dict[str, Any]]:
        return list(self._sealed)[-n:]


FLOWMAP = FlowMap()


def topology(plan: Any) -> Dict[str, Any]:
    """The lowered dataflow topology: one node per core op (with its
    static tier — ``device`` when lowering annotated a device spec,
    else ``host``; the driver overlays the live tier, which also
    knows about the collective global-exchange state and demotions)
    and one edge per (stream, consumer port)."""
    steps = [
        {
            "step_id": op.step_id,
            "op": op.name,
            "tier": (
                "device"
                if op.conf.get("_accel") is not None
                else "host"
            ),
        }
        for op in plan.ops
    ]
    edges = []
    for sid, consumers in plan.consumers.items():
        pi = plan.producer.get(sid)
        src = plan.ops[pi].step_id if pi is not None else None
        for ci, port in consumers:
            edges.append(
                {
                    "stream_id": sid,
                    "src": src,
                    "dst": plan.ops[ci].step_id,
                    "port": port,
                }
            )
    return {"steps": steps, "edges": edges}


def derive_bottleneck(
    steps: Dict[str, Dict[str, Any]],
    edges: Iterable[Tuple[str, str]] = (),
    *,
    min_share: float = 0.5,
    queue_min: int = 2,
    lag_min_s: float = 1.0,
) -> Optional[Tuple[str, str]]:
    """Name the bottleneck step, purely from per-step signals.

    ``steps`` maps step_id to a dict with any of ``busy_s`` (seconds
    of attributed main-thread/device work, from the epoch ledger),
    ``queue_depth`` (dispatch-pipeline depth observed at drain), and
    ``lag_s`` (watermark / event-time lag seconds).  ``edges`` are
    ``(src_step, dst_step)`` pairs of the lowered topology.

    Attribution: find the largest pressure signal — a queue depth of
    at least ``queue_min`` or a lag of at least ``lag_min_s`` — then
    name the slowest sustained consumer at-or-upstream of it (the
    step with the most attributed busy time among the pressured step
    and its transitive upstreams).  With no pressure signal anywhere,
    a step only qualifies by *dominating* the attributed time: its
    busy share must strictly exceed ``min_share``.  Returns ``(step_id,
    reason)`` or ``None``.  Deterministic: ties break on step id.
    """
    pressured: Optional[Tuple[float, str, str]] = None
    for step in sorted(steps):
        sig = steps[step]
        depth = float(sig.get("queue_depth") or 0)
        lag = float(sig.get("lag_s") or 0.0)
        if depth >= queue_min and (
            pressured is None or depth > pressured[0]
        ):
            pressured = (depth, step, f"queue depth {int(depth)}")
        if lag >= lag_min_s and (
            pressured is None or lag > pressured[0]
        ):
            pressured = (lag, step, f"lag {lag:.1f}s")

    def busy(step: str) -> float:
        return float(steps.get(step, {}).get("busy_s") or 0.0)

    if pressured is not None:
        _val, at, what = pressured
        ups = {at}
        grew = True
        while grew:
            grew = False
            for src, dst in edges:
                if dst in ups and src not in ups and src in steps:
                    ups.add(src)
                    grew = True
        best = max(sorted(ups), key=busy)
        if busy(best) <= 0.0:
            best = at
        reason = f"{what} at {at}"
        if best != at:
            reason += f" fed by slowest upstream {best}"
        return best, reason

    total = sum(busy(s) for s in steps)
    if total <= 0.0:
        return None
    best = max(sorted(steps), key=busy)
    share = busy(best) / total
    # Strictly-exceed: an even split (two steps at exactly 50%) is
    # balanced load, not a dominant step — naming one would flap on
    # the tie-break.
    if share <= min_share:
        return None
    return best, (
        f"step holds {share:.0%} of attributed busy time "
        f"({busy(best):.3f}s of {total:.3f}s)"
    )


def device_footprint(state: Any) -> Tuple[int, int]:
    """Best-effort ``(resident_keys, device_bytes)`` over the device
    tier's state shapes (slot tables, sharded slots, window/scan
    wrappers, the residency manager) — duck-typed so every tier
    answers without new per-shape protocol surface."""
    seen: set = set()
    field_ids: set = set()
    keys = 0
    nbytes = 0

    def walk(obj: Any, depth: int = 0) -> None:
        nonlocal keys, nbytes
        if obj is None or depth > 4 or id(obj) in seen:
            return
        seen.add(id(obj))
        for attr in ("key_to_slot", "key_to_kid"):
            m = getattr(obj, attr, None)
            if isinstance(m, dict):
                keys = max(keys, len(m))
        fields = getattr(obj, "_fields", None)
        if isinstance(fields, dict) and id(fields) not in field_ids:
            field_ids.add(id(fields))
            for arr in fields.values():
                nbytes += int(getattr(arr, "nbytes", 0) or 0)
        for attr in ("agg", "_inner"):
            walk(getattr(obj, attr, None), depth + 1)

    walk(state)
    return keys, nbytes


def watermark_lag_s(wagg: Any) -> Optional[float]:
    """Max per-key watermark lag (seconds) of a device window state:
    the per-key watermark is ``base_us + (now_us - sys_at_base)``, so
    its lag behind wall-clock is the constant ``sys_at_base -
    base_us`` until the key's next event.  Sampled at drain points
    only (the arrays are mutated by the dispatch path)."""
    import numpy as np

    base = getattr(wagg, "base_us", None)
    sys_at = getattr(wagg, "sys_at_base", None)
    if base is None or sys_at is None:
        return None
    b = np.asarray(base, dtype=np.float64)
    s = np.asarray(sys_at, dtype=np.float64)
    if b.shape != s.shape or b.size == 0:
        return None
    mask = np.isfinite(b) & np.isfinite(s)
    if not mask.any():
        return None
    return float(np.max((s[mask] - b[mask]) / 1e6))


def payload_size(items: Any) -> Tuple[int, int]:
    """Best-effort ``(rows, bytes)`` of one wire payload: columnar
    batches report their column buffer bytes; itemized lists report
    rows only (their wire size is codec-dependent and already
    attributed by ``note_wire``)."""
    try:
        rows = len(items)
    except TypeError:
        rows = 0
    nbytes = 0
    cols = getattr(items, "cols", None)
    if isinstance(cols, dict):
        for arr in cols.values():
            nbytes += int(getattr(arr, "nbytes", 0) or 0)
    return rows, nbytes
