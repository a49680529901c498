"""Device-accelerated windowed aggregation.

Lowers numeric ``fold_window``/``reduce_window``/``count_window`` over
``EventClock`` + tumbling/sliding windows to the device tier: window-id
assignment, per-key watermarks, and lateness are vectorized numpy on
the host (float64 time math keeps full precision); the per-(key,
window) fold is one scatter-combine into a device slot table (see
``bytewax_tpu_torch/ops/segment.py``).  The host tier's `_WindowLogic`
(``bytewax_tpu_torch/operators/windowing.py``) remains the oracle and
handles everything else (sessions, non-numeric folds, SystemClock).

Snapshots are emitted in the host tier's ``_WindowSnapshot`` format,
so recovery is interchangeable between tiers.

Semantics note: lateness matches the host tier exactly — each row is
judged post-item against its key's running watermark (a per-key
prefix max over the delivered batch, floored by the carried base), so
an in-batch timestamp jump marks subsequent borderline rows late on
both tiers identically, and the comparison is strict (``ts <
watermark``; a row exactly at the watermark is on time).
``tests/test_window_accel.py::test_window_accel_lateness_boundary``
pins this.

Pipeline note (docs/performance.md): each ``on_batch*`` call returns
``(late_events, device_phase)`` — the host phase (vocab sync,
watermark math, late classification) runs on the caller's thread and
mutates only host clock state; ``device_phase()`` (the fold
scatter-combine, the due-window scan against a clock snapshot taken
at ingest, the close snapshot fetch, and window-event construction)
is safe to defer onto the engine's dispatch-pipeline worker.  The
driver runs it inline at pipeline depth 1 — byte-identical to the
pre-pipeline engine.  ``on_notify``/``on_eof``/``snapshots_for``
remain synchronous and may only run with the pipeline drained.
"""

from datetime import datetime, timedelta, timezone
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from bytewax_tpu_torch.engine import flight as _flight
from bytewax_tpu_torch.engine.arrays import KeyEncoder, VocabMaps

__all__ = ["DeviceWindowAggState", "WindowAccelSpec"]

_US = 1_000_000.0


def _to_us(dt: datetime) -> float:
    return dt.timestamp() * _US


class _LateTs:
    """Late-value view for columnar batches: row index → timestamp."""

    def __init__(self, ts_us: np.ndarray):
        self._ts_us = ts_us

    def __getitem__(self, row: int) -> datetime:
        return datetime.fromtimestamp(
            self._ts_us[row] / _US, tz=timezone.utc
        )


class _ItemVals:
    """Late-value view for promoted itemized batches: row index →
    the row's original value object (so late events carry the same
    object the host tier would emit — a TsValue keeps its ``.ts``)."""

    __slots__ = ("_items",)

    def __init__(self, items):
        self._items = items

    def __getitem__(self, row: int):
        return self._items[row][1]


class WindowAccelSpec:
    """Flatten-time annotation: lower this windowed fold to device."""

    def __init__(
        self,
        kind: str,
        ts_getter: Callable[[Any], datetime],
        align_to: datetime,
        length: timedelta,
        offset: timedelta,
        wait: timedelta,
    ):
        self.kind = kind
        self.ts_getter = ts_getter
        self.align_us = _to_us(align_to)
        self.length_us = length.total_seconds() * _US
        self.offset_us = offset.total_seconds() * _US
        self.wait_us = wait.total_seconds() * _US

    def make_state(self) -> "DeviceWindowAggState":
        return DeviceWindowAggState(self)

    def __repr__(self) -> str:
        return f"WindowAccelSpec({self.kind!r})"


class SessionAccelSpec(WindowAccelSpec):
    """Flatten-time annotation: lower this session-windowed fold to
    device (gap-merged sessions, reference semantics:
    upstream bytewax ``pysrc/bytewax/operators/windowing.py:688-806``)."""

    def __init__(
        self,
        kind: str,
        ts_getter: Callable[[Any], datetime],
        gap: timedelta,
        wait: timedelta,
    ):
        self.kind = kind
        self.ts_getter = ts_getter
        self.gap_us = gap.total_seconds() * _US
        self.wait_us = wait.total_seconds() * _US
        # Unused sliding fields (the base __init__ computes its
        # static expansion factor from them).
        self.align_us = 0.0
        self.length_us = 1.0
        self.offset_us = 1.0

    def make_state(self) -> "DeviceSessionAggState":
        return DeviceSessionAggState(self)

    def __repr__(self) -> str:
        return f"SessionAccelSpec({self.kind!r})"


class DeviceWindowAggState:
    """All keys' open windows for one windowed-fold step.

    Host numpy state: per-key watermark bases (EventClock semantics:
    watermark = max event ts − wait + system time since that event,
    ``windowing.py:_EventClockLogic``) and the open-window table
    mapping ``(key, window_id)`` to a device slot.
    """

    def __init__(self, spec: WindowAccelSpec):
        from bytewax_tpu_torch.engine.sharded_state import make_agg_state

        self.spec = spec
        # The single-device slot table (the port's one tier): the
        # window bookkeeping (watermarks, open/close) stays host-side;
        # the per-(key, window) fold is the segment-fold kernel's
        # (slot, value) row source, through ``update_ids``.
        self.agg = make_agg_state(spec.kind)
        # windows_per_ts is static for a sliding windower.
        self.expand = max(1, int(np.ceil(spec.length_us / spec.offset_us)))
        # Per-key clock state, indexed by key id.
        self.keys: List[str] = []
        self.key_ids: Dict[str, int] = {}
        self.base_us = np.empty(0, dtype=np.float64)  # watermark base
        self.sys_at_base = np.empty(0, dtype=np.float64)
        # Open windows: composite "k\x00wid" -> True (slot table lives
        # in self.agg keyed by the same composite).
        self.open_close_us: Dict[Tuple[int, int], float] = {}
        #: Keys touched since the last epoch snapshot.
        self.touched: set = set()
        # Cached (kids, wids, closes) arrays over open_close_us;
        # invalidated whenever the open-window set changes.
        self._open_cache = None
        # Dictionary-encoded fast path: external id -> internal kid,
        # one map per vocabulary lineage (engine/arrays.py PeerVocab).
        self._vocab = VocabMaps(dtype=np.int64)
        # Automatic encoder for plain string key columns.
        self._enc = KeyEncoder()
        # Sticky marker: itemized promotion failed a deterministic
        # check; stop re-trying it every batch.
        self._promote_failed = False
        # Deferred device phases read the per-key clock as of their
        # own ingest, so the ingest snapshots it; at pipeline depth 1
        # the phase runs inline before the clock can move again and
        # the copy is skipped.
        from bytewax_tpu_torch.engine.pipeline import pipeline_depth

        self._clock_copies = pipeline_depth() > 1

    # -- clock -------------------------------------------------------------

    def _key_ids_for(self, keys: List[str]) -> np.ndarray:
        out = np.empty(len(keys), dtype=np.int64)
        for i, k in enumerate(keys):
            kid = self.key_ids.get(k)
            if kid is None:
                kid = len(self.keys)
                self.key_ids[k] = kid
                self.keys.append(k)
            out[i] = kid
        if len(self.keys) > len(self.base_us):
            grow = len(self.keys) - len(self.base_us)
            now_us = datetime.now(timezone.utc).timestamp() * _US
            self.base_us = np.concatenate(
                [self.base_us, np.full(grow, -np.inf)]
            )
            self.sys_at_base = np.concatenate(
                [self.sys_at_base, np.full(grow, now_us)]
            )
        return out

    def _watermarks(self, kids: np.ndarray, now_us: float) -> np.ndarray:
        return self.base_us[kids] + (now_us - self.sys_at_base[kids])

    # -- processing --------------------------------------------------------

    def _sync_vocab(self, ids: np.ndarray, vocab) -> np.ndarray:
        """Map dictionary-encoded external ids to internal key ids
        with one table lookup; vocabularies must be append-only
        extensions between batches (see :class:`VocabMap`)."""
        _origin, vmap, _fresh = self._vocab.of(vocab)
        vmap.sync(ids, vocab, self._key_ids_for)
        return vmap.table[ids]

    def on_batch_columnar(self, batch):
        """Columnar fast path: a batch with ``"key"`` (strings) or
        dictionary-encoded ``"key_id"`` + ``key_vocab`` and ``"ts"``
        columns (``np.datetime64`` or int64 microseconds since the
        epoch), plus a ``"value"`` column for numeric folds, runs with
        no per-row Python.  Late rows are reported with their value
        (counting: their timestamp).  Returns ``(late_events,
        device_phase)`` — see :meth:`_ingest`."""
        if "key_id" in batch.cols and batch.key_vocab is not None:
            kids = self._sync_vocab(
                batch.numpy("key_id").astype(np.int64), batch.key_vocab
            )
        else:
            kids = self._enc.encode(
                batch.numpy("key"), self._key_ids_for
            )
        ts_col = batch.numpy("ts")
        if np.issubdtype(ts_col.dtype, np.datetime64):
            ts_us = ts_col.astype("datetime64[us]").astype(np.int64).astype(
                np.float64
            )
        else:
            ts_us = ts_col.astype(np.float64)
        if self.spec.kind == "count":
            return self._ingest(kids, ts_us, _LateTs(ts_us))
        # Keep the column's dtype: integer folds stay exact (the slot
        # table's _pick_dtype handles int32 and rejects wider ints).
        vals = batch.numpy("value")
        if batch.value_scale is not None:
            vals = (vals * batch.value_scale).astype(np.float32)
        return self._ingest(kids, ts_us, vals)

    def is_empty(self) -> bool:
        return not self.open_close_us and not self.keys and not self.touched

    def on_batch_items(self, items: List[Any]):
        """Itemized promotion: one native pass dictionary-encodes the
        keys of timestamped ``(key, value)`` tuples and extracts
        epoch-us timestamps — ``(key, datetime)`` rows (counts) or
        ``(key, TsValue)`` rows (numeric folds) — then ingests the
        columns exactly like ``on_batch_columnar``.  Returns None when
        the native module is unavailable (caller runs the per-item
        path); raises :class:`NonNumericValues` when the rows can't
        promote (malformed/mixed shapes, non-UTC timestamps, a
        ts_getter that disagrees with the row's own timestamp) so the
        caller can fall back, matching ``_process_scan_accel``.
        """
        from bytewax_tpu_torch.engine.xla import NonNumericValues
        from bytewax_tpu_torch.native import wa_encode

        if getattr(self, "_promote_failed", False):
            # A previous batch failed a deterministic promotion check
            # (getter disagreement, shape/kind mismatch): don't pay
            # the full encode + rejection on every batch.
            return None
        n = len(items)
        ids = np.empty(n, dtype=np.int32)
        ts_us = np.empty(n, dtype=np.float64)
        vals = np.empty(n, dtype=np.float64)
        # The native id dict shares the engine's key-id space; resync
        # when other ingest paths (columnar, per-item) allocated ids
        # this dict hasn't seen.
        iddict = getattr(self, "_item_iddict", None)
        if iddict is None or len(iddict) != len(self.key_ids):
            iddict = dict(self.key_ids)
            self._item_iddict = iddict
        try:
            res = wa_encode(items, iddict, ids, ts_us, vals)
        except (TypeError, AttributeError) as ex:
            # AttributeError: a float-coercible value without the
            # TsValue `.ts` attribute.
            raise NonNumericValues(str(ex)) from ex
        if res is None:
            return None
        new_keys, mode = res
        if mode == 1 and self.spec.kind != "count":
            # Bare datetimes carry no foldable value; the numeric
            # fold must see the rows itemized (and will raise the
            # host tier's own error).
            self._promote_failed = True
            msg = "datetime-only rows can't feed a numeric windowed fold"
            raise NonNumericValues(msg)
        # The promotion bypasses spec.ts_getter; verify on a spread
        # sample of rows that the getter agrees with the row's own
        # timestamp.  This is the promotion contract (documented on
        # EventClock): the getter must read the row's datetime /
        # TsValue ``.ts`` — a getter transforming timestamps
        # nonuniformly within one batch can evade a finite sample and
        # must not be combined with promotable row shapes.  Sub-us
        # slack: .timestamp() arithmetic is float, the native path is
        # exact integer microseconds.
        probes = sorted(
            {int(p) for p in np.linspace(0, n - 1, min(n, 8))}
        ) if n else ()
        for probe in probes:
            try:
                got = _to_us(self.spec.ts_getter(items[probe][1]))
            except Exception as ex:  # noqa: BLE001 — getter rejects row
                raise NonNumericValues(str(ex)) from ex
            if abs(got - ts_us[probe]) > 1.0:
                self._promote_failed = True
                msg = (
                    "ts_getter disagrees with the row timestamp; "
                    "itemized windowing promotion needs a getter "
                    "reading the row's own datetime/TsValue.ts"
                )
                raise NonNumericValues(msg)
        if new_keys:
            kids_new = self._key_ids_for(new_keys)
            # wa_encode assigned len(iddict)-ordered ids; they must
            # line up with the engine's first-seen allocation.  Not an
            # assert: under ``python -O`` a desync would silently
            # misattribute every subsequent window fold to the wrong
            # keys instead of failing the step.
            if int(kids_new[-1]) != len(self.keys) - 1:
                self._promote_failed = True
                msg = (
                    "itemized windowing promotion desynchronized from "
                    "the engine key-id space (native id "
                    f"{int(kids_new[-1])} vs engine id "
                    f"{len(self.keys) - 1}); this is an engine "
                    "invariant violation — please report it"
                )
                raise RuntimeError(msg)
        kids = ids.astype(np.int64)
        if self.spec.kind == "count":
            return self._ingest(kids, ts_us, _LateTs(ts_us))
        # Late events carry the original value objects (a TsValue
        # keeps its .ts); the fold consumes the encoded column.
        return self._ingest(kids, ts_us, _ItemVals(items), fold_vals=vals)

    def on_batch(self, keys: List[str], values: List[Any]):
        """Fold a batch; window events are tagged like the host tier's
        ``_WindowLogic`` ("E" emit / "L" late / "M" meta).  Returns
        ``(late_events, device_phase)`` — see :meth:`_ingest`."""
        spec = self.spec
        kids = self._key_ids_for(keys)
        ts_us = np.fromiter(
            (_to_us(spec.ts_getter(v)) for v in values),
            dtype=np.float64,
            count=len(values),
        )
        return self._ingest(kids, ts_us, values)

    def _ingest(
        self, kids: np.ndarray, ts_us: np.ndarray, values, fold_vals=None
    ):
        """Host phase of one delivery; returns ``(late_events,
        device_phase)``.

        ``values`` is indexed per late row (original objects where
        available); ``fold_vals`` optionally supplies the numeric fold
        column when ``values`` is a lazy view rather than an array.
        ``device_phase()`` — the fold, the due-window scan (against
        the clock as of THIS ingest), and window-event construction —
        returns ``(close_events, notify_hint)`` and may run deferred
        on the dispatch pipeline's worker; it touches only the
        fold/open-window state the pipeline owns between submit and
        finalize."""
        spec = self.spec
        now_us = datetime.now(timezone.utc).timestamp() * _US
        self.touched.update(
            self.keys[int(k)] for k in np.unique(kids)
        )

        # Per-row watermark exactly as the host tier computes it per
        # item (post-item): the running per-key prefix max of
        # (ts - wait), floored by the carried base advanced with
        # system time.  Group rows by key with one stable sort, then
        # run one accumulate per contiguous segment — O(n log n), not
        # O(keys × rows).
        eff = ts_us - spec.wait_us
        n = len(ts_us)
        order = np.argsort(kids, kind="stable")
        kids_sorted = kids[order]
        eff_sorted = eff[order]
        seg_kids, seg_starts = np.unique(kids_sorted, return_index=True)
        seg_counts = np.diff(np.append(seg_starts, n))
        n_seg = len(seg_kids)
        carry = self.base_us[seg_kids] + (now_us - self.sys_at_base[seg_kids])

        # Segmented prefix max with no per-key Python: shift each
        # key's rows into its own disjoint value band (band width >
        # the value span), run ONE global cummax — later bands
        # dominate earlier ones, so the running max never leaks
        # across segments — and shift back.  Exact only in integer
        # arithmetic below 2^53, which the hot columnar path
        # (datetime64[us] timestamps) always is; fractional
        # microseconds or astronomically-spread batches take the
        # per-segment loop so watermark equality stays bit-exact.
        lo_val = float(eff_sorted.min()) if n else 0.0
        band = float(eff_sorted.max()) - lo_val + 1.0 if n else 1.0
        integral = n == 0 or (
            band == np.floor(band)
            and not np.any(eff_sorted % 1.0)
        )
        if integral and n_seg * band < float(1 << 53):
            seg_of_row = np.repeat(
                np.arange(n_seg, dtype=np.int64), seg_counts
            )
            off = seg_of_row * band
            prefix = (
                np.maximum.accumulate((eff_sorted - lo_val) + off) - off
            ) + lo_val
            wm_sorted = np.maximum(prefix, carry[seg_of_row])
            seg_max = np.maximum.reduceat(eff_sorted, seg_starts)
        else:
            seg_ends = np.append(seg_starts[1:], n)
            wm_sorted = np.empty(n, dtype=np.float64)
            seg_max = np.empty(n_seg, dtype=np.float64)
            for j, (lo, hi) in enumerate(
                zip(seg_starts.tolist(), seg_ends.tolist())
            ):
                prefix = np.maximum.accumulate(eff_sorted[lo:hi])
                np.maximum(prefix, carry[j], out=wm_sorted[lo:hi])
                seg_max[j] = prefix[-1]
        advanced = seg_max > self.base_us[seg_kids]
        if advanced.any():
            moved = seg_kids[advanced]
            self.base_us[moved] = seg_max[advanced]
            self.sys_at_base[moved] = now_us
        wm_rows = np.empty(n, dtype=np.float64)
        wm_rows[order] = wm_sorted
        late_mask = ts_us < wm_rows

        events: List[Tuple[str, Tuple[int, str, Any]]] = []
        if late_mask.any():
            events.extend(
                self._late_events(
                    np.nonzero(late_mask)[0], kids, ts_us, values
                )
            )

        ok = ~late_mask
        kids_ok = ts_ok = vals_ok = None
        if ok.any():
            kids_ok = kids[ok]
            ts_ok = ts_us[ok]
            if spec.kind == "count":
                vals_ok = np.ones(int(ok.sum()), dtype=np.float64)
            elif fold_vals is not None:
                vals_ok = fold_vals[ok]
            else:
                vals_ok = np.asarray(values)[ok]  # keep dtype for exact ints

        # The deferred phase judges window dues by the watermark as of
        # THIS ingest: snapshot the clock (the next ingest mutates it
        # in place on the host thread while the phase may still be in
        # flight on the pipeline worker).
        clock = (
            (self.base_us.copy(), self.sys_at_base.copy())
            if self._clock_copies
            else None
        )

        def device_phase():
            if kids_ok is not None:
                self._absorb(kids_ok, ts_ok, vals_ok)
            closes = self._close_due(now_us, clock=clock)
            return closes, self.notify_at(clock=clock)

        return events, device_phase

    def _late_events(
        self, late_rows: np.ndarray, kids: np.ndarray, ts_us: np.ndarray, values
    ) -> List[Tuple[str, Tuple[int, str, Any]]]:
        """Window-id attribution for late rows (sliding arithmetic;
        the session subclass reports the late-session sentinel)."""
        spec = self.spec
        events = []
        wid_hi = np.floor(
            (ts_us[late_rows] - spec.align_us) / spec.offset_us
        ).astype(np.int64)
        for i, row in zip(range(len(late_rows)), late_rows):
            key = self.keys[int(kids[row])]
            ts_row = ts_us[row]
            for wid in range(
                int(wid_hi[i]) - self.expand + 1, int(wid_hi[i]) + 1
            ):
                # Same in-window bound as the on-time path; for
                # offsets that don't divide length, not every wid
                # in the static range contains the timestamp.
                if (
                    ts_row
                    < spec.align_us
                    + wid * spec.offset_us
                    + spec.length_us
                ):
                    events.append((key, (wid, "L", values[row])))
        return events

    def _absorb(
        self, kids_ok: np.ndarray, ts_ok: np.ndarray, vals_ok: np.ndarray
    ) -> None:
        """Route on-time rows into windows and fold them on device."""
        self._fold_rows(kids_ok, ts_ok, vals_ok)

    def _fold_rows(
        self, kids_ok: np.ndarray, ts_ok: np.ndarray, vals_ok: np.ndarray
    ) -> None:
        """Fold on-time rows into their containing windows (opening
        windows as needed) — the scatter-combine into the slot table."""
        spec = self.spec
        hi = np.floor(
            (ts_ok - spec.align_us) / spec.offset_us
        ).astype(np.int64)
        if len(hi) and int(np.abs(hi).max()) >= (1 << 31) - self.expand:
            msg = (
                "window ids exceed the composite encoding range; "
                "move align_to closer to the event times or use a "
                "larger window offset"
            )
            raise ValueError(msg)

        # Expand each row into the (static count of) windows that
        # contain it, all vectorized.  Tumbling windows (expand == 1)
        # skip the 2-D broadcast entirely: every row is in exactly its
        # own window (ts < align + hi*offset + length holds by
        # construction of hi when offset == length), saving five
        # row-count-sized materializations per batch on the pipeline
        # worker.
        if self.expand == 1 and spec.offset_us == spec.length_us:
            kid_rep = kids_ok
            wid_flat = hi
            val_rep = vals_ok
        else:
            e = np.arange(self.expand, dtype=np.int64)
            wids = hi[:, None] - e[None, :]  # [n, expand]
            in_window = (
                ts_ok[:, None]
                < spec.align_us + wids * spec.offset_us + spec.length_us
            )
            kid_rep = np.broadcast_to(kids_ok[:, None], wids.shape)[
                in_window
            ]
            wid_flat = wids[in_window]
            val_rep = np.broadcast_to(vals_ok[:, None], wids.shape)[
                in_window
            ]

        # Composite (key, window) ids; python work only per NEW
        # composite, per-row mapping is pure numpy.
        comp = (kid_rep << 32) + (wid_flat + (1 << 31))
        uniq, inverse = np.unique(comp, return_inverse=True)
        slot_of_uniq = np.empty(len(uniq), dtype=np.int32)
        for j, c in enumerate(uniq.tolist()):
            kid = c >> 32
            wid = (c & ((1 << 32) - 1)) - (1 << 31)
            slot_of_uniq[j] = self.agg.alloc(
                f"{self.keys[kid]}\x00{wid}"
            )
            if (kid, wid) not in self.open_close_us:
                self.open_close_us[(kid, wid)] = (
                    spec.align_us
                    + wid * spec.offset_us
                    + spec.length_us
                )
                self._open_cache = None
        if len(comp):
            _flight.RECORDER.count("window_rows_ingested", len(val_rep))
            _flight.RECORDER.record(
                "device_dispatch", tier="window", rows=len(val_rep)
            )
            self.agg.update_ids(slot_of_uniq[inverse], val_rep)

    def _open_arrays(self):
        """Cached parallel arrays of the open-window table so the
        per-batch due check is vectorized (a Python loop here is
        O(keys × windows) per batch at high cardinality)."""
        if self._open_cache is None:
            items = list(self.open_close_us.items())
            kids = np.fromiter(
                (k for (k, _w), _c in items), dtype=np.int64, count=len(items)
            )
            wids = np.fromiter(
                (w for (_k, w), _c in items), dtype=np.int64, count=len(items)
            )
            closes = np.fromiter(
                (c for _kw, c in items), dtype=np.float64, count=len(items)
            )
            self._open_cache = (kids, wids, closes)
        return self._open_cache

    def _close_due(
        self, now_us: float, clock=None
    ) -> List[Tuple[str, Tuple[int, str, Any]]]:
        if not self.open_close_us:
            return []
        kids_arr, wids_arr, closes_arr = self._open_arrays()
        base, sys_at = clock if clock is not None else (
            self.base_us,
            self.sys_at_base,
        )
        wm = base[kids_arr] + (now_us - sys_at[kids_arr])
        due_rows = np.nonzero(closes_arr <= wm)[0]
        if not len(due_rows):
            return []
        due = [
            (int(kids_arr[i]), int(wids_arr[i]), float(closes_arr[i]))
            for i in due_rows
        ]
        events = []
        # bytewax: allow[BTX-DRAIN] — the windower's .agg is its own slot table (never residency-wrapped; the driver evicts only the keyed-agg/scan tiers), and this due-window fetch runs inside the deferred device phase the pipeline worker owns
        snaps = self.agg.snapshots_for(
            [f"{self.keys[kid]}\x00{wid}" for kid, wid, _ in due]
        )
        from bytewax_tpu_torch.operators.windowing import WindowMetadata

        for (kid, wid, close_us), (_ck, snap) in zip(due, snaps):
            key = self.keys[kid]
            value = self._finalize_one(snap)
            del self.open_close_us[(kid, wid)]
            self.agg.discard(f"{key}\x00{wid}")
            events.append((key, (wid, "E", value)))
            open_dt = datetime.fromtimestamp(
                (close_us - self.spec.length_us) / _US, tz=timezone.utc
            )
            close_dt = datetime.fromtimestamp(close_us / _US, tz=timezone.utc)
            events.append(
                (key, (wid, "M", WindowMetadata(open_dt, close_dt)))
            )
        self._open_cache = None
        return events

    def _finalize_one(self, snap: Any) -> Any:
        kind = self.spec.kind
        if snap is None:
            return 0 if kind == "count" else None
        if kind == "count":
            return int(snap)
        # mean/stats windows emit the raw accumulator ((sum, count) /
        # (min, max, sum, count)) exactly like the host-tier
        # WindowFold; finalization happens downstream (mean_window /
        # stats_window append it).
        return snap

    def on_notify(self) -> List[Tuple[str, Tuple[int, str, Any]]]:
        now_us = datetime.now(timezone.utc).timestamp() * _US
        return self._close_due(now_us)

    def on_eof(self) -> List[Tuple[str, Tuple[int, str, Any]]]:
        return self._close_due(np.inf)

    def notify_at(self, clock=None) -> Optional[datetime]:
        """System time of the earliest window close: the instant the
        key's watermark reaches the close time."""
        if not self.open_close_us:
            return None
        kids_arr, _wids_arr, closes_arr = self._open_arrays()
        base, sys_at = clock if clock is not None else (
            self.base_us,
            self.sys_at_base,
        )
        bases = base[kids_arr]
        finite = np.isfinite(bases)
        if not finite.any():
            return None
        ats = sys_at[kids_arr][finite] + (
            closes_arr[finite] - bases[finite]
        )
        return datetime.fromtimestamp(float(ats.min()) / _US, tz=timezone.utc)

    # -- recovery ----------------------------------------------------------

    def snapshots_for(self, keys: List[str]):
        """Host-tier ``_WindowSnapshot``-compatible snapshots; a key
        with no open windows snapshots as a discard (the host tier
        discards empty window logics the same way).

        One pass over the open-window table groups it by key, and one
        device→host copy of the slot table serves every key asked
        for.  (The JAX package scans the whole table and copies the
        slot table once per key: at 10,000 keys and 110,000 open
        sliding windows an epoch snapshot stalled the pipeline so long
        that the EventClock's system-time term made on-time rows
        late.)  The snapshots are the same."""
        from bytewax_tpu_torch.operators.windowing import (
            WindowMetadata,
            _EventClockState,
            _SlidingWindowerState,
            _WindowSnapshot,
        )

        asked = {}
        for key in keys:
            kid = self.key_ids.get(key)
            if kid is not None:
                asked[kid] = key
        open_by_kid: Dict[int, List[Tuple[int, float]]] = {}
        for (kid, wid), close_us in self.open_close_us.items():
            if kid in asked:
                open_by_kid.setdefault(kid, []).append((wid, close_us))
        comps = [
            f"{asked[kid]}\x00{wid}"
            for kid, wins in open_by_kid.items()
            for wid, _close in wins
        ]
        agg_snaps = dict(self.agg.snapshots_for(comps)) if comps else {}

        out = []
        for key in keys:
            kid = self.key_ids.get(key)
            wins = open_by_kid.get(kid) if kid is not None else None
            if not wins:
                out.append((key, None))
                continue
            opened = {}
            states = {}
            for wid, close_us in wins:
                open_dt = datetime.fromtimestamp(
                    (close_us - self.spec.length_us) / _US,
                    tz=timezone.utc,
                )
                close_dt = datetime.fromtimestamp(
                    close_us / _US, tz=timezone.utc
                )
                opened[wid] = WindowMetadata(open_dt, close_dt)
                states[wid] = agg_snaps[f"{key}\x00{wid}"]
            base = self.base_us[kid]
            clock_state = _EventClockState(
                system_time_of_max_event=datetime.fromtimestamp(
                    self.sys_at_base[kid] / _US, tz=timezone.utc
                ),
                watermark_base=(
                    datetime.fromtimestamp(base / _US, tz=timezone.utc)
                    if np.isfinite(base)
                    else datetime.min.replace(tzinfo=timezone.utc)
                ),
            )
            out.append(
                (
                    key,
                    _WindowSnapshot(
                        clock_state,
                        _SlidingWindowerState(opened=opened),
                        states,
                        [],
                    ),
                )
            )
        return out

    def demotion_snapshots(self):
        """Full-state drain for device→host demotion: host-format
        window snapshots for every key this windower has ever seen
        (keys with no open windows drain as None — the host tier
        rebuilds them on demand, matching its own discard of empty
        window logics)."""
        return self.snapshots_for(sorted(self.key_ids))

    def _load_clock(self, kid: int, snap: Any) -> None:
        cs = snap.clock_state
        if cs is not None:
            self.base_us[kid] = _to_us(cs.watermark_base)
            self.sys_at_base[kid] = _to_us(cs.system_time_of_max_event)

    def _replay_queue(self, kid: int, snap: Any) -> None:
        """A host-tier ordered=True logic keeps on-time values whose
        ts is still ahead of the watermark in ``queue``, to apply in
        timestamp order once due.  The device tier folds eagerly (its
        folds are commutative), so replay them into their windows now
        — the host never late-drops queued entries, so neither do we.
        Window closes happen on the next batch / notify via the
        restored watermark base."""
        queue = getattr(snap, "queue", None)
        if not queue:
            return
        ts_q = np.fromiter(
            (_to_us(ts) for _v, ts in queue),
            dtype=np.float64,
            count=len(queue),
        )
        if self.spec.kind == "count":
            vals_q = np.ones(len(queue), dtype=np.float64)
        else:
            vals_q = np.asarray([v for v, _ts in queue])
        self._absorb(
            np.full(len(queue), kid, dtype=np.int64), ts_q, vals_q
        )

    def _install(self, key: str, kid: int, snap: Any) -> List[Tuple[str, Any]]:
        """Restore one key's clock and open windows from its
        ``_WindowSnapshot``; returns its windows' ``(slot key, state)``
        pairs for the fold table."""
        self._load_clock(kid, snap)
        for wid, meta in snap.windower_state.opened.items():
            self.open_close_us[(kid, wid)] = _to_us(meta.close_time)
        return [
            (f"{key}\x00{wid}", state)
            for wid, state in snap.logic_states.items()
        ]

    def load_many(self, items: List[Tuple[str, Any]]) -> None:
        """Resume a page of host-tier ``(key, _WindowSnapshot)`` pairs.
        The clocks and open-window maps restore per key; every window's
        accumulator then goes into the fold table with one
        ``load_many`` (one indexed write per field for the page; the
        JAX package writes each window on its own), and queued values
        replay last."""
        if not items:
            return
        kids = self._key_ids_for([key for key, _snap in items]).tolist()
        states = []
        for (key, snap), kid in zip(items, kids):
            states.extend(self._install(key, kid, snap))
        self._open_cache = None
        self.agg.load_many(states)
        for (_key, snap), kid in zip(items, kids):
            self._replay_queue(kid, snap)

    def load(self, key: str, snap: Any) -> None:
        """Resume one key from a host-tier ``_WindowSnapshot``."""
        self.load_many([(key, snap)])

    # -- residency (engine/residency.py) ------------------------------------
    #
    # The extract/inject surface for window state: a key drains to its
    # host-tier ``_WindowSnapshot`` and its device fold slots are
    # released.  NOTE the scheduling caveat: an extracted key's open
    # windows stop closing by wall clock until the key is reinstated,
    # so callers must route snapshot reads AND notify scheduling
    # through a residency cache — the driver does not evict window
    # state yet (docs/state-residency.md).

    def extract_keys(self, keys: List[str]) -> List[Tuple[str, Any]]:
        """Snapshot AND release the given keys: open windows close
        their device slots; the per-key clock entries stay (a later
        ``inject_keys`` restores the snapshotted clock)."""
        out = []
        for key, snap in self.snapshots_for(keys):
            if snap is None:
                continue
            kid = self.key_ids[key]
            for k2, wid in [
                kw for kw in self.open_close_us if kw[0] == kid
            ]:
                del self.open_close_us[(k2, wid)]
                self.agg.discard(f"{key}\x00{wid}")
            self._open_cache = None
            self.touched.discard(key)
            out.append((key, snap))
        return out

    def inject_keys(self, items: List[Tuple[str, Any]]) -> None:
        """Reinstate previously-extracted keys from their host-tier
        ``_WindowSnapshot``s."""
        self.load_many(items)


class DeviceSessionAggState(DeviceWindowAggState):
    """Session windows on the device tier: key-local gap merges.

    The heavy per-row work stays vectorized/on-device: rows are
    lexsorted by (key, timestamp), contiguous runs (consecutive
    timestamps within ``gap``) are found with one vectorized diff,
    each run folds into ONE device slot via the same scatter-combine
    as sliding windows, and only per-RUN work (session create /
    extend / gap-merge bookkeeping, ``WindowMetadata.merged_ids``)
    runs in host Python — O(runs + open sessions), not O(rows).

    A session's accumulator is the combine of its slot set; merging
    two sessions is list concatenation (no device roundtrip), and
    the combine happens host-side at close/snapshot over a handful
    of scalars.

    Documented deviations from the host tier (cosmetic — the merged
    intervals, membership, and values are identical):

    - New session ids are assigned in timestamp order within each
      delivered batch; the host tier assigns in arrival order.
    - A merge's surviving id is the earliest-open pre-merge session;
      the host tier's can differ when a single value extends several
      sessions downward at once.

    Reference session semantics:
    upstream bytewax ``pysrc/bytewax/operators/windowing.py:688-806``.
    """

    def __init__(self, spec: SessionAccelSpec):
        super().__init__(spec)
        #: kid -> wid -> [open_us, close_us, merged_ids set]
        self.sessions: Dict[int, Dict[int, list]] = {}
        #: kid -> next session id (never reset: session ids must not
        #: be reused, matching the host windower's never-empty state)
        self.next_wid: Dict[int, int] = {}
        #: (kid, wid) -> device slot keys whose combine is the
        #: session's accumulator
        self.session_slots: Dict[Tuple[int, int], List[str]] = {}
        self._slot_seq = 0
        # For sessions, ``open_close_us`` holds each session's DUE
        # time (close + gap) so the base class's vectorized due scan
        # and ``notify_at`` apply unchanged; emission recovers the
        # close time by subtracting the gap.

    # -- session bookkeeping (per run, host Python) ------------------------

    def _place_run(self, kid: int, lo_us: float, hi_us: float) -> int:
        """Create/extend/merge sessions for one run of rows; returns
        the session id the run folds into."""
        gap = self.spec.gap_us
        sess = self.sessions.setdefault(kid, {})
        overlapping = [
            wid
            for wid, s in sess.items()
            if not (hi_us < s[0] - gap or lo_us > s[1] + gap)
        ]
        if not overlapping:
            wid = self.next_wid.get(kid, 0)
            self.next_wid[kid] = wid + 1
            sess[wid] = [lo_us, hi_us, set()]
            self.session_slots[(kid, wid)] = []
            self.open_close_us[(kid, wid)] = hi_us + gap
            self._open_cache = None
            return wid
        winner = min(overlapping, key=lambda w: sess[w][0])
        s = sess[winner]
        s[0] = min(s[0], lo_us)
        s[1] = max(s[1], hi_us)
        for other in overlapping:
            if other == winner:
                continue
            o = sess.pop(other)
            s[0] = min(s[0], o[0])
            s[1] = max(s[1], o[1])
            # The host records only the absorbed window's id (its own
            # merged_ids are dropped): windowing.py _merge_overlapping.
            s[2].add(other)
            self.session_slots[(kid, winner)].extend(
                self.session_slots.pop((kid, other))
            )
            del self.open_close_us[(kid, other)]
        self.open_close_us[(kid, winner)] = s[1] + gap
        self._open_cache = None
        return winner

    # -- hook overrides -----------------------------------------------------

    def _late_events(
        self, late_rows: np.ndarray, kids: np.ndarray, ts_us: np.ndarray, values
    ) -> List[Tuple[str, Tuple[int, str, Any]]]:
        # Session membership depends on other values, so a late value
        # can't name a specific session (host: late_for -> sentinel).
        from bytewax_tpu_torch.operators.windowing import LATE_SESSION_ID

        return [
            (
                self.keys[int(kids[row])],
                (LATE_SESSION_ID, "L", values[row]),
            )
            for row in late_rows
        ]

    def _absorb(
        self, kids_ok: np.ndarray, ts_ok: np.ndarray, vals_ok: np.ndarray
    ) -> None:
        n = len(ts_ok)
        if not n:
            return
        order = np.lexsort((ts_ok, kids_ok))
        k = kids_ok[order]
        t = ts_ok[order]
        v = np.asarray(vals_ok)[order]
        # Runs: maximal (key, ts-sorted) stretches with consecutive
        # gaps <= gap.  Runs are disjoint and processed in ts order
        # per key, so a run that bridges two existing sessions via
        # transitive extension is handled by _place_run seeing the
        # already-extended interval.
        new_run = np.empty(n, dtype=bool)
        new_run[0] = True
        np.logical_or(
            k[1:] != k[:-1],
            (t[1:] - t[:-1]) > self.spec.gap_us,
            out=new_run[1:],
        )
        run_of_row = np.cumsum(new_run) - 1
        starts = np.nonzero(new_run)[0]
        ends = np.append(starts[1:], n) - 1
        slot_of_run = np.empty(len(starts), dtype=np.int32)
        for r in range(len(starts)):
            kid = int(k[starts[r]])
            wid = self._place_run(kid, float(t[starts[r]]), float(t[ends[r]]))
            # Fold into the session's existing slot when it has one:
            # a continuously-active session must stay O(1) state, not
            # accumulate a slot per batch.  (Extra slots only ever
            # come from merges, which concatenate lists.)
            slots = self.session_slots[(kid, wid)]
            if slots:
                slot_key = slots[0]
            else:
                slot_key = f"{self.keys[kid]}\x00{wid}\x00{self._slot_seq}"
                self._slot_seq += 1
                slots.append(slot_key)
            slot_of_run[r] = self.agg.alloc(slot_key)
        _flight.RECORDER.count("window_rows_ingested", len(v))
        _flight.RECORDER.record(
            "device_dispatch", tier="session", rows=len(v)
        )
        self.agg.update_ids(slot_of_run[run_of_row], v)

    def _combine(self, snaps: List[Any]) -> Any:
        """Combine slot accumulators host-side (kind algebra over a
        handful of scalars)."""
        kind = self.spec.kind
        snaps = [s for s in snaps if s is not None]
        if not snaps:
            return None
        acc = snaps[0]
        for s in snaps[1:]:
            if kind in ("sum", "count"):
                acc = acc + s
            elif kind == "min":
                acc = min(acc, s)
            elif kind == "max":
                acc = max(acc, s)
            elif kind == "mean":
                acc = (acc[0] + s[0], acc[1] + s[1])
            else:  # stats
                acc = (
                    min(acc[0], s[0]),
                    max(acc[1], s[1]),
                    acc[2] + s[2],
                    acc[3] + s[3],
                )
        return acc

    def _session_acc(self, kid: int, wid: int, discard: bool) -> Any:
        slot_keys = self.session_slots[(kid, wid)]
        acc = self._combine(
            [s for _k, s in self.agg.snapshots_for(slot_keys)]
        )
        if discard:
            for sk in slot_keys:
                self.agg.discard(sk)
            del self.session_slots[(kid, wid)]
        return acc

    def _close_due(
        self, now_us: float, clock=None
    ) -> List[Tuple[str, Tuple[int, str, Any]]]:
        if not self.open_close_us:
            return []
        kids_arr, wids_arr, dues_arr = self._open_arrays()
        base, sys_at = clock if clock is not None else (
            self.base_us,
            self.sys_at_base,
        )
        wm = base[kids_arr] + (now_us - sys_at[kids_arr])
        # Strict: a session closes when the watermark passes close +
        # gap (host: close_time < watermark - gap), not at equality.
        due_rows = np.nonzero(dues_arr < wm)[0]
        if not len(due_rows):
            return []
        from bytewax_tpu_torch.operators.windowing import WindowMetadata

        events = []
        for i in due_rows:
            kid, wid = int(kids_arr[i]), int(wids_arr[i])
            key = self.keys[kid]
            acc = self._session_acc(kid, wid, discard=True)
            s = self.sessions[kid].pop(wid)
            del self.open_close_us[(kid, wid)]
            events.append((key, (wid, "E", self._finalize_one(acc))))
            meta = WindowMetadata(
                datetime.fromtimestamp(s[0] / _US, tz=timezone.utc),
                datetime.fromtimestamp(s[1] / _US, tz=timezone.utc),
                set(s[2]),
            )
            events.append((key, (wid, "M", meta)))
        self._open_cache = None
        return events

    # -- recovery -----------------------------------------------------------

    def snapshots_for(self, keys: List[str]):
        """Host-tier ``_WindowSnapshot``-compatible snapshots with
        session windower state.  Session state is never discarded
        once a key exists (ids must not be reused — host parity).

        One device→host copy of the slot table serves every session
        of every key asked for (the JAX package copies it once per
        session); the snapshots are the same."""
        from bytewax_tpu_torch.operators.windowing import (
            WindowMetadata,
            _EventClockState,
            _SessionWindowerState,
            _WindowSnapshot,
        )

        slot_keys = [
            sk
            for key in keys
            if key in self.key_ids
            for wid in self.sessions.get(self.key_ids[key], {})
            for sk in self.session_slots[(self.key_ids[key], wid)]
        ]
        agg_snaps = (
            dict(self.agg.snapshots_for(slot_keys)) if slot_keys else {}
        )
        out = []
        for key in keys:
            kid = self.key_ids.get(key)
            if kid is None:
                out.append((key, None))
                continue
            sess = self.sessions.get(kid, {})
            metas = {
                wid: WindowMetadata(
                    datetime.fromtimestamp(s[0] / _US, tz=timezone.utc),
                    datetime.fromtimestamp(s[1] / _US, tz=timezone.utc),
                    set(s[2]),
                )
                for wid, s in sess.items()
            }
            states = {
                wid: self._combine(
                    [agg_snaps[sk] for sk in self.session_slots[(kid, wid)]]
                )
                for wid in sess
            }
            base = self.base_us[kid]
            clock_state = _EventClockState(
                system_time_of_max_event=datetime.fromtimestamp(
                    self.sys_at_base[kid] / _US, tz=timezone.utc
                ),
                watermark_base=(
                    datetime.fromtimestamp(base / _US, tz=timezone.utc)
                    if np.isfinite(base)
                    else datetime.min.replace(tzinfo=timezone.utc)
                ),
            )
            out.append(
                (
                    key,
                    _WindowSnapshot(
                        clock_state,
                        _SessionWindowerState(
                            next_id=self.next_wid.get(kid, 0),
                            sessions=metas,
                            merge_queue=[],
                        ),
                        states,
                        [],
                    ),
                )
            )
        return out

    def _install(self, key: str, kid: int, snap: Any) -> List[Tuple[str, Any]]:
        """Restore one key's clock and sessions from its session
        ``_WindowSnapshot``; returns its sessions' ``(slot key,
        state)`` pairs for the fold table."""
        self._load_clock(kid, snap)
        st = snap.windower_state
        self.next_wid[kid] = st.next_id
        sess = self.sessions.setdefault(kid, {})
        gap = self.spec.gap_us
        for wid, meta in st.sessions.items():
            sess[wid] = [
                _to_us(meta.open_time),
                _to_us(meta.close_time),
                set(meta.merged_ids),
            ]
            self.session_slots[(kid, wid)] = []
            self.open_close_us[(kid, wid)] = _to_us(meta.close_time) + gap
        # A snapshot taken between a windower merge and the logic
        # merge has the sessions dict merged but logic states still
        # split per pre-merge id; resolve each state to its surviving
        # session (chasing chained merges).
        into = dict(st.merge_queue)
        states = []
        for wid, state in snap.logic_states.items():
            target = wid
            seen = set()
            while target in into and target not in seen:
                seen.add(target)
                target = into[target]
            if target not in sess:
                continue
            slot_key = f"{key}\x00{target}\x00{self._slot_seq}"
            self._slot_seq += 1
            states.append((slot_key, state))
            self.session_slots[(kid, target)].append(slot_key)
        return states

    def extract_keys(self, keys: List[str]) -> List[Tuple[str, Any]]:
        """Session variant of the residency extract: open sessions
        drain into the snapshot (which carries ``next_id``, so session
        ids stay unique across an extract/inject round trip) and their
        device slots are released."""
        out = []
        for key, snap in self.snapshots_for(keys):
            kid = self.key_ids.get(key)
            if snap is None or kid is None:
                continue
            # Keys with ZERO open sessions still extract: their
            # snapshot carries next_id/clock state (session state is
            # never discarded once a key exists), and skipping them
            # would leave a residency manager believing it evicted a
            # key that released nothing.
            for wid in list(self.sessions.get(kid, {})):
                for slot_key in self.session_slots.pop((kid, wid), []):
                    self.agg.discard(slot_key)
                self.open_close_us.pop((kid, wid), None)
            self.sessions[kid] = {}
            self._open_cache = None
            self.touched.discard(key)
            out.append((key, snap))
        return out
