"""Columnar micro-batches.

An :class:`ArrayBatch` is the unit of the XLA fast path: a dict of
equal-length columns (numpy or jax arrays) that flows through the same
core-operator plan as Python item lists.  Host-tier operators that
need items expand it with :meth:`to_pylist`; device-tier operators
consume the columns directly.
"""

from datetime import datetime
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "ArrayBatch",
    "PeerVocab",
    "TsValue",
    "VocabMap",
    "VocabMaps",
    "column_ts",
    "peer_vocab",
]


class TsValue(float):
    """Degrade payload for ``{key, ts, value}`` columnar rows: a float
    that also carries the row's event timestamp as ``.ts``.

    Arithmetic (fold/reduce) yields plain floats, so host-tier
    reducers consume it unchanged; event-time clocks read the
    timestamp via :func:`column_ts` (or ``lambda v: v.ts``).
    """

    __slots__ = ("ts",)

    def __new__(cls, value: float, ts: datetime) -> "TsValue":
        self = super().__new__(cls, value)
        self.ts = ts
        return self

    def __reduce__(self):
        # Default float pickling drops the ts attribute.
        return (TsValue, (float(self), self.ts))


class VocabMap:
    """Append-only mapping from a batch's external ``key_id`` space to
    engine-internal ids.

    Shared by every dictionary-encoded fast path (single-device and
    sharded keyed aggregation, windowed folds): validates that each
    batch's ``key_vocab`` is an append-only extension of the previous
    one (id meanings can never change between batches), grows the
    id table, and assigns internal ids for newly-seen externals via
    the caller's ``alloc``.

    Grow a vocabulary by passing a NEW (longer) array or list each
    time.  Validation of the already-seen prefix is by cached length
    plus a sampled-entry spot-check — O(probes + new suffix) per
    batch, never a full re-scan of the vocabulary — so a detected
    rewrite raises, while a rewrite that dodges every sampled entry
    of a large vocabulary is undefined behavior (the contract was
    always append-only).
    """

    __slots__ = ("vocab", "table", "_ref", "_ref_probe", "_dtype")

    #: How many entries the identity fast path spot-checks per batch.
    _PROBE_N = 16

    def __init__(self, dtype=np.int32):
        self.vocab: Optional[np.ndarray] = None
        self.table: Optional[np.ndarray] = None
        self._ref: Any = None
        self._ref_probe: Any = None
        self._dtype = dtype

    def _probe_of(self, arr: np.ndarray):
        """A cheap fingerprint of an ndarray vocab: a spread of sampled
        entries.  Lets the identity fast path catch in-place rewrites
        (same object, new meanings) instead of corrupting the mapping
        silently."""
        n = len(arr)
        if n == 0:
            return (0, ())
        idx = np.linspace(0, n - 1, min(n, self._PROBE_N)).astype(np.intp)
        return (n, tuple(arr[idx].tolist()))

    def sync(self, ids: np.ndarray, vocab: Any, alloc_many) -> np.ndarray:
        """Install/extend ``vocab``, assign internal ids for new
        externals appearing in ``ids`` (``alloc_many([key_str, ...])
        -> id array``, one call per batch of new keys), and return
        the unique external ids touched.

        Validation cost is O(new suffix + probes) per batch, not
        O(vocabulary): the already-validated prefix is re-checked by
        its cached length plus the sampled-entry fingerprint (the same
        spot-check contract the identity fast path always had), so a
        vocabulary grown by passing ever-longer arrays never pays a
        full prefix re-scan per batch."""
        same = vocab is self._ref and (
            # Identity only short-circuits full validation for
            # ndarrays (spot-checked below) — a list mutated in place
            # keeps its identity, so equal-length lists re-validate
            # every batch (in-place growth revalidates by probe).
            isinstance(vocab, np.ndarray)
            or len(vocab) == len(self.table)
            and vocab == self.vocab.tolist()
        )
        if same and isinstance(vocab, np.ndarray):
            if self._probe_of(vocab) != self._ref_probe:
                msg = (
                    "key_vocab ndarray was rewritten in place; id "
                    "meanings can never change between batches — grow "
                    "a vocabulary by passing a new, longer array"
                )
                raise TypeError(msg)
        if self.vocab is None:
            self.vocab = np.asarray(vocab)
            self.table = np.full(len(self.vocab), -1, dtype=self._dtype)
            self._ref = vocab
            self._ref_probe = self._probe_of(self.vocab)
        elif not same:
            prev = len(self.table)
            n = len(vocab)
            ok = n >= prev
            if ok and prev:
                # Spot-check the already-validated prefix at sampled
                # indices instead of re-scanning all of it: O(probes),
                # not O(vocabulary), per batch.
                idx = np.linspace(
                    0, prev - 1, min(prev, self._PROBE_N)
                ).astype(np.intp)
                if isinstance(vocab, np.ndarray):
                    ok = np.array_equal(vocab[idx], self.vocab[idx])
                else:
                    ok = all(
                        vocab[i] == self.vocab[i] for i in idx.tolist()
                    )
            if not ok:
                msg = (
                    "key_vocab must be an append-only extension of the "
                    "vocabulary used by earlier batches of this step"
                )
                raise TypeError(msg)
            if n > prev:
                if isinstance(vocab, np.ndarray):
                    self.vocab = vocab
                else:
                    # Convert only the new suffix; the validated
                    # prefix is already installed.
                    self.vocab = np.concatenate(
                        [self.vocab, np.asarray(vocab[prev:])]
                    )
                pad = np.full(n - prev, -1, self._dtype)
                self.table = np.concatenate([self.table, pad])
            self._ref = vocab
            self._ref_probe = self._probe_of(self.vocab)
        if len(ids):
            mx, mn = int(ids.max()), int(ids.min())
            if mx >= len(self.table) or mn < 0:
                bad = mx if mx >= len(self.table) else mn
                msg = (
                    f"key_id {bad} is out of range for a "
                    f"{len(self.table)}-entry key_vocab"
                )
                raise TypeError(msg)
        # bincount + nonzero beats np.unique's sort by ~20x here.
        counts = np.bincount(ids, minlength=len(self.table))
        uniq = np.nonzero(counts)[0]
        new = uniq[self.table[uniq] < 0]
        if len(new):
            self.table[new] = np.asarray(
                alloc_many([str(self.vocab[e]) for e in new.tolist()]),
                dtype=self._dtype,
            )
        return uniq

    def drop_ids(self, internal_ids) -> int:
        """Forget the external entries mapped to these *internal* ids
        (back to unassigned): the next :meth:`sync` re-allocs them, so
        a released internal id can be reused by another key without a
        stale external mapping folding rows into the wrong slot.
        Returns how many entries were dropped."""
        if self.table is None or not len(self.table):
            return 0
        mask = np.isin(
            self.table,
            np.asarray(list(internal_ids), dtype=self.table.dtype),
        )
        n = int(mask.sum())
        if n:
            self.table[mask] = -1
        return n

    def continued_by(self, vocab: Any) -> bool:
        """Whether ``vocab`` is this map's vocabulary or an exact
        append-only extension of it (every entry compared, unlike the
        sampled check of :meth:`sync`)."""
        if self.vocab is None or vocab is self._ref:
            return True
        n = len(self.vocab)
        return len(vocab) >= n and np.array_equal(
            np.asarray(vocab[:n]), self.vocab
        )


class PeerVocab(np.ndarray):
    """A ``key_vocab`` that arrived from another cluster process.

    Each process dictionary-encodes its own rows (the 1BRC parser
    numbers stations in the order it meets them), so the ids of a
    routed batch mean something only against the vocabulary they came
    with.  The driver tags such a vocabulary with its sender's process
    id (``origin``) as the frame arrives; device states then map each
    origin's ids on their own (:class:`VocabMaps`) instead of taking
    them as ids of this process's vocabulary."""

    origin: int

    def __array_finalize__(self, obj):
        self.origin = getattr(obj, "origin", -1)


def peer_vocab(vocab: Any, origin: int) -> PeerVocab:
    """``vocab`` as a :class:`PeerVocab` of process ``origin``."""
    out = np.asarray(vocab).view(PeerVocab)
    out.origin = origin
    return out


class VocabMaps:
    """The :class:`VocabMap` of each vocabulary lineage feeding one
    device state: this process's own (held to the append-only
    contract, as a single map is) and one per sending process.

    A peer's map starts over when a vocabulary from that peer does not
    extend it exactly (a peer may forward batches of several
    lineages); that costs only the map's cache, because internal ids
    are allocated per key string: every lineage's table points a key
    to the same internal id."""

    __slots__ = ("_dtype", "local", "peers")

    def __init__(self, dtype=np.int32):
        self._dtype = dtype
        self.local = VocabMap(dtype)
        self.peers: Dict[int, VocabMap] = {}

    def of(self, vocab: Any) -> Tuple[Optional[int], VocabMap, bool]:
        """``(origin, map, fresh)`` for a batch's ``key_vocab``:
        origin None for this process's own vocabulary; ``fresh`` when
        a peer's map was just (re)started."""
        if not isinstance(vocab, PeerVocab):
            return None, self.local, False
        vmap = self.peers.get(vocab.origin)
        fresh = vmap is None or not vmap.continued_by(vocab)
        if fresh:
            vmap = self.peers[vocab.origin] = VocabMap(self._dtype)
        return vocab.origin, vmap, fresh

    def drop_ids(self, internal_ids) -> int:
        """:meth:`VocabMap.drop_ids` on every lineage's map."""
        ids = list(internal_ids)
        return sum(
            vmap.drop_ids(ids)
            for vmap in (self.local, *self.peers.values())
        )


_factorize = None


def factorize_keys(arr: np.ndarray):
    """Dictionary-encode a string key column: ``(codes, uniques)``
    with codes in order of first appearance.  This is the automatic
    feeder-side encoding that lets plain string-keyed batches reach
    the packed device path: hash-based ``pandas.factorize`` (~4x
    faster than ``np.unique``'s sort on string columns) when pandas
    is present, else ``np.unique``."""
    global _factorize
    if _factorize is None:
        try:
            from pandas import factorize as _pd_factorize

            _factorize = _pd_factorize
        except ImportError:
            _factorize = False
    if _factorize:
        codes, uniq = _factorize(arr)
        if len(codes) and codes.min() < 0:
            # pandas maps None/NaN keys to code -1, which negative
            # indexing would silently attribute to the LAST unique
            # key; fail loudly like the np.unique path does.
            msg = "key column contains null (None/NaN) keys"
            raise TypeError(msg)
        return codes, np.asarray(uniq)
    uniq, codes = np.unique(arr, return_inverse=True)
    return codes, uniq


class KeyEncoder:
    """Incremental dictionary encoder for string key columns — the
    automatic feeder-side encoding that gives plain string-keyed
    batches the packed device path's economics.

    Steady state (every key already seen) is one vectorized
    ``searchsorted`` over the sorted seen-key set plus one gather: no
    per-row Python objects, no per-batch hashing of every row.  Only
    rows with *unseen* keys pay :func:`factorize_keys`, and only the
    first time each key appears.
    """

    __slots__ = ("_sorted", "_ids")

    #: With at most this many seen keys, an over-wide incoming column
    #: is searched as-is (numpy string comparison is width-aware, so
    #: mixed-width searchsorted is exact) instead of paying the
    #: O(rows × width) narrowing scan+copy per batch — the search is
    #: so shallow that wide compares are cheaper than narrowing.
    _WIDE_SEARCH_MAX_KEYS = 16

    #: With at most this many seen keys, skip binary search entirely:
    #: one vectorized equality pass per seen key (memcmp-style, no
    #: insertion-point bookkeeping) beats two searchsorted calls —
    #: string-keyed low-cardinality streams are the common windowing
    #: shape, and this roughly halves their per-batch encode cost.
    _EQ_SCAN_MAX_KEYS = 3

    def __init__(self):
        self._sorted: Optional[np.ndarray] = None  # seen keys, sorted
        self._ids: Optional[np.ndarray] = None  # internal id per entry

    def _cold(self, keys: np.ndarray, alloc_many, install: bool):
        codes, uniq = factorize_keys(keys)
        ids = np.asarray(
            alloc_many([str(k) for k in uniq]), dtype=np.int64
        )
        if install:
            if keys.dtype.kind in "SU":
                # pandas hands uniques back as objects; keep the seen
                # set in the column's fixed-width dtype so the steady
                # state compares raw buffers, not PyObjects.  Narrow
                # it (cheap on the small unique set) so steady-state
                # searches stay at true key width even when the
                # producer's column was over-wide.
                uniq = self._narrowed(
                    np.asarray(uniq).astype(keys.dtype.kind)
                )
            self._merge(np.asarray(uniq), ids)
        return ids[codes]

    def _merge(self, uniq: np.ndarray, ids: np.ndarray) -> None:
        if self._sorted is None:
            order = np.argsort(uniq)
            self._sorted = uniq[order]
            self._ids = ids[order]
            return
        all_keys = np.concatenate([self._sorted, uniq])
        all_ids = np.concatenate([self._ids, ids])
        order = np.argsort(all_keys, kind="stable")
        all_keys = all_keys[order]
        all_ids = all_ids[order]
        keep = np.ones(len(all_keys), dtype=bool)
        keep[1:] = all_keys[1:] != all_keys[:-1]
        self._sorted = all_keys[keep]
        self._ids = all_ids[keep]

    @staticmethod
    def _narrowed(keys: np.ndarray) -> np.ndarray:
        """Trim a too-wide fixed-width column to its true width:
        binary-search cost scales with itemsize, and producers
        routinely hand over U21 columns holding 2-char keys (any
        ``ints.astype(str)``).  Exact — the width scan covers every
        row."""
        kind = keys.dtype.kind
        if kind not in "SU" or not len(keys):
            return keys
        unit = 4 if kind == "U" else 1
        cell = np.uint32 if kind == "U" else np.uint8
        per = keys.dtype.itemsize // unit
        if per <= 1:
            return keys
        # Strided column views (e.g. a columnar redistribute's
        # per-lane slices) can't be dtype-viewed; compact first.
        keys = np.ascontiguousarray(keys)
        used = (
            keys.view(cell).reshape(len(keys), per).any(axis=0)
        )
        nz = np.nonzero(used)[0]
        width = int(nz[-1]) + 1 if len(nz) else 1
        if width >= per:
            return keys
        return (
            keys.view(cell)
            .reshape(len(keys), per)[:, :width]
            .copy()
            .view(f"{kind}{width}")
            .reshape(len(keys))
        )

    def encode(self, keys: np.ndarray, alloc_many) -> np.ndarray:
        """Internal id per row; ``alloc_many([key_str, ...]) -> ids``
        assigns ids for keys seen for the first time."""
        keys = np.asarray(keys)
        if not len(keys):
            # Never install from an empty batch: its dtype kind is
            # arbitrary and would poison the steady-state fast path.
            return np.empty(0, dtype=np.int64)
        if (
            self._sorted is not None
            and keys.dtype.kind in "SU"
            and keys.dtype.kind == self._sorted.dtype.kind
            and len(self._sorted) <= self._EQ_SCAN_MAX_KEYS
        ):
            # Tiny seen set: one width-aware equality pass per key.
            out = np.empty(len(keys), dtype=np.int64)
            hit = np.zeros(len(keys), dtype=bool)
            for i in range(len(self._sorted)):
                m = keys == self._sorted[i]
                out[m] = self._ids[i]
                hit |= m
            if hit.all():
                return out
            miss = ~hit
            out[miss] = self._cold(keys[miss], alloc_many, install=True)
            return out
        if (
            self._sorted is not None
            and keys.dtype.kind in "SU"
            and keys.dtype.kind == self._sorted.dtype.kind
            and keys.dtype.itemsize > self._sorted.dtype.itemsize
            and len(self._sorted) <= self._WIDE_SEARCH_MAX_KEYS
        ):
            # Few keys, over-wide column: skip the narrowing pass and
            # search the (narrow) seen set with the wide keys
            # directly — numpy's width-aware comparison keeps this
            # exact.
            probe = self._sorted
        else:
            keys = self._narrowed(keys)
            probe = self._sorted
            if probe is None:
                return self._cold(keys, alloc_many, install=True)
            if probe.dtype.kind != keys.dtype.kind:
                # A producer switching between str/bytes/object
                # columns: stay correct without cross-kind
                # comparisons (slow path every batch, but mixed-kind
                # feeds are already odd).
                return self._cold(keys, alloc_many, install=False)
        # Membership via left/right insertion points: present keys
        # have right > left (and left is then the exact index).  Two
        # binary searches beat one search plus a per-row gather+
        # compare — the gather materializes a wide string array.
        lo = np.searchsorted(probe, keys, side="left")
        hit = np.searchsorted(probe, keys, side="right") > lo
        if hit.all():
            return self._ids[lo]
        out = np.empty(len(keys), dtype=np.int64)
        out[hit] = self._ids[lo[hit]]
        miss = ~hit
        out[miss] = self._cold(keys[miss], alloc_many, install=True)
        return out

    def drop(self, key: str) -> None:
        """Forget one key (its id is being released for reuse)."""
        if self._sorted is None or not len(self._sorted):
            return
        kind = self._sorted.dtype.kind
        try:
            if kind in "SU":
                probe = np.asarray([key]).astype(kind)[0]
            else:
                probe = key
        except (UnicodeEncodeError, ValueError):
            return
        pos = int(np.searchsorted(self._sorted, probe))
        if pos < len(self._sorted) and self._sorted[pos] == probe:
            self._sorted = np.delete(self._sorted, pos)
            self._ids = np.delete(self._ids, pos)

    def clear(self) -> None:
        self._sorted = None
        self._ids = None


def column_ts(value: Any) -> datetime:
    """The ts getter for columnar flows that may degrade to items: a
    ``{key, ts}`` batch degrades to timestamp values (returned as-is)
    and a ``{key, ts, value}`` batch to :class:`TsValue` (read
    ``.ts``).  On the device tier the ``ts`` column is used directly
    and this getter is never called.
    """
    if isinstance(value, datetime):
        return value
    return value.ts


class ArrayBatch:
    """A columnar batch of rows.

    Keyed convention: a batch feeding a keyed operator carries either
    a ``"key"`` column (strings) or a dictionary-encoded ``"key_id"``
    column (int32 into ``key_vocab``), plus a ``"value"`` column.
    Dictionary encoding is the fast path: the engine maps external ids
    to state slots with one vectorized table lookup instead of
    per-batch string sorting.

    ``key_vocab`` entries must never change meaning across batches:
    extend a vocabulary by passing a new, longer array (append-only);
    never rewrite entries of a reused array in place.
    """

    __slots__ = ("cols", "key_vocab", "value_scale")

    def __init__(
        self,
        cols: Dict[str, Any],
        key_vocab: Any = None,
        value_scale: Optional[float] = None,
    ):
        """``value_scale`` marks the ``value`` column as fixed-point:
        real value = stored int * scale (lossless for e.g. one-decimal
        temperatures stored as int16 deci-units)."""
        if not cols:
            msg = "ArrayBatch needs at least one column"
            raise ValueError(msg)
        self.cols = cols
        self.key_vocab = key_vocab
        self.value_scale = value_scale

    def __len__(self) -> int:
        first = next(iter(self.cols.values()))
        return len(first)

    def __repr__(self) -> str:
        return f"ArrayBatch({{{', '.join(self.cols)}}}, rows={len(self)})"

    def numpy(self, name: str) -> np.ndarray:
        return np.asarray(self.cols[name])

    def _key_strings(self) -> List[str]:
        """The key column as Python strings, decoding ``key_id``
        through ``key_vocab`` when dictionary-encoded."""
        if "key_id" in self.cols:
            if self.key_vocab is None:
                msg = "key_id columns need a key_vocab to decode"
                raise TypeError(msg)
            vocab = np.asarray(self.key_vocab)
            return vocab[np.asarray(self.cols["key_id"])].tolist()
        return np.asarray(self.cols["key"]).tolist()

    def _scaled_values(self) -> np.ndarray:
        """The ``value`` column with any fixed-point scale applied."""
        values = np.asarray(self.cols["value"])
        if self.value_scale is not None:
            values = values * self.value_scale
        return values

    def _ts_datetimes(self) -> List[datetime]:
        """The ``ts`` column as tz-aware datetimes (accepts
        ``np.datetime64`` or int64/float64 microseconds since epoch)."""
        from datetime import timezone

        ts = np.asarray(self.cols["ts"])
        if np.issubdtype(ts.dtype, np.datetime64):
            return [
                t.replace(tzinfo=timezone.utc)
                for t in ts.astype("datetime64[us]").tolist()
            ]
        return [
            datetime.fromtimestamp(t / 1e6, tz=timezone.utc)
            for t in ts.astype(np.float64).tolist()
        ]

    def to_pylist(self) -> List[Any]:
        """Expand to Python items for host-tier consumers.

        ``("key", "value")`` columns become ``(key, value)`` tuples, a
        single column becomes its scalars, anything else becomes
        per-row dicts.
        """
        names = set(self.cols)
        # A column named key_id invokes the dictionary-encoded keyed
        # convention; _key_strings raises a clear error when the
        # vocab is missing rather than silently mis-keying rows.
        if names in ({"key", "ts"}, {"key_id", "ts"}):
            # Columnar windowed-event batches degrade to (key,
            # timestamp) items so the host tier (and cluster
            # exchange) key them correctly; ts getters must accept
            # datetime values in columnar flows (see `column_ts`).
            return list(zip(self._key_strings(), self._ts_datetimes()))
        if names in ({"key", "ts", "value"}, {"key_id", "ts", "value"}):
            values = self._scaled_values()
            if np.issubdtype(values.dtype, np.number):
                # Numeric windowed-fold batches degrade to (key,
                # TsValue) items: the payload folds as a plain float
                # and carries the row's timestamp for `column_ts`
                # getters.  Non-numeric values (e.g. raw Kafka bytes)
                # fall through to per-row dicts — TsValue is a float.
                stamps = self._ts_datetimes()
                return [
                    (k, TsValue(v, t))
                    for k, v, t in zip(
                        self._key_strings(), values.tolist(), stamps
                    )
                ]
        if names == {"key_id", "value"}:
            return list(
                zip(self._key_strings(), self._scaled_values().tolist())
            )
        if names == {"key", "value"}:
            keys = np.asarray(self.cols["key"]).tolist()
            return list(zip(keys, self._scaled_values().tolist()))
        arrays = [np.asarray(c).tolist() for c in self.cols.values()]
        if len(arrays) == 1:
            return arrays[0]
        return [dict(zip(self.cols, row)) for row in zip(*arrays)]
