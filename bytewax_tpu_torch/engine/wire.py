"""Columnar frames on the wire — the cluster exchange codec.

Ingest is columnar end to end, but a batch crossing a process
boundary used to collapse into a length-prefixed pickle: the keyed
shuffle paid ``pickle.dumps``/``loads`` on every NumPy record batch
and each routed slice shipped one tiny frame.  Following Exoshuffle's
shuffle-as-a-library layering (PAPERS.md) this module owns the wire
*format* and the *batching policy* of the exchange, riding inside the
existing ``ship_deliver``/``ship_route`` payloads — zero new frame
kinds, zero new send surface, and the count-matched epoch barrier
counts exactly the frames that hit the socket.

Three pieces live here (docs/performance.md "Columnar exchange" and
"Overlapped collectives"):

- **The codec** (:func:`encode` / :func:`decode`): a ``deliver`` /
  ``route`` payload carrying an :class:`ArrayBatch` whose columns are
  fixed-width (numeric, ``datetime64``, ``S``/``U`` bytes) is framed
  as a compact header — schema (column names, dtypes, roles by name:
  ``key``/``key_id``/``ts``/``value``), row count, per-column byte
  lengths — followed by the raw column buffers, and decoded
  **zero-copy** via ``np.frombuffer`` over the received frame.
  Object-dtype columns fall back to a per-column pickle inside the
  columnar frame; non-batch payloads (control frames, item lists)
  fall back to the whole-frame pickle encoding unchanged.  Frames are
  versioned: an unknown version raises a typed
  :class:`~bytewax_tpu_torch.errors.WireFormatError` instead of guessing.

- **Per-peer accumulation** (:class:`RouteAccumulator`): ``ship_route``
  slices for the same (peer, stream, lane) — and ``ship_deliver``
  keyed split slices for the same (peer, op, port, lane) — accumulate
  and coalesce under the ingest coalescer's
  ``can_merge``/``merge_batches`` rules (engine/batching.py) until a
  poll boundary, so small routed slices amortize syscalls and
  per-frame headers.  The driver flushes it unconditionally before
  every drain point (``_Driver.ship_flush``, a BTX-DRAIN drain-only
  operation), so the generation-tagged count-matched barrier and
  epoch quiescence see exactly the frames they count.

- **The quantized aggregate codec** (:func:`encode_agg` /
  :func:`decode_agg`): the global-mesh collective tier's per-key
  partial-aggregate columns frame as a versioned header + per-column
  buffers where float columns are block-scaled down to int8 or bf16
  (EQuARX-style quantized all-reduce, PAPERS.md) per
  ``BYTEWAX_TPU_GSYNC_QUANT`` — integer and ``count`` columns are
  NEVER quantized (exact), and oversized column sets chunk into
  bounded frames.  The frames ride INSIDE the existing ``gsync``
  payload (pickled bytes — no new frame kinds); an unknown version
  or quant code raises a typed :class:`WireFormatError`, so
  mixed-version clusters fail loudly instead of folding garbage.

A vocab/schema cache rides the columnar framing when the comm layer
arms a :class:`WireSession` (one per mesh, reset with it on every
restart generation): an unchanged ``key_vocab`` for one (peer,
stream) ships once with a generation tag and subsequent frames carry
only the tag, invalidated whenever the vocab object or its length
moves.  ``BYTEWAX_TPU_WIRE=pickle`` bypasses all of it.

This module is pure encode/decode and in-memory accumulation — no
sockets, no comm frames.  It is callable only from the allowlisted
comm/driver modules (``contracts.WIRE_ALLOWED_MODULES``, enforced by
BTX-SEND and pinned in ``tests/test_comm_invariants.py``).

``BYTEWAX_TPU_WIRE=pickle`` restores the legacy wire wholesale —
whole-frame pickle for every payload AND one frame per routed slice
(the driver arms no accumulator) — which is both the mixed-version
rollout mode and the comparison baseline bench.py measures.
"""

import os
import pickle
import struct
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from bytewax_tpu_torch.engine import flight as _flight
from bytewax_tpu_torch.engine.arrays import ArrayBatch
from bytewax_tpu_torch.engine.batching import can_merge, merge_batches
from bytewax_tpu_torch.errors import WireFormatError

__all__ = [
    "RouteAccumulator",
    "WireSession",
    "decode",
    "decode_agg",
    "encode",
    "encode_agg",
    "gsync_quant",
    "reconfigure",
    "wire_mode",
]

#: Frame magic.  The first byte can never begin a protocol-2+ pickle
#: (those start with ``b"\x80"``), so ``decode`` can tell the two
#: encodings apart from the first bytes alone — the versioned
#: fallback needs no out-of-band flag.
_MAGIC = b"\xb5BXW"
#: Version 2 added the per-(peer, stream) vocab generation cache
#: (``_FLAG_VOCAB_GEN``/``_FLAG_VOCAB_REF``); a v1 decoder cannot
#: parse those flags, so the version byte moved — mixed-version
#: clusters fail typed and roll on ``BYTEWAX_TPU_WIRE=pickle``.
_VERSION = 2

_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

_KIND_DELIVER = 0
_KIND_ROUTE = 1

#: Per-column encodings inside a columnar frame.
_COL_RAW = 0
_COL_PICKLE = 1

#: Header flag bits.
_FLAG_SCALE = 1
_FLAG_VOCAB = 2
_FLAG_VOCAB_PICKLED = 4
#: The vocab body is followed by a u32 generation tag the receiver
#: caches per (sender, stream) in its :class:`WireSession`.
_FLAG_VOCAB_GEN = 8
#: No vocab body at all: a u32 generation tag referencing the vocab
#: the receiver cached from an earlier ``_FLAG_VOCAB_GEN`` frame.
_FLAG_VOCAB_REF = 16

#: Column buffers are padded to this alignment so the zero-copy
#: ``np.frombuffer`` views start on aligned offsets (unaligned numpy
#: views are legal but slower on every subsequent op).
_ALIGN = 8

#: dtype kinds shipped as raw buffers: bool, signed/unsigned ints,
#: floats, complex, timedelta64, datetime64, and fixed-width S/U
#: string cells.  Everything else (object columns above all) takes
#: the per-column pickle fallback.
_RAW_KINDS = frozenset("biufcmMSU")

_mode_cache: Optional[str] = None
_quant_cache: Optional[str] = None


def wire_mode() -> str:
    """The armed wire: ``"columnar"`` (default) or ``"pickle"``
    (``BYTEWAX_TPU_WIRE=pickle`` — the legacy wire: whole-frame
    pickle, no route accumulation).  Cached; re-read after
    :func:`reconfigure` (tests/bench)."""
    global _mode_cache
    if _mode_cache is None:
        raw = os.environ.get("BYTEWAX_TPU_WIRE", "columnar") or "columnar"
        _mode_cache = "pickle" if raw == "pickle" else "columnar"
    return _mode_cache


def gsync_quant() -> str:
    """The armed gsync aggregate-exchange quantization
    (``BYTEWAX_TPU_GSYNC_QUANT``): ``"off"`` (default — the exact
    device all_to_all exchange), ``"bf16"``, or ``"int8"``
    (block-scaled; docs/performance.md "Overlapped collectives").
    Cached; re-read after :func:`reconfigure`."""
    global _quant_cache
    if _quant_cache is None:
        raw = os.environ.get("BYTEWAX_TPU_GSYNC_QUANT", "off") or "off"
        if raw not in ("off", "bf16", "int8"):
            msg = (
                f"BYTEWAX_TPU_GSYNC_QUANT={raw!r} is not valid; use "
                "'off', 'bf16', or 'int8'"
            )
            raise ValueError(msg)
        _quant_cache = raw
    return _quant_cache


def reconfigure() -> None:
    """Drop the cached env knobs (tests/bench tweak them
    mid-process)."""
    global _mode_cache, _quant_cache
    _mode_cache = None
    _quant_cache = None


class WireSession:
    """Per-mesh vocab/schema cache (one per :class:`~bytewax_tpu_torch.
    engine.comm.Comm`, so it resets with the mesh on every restart
    generation and two in-process drivers never share one).

    ``tx`` maps ``(peer, stream key)`` to ``(vocab object, length,
    generation)`` — the strong reference pins the object so an
    identity test can never alias a recycled ``id()``.  An encode
    whose vocab matches by identity AND length ships only the
    generation tag; a changed object or a longer (grown-in-place
    list) vocab ships the full body under a fresh generation.  ``rx``
    maps ``(peer, stream key)`` to the latest ``(generation, vocab)``
    decoded from a defining frame; a reference to any other
    generation raises :class:`WireFormatError` (the defining frame
    was lost — a wedge the stall watchdog/supervisor already heals).
    """

    __slots__ = ("tx", "rx", "_gen")

    def __init__(self):
        self.tx: Dict[Tuple, Tuple[Any, int, int]] = {}
        self.rx: Dict[Tuple, Tuple[int, Any]] = {}
        self._gen = 0

    def next_gen(self) -> int:
        self._gen += 1
        return self._gen

    def status(self) -> Dict[str, int]:
        """Vocab-session view for ``/status``: the latest generation
        tag issued and how many (peer, stream) vocab cache entries
        are armed on each side.  Racy read — observability only."""
        return {
            "generation": self._gen,
            "tx_streams": len(self.tx),
            "rx_streams": len(self.rx),
        }


# -- encode -----------------------------------------------------------------


def _pack_str(s: str) -> Optional[bytes]:
    raw = s.encode("utf-8")
    if len(raw) > 0xFFFF:
        return None
    return _U16.pack(len(raw)) + raw


def _encode_columnar(
    msg: Any,
    session: Optional[WireSession] = None,
    peer: Optional[int] = None,
) -> Optional[bytes]:
    """The columnar framing of one ship payload, or None when the
    payload is not a codable batch (the caller then pickles whole).
    With a session armed, vocab bodies are cached per (peer, stream)
    under a generation tag — an unchanged vocab ships once."""
    if type(msg) is not tuple or not msg:
        return None
    if msg[0] == "deliver" and len(msg) == 4:
        kind, meta, entry = _KIND_DELIVER, msg[1:3], msg[3]
    elif msg[0] == "route" and len(msg) == 3:
        kind, meta, entry = _KIND_ROUTE, msg[1:2], msg[2]
    else:
        return None
    if type(entry) is not tuple or len(entry) != 2:
        return None
    w, batch = entry
    # Exact types only: a bool lane index or an ArrayBatch subclass
    # carrying extra state must round-trip through pickle unchanged.
    if type(w) is not int or type(batch) is not ArrayBatch:
        return None
    head: List[bytes] = [_MAGIC, _U8.pack(_VERSION), _U8.pack(kind)]
    if kind == _KIND_DELIVER:
        op_idx, port = meta
        if not (0 <= int(op_idx) <= 0xFFFFFFFF):
            return None
        port_b = _pack_str(port)
        if port_b is None:
            return None
        head.append(_U32.pack(int(op_idx)))
        head.append(port_b)
    else:
        (stream_id,) = meta
        sid_b = _pack_str(stream_id)
        if sid_b is None:
            return None
        head.append(sid_b)
    nrows = len(batch)
    flags = 0
    scale_b = b""
    if batch.value_scale is not None:
        if type(batch.value_scale) is not float:
            return None
        flags |= _FLAG_SCALE
        scale_b = _F64.pack(batch.value_scale)
    vocab = batch.key_vocab
    vocab_buf = b""
    vocab_desc = b""
    gen_b = b""
    pending_tx = None
    if vocab is not None and session is not None and peer is not None:
        # Vocab cache: key the stream by the same identity the frame
        # header carries, so the receiver's lookup needs nothing
        # beyond what it just decoded.  The defining entry commits
        # only once the frame really encodes columnar — a fallback to
        # pickle must not strand a generation the receiver never saw.
        try:
            vlen = len(vocab)
        except TypeError:
            vlen = -1
        skey = (peer, kind) + tuple(meta)
        ent = session.tx.get(skey)
        if ent is not None and ent[0] is vocab and ent[1] == vlen:
            # Unchanged vocab (same object, same length — the
            # append-only contract makes content at an index
            # immutable): ship only the generation tag.
            flags |= _FLAG_VOCAB | _FLAG_VOCAB_REF
            gen_b = _U32.pack(ent[2])
            vocab = None
        else:
            gen = session.next_gen() & 0xFFFFFFFF
            pending_tx = (skey, (vocab, vlen, gen))
            flags |= _FLAG_VOCAB_GEN
            gen_b = _U32.pack(gen)
    if vocab is not None:
        flags |= _FLAG_VOCAB
        if (
            isinstance(vocab, np.ndarray)
            and vocab.ndim == 1
            and vocab.dtype.kind in _RAW_KINDS
            and vocab.dtype.itemsize > 0
        ):
            dt_b = _pack_str(vocab.dtype.str)
            if dt_b is None:
                return None
            vocab_buf = np.ascontiguousarray(vocab).tobytes()
            vocab_desc = dt_b + _U64.pack(len(vocab)) + _U64.pack(
                len(vocab_buf)
            )
        else:
            flags |= _FLAG_VOCAB_PICKLED
            vocab_buf = pickle.dumps(
                vocab, protocol=pickle.HIGHEST_PROTOCOL
            )
            vocab_desc = _U64.pack(len(vocab_buf))
    cols = batch.cols
    if len(cols) > 0xFFFF:
        return None
    bufs: List[bytes] = []
    col_desc: List[bytes] = []
    for name, col in cols.items():
        name_b = _pack_str(name)
        if name_b is None:
            return None
        arr = np.asarray(col)
        if (
            arr.ndim == 1
            and len(arr) == nrows
            and arr.dtype.kind in _RAW_KINDS
            and arr.dtype.itemsize > 0
        ):
            dt_b = _pack_str(arr.dtype.str)
            if dt_b is None:
                return None
            buf = np.ascontiguousarray(arr).tobytes()
            col_desc.append(
                name_b + _U8.pack(_COL_RAW) + dt_b + _U64.pack(len(buf))
            )
        else:
            # Object-dtype (or otherwise unframeable) column: pickle
            # just this column inside the columnar frame.
            buf = pickle.dumps(arr, protocol=pickle.HIGHEST_PROTOCOL)
            col_desc.append(
                name_b + _U8.pack(_COL_PICKLE) + _U64.pack(len(buf))
            )
        bufs.append(buf)
    head.append(_I64.pack(w))
    head.append(_U64.pack(nrows))
    head.append(_U8.pack(flags))
    head.append(scale_b)
    head.append(gen_b)
    head.append(_U16.pack(len(cols)))
    head.extend(col_desc)
    head.append(vocab_desc)
    out = b"".join(head)
    parts = [out]
    off = len(out)
    for buf in bufs + ([vocab_buf] if vocab_buf else []):
        pad = -off % _ALIGN
        if pad:
            parts.append(b"\x00" * pad)
            off += pad
        parts.append(buf)
        off += len(buf)
    if pending_tx is not None:
        session.tx[pending_tx[0]] = pending_tx[1]
    return b"".join(parts)


def _refuse_device_tensors(msg: Any) -> None:
    """Raise if a routed batch holds a tensor on a device: frames
    between processes carry host columns only, and pickling a CUDA
    tensor would copy it through the host in secret (or fail on a
    receiver with another device).  The sender decides where its
    columns live; nothing here copies them."""
    if type(msg) is not tuple or not msg or msg[0] not in ("deliver", "route"):
        return
    entry = msg[-1]
    if type(entry) is not tuple or len(entry) != 2:
        return
    batch = entry[1]
    if not isinstance(batch, ArrayBatch):
        return
    named = list(batch.cols.items()) + [("key_vocab", batch.key_vocab)]
    for name, col in named:
        dev = getattr(col, "device", None)
        if (
            dev is not None
            and type(col).__module__.split(".")[0] == "torch"
            and getattr(dev, "type", "cpu") != "cpu"
        ):
            err = (
                f"a routed batch's {name!r} is a tensor on {dev}: "
                "frames between cluster processes carry numpy columns "
                "only; move it to the host before it leaves its "
                "process"
            )
            raise TypeError(err)


def encode(
    msg: Any,
    session: Optional[WireSession] = None,
    peer: Optional[int] = None,
) -> bytes:
    """Encode one mesh payload for the wire: columnar framing for
    codable ``deliver``/``route`` batch payloads, whole-frame pickle
    for everything else (and for everything under
    ``BYTEWAX_TPU_WIRE=pickle``).  ``session``/``peer`` (set by the
    comm layer) arm the per-(peer, stream) vocab cache."""
    t0 = time.perf_counter()
    _refuse_device_tensors(msg)
    data = None
    if wire_mode() == "columnar":
        data = _encode_columnar(msg, session, peer)
    if data is None:
        data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        codec = "pickle"
    else:
        codec = "columnar"
    _flight.note_wire("encode", codec, len(data), time.perf_counter() - t0)
    return data


# -- decode -----------------------------------------------------------------


class _Reader:
    """Sequential header reader with truncation checks (a torn or
    corrupted frame raises :class:`WireFormatError`, never slices
    garbage)."""

    __slots__ = ("data", "off")

    def __init__(self, data: bytes, off: int):
        self.data = data
        self.off = off

    def take(self, st: struct.Struct) -> Any:
        end = self.off + st.size
        if end > len(self.data):
            raise WireFormatError("truncated columnar frame header")
        (val,) = st.unpack_from(self.data, self.off)
        self.off = end
        return val

    def take_str(self) -> str:
        n = self.take(_U16)
        end = self.off + n
        if end > len(self.data):
            raise WireFormatError("truncated columnar frame header")
        s = self.data[self.off : end].decode("utf-8")
        self.off = end
        return s

    def take_buf(self, n: int) -> Tuple[int, int]:
        """Reserve an ``n``-byte aligned payload region; returns its
        (start, end) offsets."""
        self.off += -self.off % _ALIGN
        end = self.off + n
        if end > len(self.data):
            raise WireFormatError("truncated columnar frame payload")
        start = self.off
        self.off = end
        return start, end


def _decode_columnar(
    data: bytes,
    session: Optional[WireSession] = None,
    peer: Optional[int] = None,
) -> Any:
    version = data[4]
    if version != _VERSION:
        msg = (
            f"columnar wire frame version {version} is not supported "
            f"by this process (speaks version {_VERSION}); mixed-"
            "version clusters must run the pickle wire "
            "(BYTEWAX_TPU_WIRE=pickle) during the rollout"
        )
        raise WireFormatError(msg)
    rd = _Reader(data, 5)
    kind = rd.take(_U8)
    if kind == _KIND_DELIVER:
        op_idx = rd.take(_U32)
        port = rd.take_str()
        skey_meta: Tuple = (op_idx, port)
    elif kind == _KIND_ROUTE:
        stream_id = rd.take_str()
        skey_meta = (stream_id,)
    else:
        raise WireFormatError(f"unknown columnar frame kind {kind}")
    w = rd.take(_I64)
    nrows = rd.take(_U64)
    flags = rd.take(_U8)
    scale = rd.take(_F64) if flags & _FLAG_SCALE else None
    vocab_gen = (
        rd.take(_U32)
        if flags & (_FLAG_VOCAB_GEN | _FLAG_VOCAB_REF)
        else None
    )
    ncols = rd.take(_U16)
    specs: List[Tuple[str, int, Optional[str], int]] = []
    for _ in range(ncols):
        name = rd.take_str()
        colkind = rd.take(_U8)
        if colkind == _COL_RAW:
            dt = rd.take_str()
            nbytes = rd.take(_U64)
            specs.append((name, colkind, dt, nbytes))
        elif colkind == _COL_PICKLE:
            nbytes = rd.take(_U64)
            specs.append((name, colkind, None, nbytes))
        else:
            raise WireFormatError(
                f"unknown column encoding {colkind} in columnar frame"
            )
    vocab_spec: Optional[Tuple[Optional[str], int, int]] = None
    if flags & _FLAG_VOCAB and not flags & _FLAG_VOCAB_REF:
        if flags & _FLAG_VOCAB_PICKLED:
            vocab_spec = (None, 0, rd.take(_U64))
        else:
            dt = rd.take_str()
            nvocab = rd.take(_U64)
            vocab_spec = (dt, nvocab, rd.take(_U64))
    cols: Dict[str, Any] = {}
    for name, colkind, dt, nbytes in specs:
        start, end = rd.take_buf(nbytes)
        if colkind == _COL_RAW:
            dtype = np.dtype(dt)
            if nbytes != nrows * dtype.itemsize:
                raise WireFormatError(
                    f"column {name!r} carries {nbytes} bytes for "
                    f"{nrows} rows of {dt}"
                )
            # Zero-copy: a read-only view over the received frame.
            cols[name] = np.frombuffer(
                data, dtype=dtype, count=nrows, offset=start
            )
        else:
            cols[name] = pickle.loads(data[start:end])
    vocab = None
    if flags & _FLAG_VOCAB_REF:
        if session is None or peer is None:
            raise WireFormatError(
                "columnar frame references a cached vocab but no "
                "wire session is armed on this receiver"
            )
        ent = session.rx.get((peer, kind) + skey_meta)
        if ent is None or ent[0] != vocab_gen:
            msg = (
                f"columnar frame references vocab generation "
                f"{vocab_gen} from peer {peer} but this process "
                f"holds {ent[0] if ent else 'none'}; the defining "
                "frame was lost"
            )
            raise WireFormatError(msg)
        vocab = ent[1]
    elif vocab_spec is not None:
        dt, nvocab, nbytes = vocab_spec
        start, end = rd.take_buf(nbytes)
        if dt is None:
            vocab = pickle.loads(data[start:end])
        else:
            vocab = np.frombuffer(
                data, dtype=np.dtype(dt), count=nvocab, offset=start
            )
        if vocab_gen is not None and session is not None and peer is not None:
            # Cache a COMPACT copy, never the frombuffer view: the
            # view would pin the entire defining frame's bytes (which
            # may carry megabytes of column data) for as long as the
            # generation lives.  The defining batch gets the same
            # copy, so ref-resolved batches share its identity.
            if isinstance(vocab, np.ndarray):
                vocab = vocab.copy()
            session.rx[(peer, kind) + skey_meta] = (vocab_gen, vocab)
    batch = ArrayBatch(cols, key_vocab=vocab, value_scale=scale)
    if kind == _KIND_DELIVER:
        return ("deliver", op_idx, port, (w, batch))
    return ("route", stream_id, (w, batch))


def decode(
    data: bytes,
    session: Optional[WireSession] = None,
    peer: Optional[int] = None,
) -> Any:
    """Decode one received mesh frame: columnar frames rebuild their
    :class:`ArrayBatch` zero-copy, anything else is a pickle.
    ``session``/``peer`` (set by the comm layer) resolve and refresh
    the per-(peer, stream) vocab cache."""
    t0 = time.perf_counter()
    if data[:4] == _MAGIC:
        msg = _decode_columnar(data, session, peer)
        codec = "columnar"
    else:
        msg = pickle.loads(data)
        codec = "pickle"
    _flight.note_wire("decode", codec, len(data), time.perf_counter() - t0)
    return msg


# -- quantized gsync aggregate frames ---------------------------------------

#: Aggregate-frame magic (distinct from the columnar data magic so a
#: mis-routed buffer fails typed instead of mis-parsing).
_AGG_MAGIC = b"\xb5BXQ"
_AGG_VERSION = 1

#: Per-column encodings inside an aggregate frame.
_AGG_RAW = 0  # exact bytes (integer/count/bool/fixed-width columns)
_AGG_BF16 = 1  # float32 rounded-to-nearest to its upper 16 bits
_AGG_INT8 = 2  # block-scaled int8 (EQuARX-style)
_AGG_UTF8 = 3  # unicode (U-dtype) cells packed as UTF-8 bytes (exact)

#: Values per int8 quantization block: each block carries one f32
#: scale (max|block| / 127), so overhead is 4 bytes per 1024 values
#: and a single outlier cannot flatten the whole column's resolution.
_QBLOCK = 1024
#: Public alias: the device-side merge kernels (engine/xla.py)
#: dequantize with the same block size.
QBLOCK = _QBLOCK

#: Rows per aggregate frame: oversized partial-column sets chunk into
#: bounded frames so encode scratch (and any future streaming decode)
#: stays bounded regardless of key cardinality.
_AGG_CHUNK_ROWS = 1 << 16


def _quantize_int8(col: np.ndarray) -> Tuple[bytes, bytes]:
    """Block-scaled int8: returns (scales f32 buffer, int8 buffer).
    Error bound per value: ``max|block| / 254`` (half a quantization
    step of ``scale = max|block| / 127``)."""
    vals = np.ascontiguousarray(col, dtype=np.float32)
    n = len(vals)
    nblocks = -(-n // _QBLOCK) if n else 0
    padded = np.zeros(nblocks * _QBLOCK, dtype=np.float32)
    padded[:n] = vals
    blocks = padded.reshape(nblocks, _QBLOCK)
    scales = (
        np.abs(blocks).max(axis=1) / 127.0
        if nblocks
        else np.empty(0, dtype=np.float32)
    ).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)
    q = np.clip(
        np.rint(blocks / safe[:, None]), -127, 127
    ).astype(np.int8)
    return scales.tobytes(), q.reshape(-1)[:n].tobytes()


def _dequantize_int8(
    scales: np.ndarray, q: np.ndarray
) -> np.ndarray:
    out = q.astype(np.float64)
    if len(scales):
        out *= np.repeat(scales.astype(np.float64), _QBLOCK)[: len(q)]
    return out


def encode_agg(
    cols: Dict[str, np.ndarray], quant: Optional[str] = None
) -> List[bytes]:
    """Frame one set of per-key partial-aggregate columns for the
    gsync exchange, chunked into bounded frames.

    Float columns quantize per ``quant`` (default: the armed
    :func:`gsync_quant`): ``int8`` block-scales them (≈8x smaller
    than f64), ``bf16`` truncates to bfloat16 (≈4x), ``off`` ships
    exact bytes.  Integer (``count``), bool, datetime, and
    fixed-width string columns ALWAYS ship exact — quantizing a count
    would corrupt means and exactly-once accounting.  The frames ride
    inside the existing ``gsync`` control payload: no new comm frame
    kinds, nothing uncounted on the mesh.
    """
    if quant is None:
        quant = gsync_quant()
    if quant not in ("off", "bf16", "int8"):
        raise ValueError(f"unknown gsync quant mode {quant!r}")
    names = list(cols)
    if not names:
        return [_encode_agg_chunk({}, quant)]
    nrows = len(np.asarray(cols[names[0]]))
    out = []
    for lo in range(0, max(nrows, 1), _AGG_CHUNK_ROWS):
        chunk = {
            name: np.asarray(col)[lo : lo + _AGG_CHUNK_ROWS]
            for name, col in cols.items()
        }
        out.append(_encode_agg_chunk(chunk, quant))
    return out


def _encode_agg_chunk(cols: Dict[str, np.ndarray], quant: str) -> bytes:
    head: List[bytes] = [
        _AGG_MAGIC,
        _U8.pack(_AGG_VERSION),
        _U16.pack(len(cols)),
    ]
    bufs: List[bytes] = []
    for name, col in cols.items():
        arr = np.asarray(col)
        name_b = _pack_str(name)
        if name_b is None:
            raise ValueError(f"aggregate column name {name!r} too long")
        nrows = len(arr)
        quantize = (
            quant != "off"
            and arr.dtype.kind == "f"
            # The count role is exact by contract whatever its dtype.
            and name != "count"
        )
        if quantize and quant == "int8":
            scales_b, q_b = _quantize_int8(arr)
            head.append(
                name_b
                + _U8.pack(_AGG_INT8)
                + _U64.pack(nrows)
                + _U64.pack(len(scales_b))
            )
            bufs.append(scales_b)
            bufs.append(q_b)
        elif quantize:  # bf16
            as32 = np.ascontiguousarray(arr, dtype=np.float32)
            u = as32.view(np.uint32)
            # Round-to-nearest-even (not truncation): halves the
            # worst-case relative error to 2**-8.
            hi = (
                (
                    u.astype(np.uint64)
                    + 0x7FFF
                    + ((u >> 16) & 1)
                )
                >> 16
            ).astype(np.uint16)
            head.append(
                name_b + _U8.pack(_AGG_BF16) + _U64.pack(nrows)
            )
            bufs.append(hi.tobytes())
        elif arr.dtype.kind == "U":
            # Unicode key columns pack as UTF-8 (exact, ~4x smaller
            # than the U dtype's fixed 4-byte code points).
            packed = np.char.encode(arr, "utf-8")
            dt_b = _pack_str(packed.dtype.str)
            if dt_b is None:
                raise ValueError(
                    f"aggregate column {name!r} dtype string too long"
                )
            buf = np.ascontiguousarray(packed).tobytes()
            head.append(
                name_b
                + _U8.pack(_AGG_UTF8)
                + dt_b
                + _U64.pack(nrows)
                + _U64.pack(len(buf))
            )
            bufs.append(buf)
        else:
            if arr.dtype.kind not in _RAW_KINDS or arr.dtype.itemsize == 0:
                raise ValueError(
                    f"aggregate column {name!r} has un-frameable "
                    f"dtype {arr.dtype}"
                )
            if arr.dtype.kind in "iu" and arr.dtype.itemsize > 1 and nrows:
                # Exact integer narrowing: counts and all-integer
                # partials ship in the smallest signed width that
                # holds their range (lossless — round-trips compare
                # equal by value; the merge upcasts to f64 anyway).
                lo, hi = int(arr.min()), int(arr.max())
                for cand in (np.int8, np.int16, np.int32):
                    info = np.iinfo(cand)
                    if info.min <= lo and hi <= info.max:
                        arr = arr.astype(cand)
                        break
            dt_b = _pack_str(arr.dtype.str)
            if dt_b is None:
                raise ValueError(
                    f"aggregate column {name!r} dtype string too long"
                )
            buf = np.ascontiguousarray(arr).tobytes()
            head.append(
                name_b
                + _U8.pack(_AGG_RAW)
                + dt_b
                + _U64.pack(nrows)
                + _U64.pack(len(buf))
            )
            bufs.append(buf)
    parts = [b"".join(head)]
    off = len(parts[0])
    for buf in bufs:
        pad = -off % _ALIGN
        if pad:
            parts.append(b"\x00" * pad)
            off += pad
        parts.append(buf)
        off += len(buf)
    return b"".join(parts)


def decode_agg_parts(
    data: bytes,
) -> Dict[str, Tuple[str, Any]]:
    """Decode one aggregate frame into raw per-column parts,
    deferring float dequantization to the caller — the device-side
    merge kernels in ``engine/xla.py`` dequantize in HBM, so the
    quantized payload crosses the host/device boundary at wire width
    instead of f64.  Exact columns (``raw``/``utf8``) decode fully
    (they are key metadata or exact integers the device path uploads
    as-is).  Returns ``{name: (enc, parts)}`` where ``enc`` is one of
    ``"raw"``/``"utf8"``/``"bf16"``/``"int8"`` and ``parts`` is the
    decoded array (raw/utf8), the uint16 mantissa array (bf16), or a
    ``(scales_f32, q_int8)`` pair (int8) — all zero-copy read-only
    views over the frame buffer.  Unknown magic/version/encoding
    raises a typed :class:`WireFormatError` — a mixed cluster fails
    loudly."""
    if data[:4] != _AGG_MAGIC:
        raise WireFormatError("not a gsync aggregate frame")
    version = data[4]
    if version != _AGG_VERSION:
        msg = (
            f"gsync aggregate frame version {version} is not "
            f"supported by this process (speaks {_AGG_VERSION}); "
            "mixed-version clusters must run "
            "BYTEWAX_TPU_GSYNC_QUANT=off during the rollout"
        )
        raise WireFormatError(msg)
    rd = _Reader(data, 5)
    ncols = rd.take(_U16)
    specs: List[Tuple[str, int, Optional[str], int, int]] = []
    for _ in range(ncols):
        name = rd.take_str()
        enc = rd.take(_U8)
        if enc in (_AGG_RAW, _AGG_UTF8):
            dt = rd.take_str()
            nrows = rd.take(_U64)
            specs.append((name, enc, dt, nrows, rd.take(_U64)))
        elif enc == _AGG_BF16:
            specs.append((name, enc, None, rd.take(_U64), 0))
        elif enc == _AGG_INT8:
            nrows = rd.take(_U64)
            specs.append((name, enc, None, nrows, rd.take(_U64)))
        else:
            raise WireFormatError(
                f"unknown aggregate column encoding {enc}"
            )
    cols: Dict[str, Tuple[str, Any]] = {}
    for name, enc, dt, nrows, extra in specs:
        if enc in (_AGG_RAW, _AGG_UTF8):
            dtype = np.dtype(dt)
            start, _end = rd.take_buf(nrows * dtype.itemsize)
            col = np.frombuffer(
                data, dtype=dtype, count=nrows, offset=start
            )
            if enc == _AGG_UTF8:
                cols[name] = ("utf8", np.char.decode(col, "utf-8"))
            else:
                cols[name] = ("raw", col)
        elif enc == _AGG_BF16:
            start, _end = rd.take_buf(nrows * 2)
            hi = np.frombuffer(
                data, dtype=np.uint16, count=nrows, offset=start
            )
            cols[name] = ("bf16", hi)
        else:  # _AGG_INT8
            start, _end = rd.take_buf(extra)
            scales = np.frombuffer(
                data, dtype=np.float32, count=extra // 4, offset=start
            )
            qstart, _qend = rd.take_buf(nrows)
            q = np.frombuffer(
                data, dtype=np.int8, count=nrows, offset=qstart
            )
            cols[name] = ("int8", (scales, q))
    return cols


def dequantize_bf16(hi: np.ndarray) -> np.ndarray:
    """Host-side bf16 expansion (the oracle for the device kernel)."""
    as32 = (hi.astype(np.uint32) << 16).view(np.float32)
    return as32.astype(np.float64)


def dequant_part(enc: str, parts: Any) -> np.ndarray:
    """Host-side dequantization of one :func:`decode_agg_parts`
    column (the fold path of the host-merge fallback and the oracle
    for the device kernels): exact parts pass through, ``bf16``/
    ``int8`` expand exactly as :func:`decode_agg` would."""
    if enc in ("raw", "utf8"):
        return np.asarray(parts)
    if enc == "bf16":
        return dequantize_bf16(parts)
    scales, q = parts
    return _dequantize_int8(scales, q)


def decode_agg(data: bytes) -> Dict[str, np.ndarray]:
    """Decode one aggregate frame back into per-key partial columns
    (quantized float columns dequantize to float64; exact columns
    rebuild zero-copy).  The host-side companion of
    :func:`decode_agg_parts` — one parse path, host dequant."""
    cols: Dict[str, np.ndarray] = {}
    for name, (enc, parts) in decode_agg_parts(data).items():
        if enc in ("raw", "utf8"):
            cols[name] = parts
        elif enc == "bf16":
            cols[name] = dequantize_bf16(parts)
        else:  # int8
            scales, q = parts
            cols[name] = _dequantize_int8(scales, q)
    return cols


# -- per-peer route accumulation --------------------------------------------


class RouteAccumulator:
    """Per-peer coalescing of shipped slices: ``ship_route`` slices
    bucket by (peer process, stream, lane) and ``ship_deliver`` keyed
    split slices by (peer process, op, port, lane).

    ``add``/``add_deliver`` append a slice to the bucket's current
    *run* when the ingest coalescer's ``can_merge`` rules allow it
    (same columns, same scale, same vocab identity — exactly the
    merges no consumer can observe); an incompatible slice starts a
    new run.  Each run becomes ONE wire frame at flush, in global
    first-seen bucket order across both kinds.

    Flush protocol (``_Driver.ship_flush``): ``peek`` exposes the
    oldest run merged into its frame payload as ``(bucket key,
    items)`` — the key is kind-tagged, ``("route", dest, stream_id,
    w)`` or ``("deliver", dest, op_idx, port, w)`` — the caller sends
    it and counts it, and only then ``pop``s; a fault fired inside
    ``comm.send`` (the pinned chaos site) unwinds with the run still
    in the pending set, never silently dropping accumulated rows.
    Rows only ever wait within one poll iteration: the driver flushes
    at every poll boundary and before every drain point.
    """

    __slots__ = ("_runs", "_order", "_head")

    def __init__(self):
        self._runs: Dict[Tuple, List[List[Any]]] = {}
        self._order: Deque[Tuple] = deque()
        self._head: Optional[Tuple[Tuple, Any]] = None

    def _add(self, key: Tuple, items: Any) -> None:
        runs = self._runs.get(key)
        if runs is None:
            runs = []
            self._runs[key] = runs
            self._order.append(key)
        if runs and can_merge(runs[-1][-1], items):
            runs[-1].append(items)
        else:
            runs.append([items])
        # A peeked-but-unsent head may alias the run just extended.
        self._head = None

    def add(self, dest: int, stream_id: str, w: int, items: Any) -> None:
        """Accumulate one routed slice."""
        self._add(("route", dest, stream_id, w), items)

    def add_deliver(
        self, dest: int, op_idx: int, port: str, w: int, items: Any
    ) -> None:
        """Accumulate one keyed-split delivery slice."""
        self._add(("deliver", dest, op_idx, port, w), items)

    def pending(self) -> bool:
        return bool(self._order)

    def pending_frames(self) -> int:
        """How many wire frames a full flush would ship right now
        (every run of every bucket) — the /status observability
        figure, read racily off the API thread (the ``list()`` copy
        is GIL-atomic, so a concurrent add/pop can't break the
        iteration)."""
        return sum(len(runs) for runs in list(self._runs.values()))

    def pending_status(self) -> Dict[str, Dict[str, int]]:
        """Per-kind pending breakdown for ``/status``: bucket and
        frame counts split by the accumulator's two bucket kinds —
        the ``route`` (peer, stream, lane) buckets AND the
        generalized ``deliver`` (peer, op, port, lane) buckets.  Read
        racily off the API thread like :meth:`pending_frames` (the
        ``list()`` copy is GIL-atomic)."""
        out = {
            "route": {"buckets": 0, "frames": 0},
            "deliver": {"buckets": 0, "frames": 0},
        }
        for key, runs in list(self._runs.items()):
            cell = out.get(key[0])
            if cell is None:  # pragma: no cover - future kinds
                cell = out[key[0]] = {"buckets": 0, "frames": 0}
            cell["buckets"] += 1
            cell["frames"] += len(runs)
        return out

    def peek(self) -> Optional[Tuple[Tuple, Any]]:
        """The oldest pending frame as ``(bucket key, items)`` with
        its run merged, or None; stays pending until :meth:`pop`."""
        if self._head is not None:
            return self._head
        if not self._order:
            return None
        key = self._order[0]
        self._head = (key, merge_batches(self._runs[key][0]))
        return self._head

    def pop(self) -> None:
        """Drop the run :meth:`peek` exposed (it is on the wire)."""
        self._head = None
        key = self._order[0]
        runs = self._runs[key]
        runs.pop(0)
        if not runs:
            self._order.popleft()
            del self._runs[key]
