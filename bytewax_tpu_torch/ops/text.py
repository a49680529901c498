"""Host data-plane text ops feeding the device tier.

The reference tokenizes per line in Python UDFs
(upstream bytewax ``examples/wordcount.py``); here tokenization is one
native pass producing dictionary-encoded columnar batches, so the
downstream keyed count rides the device scatter path without ever
materializing per-word Python strings.
"""

import os
import re
from typing import Any, List, Optional, Tuple

import numpy as np

from bytewax_tpu_torch.engine.arrays import ArrayBatch

__all__ = [
    "LineBatcher",
    "TOKEN_RE",
    "WordTokenizer",
    "maybe_numeric",
    "native_tokenizer_available",
    "split_fields",
    "split_lines",
]

#: The canonical word-separator set (reference:
#: ``examples/wordcount.py``).  The native tokenizer's stop table in
#: ``native/io_native.cpp`` mirrors its ASCII subset — keep both in
#: sync (tests/test_text.py covers the edges).
TOKEN_RE = re.compile(r"[^\s!,.?\":;0-9]+")
_TOKEN_RE = TOKEN_RE


def native_tokenizer_available() -> bool:
    """Whether the native tokenizer library can be built/loaded."""
    from bytewax_tpu_torch.native import is_available

    return is_available()


# -- vectorized line/field decode (the columnar ingest fast path) -----------
#
# Line-oriented connectors (files, stdio) read raw CHUNKS and split
# them here in O(chunk) vectorized passes — no per-row Python strings
# until (unless) a host-tier step itemizes.  The heavy op is one
# fancy-index gather of the padded line matrix; with
# BYTEWAX_TPU_TEXT_DEVICE=1 that gather runs in torch on the device
# :func:`bytewax_tpu_torch.utils.device` selects (the "device-side
# decode" path — worthwhile where the columns are device-bound
# anyway; the numpy path is fastest on the CPU).


def _gather_pad(
    buf: np.ndarray, starts: np.ndarray, lens: np.ndarray, width: int
) -> np.ndarray:
    """[n_lines, width] padded code-unit matrix from a flat buffer:
    row i is ``buf[starts[i] : starts[i] + lens[i]]`` zero-padded to
    ``width``.  One gather + one mask, no per-line Python.

    With ``BYTEWAX_TPU_TEXT_DEVICE=1`` the index matrix, the mask and
    the gather are built on the device from ``buf``, ``starts`` and
    ``lens`` alone (one ``torch.where`` over an index gather), and the
    matrix copies back.  There is no numpy fallback: without the
    device, :func:`bytewax_tpu_torch.utils.device` raises."""
    if os.environ.get("BYTEWAX_TPU_TEXT_DEVICE") == "1":
        return _gather_pad_device(buf, starts, lens, width)
    offs = np.arange(width, dtype=starts.dtype)
    idx = starts[:, None] + offs[None, :]
    np.clip(idx, 0, len(buf) - 1, out=idx)
    mask = offs[None, :] < lens[:, None]
    return np.where(mask, buf[idx], 0)


def _gather_pad_device(
    buf: np.ndarray, starts: np.ndarray, lens: np.ndarray, width: int
) -> np.ndarray:
    """:func:`_gather_pad` on the device.  uint32 code units travel as
    int32 (every code point is below 2^31): torch indexes int32 and
    uint8 tensors on every device."""
    import torch

    from bytewax_tpu_torch.utils import device

    dev = device()
    carrier = buf.view(np.int32) if buf.dtype == np.uint32 else buf
    t_buf = torch.tensor(carrier, device=dev)
    t_starts = torch.tensor(starts, dtype=torch.int64, device=dev)
    t_lens = torch.tensor(lens, dtype=torch.int64, device=dev)
    offs = torch.arange(width, dtype=torch.int64, device=dev)
    idx = (t_starts[:, None] + offs[None, :]).clamp_(0, len(buf) - 1)
    mask = offs[None, :] < t_lens[:, None]
    zero = torch.zeros((), dtype=t_buf.dtype, device=dev)
    mat = torch.where(mask, t_buf[idx], zero)
    return mat.cpu().numpy().view(buf.dtype)


def _split_units(buf: np.ndarray, kind: str) -> np.ndarray:
    """Split a newline-terminated flat code-unit buffer (uint8 for
    bytes/``S``, uint32 for text/``U``) into a fixed-width line array.
    CR before LF is stripped (CRLF files decode like LF files)."""
    ends = np.flatnonzero(buf == 0x0A)
    starts = np.empty_like(ends)
    if len(ends):
        starts[0] = 0
        starts[1:] = ends[:-1] + 1
    lens = ends - starts
    if len(ends):
        crlf = (lens > 0) & (buf[np.maximum(ends - 1, 0)] == 0x0D)
        lens = lens - crlf
    width = max(int(lens.max()) if len(lens) else 0, 1)
    n = len(ends)
    if n * width > 8 * len(buf) and n * width * buf.itemsize > (1 << 22):
        # Fixed-width line arrays pad EVERY row to the longest line's
        # width: one pathological 200KB line sharing a chunk with 16k
        # short lines would turn a 1MB read into a multi-GB array.
        # Such ragged chunks take a per-line object-dtype split
        # instead (O(chunk) memory; vectorization resumes on the next
        # chunk, and consumers fall back on the dtype).
        if kind == "S":
            data = buf.tobytes()
        else:
            data = buf.astype("<u4").tobytes().decode("utf-32-le")
        return np.array(
            [
                data[s : s + ln]
                for s, ln in zip(starts.tolist(), lens.tolist())
            ],
            dtype=object,
        )
    mat = _gather_pad(buf, starts, lens, width)
    if kind == "S":
        return (
            np.ascontiguousarray(mat.astype(np.uint8))
            .view(f"S{width}")
            .ravel()
        )
    return (
        np.ascontiguousarray(mat.astype(np.uint32))
        .view(f"U{width}")
        .ravel()
    )


def split_lines(
    body: bytes, encoding: Optional[str] = "utf-8"
) -> np.ndarray:
    """Split a newline-terminated byte chunk into a line array in
    O(chunk) vectorized passes (``U``-dtype text lines, or ``S``-dtype
    raw byte lines with ``encoding=None``).  ``body`` must end with
    ``\\n`` — callers carry the trailing partial line themselves (see
    :class:`LineBatcher`).

    >>> from bytewax_tpu_torch.ops.text import split_lines
    >>> split_lines(b"one\\ntwo\\n").tolist()
    ['one', 'two']
    """
    if not body:
        return np.empty(0, dtype="U1")
    if encoding is None:
        return _split_units(np.frombuffer(body, np.uint8), "S")
    text = body.decode(encoding)
    buf = np.frombuffer(text.encode("utf-32-le"), np.uint32)
    return _split_units(buf, "U")


class LineBatcher:
    """Chunk→line-batch decoder with exact resume offsets.

    Feed raw byte chunks in read order; each feed returns the
    ``ColumnarBatch({"line": ...})`` of every line completed by that
    chunk (or ``None``) and internally carries the trailing partial
    line — :attr:`pending` is its byte length, so a partition's
    resume offset is ``bytes_read - batcher.pending`` at any point
    (always a line boundary; the recovery snapshot format stays a
    plain int byte offset).  :meth:`flush` emits the final
    unterminated line at EOF.

    ``on_error="dlq"`` is the dead-letter decode policy
    (docs/recovery.md "Connector-edge resilience"): a chunk whose
    vectorized decode fails re-splits at the byte level and decodes
    per line, collecting undecodable lines into :attr:`dead` (drained
    by the engine into the dead-letter queue) while every clean line
    still flows — one poison byte no longer kills the run.  The
    default ``"raise"`` keeps the strict behavior.
    """

    __slots__ = ("_carry", "_encoding", "_on_error", "dead")

    def __init__(
        self,
        encoding: Optional[str] = "utf-8",
        on_error: str = "raise",
    ):
        if on_error not in ("raise", "dlq"):
            msg = f"on_error must be 'raise' or 'dlq'; got {on_error!r}"
            raise ValueError(msg)
        self._carry = b""
        self._encoding = encoding
        self._on_error = on_error
        #: Dead-lettered lines ({"error", "payload"}) under
        #: ``on_error="dlq"``; the owning partition drains these.
        self.dead: List[dict] = []

    @property
    def pending(self) -> int:
        """Bytes held back as a trailing partial line."""
        return len(self._carry)

    def _split(self, body: bytes) -> np.ndarray:
        if self._on_error != "dlq" or self._encoding is None:
            return split_lines(body, self._encoding)
        nul = b"\x00" in body
        if not nul:
            try:
                return split_lines(body, self._encoding)
            except UnicodeDecodeError:
                pass
        # Poison bytes somewhere in the chunk: split at the byte level
        # and decode per line, so only the offending line(s)
        # dead-letter.  A chunk holding a NUL splits this way too, into
        # an object-dtype array of each line's exact text: a
        # fixed-width array would drop a NUL that ends a line, and the
        # consumer could no longer see (or dead-letter) it.
        good: List[str] = []
        for ln in body.split(b"\n")[:-1]:
            if ln.endswith(b"\r"):
                ln = ln[:-1]
            try:
                good.append(ln.decode(self._encoding))
            except UnicodeDecodeError as ex:
                self.dead.append(
                    {
                        "error": f"{type(ex).__name__}: {ex}",
                        "payload": repr(ln),
                    }
                )
        if not good:
            return np.empty(0, dtype="U1")
        return np.array(good, dtype=object) if nul else np.array(good)

    def feed(self, raw: bytes) -> Optional[ArrayBatch]:
        data = self._carry + raw
        cut = data.rfind(b"\n") + 1
        if cut == 0:
            self._carry = data
            return None
        self._carry = data[cut:]
        lines = self._split(data[:cut])
        return ArrayBatch({"line": lines})

    def flush(self) -> Optional[ArrayBatch]:
        """EOF: the carried bytes are the (unterminated) last line."""
        if not self._carry:
            return None
        body, self._carry = self._carry + b"\n", b""
        return ArrayBatch({"line": self._split(body)})


def split_fields(
    lines: np.ndarray, n_fields: int, delimiter: str = ","
) -> Optional[List[np.ndarray]]:
    """Split a ``U``-dtype line array into exactly ``n_fields`` field
    columns with O(fields) vectorized passes (``np.char.partition``
    per field).  Returns ``None`` when any row has the wrong
    delimiter count — the caller falls back to a real CSV parser for
    that batch (quoting, ragged rows).

    >>> import numpy as np
    >>> from bytewax_tpu_torch.ops.text import split_fields
    >>> [c.tolist() for c in split_fields(np.array(["a,1", "b,2"]), 2)]
    [['a', 'b'], ['1', '2']]
    """
    if lines.dtype.kind not in "US":
        # Ragged chunks degrade to object-dtype line arrays (see
        # _split_units); np.char needs fixed-width strings, so those
        # batches take the caller's fallback parser.
        return None
    delim: Any = delimiter
    if lines.dtype.kind == "S" and isinstance(delimiter, str):
        # Raw byte lines (split_lines with encoding=None): np.char
        # needs the operand in the array's own flavor.
        delim = delimiter.encode("ascii")
    counts = np.char.count(lines, delim)
    if len(counts) and (
        counts.min() != n_fields - 1 or counts.max() != n_fields - 1
    ):
        return None
    cols: List[np.ndarray] = []
    rest = lines
    for _ in range(n_fields - 1):
        parts = np.char.partition(rest, delim)
        cols.append(np.ascontiguousarray(parts[:, 0]))
        rest = np.ascontiguousarray(parts[:, 2])
    cols.append(rest)
    return cols


def maybe_numeric(col: np.ndarray) -> np.ndarray:
    """Cast a string column to float64 when every cell parses (one
    C-level pass); otherwise (including empty cells) return it
    unchanged.

    Cells that parse but don't round-trip keep the column as strings:
    ``nan``/``inf`` tokens, and leading-zero identifiers (``"00501"``
    zip codes would silently become ``501.0``)."""
    if not len(col) or col.dtype.kind not in "US":
        return col
    try:
        cast = col.astype(np.float64)
    except ValueError:
        return col
    if not np.isfinite(cast).all():
        return col
    raw = col.dtype.kind == "S"
    stripped = np.char.lstrip(col, b"+-" if raw else "+-")
    zero_led = (
        np.char.startswith(stripped, b"0" if raw else "0")
        & (np.char.str_len(stripped) > 1)
        & ~np.char.startswith(stripped, b"0." if raw else "0.")
    )
    if zero_led.any():
        return col
    return cast


class WordTokenizer:
    """A ``flat_map_batch`` mapper: batches of (already-lowercased)
    text lines in, one dictionary-encoded ``ArrayBatch`` of
    ``(key_id, 1)`` word rows out.

    The word vocabulary grows in first-sight order and is append-only
    across batches (id meanings never change), so downstream device
    state keys on id identity.  ASCII lines tokenize in one native
    pass; lines with non-ASCII characters fall back to the Python
    regex per line (the extracted words re-enter the native vocab, so
    both paths share one id space) — their word rows are appended
    after the batch's ASCII rows.
    """

    def __init__(self):
        import ctypes

        from bytewax_tpu_torch.native import lib

        self._ctypes = ctypes
        self._cdll = lib()
        self._tok = self._cdll.wc_new()
        self._vocab_cache: List[str] = []
        self._vocab_np: Optional[np.ndarray] = None

    def __del__(self):
        tok = getattr(self, "_tok", None)
        if tok:
            self._cdll.wc_free(tok)
            self._tok = None

    def _tokenize_bytes(self, data: bytes) -> np.ndarray:
        ctypes = self._ctypes
        cap = len(data) // 2 + 1
        ids = np.empty(cap, dtype=np.int32)
        n = self._cdll.wc_tokenize(
            self._tok,
            data,
            len(data),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cap,
        )
        if n < 0:  # pragma: no cover - cap is a strict upper bound
            msg = "native tokenizer capacity overflow"
            raise RuntimeError(msg)
        return ids[:n]

    def _vocab(self) -> np.ndarray:
        """Current vocabulary as a numpy string array (a new, longer
        array per growth — the engine's append-only contract)."""
        ctypes = self._ctypes
        size = self._cdll.wc_vocab_size(self._tok)
        if self._vocab_np is not None and len(self._vocab_np) == size:
            return self._vocab_np
        while len(self._vocab_cache) < size:
            i = len(self._vocab_cache)
            buf = ctypes.create_string_buffer(1024)
            n = self._cdll.wc_vocab_get(self._tok, i, buf, 1024)
            if n < 0:  # word longer than the probe buffer
                buf = ctypes.create_string_buffer(-n)
                n = self._cdll.wc_vocab_get(self._tok, i, buf, -n)
            self._vocab_cache.append(buf.raw[:n].decode("utf-8"))
        self._vocab_np = np.array(self._vocab_cache)
        return self._vocab_np

    def __call__(self, lines: Any) -> Any:
        if isinstance(lines, ArrayBatch):
            lines = lines.to_pylist()
        slow: List[str] = []
        try:
            # One join + one native pass for the ASCII batch body.
            data = "\n".join(lines).encode("ascii")
        except UnicodeEncodeError:
            fast_lines = []
            for line in lines:
                (fast_lines if line.isascii() else slow).append(line)
            data = "\n".join(fast_lines).encode("ascii")
        ids = self._tokenize_bytes(data)
        if slow:
            # Python-regex words contain no native separator chars,
            # so a space-joined re-pass interns them unsplit into the
            # same id space.
            words = []
            for line in slow:
                words.extend(_TOKEN_RE.findall(line))
            if words:
                slow_ids = self._tokenize_bytes(
                    " ".join(words).encode("utf-8")
                )
                ids = np.concatenate([ids, slow_ids])
        if not len(ids):
            return []
        return ArrayBatch(
            {
                "key_id": ids,
                "value": np.ones(len(ids), dtype=np.int32),
            },
            key_vocab=self._vocab(),
        )
