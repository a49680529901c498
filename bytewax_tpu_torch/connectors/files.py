"""Connectors for local filesystem files.

Reference parity: upstream bytewax ``pysrc/bytewax/connectors/files.py``;
implementation is our own.  Line files resume by byte offset; sinks
truncate on resume for exactly-once output.

Batch-native mode (docs/performance.md "Columnar ingest"): the line
and CSV sources take ``columnar=True`` to read fixed-size byte chunks
and split/parse them in vectorized passes (:mod:`bytewax_tpu_torch.ops.text`)
instead of decoding per row in Python, emitting
:class:`~bytewax_tpu_torch.inputs.ColumnarBatch` record batches.  Resume
snapshots stay plain int byte offsets in both modes (always a line
boundary), so a store written by one mode resumes under the other.

Connector-edge resilience (docs/recovery.md): transient ``OSError``s
from reads/writes are retried by the engine at the poll/write
boundary, and the sources take ``on_error="dlq"`` to dead-letter
poison rows (undecodable lines, parser-rejected CSV rows) with
provenance instead of killing the run.
"""

import csv
import io
import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union
from zlib import adler32

import numpy as np

from bytewax_tpu_torch.inputs import (
    ColumnarBatch,
    FixedPartitionedSource,
    StatefulSourcePartition,
    batch,
)
from bytewax_tpu_torch.outputs import FixedPartitionedSink, StatefulSinkPartition

__all__ = [
    "CSVSource",
    "DirSink",
    "DirSource",
    "FileSink",
    "FileSource",
]


def _get_path_dev(path: Path) -> str:
    return hex(path.stat().st_dev)


class _FileSourcePartition(StatefulSourcePartition[str, int]):
    def __init__(self, path: Path, batch_size: int, resume_state: Optional[int]):
        self._f = open(path, "rt")
        if resume_state is not None:
            self._f.seek(resume_state)
        lines = (line.rstrip("\n") for line in iter(self._f.readline, ""))
        self._batcher = batch(lines, batch_size)

    def next_batch(self) -> List[str]:
        return next(self._batcher)

    def snapshot(self) -> int:
        return self._f.tell()

    def close(self) -> None:
        self._f.close()


class _ChunkedLinePartition(
    StatefulSourcePartition[ColumnarBatch, int]
):
    """Batch-native line reader: raw chunks in, vectorized-split
    ``ColumnarBatch({"line": ...})`` out (see ops/text.py).  The
    snapshot is the byte offset of the first line NOT yet emitted
    (the trailing partial line carried across a chunk boundary is
    re-read on resume), interchangeable with the itemized reader's
    ``tell()`` snapshots.

    ``on_error="dlq"`` dead-letters undecodable lines (the engine
    drains :meth:`drain_dead_letters` into the dead-letter queue)
    instead of killing the run on one poison byte."""

    def __init__(
        self,
        path: Path,
        chunk_bytes: int,
        resume_state: Optional[int],
        encoding: Optional[str] = "utf-8",
        on_error: str = "raise",
    ):
        from bytewax_tpu_torch.ops.text import LineBatcher

        self._f = open(path, "rb")
        self._read = resume_state if resume_state is not None else 0
        if self._read:
            self._f.seek(self._read)
        self._chunk_bytes = chunk_bytes
        self._lines = LineBatcher(encoding, on_error=on_error)
        self._done = False

    def next_batch(self) -> Union[ColumnarBatch, List[str]]:
        if self._done:
            raise StopIteration()
        raw = self._f.read(self._chunk_bytes)
        if not raw:
            self._done = True
            final = self._lines.flush()
            if final is None:
                raise StopIteration()
            return final
        self._read += len(raw)
        out = self._lines.feed(raw)
        return out if out is not None else []

    def drain_dead_letters(self) -> List[dict]:
        dead, self._lines.dead = self._lines.dead, []
        return dead

    def snapshot(self) -> int:
        return self._read - self._lines.pending

    def close(self) -> None:
        self._f.close()


class FileSource(FixedPartitionedSource[str, int]):
    """Read a single file line-by-line; resumes exactly at the
    snapshotted byte offset.

    >>> import tempfile, os
    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.connectors.files import FileSource
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, run_main
    >>> with tempfile.TemporaryDirectory() as td:
    ...     path = os.path.join(td, "lines.txt")
    ...     _ = open(path, "w").write("one\\ntwo\\n")
    ...     flow = Dataflow("file_source_eg")
    ...     s = op.input("inp", flow, FileSource(path))
    ...     out = []
    ...     op.output("out", s, TestingSink(out))
    ...     run_main(flow)
    >>> out
    ['one', 'two']
    """

    def __init__(
        self,
        path: Path,
        batch_size: int = 1000,
        get_fs_id: Callable[[Path], str] = _get_path_dev,
        columnar: bool = False,
        chunk_bytes: int = 1 << 20,
        encoding: Optional[str] = "utf-8",
        on_error: str = "raise",
    ):
        """:arg path: Path to file.
        :arg batch_size: Lines per batch (default 1000; itemized mode).
        :arg get_fs_id: Returns a consistent unique id for the
            filesystem holding the file, used to deduplicate reads
            across workers; return a constant for shared mounts.
        :arg columnar: Batch-native mode — read ``chunk_bytes`` raw
            chunks and emit vectorized-split
            :class:`~bytewax_tpu_torch.inputs.ColumnarBatch` line batches
            (no per-row Python decode; docs/performance.md).  Resume
            offsets stay interchangeable with itemized mode.
        :arg chunk_bytes: Bytes per read in columnar mode.
        :arg encoding: Text encoding in columnar mode; ``None`` emits
            raw byte lines.
        :arg on_error: ``"dlq"`` dead-letters undecodable lines (the
            columnar decode path) into the engine's dead-letter queue
            with provenance instead of killing the run
            (docs/recovery.md "Connector-edge resilience").
            Columnar-mode only — the itemized reader decodes through
            Python's text layer, which cannot isolate a poison line,
            so the combination is refused rather than silently
            ignored."""
        if on_error not in ("raise", "dlq"):
            msg = f"on_error must be 'raise' or 'dlq'; got {on_error!r}"
            raise ValueError(msg)
        if on_error == "dlq" and not columnar:
            msg = (
                "on_error='dlq' requires columnar=True here (the "
                "itemized line reader can't isolate a poison line); "
                "use CSVSource for itemized dead-lettering"
            )
            raise ValueError(msg)
        path = Path(path)
        self._path = path
        self._batch_size = batch_size
        self._columnar = columnar
        self._chunk_bytes = chunk_bytes
        self._encoding = encoding
        self._on_error = on_error
        self._fs_id = get_fs_id(path.parent) if path.parent.exists() else "0"
        if "::" in self._fs_id:
            msg = (
                f"filesystem id {self._fs_id!r} contains the reserved "
                "`::` partition-name separator; return ids without it "
                "from `get_fs_id`"
            )
            raise ValueError(msg)

    def list_parts(self) -> List[str]:
        if self._path.exists():
            return [f"{self._fs_id}::{self._path}"]
        return []

    def build_part(
        self, step_id: str, for_part: str, resume_state: Optional[int]
    ) -> StatefulSourcePartition:
        _fs_id, path = for_part.split("::", 1)
        if path != str(self._path):
            msg = "can't resume reading from different file"
            raise ValueError(msg)
        if self._columnar:
            return _ChunkedLinePartition(
                self._path,
                self._chunk_bytes,
                resume_state,
                self._encoding,
                on_error=self._on_error,
            )
        return _FileSourcePartition(self._path, self._batch_size, resume_state)


class DirSource(FixedPartitionedSource[str, int]):
    """Read all files matching a glob in a directory, line-by-line;
    each unique file is a partition (the unit of parallelism).

    >>> import tempfile, os
    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.connectors.files import DirSource
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, run_main
    >>> with tempfile.TemporaryDirectory() as td:
    ...     _ = open(os.path.join(td, "a.log"), "w").write("x\\n")
    ...     _ = open(os.path.join(td, "b.log"), "w").write("y\\n")
    ...     flow = Dataflow("dir_source_eg")
    ...     s = op.input("inp", flow, DirSource(td, glob_pat="*.log"))
    ...     out = []
    ...     op.output("out", s, TestingSink(out))
    ...     run_main(flow)
    >>> sorted(out)
    ['x', 'y']
    """

    def __init__(
        self,
        dir_path: Path,
        glob_pat: str = "*",
        batch_size: int = 1000,
        get_fs_id: Callable[[Path], str] = _get_path_dev,
        columnar: bool = False,
        chunk_bytes: int = 1 << 20,
        encoding: Optional[str] = "utf-8",
        on_error: str = "raise",
    ):
        """``columnar=True`` reads each file in raw chunks and emits
        vectorized-split :class:`~bytewax_tpu_torch.inputs.ColumnarBatch`
        line batches; ``on_error="dlq"`` (columnar-mode only)
        dead-letters undecodable lines instead of killing the run
        (see :class:`FileSource`)."""
        if on_error not in ("raise", "dlq"):
            msg = f"on_error must be 'raise' or 'dlq'; got {on_error!r}"
            raise ValueError(msg)
        if on_error == "dlq" and not columnar:
            msg = (
                "on_error='dlq' requires columnar=True here (the "
                "itemized line reader can't isolate a poison line); "
                "use CSVSource for itemized dead-lettering"
            )
            raise ValueError(msg)
        dir_path = Path(dir_path)
        if not dir_path.exists():
            msg = f"no such input directory: {dir_path}"
            raise ValueError(msg)
        if not dir_path.is_dir():
            msg = f"input path {dir_path} must be a directory"
            raise ValueError(msg)
        self._dir_path = dir_path
        self._glob_pat = glob_pat
        self._batch_size = batch_size
        self._columnar = columnar
        self._chunk_bytes = chunk_bytes
        self._encoding = encoding
        self._on_error = on_error
        self._fs_id = get_fs_id(dir_path)
        if "::" in self._fs_id:
            msg = (
                f"filesystem id {self._fs_id!r} contains the reserved "
                "`::` partition-name separator; return ids without it "
                "from `get_fs_id`"
            )
            raise ValueError(msg)

    def list_parts(self) -> List[str]:
        return [
            f"{self._fs_id}::{path.relative_to(self._dir_path)}"
            for path in sorted(self._dir_path.glob(self._glob_pat))
            if path.is_file()
        ]

    def build_part(
        self, step_id: str, for_part: str, resume_state: Optional[int]
    ) -> StatefulSourcePartition:
        _fs_id, rel = for_part.split("::", 1)
        if self._columnar:
            return _ChunkedLinePartition(
                self._dir_path / rel,
                self._chunk_bytes,
                resume_state,
                self._encoding,
                on_error=self._on_error,
            )
        return _FileSourcePartition(
            self._dir_path / rel, self._batch_size, resume_state
        )


class _LineTap:
    """Pass-through line iterator remembering the last line handed
    out — when ``csv`` raises mid-parse, the remembered line is the
    poison payload for the dead-letter record — and the lines of the
    row being read, until :meth:`take`."""

    __slots__ = ("_lines", "last", "_row")

    def __init__(self, lines):
        self._lines = lines
        self.last: Optional[str] = None
        self._row: List[str] = []

    def __iter__(self):
        return self

    def __next__(self):
        self.last = next(self._lines)
        self._row.append(self.last)
        return self.last

    def take(self) -> str:
        """The raw lines handed out since the last call: the text of
        the row the reader just returned (a quoted field may span
        lines)."""
        row, self._row = "".join(self._row), []
        return row


def _read_rows_dlq(
    reader, tap: _LineTap, dead: List[dict], limit: Optional[int] = None
):
    """Pull up to ``limit`` rows (None = all) off a csv reader,
    dead-lettering parser-rejected rows — with the line the parse
    died on, via ``tap`` — into ``dead`` instead of raising.
    Returns ``(rows, captured_count)``.

    A row whose raw text holds a NUL is dead-lettered too, with the
    error older ``csv`` modules raised for it: since Python 3.12
    ``csv`` accepts NULs and would hand the row on as data."""
    out: List[Dict[str, str]] = []
    captured = 0
    while limit is None or len(out) < limit:
        try:
            row = next(reader)
        except StopIteration:
            break
        except csv.Error as ex:
            tap.take()
            captured += 1
            dead.append(
                {
                    "error": f"{type(ex).__name__}: {ex}",
                    "payload": tap.last,
                }
            )
            continue
        raw = tap.take()
        if "\x00" in raw:
            captured += 1
            dead.append({"error": "Error: line contains NUL", "payload": raw})
            continue
        out.append(row)
    return out, captured


def _nul_lines(lines: np.ndarray) -> bool:
    """Whether any line of a split chunk holds a NUL character.  Fixed
    width string arrays pad with zeros, so a zero code unit counts
    only before a line's last nonzero one (a NUL that ends a line is
    already lost to the padding)."""
    if lines.dtype.kind not in "US":
        return any("\x00" in ln for ln in lines.tolist())
    if not len(lines) or not lines.dtype.itemsize:
        return False
    unit = np.uint8 if lines.dtype.kind == "S" else np.uint32
    width = lines.dtype.itemsize // np.dtype(unit).itemsize
    codes = np.ascontiguousarray(lines).view(unit).reshape(len(lines), width)
    nonzero = codes != 0
    length = width - np.argmax(nonzero[:, ::-1], axis=1)
    length[~nonzero.any(axis=1)] = 0
    return bool((~nonzero & (np.arange(width) < length[:, None])).any())


class _CSVPartition(StatefulSourcePartition[Dict[str, str], int]):
    def __init__(
        self,
        path: Path,
        batch_size: int,
        resume_state: Optional[int],
        fmtparams: Dict[str, Any],
        on_error: str = "raise",
    ):
        self._f = open(path, "rt", newline="")
        # Feed csv via readline (not file iteration): iterating a
        # TextIOWrapper with __next__ disables tell(), which snapshots
        # need mid-file.
        lines = iter(self._f.readline, "")
        # The header is always re-read so field names survive resume.
        # csv.reader rejects DictReader-only kwargs.
        reader_params = {
            k: v
            for k, v in fmtparams.items()
            if k not in ("restkey", "restval")
        }
        header_reader = csv.reader(lines, **reader_params)
        self._fields = next(header_reader)
        if resume_state is not None:
            self._f.seek(resume_state)
        self._on_error = on_error
        self._batch_size = batch_size
        # Only dead-letter mode reads through the tap: it keeps each
        # row's raw lines until the row is taken.
        self._tap = _LineTap(lines) if on_error == "dlq" else None
        self._reader = csv.DictReader(
            self._tap or lines, fieldnames=self._fields, **fmtparams
        )
        self._batcher = batch(self._reader, batch_size)
        self._dead: List[dict] = []

    def next_batch(self) -> List[Dict[str, str]]:
        if self._on_error != "dlq":
            return next(self._batcher)
        # Dead-letter mode: rows the parser rejects (embedded NULs,
        # oversized fields) are captured with their raw line instead
        # of killing the run; the file offset has moved past them, so
        # the resume snapshot treats them as consumed — exactly the
        # contract the engine's DLQ epoch pairing needs.
        out, captured = _read_rows_dlq(
            self._reader, self._tap, self._dead, self._batch_size
        )
        if not out and not captured:
            raise StopIteration()
        return out

    def drain_dead_letters(self) -> List[dict]:
        dead, self._dead = self._dead, []
        return dead

    def snapshot(self) -> int:
        return self._f.tell()

    def close(self) -> None:
        self._f.close()


class _ColumnarCSVPartition(StatefulSourcePartition[Any, int]):
    """Batch-native CSV reader: chunked line split + one vectorized
    field split per column (ops/text.py), numeric columns cast in one
    C pass.  Rows the fast path can't take (quoting, ragged rows)
    fall back to ``csv.DictReader`` for that batch only — emitted
    itemized, which the batch-native protocol allows."""

    def __init__(
        self,
        path: Path,
        chunk_bytes: int,
        resume_state: Optional[int],
        fmtparams: Dict[str, Any],
        on_error: str = "raise",
    ):
        self._on_error = on_error
        self._dead: List[dict] = []
        self._delim = fmtparams.get("delimiter", ",")
        self._quote = fmtparams.get("quotechar") or '"'
        # Quote PARITY (count of quotechars mod 2) is how the chunked
        # reader detects a quoted field left open at a batch/header
        # boundary (embedded newlines).  Parity only delimits fields
        # when quotes are self-escaping: doublequote ("" counts 2)
        # keeps it, escapechar dialects break it, and QUOTE_NONE has
        # no quoted fields at all (rows == lines, chunking trivially
        # safe).  A dialect where multi-line fields are possible but
        # parity is unsound can't be chunked without corrupting rows
        # that span a boundary — refuse it up front.
        multiline_fields = (
            fmtparams.get("quoting", csv.QUOTE_MINIMAL) != csv.QUOTE_NONE
        )
        parity_sound = (
            fmtparams.get("doublequote", True)
            and fmtparams.get("escapechar") is None
        )
        if multiline_fields and not parity_sound:
            msg = (
                "CSVSource(columnar=True) can't chunk a dialect whose "
                "quote parity doesn't delimit fields (escapechar / "
                "doublequote=False): a quoted field spanning a chunk "
                "boundary would be cut mid-row.  Use itemized mode "
                "for this dialect."
            )
            raise ValueError(msg)
        self._stitch = multiline_fields
        reader_params = {
            k: v
            for k, v in fmtparams.items()
            if k not in ("restkey", "restval")
        }
        # Header is always re-read so field names survive resume
        # (same contract as the itemized reader) — and a quoted header
        # field may itself contain newlines, so keep reading while its
        # quote is open.
        quote_b = self._quote.encode("utf-8")
        with open(path, "rb") as f:
            header = f.readline()
            while self._stitch and header.count(quote_b) % 2:
                more = f.readline()
                if not more:
                    break
                header += more
            body_start = f.tell()
        self._fields = next(
            csv.reader(io.StringIO(header.decode("utf-8")), **reader_params)
        )
        self._fmtparams = fmtparams
        #: Only plain-delimiter dialects take the vectorized path; any
        #: other fmtparam routes every batch through csv.DictReader.
        self._simple = set(fmtparams) <= {"delimiter"}
        #: Numeric-cast decision per column, made ONCE on the first
        #: fast-path batch and held for the run: where later chunk
        #: boundaries fall must not flip a column between float64 and
        #: str (see _apply_sticky_casts).
        self._numeric: Optional[frozenset] = None
        self._inner = _ChunkedLinePartition(
            path,
            chunk_bytes,
            resume_state if resume_state is not None else body_start,
            on_error=on_error,
        )

    @staticmethod
    def _count_quotes(lines: np.ndarray, quote: str) -> int:
        if not len(lines):
            return 0
        if lines.dtype.kind in "US":
            return int(np.char.count(lines, quote).sum())
        # Ragged chunks degrade to object-dtype line arrays (see
        # ops/text._split_units); they're rare, so a Python count is
        # fine here.
        return sum(ln.count(quote) for ln in lines.tolist())

    def _apply_sticky_casts(
        self, cols: List[np.ndarray]
    ) -> Optional[Dict[str, np.ndarray]]:
        """Numeric casts with a per-run sticky decision: the first
        fast-path batch decides which columns are float64, every later
        batch honors it.  Returns ``None`` when a later batch has a
        non-castable cell in a sticky-numeric column — that batch
        falls back itemized like any other the fast path can't take."""
        from bytewax_tpu_torch.ops.text import maybe_numeric

        if self._numeric is None:
            casted = {
                name: maybe_numeric(col)
                for name, col in zip(self._fields, cols)
            }
            self._numeric = frozenset(
                name
                for name, col in casted.items()
                if col.dtype == np.float64
            )
            return casted
        out: Dict[str, np.ndarray] = {}
        for name, col in zip(self._fields, cols):
            if name in self._numeric:
                try:
                    col = col.astype(np.float64)
                except ValueError:
                    return None
            out[name] = col
        return out

    def next_batch(self) -> Any:
        from bytewax_tpu_torch.ops.text import split_fields

        out = self._inner.next_batch()
        if not isinstance(out, ColumnarBatch):
            return out
        lines = out.cols["line"]
        n_quotes = self._count_quotes(lines, self._quote)
        cols = None
        # Dead-letter mode sends a chunk with a NUL in a line to the
        # csv fallback below, which dead-letters that row.
        poisoned = self._on_error == "dlq" and _nul_lines(lines)
        if self._simple and not n_quotes and not poisoned:
            cols = split_fields(lines, len(self._fields), self._delim)
        casted = (
            self._apply_sticky_casts(cols) if cols is not None else None
        )
        if casted is not None:
            return ColumnarBatch(casted)
        rows = list(lines.tolist())
        # A quoted field may span lines: the chunk splitter cut it at
        # every newline.  csv reassembles multi-line fields when the
        # terminators are present, so the fallback feeds TERMINATED
        # lines — and when the batch ends inside an open quote (odd
        # quote parity; sound for every dialect __init__ admits), it
        # pulls further chunks until the row closes, so every emitted
        # row is complete and the byte-offset snapshot (taken between
        # deliveries) stays on a row boundary.
        while self._stitch and n_quotes % 2:
            try:
                nxt = self._inner.next_batch()
            except StopIteration:
                break  # unterminated quote at EOF: parse what's there
            if isinstance(nxt, ColumnarBatch) and len(nxt):
                more = nxt.cols["line"]
                n_quotes += self._count_quotes(more, self._quote)
                rows.extend(more.tolist())
        tap = _LineTap(ln + "\n" for ln in rows)
        reader = csv.DictReader(
            tap,
            fieldnames=self._fields,
            **self._fmtparams,
        )
        if self._on_error != "dlq":
            return list(reader)
        # Dead-letter mode: parser-rejected rows in a fallback batch
        # are captured (with the line the parse died on) and the rest
        # of the batch still flows.
        out, _captured = _read_rows_dlq(reader, tap, self._dead)
        return out

    def drain_dead_letters(self) -> List[dict]:
        dead = self._dead + self._inner.drain_dead_letters()
        self._dead = []
        return dead

    def snapshot(self) -> int:
        return self._inner.snapshot()

    def close(self) -> None:
        self._inner.close()


class CSVSource(FixedPartitionedSource[Dict[str, str], int]):
    """Read a CSV file row-by-row as keyed-by-header dicts.

    Equivalent to a :class:`FileSource` followed by ``csv.DictReader``,
    but resumable by byte offset.

    >>> import tempfile, os
    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.connectors.files import CSVSource
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, run_main
    >>> with tempfile.TemporaryDirectory() as td:
    ...     path = os.path.join(td, "rows.csv")
    ...     _ = open(path, "w").write("name,score\\nalice,10\\n")
    ...     flow = Dataflow("csv_source_eg")
    ...     s = op.input("inp", flow, CSVSource(path))
    ...     out = []
    ...     op.output("out", s, TestingSink(out))
    ...     run_main(flow)
    >>> out
    [{'name': 'alice', 'score': '10'}]
    """

    def __init__(
        self,
        path: Path,
        batch_size: int = 1000,
        get_fs_id: Callable[[Path], str] = _get_path_dev,
        columnar: bool = False,
        chunk_bytes: int = 1 << 20,
        on_error: str = "raise",
        **fmtparams: Any,
    ):
        """``columnar=True`` reads raw chunks and emits
        :class:`~bytewax_tpu_torch.inputs.ColumnarBatch` record batches with
        one column per CSV field, numeric columns cast to float64
        (vectorized; the cast decision is made on the first batch and
        held for the run, so chunk boundaries never flip a column's
        dtype; docs/performance.md).  Batches the fast path can't take
        (quoted fields, ragged rows, exotic dialects) fall back to
        ``csv.DictReader`` per batch and arrive itemized — quoted
        fields may span lines and chunks.  Dialects whose quote parity
        doesn't delimit fields (``escapechar``, ``doublequote=False``)
        are refused in columnar mode (a quoted field spanning a chunk
        boundary couldn't be stitched); use itemized mode for those.

        ``on_error="dlq"`` (both modes) dead-letters poison rows —
        lines the CSV parser rejects (embedded NULs, oversized
        fields) and, in columnar mode, undecodable lines — into the
        engine's dead-letter queue with provenance instead of killing
        the run (docs/recovery.md "Connector-edge resilience")."""
        if on_error not in ("raise", "dlq"):
            msg = f"on_error must be 'raise' or 'dlq'; got {on_error!r}"
            raise ValueError(msg)
        self._file_source = FileSource(path, batch_size, get_fs_id)
        self._columnar = columnar
        self._chunk_bytes = chunk_bytes
        self._on_error = on_error
        self._fmtparams = fmtparams

    def list_parts(self) -> List[str]:
        return self._file_source.list_parts()

    def build_part(
        self, step_id: str, for_part: str, resume_state: Optional[int]
    ) -> StatefulSourcePartition:
        _fs_id, path = for_part.split("::", 1)
        if path != str(self._file_source._path):
            msg = "can't resume reading from different file"
            raise ValueError(msg)
        if self._columnar:
            return _ColumnarCSVPartition(
                self._file_source._path,
                self._chunk_bytes,
                resume_state,
                self._fmtparams,
                on_error=self._on_error,
            )
        return _CSVPartition(
            self._file_source._path,
            self._file_source._batch_size,
            resume_state,
            self._fmtparams,
            on_error=self._on_error,
        )


class _FileSinkPartition(StatefulSinkPartition[str, int]):
    def __init__(self, path: Path, resume_state: Optional[int], end: str):
        resume_offset = 0 if resume_state is None else resume_state
        self._f = open(path, "at")
        # Truncate back to the snapshot so replayed epochs don't
        # duplicate output (exactly-once for batch contexts).
        self._f.seek(resume_offset)
        self._f.truncate()
        self._end = end

    def write_batch(self, values: List[str]) -> None:
        for value in values:
            self._f.write(value)
            self._f.write(self._end)
        self._f.flush()
        os.fsync(self._f.fileno())

    def snapshot(self) -> int:
        return self._f.tell()

    def close(self) -> None:
        self._f.close()


class FileSink(FixedPartitionedSink[str, int]):
    """Write items to a single file, one per line.

    Items must be ``(key, value)`` 2-tuples with string-able values.
    The file is truncated back to the last snapshot on resume, so
    duplicates are prevented.

    >>> import tempfile, os
    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.connectors.files import FileSink
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSource, run_main
    >>> with tempfile.TemporaryDirectory() as td:
    ...     path = os.path.join(td, "out.txt")
    ...     flow = Dataflow("file_sink_eg")
    ...     s = op.input("inp", flow, TestingSource([("k", "hi")]))
    ...     op.output("out", s, FileSink(path))
    ...     run_main(flow)
    ...     print(open(path).read())
    hi
    <BLANKLINE>
    """

    def __init__(self, path: Path, end: str = "\n"):
        self._path = Path(path)
        self._end = end

    def list_parts(self) -> List[str]:
        return [str(self._path)]

    def part_fn(self, item_key: str) -> int:
        return 0

    def build_part(
        self, step_id: str, for_part: str, resume_state: Optional[int]
    ) -> _FileSinkPartition:
        return _FileSinkPartition(self._path, resume_state, self._end)


class DirSink(FixedPartitionedSink[str, int]):
    """Write to a set of files in a directory, one item per line;
    individual files are the unit of parallelism.

    Items must be ``(key, value)`` 2-tuples; the key picks the file
    via ``assign_file``.

    >>> import tempfile, os
    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.connectors.files import DirSink
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSource, run_main
    >>> with tempfile.TemporaryDirectory() as td:
    ...     flow = Dataflow("dir_sink_eg")
    ...     s = op.input("inp", flow, TestingSource([("k", "v")]))
    ...     sink = DirSink(td, file_count=2, assign_file=lambda k: 0)
    ...     op.output("out", s, sink)
    ...     run_main(flow)
    ...     print(open(os.path.join(td, "part_0")).read().strip())
    v
    """

    def __init__(
        self,
        dir_path: Path,
        file_count: int,
        file_namer: Callable[[int, int], str] = lambda i, _n: f"part_{i}",
        assign_file: Callable[[str], int] = lambda k: adler32(k.encode()),
        end: str = "\n",
    ):
        self._dir_path = Path(dir_path)
        self._file_count = file_count
        self._file_namer = file_namer
        self._assign_file = assign_file
        self._end = end

    def list_parts(self) -> List[str]:
        return [
            self._file_namer(i, self._file_count)
            for i in range(self._file_count)
        ]

    def part_fn(self, item_key: str) -> int:
        return self._assign_file(item_key)

    def build_part(
        self, step_id: str, for_part: str, resume_state: Optional[int]
    ) -> _FileSinkPartition:
        return _FileSinkPartition(
            self._dir_path / for_part, resume_state, self._end
        )
