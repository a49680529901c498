"""Native host runtime: C++ data-plane components bound via ctypes.

Compiled on first use with the system toolchain (``g++ -O3``) into a
cached shared library next to the sources.  The native surface mirrors
where the reference is native (its Rust engine): the host data plane
feeding the device — parsing, chunking — not the compute path (which
is XLA).
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np

__all__ = [
    "BrcParser",
    "any_isinstance",
    "bucket_adler",
    "group_kv",
    "is_available",
    "kv_encode",
    "lib",
    "scan_emit",
    "scan_fill_values",
    "wa_encode",
]

_HERE = Path(__file__).parent
_SRC = _HERE / "io_native.cpp"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
_host_ops: Any = None
_host_ops_tried = False


def _hashed_out_path(stem: str, src: Path, flags, *extra: str) -> Path:
    """Cache key = source content + compiler flags + host identity
    (a stale or foreign binary can SIGILL); binaries are gitignored,
    never shipped."""
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(platform.machine().encode())
    for part in extra:
        h.update(part.encode())
    return _HERE / f"{stem}-{h.hexdigest()[:12]}.so"


def _compile_cached(compiler: str, src: Path, flags, out_path: Path) -> None:
    """Compile to a per-process temp name and rename into place so a
    concurrent lane never loads a half-written file (rename on the
    same filesystem is atomic); failed runs leave no orphan temp, and
    stale cache entries (not in-progress temps) are cleaned up."""
    tmp_path = out_path.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [compiler, *flags, str(src), "-o", str(tmp_path)]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, text=True, timeout=120
        )
        os.replace(tmp_path, out_path)
    except BaseException:
        tmp_path.unlink(missing_ok=True)
        raise
    stem = out_path.name.rsplit("-", 1)[0]
    for stale in _HERE.glob(f"{stem}-*.so"):
        if stale != out_path and not stale.name.endswith(".tmp.so"):
            try:
                stale.unlink()
            except OSError:
                pass


def _build_ext(src: Path, modname: str):
    """Compile + import a CPython extension module from one C file."""
    import importlib.util
    import sysconfig

    flags = [
        "-O3",
        "-shared",
        "-fPIC",
        f"-I{sysconfig.get_path('include')}",
    ]
    ext_path = _hashed_out_path(
        f"_{modname}", src, flags, platform.python_version()
    )
    if not ext_path.exists():
        _compile_cached(
            os.environ.get("CC", os.environ.get("CXX", "gcc")),
            src,
            flags,
            ext_path,
        )
    spec = importlib.util.spec_from_file_location(modname, ext_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ext() -> Any:
    """The host_ops CPython extension, building it on first use; None
    when no toolchain is available (callers stay pure Python)."""
    global _host_ops, _host_ops_tried
    if _host_ops is None:
        if _host_ops_tried:
            return None
        with _lock:
            _host_ops_tried = True
            try:
                _host_ops = _build_ext(_HERE / "host_ops.c", "host_ops")
            except Exception:  # noqa: BLE001 — no toolchain: stay Python
                return None
    return _host_ops


def group_kv(items):
    """Group ``(str key, value)`` tuples into ``{key: [values]}`` with
    the native fast path when it is available (and buildable), else
    ``None`` so the caller runs its general Python loop.  The fast
    path itself raises TypeError on rows that are not exact str-keyed
    2-tuples — callers must fall back on that too."""
    ext = _ext()
    return None if ext is None else ext.group_kv(items)


def bucket_adler(items, n_buckets):
    """Bucket ``(str key, value)`` tuples by ``adler32(key utf-8) %
    n_buckets`` in one C pass — the keyed-exchange / default part_fn
    routing loop.  Returns a list of ``n_buckets`` lists of the
    original items, or ``None`` when the native module is not
    available.  Raises TypeError on rows that are not exact str-keyed
    2-tuples — callers must fall back on that too."""
    ext = _ext()
    return None if ext is None else ext.bucket_adler(items, n_buckets)


def scan_fill_values(groups, out) -> Any:
    """Flatten an insertion-ordered ``{key: [values]}`` dict into the
    writable float64 buffer ``out`` (one group after another);
    returns the list of group sizes, or None without the native
    module.  Raises TypeError on non-float-coercible values —
    callers fall back to the host tier on that."""
    ext = _ext()
    return None if ext is None else ext.scan_fill_values(groups, out)


def kv_encode(items, iddict, ids, vals, ivals=None) -> Any:
    """One-pass itemized→columnar promotion: dictionary-encode the
    keys of ``(str key, value)`` tuples through ``iddict`` (first-
    sight dense ids) and fill values into the float64 buffer
    ``vals`` / ids into the int32 buffer ``ids``.  With the optional
    int64 buffer ``ivals``, exact-integer streams also fill it
    losslessly (values past 2^53 survive; past int64 the batch drops
    to the float lane).  Returns ``(new_keys, all_int)``, or None
    without the native module.  Raises TypeError on malformed rows or
    non-numeric values (with ``iddict`` rolled back) — callers fall
    back on that."""
    ext = _ext()
    return (
        None
        if ext is None
        else ext.kv_encode(items, iddict, ids, vals, ivals)
    )


def any_isinstance(items, types) -> Optional[bool]:
    """``any(isinstance(x, types) for x in items)`` in one C pass
    with a last-clean-type cache (homogeneous lists cost one pointer
    compare per item); None without the native module."""
    ext = _ext()
    return None if ext is None else ext.any_isinstance(items, types)


def wa_encode(items, iddict, ids, tss, vals) -> Any:
    """One-pass itemized→columnar promotion for event-time windowing:
    dictionary-encode the keys of timestamped ``(str key, value)``
    tuples through ``iddict`` and fill epoch-us timestamps into the
    float64 buffer ``tss`` / values into ``vals`` / ids into the
    int32 buffer ``ids``.  Two uniform row shapes: value is a UTC
    datetime (mode 1: counts) or a float carrying a UTC datetime
    ``ts`` attribute (mode 2: the TsValue degrade shape).  Returns
    ``(new_keys, mode)``, or None without the native module.  Raises
    TypeError on malformed/mixed rows or non-UTC timestamps (with
    ``iddict`` rolled back) — callers fall back on that."""
    ext = _ext()
    return None if ext is None else ext.wa_encode(items, iddict, ids, tss, vals)


def scan_emit(groups, outs) -> Any:
    """Build the scan emission list ``[(key, (value, *outs)), ...]``
    from the group dict plus the kind's output columns (a tuple of
    contiguous 1-D numpy arrays — float, bool, or int, decided per
    column from its buffer format) in one C pass, reusing the
    original key and value objects; None without the native module."""
    ext = _ext()
    return None if ext is None else ext.scan_emit(groups, outs)


def _build() -> Optional[ctypes.CDLL]:
    global _build_error
    flags = [
        "-O3",
        "-march=native",
        "-shared",
        "-fPIC",
        "-std=c++17",
    ]
    lib_path = _hashed_out_path("_io_native", _SRC, flags)
    if lib_path.exists():
        return ctypes.CDLL(str(lib_path))
    try:
        _compile_cached(
            os.environ.get("CXX", "g++"), _SRC, flags, lib_path
        )
    except (subprocess.CalledProcessError, OSError, subprocess.TimeoutExpired) as ex:
        _build_error = getattr(ex, "stderr", str(ex)) or str(ex)
        return None
    return ctypes.CDLL(str(lib_path))


def lib() -> ctypes.CDLL:
    """The loaded native library, building it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            built = _build()
            if built is None:
                msg = (
                    "failed to build the native IO library with g++: "
                    f"{_build_error}"
                )
                raise RuntimeError(msg)
            _configure(built)
            _lib = built
    return _lib


def is_available() -> bool:
    """Whether the native library can be built/loaded."""
    try:
        lib()
        return True
    except (RuntimeError, OSError):
        return False


def _configure(cdll: ctypes.CDLL) -> None:
    cdll.brc_parser_new.restype = ctypes.c_void_p
    cdll.brc_parser_free.argtypes = [ctypes.c_void_p]
    cdll.brc_vocab_size.argtypes = [ctypes.c_void_p]
    cdll.brc_vocab_size.restype = ctypes.c_int32
    cdll.brc_vocab_get.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.c_char_p,
        ctypes.c_int32,
    ]
    cdll.brc_vocab_get.restype = ctypes.c_int32
    cdll.last_line_end.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    cdll.last_line_end.restype = ctypes.c_int64
    cdll.brc_parse_chunk.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int64,
    ]
    cdll.brc_parse_chunk.restype = ctypes.c_int64
    cdll.line_offsets.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    cdll.line_offsets.restype = ctypes.c_int64
    cdll.wc_new.restype = ctypes.c_void_p
    cdll.wc_free.argtypes = [ctypes.c_void_p]
    cdll.wc_vocab_size.argtypes = [ctypes.c_void_p]
    cdll.wc_vocab_size.restype = ctypes.c_int32
    cdll.wc_vocab_get.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.c_char_p,
        ctypes.c_int32,
    ]
    cdll.wc_vocab_get.restype = ctypes.c_int32
    cdll.wc_tokenize.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    cdll.wc_tokenize.restype = ctypes.c_int64


class BrcParser:
    """Streaming 1BRC text parser: bytes in, dictionary-encoded
    ``(key_id int32, deci-degrees int16)`` columns out.

    The station vocabulary grows incrementally and is stable across
    chunks, so downstream device state can rely on id identity.
    """

    def __init__(self):
        self._cdll = lib()
        self._parser = self._cdll.brc_parser_new()
        self._vocab_cache: list = []

    def __del__(self):
        parser = getattr(self, "_parser", None)
        if parser:
            self._cdll.brc_parser_free(parser)
            self._parser = None

    def parse(self, chunk: bytes):
        """Parse a chunk ending on a line boundary; returns
        ``(ids int32[n], temps int16[n])``."""
        # Worst-case rows: one per 5 bytes ("a;0\n" minimum ~4).
        cap = len(chunk) // 4 + 1
        ids = np.empty(cap, dtype=np.int32)
        temps = np.empty(cap, dtype=np.int16)
        n = self._cdll.brc_parse_chunk(
            self._parser,
            chunk,
            len(chunk),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            temps.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            cap,
        )
        if n < 0:
            msg = "malformed 1BRC input (expected `station;temp` lines)"
            raise ValueError(msg)
        return ids[:n], temps[:n]

    def vocab(self) -> np.ndarray:
        """Current station vocabulary as a numpy string array."""
        size = self._cdll.brc_vocab_size(self._parser)
        while len(self._vocab_cache) < size:
            i = len(self._vocab_cache)
            buf = ctypes.create_string_buffer(256)
            n = self._cdll.brc_vocab_get(self._parser, i, buf, 256)
            self._vocab_cache.append(buf.raw[:n].decode("utf-8"))
        return np.array(self._vocab_cache)

    def split_point(self, chunk: bytes) -> int:
        """Largest prefix length of ``chunk`` ending on a newline."""
        return self._cdll.last_line_end(chunk, len(chunk))
