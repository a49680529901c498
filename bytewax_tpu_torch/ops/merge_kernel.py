"""Build, bind and launch the Hopper dequantize-and-merge kernel
(``csrc/agg_merge.cu``).

The card's counterpart of the JAX package's ``agg_merge_fn``
(``engine/xla.py``): the quantized gsync rounds of the cluster-wide
exchange tier fold every peer's partial-aggregate frame into
device-resident merge tables, one launch for a whole round (every frame,
every field).  The source is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, at first use, and loaded
with ``ctypes`` (:mod:`bytewax_tpu_torch.ops.cuda_build`).  Nothing is
built when this module is imported.

:func:`merge_round` is the way in: it checks the tables and the round's
descriptor, launches on PyTorch's current stream (:func:`launch_round`),
raises if the launch fails, then reads the kernel's three error words
back (one 12-byte copy a round, which waits for the kernel) and raises,
naming the first frame at fault, if a real row's target repeated
another's in its frame or lay outside the tables: a frame with a
repeated target would make the result depend on the order of the
card's writes.  :func:`launch_round` alone issues the call without that
read (a CUDA graph can capture it).  :func:`merge` folds one frame's
field, a round of one frame and one field.  Launches are counted in
:data:`launches`.  There is no fallback: the CPU path is the plain
version in :mod:`bytewax_tpu_torch.engine.xla`, which
:func:`~bytewax_tpu_torch.engine.xla.agg_merge_round` picks only for CPU
tensors.
"""

import ctypes
import threading
from typing import Optional, Sequence

import torch

from bytewax_tpu_torch.ops import cuda_build

__all__ = [
    "ENCODINGS",
    "MAX_FIELDS",
    "OPS",
    "QBLOCK",
    "build",
    "launch_round",
    "launches",
    "merge",
    "merge_round",
]

#: Encodings and ops, as ``csrc/agg_merge.cu`` numbers them.
ENCODINGS = {"raw": 0, "int8": 1, "bf16": 2}
OPS = {"add": 0, "min": 1, "max": 2}
#: Values per int8 scale (``engine/wire.py`` ``QBLOCK``).
QBLOCK = 1024
#: The most fields (tables) one round folds (``kMaxFields``: the stats
#: kind's four).
MAX_FIELDS = 4
#: The most table slots whose two bitmaps fit one cluster's shared
#: memory (8 blocks of 227 KB).
MAX_SLOTS = 8 * (227 * 1024 // 8) * 32
#: The most clusters a launch takes (``kMaxClusters``), three error
#: words each.
_MAX_CLUSTERS = 16

_SRC = cuda_build.CSRC / "agg_merge.cu"

#: Kernel launches since import (or since a caller reset it to 0).
launches = 0
#: ``nvcc``'s output from the build (``-Xptxas -v`` register report).
build_log = ""

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        lib, build_log = cuda_build.load_library(_SRC, "agg_merge")
        fn = lib.bw_agg_merge_round
        fn.argtypes = [
            ctypes.c_void_p,  # tables (void* [n_fields])
            ctypes.c_void_p,  # table_int (int [n_fields])
            ctypes.c_void_p,  # ops (int [n_fields])
            ctypes.c_int,  # n_fields
            ctypes.c_longlong,  # size
            ctypes.c_int,  # n_frames
            ctypes.c_longlong,  # max_rows
            ctypes.c_void_p,  # desc
            ctypes.c_void_p,  # base
            ctypes.c_void_p,  # err
            ctypes.POINTER(ctypes.c_int),  # n_clusters (out)
            ctypes.c_void_p,  # stream
            ctypes.c_int,  # device
        ]
        fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _fail(what: str) -> None:
    msg = f"agg-merge kernel: {what}"
    raise ValueError(msg)


def _require(ok: bool, what: str) -> None:
    if not ok:
        _fail(what)


def _check(t, name: str, dev: torch.device, dtypes, at_least: int) -> None:
    _require(isinstance(t, torch.Tensor), f"{name} must be a tensor")
    _require(t.device == dev, f"{name} is on {t.device}, the table on {dev}")
    _require(t.dtype in dtypes, f"{name} has dtype {t.dtype}, not one of {dtypes}")
    _require(t.dim() == 1 and t.is_contiguous(), f"{name} must be 1-D and contiguous")
    _require(t.shape[0] >= at_least, f"{name} has {t.shape[0]} entries, {at_least} needed")


_BF16_TYPES = tuple(t for t in (torch.int16, getattr(torch, "uint16", None)) if t is not None)


def _table_ok(t, dev: torch.device, size: int) -> bool:
    return (
        isinstance(t, torch.Tensor)
        and t.device == dev
        and (t.dtype is torch.float32 or t.dtype is torch.int32)
        and t.dim() == 1
        and t.shape[0] == size
        and t.is_contiguous()
    )


def launch_round(
    tables: Sequence[torch.Tensor],
    ops: Sequence[str],
    desc: torch.Tensor,
    n_frames: int,
    base: int = 0,
    max_rows: int = 0,
) -> torch.Tensor:
    """Issue one round's merge on the current stream and return its
    int32 error words, ``[clusters, 3]`` (each cluster's repeated
    targets, targets outside the tables, and first frame at fault or
    -1), valid once the kernel has run.  ``max_rows`` is the most real
    rows of a frame, which sizes the grid; see :func:`merge_round`."""
    global launches
    # The messages are formatted only on failure: this runs once a round.
    n_fields = len(tables)
    if not 1 <= n_fields <= MAX_FIELDS or len(ops) != n_fields:
        _fail(f"{n_fields} tables and {len(ops)} ops (1 to {MAX_FIELDS} of each, as many ops as tables)")
    first = tables[0]
    if not isinstance(first, torch.Tensor) or first.device.type != "cuda":
        _fail(f"the tables lie on {getattr(first, 'device', None)}, not on a CUDA device")
    dev = first.device
    size = first.shape[0] if first.dim() == 1 else 0
    if not 1 <= size <= MAX_SLOTS:
        _fail(f"{size} table slots (1 to {MAX_SLOTS})")
    for k, table in enumerate(tables):
        if not _table_ok(table, dev, size):
            _fail(f"table {k} must be a 1-D, contiguous int32 or float32 tensor of {size} slots on {dev}")
    codes = [OPS.get(op, -1) for op in ops]
    if min(codes) < 0:
        _fail(f"unknown op among {list(ops)}")
    n_frames = int(n_frames)
    if (
        n_frames < 0
        or not isinstance(desc, torch.Tensor)
        or desc.device != dev
        or desc.dtype is not torch.int64
        or not desc.is_contiguous()
        or desc.numel() < n_frames * (2 + 3 * n_fields)
    ):
        _fail(
            f"the descriptor of {n_frames} frames of {n_fields} fields must be a contiguous int64 "
            f"tensor of {n_frames * (2 + 3 * n_fields)} words on {dev}"
        )
    err = torch.empty((_MAX_CLUSTERS, 3), dtype=torch.int32, device=dev)
    clusters = ctypes.c_int(0)
    lib = _lib if _lib is not None else build()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    ptrs = (ctypes.c_void_p * n_fields)(*[t.data_ptr() for t in tables])
    ints = (ctypes.c_int * n_fields)(*[1 if t.dtype is torch.int32 else 0 for t in tables])
    ops_c = (ctypes.c_int * n_fields)(*codes)
    rc = lib.bw_agg_merge_round(
        ctypes.cast(ptrs, ctypes.c_void_p),
        ctypes.cast(ints, ctypes.c_void_p),
        ctypes.cast(ops_c, ctypes.c_void_p),
        n_fields,
        size,
        n_frames,
        int(max_rows),
        desc.data_ptr(),
        base,
        err.data_ptr(),
        ctypes.byref(clusters),
        torch._C._cuda_getCurrentRawStream(idx),
        idx,
    )
    if rc != 0:
        msg = f"agg-merge kernel launch failed: CUDA error {rc}"
        raise RuntimeError(msg)
    with _lock:
        launches += 1
    return err[: clusters.value]


def merge_round(
    tables: Sequence[torch.Tensor],
    ops: Sequence[str],
    desc: torch.Tensor,
    n_frames: int,
    base: int = 0,
    max_rows: int = 0,
) -> None:
    """Fold one round of ``n_frames`` frames into ``tables`` in place,
    with one launch and one read-back.

    ``tables`` are one table a field (int32 or float32, one length, on
    one CUDA device) and ``ops[k]`` field ``k``'s combine.  ``desc`` is
    the round's int64 descriptor on the tables' device, ``[n_frames][2 +
    3 * n_fields]``: a frame's targets and row count, then each field's
    encoding and its two parts, every address ``base`` plus the word
    (:func:`bytewax_tpu_torch.engine.xla.pack_merge_round` lays it out).
    Frames fold in order; a frame's real targets must be unique and
    inside the tables.  Raises, naming the first frame at fault, if a
    target repeats or lies outside (the tables may then have taken some
    of the rows).  ``max_rows``, the most real rows of a frame, sizes
    the grid (a cluster of 8 blocks for each 1,024 rows, at most 16 and
    at most as many as the card holds at once)."""
    words = launch_round(tables, ops, desc, n_frames, base, max_rows).tolist()
    repeated = sum(w[0] for w in words)
    outside = sum(w[1] for w in words)
    frame = min(w[2] & 0xFFFFFFFF for w in words)
    if repeated or outside:
        msg = (
            f"agg-merge kernel: frame {frame} of the round is the first at "
            f"fault: {repeated} row(s) repeat another row's target in "
            f"their frame and {outside} target(s) lie outside the "
            f"{tables[0].shape[0]}-slot tables; a frame's real targets "
            "must be unique table slots"
        )
        raise ValueError(msg)


def merge(
    table: torch.Tensor,
    gidx: torch.Tensor,
    n: int,
    enc: str,
    parts: Sequence[torch.Tensor],
    op: str,
) -> None:
    """Fold rows ``[0, n)`` of one frame's field into ``table`` in place:
    ``table[gidx[i]] = op(table[gidx[i]], dequantize(parts, i))``, a
    round of one frame and one field (one launch; none for ``n = 0``).

    ``table`` is int32 or float32 on a CUDA device; ``gidx`` int32 with
    at least ``n`` entries, unique over the first ``n`` and inside the
    table.  ``parts`` is ``enc``'s: ``raw`` one tensor of the table's
    dtype; ``int8`` ``(scales float32, q int8)`` with one scale a
    :data:`QBLOCK` rows; ``bf16`` one int16 (or uint16) tensor of the
    float32 values' upper halves.  Rows from ``n`` on are padding and
    are not read.  Raises as :func:`merge_round` does."""
    _require(enc in ENCODINGS, f"unknown encoding {enc!r}")
    _require(op in OPS, f"unknown op {op!r}")
    _require(isinstance(table, torch.Tensor), "table must be a tensor")
    dev = table.device
    _require(dev.type == "cuda", f"the table lies on {dev}, not on a CUDA device")
    n = int(n)
    _require(n >= 0, f"n = {n}")
    _check(gidx, "gidx", dev, (torch.int32,), n)
    if enc == "raw":
        _require(len(parts) == 1, "a raw part is one tensor")
        _check(parts[0], "values", dev, (table.dtype,), n)
    elif enc == "int8":
        _require(len(parts) == 2, "an int8 part is (scales, q)")
        _check(parts[0], "scales", dev, (torch.float32,), -(-n // QBLOCK))
        _check(parts[1], "q", dev, (torch.int8,), n)
    else:
        _require(len(parts) == 1, "a bf16 part is one tensor of upper halves")
        _check(parts[0], "hi", dev, _BF16_TYPES, n)
    if n == 0:
        return
    p1 = parts[1].data_ptr() if len(parts) > 1 else 0
    desc = torch.tensor(
        [gidx.data_ptr(), n, ENCODINGS[enc], parts[0].data_ptr(), p1], dtype=torch.int64
    ).to(dev)
    merge_round([table], [op], desc, 1, max_rows=n)
