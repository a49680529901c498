"""Build, bind and launch the Hopper dequantize-and-merge kernel
(``csrc/agg_merge.cu``).

The card's counterpart of the JAX package's ``agg_merge_fn``
(``engine/xla.py``): the quantized gsync rounds of the cluster-wide
exchange tier fold every peer's partial-aggregate frame into a
device-resident merge table, one launch for each (frame, field).  The
source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, and loaded with ``ctypes``
(:mod:`bytewax_tpu_torch.ops.cuda_build`).  Nothing is built when this
module is imported.

:func:`merge` is the way in: it checks device, dtype, layout and
length, launches on PyTorch's current stream (:func:`launch`), raises
if the launch fails, then reads the kernel's two error words back (one
4-byte-pair copy, which waits for the kernel) and raises if a real
row's target repeated another's or lay outside the table: a frame with
a repeated target would make the result depend on the order of the
card's writes.  :func:`launch` alone issues the call without that
read (a CUDA graph can capture it).  Calls are counted in
:data:`launches`.  There is no fallback: the CPU path is the plain
version in :mod:`bytewax_tpu_torch.engine.xla`, which
:func:`~bytewax_tpu_torch.engine.xla.agg_merge` picks only for CPU
tensors.
"""

import ctypes
import threading
from typing import Optional, Sequence

import torch

from bytewax_tpu_torch.ops import cuda_build

__all__ = ["ENCODINGS", "OPS", "QBLOCK", "build", "launch", "launches", "merge"]

#: Encodings and ops, as ``csrc/agg_merge.cu`` numbers them.
ENCODINGS = {"raw": 0, "int8": 1, "bf16": 2}
OPS = {"add": 0, "min": 1, "max": 2}
#: Values per int8 scale (``engine/wire.py`` ``QBLOCK``).
QBLOCK = 1024

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
        fn = lib.bw_agg_merge
        fn.argtypes = [
            ctypes.c_int,  # table_int
            ctypes.c_int,  # enc
            ctypes.c_int,  # op
            ctypes.c_void_p,  # table
            ctypes.c_longlong,  # size
            ctypes.c_void_p,  # gidx
            ctypes.c_longlong,  # n
            ctypes.c_void_p,  # part 0
            ctypes.c_void_p,  # part 1
            ctypes.c_void_p,  # work
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _require(ok: bool, what: str) -> None:
    if not ok:
        msg = f"agg-merge kernel: {what}"
        raise ValueError(msg)


def _check(t, name: str, dev: torch.device, dtypes, at_least: int) -> None:
    _require(isinstance(t, torch.Tensor), f"{name} must be a tensor")
    _require(t.device == dev, f"{name} is on {t.device}, the table on {dev}")
    _require(t.dtype in dtypes, f"{name} has dtype {t.dtype}, not one of {dtypes}")
    _require(t.dim() == 1 and t.is_contiguous(), f"{name} must be 1-D and contiguous")
    _require(t.shape[0] >= at_least, f"{name} has {t.shape[0]} entries, {at_least} needed")


_BF16_TYPES = tuple(t for t in (torch.int16, getattr(torch, "uint16", None)) if t is not None)


def launch(
    table: torch.Tensor,
    gidx: torch.Tensor,
    n: int,
    enc: str,
    parts: Sequence[torch.Tensor],
    op: str,
) -> torch.Tensor:
    """Issue one merge call on the current stream and return its
    workspace, whose last two int32 words count the repeated and the
    out-of-range targets once the kernel has run; see :func:`merge`."""
    global launches
    _require(enc in ENCODINGS, f"unknown encoding {enc!r}")
    _require(op in OPS, f"unknown op {op!r}")
    _require(isinstance(table, torch.Tensor), "table must be a tensor")
    dev = table.device
    _require(dev.type == "cuda", f"the table lies on {dev}, not on a CUDA device")
    _require(table.dtype in (torch.float32, torch.int32), f"table dtype {table.dtype}")
    _require(table.dim() == 1 and table.is_contiguous(), "the table must be 1-D and contiguous")
    size = table.shape[0]
    _require(1 <= size < 2**31, f"{size} table slots")
    n = int(n)
    _require(n >= 0, f"n = {n}")
    _check(gidx, "gidx", dev, (torch.int32,), n)
    if enc == "raw":
        _require(len(parts) == 1, "a raw part is one tensor")
        _check(parts[0], "values", dev, (table.dtype,), n)
        p0, p1 = parts[0], None
    elif enc == "int8":
        _require(len(parts) == 2, "an int8 part is (scales, q)")
        _check(parts[0], "scales", dev, (torch.float32,), -(-n // QBLOCK))
        _check(parts[1], "q", dev, (torch.int8,), n)
        p0, p1 = parts
    else:
        _require(len(parts) == 1, "a bf16 part is one tensor of upper halves")
        _check(parts[0], "hi", dev, _BF16_TYPES, n)
        p0, p1 = parts[0], None
    if n == 0:
        return torch.zeros((2,), dtype=torch.int32, device=dev)
    work = torch.empty(((size + 31) // 32 + 2,), dtype=torch.int32, device=dev)
    lib = build()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(idx):
        err = lib.bw_agg_merge(
            1 if table.dtype == torch.int32 else 0,
            ENCODINGS[enc],
            OPS[op],
            table.data_ptr(),
            size,
            gidx.data_ptr(),
            n,
            p0.data_ptr(),
            None if p1 is None else p1.data_ptr(),
            work.data_ptr(),
            torch._C._cuda_getCurrentRawStream(idx),
        )
    if err != 0:
        msg = f"agg-merge kernel launch failed: CUDA error {err}"
        raise RuntimeError(msg)
    with _lock:
        launches += 1
    return work


def merge(
    table: torch.Tensor,
    gidx: torch.Tensor,
    n: int,
    enc: str,
    parts: Sequence[torch.Tensor],
    op: str,
) -> None:
    """Fold rows ``[0, n)`` of one frame's field into ``table`` in place
    with one launch: ``table[gidx[i]] = op(table[gidx[i]],
    dequantize(parts, i))``.

    ``table`` is int32 or float32 on a CUDA device; ``gidx`` int32 with
    at least ``n`` entries, unique over the first ``n`` and inside the
    table.  ``parts`` is ``enc``'s: ``raw`` one tensor of the table's
    dtype; ``int8`` ``(scales float32, q int8)`` with one scale a
    :data:`QBLOCK` rows; ``bf16`` one int16 (or uint16) tensor of the
    float32 values' upper halves.  Rows from ``n`` on are padding and
    are not read.  Raises if a target repeats or lies outside the table
    (the table may then have taken some of the rows)."""
    work = launch(table, gidx, n, enc, parts, op)
    repeated, outside = work[-2:].tolist()
    if repeated or outside:
        msg = (
            f"agg-merge kernel: {repeated} row(s) of the frame repeat "
            f"another row's target and {outside} target(s) lie outside "
            f"the {table.shape[0]}-slot table; a frame's real targets "
            "must be unique table slots"
        )
        raise ValueError(msg)
