"""Build, bind and launch the Hopper shard-bucketing kernel
(``csrc/shard_bucket.cu``).

The card's counterpart of the JAX package's ``bucket_by_shard``
(``parallel/exchange.py``): the stable counting sort that places every
row of the mesh-sharded tier's micro-batches into its owner shard's
bucket.  The source is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, and loaded with
``ctypes`` (:mod:`bytewax_tpu_torch.ops.cuda_build`).  Nothing is built
when this module is imported.

:func:`bucket` is the only way in: it checks device, dtype, layout and
shape, allocates the outputs and the kernel's workspace, launches on
PyTorch's current stream, raises if a launch fails, and counts calls in
:data:`launches` (one call is the kernel's passes, issued together).
There is no fallback: the CPU path is the plain version in
:mod:`bytewax_tpu_torch.parallel.exchange`, which the entry points there
pick only for CPU tensors.
"""

import ctypes
import threading
from typing import List, Optional, Tuple

import torch

from bytewax_tpu_torch.ops import cuda_build

__all__ = ["DECODE", "MAX_LANES", "MAX_SHARDS", "POS", "bucket", "build", "launches"]

#: ``flags`` bits, as ``csrc/shard_bucket.cu`` numbers them.
DECODE, POS = 1, 2
MAX_LANES = 4
MAX_SHARDS = 64
#: Rows of one chunk of the kernel's passes (``kChunk`` in the source).
_CHUNK = 4096

_SRC = cuda_build.CSRC / "shard_bucket.cu"

#: Kernel calls since import (or since a caller reset it to 0).
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
        lib, build_log = cuda_build.load_library(_SRC, "shard_bucket")
        fn = lib.bw_shard_bucket
        fn.argtypes = [
            ctypes.c_void_p,  # lane0
            ctypes.c_void_p,  # lane1
            ctypes.c_void_p,  # lane2
            ctypes.c_void_p,  # lane3
            ctypes.c_int,  # n_lanes
            ctypes.c_longlong,  # block_stride
            ctypes.c_longlong,  # row_stride
            ctypes.c_void_p,  # shard_ids
            ctypes.c_void_p,  # valid
            ctypes.c_int,  # n_blocks
            ctypes.c_longlong,  # n
            ctypes.c_int,  # n_shards
            ctypes.c_longlong,  # capacity
            ctypes.c_int,  # flags
            ctypes.c_int,  # pad0
            ctypes.c_longlong,  # pos_base
            ctypes.c_int,  # pos_pad
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # counts
            ctypes.c_void_p,  # dropped
            ctypes.c_void_p,  # chunk_counts
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _require(ok: bool, what: str) -> None:
    if not ok:
        msg = f"shard-bucket kernel: {what}"
        raise ValueError(msg)


def _strides(t: torch.Tensor, name: str, dev: torch.device, dtype) -> Tuple[int, int]:
    """A ``[blocks, rows]`` input's (block, row) strides, in elements;
    a stride of a dimension of size 1 does not matter and reads as 0."""
    _require(isinstance(t, torch.Tensor), f"{name} must be a tensor")
    _require(t.device == dev, f"{name} is on {t.device}, the rows on {dev}")
    _require(t.dtype == dtype, f"{name} has dtype {t.dtype}, not {dtype}")
    _require(t.dim() == 2, f"{name} must be [blocks, rows], got {tuple(t.shape)}")
    return tuple(st if size > 1 else 0 for size, st in zip(t.shape, t.stride()))


def bucket(
    lanes: List[torch.Tensor],
    n_shards: int,
    capacity: int,
    shard_ids: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    flags: int = 0,
    pad0: int = 0,
    pos_base: int = 0,
    pos_pad: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bucket ``[blocks, rows]`` int32 lanes by shard with one call of
    the kernel; returns ``(out [n_out, n_shards, blocks, capacity],
    counts [blocks, n_shards], dropped [blocks])``, int32 on the rows'
    device (``n_out`` is the lane count, plus one with :data:`POS`).

    Every lane, ``shard_ids`` (int32) and ``valid`` (bool) share one
    block stride; the lanes share one row stride, and ``shard_ids`` and
    ``valid`` have a row stride of 1.  Without ``shard_ids`` a row's
    shard is lane 0 modulo ``n_shards``; without ``valid`` every row is
    valid.  The semantics are the plain version's
    (:func:`bytewax_tpu_torch.parallel.exchange.bucket_blocks_plain`)."""
    global launches
    _require(1 <= len(lanes) <= MAX_LANES, f"{len(lanes)} lanes")
    _require(1 <= n_shards <= MAX_SHARDS, f"{n_shards} shards (at most {MAX_SHARDS})")
    _require(capacity >= 0, f"capacity {capacity}")
    _require(flags & ~(DECODE | POS) == 0, f"flags {flags}")
    first = lanes[0]
    _require(isinstance(first, torch.Tensor), "lane 0 must be a tensor")
    dev = first.device
    _require(dev.type == "cuda", f"rows lie on {dev}, not on a CUDA device")
    _require(first.dim() == 2, f"lanes must be [blocks, rows], got {tuple(first.shape)}")
    n_blocks, n = first.shape
    _require(1 <= n_blocks <= 65535, f"{n_blocks} source blocks")
    _require(n < 2**31, f"{n} rows a block")
    block_stride, row_stride = _strides(first, "lane 0", dev, torch.int32)
    for k, lane in enumerate(lanes[1:], start=1):
        _require(lane.shape == first.shape, f"lane {k} is {tuple(lane.shape)}, lane 0 {tuple(first.shape)}")
        _require(
            _strides(lane, f"lane {k}", dev, torch.int32) == (block_stride, row_stride),
            f"lane {k} has strides {lane.stride()}, lane 0 {first.stride()}",
        )
    for name, t, dtype in (("shard_ids", shard_ids, torch.int32), ("valid", valid, torch.bool)):
        if t is None:
            continue
        _require(t.shape == first.shape, f"{name} is {tuple(t.shape)}, the lanes {tuple(first.shape)}")
        _require(
            _strides(t, name, dev, dtype) == (block_stride, 1 if n > 1 else 0),
            f"{name} has strides {t.stride()}; it needs block stride {block_stride} and row stride 1",
        )
    n_out = len(lanes) + (1 if flags & POS else 0)
    out = torch.empty((n_out, n_shards, n_blocks, capacity), dtype=torch.int32, device=dev)
    counts = torch.empty((n_blocks, n_shards), dtype=torch.int32, device=dev)
    dropped = torch.empty((n_blocks,), dtype=torch.int32, device=dev)
    chunks = -(-n // _CHUNK)
    work = torch.empty((max(1, n_blocks * chunks * n_shards),), dtype=torch.int32, device=dev)
    lib = build()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    ptrs = [lane.data_ptr() for lane in lanes] + [None] * (MAX_LANES - len(lanes))
    with torch.cuda.device(idx):
        err = lib.bw_shard_bucket(
            *ptrs,
            len(lanes),
            block_stride,
            row_stride,
            None if shard_ids is None else shard_ids.data_ptr(),
            None if valid is None else valid.data_ptr(),
            n_blocks,
            n,
            n_shards,
            capacity,
            flags,
            int(pad0),
            int(pos_base),
            int(pos_pad),
            out.data_ptr(),
            counts.data_ptr(),
            dropped.data_ptr(),
            work.data_ptr(),
            torch._C._cuda_getCurrentRawStream(idx),
        )
    if err != 0:
        msg = f"shard-bucket kernel launch failed: CUDA error {err}"
        raise RuntimeError(msg)
    with _lock:
        launches += 1
    return out, counts, dropped
