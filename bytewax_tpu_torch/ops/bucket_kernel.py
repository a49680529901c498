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
PyTorch's current stream, raises if the launch fails, and counts calls in
:data:`launches` (one call is one launch: a single pass over the rows,
with a decoupled look-back between chunks).  There is no fallback: the
CPU path is the plain version in
:mod:`bytewax_tpu_torch.parallel.exchange`, which the entry points there
pick only for CPU tensors.

The kernel's workspace (a ticket counter, the call's sequence number and
each chunk's per-shard status words) stays with the device: one zeroed
buffer a device, grown when a call needs more, never cleared between
calls.  The engine issues every call on one stream, where calls run in
order; two calls running at once on one workspace would take each
other's tickets.
"""

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

import torch

from bytewax_tpu_torch.ops import cuda_build

__all__ = ["DECODE", "MAX_LANES", "MAX_SHARDS", "POS", "bucket", "build", "launches", "out_shape"]

#: ``flags`` bits, as ``csrc/shard_bucket.cu`` numbers them.
DECODE, POS = 1, 2
MAX_LANES = 4
MAX_SHARDS = 64
#: The least status words a new workspace holds (2 MB).
_MIN_WORKSPACE_WORDS = 1 << 18

_SRC = cuda_build.CSRC / "shard_bucket.cu"

#: Kernel calls since import (or since a caller reset it to 0).
launches = 0
#: ``nvcc``'s output from the build (``-Xptxas -v`` register report).
build_log = ""

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: Device index -> (zeroed workspace, its bytes).
_workspaces: Dict[int, Tuple[torch.Tensor, int]] = {}


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        lib, build_log = cuda_build.load_library(_SRC, "shard_bucket")
        ws = lib.bw_shard_bucket_workspace
        ws.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
        ws.restype = ctypes.c_longlong
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
            ctypes.c_int,  # peers
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # counts
            ctypes.c_void_p,  # dropped
            ctypes.c_void_p,  # workspace
            ctypes.c_void_p,  # stream
            ctypes.c_int,  # device
        ]
        fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _fail(what: str) -> None:
    msg = f"shard-bucket kernel: {what}"
    raise ValueError(msg)


def _strides(t: torch.Tensor, name: str, dev: torch.device, dtype) -> Tuple[int, int]:
    """A ``[blocks, rows]`` input's (block, row) strides, in elements;
    a stride of a dimension of size 1 does not matter and reads as 0."""
    if not (isinstance(t, torch.Tensor) and t.device == dev and t.dtype is dtype and t.dim() == 2):
        _fail(f"{name} must be a [blocks, rows] {dtype} tensor on {dev}, got {t!r:.80}")
    (b, r), (bs, rs) = t.shape, t.stride()
    return (bs if b > 1 else 0, rs if r > 1 else 0)


def _workspace(lib: ctypes.CDLL, nbytes: int, dev: torch.device) -> torch.Tensor:
    """The device's workspace, grown (zeroed) if it holds fewer than
    ``nbytes``."""
    with _lock:
        held = _workspaces.get(dev.index)
        if held is None or held[1] < nbytes:
            least = lib.bw_shard_bucket_workspace(1, 0, 1) + 8 * _MIN_WORKSPACE_WORDS
            size = max(nbytes, least, 2 * held[1] if held else 0)
            held = (torch.zeros(size, dtype=torch.uint8, device=dev), size)
            _workspaces[dev.index] = held
        return held[0]


def out_shape(n_out: int, n_shards: int, n_blocks: int, capacity: int, peers: int = 1) -> Tuple[int, ...]:
    """The bucket output's shape: ``[n_out, n_shards, n_blocks,
    capacity]``, or peer-major ``[peers, n_out, n_shards // peers,
    n_blocks, capacity]`` with ``peers`` above 1."""
    if peers == 1:
        return (n_out, n_shards, n_blocks, capacity)
    return (peers, n_out, n_shards // peers, n_blocks, capacity)


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
    peers: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bucket ``[blocks, rows]`` int32 lanes by shard with one launch of
    the kernel; returns ``(out, counts [blocks, n_shards], dropped
    [blocks])``, int32 on the rows' device, ``out`` shaped as
    :func:`out_shape` gives (``n_out`` is the lane count, plus one with
    :data:`POS`; ``peers`` must divide ``n_shards``).

    Every lane, ``shard_ids`` (int32) and ``valid`` (bool) share one
    block stride; the lanes share one row stride, and ``shard_ids`` and
    ``valid`` have a row stride of 1.  Without ``shard_ids`` a row's
    shard is lane 0 modulo ``n_shards``; without ``valid`` every row is
    valid.  The semantics are the plain version's
    (:func:`bytewax_tpu_torch.parallel.exchange.bucket_blocks_plain`)."""
    global launches
    # The messages are formatted only on failure: this runs a batch.
    if not (1 <= len(lanes) <= MAX_LANES and 1 <= n_shards <= MAX_SHARDS and capacity >= 0):
        _fail(
            f"{len(lanes)} lanes (1 to {MAX_LANES}), {n_shards} shards (1 to {MAX_SHARDS}), "
            f"capacity {capacity}"
        )
    if flags & ~(DECODE | POS) or peers < 1 or n_shards % peers:
        _fail(f"flags {flags}, {peers} peers for {n_shards} shards (peers must divide them)")
    first = lanes[0]
    if not isinstance(first, torch.Tensor) or first.device.type != "cuda" or first.dim() != 2:
        _fail(f"lanes must be [blocks, rows] tensors on a CUDA device, got {first!r:.80}")
    dev = first.device
    n_blocks, n = first.shape
    if not (1 <= n_blocks <= 65535 and n < 2**31):
        _fail(f"{n_blocks} source blocks (1 to 65535) of {n} rows (below 2^31)")
    block_stride, row_stride = _strides(first, "lane 0", dev, torch.int32)
    for k, lane in enumerate(lanes[1:], start=1):
        strides = _strides(lane, f"lane {k}", dev, torch.int32)
        if lane.shape != first.shape or strides != (block_stride, row_stride):
            _fail(
                f"lane {k} is {tuple(lane.shape)} with strides {lane.stride()}, lane 0 "
                f"{tuple(first.shape)} with {first.stride()}"
            )
    for name, t, dtype in (("shard_ids", shard_ids, torch.int32), ("valid", valid, torch.bool)):
        if t is None:
            continue
        if t.shape != first.shape or _strides(t, name, dev, dtype) != (block_stride, 1 if n > 1 else 0):
            _fail(
                f"{name} is {tuple(t.shape)} with strides {t.stride()}; it needs the lanes' "
                f"shape {tuple(first.shape)}, block stride {block_stride} and row stride 1"
            )
    n_out = len(lanes) + (1 if flags & POS else 0)
    out = torch.empty(out_shape(n_out, n_shards, n_blocks, capacity, peers), dtype=torch.int32, device=dev)
    counts = torch.empty((n_blocks, n_shards), dtype=torch.int32, device=dev)
    dropped = torch.empty((n_blocks,), dtype=torch.int32, device=dev)
    lib = _lib if _lib is not None else build()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    nbytes = lib.bw_shard_bucket_workspace(n_blocks, n, n_shards)
    held = _workspaces.get(idx)
    if held is None or held[1] < nbytes:
        held = (_workspace(lib, nbytes, torch.device("cuda", idx)), nbytes)
    work = held[0]
    ptrs = [lane.data_ptr() for lane in lanes] + [None] * (MAX_LANES - len(lanes))
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
        peers,
        out.data_ptr(),
        counts.data_ptr(),
        dropped.data_ptr(),
        work.data_ptr(),
        torch._C._cuda_getCurrentRawStream(idx),
        idx,
    )
    if err != 0:
        msg = f"shard-bucket kernel launch failed: CUDA error {err}"
        raise RuntimeError(msg)
    with _lock:
        launches += 1
    return out, counts, dropped
