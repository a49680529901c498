"""Build, bind and launch the Hopper segment-fold kernel
(``csrc/segment_fold.cu``).

This is the port's counterpart of the JAX package's Pallas kernel
(``ops/pallas_fold.py``): the one device fold under every keyed
aggregation.  The source is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, at first use, and loaded
with ``ctypes`` (:mod:`bytewax_tpu_torch.ops.cuda_build`).  Nothing is
built when this module is imported.

:func:`fold` is the only way in: it checks device, dtype, contiguity
and shape, launches on PyTorch's current stream (the kernel sizes its
own grid), raises if the launch fails, and counts launches in
:data:`launches`.  There is no fallback:
the CPU path is the plain version in :mod:`bytewax_tpu_torch.ops.segment`,
which the entry points there pick only for CPU tensors.
"""

import ctypes
import threading
from typing import Dict, Optional

import torch

from bytewax_tpu_torch.ops import cuda_build

__all__ = [
    "SRC_EXT16",
    "SRC_EXT32",
    "SRC_PACKED",
    "SRC_SLOT",
    "build",
    "fold",
    "launches",
]

#: Row sources, as ``csrc/segment_fold.cu`` numbers them.
SRC_SLOT, SRC_EXT16, SRC_EXT32, SRC_PACKED = 0, 1, 2, 3

_OPS = {"add": 0, "min": 1, "max": 2}
_COUNT_BIT = 4
_MAX_FIELDS = 4

_SRC = cuda_build.CSRC / "segment_fold.cu"

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
        lib, build_log = cuda_build.load_library(_SRC, "segment_fold")
        fn = lib.bw_segment_fold
        fn.argtypes = [
            ctypes.c_int,  # source
            ctypes.c_int,  # acc_int
            ctypes.c_int,  # n_fields
            ctypes.c_int,  # field_codes
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,  # rows
            ctypes.c_void_p,  # vals
            ctypes.c_void_p,  # map
            ctypes.c_longlong,  # n_map
            ctypes.c_float,  # scale
            ctypes.c_longlong,  # n
            ctypes.c_longlong,  # capacity
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _require(ok: bool, what: str) -> None:
    if not ok:
        msg = f"segment-fold kernel: {what}"
        raise ValueError(msg)


def _check_tensor(t, name: str, dev: torch.device, dtypes, ndim: int) -> None:
    # The messages are formatted only on failure: this runs several
    # times per launch.
    if (
        isinstance(t, torch.Tensor)
        and t.device == dev
        and t.dtype in dtypes
        and t.dim() == ndim
        and t.is_contiguous()
    ):
        return
    _require(isinstance(t, torch.Tensor), f"{name} must be a tensor")
    _require(t.device == dev, f"{name} is on {t.device}, state on {dev}")
    _require(t.dtype in dtypes, f"{name} has dtype {t.dtype}, not one of {dtypes}")
    _require(t.dim() == ndim, f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    _require(t.is_contiguous(), f"{name} must be contiguous")


_ROW_TYPES = {
    SRC_SLOT: (torch.int32,),
    SRC_EXT16: (torch.int16,),
    SRC_EXT32: (torch.int32,),
}


def fold(
    kind,
    state: Dict[str, torch.Tensor],
    source: int,
    rows: torch.Tensor,
    vals: Optional[torch.Tensor],
    ext_to_slot: Optional[torch.Tensor] = None,
    scale: float = 1.0,
) -> None:
    """Fold a micro-batch into ``state`` (every field of ``kind``) in
    place, with one kernel launch.

    ``rows`` is int32 slots (``SRC_SLOT``), int16/int32 external ids
    (``SRC_EXT16``/``SRC_EXT32``, with ``ext_to_slot``), or the
    ``[2, n]`` int16 packed batch (``SRC_PACKED``, with
    ``ext_to_slot`` and ``scale``; ``vals`` is None).  ``vals`` has
    the state's dtype."""
    global launches
    names = list(kind.fields)
    _require(1 <= len(names) <= _MAX_FIELDS, f"{len(names)} fields")
    first = state[names[0]]
    dev = first.device
    _require(dev.type == "cuda", f"state lies on {dev}, not on a CUDA device")
    acc = first.dtype
    _require(acc in (torch.float32, torch.int32), f"accumulator dtype {acc}")
    capacity = first.shape[0]
    _require(capacity >= 1, "empty slot table")
    codes = 0
    for k, name in enumerate(names):
        _check_tensor(state[name], f"state[{name!r}]", dev, (acc,), 1)
        _require(state[name].shape[0] == capacity, "fields differ in length")
        op = _OPS[kind.fields[name][1]]
        codes |= (op | (_COUNT_BIT if name == "count" else 0)) << (3 * k)
    if source == SRC_PACKED:
        _check_tensor(rows, "packed", dev, (torch.int16,), 2)
        _require(rows.shape[0] == 2, "packed must be [2, n]")
        _require(vals is None, "packed rows carry their values")
        n = rows.shape[1]
    else:
        _require(source in _ROW_TYPES, f"unknown row source {source}")
        _check_tensor(rows, "rows", dev, _ROW_TYPES[source], 1)
        _check_tensor(vals, "vals", dev, (acc,), 1)
        n = rows.shape[0]
        _require(vals.shape[0] == n, "rows and vals differ in length")
    if source == SRC_SLOT:
        _require(ext_to_slot is None, "slot rows take no id->slot table")
        map_ptr, n_map = None, 0
    else:
        _check_tensor(ext_to_slot, "ext_to_slot", dev, (torch.int32,), 1)
        n_map = ext_to_slot.shape[0]
        _require(n_map >= 1, "empty id->slot table")
        map_ptr = ext_to_slot.data_ptr()
    if n == 0 or capacity == 1:
        return
    lib = build()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    acc_int = 1 if acc == torch.int32 else 0
    ptrs = [state[name].data_ptr() for name in names]
    ptrs += [None] * (_MAX_FIELDS - len(ptrs))
    with torch.cuda.device(idx):
        err = lib.bw_segment_fold(
            source,
            acc_int,
            len(names),
            codes,
            *ptrs,
            rows.data_ptr(),
            None if vals is None else vals.data_ptr(),
            map_ptr,
            n_map,
            float(scale),
            n,
            capacity,
            torch._C._cuda_getCurrentRawStream(idx),
        )
    if err != 0:
        msg = f"segment-fold kernel launch failed: CUDA error {err}"
        raise RuntimeError(msg)
    with _lock:
        launches += 1

