"""Build, bind and launch the Hopper segmented-scan kernel
(``csrc/segment_scan.cu``).

The card's counterpart of the JAX package's jitted scan programs
(``ops/scan.py`` ``zscore_scan_body`` and ``generic_scan_body``): one
template with three instances, ``welford`` (:class:`~bytewax_tpu_torch.ops.scan.WelfordZScore`),
``ema`` (:class:`~bytewax_tpu_torch.ops.scan.Ema`) and ``extrema``
(:class:`~bytewax_tpu_torch.ops.scan.RunningExtrema`).  The source is
compiled with ``nvcc`` for ``sm_90a`` at first use and loaded with
``ctypes`` (:mod:`bytewax_tpu_torch.ops.cuda_build`).  Nothing is built
when this module is imported.

:func:`scan` is the only way in: it checks device, dtype, contiguity
and shape, allocates the outputs and the workspace, launches on
PyTorch's current stream, raises if a launch fails, and counts calls
in :data:`launches`.  There is no fallback: the CPU path is each kind's
plain version in :mod:`bytewax_tpu_torch.ops.scan`, which
``ScanKind.run`` picks only for CPU tables.
"""

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from bytewax_tpu_torch.ops import cuda_build

__all__ = ["INSTANCES", "build", "launches", "scan"]

#: Instance -> (code in the source, field dtypes, output columns).
INSTANCES = {
    "welford": (0, (torch.int32, torch.float32, torch.float32), 1),
    "ema": (1, (torch.int32, torch.float32), 1),
    "extrema": (2, (torch.float32, torch.float32), 2),
}

_SRC = cuda_build.CSRC / "segment_scan.cu"

#: Kernel calls since import (or since a caller reset it to 0); each
#: call is the kernel's three launches.
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
        lib, build_log = cuda_build.load_library(_SRC, "segment_scan")
        ws = lib.bw_segment_scan_workspace
        ws.argtypes = [ctypes.c_int, ctypes.c_longlong]
        ws.restype = ctypes.c_longlong
        fn = lib.bw_segment_scan
        fn.argtypes = [
            ctypes.c_int,  # kind
            ctypes.c_longlong,  # n
            ctypes.c_longlong,  # capacity
            ctypes.c_void_p,  # slots
            ctypes.c_void_p,  # values
            ctypes.c_void_p,  # field 0
            ctypes.c_void_p,  # field 1
            ctypes.c_void_p,  # field 2
            ctypes.c_void_p,  # output 0
            ctypes.c_void_p,  # output 1
            ctypes.c_float,  # alpha
            ctypes.c_float,  # log_q
            ctypes.c_void_p,  # workspace
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _require(ok: bool, what: str) -> None:
    if not ok:
        msg = f"segment-scan kernel: {what}"
        raise ValueError(msg)


def _check(t, name: str, dev: torch.device, dtype: torch.dtype) -> None:
    if (
        isinstance(t, torch.Tensor)
        and t.device == dev
        and t.dtype == dtype
        and t.dim() == 1
        and t.is_contiguous()
    ):
        return
    _require(isinstance(t, torch.Tensor), f"{name} must be a tensor")
    _require(t.device == dev, f"{name} is on {t.device}, the table on {dev}")
    _require(t.dtype == dtype, f"{name} has dtype {t.dtype}, not {dtype}")
    _require(t.dim() == 1, f"{name} must be 1-D, got {tuple(t.shape)}")
    _require(t.is_contiguous(), f"{name} must be contiguous")


def scan(
    kind, fields: Dict[str, torch.Tensor], slots: torch.Tensor, values: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """One segmented scan of grouped ``(slot, value)`` rows through the
    kernel instance ``kind.kernel``: updates ``fields`` (the kind's
    table, in field order) at each segment's tail, in place, and
    returns the kind's float32 output columns.

    ``slots`` is int32 and grouped (each slot's rows contiguous),
    ``values`` float32, all on one CUDA device."""
    global launches
    _require(kind.kernel in INSTANCES, f"no instance {kind.kernel!r}")
    code, dtypes, n_out = INSTANCES[kind.kernel]
    names = list(kind.fields)
    _require(len(names) == len(dtypes), f"{kind.kernel} takes {len(dtypes)} fields")
    first = fields[names[0]]
    dev = first.device
    _require(dev.type == "cuda", f"the table lies on {dev}, not on a CUDA device")
    capacity = first.shape[0]
    for name, dtype in zip(names, dtypes):
        _check(fields[name], f"fields[{name!r}]", dev, dtype)
        _require(fields[name].shape[0] == capacity, "fields differ in length")
    _check(slots, "slots", dev, torch.int32)
    _check(values, "values", dev, torch.float32)
    n = slots.shape[0]
    _require(values.shape[0] == n, "slots and values differ in length")
    outs = tuple(torch.empty(n, dtype=torch.float32, device=dev) for _ in range(n_out))
    if n == 0:
        return outs
    lib = build()
    workspace = torch.empty(
        lib.bw_segment_scan_workspace(code, n), dtype=torch.uint8, device=dev
    )
    ptrs = [fields[name].data_ptr() for name in names] + [None] * (3 - len(names))
    out_ptrs = [o.data_ptr() for o in outs] + [None] * (2 - n_out)
    alpha, log_q = kind.kernel_params()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(idx):
        err = lib.bw_segment_scan(
            code,
            n,
            capacity,
            slots.data_ptr(),
            values.data_ptr(),
            *ptrs,
            *out_ptrs,
            float(alpha),
            float(log_q),
            workspace.data_ptr(),
            torch._C._cuda_getCurrentRawStream(idx),
        )
    if err != 0:
        msg = f"segment-scan kernel launch failed: CUDA error {err}"
        raise RuntimeError(msg)
    with _lock:
        launches += 1
    return outs
