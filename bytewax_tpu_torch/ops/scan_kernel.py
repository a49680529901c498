"""Build, bind and launch the Hopper segmented-scan kernel
(``csrc/segment_scan.cu``).

The card's counterpart of the JAX package's jitted scan programs
(``ops/scan.py`` ``zscore_scan_body`` and ``generic_scan_body``): one
template with three instances, ``welford`` (:class:`~bytewax_tpu_torch.ops.scan.WelfordZScore`),
``ema`` (:class:`~bytewax_tpu_torch.ops.scan.Ema`) and ``extrema``
(:class:`~bytewax_tpu_torch.ops.scan.RunningExtrema`), each a single-pass
scan with decoupled look-back: one launch a call.  The source is
compiled with ``nvcc`` for ``sm_90a`` at first use and loaded with
``ctypes`` (:mod:`bytewax_tpu_torch.ops.cuda_build`).  Nothing is built
when this module is imported.

:func:`scan` is the only way in: it checks device, dtype, contiguity
and shape, allocates the outputs, launches on PyTorch's current stream,
raises if the launch fails, and counts calls in :data:`launches`.  There
is no fallback: the CPU path is each kind's plain version in
:mod:`bytewax_tpu_torch.ops.scan`, which ``ScanKind.run`` picks only for
CPU tables.

The kernel's workspace (a tile counter, the call's sequence number and
each tile's status word and payloads) stays with the device: one zeroed
buffer a device, grown when a call needs more, never cleared between
calls.  The engine issues every call on one stream, where calls run in
order.  Calls issued on a second stream that may run at the same time
would each need a workspace of their own (the cache keyed by stream as
well as device): two calls running at once on one workspace would claim
each other's tiles.
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
#: The least rows a new workspace serves (about 37 KB at 2^20 rows).
_MIN_WORKSPACE_ROWS = 1 << 20

#: Kernel calls since import (or since a caller reset it to 0); each
#: call is one launch.
launches = 0
#: ``nvcc``'s output from the build (``-Xptxas -v`` register report).
build_log = ""

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: Device index -> (zeroed workspace, rows it serves).
_workspaces: Dict[int, Tuple[torch.Tensor, int]] = {}


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
            ctypes.c_int,  # device
        ]
        fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _require(ok: bool, what: str) -> None:
    if not ok:
        msg = f"segment-scan kernel: {what}"
        raise ValueError(msg)


def _check(t, name: str, idx: int, dtype: torch.dtype) -> None:
    # The messages are formatted only on failure: this runs five times
    # a call.
    if (
        isinstance(t, torch.Tensor)
        and t.get_device() == idx
        and t.dtype is dtype
        and t.dim() == 1
        and t.is_contiguous()
    ):
        return
    _require(isinstance(t, torch.Tensor), f"{name} must be a tensor")
    _require(t.get_device() == idx, f"{name} is on {t.device}, the table on cuda:{idx}")
    _require(t.dtype == dtype, f"{name} has dtype {t.dtype}, not {dtype}")
    _require(t.dim() == 1, f"{name} must be 1-D, got {tuple(t.shape)}")
    _require(t.is_contiguous(), f"{name} must be contiguous")


def _workspace(lib: ctypes.CDLL, code: int, n: int, dev: torch.device) -> torch.Tensor:
    """The device's workspace, grown (zeroed) if it serves fewer than
    ``n`` rows (:func:`scan` reads a big enough one itself)."""
    with _lock:
        held = _workspaces.get(dev.index)
        if held is None or held[1] < n:
            rows = max(n, _MIN_WORKSPACE_ROWS, 2 * held[1] if held else 0)
            nbytes = lib.bw_segment_scan_workspace(code, rows)
            held = (torch.zeros(nbytes, dtype=torch.uint8, device=dev), rows)
            _workspaces[dev.index] = held
        return held[0]


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
    instance = INSTANCES.get(kind.kernel)
    _require(instance is not None, f"no instance {kind.kernel!r}")
    code, dtypes, n_out = instance
    names = kind.fields
    _require(len(names) == len(dtypes), f"{kind.kernel} takes {len(dtypes)} fields")
    ptrs = [None, None, None]
    for k, (name, dtype) in enumerate(zip(names, dtypes)):
        field = fields[name]
        if k == 0:
            _require(field.is_cuda, f"the table lies on {field.device}, not on a CUDA device")
            idx = field.get_device()
            capacity = field.shape[0]
        _check(field, f"fields[{name!r}]", idx, dtype)
        _require(field.shape[0] == capacity, "fields differ in length")
        ptrs[k] = field.data_ptr()
    _check(slots, "slots", idx, torch.int32)
    _check(values, "values", idx, torch.float32)
    n = slots.shape[0]
    _require(values.shape[0] == n, "slots and values differ in length")
    dev = slots.device
    out = torch.empty(n, dtype=torch.float32, device=dev)
    out1 = torch.empty(n, dtype=torch.float32, device=dev) if n_out > 1 else None
    outs = (out,) if out1 is None else (out, out1)
    if n == 0:
        return outs
    lib = _lib if _lib is not None else build()
    held = _workspaces.get(idx)
    workspace = held[0] if held is not None and held[1] >= n else _workspace(lib, code, n, dev)
    alpha, log_q = kind.kernel_params()
    err = lib.bw_segment_scan(
        code,
        n,
        capacity,
        slots.data_ptr(),
        values.data_ptr(),
        *ptrs,
        out.data_ptr(),
        None if out1 is None else out1.data_ptr(),
        alpha,
        log_q,
        workspace.data_ptr(),
        torch._C._cuda_getCurrentRawStream(idx),
        idx,
    )
    if err != 0:
        msg = f"segment-scan kernel launch failed: CUDA error {err}"
        raise RuntimeError(msg)
    with _lock:
        launches += 1
    return outs
