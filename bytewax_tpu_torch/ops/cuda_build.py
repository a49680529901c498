"""Build the port's hand-written CUDA sources and load them.

Every kernel source under ``bytewax_tpu_torch/csrc/`` has a plain C
interface.  :func:`load_library` compiles one with ``nvcc`` for
``sm_90a`` into a shared library under ``bytewax_tpu_torch/_build/``
(named by the source's hash, so an edited source builds anew and an
unchanged one is built once), and loads it with ``ctypes``.  Each
kernel module (:mod:`bytewax_tpu_torch.ops.fold_kernel`,
:mod:`bytewax_tpu_torch.ops.scan_kernel`) calls it at the kernel's
first use and declares the argument types of its entry points.  Two
sources build in parallel from two threads: ``nvcc`` runs as a
subprocess.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

__all__ = ["CSRC", "load_library", "nvcc"]

_PKG = Path(__file__).resolve().parent.parent
#: Where the kernel sources live.
CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"


def nvcc() -> str:
    """The ``nvcc`` on ``PATH``, else under ``CUDA_HOME`` (default
    ``/usr/local/cuda``); raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    msg = (
        "building the port's CUDA kernels needs nvcc (on PATH or under "
        "CUDA_HOME); none was found"
    )
    raise RuntimeError(msg)


def load_library(src: Path, stem: str) -> Tuple[ctypes.CDLL, str]:
    """Compile ``src`` (once per source version) and load it.

    Returns the library and ``nvcc``'s output (its ``-Xptxas -v``
    register report; empty when the library was already built).
    Raises with ``nvcc``'s output if the build fails."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    out = _BUILD_DIR / f"lib{stem}-{digest}.so"
    log = ""
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            nvcc(),
            "-gencode=arch=compute_90a,code=sm_90a",
            "-std=c++17",
            "-O3",
            "-shared",
            "-Xcompiler",
            "-fPIC",
            "-Xptxas",
            "-v",
            "-o",
            str(tmp),
            str(src),
        ]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            msg = f"nvcc failed on {src.name} ({res.returncode}):\n{log}"
            raise RuntimeError(msg)
        os.replace(tmp, out)
    return ctypes.CDLL(str(out)), log
