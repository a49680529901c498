"""Small shared helpers, and the port's device selection."""

import os
from typing import Callable, Iterable, List, Tuple, TypeVar

X = TypeVar("X")

__all__ = [
    "PLATFORMS",
    "VIRTUAL_DEVICES_ENV",
    "device",
    "force_cpu_mesh",
    "force_platform",
    "partition",
]

#: Accepted values of ``BYTEWAX_TPU_PLATFORM`` (unset means ``cuda``).
PLATFORMS = ("cpu", "cuda", "gpu")
#: The variable that asks for a mesh of one repeated device (read by
#: :func:`bytewax_tpu_torch.parallel.mesh.local_devices` alone).
VIRTUAL_DEVICES_ENV = "BYTEWAX_TPU_VIRTUAL_DEVICES"


def _check(platform: str) -> None:
    if platform not in PLATFORMS:
        msg = (
            f"BYTEWAX_TPU_PLATFORM={platform!r} is not a platform the "
            f"torch port runs on; use one of {PLATFORMS}"
        )
        raise ValueError(msg)


def force_platform(platform: str) -> None:
    """Select the torch device that the device tier builds its state
    on, by setting ``BYTEWAX_TPU_PLATFORM`` — the variable the driver
    reads at startup.

    ``cpu`` runs the device tier's tensors on the CPU through each
    kernel's plain PyTorch version (what the tests ask for);
    ``cuda``/``gpu`` (or leaving the variable unset) runs it on
    ``cuda:0`` through the hand-written kernels.
    """
    _check(platform)
    os.environ["BYTEWAX_TPU_PLATFORM"] = platform


def force_cpu_mesh(n_devices: int) -> None:
    """Run the device tier on the CPU over a mesh of ``n_devices``
    entries, all the CPU: the counterpart of the JAX package's function
    of this name, which gives jax that many virtual CPU devices.

    Sets ``BYTEWAX_TPU_PLATFORM=cpu`` and ``BYTEWAX_TPU_VIRTUAL_DEVICES``
    (the platform's device, repeated ``n_devices`` times; with the
    platform left on ``cuda`` the same variable repeats ``cuda:0``).
    Keyed state then shards over that many entries under
    ``BYTEWAX_TPU_SHARD=auto`` (the default)."""
    if n_devices < 1:
        msg = f"a mesh needs at least one device, not {n_devices}"
        raise ValueError(msg)
    force_platform("cpu")
    os.environ[VIRTUAL_DEVICES_ENV] = str(n_devices)


def device():
    """The ``torch.device`` the device tier runs on.

    With ``BYTEWAX_TPU_PLATFORM`` unset (or ``cuda``/``gpu``) that is
    ``cuda:0``, and a process without a usable CUDA card raises here:
    the device tier never carries on silently on the CPU.  Only
    ``BYTEWAX_TPU_PLATFORM=cpu`` selects the CPU.
    """
    import torch

    platform = os.environ.get("BYTEWAX_TPU_PLATFORM") or "cuda"
    _check(platform)
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        msg = (
            "the device tier runs on cuda:0, but torch finds no CUDA "
            "device; set BYTEWAX_TPU_PLATFORM=cpu to run it on the CPU "
            "or BYTEWAX_TPU_ACCEL=0 to run the host tier only"
        )
        raise RuntimeError(msg)
    return torch.device("cuda", 0)


def partition(
    xs: Iterable[X], pred: Callable[[X], bool]
) -> Tuple[List[X], List[X]]:
    """Split an iterable into (matching, not-matching) lists, keeping
    order."""
    trues: List[X] = []
    falses: List[X] = []
    for x in xs:
        if pred(x):
            trues.append(x)
        else:
            falses.append(x)
    return trues, falses
