"""The device mesh that keyed state shards over.

The JAX package's mesh is a ``jax.sharding.Mesh`` over the local
devices with one ``shard`` axis, and its state arrays carry a
``NamedSharding`` over it.  Here a mesh is an ordered list of
``torch.device``s, and a sharded array is a list of per-shard tensors,
shard ``d`` on ``devices[d]``; so ``key_sharding`` and ``replicated``
have no counterpart.  Entries may repeat: a mesh of four shards on one
card is ``[cuda:0] * 4``, each shard's state a block of its own on that
card.  :func:`local_devices` gives ``cuda:0 .. count-1``, the CPU under
``BYTEWAX_TPU_PLATFORM=cpu``, or the platform's device repeated
``BYTEWAX_TPU_VIRTUAL_DEVICES`` times
(:func:`bytewax_tpu_torch.utils.force_cpu_mesh`).
"""

import os
from typing import List, Optional, Sequence

import torch

from bytewax_tpu_torch.utils import VIRTUAL_DEVICES_ENV, device

__all__ = [
    "SHARD_AXIS",
    "Mesh",
    "distributed_is_initialized",
    "local_devices",
    "make_mesh",
]

#: Mesh axis over which keyed state is sharded.
SHARD_AXIS = "shard"


def distributed_is_initialized() -> bool:
    """Whether ``torch.distributed`` is up (only the cluster-wide
    exchange tier, not yet ported, would need it)."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def local_devices() -> List[torch.device]:
    """The devices this process can shard state over.

    ``BYTEWAX_TPU_VIRTUAL_DEVICES=n`` repeats the platform's device
    (:func:`bytewax_tpu_torch.utils.device`) ``n`` times.  Otherwise
    that is ``[cpu]`` under ``BYTEWAX_TPU_PLATFORM=cpu`` and every CUDA
    card, ``cuda:0 .. count-1``, else; with no card this raises, as
    :func:`~bytewax_tpu_torch.utils.device` does."""
    first = device()
    raw = os.environ.get(VIRTUAL_DEVICES_ENV, "")
    if raw:
        try:
            n = int(raw)
        except ValueError:
            n = 0
        if n < 1:
            msg = f"{VIRTUAL_DEVICES_ENV}={raw!r} is not a device count"
            raise ValueError(msg)
        return [first] * n
    if first.type == "cpu":
        return [first]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A 1-D mesh: ``devices[d]`` holds shard ``d``'s block."""

    def __init__(self, devices: Sequence[torch.device]):
        if not devices:
            msg = "a mesh needs at least one device"
            raise ValueError(msg)
        self.devices = [torch.device(d) for d in devices]
        self.shape = {SHARD_AXIS: len(self.devices)}

    def runs(self) -> List[range]:
        """Maximal runs of consecutive shards on one device: the shards
        one kernel call can serve together."""
        out: List[range] = []
        start = 0
        for d in range(1, len(self.devices) + 1):
            if d == len(self.devices) or self.devices[d] != self.devices[start]:
                out.append(range(start, d))
                start = d
        return out

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """Build a 1-D mesh over ``n_devices`` (default: all of
    :func:`local_devices`) with the keyed-state shard axis."""
    if devices is None:
        devices = local_devices()
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices)
