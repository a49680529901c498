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

Across processes (``BYTEWAX_TPU_DISTRIBUTED=1``) the JAX package's
global mesh spans ``jax.devices()``.  Here :func:`init_world` joins
``torch.distributed`` (gloo) once a process, gathers every process's
device identities, and picks the transport of the cluster-wide exchange
(:class:`World`): NCCL where every shard of every process sits on a card
of its own, else gloo, staged through pinned host memory where the
shards lie on cards.
"""

import os
from datetime import timedelta
from typing import List, Optional, Sequence

import torch

from bytewax_tpu_torch.utils import VIRTUAL_DEVICES_ENV, device

__all__ = [
    "SHARD_AXIS",
    "Mesh",
    "World",
    "distributed_is_initialized",
    "init_world",
    "local_devices",
    "make_mesh",
    "world",
]

#: Mesh axis over which keyed state is sharded.
SHARD_AXIS = "shard"


def distributed_is_initialized() -> bool:
    """Whether ``torch.distributed`` is up (the cluster-wide exchange
    tier needs it; :func:`init_world` brings it up)."""
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


class World:
    """The processes of a ``torch.distributed`` run, their devices, and
    the transport of the cluster-wide exchange.

    ``devices[p]`` is process ``p``'s list of device identities (a
    card's UUID, ``cpu``), or None where that process has no usable
    device; ``local`` is this process's devices.  ``transport`` is
    ``nccl`` where every entry of every list is a distinct card, else
    ``gloo``; ``staged`` says that gloo's buffers cross pinned host
    memory (this process's shards lie on a card); ``reason`` says why,
    in words; ``group`` is the NCCL group (None for gloo, which runs on
    the default group).  Every process derives the same transport from
    the same gathered lists, once, and keeps it for the run."""

    def __init__(self, proc_id, proc_count, local, devices, transport, staged, reason, group):
        self.proc_id = proc_id
        self.proc_count = proc_count
        self.local = local
        self.devices = devices
        self.transport = transport
        self.staged = staged
        self.reason = reason
        self.group = group

    def describe(self) -> str:
        """The transport in a few words, as the tier's debug line and
        ``chip_smoke.py`` print it."""
        how = self.transport + (" staged through pinned host memory" if self.staged else "")
        return f"{how} ({self.reason})"


_WORLD: Optional[World] = None


def world() -> Optional[World]:
    """This process's :class:`World`, None before :func:`init_world`."""
    return _WORLD


def _identity(dev: torch.device) -> str:
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        return f"cuda:{torch.cuda.get_device_properties(index).uuid}"
    return dev.type


def _transport(devices: List[Optional[List[str]]]):
    """``(transport, reason)`` from every process's device identities."""
    flat = [d for ds in devices for d in (ds or [None])]
    if any(d is None for d in flat):
        return "gloo", "a process has no usable device"
    if not all(d.startswith("cuda:") for d in flat):
        return "gloo", "the shards lie on the CPU"
    if len(set(flat)) < len(flat):
        return "gloo", "processes share a card"
    return "nccl", "every shard on a card of its own"


def init_world(proc_id: int, proc_count: int, coordinator: str, timeout_s: float) -> World:
    """Join ``torch.distributed`` and gather the cluster's devices.

    Every process of the cluster calls this at start-up, in the same
    order: ``init_process_group("gloo")`` at ``tcp://coordinator`` (rank
    ``proc_id`` of ``proc_count``; a peer that never joins fails the
    call after ``timeout_s``), one ``all_gather_object`` of the device
    identities of :func:`local_devices` (None where this process has no
    card and was not asked for the CPU), and, where every shard sits on
    a card of its own, one NCCL group (``new_group``, collective too).
    The world size is fixed from then on; a second call returns the
    same :class:`World`.  A failure of NCCL raises: it never falls back
    to gloo."""
    global _WORLD
    import torch.distributed as dist

    if _WORLD is not None:
        return _WORLD
    timeout = timedelta(seconds=timeout_s)
    if not distributed_is_initialized():
        dist.init_process_group(
            "gloo",
            init_method=f"tcp://{coordinator}",
            rank=proc_id,
            world_size=proc_count,
            timeout=timeout,
        )
    try:
        local: Optional[List[torch.device]] = local_devices()
    except RuntimeError:  # no card, and the CPU was not asked for
        local = None
    mine = None if local is None else [_identity(d) for d in local]
    devices: List[Optional[List[str]]] = [None] * proc_count
    dist.all_gather_object(devices, mine)
    transport, reason = _transport(devices)
    group = None
    if transport == "nccl":
        torch.cuda.set_device(local[0])
        group = dist.new_group(backend="nccl", timeout=timeout)
    staged = transport == "gloo" and local is not None and local[0].type == "cuda"
    _WORLD = World(proc_id, proc_count, local, devices, transport, staged, reason, group)
    return _WORLD
