"""Devices of the data-parallel layer.

Scale-out is utterance-level data parallelism, as in the JAX package's
``parallel/mesh.py``: the batch axis is split over every device of every
process, and the model is replicated, one copy per device (the model is far
below one card's memory). There are no collectives on the hot path.

A ``Mesh`` holds this process's devices and, when ``torch.distributed`` is
initialised, its process group: the processes take contiguous slices of the
global batch in rank order, and each process's devices take contiguous
slices of its slice.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..errors import ERROR_STACK, KoalaInvalidArgumentError, raise_with_stack


class Mesh:
    """This process's devices, and the process group it belongs to (None
    when the program runs as one process)."""

    def __init__(self, devices: Sequence[torch.device], group=None):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        if not self.devices:
            ERROR_STACK.push("a mesh needs at least one device")
            raise_with_stack(KoalaInvalidArgumentError, "Invalid mesh")
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world = dist.get_world_size(group) if group is not None else 1

    @property
    def size(self) -> int:
        """Devices over all processes."""
        return len(self.devices) * self.world

    def local_rows(self, global_batch: int) -> Tuple[int, int]:
        """This process's rows [lo, hi) of a global batch."""
        if global_batch % self.size:
            raise ValueError("global batch %d must divide by mesh size %d"
                             % (global_batch, self.size))
        per = global_batch // self.world
        return self.rank * per, (self.rank + 1) * per

    def __repr__(self) -> str:
        return "Mesh(devices=%s, rank=%d, world=%d)" % (self.devices, self.rank, self.world)


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over this process's ``devices`` (device strings as ``create``
    takes them, or ``torch.device``s), by default every CUDA card; without a
    card that raises ``KoalaInvalidArgumentError``. ``["cpu"] * N`` makes N
    CPU shards. The process group is ``torch.distributed``'s default group
    when it is initialised."""
    if devices is None:
        if not torch.cuda.is_available():
            ERROR_STACK.push("no CUDA card for a mesh; pass devices=['cpu'] to run on the CPU")
            raise_with_stack(KoalaInvalidArgumentError, "Invalid device argument")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [d if isinstance(d, torch.device) else resolve_device(d) for d in devices]
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    return Mesh(devices, group)


def shard_batch(mesh: Mesh, batch) -> List[torch.Tensor]:
    """A global batch [B, ...] (numpy or tensor) -> this process's rows,
    split into one contiguous block per local device, each on its device."""
    lo, hi = mesh.local_rows(batch.shape[0])
    per = (hi - lo) // len(mesh.devices)
    rows = batch[lo:hi]
    if isinstance(rows, np.ndarray):
        rows = torch.from_numpy(np.ascontiguousarray(rows))
    return [rows[i * per:(i + 1) * per].to(d) for i, d in enumerate(mesh.devices)]


def shard_state(mesh: Mesh, state):
    """An engine state tree with the global batch leading every leaf (numpy
    or tensors) -> this process's rows of every leaf (``local_rows``), on the
    mesh's device. For the one-device-a-process mesh that the data-parallel
    layer runs on."""
    if len(mesh.devices) != 1:
        raise ValueError("shard_state: a mesh of one device a process, not %d"
                         % len(mesh.devices))
    if isinstance(state, dict):
        return {k: shard_state(mesh, v) for k, v in state.items()}
    return shard_batch(mesh, state)[0]


def replicate(mesh: Mesh, module: torch.nn.Module) -> List[torch.nn.Module]:
    """One copy of a parameter module on each local device."""
    return [copy.deepcopy(module).to(d) for d in mesh.devices]


__all__ = ["Mesh", "make_mesh", "shard_batch", "shard_state", "replicate"]
