"""The data mesh and batch placement: the port's counterpart of
scflow_tpu/parallel/mesh.py, with its names.

JAX shards the global batch over a Mesh of every chip and replicates the
parameters; XLA then inserts the collectives.  Here a Mesh lists the torch
devices of one process, and PoseService serves over it: the object rows
split over its devices (batch_sharding), the frames and the weights copied
to each (replicated_sharding, replicate).  A job of several ranks needs no
mesh: each rank holds its local batch on its own card, and the train step
crosses the ranks through parallel/dist.py.
"""

import copy
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """A list of torch devices along one data axis.  A device may appear
    more than once (two shards sharing a card)."""

    def __init__(self, devices: Sequence):
        from scflow_tpu_torch.device import resolve_device

        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices: List[torch.device] = [resolve_device(d) for d in devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of `devices` (names or torch devices) or, without them, of
    every visible card (cuda:0, cuda:1, ...); n_devices keeps the first n.
    Without a card and without devices it raises, as resolve_device does."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())] or [None]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices)


class Sharding(NamedTuple):
    """How an array lies on a mesh: split along its leading axis (one block
    per device, in mesh order) or replicated on every device."""

    mesh: Mesh
    split: bool

    def place(self, array) -> List[torch.Tensor]:
        """The array's blocks (or copies) on the mesh's devices, through
        pinned memory for a card."""
        x = torch.as_tensor(np.ascontiguousarray(array) if isinstance(array, np.ndarray)
                            else array)
        devices = self.mesh.devices
        if not self.split:
            return [to_device(x, d) for d in devices]
        if x.shape[0] % len(devices):
            raise ValueError(f"{x.shape[0]} rows do not split evenly over {len(devices)} "
                             "devices")
        return [to_device(block, d) for block, d in zip(x.chunk(len(devices)), devices)]


def batch_sharding(mesh: Mesh) -> Sharding:
    """Shard along the leading (batch) axis."""
    return Sharding(mesh, True)


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, False)


def to_device(x, device: torch.device) -> torch.Tensor:
    """x as a tensor on `device`: on a card from pinned host memory with a
    non-blocking copy, so the copy queues behind the work already running
    instead of waiting for it."""
    x = torch.as_tensor(x)
    if device.type != "cuda" or x.device == device:
        return x if x.device == device else x.to(device)
    if x.device.type == "cpu":
        x = x.pin_memory()
    return x.to(device, non_blocking=True)


def replicate(module: torch.nn.Module, mesh: Mesh) -> List[torch.nn.Module]:
    """The module's parameters and buffers on each device of the mesh, in its
    order: one copy per distinct device, the module itself where it already
    lies (a device listed twice shares its copy)."""
    copies = {next(module.parameters()).device: module}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = copy.deepcopy(module).to(d)
    return [copies[d] for d in mesh.devices]
