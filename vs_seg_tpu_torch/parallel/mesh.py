"""The device mesh, the counterpart of vs_seg_tpu/parallel/mesh.py.

JAX's mesh is a named array of devices that one process drives with
shard_map. The port's mesh is an ordered tuple of torch.devices, one per
shard, driven from one process by parallel/collectives.py:run_spmd (a
thread per shard). A device may appear more than once: N shards on one card
run the real multi-shard code and its kernels (a one-GPU machine tests the
N-GPU path that way). NamedSharding and PartitionSpec have no counterpart
in one process.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from vs_seg_tpu_torch.core.device import resolve_device

Mesh = Tuple[torch.device, ...]


def make_mesh(devices: Optional[Sequence] = None, device="cuda") -> Mesh:
    """The shards' devices: `devices` as given (repeats allowed), else every
    visible CUDA device when `device` is a CUDA device, else (cpu,). Each
    device is checked (core/device.py:resolve_device): a missing card is an
    error, never a move to the CPU."""
    if devices is not None:
        mesh = tuple(resolve_device(d) for d in devices)
        if not mesh:
            raise ValueError("a mesh needs at least one device")
        return mesh
    dev = resolve_device(device)
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)


def replicate(model: nn.Module, mesh: Mesh) -> list:
    """One model per shard: `model` itself on the shards of its own device,
    one deep copy per other device (shared by that device's shards)."""
    home = next(model.parameters()).device
    copies = {home: model}
    out = []
    for dev in mesh:
        if dev not in copies:
            copies[dev] = copy.deepcopy(model).to(dev)
        out.append(copies[dev])
    return out

