"""The host mesh of the data-parallel collective: the port of
``repro.launch.mesh.make_host_mesh``.

The reference lays a (data, model) mesh over the JAX devices of one
process. Here the data axis is a ``torch.distributed`` process group, one
rank a shard, each rank on its own device; without a group it is one
process, one shard. The model axis is 1: the port has no model-sharded
parameters until ROADMAP item 16.9 ports ``dist/sharding.py``, and
``make_production_mesh`` and the TPU roofline constants come with it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.device import resolve


@dataclass(frozen=True)
class HostMesh:
    """shape: {"data": n, "model": 1}; group: the data axis's process
    group (None: this process alone); rank: this process's shard;
    device: where the collective's state lives."""

    shape: dict
    group: object
    rank: int
    device: torch.device


def _world_group():
    return (dist.group.WORLD
            if dist.is_available() and dist.is_initialized() else None)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device=None) -> HostMesh:
    """A (data, 1) mesh. ``data`` is clamped to the world size of the
    initialized default group (1 without one), as the reference clamps
    it to its device count. ``data`` equal to
    the world size spans the group; ``data`` 1 in a larger group leaves
    each rank a mesh of its own. ``device`` None means the card."""
    if model != 1:
        raise NotImplementedError(
            f"make_host_mesh: model={model}; the port has no model axis "
            f"yet: ROADMAP queue 1, item 16.9 (dist/sharding.py)")
    dev = resolve(device)
    group = _world_group()
    world = dist.get_world_size(group) if group is not None else 1
    data = max(1, min(data, world))
    if data == 1 and world > 1:
        return HostMesh({"data": 1, "model": 1}, None, 0, dev)
    if data != world:
        raise ValueError(f"make_host_mesh: data={data} must be 1 or the "
                         f"group's world size {world}")
    rank = dist.get_rank(group) if group is not None else 0
    return HostMesh({"data": data, "model": 1}, group, rank, dev)
