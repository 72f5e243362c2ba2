"""Meshes and the roofline constants: the port of ``repro.launch.mesh``.

``make_host_mesh`` lays a (data, model) mesh over the initialized
``torch.distributed`` group, one rank a device, row-major as
``jax.make_mesh`` lays its devices; without a group it is one process,
one shard. ``make_production_mesh`` gives the reference's production
shapes, (data 16, model 16) and (pod 2, data 16, model 16), over a group
of 256 or 512 ranks: only the dry run builds one, over the fake process
group (``launch.dryrun``), since no machine here has 256 cards.

The roofline constants are the H100 SXM's, from NVIDIA's H100 Tensor
Core GPU datasheet (SXM5 column): dense bfloat16 989.4 TFLOP/s, HBM3 3.35
TB/s, and NVLink 4 at 900 GB/s both directions, 450 GB/s each way. One
NVLink domain holds 8 GPUs, so a 16-wide model axis spans two nodes,
whose link between them (InfiniBand, 400 Gb/s a GPU) is slower than
NVLink: there the collective term ``bytes / NVLINK_BW`` is a lower
bound.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.device import resolve

# H100 SXM5 (NVIDIA H100 Tensor Core GPU datasheet)
PEAK_FLOPS_BF16 = 989.4e12      # dense, per GPU
HBM_BW = 3.35e12                # B/s per GPU
NVLINK_BW = 450e9               # B/s per GPU, one direction


@dataclass(frozen=True)
class HostMesh:
    """shape: {"data": n, "model": m}; group: the data axis's process group
    (None: this rank's data axis is itself alone); rank: this process's
    coordinate on the data axis; device: where the collective's state
    lives; model: m; model_rank: this process's coordinate on the model
    axis."""

    shape: dict
    group: object
    rank: int
    device: torch.device
    model: int = 1
    model_rank: int = 0


def _world_group():
    return (dist.group.WORLD
            if dist.is_available() and dist.is_initialized() else None)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device=None) -> HostMesh:
    """A (data, model) mesh over the initialized default group. ``data`` is
    clamped to its world size (1 without one) and ``model`` to what is
    left, as the reference clamps both to its device count. With
    ``model`` 1, ``data`` equal to the world size spans the group and
    ``data`` 1 in a larger group leaves each rank a mesh of its own. With
    ``model`` above 1 the group must hold data x model ranks: rank q sits
    at (q // model, q % model), and its data group is the ranks that share
    its model coordinate. ``device`` None means the card."""
    dev = resolve(device)
    group = _world_group()
    world = dist.get_world_size(group) if group is not None else 1
    data = max(1, min(data, world))
    model = max(1, min(model, world // data))
    if model > 1:
        return _model_mesh(data, model, world, dev)
    if data == 1 and world > 1:
        return HostMesh({"data": 1, "model": 1}, None, 0, dev)
    if data != world:
        raise ValueError(f"make_host_mesh: data={data} must be 1 or the "
                         f"group's world size {world}")
    rank = dist.get_rank(group) if group is not None else 0
    return HostMesh({"data": data, "model": 1}, group, rank, dev)


def _model_mesh(data: int, model: int, world: int, dev) -> HostMesh:
    from torch.distributed.device_mesh import init_device_mesh

    if data * model != world:
        raise ValueError(f"make_host_mesh: data={data} x model={model} must "
                         f"be the group's world size {world}")
    dm = init_device_mesh(dev.type, (data, model),
                          mesh_dim_names=("data", "model"))
    q = dist.get_rank()
    return HostMesh({"data": data, "model": model},
                    dm.get_group("data") if data > 1 else None,
                    q // model, dev, model, q % model)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh, (data 16, model 16) or (pod 2,
    data 16, model 16), as a ``dist.sharding.Mesh`` over a ``DeviceMesh``
    of the initialized group, which must hold 256 or 512 ranks. The dry
    run initializes the fake process group for it
    (``launch.dryrun.fake_group``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import sharding as SH

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dm = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    return SH.from_device_mesh(dm)
