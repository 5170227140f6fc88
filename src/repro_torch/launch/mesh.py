"""Meshes over the current process group: the port of
``repro/launch/mesh.py``. Functions, so importing it touches no device."""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production meshes over the current process group:
    one pod 16 × 16 = 256 ranks (data, model); two pods 2 × 16 × 16 = 512
    (pod, data, model). The dry run builds them over PyTorch's ``fake``
    process group of that many ranks in one process."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def mesh_device_type() -> str:
    """The device type the ranks compute on: ``cuda`` where the process
    group's default device is a card, else ``cpu``."""
    from repro_torch.dist import rank_device
    return rank_device().type


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0):
    """A ``DeviceMesh`` of shape (data, model), or (pod, data, model), with
    the reference's axis names, over the ranks of the default process
    group in order. Raises when the group's size is not the product."""
    shape = (pod, data, model) if pod else (data, model)
    names = ("pod", "data", "model") if pod else ("data", "model")
    return make_mesh(shape, names)


def make_mesh(shape, names):
    """A ``DeviceMesh`` of ``shape`` with dim ``names`` (e.g. ``(4,)``,
    ``("stage",)``) over the ranks of the default process group in order;
    raises when the group's size is not the product."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != n:
        raise ValueError(f"a {dict(zip(names, shape))} mesh takes {n} ranks; "
                         f"the process group has {world or 'none'}")
    return DeviceMesh(mesh_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(names))
