"""Place a model's parameters and a tree of tensors on a mesh by the rules,
and bring them back as full tensors.

A parameter becomes an ``nn.Parameter`` over a DTensor with the
placements of its rule (``spec.placements``), keeping the attributes the
port reads from it (``init``, ``scale``, ``by_slice``, ``axes``). Every
rank holds the same full tensors before the call (the same seed, or the
same host arrays), so placing needs no collective: each rank keeps its
own shard.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.sharding.spec import placements

_ATTRS = ("init", "scale", "by_slice", "axes")


def place(t: torch.Tensor, spec, mesh):
    """The DTensor of ``t`` (the same full tensor on every rank) laid out
    by ``spec`` on ``mesh``, each rank keeping its shard."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t.detach(), mesh, placements(spec, mesh),
                             src_data_rank=None)


@torch.no_grad()
def distribute_params(model: nn.Module, pspecs: dict, mesh,
                      values: dict = None) -> nn.Module:
    """Every parameter of ``model`` replaced, in place, by its DTensor laid
    out by ``pspecs[name]``, of its own value or of ``values[name]`` (a full
    tensor, cast to the parameter's type; the model may then be on
    ``meta``); the full tensors are freed as they go."""
    from repro_torch.dist import rank_device
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        full = p.data if values is None else values[name].to(
            rank_device(), p.dtype)
        new = nn.Parameter(place(full, pspecs[name], mesh),
                           requires_grad=p.requires_grad)
        for a in _ATTRS:
            if hasattr(p, a):
                setattr(new, a, getattr(p, a))
        setattr(mod, leaf, new)
    return model


@torch.no_grad()
def draw_sharded(model: nn.Module, rng, pspecs: dict, mesh) -> nn.Module:
    """The model's parameters drawn by their init rule from ``rng`` in the
    order ``models.common.draw_params`` draws them, so the values are the
    one-device model's, each made whole on the rank's device, drawn, and
    replaced by its DTensor laid out by ``pspecs[name]`` before the next
    is made: at most one whole parameter at a time. The model may be
    built on ``meta``."""
    from repro_torch.device import make_generator
    from repro_torch.dist import rank_device
    from repro_torch.models.common import init_leaf
    device = rank_device()
    g = make_generator(rng, device)
    for name, p in list(model.named_parameters()):
        full = torch.empty(tuple(p.shape), dtype=p.dtype, device=device)
        for a in _ATTRS:
            if hasattr(p, a):
                setattr(full, a, getattr(p, a))
        init_leaf(full, g)
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        new = nn.Parameter(place(full, pspecs[name], mesh),
                           requires_grad=False)
        for a in _ATTRS:
            if hasattr(p, a):
                setattr(new, a, getattr(p, a))
        setattr(mod, leaf, new)
        del full
    return model


def place_tree(tree, specs, mesh):
    """A nested dict of full tensors placed leaf by leaf by the same-shaped
    dict of specs; other leaves (ints) pass through."""
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return place(tree, specs, mesh)
    return tree


def full_tree(tree):
    """A nested dict with every DTensor leaf gathered to its full tensor
    (a collective: every rank calls it)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    return tree
