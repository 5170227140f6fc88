"""Carry a reference parameter tree into the port's modules.

``load_jax_params(model, params)`` takes the tree the JAX package builds
(``init_params(DenseLM(cfg).param_specs(), key)``), as numpy arrays or
anything ``np.asarray`` reads, and copies each leaf into the parameter of
the same path, unstacking the leading layers axis of ``params["layers"]``
into the module list. Layouts are the same in both packages, so each leaf
is a copy, cast to the parameter's type.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _leaves(tree, prefix: str = ""):
    for key, sub in tree.items():
        path = f"{prefix}{key}"
        if isinstance(sub, dict):
            yield from _leaves(sub, path + ".")
        else:
            yield path, sub


@torch.no_grad()
def load_jax_params(model: nn.Module, params: dict) -> nn.Module:
    """Fill ``model`` from the reference tree ``params``; raises when a leaf
    has no parameter, a shape differs, or a parameter is left unfilled."""
    named = dict(model.named_parameters())
    filled = set()

    def put(name, arr):
        p = named.get(name)
        if p is None:
            raise KeyError(f"reference leaf {name!r} has no parameter")
        arr = np.asarray(arr, dtype=np.float32)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {arr.shape} != "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(arr.copy()))
        filled.add(name)

    n_layers = len(model.layers)
    for path, leaf in _leaves(params):
        if path.startswith("layers."):
            arr = np.asarray(leaf, dtype=np.float32)
            if arr.shape[0] != n_layers:
                raise ValueError(f"{path}: {arr.shape[0]} stacked layers, the "
                                 f"model has {n_layers}")
            for i in range(n_layers):
                put(f"layers.{i}.{path[len('layers.'):]}", arr[i])
        else:
            put(path, leaf)
    missing = sorted(set(named) - filled)
    if missing:
        raise KeyError(f"parameters not in the reference tree: {missing}")
    return model
