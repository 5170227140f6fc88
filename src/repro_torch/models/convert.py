"""Carry a reference parameter tree into the port's modules.

``load_jax_params(model, params)`` takes the tree the JAX package builds
(``init_params(DenseLM(cfg).param_specs(), key)``), as numpy arrays or
anything ``np.asarray`` reads, and copies each leaf into the parameter of
the same path, unstacking the leading layers axis of ``params["layers"]``
into the module list. Layouts are the same in both packages, so each leaf
is a copy, cast to the parameter's type.

``load_jax_cache(model, cache)`` does the same for a reference KV cache
(``init_cache``, ``prefill`` or ``decode_step`` output, either layout): a
port cache on the model's device, each leaf in its ``cache_specs`` type
and ``index`` a host int.
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


@torch.no_grad()
def load_jax_cache(model: nn.Module, cache: dict) -> dict:
    """A port cache holding the reference cache ``cache`` (numpy leaves, or
    anything ``np.asarray`` reads; bf16 leaves go through fp32, which holds
    them exactly). Raises when its keys, shapes or types are not those of
    ``model.cache_specs`` at its batch and length."""
    first = np.asarray(cache["k_q" if "k_q" in cache else "k"])
    B, max_seq = first.shape[1], first.shape[2]
    dtype = torch.bfloat16 if "k_q" in cache else _torch_dtype(first.dtype)
    specs = model.cache_specs(B, max_seq, dtype)
    if set(specs) != set(cache):
        raise KeyError(f"reference cache leaves {sorted(cache)} are not the "
                       f"model's {sorted(specs)}")
    out = {"index": int(np.asarray(cache["index"]))}
    for name, spec in specs.items():
        if name == "index":
            continue
        arr = np.asarray(cache[name])
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"{name}: reference shape {arr.shape} != "
                             f"{tuple(spec.shape)}")
        if _torch_dtype(arr.dtype) != spec.dtype:
            raise ValueError(f"{name}: reference type {arr.dtype}, the "
                             f"model's cache holds {spec.dtype}")
        if spec.dtype == torch.int8:
            t = torch.from_numpy(arr.copy())
        else:
            t = torch.from_numpy(arr.astype(np.float32)).to(spec.dtype)
        out[name] = t.to(model.device)
    return out


def _torch_dtype(np_dtype) -> torch.dtype:
    """The torch type of a reference leaf's numpy type (ml_dtypes'
    bfloat16 by name)."""
    name = np.dtype(np_dtype).name
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16, "int8": torch.int8}[name]
