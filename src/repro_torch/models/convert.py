"""Carry a reference parameter tree into the port's modules.

``load_jax_params(model, params)`` takes the tree the JAX package builds
(``init_params(model.param_specs(), key)``), as numpy arrays or anything
``np.asarray`` reads, and copies each leaf into the parameter of the same
path. The reference stacks each run of like layers along a leading axis;
the model's ``stacked`` names them (``layers``; ``mlstm`` and ``slstm``;
``enc_layers`` and ``dec_layers``; the MoE LM's ``dense_layers`` and
``layers``, not its one ``mtp.layer``), and each is unstacked into the
module list of that name. Layouts are the same in both packages, so each leaf is
a copy, cast to the parameter's type.

``load_jax_cache(model, cache)`` does the same for a reference cache
(``init_cache``, ``prefill`` or ``decode_step`` output, nested as the
model's ``cache_specs``): a port cache on the model's device, each leaf in
its ``cache_specs`` type and ``index`` a host int.

``load_jax_train_state(model, state)`` carries a reference training state
(or a training checkpoint the reference wrote) into the model and an
optimizer state of the port's, unstacked the same way.
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


def _unstacked(model: nn.Module, tree: dict):
    """(port name, fp32 array) of every leaf of a reference tree laid out as
    the model's parameters (its params, or an optimizer's mirror of them),
    each stacked leaf split into its layers' names."""
    stacked = {f"{name}.": len(getattr(model, name))
               for name in getattr(model, "stacked", ("layers",))}
    for path, leaf in _leaves(tree):
        arr = np.asarray(leaf, dtype=np.float32)
        prefix = next((p for p in stacked if path.startswith(p)), None)
        if prefix is None:
            yield path, arr
            continue
        n_layers = stacked[prefix]
        if arr.shape[0] != n_layers:
            raise ValueError(f"{path}: {arr.shape[0]} stacked layers, the "
                             f"model has {n_layers}")
        for i in range(n_layers):
            yield f"{prefix}{i}.{path[len(prefix):]}", arr[i]


def _fill(targets: dict, leaves, what: str) -> None:
    """Copy each (name, array) of ``leaves`` into ``targets[name]`` in
    place; raises when a name has no target, a shape differs, or a target
    is left unfilled."""
    filled = set()
    for name, arr in leaves:
        t = targets.get(name)
        if t is None:
            raise KeyError(f"reference leaf {name!r} has no {what}")
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{name}: reference shape {arr.shape} != "
                             f"{tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.array(arr)))
        filled.add(name)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"{what}s not in the reference tree: {missing}")


@torch.no_grad()
def load_jax_params(model: nn.Module, params: dict) -> nn.Module:
    """Fill ``model`` from the reference tree ``params``; raises when a leaf
    has no parameter, a shape differs, or a parameter is left unfilled."""
    _fill(dict(model.named_parameters()), _unstacked(model, params),
          "parameter")
    return model


def _nested(flat: dict) -> dict:
    """A flat ``a/b/c`` → array dict (a checkpoint's) as nested dicts."""
    out: dict = {}
    for key, arr in flat.items():
        *head, last = key.split("/")
        node = out
        for part in head:
            node = node.setdefault(part, {})
        node[last] = arr
    return out


@torch.no_grad()
def load_jax_train_state(model: nn.Module, state) -> dict:
    """The port's train state (``train.steps``) holding the reference's
    ``state`` ({"params", "opt", "step"}, numpy leaves or anything
    ``np.asarray`` reads), or the training checkpoint at the directory
    ``state`` that the reference's ``CheckpointManager`` wrote (its flat
    ``params/layers/attn/wq`` keys nested back). The parameters are carried
    into ``model`` as ``load_jax_params`` carries them. AdamW's ``m`` and
    ``v`` mirror the parameters and are unstacked the same way;
    Adafactor's state, {"r", "c"} or {"v"} a leaf, keeps the reference's
    stacked leaves under their dotted paths (``layers.attn.wq``), as the
    port's Adafactor factors them; SGD's is empty. The optimizer's state
    is new fp32 tensors on the model's device."""
    if isinstance(state, str):
        from repro_torch.checkpoint.manager import load_arrays
        state = _nested(load_arrays(state))
    load_jax_params(model, state["params"])
    params = dict(model.named_parameters())
    ref_opt = state["opt"]
    device = model.device
    opt = {}
    if set(ref_opt) == {"m", "v"}:           # AdamW: mirrors of the params
        opt = {k: {n: torch.empty(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for n, p in params.items()} for k in ("m", "v")}
        for k in ("m", "v"):
            _fill(opt[k], _unstacked(model, ref_opt[k]), f"AdamW {k} leaf")
    elif ref_opt:                            # Adafactor: the reference's leaves
        leaves = {name: np.asarray(arr, dtype=np.float32)
                  for name, arr in _leaves(ref_opt)}
        for name, arr in leaves.items():
            key, kind = name.rsplit(".", 1)
            opt.setdefault(key, {})[kind] = torch.empty(
                arr.shape, dtype=torch.float32, device=device)
        _fill({f"{key}.{kind}": t for key, leaf in opt.items()
               for kind, t in leaf.items()}, leaves.items(),
              "Adafactor leaf")
    step = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32)
    return {"params": params, "opt": opt, "step": step}


@torch.no_grad()
def load_jax_cache(model: nn.Module, cache: dict) -> dict:
    """A port cache holding the reference cache ``cache`` (numpy leaves, or
    anything ``np.asarray`` reads; bf16 leaves go through fp32, which holds
    them exactly). The batch and length are read from the cache (whisper's
    from its cross keys, the encoder's length) and its keys, shapes and
    types must be those of ``model.cache_specs`` there, except that a
    bf16 leaf of ``COMPUTE_TYPED`` is taken where the spec holds fp32,
    which holds it exactly."""
    B, max_seq, dtype = _geometry(cache)
    out = _carried(model.cache_specs(B, max_seq, dtype), cache, model.device)
    out["index"] = int(np.asarray(cache["index"]))
    return out


def _geometry(cache: dict) -> tuple:
    """(batch, length, type) of a reference cache: from its cross keys, its
    keys (an MoE cache's under ``kv``: GQA's k, MLA's c_kv), or (an SSM's
    states, which have no length) its first leaf."""
    for tree in (cache, cache.get("kv", {})):
        for name in ("cross_k", "k", "k_q", "c_kv"):
            if name in tree:
                arr = np.asarray(tree[name])
                dtype = torch.bfloat16 if name == "k_q" else \
                    _torch_dtype(arr.dtype)
                return arr.shape[1], arr.shape[2], dtype
    first = next(leaf for _, leaf in _leaves(cache) if np.ndim(leaf) > 1)
    return np.shape(first)[1], 1, torch.bfloat16


# leaves that the reference returns in the compute type where its cache
# spec holds fp32: the xLSTM's mLSTM conv states
COMPUTE_TYPED = frozenset({"m_state.conv"})


def _carried(specs: dict, cache: dict, device, path: str = "") -> dict:
    if set(specs) != set(cache):
        raise KeyError(f"reference cache leaves {sorted(cache)} at "
                       f"{path or 'the top'} are not the model's "
                       f"{sorted(specs)}")
    out = {}
    for name, spec in specs.items():
        if name == "index" and not path:
            continue
        if isinstance(spec, dict):
            out[name] = _carried(spec, cache[name], device, f"{path}{name}.")
            continue
        arr = np.asarray(cache[name])
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"{path}{name}: reference shape {arr.shape} != "
                             f"{tuple(spec.shape)}")
        got = _torch_dtype(arr.dtype)
        if got != spec.dtype and not (f"{path}{name}" in COMPUTE_TYPED
                                      and got == torch.bfloat16
                                      and spec.dtype == torch.float32):
            raise ValueError(f"{path}{name}: reference type {arr.dtype}, the "
                             f"model's cache holds {spec.dtype}")
        if spec.dtype == torch.int8:
            t = torch.from_numpy(arr.copy())
        else:
            t = torch.from_numpy(arr.astype(np.float32)).to(spec.dtype)
        out[name] = t.to(device)
    return out


def _torch_dtype(np_dtype) -> torch.dtype:
    """The torch type of a reference leaf's numpy type (ml_dtypes'
    bfloat16 by name)."""
    name = np.dtype(np_dtype).name
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16, "int8": torch.int8}[name]
