"""Serving steps: the KV cache, prefill and single-token decode, in bf16 —
the port of ``repro/serve/steps.py``.

On one device (``mesh=None``) the steps run the model as it is. Over a
mesh (a ``DeviceMesh`` of ``launch.mesh``), the model's parameters are
laid out by the plan's rules (``place_model``), the cache by
``cache_pspecs`` (batch × heads, as the reference shards it), each step's
inputs by the batch rule, and the model runs under
``activation_sharding``; the steps return the logits and next tokens
whole on every rank, and the cache stays laid out.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ParallelPlan
from repro_torch.sharding import context as sctx
from repro_torch.sharding.place import distribute_params, place
from repro_torch.sharding.spec import (Rules, cache_pspecs, param_pspecs,
                                       rules_for)

COMPUTE_DTYPE = torch.bfloat16


def place_model(model, plan: ParallelPlan, mesh,
                rules: Optional[Rules] = None):
    """The model's parameters (the same full tensors on every rank) laid
    out on ``mesh`` by the plan's rules, in place. Returns the model."""
    rules = rules or rules_for(plan, mesh)
    return distribute_params(model, param_pspecs(model, rules), mesh)


def init_cache(model, batch_size: int, max_seq: int, dtype=torch.bfloat16,
               device=None, mesh=None, plan: Optional[ParallelPlan] = None,
               rules: Optional[Rules] = None) -> dict:
    """The cache of ``model.cache_specs`` on ``device`` (default: the
    model's), nested as the specs are (an SSM's states), each leaf at its
    start (zeros, ones, or its scalar: the stabilisers' −1e30), its
    ``index`` the host int 0. Over ``mesh``, each leaf laid out by
    ``cache_pspecs`` under the plan's rules (or ``rules``), on the rank's
    device unless ``device`` is given (``meta`` in the dry run)."""
    if mesh is not None:
        from repro_torch.dist import rank_device
        device = device if device is not None else rank_device()
        rules = rules or rules_for(plan, mesh)
        specs = cache_pspecs(model, batch_size, max_seq, rules, dtype)
    device = device if device is not None else model.device

    def build(cspecs, pspecs):
        out = {}
        for name, spec in cspecs.items():
            if isinstance(spec, dict):
                out[name] = build(spec, pspecs and pspecs[name])
            elif name == "index":
                out[name] = 0
            else:
                value = {"zeros": 0.0, "ones": 1.0}.get(spec.init, spec.scale)
                leaf = torch.full(spec.shape, value, dtype=spec.dtype,
                                  device=device)
                out[name] = leaf if mesh is None else place(
                    leaf, pspecs[name], mesh)
        return out

    return build(model.cache_specs(batch_size, max_seq, dtype),
                 specs if mesh is not None else None)


def _placed_inputs(batch: dict, rules: Rules, mesh) -> dict:
    from repro_torch.train.steps import batch_pspecs
    specs = batch_pspecs(batch, rules)
    return {k: place(v, specs[k], mesh) for k, v in batch.items()}


def make_prefill_step(model, plan: Optional[ParallelPlan] = None, mesh=None,
                      *, rules: Optional[Rules] = None):
    """``prefill_step(batch, cache) -> (logits (B, 1, V), new_cache)``: the
    prompt written into the cache, the last position's logits. Over
    ``mesh`` the model and cache must be laid out on it (``place_model``,
    ``init_cache(..., mesh=)``) and ``batch`` is the global batch on every
    rank; the logits come back whole."""
    if mesh is not None:
        rules = rules or rules_for(plan, mesh)

    @torch.no_grad()
    def prefill_step(batch, cache):
        if mesh is None:
            logits, new_cache = model.prefill(batch, cache,
                                              compute_dtype=COMPUTE_DTYPE)
            return logits[:, -1:], new_cache
        with sctx.activation_sharding(rules, mesh):
            logits, new_cache = model.prefill(
                _placed_inputs(batch, rules, mesh), cache,
                compute_dtype=COMPUTE_DTYPE)
            return sctx.replicated(logits[:, -1:]), new_cache

    return prefill_step


def make_decode_step(model, plan: Optional[ParallelPlan] = None, mesh=None,
                     *, rules: Optional[Rules] = None):
    """``decode_step(cache, tokens) -> (next_tok (B, 1) int32, logits,
    new_cache)``, greedy; over ``mesh`` as ``make_prefill_step``.
    ``tokens`` is (B, 1), or the VLM's batch dict (``{"embeds": (B, 1,
    d)}``), as the reference's decode step takes."""
    if mesh is not None:
        rules = rules or rules_for(plan, mesh)

    @torch.no_grad()
    def decode_step(cache, tokens):
        if mesh is None:
            logits, new_cache = model.decode_step(cache, tokens,
                                                  compute_dtype=COMPUTE_DTYPE)
        else:
            with sctx.activation_sharding(rules, mesh):
                if isinstance(tokens, dict):
                    arg = _placed_inputs(tokens, rules, mesh)
                else:
                    arg = _placed_inputs({"tokens": tokens}, rules,
                                         mesh)["tokens"]
                logits, new_cache = model.decode_step(
                    cache, arg, compute_dtype=COMPUTE_DTYPE)
                logits = sctx.replicated(logits)
        next_tok = torch.argmax(logits[:, -1].to(torch.float32), dim=-1)
        return next_tok.to(torch.int32)[:, None], logits, new_cache

    return decode_step
