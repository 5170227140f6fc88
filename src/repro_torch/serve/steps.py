"""Serving steps on one device: the KV cache, prefill and single-token
decode, in bf16 — the port of ``repro/serve/steps.py``.

The reference wires these for a production mesh (``Rules``, a sharded
cache, ``activation_sharding``). The port runs one device, so a
``ParallelPlan`` that asks for more than one (``tp``, ``fsdp``, ``sp``,
``ep``) raises; sharding is ROADMAP.md Queue 1 item 9.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ParallelPlan

COMPUTE_DTYPE = torch.bfloat16


def check_single_device(plan: Optional[ParallelPlan]) -> None:
    """Raise unless ``plan`` (None: one device) runs on one device."""
    if plan is None:
        return
    asked = [a for a in ("tp", "fsdp", "sp", "ep") if getattr(plan, a)]
    if asked:
        raise NotImplementedError(
            f"ParallelPlan({', '.join(f'{a}=True' for a in asked)}): the "
            "port serves on one device; sharding is not ported yet "
            "(ROADMAP.md Queue 1 item 9)")


def init_cache(model, batch_size: int, max_seq: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """The cache of ``model.cache_specs`` on ``device`` (default: the
    model's), nested as the specs are (an SSM's states), each leaf at its
    start (zeros, ones, or its scalar: the stabilisers' −1e30), its
    ``index`` the host int 0."""
    device = device if device is not None else model.device

    def build(specs):
        out = {}
        for name, spec in specs.items():
            if isinstance(spec, dict):
                out[name] = build(spec)
            elif name == "index":
                out[name] = 0
            else:
                value = {"zeros": 0.0, "ones": 1.0}.get(spec.init, spec.scale)
                out[name] = torch.full(spec.shape, value, dtype=spec.dtype,
                                       device=device)
        return out

    return build(model.cache_specs(batch_size, max_seq, dtype))


def make_prefill_step(model, plan: Optional[ParallelPlan] = None):
    """``prefill_step(batch, cache) -> (logits (B, 1, V), new_cache)``: the
    prompt written into the cache, the last position's logits."""
    check_single_device(plan)

    @torch.no_grad()
    def prefill_step(batch, cache):
        logits, new_cache = model.prefill(batch, cache,
                                          compute_dtype=COMPUTE_DTYPE)
        return logits[:, -1:], new_cache

    return prefill_step


def make_decode_step(model, plan: Optional[ParallelPlan] = None):
    """``decode_step(cache, tokens) -> (next_tok (B, 1) int32, logits,
    new_cache)``, greedy."""
    check_single_device(plan)

    @torch.no_grad()
    def decode_step(cache, tokens):
        logits, new_cache = model.decode_step(cache, tokens,
                                              compute_dtype=COMPUTE_DTYPE)
        next_tok = torch.argmax(logits[:, -1].to(torch.float32), dim=-1)
        return next_tok.to(torch.int32)[:, None], logits, new_cache

    return decode_step
