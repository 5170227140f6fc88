"""The train step on one device: grad accumulation, global-norm clipping,
the warm-up-cosine schedule and the optimizer update, the port of
``repro/train/steps.py``.

The state is ``{"params", "opt", "step"}`` as the reference's is:
``params`` maps each parameter name to the model's own ``nn.Parameter``
(the reference's tree, unstacked: ``layers.0.attn.wq``), ``opt`` the
optimizer's fp32 state (AdamW's by the same names, Adafactor's by the
reference's stacked leaves, ``optim.optimizers.stack_groups``), ``step``
a 0-dim int32 CPU tensor. The reference's state is immutable and its step returns a new
one; the port's step updates the model's parameters and the optimizer's
state in place and returns the same dict with ``step`` advanced, so a
failure raised partway through an update leaves the model half-updated
(``runtime.Supervisor`` restores every leaf on a restart).

Grad accumulation: the reference sums ``g.astype(acc) / ga`` over the
microbatches into an accumulator tree, fp32 for fp32-param plans and bf16
for bf16-param ones. The port scales each microbatch's loss by 1/ga and
lets ``.grad`` accumulate in the parameter's own type, which is the same
type, with no second copy of the parameters (at dbrx-132b's size that copy
would not fit). For ga a power of two the scaling is exact and the sums
are the reference's; otherwise the 1/ga rounds into each microbatch's
backward instead of after it, a difference within an ulp of each
microbatch's gradient.

Gradients are on only inside the step (``common.grads_on``), so the same
model serves between steps without recording a graph. A plan that asks
for more than one device (``tp``, ``fsdp``, ``sp``, ``ep``) raises; the
reference's sharding wiring (``state_pspecs``, ``batch_pspecs``,
``to_named``, ``abstract_train_state``) waits with sharding (ROADMAP.md
Queue 1 item 9c-ii).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ParallelPlan, TrainConfig
from repro_torch.models import common as cm
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.optim.compress import clip_by_global_norm
from repro_torch.serve.steps import check_single_device
from repro_torch.train.loss import lm_loss

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _optimizer(model, plan: ParallelPlan, tcfg: TrainConfig):
    """The plan's optimizer over the reference's leaves of ``model``."""
    return make_optimizer(plan.optimizer, tcfg,
                          stacked=getattr(model, "stacked", ()))


def init_train_state(model, plan: ParallelPlan, tcfg: TrainConfig,
                     rng) -> dict:
    """The model's parameters drawn afresh from ``rng`` (a seed or a
    ``torch.Generator``) by the reference's init rule, in place, the
    optimizer's state zeros, step 0. The model must hold its matmul
    weights in the plan's ``param_dtype`` (build it with
    ``param_dtype=``); its norm weights and gate biases stay fp32, as the
    port keeps them."""
    check_single_device(plan)
    want = DTYPES[plan.param_dtype]
    if model.embed.tok.dtype != want:
        raise ValueError(f"the plan's param_dtype is {plan.param_dtype}, the "
                         f"model holds {model.embed.tok.dtype}: build it with "
                         f"param_dtype={want}")
    cm.draw_params(model, rng, model.device)
    params = dict(model.named_parameters())
    opt = _optimizer(model, plan, tcfg).init(params)
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32)}


def split_batch(batch: dict, ga: int) -> list:
    """``ga`` microbatches of consecutive rows: the batch axis is dim 0,
    and dim 1 of ``positions3`` (3, B, S), as the reference splits."""
    if ga <= 1:
        return [batch]
    out = [dict() for _ in range(ga)]
    for key, v in batch.items():
        dim = 1 if key == "positions3" else 0
        if v.shape[dim] % ga:
            raise ValueError(f"{key}: batch {v.shape[dim]} does not split "
                             f"into {ga} microbatches")
        for mb, part in zip(out, torch.chunk(v, ga, dim=dim)):
            mb[key] = part
    return out


def make_train_step(model, plan: ParallelPlan, tcfg: TrainConfig, *,
                    grad_accum: Optional[int] = None):
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradients over ``grad_accum`` (default ``plan.grad_accum``)
    microbatches, the gradients clipped to ``tcfg.grad_clip`` by their
    global norm, the schedule's learning rate at ``state["step"]``, the
    optimizer's update in place. Metrics: ``lm_loss``'s, each the mean
    over the microbatches, with ``grad_norm`` (before the clip) and
    ``lr``, all 0-dim fp32 tensors. A model built with ``attn_impl``
    "pallas" raises: the fused attention op has no backward, in the port
    as in the reference, whose ``jax.grad`` fails on it."""
    check_single_device(plan)
    if model.cfg.attn_impl == "pallas":
        raise ValueError("attn_impl 'pallas' has no backward: build the "
                         "model to train with attn_impl 'auto' or 'xla'")
    optimizer = _optimizer(model, plan, tcfg)
    schedule = warmup_cosine(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)
    ga = grad_accum if grad_accum is not None else plan.grad_accum
    compute_dtype = DTYPES[plan.compute_dtype]

    def compute_grads(params: dict, batch: dict):
        for p in params.values():
            p.grad = None
        per_mb = []
        with cm.grads_on(model):
            for mb in split_batch(batch, ga):
                loss, metrics = lm_loss(model, mb, remat=plan.remat,
                                        compute_dtype=compute_dtype)
                (loss / ga if ga > 1 else loss).backward()
                per_mb.append({k: v.detach() for k, v in metrics.items()})
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        for p in params.values():
            p.grad = None
        metrics = {k: torch.mean(torch.stack([m[k] for m in per_mb]))
                   for k in per_mb[0]}
        return grads, metrics

    def train_step(state: dict, batch: dict):
        grads, metrics = compute_grads(state["params"], batch)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = schedule(state["step"])
        optimizer.update(grads, state["opt"], state["params"], state["step"],
                         lr)
        del grads
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        state["step"] = state["step"] + 1
        return state, metrics

    return train_step
