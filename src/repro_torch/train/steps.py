"""The train step: grad accumulation, global-norm clipping, the
warm-up-cosine schedule and the optimizer update, on one device or over a
mesh of ranks, the port of ``repro/train/steps.py``.

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
model serves between steps without recording a graph.

Over a mesh (``mesh=``, a ``DeviceMesh`` of ``launch.mesh``), the state is
laid out by the plan's rules (``state_pspecs``, ``to_named``): every
parameter and optimizer leaf a DTensor, each rank holding its shard. The
step places each microbatch of the global batch by ``batch_pspecs``, runs
the loss under ``activation_sharding`` (DTensor carries the layouts
through the model as GSPMD does the reference's, and inserts the
collectives), brings each gradient to its parameter's layout (the
reduce-scatter or all-reduce its placements imply), clips by the global
norm (a local sum of squares and one all-reduce) and updates each rank's
shards in place. ``mesh=None`` is the one-device step, unchanged.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.configs.base import ParallelPlan, TrainConfig
from repro_torch.models import common as cm
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.optim.compress import clip_by_global_norm
from repro_torch.sharding import context as sctx
from repro_torch.sharding.place import (distribute_params, draw_sharded,
                                        place, place_tree)
from repro_torch.sharding.spec import (PSpec, Rules, param_pspecs,
                                       placements, rules_for)
from repro_torch.train.loss import lm_loss

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _optimizer(model, plan: ParallelPlan, tcfg: TrainConfig):
    """The plan's optimizer over the reference's leaves of ``model``."""
    return make_optimizer(plan.optimizer, tcfg,
                          stacked=getattr(model, "stacked", ()))


def init_train_state(model, plan: ParallelPlan, tcfg: TrainConfig,
                     rng, mesh=None) -> dict:
    """The model's parameters drawn afresh from ``rng`` (a seed or a
    ``torch.Generator``) by the reference's init rule, in place, the
    optimizer's state zeros, step 0. Over ``mesh`` the same values, laid
    out by the plan's rules: each parameter drawn whole and cut to the
    rank's shard in turn (``sharding.place.draw_sharded``), the
    optimizer's state made as DTensors. The model must hold its matmul
    weights in the plan's ``param_dtype`` (build it with
    ``param_dtype=``); its norm weights and gate biases stay fp32, as the
    port keeps them."""
    want = DTYPES[plan.param_dtype]
    if model.embed.tok.dtype != want:
        raise ValueError(f"the plan's param_dtype is {plan.param_dtype}, the "
                         f"model holds {model.embed.tok.dtype}: build it with "
                         f"param_dtype={want}")
    if mesh is None:
        cm.draw_params(model, rng, model.device)
        params = dict(model.named_parameters())
        opt = _optimizer(model, plan, tcfg).init(params)
        return {"params": params, "opt": opt,
                "step": torch.zeros((), dtype=torch.int32)}
    specs = state_pspecs(model, plan, rules_for(plan, mesh))
    draw_sharded(model, rng, specs["params"], mesh)
    params = dict(model.named_parameters())
    opt = _optimizer(model, plan, tcfg).init(params)
    if plan.optimizer == "adafactor":         # its leaves are the stacked ones
        opt = place_tree(opt, specs["opt"], mesh)
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32)}


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def _stacked_axes(names: list, key: str, params: dict):
    """(axes, shape) of the reference's leaf ``key`` over the port's
    ``names``: a stacked leaf gains the leading ``"layers"``."""
    p = params[names[0]]
    if key == names[0]:
        return p.axes, tuple(p.shape)
    return ("layers",) + p.axes, (len(names),) + tuple(p.shape)


def state_pspecs(model, plan: ParallelPlan, rules: Rules) -> dict:
    """PSpecs of the train state, the reference's ``state_pspecs``: the
    parameters' by the rules, AdamW's ``m`` and ``v`` the same, SGD none,
    Adafactor's by its (stacked) leaves: ``r`` drops the last dim of the
    leaf's spec, ``c`` the second-to-last, a vector's ``v`` keeps it (the
    reference pads the spec to the leaf's rank first and pops no trailing
    None there)."""
    from repro_torch.optim.optimizers import stack_groups
    params = dict(model.named_parameters())
    p_specs = param_pspecs(model, rules)
    if plan.optimizer == "adamw":
        opt = {"m": dict(p_specs), "v": dict(p_specs)}
    elif plan.optimizer == "sgd":
        opt = {}
    else:
        opt = {}
        for key, names in stack_groups(
                params, getattr(model, "stacked", ())).items():
            axes, shape = _stacked_axes(names, key, params)
            ps = rules.pspec(axes, shape)
            if len(shape) < 2:
                opt[key] = {"v": ps}
                continue
            dims = list(ps) + [None] * (len(shape) - len(ps))
            opt[key] = {"r": PSpec(*dims[:-1]),
                        "c": PSpec(*(dims[:-2] + dims[-1:]))}
    return {"params": p_specs, "opt": opt, "step": PSpec()}


def batch_pspecs(input_specs: dict, rules: Rules) -> dict:
    """PSpecs of the model's inputs (name → a shape or a tensor): the batch
    axis at dim 0, at dim 1 of ``positions3`` (3, B, S), divisibility
    checked per shape."""
    out = {}
    for k, v in input_specs.items():
        shape = tuple(v.shape) if hasattr(v, "shape") else tuple(v)
        axes = (None, "batch") if k == "positions3" else ("batch",)
        axes = axes + (None,) * (len(shape) - len(axes))
        out[k] = rules.pspec(axes, shape)
    return out


def to_named(tree, mesh):
    """A tree of PSpecs as the DTensor placements on ``mesh``, the
    counterpart of the reference's ``NamedSharding`` tree."""
    if isinstance(tree, dict):
        return {k: to_named(v, mesh) for k, v in tree.items()}
    return placements(tree, mesh)


def abstract_train_state(model_cfg, plan: ParallelPlan,
                         tcfg: TrainConfig) -> dict:
    """The train state of ``model_cfg``'s model under ``plan`` on the
    ``meta`` device: every leaf's shape and type, nothing allocated."""
    from repro_torch.models.registry import build_model
    model = build_model(model_cfg, param_dtype=DTYPES[plan.param_dtype],
                        device="meta")
    params = dict(model.named_parameters())
    opt = _optimizer(model, plan, tcfg).init(params)
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def shard_train_state(model, plan: ParallelPlan, mesh, state: dict,
                      rules: Optional[Rules] = None) -> dict:
    """``state`` (full tensors, the same on every rank: the model's own
    parameters and an optimizer state over them, or host arrays read
    from a checkpoint) laid out on ``mesh`` by the plan's rules: the
    model's parameters replaced by their DTensors, the optimizer's leaves
    placed. Returns the placed state over the model's new parameters."""
    from repro_torch.dist import rank_device
    rules = rules or rules_for(plan, mesh)
    specs = state_pspecs(model, plan, rules)
    distribute_params(model, specs["params"], mesh, values=state["params"])
    to_dev = lambda t: (t.to(rank_device(), torch.float32)
                        if isinstance(t, torch.Tensor) else t)
    opt = place_tree(_tree_map(to_dev, state["opt"]), specs["opt"], mesh)
    return {"params": dict(model.named_parameters()), "opt": opt,
            "step": torch.as_tensor(state["step"], dtype=torch.int32).cpu()}


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


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def place_batch(batch: dict, rules: Rules, mesh) -> dict:
    """The global ``batch`` (the same plain tensors on every rank) as
    DTensors laid out by ``batch_pspecs``, each rank keeping its rows."""
    specs = batch_pspecs(batch, rules)
    return {k: place(v, specs[k], mesh) for k, v in batch.items()}


def _scalar(x) -> torch.Tensor:
    """A metric as a plain 0-dim tensor (a DTensor gathered first)."""
    return sctx.replicated(x).detach()


def make_train_step(model, plan: ParallelPlan, tcfg: TrainConfig,
                    mesh=None, *, rules: Optional[Rules] = None,
                    grad_accum: Optional[int] = None):
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradients over ``grad_accum`` (default ``plan.grad_accum``)
    microbatches, the gradients clipped to ``tcfg.grad_clip`` by their
    global norm, the schedule's learning rate at ``state["step"]``, the
    optimizer's update in place. Metrics: ``lm_loss``'s, each the mean
    over the microbatches, with ``grad_norm`` (before the clip) and
    ``lr``, all 0-dim fp32 tensors. A model built with ``attn_impl``
    "pallas" raises: the fused attention op has no backward, in the port
    as in the reference, whose ``jax.grad`` fails on it.

    With ``mesh``, the state must be laid out on it by the plan's rules
    (``init_train_state(..., mesh=mesh)`` or ``shard_train_state``) and
    ``batch`` is the global batch, the same on every rank; the metrics
    are the global ones on every rank. ``rules`` default to the plan's
    over the mesh."""
    if model.cfg.attn_impl == "pallas":
        raise ValueError("attn_impl 'pallas' has no backward: build the "
                         "model to train with attn_impl 'auto' or 'xla'")
    if mesh is not None:
        rules = rules or rules_for(plan, mesh)
    optimizer = _optimizer(model, plan, tcfg)
    schedule = warmup_cosine(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)
    ga = grad_accum if grad_accum is not None else plan.grad_accum
    compute_dtype = DTYPES[plan.compute_dtype]

    def backward(mb: dict) -> dict:
        """One microbatch's loss and backward; its metrics."""
        if mesh is not None:
            mb = place_batch(mb, rules, mesh)
        loss, metrics = lm_loss(model, mb, remat=plan.remat,
                                compute_dtype=compute_dtype)
        (loss / ga if ga > 1 else loss).backward()
        return {k: _scalar(v) for k, v in metrics.items()}

    def accumulate(params: dict, microbatches: list) -> list:
        """Each microbatch's loss and backward, ``.grad`` summed; their
        metrics."""
        for p in params.values():
            p.grad = None
        per_mb = []
        # the backward (and remat's recomputation) inside the layout too
        ctx = (sctx.activation_sharding(rules, mesh) if mesh is not None
               else contextlib.nullcontext())
        with cm.grads_on(model), ctx:
            for mb in microbatches:
                per_mb.append(backward(mb))
        return per_mb

    def collect(params: dict, per_mb: list):
        """The summed gradients in their parameters' layouts, ``.grad``
        cleared; the metrics' means over the microbatches."""
        grads = {}
        for n, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if mesh is not None and tuple(g.placements) != tuple(p.placements):
                # the reduction the layout implies: a partial sum over the
                # data ranks reduce-scattered to the parameter's shards
                g = g.redistribute(p.device_mesh, p.placements)
            grads[n] = g
        for p in params.values():
            p.grad = None
        metrics = {k: torch.mean(torch.stack([m[k] for m in per_mb]))
                   for k in per_mb[0]}
        return grads, metrics

    def update(state: dict, grads: dict, metrics: dict):
        """The clip, the schedule and the optimizer's update in place."""
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = schedule(state["step"])
        optimizer.update(grads, state["opt"], state["params"], state["step"],
                         lr)
        del grads
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        state["step"] = state["step"] + 1
        return state, metrics

    def train_step(state: dict, batch: dict):
        per_mb = accumulate(state["params"], split_batch(batch, ga))
        grads, metrics = collect(state["params"], per_mb)
        return update(state, grads, metrics)

    # the step's three parts, for the dry run, which prices one
    # microbatch's backward apart from the once-a-step reduction and update
    train_step.accumulate = accumulate
    train_step.collect = collect
    train_step.update = update
    return train_step
