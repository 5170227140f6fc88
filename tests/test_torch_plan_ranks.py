"""Rank bodies for ``tests/test_torch_plans.py`` and the card tests: each
runs inside a rank process started by ``repro_torch.dist.spawn`` (a gloo
group, on the CPU or on one card), imports nothing of JAX, and returns
host tensors from rank 0. No tests here."""
import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import TrainConfig, get_arch
from repro_torch.configs.base import ParallelPlan
from repro_torch.dist import rank_device
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import build_model
from repro_torch.sharding.place import full_tree

TCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def host(tree):
    """A state tree's tensors as CPU copies (gathered first, on every
    rank): later in-place updates do not reach them."""
    tree = full_tree(tree)
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    return (tree.detach().cpu().clone() if isinstance(tree, torch.Tensor)
            else tree)


@contextlib.contextmanager
def one_rank_group(store_dir: str):
    """A gloo group of one rank (this process) on the CPU for the block, and
    its (1, 1) mesh; destroyed on the way out."""
    import os
    from repro_torch.dist import init_rank
    os.makedirs(store_dir, exist_ok=True)
    init_rank(0, 1, store_dir, "cpu")
    try:
        yield make_host_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def gather_objects(obj):
    """Every rank's ``obj``, in rank order, on every rank."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------


def train_step(ref_state: dict, plan: dict, batch: dict, shape=(2, 2)):
    """qwen2.5-14b SMOKE from the reference's state, one step of ``plan``
    over a ``shape`` mesh: (the state, gathered; the metrics)."""
    from repro_torch.models.convert import load_jax_train_state
    from repro_torch.train.steps import make_train_step, shard_train_state
    plan = ParallelPlan(**plan)
    mesh = make_host_mesh(*shape)
    model = build_model(get_arch("qwen2.5-14b").smoke, device=rank_device())
    state = shard_train_state(model, plan, mesh,
                              load_jax_train_state(model, ref_state))
    step = make_train_step(model, plan, TrainConfig(**TCFG), mesh)
    state, metrics = step(state, {k: torch.from_numpy(v).to(rank_device())
                                  for k, v in batch.items()})
    return host({"params": dict(state["params"]), "opt": state["opt"],
                 "step": state["step"]}), {k: float(v)
                                           for k, v in metrics.items()}


def ep_layer(weights: dict, x: np.ndarray, shape=(2, 2)):
    """dbrx-132b SMOKE's MoE layer with the reference's weights, under its
    plan (``ep``) over a ``shape`` mesh, fp32: (the output, whole; every
    rank's dispatch decisions, (expert ids, kept) a call)."""
    from repro_torch.models import moe
    from repro_torch.sharding import context as sctx
    from repro_torch.sharding.spec import param_pspecs, rules_for
    from repro_torch.sharding.place import distribute_params
    cfg = get_arch("dbrx-132b").smoke
    layer = moe.MoE(cfg, torch.float32, rank_device())
    with torch.no_grad():
        for n, p in layer.named_parameters():
            p.copy_(torch.from_numpy(weights[n]))
    mesh = make_host_mesh(*shape)
    rules = rules_for(get_arch("dbrx-132b").plan, mesh)
    distribute_params(layer, param_pspecs(layer, rules), mesh)
    seen = []
    real = moe.dispatch_indices

    def spy(expert_ids, E, cap):
        dest, order, keep = real(expert_ids, E, cap)
        seen.append((expert_ids.cpu().numpy(), keep.cpu().numpy(), cap))
        return dest, order, keep

    moe.dispatch_indices = spy
    try:
        with torch.no_grad(), sctx.activation_sharding(rules, mesh):
            out, aux = layer(sctx.shard_act(
                torch.from_numpy(x).to(rank_device())), torch.float32)
            out = out.full_tensor().cpu()
    finally:
        moe.dispatch_indices = real
    return out, gather_objects(seen)


def pipeline(W: np.ndarray, x: np.ndarray, n_stages: int = 4):
    """``pipeline_apply`` of the reference's test (tanh(x @ w) per layer)
    over ``n_stages`` stage ranks: (outputs, the gradient of sum(y²) in W,
    each stage's slice summed over the ranks)."""
    from repro_torch.train.pipeline import pipeline_apply, split_stages
    mesh = make_mesh((n_stages,), ("stage",))
    Wt = torch.from_numpy(W).to(rank_device()).requires_grad_(True)

    def stage_fn(w_group, xm):
        for i in range(w_group.shape[0]):
            xm = torch.tanh(xm @ w_group[i])
        return xm

    y = pipeline_apply(stage_fn, split_stages(Wt, n_stages),
                       torch.from_numpy(x).to(rank_device()), mesh)
    torch.sum(y ** 2).backward()
    g = Wt.grad.clone()
    dist.all_reduce(g)
    return y.detach().cpu(), g.cpu()


def xlstm_run(ckpt_dir: str, steps: range, prefer_model: int = 2):
    """xlstm-350m SMOKE under its plan (grad accumulation 1, fp32) on
    ``make_elastic_mesh``: resume from the latest checkpoint in
    ``ckpt_dir`` (its state, as restored and laid out, gathered back), run
    ``steps``, checkpoint. Returns (mesh shape, the restored state or
    None, the losses, the final state gathered)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.runtime.elastic import (make_elastic_mesh,
                                             restore_sharded, save_sharded)
    from repro_torch.train.steps import init_train_state, make_train_step
    entry = get_arch("xlstm-350m")
    plan = dataclasses.replace(entry.plan, grad_accum=1,
                               param_dtype="float32")
    tcfg = TrainConfig(total_steps=12, lr=1e-3, warmup_steps=2)
    mesh = make_elastic_mesh(prefer_model=prefer_model)
    model = build_model(entry.smoke, device="meta")
    state = init_train_state(model, plan, tcfg, 0, mesh=mesh)
    ckpt = CheckpointManager(ckpt_dir, keep=2, async_save=False)
    restored, meta = restore_sharded(ckpt, model, plan, mesh, state)
    got = None
    if restored is not None:
        state = restored
        got = host({"params": dict(state["params"]), "opt": state["opt"],
                    "step": state["step"]})
    step = make_train_step(model, plan, tcfg, mesh)
    loader = ShardedLoader(entry.smoke.vocab_size, 4, 8, seed=3,
                           device=rank_device())
    losses = []
    for s in steps:
        state, m = step(state, loader.get(s))
        losses.append(float(m["loss"]))
    save_sharded(ckpt, steps[-1], state)
    final = host({"params": dict(state["params"]), "opt": state["opt"],
                  "step": state["step"]})
    return tuple(mesh.mesh.shape), got, losses, final


def four(rank, world, train_args, ep_args, pipe_args, ckpt_dir):
    """Group of four: the sharded train step, EP, the pipeline, and the
    elastic run's first half."""
    return {"train": train_step(*train_args), "ep": ep_layer(*ep_args),
            "pipeline": pipeline(*pipe_args),
            "xlstm": xlstm_run(ckpt_dir, range(0, 2))}


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------


def serve_tp(arch: str, tokens: np.ndarray, prompt: int, compute: str,
             shape=(1, 2)):
    """``arch`` SMOKE under its plan over ``shape``: prefill of the first
    ``prompt`` tokens and teacher-forced decode of the rest, the model's
    weights from seed 0. Returns the (B, steps, V) fp32 logits."""
    import repro_torch.serve.steps as steps
    steps.COMPUTE_DTYPE = getattr(torch, compute)
    mesh = make_host_mesh(*shape)
    return serve_logits(arch, tokens, prompt, mesh)


def serve_logits(arch: str, tokens: np.ndarray, prompt: int, mesh=None,
                 device="cpu"):
    """The teacher-forced logits of prefill + decode, on ``device``
    (``mesh=None``) or over ``mesh`` on the rank's device, the cache in the
    compute type."""
    from repro_torch.serve.steps import (init_cache, make_decode_step,
                                         make_prefill_step, place_model)
    entry = get_arch(arch)
    plan = entry.plan if mesh is not None else None
    device = rank_device() if mesh is not None else device
    model = build_model(entry.smoke, device=device, rng=0)
    if mesh is not None:
        place_model(model, plan, mesh)
    toks = torch.from_numpy(tokens).to(device)
    B, S = toks.shape
    import repro_torch.serve.steps as steps
    cache = init_cache(model, B, S + 1, dtype=steps.COMPUTE_DTYPE,
                       device=device, mesh=mesh, plan=plan)
    pre = make_prefill_step(model, plan, mesh)
    dec = make_decode_step(model, plan, mesh)
    logits, cache = pre({"tokens": toks[:, :prompt]}, cache)
    out = [logits.float()]
    for t in range(prompt, S):
        _, logits, cache = dec(cache, toks[:, t:t + 1])
        out.append(logits.float())
    return torch.cat(out, dim=1).cpu()


def serve_tp_rank(rank, world, *args):
    """``serve_tp`` as a rank body."""
    return serve_tp(*args)


def pipeline_rank(rank, world, *args):
    """``pipeline`` as a rank body."""
    return pipeline(*args)


def two(rank, world, serve_args, ckpt_dir):
    """Group of two: tp serving, the elastic run's second half, and a mesh
    larger than the world."""
    out = {"serve": serve_tp(*serve_args),
           "xlstm": xlstm_run(ckpt_dir, range(2, 4))}
    try:
        make_host_mesh(2, 2)
        out["too_large"] = None
    except ValueError as e:
        out["too_large"] = str(e)
    return out


# ---------------------------------------------------------------------------
# eight ranks
# ---------------------------------------------------------------------------


def compressed(rank, world, g: np.ndarray, e: np.ndarray):
    """``compressed_psum`` over every rank, rank r holding row r of ``g``
    and ``e``, against ``compressed_mean`` of all rows: (the mean bit for
    bit, this rank's new error bit for bit), from every rank."""
    from repro_torch.optim.compress import compressed_mean, compressed_psum
    gt, et = torch.from_numpy(g), torch.from_numpy(e)
    mean, new_e = compressed_psum({"g": gt[rank].to(rank_device())}, None,
                                  {"g": et[rank].to(rank_device())})
    want_m, want_e = compressed_mean({"g": gt}, {"g": et})
    return gather_objects((torch.equal(mean["g"].cpu(), want_m["g"]),
                           torch.equal(new_e["g"].cpu(), want_e["g"][rank])))
