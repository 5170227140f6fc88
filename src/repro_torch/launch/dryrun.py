"""The dry run: every (architecture × input shape × production mesh) cell
priced without a device, the port of ``repro/launch/dryrun.py``.

For every cell:
  * open PyTorch's ``fake`` process group of 256 or 512 ranks in this
    process and build the production mesh over it
    (``launch.mesh.make_production_mesh``);
  * build the model on ``meta`` with its parameters as DTensors laid out by
    the plan's rules (``sharding/spec.py``), its optimizer state, its cache
    and its inputs (``input_specs``) the same: nothing is allocated;
  * run the train step (forward, remat and backward, update), the prefill
    or the decode under ``roofline.count.CountMode``, which counts rank 0's
    program (DTensor dispatches each rank's local ops; every rank of an
    SPMD step runs the same program, so rank 0 stands for all of them, as
    the reference's per-device program × chips does);
  * derive the roofline terms (``roofline/analysis.py``) and append one
    JSONL record, the reference's keys.

It is abstract by design, as the reference's is: it allocates nothing on
any device and runs no kernel. It is no CPU fallback of a step; the steps
it prices run on the card. ``lower_s`` is the time to build the cell's
model and layouts, ``compile_s`` the time to count its step.

A train cell counts one microbatch's forward and backward and scales it by
the plan's gradient accumulation (``grad_accum`` in the record), where the
reference scales its scanned body by the trip count; the once-a-step
gradient reduction, clip and update are counted once. The host scalars of
the step (its step counter and learning rate) are Python numbers, so no
op reads a ``meta`` value back.

The ``bmo-nn`` cells (``run_bmo_cell``) cannot run the port's
``distributed_knn``, which drives its rounds from the host; they are
priced from their launches instead (see there).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun.jsonl
  python -m repro_torch.launch.dryrun --arch bmo-nn --shape knn_100k_12k --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import SHAPES, TrainConfig, get_arch, list_archs
from repro_torch.configs.registry import shape_skip_reason
from repro_torch.hardware import HBM_BYTES
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.registry import build_model
from repro_torch.roofline.analysis import analyze_counts, model_flops_estimate
from repro_torch.roofline.count import CountMode, repeated
from repro_torch.sharding.spec import make_rules
from repro_torch.utils.logging import get_logger

log = get_logger("repro_torch.dryrun")

#: ranks of the fake process group a mesh kind opens
WORLD = {"single": 256, "multi": 512}


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(world: int):
    """PyTorch's ``fake`` process group of ``world`` ranks in this process,
    as rank 0: its collectives return at once and move nothing. It is
    destroyed on the way out, a failing cell's too, so no later cell or
    test inherits it; a group already open (another caller's) raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already open in this "
                           "process; the dry run opens its own")
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())
    try:
        with _device_alltoall():
            yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _device_alltoall():
    """DTensor's shard-to-shard redistribution as the card runs it, an
    all-to-all: on a CPU-typed mesh (the fake group's) PyTorch replaces it
    by an all-gather and a chunk, since gloo has no all-to-all, which
    would count the whole gathered tensor."""
    from torch.distributed.tensor import placement_types as pt
    orig = getattr(pt, "shard_dim_alltoall", None)
    if orig is None or not hasattr(torch.ops._dtensor, "shard_dim_alltoall"):
        yield
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------


def input_specs(arch_id: str, shape_name: str) -> dict:
    """``meta`` stand-ins for every model input of the cell."""
    model = build_model(get_arch(arch_id).config, device="meta")
    return model.input_specs(SHAPES[shape_name])


# ---------------------------------------------------------------------------
# cell runners
# ---------------------------------------------------------------------------


def _active_params(model, plan) -> float:
    """Active params for MODEL_FLOPS: MoE expert tensors scaled by
    (active + shared)/total experts (the reference's rule, over the
    port's unstacked parameter names)."""
    total = 0.0
    cfg = model.cfg
    for name, p in model.named_parameters():
        n = float(math.prod(p.shape))
        if cfg.family == "moe" and "/moe/w" in name.replace(".", "/"):
            n *= cfg.n_experts_active / max(cfg.n_experts, 1)
        total += n
    return total


def _local_bytes(tree) -> float:
    """Bytes this rank holds of a tree of tensors (a DTensor's local
    shard)."""
    from repro_torch.sharding.context import is_dtensor
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if is_dtensor(tree) else tree
        return float(t.numel() * t.element_size())
    return 0.0


def _batch_bytes(batch: dict, rules, axis_sizes: dict) -> float:
    """Bytes a rank holds of the global ``batch`` laid out by the batch
    rule."""
    from repro_torch.train.steps import batch_pspecs
    total = 0.0
    for k, spec in batch_pspecs(batch, rules).items():
        n = batch[k].numel() * batch[k].element_size()
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                n //= axis_sizes[a]
        total += n
    return float(total)


def _apply_overrides(cfg, plan, overrides):
    if not overrides:
        return cfg, plan
    plan_kw = {k.split(".", 1)[1]: v for k, v in overrides.items()
               if k.startswith("plan.")}
    cfg_kw = {k.split(".", 1)[1]: v for k, v in overrides.items()
              if k.startswith("cfg.")}
    if plan_kw:
        plan = dataclasses.replace(plan, **plan_kw)
    if cfg_kw:
        cfg = dataclasses.replace(cfg, **cfg_kw)
    return cfg, plan


class _RepeatedChunk(torch.autograd.Function):
    """A scan chunk that stands for ``n`` identical ones under
    ``remat("full")``: its forward, and in the backward its recomputation
    and its gradients, each counted ``n`` times by the active counting
    mode (``roofline.count.repeated``)."""

    @staticmethod
    def forward(ctx, n, fn, *args):
        ctx.n, ctx.fn, ctx.args = n, fn, args
        with repeated(n):
            return tuple(fn(*args))

    @staticmethod
    def backward(ctx, *grads):
        args = [a.detach().requires_grad_(a.requires_grad)
                if isinstance(a, torch.Tensor) else a for a in ctx.args]
        wanted = [a for a in args
                  if isinstance(a, torch.Tensor) and a.requires_grad]
        with torch.enable_grad(), repeated(ctx.n):
            outs = ctx.fn(*args)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wanted, [g for _, g in pairs],
                allow_unused=True))
        return (None, None) + tuple(
            next(got) if isinstance(a, torch.Tensor) and a.requires_grad
            else None for a in args)


def _scan_first_chunk(fn, seqs, state, consts, n: int):
    """The xLSTM scans' hook (``models/ssm.py`` ``SCAN_HOOK``) while a
    step is counted: on ``meta`` there are no values to carry, so the
    first of the ``n`` chunks stands for all of them and is counted once
    for each (``_RepeatedChunk`` under autograd), as the reference's count
    scales a scanned body by its trips. A 32,768-long scan runs 256
    positions."""
    from repro_torch.models import common as cm
    args = (*(x[:, :x.shape[1] // n] for x in seqs), *consts, *state)
    if cm._records(fn, args):
        *state, out = _RepeatedChunk.apply(n, fn, *args)
    else:
        with repeated(n):
            *state, out = fn(*args)
    return tuple(state), torch.cat([out] * n, dim=1)


@contextlib.contextmanager
def counting(mode: CountMode):
    """``mode`` active, with the xLSTM scans counted from their first
    chunk (``_scan_first_chunk``)."""
    from repro_torch.models import ssm
    prev, ssm.SCAN_HOOK = ssm.SCAN_HOOK, _scan_first_chunk
    try:
        with mode:
            yield mode
    finally:
        ssm.SCAN_HOOK = prev


def _count_train_step(mode: CountMode, step, state: dict, mb: dict,
                      ga: int) -> None:
    """A train step into ``mode``: one microbatch's forward and backward
    scaled by ``ga``, the gradients' reduction and the update once."""
    with counting(mode):
        with mode.scaled(ga):
            per_mb = step.accumulate(state["params"], [mb])
        grads, metrics = step.collect(state["params"], per_mb)
        step.update(state, grads, metrics)


def _train_counts(cfg, plan, shape, mesh=None, rules=None):
    """``cfg``'s model built on ``meta`` under ``plan`` (its parameters and
    optimizer state laid out over ``mesh`` by ``rules`` where a mesh is
    given) and its train step on a ``shape`` batch counted
    (``_count_train_step``): (the counts, the model, the bytes a rank
    holds of the step's arguments, the seconds it took to build)."""
    from repro_torch.sharding.place import distribute_params, place_tree
    from repro_torch.train.steps import (DTYPES, _optimizer, make_train_step,
                                         split_batch, state_pspecs)
    t = time.time()
    tcfg = TrainConfig()
    model = build_model(cfg, param_dtype=DTYPES[plan.param_dtype],
                        device="meta")
    batch = model.input_specs(shape)
    if mesh is not None:
        specs = state_pspecs(model, plan, rules)
        distribute_params(model, specs["params"], mesh)
    params = dict(model.named_parameters())
    opt = _optimizer(model, plan, tcfg).init(params)
    if mesh is not None and plan.optimizer == "adafactor":
        opt = place_tree(opt, specs["opt"], mesh)     # the stacked leaves
    if mesh is not None:
        axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        batch_bytes = _batch_bytes(batch, rules, axis_sizes)
    else:
        batch_bytes = _local_bytes(batch)
    # the host scalars as Python numbers: nothing reads a meta value
    state = {"params": params, "opt": opt, "step": 0}
    step = make_train_step(model, plan, tcfg, mesh, rules=rules,
                           grad_accum=plan.grad_accum)
    arg_bytes = _local_bytes(params) + _local_bytes(opt) + batch_bytes
    t_build = time.time() - t
    mode = CountMode()
    _count_train_step(mode, step, state,
                      split_batch(batch, plan.grad_accum)[0],
                      plan.grad_accum)
    return mode.counts, model, arg_bytes, t_build


def _fits(peak: float) -> bool:
    return bool(peak <= HBM_BYTES if peak else True)


def run_cell(arch_id: str, shape_name: str, mesh_kind: str, *,
             overrides: Optional[Dict[str, Any]] = None,
             variant: str = "baseline") -> Dict[str, Any]:
    """One (arch × shape × mesh) cell's record (``status`` "ok" or
    "skipped"); raises where the cell fails."""
    shape = SHAPES[shape_name]
    entry = get_arch(arch_id)
    cfg, plan = _apply_overrides(entry.config, entry.plan, overrides)
    skip = shape_skip_reason(arch_id, shape_name)
    if skip:
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
                "variant": variant, "status": "skipped", "reason": skip}
    with fake_world(WORLD[mesh_kind]):
        return _count_cell(arch_id, shape_name, mesh_kind, cfg, plan,
                           overrides, variant)


def _count_cell(arch_id, shape_name, mesh_kind, cfg, plan, overrides,
                variant) -> Dict[str, Any]:
    from repro_torch.serve.steps import (init_cache, make_decode_step,
                                         make_prefill_step, place_model)
    t_start = time.time()
    shape = SHAPES[shape_name]
    multi_pod = mesh_kind == "multi"
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    rules = make_rules(fsdp=plan.fsdp, tp=plan.tp, sp=plan.sp, ep=plan.ep,
                       multi_pod=multi_pod, axis_sizes=axis_sizes,
                       kv_len_shard=plan.kv_len_shard)
    mode = CountMode()
    extra: Dict[str, Any] = {}
    B, S = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        # microbatch must still cover the data-parallel extent
        dp_axes = rules.mesh_axes("batch")
        dp_extent = math.prod(axis_sizes[a] for a in (
            (dp_axes,) if isinstance(dp_axes, str) else dp_axes))
        ga = max(min(plan.grad_accum, shape.global_batch // dp_extent), 1)
        if ga != plan.grad_accum:
            plan = dataclasses.replace(plan, grad_accum=ga)
        c, model, arg_bytes, t_build = _train_counts(cfg, plan, shape, mesh,
                                                     rules)
        t_lower = t_start + t_build
        extra = {"grad_accum": ga,
                 "counted": f"one microbatch's forward and backward x {ga}"
                            f" (grad_accum), the reduction and update once"}
    else:
        model = build_model(cfg, param_dtype=torch.bfloat16, device="meta")
        in_specs = model.input_specs(shape)
        place_model(model, plan, mesh, rules)
        cache = init_cache(model, B, S, device="meta", mesh=mesh, plan=plan,
                           rules=rules)
        arg_bytes = (_local_bytes(dict(model.named_parameters()))
                     + _local_bytes(cache)
                     + _batch_bytes(in_specs, rules, axis_sizes))
        t_lower = time.time()
        if shape.kind == "prefill":
            prefill = make_prefill_step(model, plan, mesh, rules=rules)
            with counting(mode):
                prefill(in_specs, cache)
        else:
            decode = make_decode_step(model, plan, mesh, rules=rules)
            tok = in_specs if cfg.family == "vlm" else in_specs["tokens"]
            with counting(mode):
                decode(cache, tok)
        c = mode.counts
    t_count = time.time()

    print(f"--- {arch_id} × {shape_name} × {mesh_kind} [{variant}] ---")
    print("counts (rank 0): flops=%.3e bytes=%.3e collective=%.3e ops=%d "
          "peak_live=%.3e" % (c.flops, c.bytes_accessed, c.coll_bytes,
                              c.ops, c.peak_live_bytes))
    n_active = _active_params(model, plan)
    mf = model_flops_estimate(cfg, shape, n_active)
    terms = analyze_counts(c, arch=arch_id, shape=shape_name,
                           mesh_name=mesh_kind, chips=chips, model_flops=mf,
                           arg_bytes=arg_bytes)
    rec = terms.to_dict()
    rec.update({
        "variant": variant, "status": "ok",
        "lower_s": round(t_lower - t_start, 1),
        "compile_s": round(t_count - t_lower, 1),
        "n_params_active": n_active,
        "overrides": overrides or {},
        "fits_hbm": _fits(terms.peak_memory_per_chip),
        "coll_bytes_by_kind": {k: v * chips
                               for k, v in c.coll_bytes_by_kind.items()},
        # where rank 0's bytes go: the five ops that move the most,
        # {op: [calls, flops, bytes]}
        "top_ops": dict(sorted(c.by_op.items(),
                               key=lambda kv: -kv[1][2])[:5]),
    })
    rec.update(extra)
    print(json.dumps({k: rec[k] for k in
                      ("t_compute", "t_memory", "t_collective", "bottleneck",
                       "useful_flops_ratio", "roofline_fraction",
                       "peak_memory_per_chip", "fits_hbm")}, indent=None))
    return rec


def price_train_step(cfg, plan, global_batch: int, seq_len: int, *,
                     name: str = "one_chip") -> Dict[str, Any]:
    """The roofline of one train step on one chip, no mesh: ``cfg``'s
    model on ``meta`` under ``plan`` (its optimizer, remat, compute type
    and ``grad_accum``), a ``global_batch`` × ``seq_len`` batch, counted as
    a cell is (one microbatch × ``grad_accum``, the update once). The
    record beside a step measured on the card."""
    from repro_torch.configs.base import ShapeConfig
    shape = ShapeConfig(name, seq_len, global_batch, "train")
    t = time.time()
    counts, model, arg_bytes, _ = _train_counts(cfg, plan, shape)
    n_active = _active_params(model, plan)
    terms = analyze_counts(counts, arch=cfg.name, shape=name,
                           mesh_name="none", chips=1,
                           model_flops=model_flops_estimate(cfg, shape,
                                                            n_active),
                           arg_bytes=arg_bytes)
    rec = terms.to_dict()
    rec.update({"status": "ok", "compile_s": round(time.time() - t, 1),
                "n_params_active": n_active, "grad_accum": plan.grad_accum,
                "fits_hbm": _fits(terms.peak_memory_per_chip),
                "t_bound": max(terms.t_compute, terms.t_memory,
                               terms.t_collective)})
    return rec


# ---------------------------------------------------------------------------
# BMO-NN (the paper's own workload) cells
# ---------------------------------------------------------------------------

KNN_SHAPES = {
    # (n points, d, Q queries per step)
    "knn_100k_12k": (100_000 * 8, 12_288, 256),   # pod-scale corpus (800k)
    "knn_1m_12k": (1_048_576, 12_288, 256),
    "knn_100k_28k": (131_072, 28_672, 256),
}


def _bmo_counts(mode: CountMode, cfg, n_loc: int, d_m: int, Q: int, mesh,
                dp_dims) -> None:
    """Rank 0's share of ``distributed_knn`` on a D × M grid, into
    ``mode``: the init launch over its n_loc arms and ``max_rounds``
    rounds of B arms, each a pull launch on its d_m columns priced by
    ``tune.seed.launch_work`` (the tuner's arithmetic); each round's
    ``pmean`` of the (Q, B, P) pulls over ``model``; the exact evaluation
    of the local top-k (a pull k rows wide of all d_m columns), its
    ``psum`` over ``model`` and the all-gather of the (Q, k) values and
    ids over the data axes. The collectives run through the counting
    mode on ``meta`` tensors, as the LM cells' do."""
    import torch.distributed._functional_collectives as funcol
    from repro_torch.tune.seed import launch_work
    gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
    c = mode.counts
    B, P, k = cfg.batch_arms, cfg.pulls_per_round, cfg.k
    launches = [(n_loc, cfg.init_pulls, cfg.block)]
    launches += [(B, P, cfg.block)] * cfg.max_rounds
    launches += [(k, 1, d_m)]                       # the exact evaluation
    for arms, T, width in launches:
        flops, nbytes = launch_work(Q, arms, T, width)
        c.flops += flops
        c.bytes_accessed += nbytes
        c.ops += 1
    model_dim = list(mesh.mesh_dim_names).index("model")
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                    device="meta")
    with mode:
        for _ in range(cfg.max_rounds):
            funcol.all_reduce(meta(Q, B, P), "sum", (mesh, model_dim))
        funcol.all_reduce(meta(Q, k), "sum", (mesh, model_dim))
        for dim in dp_dims:
            gather(meta(Q, k), 0, (mesh, dim))
            gather(meta(Q, k, dt=torch.int64), 0, (mesh, dim))


def run_bmo_cell(shape_name: str, mesh_kind: str, *,
                 variant: str = "baseline",
                 overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """A ``bmo-nn`` cell, priced from its launches (``_bmo_counts``): the
    port's ``distributed_knn`` steers its rounds from the host (it reads
    each round's survivors back), so it cannot run on ``meta``. The race
    is counted at ``max_rounds`` rounds, the most it runs."""
    from repro_torch.configs.base import BMOConfig
    t_start = time.time()
    n, d, Q = KNN_SHAPES[shape_name]
    multi_pod = mesh_kind == "multi"
    bmo_kw = {k.split(".", 1)[1]: v for k, v in (overrides or {}).items()
              if k.startswith("bmo.")}
    base_kw = dict(k=5, delta=0.01, block=128, batch_arms=32,
                   pulls_per_round=2, metric="l2", max_rounds=64)
    base_kw.update(bmo_kw)
    cfg = BMOConfig(**base_kw)
    mode = CountMode()
    with fake_world(WORLD[mesh_kind]):
        mesh = make_production_mesh(multi_pod=multi_pod)
        chips = mesh.size()
        names = list(mesh.mesh_dim_names)
        sizes = dict(zip(names, mesh.mesh.shape))
        dp_dims = [names.index(a) for a in names if a != "model"]
        D = math.prod(sizes[names[i]] for i in dp_dims)
        M = sizes["model"]
        n_loc, d_m = n // D, d // M
        t_lower = time.time()
        _bmo_counts(mode, cfg, n_loc, d_m, Q, mesh, dp_dims)
    t_count = time.time()
    # the rank's corpus and query shards, and the race's per-(query, arm)
    # state: the init's (Q, n_loc, 2) statistics, pull counts, bounds
    # and the alive mask
    arg_bytes = 4.0 * (n_loc * d_m + Q * d_m)
    state_bytes = Q * n_loc * (8.0 + 4.0 + 8.0 + 1.0)
    c = mode.counts
    print(f"--- bmo-nn × {shape_name} × {mesh_kind} [{variant}] ---")
    print("counts (rank 0): flops=%.3e bytes=%.3e collective=%.3e" % (
        c.flops, c.bytes_accessed, c.coll_bytes))
    # MODEL_FLOPS for kNN = the paper's metric at the roofline: per query,
    # adaptive coordinate reads ≈ n·init·block ops (1 flop each, l2: 3)
    mf = 3.0 * Q * n * cfg.init_pulls * cfg.block
    terms = analyze_counts(c, arch="bmo-nn", shape=shape_name,
                           mesh_name=mesh_kind, chips=chips, model_flops=mf,
                           arg_bytes=arg_bytes + state_bytes)
    rec = terms.to_dict()
    rec.update({"variant": variant, "status": "ok",
                "lower_s": round(t_lower - t_start, 1),
                "compile_s": round(t_count - t_lower, 1),
                "overrides": overrides or {},
                "fits_hbm": _fits(terms.peak_memory_per_chip),
                "coll_bytes_by_kind": {k: v * chips for k, v in
                                       c.coll_bytes_by_kind.items()},
                "counted": f"launches priced by tune.seed.launch_work: the "
                           f"init and {cfg.max_rounds} rounds (max_rounds)"})
    print(json.dumps({k: rec[k] for k in
                      ("t_compute", "t_memory", "t_collective", "bottleneck",
                       "peak_memory_per_chip", "fits_hbm")}))
    return rec


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _parse_override(kv: str):
    k, v = kv.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            continue
    if v in ("true", "false", "True", "False"):
        return k, v.lower() == "true"
    return k, v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="arch id, or 'bmo-nn' for the paper workload")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="plan.X=V / cfg.X=V / bmo.X=V override")
    args = ap.parse_args(argv)

    overrides = dict(_parse_override(kv) for kv in args.overrides) or None
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    cells = []
    if args.all:
        for a in list_archs():
            for s in SHAPES:
                cells += [(a, s, m) for m in meshes]
        for s in KNN_SHAPES:
            cells += [("bmo-nn", s, m) for m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, m) for m in meshes]

    failures = 0
    for arch, shape, m in cells:
        try:
            if arch == "bmo-nn":
                rec = run_bmo_cell(shape, m, variant=args.variant,
                                   overrides=overrides)
            else:
                rec = run_cell(arch, shape, m, variant=args.variant,
                               overrides=overrides)
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "mesh": m,
                   "variant": args.variant, "status": "error",
                   "error": f"{type(e).__name__}: {e}"}
            failures += 1
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    if failures:
        log.error("%d cells failed", failures)
        sys.exit(1)


if __name__ == "__main__":
    main()
