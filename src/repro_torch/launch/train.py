"""Training CLI: arch config → model → train step → step-keyed loader →
checkpoint manager → fault-tolerant supervisor, the port of
``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \\
      --smoke --device cpu --steps 8 --batch 4 --seq 32 --ckpt-dir DIR

Without ``--device`` it trains on the current CUDA device (and raises
without one). As the reference's CLI, it runs the arch's plan at grad
accumulation 1 with fsdp, sp and ep cleared and tp on when ``--model`` is
above 1, the ``Supervisor`` driving the steps and restarting from the
latest checkpoint on a failure (``--fail-at`` injects one). With
``--data`` or ``--model`` above 1 the plan runs over a (data, model) mesh
of ranks: under ``torchrun`` (its environment set) each process is a
rank; otherwise the CLI spawns data × model rank processes itself on
``--device`` (on one card they share it) and rank 0 returns the metrics.
Over a mesh the checkpoint is gathered whole and written by rank 0, so a
relaunch resumes from it at any rank count; a rank that dies fails the
run. A ``--ckpt-dir`` that holds checkpoints resumes from the latest.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.data.loader import ShardedLoader
from repro_torch.device import resolve_device
from repro_torch.dist import CLI_TIMEOUT_S, init_rank, rank_device, spawn
from repro_torch.models import build_model
from repro_torch.runtime.supervisor import FailureInjector, Supervisor
from repro_torch.train.steps import DTYPES, init_train_state, make_train_step
from repro_torch.utils import get_logger

log = get_logger("repro_torch.train")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--data", type=int, default=1, help="mesh data axis")
    ap.add_argument("--model", type=int, default=1, help="mesh model axis")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (fault-tolerance demo)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "'cpu' runs the plain PyTorch path)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns the last step's metrics as floats, with ``step`` (the
    steps the state has taken) and ``seconds``."""
    args = parse_args(argv)
    world = args.data * args.model
    if world == 1:
        return train(args, resolve_device(args.device))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"--data {args.data} --model {args.model} takes "
                             f"{world} ranks; torchrun started "
                             f"{os.environ['WORLD_SIZE']}")
        init_rank(int(os.environ["RANK"]), world, None,
                  args.device or "cuda")
        return train_rank(int(os.environ["RANK"]), world, args)
    return spawn(train_rank, world, (args,), device=args.device or "cuda",
                 timeout=CLI_TIMEOUT_S)


def train_rank(rank: int, world: int, args) -> dict:
    """One rank of ``--data`` × ``--model``: ``train`` over the mesh."""
    from repro_torch.launch.mesh import make_host_mesh
    return train(args, rank_device(), make_host_mesh(args.data, args.model))


def train(args, device, mesh=None) -> dict:
    """The CLI's run on ``device``, over ``mesh`` when given: the
    Supervisor drives the steps, restarting from the latest checkpoint on
    a failure (over a mesh every rank restarts, the checkpoint gathered
    whole and written by rank 0, read back into each rank's shards)."""
    entry = get_arch(args.arch)
    cfg = entry.smoke if args.smoke else entry.config
    plan = dataclasses.replace(entry.plan, grad_accum=1, fsdp=False,
                               sp=False, tp=args.model > 1, ep=False)
    tcfg = _tcfg(args)
    model = build_model(cfg, param_dtype=DTYPES[plan.param_dtype],
                        device="meta" if mesh is not None else device)
    step_fn = make_train_step(model, plan, tcfg, mesh)
    loader = ShardedLoader(cfg.vocab_size, args.batch, args.seq,
                           device=device)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3,
                             async_save=mesh is None)
    injector = (FailureInjector([args.fail_at]) if args.fail_at is not None
                else None)
    hooks = {}
    if mesh is not None:
        from repro_torch.runtime.elastic import restore_sharded, save_sharded
        from repro_torch.sharding.spec import rules_for

        def restore(ckpt_, like):
            state, meta = restore_sharded(ckpt_, model, plan, mesh, like,
                                          rules=rules_for(plan, mesh))
            return (like, None) if state is None else (state,
                                                       int(meta["step"]))
        hooks = dict(restore=restore, save=save_sharded)
    t0 = time.time()
    last = {}
    sup = Supervisor(
        ckpt=ckpt, train_step=step_fn, loader=loader.get,
        init_state=lambda: init_train_state(model, plan, tcfg, tcfg.seed,
                                            mesh=mesh),
        ckpt_every=args.ckpt_every, injector=injector, **hooks)
    state = sup.run(args.steps, on_metrics=_logger(args, last, t0))
    seconds = time.time() - t0
    log.info("done in %.1fs", seconds)
    return dict(last, step=int(state["step"]), seconds=seconds)


def _tcfg(args) -> TrainConfig:
    return TrainConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 1))


def _logger(args, last: dict, t0: float):
    def on_metrics(step, metrics):
        last.clear()
        last.update({k: float(v) for k, v in metrics.items()})
        if step % args.log_every == 0:
            log.info("step=%d loss=%.4f lr=%.2e %.2fs/step", step,
                     last["loss"], last["lr"],
                     (time.time() - t0) / max(step, 1))
    return on_metrics


if __name__ == "__main__":
    main()
