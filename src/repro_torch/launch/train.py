"""Training CLI on one device: arch config → model → train step →
step-keyed loader → checkpoint manager → fault-tolerant supervisor, the
port of ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \\
      --smoke --device cpu --steps 8 --batch 4 --seq 32 --ckpt-dir DIR

Without ``--device`` it trains on the current CUDA device (and raises
without one). As the reference's CLI, it runs the arch's published plan
with grad accumulation 1 and no sharding: ``--data`` or ``--model`` above
1 raises ``NotImplementedError`` (sharding is ROADMAP.md Queue 1 item
9c-ii). A ``--ckpt-dir`` that holds checkpoints resumes from the latest.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.data.loader import ShardedLoader
from repro_torch.device import resolve_device
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
    if args.data > 1 or args.model > 1:
        raise NotImplementedError(
            f"--data {args.data} --model {args.model}: the port trains on one "
            "device; sharding is not ported yet (ROADMAP.md Queue 1 item "
            "9c-ii)")
    device = resolve_device(args.device)
    entry = get_arch(args.arch)
    cfg = entry.smoke if args.smoke else entry.config
    plan = dataclasses.replace(entry.plan, grad_accum=1, fsdp=False,
                               sp=False, tp=False, ep=False)
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 1))
    model = build_model(cfg, param_dtype=DTYPES[plan.param_dtype],
                        device=device, rng=tcfg.seed)
    step_fn = make_train_step(model, plan, tcfg)
    loader = ShardedLoader(cfg.vocab_size, args.batch, args.seq,
                           device=device)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    injector = (FailureInjector([args.fail_at]) if args.fail_at is not None
                else None)
    t0 = time.time()
    last = {}

    def on_metrics(step, metrics):
        last.clear()
        last.update({k: float(v) for k, v in metrics.items()})
        if step % args.log_every == 0:
            log.info("step=%d loss=%.4f lr=%.2e %.2fs/step", step,
                     last["loss"], last["lr"],
                     (time.time() - t0) / max(step, 1))

    sup = Supervisor(
        ckpt=ckpt, train_step=step_fn, loader=loader.get,
        init_state=lambda: init_train_state(model, plan, tcfg, tcfg.seed),
        ckpt_every=args.ckpt_every, injector=injector)
    state = sup.run(args.steps, on_metrics=on_metrics)
    seconds = time.time() - t0
    log.info("done in %.1fs", seconds)
    return dict(last, step=int(state["step"]), seconds=seconds)


if __name__ == "__main__":
    main()
