"""Learning-rate schedules, pure functions of the step counter: the port of
``repro/optim/schedules.py``. Each returns a 0-dim fp32 tensor on the CPU,
computed in fp32 as the reference computes it."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32).cpu()


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warm-up from 0 to ``lr`` over ``warmup_steps``, then a cosine
    down to ``final_frac · lr`` at ``total_steps``, constant after."""
    def schedule(step) -> torch.Tensor:
        step = _f32(step)
        warm = lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = lr * (final_frac + (1 - final_frac) * 0.5
                    * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule


def constant(lr: float):
    return lambda step: _f32(lr)
