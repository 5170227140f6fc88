"""Racing configuration, field for field the reference's ``BMOConfig`` so the
``cfg`` dict in an index's metadata loads unchanged in either package."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class BMOConfig:
    """Paper-technique hyper-parameters (Alg. 1/2 + §IV + App. D-A)."""

    k: int = 5                       # number of nearest neighbours
    delta: float = 0.01              # failure probability
    block: int = 128                 # coordinate-block width of one pull
    batch_arms: int = 32             # arms raced per round (paper App. D-A: 32)
    pulls_per_round: int = 2         # blocks pulled per selected arm per round
    init_pulls: int = 2              # initial blocks pulled on every arm
    metric: str = "l2"               # l2 | l1
    rotate: bool = False             # §IV-B randomized Hadamard pre-rotation
    sparse: bool = False             # §IV-A sparse Monte-Carlo box
    epsilon: float = 0.0             # >0 → PAC variant (Thm 2)
    sigma: Optional[float] = None    # sub-Gaussian bound; None = empirical (App. D-A)
    max_rounds: int = 0              # 0 = derived from d/block
    epoch_rounds: int = 4            # racing rounds fused per kernel launch
                                     # (grows as the survivor frontier shrinks)
    frontier_floor: int = 0          # smallest survivor-bucket width the
                                     # frontier may shrink to (0 = derived
                                     # from batch_arms/k)
    kernel_buffers: int = 2          # pulls the fused pull kernel may load
                                     # ahead (2 = double buffering)
