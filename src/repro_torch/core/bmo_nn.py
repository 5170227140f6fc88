"""BMO-NN result record (paper Algorithm 2). θ_i = ρ(q, x_i)/d throughout."""
from __future__ import annotations

from typing import NamedTuple

import torch


class KNNResult(NamedTuple):
    indices: torch.Tensor     # (Q, k)
    values: torch.Tensor      # (Q, k) θ estimates (ρ/d)
    coord_ops: torch.Tensor   # (Q,) coordinate-wise distance computations
    rounds: torch.Tensor      # (Q,)
    n_exact: torch.Tensor     # (Q,)
