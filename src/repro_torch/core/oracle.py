"""Exact k-NN oracle (the paper's 'exact computation' baseline and the
judge of exactness). The sparse oracle waits for the sparse box."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.ucb import smallest_k
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops


class OracleResult(NamedTuple):
    indices: torch.Tensor    # (Q, k)
    values: torch.Tensor     # (Q, k) θ = ρ/d
    coord_ops: torch.Tensor  # () total coordinate-wise distance computations


def exact_knn(corpus, queries, k: int, metric: str = "l2", *,
              impl: str = "auto", batch: int = 256,
              device=None) -> OracleResult:
    """Brute force: the full (Q, n) distance matrix, ``batch`` queries at a
    time, and its k smallest entries per row (the lower index first among
    ties, as ``lax.top_k``). Costs Q·n·d. Runs on ``device`` (default: the
    GPU)."""
    dev = resolve_device(device)
    x = torch.as_tensor(corpus, dtype=torch.float32, device=dev)
    qs = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    Q, d = qs.shape
    n = x.shape[0]
    idx_out, val_out = [], []
    for s in range(0, Q, batch):
        dist = kops.pairwise_dist(qs[s:s + batch], x, metric=metric,
                                  impl=impl)
        idx = smallest_k(dist, k)
        idx_out.append(idx)
        val_out.append(torch.gather(dist, 1, idx) / d)
    return OracleResult(torch.cat(idx_out), torch.cat(val_out),
                        torch.tensor(float(Q) * n * d))
