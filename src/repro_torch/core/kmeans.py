"""BMO k-means (paper §V-A): Lloyd's algorithm whose assignment step (the
nearest centroid of each point: n independent 1-NN problems over k arms)
runs through BMO-UCB. The update step is the standard O(nd) mean."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import BMOConfig
from repro_torch.core import bmo_nn, oracle
from repro_torch.device import make_generator, resolve_device


class KMeansResult(NamedTuple):
    centroids: torch.Tensor    # (k, d)
    assignment: torch.Tensor   # (n,)
    coord_ops: torch.Tensor    # () assignment-step coordinate computations
    exact_ops: torch.Tensor    # () what exact assignment would have cost


def assign_bmo(points, centroids, cfg: BMOConfig, rng=0, *,
               impl: str = "auto", device=None, block_samplers=None):
    """(n,) nearest-centroid ids through BMO-UCB (``bmo_nn.knn`` with k = 1:
    the points are the queries, the centroids the arms), and the summed
    coordinate ops. ``rng`` is a seed or a ``torch.Generator``;
    ``block_samplers(i)`` replaces point i's draws."""
    acfg = dataclasses.replace(cfg, k=1)
    res = bmo_nn.knn(centroids, points, acfg, rng, impl=impl, device=device,
                     block_samplers=block_samplers)
    return res.indices[:, 0], torch.sum(res.coord_ops)


def assign_exact(points, centroids, *, impl: str = "auto", device=None):
    res = oracle.exact_knn(centroids, points, 1, "l2", impl=impl,
                           device=device)
    return res.indices[:, 0], res.coord_ops


def lloyd_update(points, assignment, k: int) -> torch.Tensor:
    """Each centroid the mean of its points; a centroid with no points
    becomes 0, as in the reference."""
    one_hot = torch.nn.functional.one_hot(assignment.long(), k).to(
        points.dtype)                                             # (n, k)
    sums = one_hot.T @ points                                     # (k, d)
    counts = torch.sum(one_hot, dim=0)[:, None]
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1), 0.0)


def kmeans(points, k: int, iters: int, cfg: BMOConfig, rng=0, *,
           use_bmo: bool = True, impl: str = "auto", device=None,
           init_idx=None) -> KMeansResult:
    """``iters`` Lloyd iterations from k distinct points drawn by ``rng``
    (a seed or a ``torch.Generator`` on ``device``, default the GPU), or
    from the points ``init_idx``. The same generator then feeds every
    assignment's block draws."""
    dev = resolve_device(device)
    gen = make_generator(rng, dev)
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    n, d = points.shape
    if init_idx is None:
        init_idx = torch.randperm(n, generator=gen, device=dev)[:k]
    if not isinstance(init_idx, torch.Tensor):
        init_idx = torch.from_numpy(np.array(init_idx))
    centroids = points[init_idx.to(dev).long()]
    coord_ops = torch.zeros((), device=dev)
    assignment = torch.zeros((n,), dtype=torch.int64, device=dev)
    for _ in range(iters):
        if use_bmo:
            assignment, ops = assign_bmo(points, centroids, cfg, gen,
                                         impl=impl, device=dev)
        else:
            assignment, ops = assign_exact(points, centroids, impl=impl,
                                           device=dev)
        coord_ops = coord_ops + ops.to(dev)
        centroids = lloyd_update(points, assignment, k)
    exact_ops = torch.tensor(float(iters) * n * k * d, device=dev)
    return KMeansResult(centroids, assignment, coord_ops, exact_ops)


__all__ = ["KMeansResult", "assign_bmo", "assign_exact", "kmeans",
           "lloyd_update"]
