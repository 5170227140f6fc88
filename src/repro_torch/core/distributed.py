"""Distributed BMO-NN over a (data × model) grid of devices: a thin wrapper
over the sharded index's shard-local race (``index/sharded.py``).

Arms (corpus rows) are split over the data axis: data row i of the grid
races its own n/D rows with the cross-query batched driver
(``index.sharded.local_dense_race``). Coordinates are split over the model
axis: every pull takes one block of each model part, each drawn by that
part's sampler, and averages the M partial block means (the reference's
``pmean`` over "model"), so one pull reads block × M coordinates spread
over the data row's devices. Queries are replicated over data rows and
split by coordinates like the corpus.

Final merge: each data row exact-evaluates its certified local top-k (the
partial distances summed over its model parts, the reference's ``psum``)
and the (values, global ids) of every data row are reduced to the global
top-k on the first device (the reference's ``all_gather`` over "data").
The reductions are host-side gathers onto that device; a device may
repeat in the grid, so a 2 × 2 grid runs on one card or on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from repro_torch.configs.base import BMOConfig
from repro_torch.core.bmo_nn import BlockSampler, default_block_sampler
from repro_torch.core.confidence import shard_delta
from repro_torch.device import make_generator
from repro_torch.index.batched_race import _dense_exact_theta
from repro_torch.index.sharded import (guard_local_topk, local_dense_race,
                                       merge_local_topk)


class DistKNNResult(NamedTuple):
    indices: torch.Tensor    # (Q, k) global corpus indices
    values: torch.Tensor     # (Q, k) θ = ρ/d
    coord_ops: torch.Tensor  # () total coordinate-wise computations
    rounds: torch.Tensor     # () max rounds across data rows


def distributed_knn(x, queries, cfg: BMOConfig,
                    devices: Sequence[Sequence], rng=0, *,
                    impl: str = "auto",
                    block_samplers: Optional[Callable[[int, int],
                                                      BlockSampler]] = None
                    ) -> DistKNNResult:
    """k-NN of ``queries`` (Q, d) against ``x`` (n, d) on the D × M grid
    ``devices`` (``devices[i][j]``: data row i, model part j; repeats
    allowed). n must divide by D and d by M·``cfg.block``. Each data row
    races at δ/D, so the per-interval budget is the single-machine union
    bound over all n arms. ``rng`` (a seed or a ``torch.Generator``) seeds
    one generator a grid cell; ``block_samplers(i, j)`` replaces cell
    (i, j)'s draws."""
    D, M = len(devices), len(devices[0])
    x = torch.as_tensor(x, dtype=torch.float32)
    qs = torch.as_tensor(queries, dtype=torch.float32)
    n, d = x.shape
    n_loc, d_m = n // D, d // M
    if n_loc * D != n or d_m * M != d or d_m % cfg.block:
        raise ValueError(f"a {D} × {M} grid needs n % {D} == 0 and d % "
                         f"({M}·block) == 0, got n={n}, d={d}")
    cfg_loc = dataclasses.replace(cfg, delta=shard_delta(cfg.delta, D))
    grid = [[torch.device(dev) for dev in row] for row in devices]
    if block_samplers is None:
        gen = make_generator(0 if rng is None else rng, grid[0][0])
        seeds = torch.randint(0, 2 ** 62, (D, M), generator=gen,
                              device=grid[0][0]).tolist()
        block_samplers = lambda i, j: default_block_sampler(  # noqa: E731
            make_generator(seeds[i][j], grid[i][j]), grid[i][j])
    dev0 = grid[0][0]
    vals, gids, ops, rounds = [], [], [], []
    for i in range(D):
        rows = slice(i * n_loc, (i + 1) * n_loc)
        # each part contiguous once: a column slice is a strided view,
        # which every pull would otherwise copy whole
        x_parts = [x[rows, j * d_m:(j + 1) * d_m].to(grid[i][j]).contiguous()
                   for j in range(M)]
        q_parts = [qs[:, j * d_m:(j + 1) * d_m].to(grid[i][j]).contiguous()
                   for j in range(M)]
        alive = torch.ones((n_loc,), dtype=torch.bool, device=grid[i][0])
        prior = torch.zeros((n_loc,), dtype=torch.float32, device=grid[i][0])
        res = local_dense_race(
            x_parts, q_parts, alive, prior,
            [block_samplers(i, j) for j in range(M)], cfg=cfg_loc,
            block=cfg.block, exact_cost=float(d_m), impl=impl,
            eliminate=True, prior_weight=0.0)
        # exact θ of the certified local top-k, summed over the model parts
        part = sum(_dense_exact_theta(xp, qp, res.indices.to(xp.device),
                                      cfg.metric, d).to(grid[i][0])
                   for xp, qp in zip(x_parts, q_parts))
        vals.append(guard_local_topk(res.indices, part, alive).to(dev0))
        gids.append((res.indices.to(torch.int64) + i * n_loc).to(dev0))
        # the reference's psum over the model axis of a row-replicated sum
        ops.append(M * (torch.sum(res.coord_ops).to(dev0)
                        + float(cfg.k * d_m) * qs.shape[0]))
        rounds.append(torch.amax(res.rounds).to(dev0))
    idx, merged = merge_local_topk(torch.stack(vals), torch.stack(gids),
                                   cfg.k)
    return DistKNNResult(idx, merged, torch.stack(ops).sum(),
                         torch.stack(rounds).amax())


__all__ = ["DistKNNResult", "distributed_knn"]
