"""BMO-NN (paper Algorithm 2): k-nearest neighbours via BMO-UCB, for the
dense and rotated Monte-Carlo boxes:

  * dense   (§III):   uniform coordinate-block sampling, ℓ1 or ℓ2²,
  * rotated (§IV-B):  the dense box on x' = H D x (ℓ2 only; the rotation
                      makes coordinates exchangeable).

The sparse box (§IV-A) waits for its port (ROADMAP.md, Queue 1 item 6).

θ_i = ρ(q, x_i)/d throughout. Scale: a pull is a block mean over the
d_pad-wide row, so it estimates ρ/d_pad, and the race compares every arm
on that scale — its exact evaluations too. The reference divides exact
evaluations by the true d instead (ROADMAP.md, Queue 3). Reported values
are converted to θ = ρ/d.

Randomness: block ids come from a replaceable ``block_sampler(shape, nb)``
that returns an int32 tensor on the corpus's device, the rotation signs
from a replaceable ``sign_sampler(dp)``; by default both draw from one
``torch.Generator``. The tests replace them to replay the reference's
draws.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import BMOConfig
from repro_torch.core.datasets import DenseDataset, hadamard_rotate
from repro_torch.core.ucb import RaceResult, race_topk
from repro_torch.device import make_generator, resolve_device
from repro_torch.kernels import ops as kops

BlockSampler = Callable[[tuple, int], torch.Tensor]


class KNNResult(NamedTuple):
    indices: torch.Tensor     # (Q, k)
    values: torch.Tensor      # (Q, k) θ estimates (ρ/d)
    coord_ops: torch.Tensor   # (Q,) coordinate-wise distance computations
    rounds: torch.Tensor      # (Q,)
    n_exact: torch.Tensor     # (Q,)


def default_block_sampler(generator: torch.Generator,
                          device: torch.device) -> BlockSampler:
    """Uniform block ids from ``generator``, int32 on ``device``."""
    def sample(shape, nb):
        return torch.randint(0, nb, shape, generator=generator,
                             device=device, dtype=torch.int32)
    return sample


# ---------------------------------------------------------------------------
# dense / rotated boxes
# ---------------------------------------------------------------------------


def _dense_pull_fn(ds: DenseDataset, q: torch.Tensor, cfg: BMOConfig,
                   impl: str, sample_blocks: BlockSampler):
    nb = ds.n_blocks

    def pull(arm_idx):
        blk = sample_blocks((arm_idx.shape[0], cfg.pulls_per_round), nb)
        return kops.block_pull(ds.x, q, arm_idx, blk, block=ds.block,
                               metric=cfg.metric, impl=impl)

    return pull


def _dense_exact_fn(ds: DenseDataset, q: torch.Tensor, cfg: BMOConfig,
                    impl: str):
    def exact(arm_idx):
        rows = ds.x[arm_idx]                       # (B, d_pad)
        dist = kops.pairwise_dist(q[None], rows, metric=cfg.metric, impl=impl)
        return dist[0] / ds.d_pad                  # the pulls' ρ/d_pad scale

    return exact


def query_dense(ds: DenseDataset, q: torch.Tensor, cfg: BMOConfig, rng=None,
                *, impl: str = "auto", eliminate: bool = True,
                block_sampler: Optional[BlockSampler] = None) -> RaceResult:
    """k-NN of one query against a dense corpus. ``q`` already padded.
    Block ids come from ``block_sampler``, else from ``rng`` (a seed or a
    ``torch.Generator`` on the corpus's device). ``topk_values`` are θ =
    ρ/d; the returned state keeps the race's ρ/d_pad scale."""
    dev = ds.x.device
    if block_sampler is None:
        block_sampler = default_block_sampler(
            make_generator(0 if rng is None else rng, dev), dev)
    res = race_topk(
        _dense_pull_fn(ds, q, cfg, impl, block_sampler),
        _dense_exact_fn(ds, q, cfg, impl),
        n=ds.n,
        max_pulls=ds.n_blocks,                     # = d/B blocks ≙ d coords
        pull_cost=float(ds.block),
        exact_cost=float(ds.d),
        cfg=cfg, device=dev, eliminate=eliminate,
    )
    # from the race's ρ/d_pad to θ = ρ/d (exactly 1.0 when d_pad = d)
    return res._replace(topk_values=res.topk_values * (ds.d_pad / ds.d))


# ---------------------------------------------------------------------------
# multi-query drivers (Algorithm 2 iterates queries; embarrassingly parallel)
# ---------------------------------------------------------------------------


def knn(corpus, queries, cfg: BMOConfig, rng=0, *, impl: str = "auto",
        eliminate: bool = True, device=None,
        sign_sampler: Optional[Callable[[int], torch.Tensor]] = None,
        block_samplers: Optional[Callable[[int], BlockSampler]] = None
        ) -> KNNResult:
    """k-NN of each (Q, d) query row against the (n, d) corpus (numpy or
    tensors), one race per query, on ``device`` (default: the GPU).
    ``cfg.rotate`` applies the §IV-B Hadamard rotation to corpus and
    queries together (ℓ2 only; distances preserved).

    ``rng`` is a seed or a ``torch.Generator`` on the device: it draws the
    rotation signs, then every query's block ids. ``sign_sampler(dp)`` and
    ``block_samplers(i)`` (query i's block sampler) replace those draws.
    """
    if cfg.sparse:
        raise NotImplementedError(
            "the sparse box is not ported yet (ROADMAP.md, Queue 1 item 6)")
    dev = resolve_device(device)
    gen = make_generator(rng, dev)
    x = torch.as_tensor(corpus, dtype=torch.float32, device=dev)
    qs = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    if cfg.rotate:
        if cfg.metric != "l2":
            raise ValueError("rotation preserves only ℓ2")
        n = x.shape[0]
        both, _ = hadamard_rotate(torch.cat([x, qs]), gen, use_kernel=impl,
                                  sign_sampler=sign_sampler)
        x, qs = both[:n], both[n:]
    ds = DenseDataset.build(x, block=cfg.block)
    qs = ds.pad_query(qs)
    if block_samplers is None:
        shared = default_block_sampler(gen, dev)
        block_samplers = lambda i: shared                  # noqa: E731

    res = [query_dense(ds, qs[i], cfg, impl=impl, eliminate=eliminate,
                       block_sampler=block_samplers(i))
           for i in range(qs.shape[0])]
    return KNNResult(indices=torch.stack([r.topk for r in res]),
                     values=torch.stack([r.topk_values for r in res]),
                     coord_ops=torch.stack([r.coord_ops for r in res]),
                     rounds=torch.stack([r.rounds for r in res]),
                     n_exact=torch.stack([r.n_exact for r in res]))


def knn_graph(x, cfg: BMOConfig, rng=0, *, impl: str = "auto",
              eliminate: bool = True, device=None,
              sign_sampler: Optional[Callable[[int], torch.Tensor]] = None,
              block_samplers: Optional[Callable[[int], BlockSampler]] = None
              ) -> KNNResult:
    """Algorithm 2 proper: k-NN of every point among the others. Runs
    ``knn`` with k+1, then drops self-matches (or, where a row's own point
    was not found, its worst entry)."""
    cfg1 = dataclasses.replace(cfg, k=cfg.k + 1)
    res = knn(x, x, cfg1, rng, impl=impl, eliminate=eliminate, device=device,
              sign_sampler=sign_sampler, block_samplers=block_samplers)
    Q = res.indices.shape[0]
    is_self = res.indices == torch.arange(Q, device=res.indices.device)[:, None]
    rank = torch.argsort(torch.where(is_self, torch.inf, res.values), dim=1,
                         stable=True)[:, :cfg.k]
    return KNNResult(torch.gather(res.indices, 1, rank),
                     torch.gather(res.values, 1, rank),
                     res.coord_ops, res.rounds, res.n_exact)
