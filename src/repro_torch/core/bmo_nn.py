"""BMO-NN (paper Algorithm 2): k-nearest neighbours via BMO-UCB, for the
three Monte-Carlo boxes of the paper:

  * dense   (§III):   uniform coordinate-block sampling, ℓ1 or ℓ2²,
  * rotated (§IV-B):  the dense box on x' = H D x (ℓ2 only; the rotation
                      makes coordinates exchangeable),
  * sparse  (§IV-A):  support-union importance sampling (Eq. 12), ℓ1.

θ_i = ρ(q, x_i)/d throughout. Scale (dense and rotated): a pull is a block
mean over the d_pad-wide row, so it estimates ρ/d_pad, and the race
compares every arm on that scale — its exact evaluations too. The
reference divides exact evaluations by the true d instead (ROADMAP.md,
Queue 3). Reported values are converted to θ = ρ/d. The sparse box pads
nothing in d: its pulls and exact evaluations are both ρ/d.

Randomness: block ids come from a replaceable ``block_sampler(shape, nb)``
that returns an int32 tensor on the corpus's device, the rotation signs
from a replaceable ``sign_sampler(dp)``, and the sparse box's three draws
a pull from a replaceable ``coord_sampler(q_nnz, arm_nnz)``; by default
all draw from one ``torch.Generator``. The tests replace them to replay
the reference's draws.

Sparse lookups. A query's side is a dense (Q, d + 1) table of each
coordinate's position in the query's index list (−1 where absent; column
d, the pad sentinel, points at the first pad as the reference's search
does): one indexed read in place of a search, the paper's O(1) hash map.
Membership follows the index list, so explicit zeros count. An arm's side
is a binary search in the arm's sorted row (``_sparse_lookup``), never a
gather of the whole row.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import BMOConfig
from repro_torch.core.datasets import (DenseDataset, SparseDataset,
                                       hadamard_rotate)
from repro_torch.core.ucb import RaceResult, race_topk
from repro_torch.device import make_generator, resolve_device
from repro_torch.kernels import ops as kops

BlockSampler = Callable[[tuple, int], torch.Tensor]
# (q_nnz, arm_nnz) int32 of one shape → (u, jq, ja) of that shape: u
# uniform in [0, 1) fp32, jq in [0, max(q_nnz, 1)) and ja in
# [0, max(arm_nnz, 1)) int32 — a pull's three draws (the reference's
# split(key, 3): uniform, randint, randint)
CoordSampler = Callable[[torch.Tensor, torch.Tensor],
                        Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
# lanes a sparse pull or exact evaluation works on at once
SPARSE_CHUNK = 1 << 23


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


def default_coord_sampler(generator: torch.Generator,
                          device: torch.device) -> CoordSampler:
    """The sparse pull's draws from ``generator``, on ``device``."""
    def below(count):
        top = torch.clamp(count, min=1)
        r = torch.rand(top.shape, generator=generator, device=device)
        return torch.minimum((r * top).to(torch.int32), top - 1)

    def sample(q_nnz, arm_nnz):
        q_nnz, arm_nnz = torch.broadcast_tensors(q_nnz, arm_nnz)
        u = torch.rand(q_nnz.shape, generator=generator, device=device)
        return u, below(q_nnz), below(arm_nnz)
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
# sparse box (§IV-A, Eq. 12)
# ---------------------------------------------------------------------------


class SparseQueries(NamedTuple):
    """A batch of sparse queries: the padded triplet and its position
    table."""
    idx: torch.Tensor       # (Q, mq) int32, sorted, pad = d
    val: torch.Tensor       # (Q, mq) fp32, pad = 0
    nnz: torch.Tensor       # (Q,) int32
    pos: torch.Tensor       # (Q, d + 1) int32: coordinate t at idx[pos]; −1

    def rows(self, s: int, e: int) -> "SparseQueries":
        return SparseQueries(*(f[s:e] for f in self))


def sparse_queries(q_idx, q_val, q_nnz, d: int, device) -> SparseQueries:
    """The (Q, mq) padded triplet on ``device``, with each query's position
    table: coordinate t sits at position ``pos[q, t]`` of the index list,
    −1 where absent. Column d (the pad sentinel) holds the first pad, as
    the reference's ``searchsorted`` finds it, or −1 for a full row."""
    idx = torch.as_tensor(q_idx, dtype=torch.int32, device=device)
    val = torch.as_tensor(q_val, dtype=torch.float32, device=device)
    nnz = torch.as_tensor(q_nnz, dtype=torch.int32, device=device)
    Q, mq = idx.shape
    pos = torch.full((Q, d + 1), -1, dtype=torch.int32, device=device)
    # the least position of each coordinate: the only one of a real
    # coordinate, the first pad of the sentinel
    pos.scatter_reduce_(1, torch.clamp(idx, 0, d).long(),
                        torch.arange(mq, dtype=torch.int32,
                                     device=device).expand(Q, mq),
                        reduce="amin", include_self=False)
    return SparseQueries(idx, val, nnz, pos)


def _sparse_lookup(indices, values, row, t):
    """Value of corpus row ``row`` at coordinate ``t`` (0 if absent) and a
    membership flag, for tensors ``row`` and ``t`` of one shape — the
    reference's lookup: the leftmost position whose index is ≥ t, clipped
    to the last column. A binary search over the sorted row in
    bit_length(m) steps of one gather each: ``pos`` counts the entries
    below t found so far, and a step of s moves it to pos + s (at most m)
    when the entry before that is still below t."""
    m = indices.shape[1]
    flat = indices.reshape(-1)
    before = row.long() * m - 1           # the entry before position p
    pos = torch.zeros_like(before)
    for b in reversed(range(m.bit_length())):
        cand = torch.clamp(pos + (1 << b), max=m)
        pos = torch.where(flat[before + cand] < t, cand, pos)
    at = before + 1 + torch.clamp(pos, max=m - 1)
    found = flat[at] == t
    return torch.where(found, values.reshape(-1)[at], 0.0), found


def _gather_rows(table, cols):
    """``table[q, cols[q, ...]]`` for a (Q, w) table and (Q, ...) cols."""
    Q = table.shape[0]
    return torch.gather(table, 1, cols.reshape(Q, -1).long()).reshape(
        cols.shape)


def _sparse_pull_block(ds: SparseDataset, qs: SparseQueries, arm, u, jq, ja):
    live = arm >= 0
    a = torch.where(live, arm, 0).long()                     # (Q, B)
    an = torch.where(live, ds.nnz[a], 0)
    qn = qs.nnz[:, None, None]
    tot = (qn + an[..., None]).to(torch.float32)             # (Q, B, 1)
    from_query = u < qn.to(torch.float32) / torch.clamp(tot, min=1.0)
    # a support coordinate from the chosen side
    tq = _gather_rows(qs.idx, jq)
    ta = ds.indices.reshape(-1)[a[..., None] * ds.m + ja.long()]
    t = torch.where(from_query, tq, ta)
    # both sides' values at t
    rows = a[..., None].expand(t.shape)
    va, found_a = _sparse_lookup(ds.indices, ds.values, rows, t)
    pq = _gather_rows(qs.pos, t)
    found_q = pq >= 0
    vq = torch.where(found_q, _gather_rows(qs.val, torch.clamp(pq, min=0)),
                     0.0)
    in_other = torch.where(from_query, found_a, found_q)
    # the divisor as a tensor: CUDA would multiply by the reciprocal of a
    # host scalar instead, one rounding away from the reference
    mult = tot / tot.new_tensor(2.0 * ds.d) * (
        1.0 + (~in_other).to(torch.float32))
    # Eq. 12's value (ℓ1 coordinate distance), θ already normalized by d
    val = mult * torch.abs(vq - va)
    # the both-sides-empty case (an empty or tombstoned row against an
    # empty query): the support union is empty, so θ = 0 exactly, and the
    # coordinate drawn above is padding that must not contribute
    return torch.where(tot > 0, val, 0.0)


def sparse_pull_one(ds: SparseDataset, qs: SparseQueries, arm, draws,
                    *, chunk: int = SPARSE_CHUNK) -> torch.Tensor:
    """Eq. 12 samples of θ̂: for query q and arm ``arm[q, b]`` (−1: a lane
    whose result is discarded, read as an empty arm), one sample from each
    of the draws (u, jq, ja), each (Q, B, P) — the reference's
    ``sparse_pull_one`` on every lane, ``chunk`` lanes at a time."""
    u, jq, ja = draws
    Q, B, P = u.shape
    out = torch.empty((Q, B, P), dtype=torch.float32, device=u.device)
    step = max(1, chunk // max(B * P, 1))
    for s in range(0, Q, step):
        e = s + step
        out[s:e] = _sparse_pull_block(ds, qs.rows(s, e), arm[s:e], u[s:e],
                                      jq[s:e], ja[s:e])
    return out


def _sparse_pull_fn(ds: SparseDataset, qs: SparseQueries, cfg: BMOConfig,
                    sample_coords: CoordSampler):
    """(Q, B) arm ids → (Q, B, P) pulls, P = ``cfg.pulls_per_round``, with
    the draws of ``sample_coords``."""
    P = cfg.pulls_per_round

    def pull(arm_idx):
        Q, B = arm_idx.shape
        an = torch.where(arm_idx >= 0, ds.nnz[torch.clamp(arm_idx, min=0)], 0)
        draws = sample_coords(qs.nnz[:, None, None].expand(Q, B, P),
                              an[..., None].expand(Q, B, P))
        return sparse_pull_one(ds, qs, arm_idx, draws)

    return pull


def _sparse_exact_block(ds: SparseDataset, qs: SparseQueries, arm):
    Q, B = arm.shape
    mq = qs.idx.shape[1]
    a = arm.long()
    ai, av = ds.indices[a], ds.values[a]                     # (Q, B, m)
    real = ai < ds.d
    pq = _gather_rows(qs.pos, ai)
    in_q = (pq >= 0) & real
    # the arm's values at the query's coordinates, by position (column mq
    # takes the entries outside the query's support)
    at_q = torch.zeros((Q, B, mq + 1), dtype=torch.float32, device=av.device)
    at_q.scatter_(2, torch.where(in_q, pq, mq).long(),
                  torch.where(in_q, av, 0.0))
    term1 = torch.sum(torch.abs(qs.val[:, None, :] - at_q[..., :mq])
                      * (qs.idx < ds.d)[:, None, :], -1)
    term2 = torch.sum(torch.abs(av) * (~in_q & real), -1)
    return (term1 + term2) / term1.new_tensor(float(ds.d))


def sparse_exact_theta(ds: SparseDataset, qs: SparseQueries, arm_idx, *,
                       chunk: int = SPARSE_CHUNK) -> torch.Tensor:
    """θ = ‖q − x_i‖₁ / d for query q and arm ``arm_idx[q, b]``, (Q, B),
    in the reference's two terms and order: Σ_{t∈Sq} |q_t − x_t| +
    Σ_{t∈Si, t∉Sq} |x_t|, then / d. Cost ≈ n_q + n_i lookups (the paper's
    sparsity-aware exact baseline). Takes the arms' rows, ``chunk``
    entries at a time."""
    Q, B = arm_idx.shape
    out = torch.empty((Q, B), dtype=torch.float32, device=arm_idx.device)
    step = max(1, chunk // max(B * max(ds.m, qs.idx.shape[1]), 1))
    for s in range(0, Q, step):
        out[s:s + step] = _sparse_exact_block(ds, qs.rows(s, s + step),
                                              arm_idx[s:s + step])
    return out


def query_sparse(ds: SparseDataset, q_idx, q_val, q_nnz, cfg: BMOConfig,
                 rng=None, *, eliminate: bool = True,
                 coord_sampler: Optional[CoordSampler] = None
                 ) -> RaceResult:
    """k-NN of one sparse query (its padded (mq,) index and value rows and
    its nnz) — ℓ1 only. The draws come from ``coord_sampler``, else from
    ``rng`` (a seed or a ``torch.Generator`` on the corpus's device)."""
    dev = ds.device
    if coord_sampler is None:
        coord_sampler = default_coord_sampler(
            make_generator(0 if rng is None else rng, dev), dev)
    qs = sparse_queries(torch.as_tensor(q_idx)[None],
                        torch.as_tensor(q_val)[None],
                        torch.as_tensor(q_nnz).reshape(1), ds.d, dev)
    pull = _sparse_pull_fn(ds, qs, cfg, coord_sampler)
    exact_cost = (ds.nnz + qs.nnz[0]).to(torch.float32)
    # an arm is 'exactly evaluable' after ~support-size pulls (cost parity
    # with the sparse exact computation), min 8 to keep CIs meaningful
    return race_topk(
        lambda arm: pull(arm[None])[0],
        lambda arm: sparse_exact_theta(ds, qs, arm[None])[0],
        n=ds.n,
        max_pulls=torch.clamp(exact_cost, min=8.0),
        pull_cost=1.0,
        exact_cost=exact_cost,
        cfg=cfg, device=dev, eliminate=eliminate,
        max_pulls_static=ds.m + qs.idx.shape[1],
    )


# ---------------------------------------------------------------------------
# multi-query drivers (Algorithm 2 iterates queries; embarrassingly parallel)
# ---------------------------------------------------------------------------


def _stack(res) -> KNNResult:
    return KNNResult(indices=torch.stack([r.topk for r in res]),
                     values=torch.stack([r.topk_values for r in res]),
                     coord_ops=torch.stack([r.coord_ops for r in res]),
                     rounds=torch.stack([r.rounds for r in res]),
                     n_exact=torch.stack([r.n_exact for r in res]))


def knn(corpus, queries, cfg: BMOConfig, rng=0, *, impl: str = "auto",
        eliminate: bool = True, device=None,
        sign_sampler: Optional[Callable[[int], torch.Tensor]] = None,
        block_samplers: Optional[Callable[[int], BlockSampler]] = None,
        coord_samplers: Optional[Callable[[int], CoordSampler]] = None
        ) -> KNNResult:
    """k-NN of each query against the corpus, one race per query, on
    ``device`` (default: the GPU).

    corpus: (n, d) numpy or tensor (dense/rotated), or a ``SparseDataset``
    (``cfg.sparse``). queries: (Q, d), or the (q_idx, q_val, q_nnz) padded
    triplet for the sparse box. ``cfg.rotate`` applies the §IV-B Hadamard
    rotation to corpus and queries together (ℓ2 only; distances
    preserved).

    ``rng`` is a seed or a ``torch.Generator`` on the device: it draws the
    rotation signs, then every query's block ids or sparse coordinates.
    ``sign_sampler(dp)``, ``block_samplers(i)`` and ``coord_samplers(i)``
    (query i's sampler) replace those draws.
    """
    dev = resolve_device(device)
    gen = make_generator(rng, dev)
    if cfg.sparse:
        if not isinstance(corpus, SparseDataset):
            raise TypeError("the sparse box races a SparseDataset corpus")
        ds = corpus.to(dev)
        q_idx, q_val, q_nnz = (torch.as_tensor(t, device=dev)
                               for t in queries)
        if coord_samplers is None:
            shared = default_coord_sampler(gen, dev)
            coord_samplers = lambda i: shared              # noqa: E731
        return _stack([query_sparse(ds, q_idx[i], q_val[i], q_nnz[i], cfg,
                                    eliminate=eliminate,
                                    coord_sampler=coord_samplers(i))
                       for i in range(q_idx.shape[0])])
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

    return _stack([query_dense(ds, qs[i], cfg, impl=impl,
                               eliminate=eliminate,
                               block_sampler=block_samplers(i))
                   for i in range(qs.shape[0])])


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
