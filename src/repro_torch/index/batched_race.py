"""Cross-query batched racing: two drivers for dense and rotated stores, and
the per-round one for sparse stores.

``batched_race_topk`` (the per-round driver, DESIGN.md §3.2) races one
(Q, n) arm state with one ``block_pull_multi`` launch per round: the B
lowest-LCB candidates of every active query take P pulls each, arms past
MAX_PULLS are evaluated exactly, and the Alg. 1 acceptance step runs every
round. Its pieces (``RoundsRaceFns``, from ``core/ucb.make_rounds_race``,
which the paper path's one-query race shares) are generic over
``pull_fn`` / ``exact_fn`` closures, so other boxes and resumable sessions
can drive them. The host meets the device once per round: one ``host_fetch`` of
the all-done flag and the pull slack that gates the next round's exact
evaluation.

``fused_race_topk`` (the epoch-fused, survivor-compacted driver,
DESIGN.md §4) pulls T = R·P sampled corpus blocks for the B lowest-LCB
candidates of every query in ONE ``fused_epoch_pull`` launch, merges the
on-chip Welford statistics, lazily evaluates exactly any arm past MAX_PULLS,
and runs the Alg. 1 acceptance step once. Between epochs the host gathers
the survivors into shrinking power-of-two buckets (``index/frontier.py``),
so bookkeeping scales with survivors instead of n.

The fused driver's host and device meet once per epoch: one
``host_fetch`` (``utils/hostsync.py``) of the survivor counts, the done
flags, the epoch's coordinate reads and the largest pull count among arms
still to be pulled. Each epoch records its wall time into the
``repro_race_epoch_ms{kind="fused_blocking"}`` histogram and one
``fused_epoch_pull`` launch into the kernel counters of the process's obs
context (the wide init is not counted), as the reference does; the tuner
reads its epoch and round costs from that histogram. The
last of these tells the host whether the next epoch can push any arm past
MAX_PULLS, which is what gates the exact evaluation; the reference gates it
with an on-device ``lax.cond``.

Block ids come from a replaceable ``block_sampler(shape, nb)`` that returns
an int32 tensor on the corpus's device, a sparse pull's draws from a
replaceable ``coord_sampler(q_nnz, arm_nnz)``; the defaults draw from the
query's ``torch.Generator``. The tests replace them to replay the
reference's draws.

The sparse box (§IV-A) races on the per-round driver only: its pulls are
Eq. 12 coordinate samples (``core/bmo_nn.py``), its exact evaluation
costs n_q + n_i, per arm and query, and an arm is exact after that many
pulls (at least 8).

Priors: the store's build-time per-arm variance priors are (n,); a caller
may seed per-query (Q, n) priors instead (``index_knn(prior_hint=…)``).

Scale: a pull is a block mean over the d_pad-wide (padded or rotated) row,
so the pulls estimate ρ/d_pad, and the race compares every arm on that
scale — its exact evaluations too. The reference divides exact evaluations
by the true d instead, which makes an arm look d_pad/d times worse the
moment it becomes exact and costs recall whenever d_pad ≠ d (ROADMAP.md,
Queue 3). Reported values are converted to θ = ρ/d.

Tombstoned (dead) slots enter the race pre-rejected: they are never
selected, never pulled, and can never be returned.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import BMOConfig
from repro_torch.core import confidence as conf
from repro_torch.core.bmo_nn import (BlockSampler, CoordSampler, KNNResult,
                                     _sparse_pull_fn, default_block_sampler,
                                     default_coord_sampler,
                                     sparse_exact_theta, sparse_queries)
from repro_torch.core.datasets import SparseDataset
from repro_torch.core.ucb import (INF, RoundsRaceFns, _prior2,
                                  acceptance_step_masked, make_rounds_race,
                                  smallest_k, topk_from_state,
                                  topk_from_state_masked)
from repro_torch.device import make_generator
from repro_torch.index.frontier import (FrontierState, bucket_width,
                                        compact_frontier, floor_width,
                                        pow2_floor, survivors)
from repro_torch.kernels import ops as kops
from repro_torch.obs import get_obs
from repro_torch.obs import profile as obs_profile
from repro_torch.utils.hostsync import host_fetch


def run_to_certification(fns: RoundsRaceFns, k: int) -> KNNResult:
    """Drive a rounds race to completion, one host round at a time."""
    st = fns.init()
    while fns.active(st):
        st = fns.body(st)
    topk, topk_vals = topk_from_state(st.mean, fns.ci_radius(st),
                                      st.accepted, st.rejected, k)
    return KNNResult(indices=topk, values=topk_vals, coord_ops=st.coord_ops,
                     rounds=st.rounds,
                     n_exact=torch.sum(st.exact, 1, dtype=torch.int32))


def batched_race_topk(
    pull_fn: Callable,          # (sel (Q, B)) -> (Q, B, P) samples
    exact_fn: Callable,         # (sel (Q, B)) -> (Q, B) exact θ
    n: int,
    Q: int,
    max_pulls,                  # scalar, (n,) or (Q, n)
    pull_cost: float,
    exact_cost,                 # scalar, (n,) or (Q, n)
    cfg: BMOConfig,
    *,
    device: torch.device,
    eliminate: bool = True,
    dead: Optional[torch.Tensor] = None,       # (n,) bool tombstones
    prior_var: Optional[torch.Tensor] = None,  # (n,) or (Q, n) variance prior
    prior_weight: float = 0.0,
    max_pulls_static: int = 0,
) -> KNNResult:
    fns = make_rounds_race(
        pull_fn, exact_fn, n, Q, max_pulls, pull_cost, exact_cost, cfg,
        device=device, eliminate=eliminate, dead=dead, prior_var=prior_var,
        prior_weight=prior_weight, max_pulls_static=max_pulls_static)
    return run_to_certification(fns, cfg.k)


# ---------------------------------------------------------------------------
# Epoch-fused driver (DESIGN.md §4): R rounds per launch, survivor-compacted
# bookkeeping. Dense/rotated boxes only — the pulls are corpus-block reads.
# ---------------------------------------------------------------------------


def _dense_exact_theta(x, qs, sel, metric: str, d: int):
    """Exact θ for selected slots: full-row distance / d (Alg. 1's lazy
    exact evaluation, shared by both dense drivers). sel (Q, B) → (Q, B).
    The races pass d = d_pad, the scale their pulls estimate."""
    rows = x[sel.long()]                                     # (Q, B, d_pad)
    diff = rows - qs[:, None, :]
    if metric == "l1":
        dist = torch.sum(torch.abs(diff), dim=-1)
    else:
        dist = torch.sum(diff * diff, dim=-1)
    return dist / d


def _frontier_ci(st: FrontierState, cfg: BMOConfig, log_term: float,
                 prior_pool, prior_weight: float) -> torch.Tensor:
    """Masked CI radii over the compacted frontier. The variance pool is
    taken over survivors, so the radii — and every decision — are invariant
    under frontier compaction."""
    Q, W = st.mean.shape
    if cfg.sigma is not None:
        sig_sq = torch.full((Q, W), float(cfg.sigma) ** 2,
                            dtype=torch.float32, device=st.mean.device)
    else:
        pool_f = survivors(st).to(torch.float32)
        num = torch.sum(st.m2 * pool_f, 1) + prior_weight * prior_pool
        den = (torch.sum(torch.clamp(st.count - 1.0, min=0.0) * pool_f, 1)
               + prior_weight)
        global_var = num / torch.clamp(den, min=1.0)          # (Q,)
        sig_sq = conf.empirical_sigma_sq_prior(
            st.m2, st.count, 1e-12, global_var[:, None], st.prior,
            prior_weight)
    c = conf.hoeffding_radius_masked(sig_sq, st.count, log_term, st.valid)
    return torch.where(st.exact, 0.0, c)


def _need(st: FrontierState) -> torch.Tensor:
    """(Q, W) bool — entries the next epoch may select for pulls."""
    return (st.valid & ~st.accepted & ~st.rejected & ~st.exact
            & ~st.done[:, None])


def _fused_init(x, qs, alive, prior_var, sample_blocks: BlockSampler, *,
                cfg: BMOConfig, block: int, impl: str, prior_weight: float):
    """Full-width frontier after the paper's wide init: every alive arm of
    every query gets ``init_pulls`` samples from ONE fused launch. Returns
    (state, prior_pool); the pool term is frozen here so it stays invariant
    across compactions."""
    n = x.shape[0]
    Q = qs.shape[0]
    nb = x.shape[1] // block
    P = cfg.pulls_per_round
    T0 = max(1, max(cfg.init_pulls, 2) // P) * P
    dev = x.device

    alive_f = alive.to(torch.float32)
    n_alive = torch.sum(alive_f)
    prior2 = _prior2(prior_var, Q, n)
    prior_pool = torch.sum(prior2 * alive_f[None], 1) / torch.clamp(
        n_alive, min=1.0)

    all_arms = torch.arange(n, dtype=torch.int32, device=dev)[None].expand(Q, n)
    # the draw keeps the reference's (Q, n, T0) shape; a padding or dead row
    # pulls nothing (arm id −1), and the masked merge below drops its result
    live_arms = torch.where(alive, all_arms[0], -1)[None].expand(Q, n)
    blk = sample_blocks((Q, n, T0), nb)
    stats = kops.fused_epoch_pull(x, qs, live_arms, blk, block=block,
                                  metric=cfg.metric, impl=impl,
                                  n_buf=cfg.kernel_buffers)
    zeros = torch.zeros((Q, n), dtype=torch.float32, device=dev)
    mask = alive_f[None].expand(Q, n)
    mean, count, m2 = conf.welford_merge(
        zeros, zeros, zeros, stats[..., 0], float(T0), stats[..., 1], mask)
    st = FrontierState(
        ids=all_arms,
        mean=mean, count=count, m2=m2,
        prior=prior2,
        exact=torch.zeros((Q, n), dtype=torch.bool, device=dev),
        accepted=torch.zeros((Q, n), dtype=torch.bool, device=dev),
        rejected=(~alive)[None].expand(Q, n),
        valid=alive[None].expand(Q, n),
        coord_ops=torch.full((Q,), float(T0 * block), device=dev) * n_alive,
        n_exact=torch.zeros((Q,), dtype=torch.int32, device=dev),
        rounds=torch.zeros((Q,), dtype=torch.int32, device=dev),
        done=torch.zeros((Q,), dtype=torch.bool, device=dev),
    )
    return st, prior_pool


def _fused_epoch_step(x, qs, st: FrontierState, prior_pool,
                      sample_blocks: BlockSampler, *, cfg: BMOConfig,
                      block: int, d: int, impl: str, eliminate: bool,
                      prior_weight: float, log_term: float, T: int,
                      may_cross: bool):
    """One epoch: select B lowest-LCB candidates per query, pull each T
    times in one fused launch, merge the Welford stats, lazily exact-evaluate
    arms that crossed MAX_PULLS, then run acceptance ONCE. Everything is
    O(Q·W) with W the current bucket width.

    ``may_cross`` is False only when no selectable arm can reach MAX_PULLS
    in this epoch; the exact evaluation is skipped then. Returns the new
    state and, packed in one fp64 tensor for the host, the (Q,) survivor
    counts, the (Q,) done flags, the epoch's coordinate reads summed over
    the queries and the largest pull count among arms the next epoch may
    select (last)."""
    Q, W = st.mean.shape
    k = cfg.k
    B = min(cfg.batch_arms, W)
    nb = x.shape[1] // block
    max_pulls = float(nb)

    ci = _frontier_ci(st, cfg, log_term, prior_pool, prior_weight)
    need = _need(st)

    # ---- selection: per query, B lowest-LCB candidates, in the reference's
    # order (it decides which row of block ids each arm gets) --------------
    sel = smallest_k(torch.where(need, st.mean - ci, INF), B)  # (Q, B)
    sel_valid = torch.gather(need, 1, sel)
    slot = torch.gather(st.ids, 1, sel)
    # a lane whose selection is not valid pulls nothing (arm id -1); the
    # masked merge below discards its result either way
    slot_pull = torch.where(sel_valid, slot, -1)

    # ---- one fused launch: T pulls per selected arm, reduced on-chip -----
    blk = sample_blocks((Q, B, T), nb)
    stats = kops.fused_epoch_pull(x, qs, slot_pull, blk, block=block,
                                  metric=cfg.metric, impl=impl,
                                  n_buf=cfg.kernel_buffers)
    cm = torch.gather(st.mean, 1, sel)
    cc = torch.gather(st.count, 1, sel)
    c2 = torch.gather(st.m2, 1, sel)
    nm, nc, n2 = conf.welford_merge(
        cm, cc, c2, stats[..., 0], float(T), stats[..., 1],
        sel_valid.to(torch.float32))
    coord_ops = st.coord_ops + torch.sum(sel_valid, 1) * float(T * block)

    # ---- lazy exact evaluation for arms that crossed MAX_PULLS -----------
    sel_exact = torch.gather(st.exact, 1, sel)
    crossed = (nc >= max_pulls) & sel_valid & ~sel_exact
    if may_cross:
        exact_vals = _dense_exact_theta(x, qs, torch.where(sel_valid, slot, 0),
                                        cfg.metric, x.shape[1])
        nm = torch.where(crossed, exact_vals, nm)
    mean = st.mean.scatter(1, sel, nm)
    count = st.count.scatter(1, sel, nc)
    m2 = st.m2.scatter(1, sel, n2)
    exact = st.exact.scatter(1, sel, sel_exact | crossed)
    coord_ops = coord_ops + torch.sum(crossed, 1) * float(d)

    st2 = st._replace(mean=mean, count=count, m2=m2, exact=exact,
                      coord_ops=coord_ops,
                      n_exact=st.n_exact + torch.sum(crossed, 1,
                                                     dtype=torch.int32))

    # ---- acceptance / rejection, ONCE per epoch --------------------------
    ci2 = _frontier_ci(st2, cfg, log_term, prior_pool, prior_weight)
    accept_new, rejected = acceptance_step_masked(
        st2.mean, ci2, st2.exact, st2.accepted, st2.rejected, st2.valid, k,
        epsilon=cfg.epsilon, eliminate=eliminate)
    accepted = st2.accepted | accept_new
    frozen = st.done[:, None]
    accepted = torch.where(frozen, st.accepted, accepted)
    rejected = torch.where(frozen, st.rejected, rejected)

    # done at k certified arms — or at candidate exhaustion
    no_candidates = torch.sum(st2.valid & ~accepted & ~rejected, 1) == 0
    done = st.done | (torch.sum(accepted, 1) >= k) | no_candidates
    # a finished query retires its unresolved candidates, so its survivor
    # set is exactly its k accepted arms
    rejected = torch.where(done[:, None], rejected | ~accepted, rejected)
    R = max(1, T // cfg.pulls_per_round)
    rounds = torch.where(st.done, st.rounds, st.rounds + R)
    st2 = st2._replace(accepted=accepted, rejected=rejected,
                       rounds=rounds, done=done)
    n_surv = torch.sum(st2.valid & ~st2.rejected & ~st2.done[:, None], 1)
    count_hi = torch.amax(torch.where(_need(st2), st2.count, 0.0))
    coord_delta = torch.sum((st2.coord_ops - st.coord_ops).to(torch.float64))
    host = torch.cat([n_surv.to(torch.float64), done.to(torch.float64),
                      coord_delta.reshape(1),
                      count_hi.to(torch.float64).reshape(1)])
    return st2, host


def _fused_finalize(st: FrontierState, prior_pool, *, cfg: BMOConfig,
                    log_term: float, prior_weight: float):
    ci = _frontier_ci(st, cfg, log_term, prior_pool, prior_weight)
    topk, topk_vals = topk_from_state_masked(
        st.mean, ci, st.accepted, st.rejected, st.valid, st.ids, cfg.k)
    return topk, topk_vals, st.n_exact


def fused_race_topk(x, qs, alive, prior_var, generator=None, *,
                    cfg: BMOConfig, block: int, d: int, impl: str,
                    eliminate: bool, prior_weight: float,
                    compaction: bool = True,
                    block_sampler: Optional[BlockSampler] = None,
                    _return_state: bool = False):
    """Epoch-fused, survivor-compacted dense/rotated race (DESIGN.md §4).

    The host iterates epochs, each running R fused pull-rounds in one
    kernel launch and one acceptance pass. As the frontier shrinks by c×,
    R scales up by c× (capped at MAX_PULLS worth), keyed off the survivor
    count so the pull schedule is the same with compaction on or off.

    ``generator`` (a ``torch.Generator`` on x's device, or a seed) feeds the
    default block sampler; ``block_sampler`` replaces it.
    ``compaction=False`` keeps the full-width buffers (the invariance
    tests); ``_return_state`` also returns the final FrontierState.
    """
    n = x.shape[0]
    Q = qs.shape[0]
    P = cfg.pulls_per_round
    nb = x.shape[1] // block
    B0 = min(cfg.batch_arms, n)
    log_term = math.log(2.0 / conf.delta_prime(cfg.delta, n, nb))
    max_rounds = cfg.max_rounds or int(
        2 * math.ceil(n * nb / max(B0 * P, 1)) + n + 16)
    R0 = max(cfg.epoch_rounds, 1)
    R_cap = max(1, -(-nb // P))          # one epoch never overshoots exact
    floor_w = floor_width(cfg, n, B0=B0)
    if block_sampler is None:
        block_sampler = default_block_sampler(
            make_generator(0 if generator is None else generator, x.device),
            x.device)

    st, prior_pool = _fused_init(x, qs, alive, prior_var, block_sampler,
                                 cfg=cfg, block=block, impl=impl,
                                 prior_weight=prior_weight)
    W0 = st.width
    T0 = max(1, max(cfg.init_pulls, 2) // P) * P
    rounds_spent = 0
    n_surv = np.full((Q,), n)
    done = np.zeros((Q,), bool)
    count_hi = float(T0)
    obs = get_obs()
    epoch_ms = obs.registry.histogram(
        "repro_race_epoch_ms", "wall time of one race epoch (ms)",
        kind="fused_blocking")
    while not done.all() and rounds_spent < max_rounds:
        need = int(n_surv[~done].max(initial=1))
        if compaction:
            W_new = bucket_width(need, floor=floor_w, current=st.width)
            if W_new < st.width:
                st = compact_frontier(st, W_new=W_new)
        R = min(R0 * pow2_floor(W0 // max(need, 1)), R_cap)
        t0 = time.perf_counter()
        with obs_profile.annotate("repro.race.epoch.fused_blocking"):
            st, host = _fused_epoch_step(
                x, qs, st, prior_pool, block_sampler, cfg=cfg, block=block,
                d=d, impl=impl, eliminate=eliminate,
                prior_weight=prior_weight, log_term=log_term, T=R * P,
                may_cross=count_hi + R * P >= nb)
            rounds_spent += R
            # the per-epoch boundary: survivor counts, done flags, the
            # epoch's coordinate reads and the pull bound cross to the host
            # in one transfer to drive the reallocation loop
            host = host_fetch(host)
        n_surv = host[:Q].astype(np.int64)
        done = host[Q:2 * Q] > 0
        count_hi = float(host[-1])
        epoch_ms.observe((time.perf_counter() - t0) * 1e3)
        obs_profile.record_kernel_launch(
            obs, "fused_epoch_pull", launches=1,
            coord_ops=float(host[2 * Q]), pulls=float(R))

    topk, topk_vals, n_exact = _fused_finalize(
        st, prior_pool, cfg=cfg, log_term=log_term,
        prior_weight=prior_weight)
    # from the race's ρ/d_pad to the reported θ = ρ/d (a factor of exactly
    # 1.0 when d_pad = d)
    res = KNNResult(indices=topk, values=topk_vals * (x.shape[1] / d),
                    coord_ops=st.coord_ops,
                    rounds=st.rounds, n_exact=n_exact)
    if _return_state:
        return res, st
    return res


def local_dense_race(x_parts: Sequence[torch.Tensor],
                     q_parts: Sequence[torch.Tensor], alive, prior,
                     samplers: Sequence[BlockSampler], *, cfg: BMOConfig,
                     block: int, exact_cost: float, impl: str,
                     eliminate: bool, prior_weight: float):
    """The per-round driver's dense race over one store's (or one shard's)
    slots, one ``block_pull_multi`` launch a round and part. The slots'
    columns may be split over M model parts (``core/distributed.py``): a
    pull then takes one block of each part, drawn by that part's sampler,
    and averages the M partial block means (the reference's ``pmean``); an
    exact evaluation sums the parts' distances over the pulls' width, the
    total width of the parts (d_pad for an index shard). Results land on
    the first part's device."""
    dev = x_parts[0].device
    n_loc, d_m = x_parts[0].shape
    nb_loc = d_m // block
    width = float(sum(x.shape[1] for x in x_parts))
    M = len(x_parts)
    P = cfg.pulls_per_round

    def pull(sel):
        vals = []
        for x, q, sample in zip(x_parts, q_parts, samplers):
            blk = sample(tuple(sel.shape) + (P,), nb_loc)
            vals.append(kops.block_pull_multi(
                x, q, sel.to(x.device), blk.to(x.device), block=block,
                metric=cfg.metric, impl=impl).to(dev))
        return vals[0] if M == 1 else sum(vals) / M

    def exact(sel):
        th = [_dense_exact_theta(x, q, sel.to(x.device), cfg.metric,
                                 width).to(dev)
              for x, q in zip(x_parts, q_parts)]
        return th[0] if M == 1 else sum(th)

    return batched_race_topk(
        pull, exact, n=n_loc, Q=q_parts[0].shape[0], max_pulls=float(nb_loc),
        pull_cost=float(block), exact_cost=exact_cost, cfg=cfg, device=dev,
        eliminate=eliminate, dead=~alive, prior_var=prior,
        prior_weight=prior_weight)


def _dense_index_knn(x, qs, alive, prior_var, sample_blocks: BlockSampler, *,
                     cfg: BMOConfig, block: int, d: int, impl: str,
                     eliminate: bool, prior_weight: float) -> KNNResult:
    """The per-round driver on a dense/rotated store: one
    ``block_pull_multi`` launch per round. Races on the pulls' ρ/d_pad
    scale and reports θ = ρ/d."""
    res = local_dense_race([x], [qs], alive, prior_var, [sample_blocks],
                           cfg=cfg, block=block, exact_cost=float(d),
                           impl=impl, eliminate=eliminate,
                           prior_weight=prior_weight)
    # from the race's ρ/d_pad to θ = ρ/d (exactly 1.0 when d_pad = d)
    return res._replace(values=res.values * (x.shape[1] / d))


def make_sparse_rounds_race(indices, values, nnz, alive, prior_var,
                            q_idx, q_val, q_nnz,
                            sample_coords: CoordSampler, *, cfg: BMOConfig,
                            d: int, eliminate: bool, prior_weight: float
                            ) -> RoundsRaceFns:
    """The §IV-A sparse box's per-round race pieces: Eq. 12 pulls, exact
    evaluations in the reference's two terms, per-(query, arm) exact cost
    n_q + n_i and MAX_PULLS max(n_q + n_i, 8)."""
    n, m = indices.shape
    dev = indices.device
    ds = SparseDataset(indices=indices, values=values, nnz=nnz, d=d)
    qs = sparse_queries(q_idx, q_val, q_nnz, d, dev)
    Q, mq = qs.idx.shape
    exact_cost = (nnz[None, :] + qs.nnz[:, None]).to(torch.float32)  # (Q, n)
    return make_rounds_race(
        _sparse_pull_fn(ds, qs, cfg, sample_coords),
        lambda sel: sparse_exact_theta(ds, qs, sel),
        n=n, Q=Q, max_pulls=torch.clamp(exact_cost, min=8.0), pull_cost=1.0,
        exact_cost=exact_cost, cfg=cfg, device=dev, eliminate=eliminate,
        dead=~alive, prior_var=prior_var, prior_weight=prior_weight,
        max_pulls_static=m + mq)


def _sparse_index_knn(indices, values, nnz, alive, prior_var,
                      q_idx, q_val, q_nnz, sample_coords: CoordSampler, *,
                      cfg: BMOConfig, d: int, eliminate: bool,
                      prior_weight: float) -> KNNResult:
    fns = make_sparse_rounds_race(
        indices, values, nnz, alive, prior_var, q_idx, q_val, q_nnz,
        sample_coords, cfg=cfg, d=d, eliminate=eliminate,
        prior_weight=prior_weight)
    return run_to_certification(fns, cfg.k)


def index_knn(store, queries, generator=None, *, k=None, impl: str = "auto",
              eliminate: bool = True, warm_start: bool = True,
              mode: str = "auto", prior_hint=None,
              block_sampler: Optional[BlockSampler] = None,
              coord_sampler: Optional[CoordSampler] = None) -> KNNResult:
    """Batched k-NN against an IndexStore (slot indices; tombstones
    excluded): (Q, d) dense queries against a dense or rotated store, the
    (q_idx, q_val, q_nnz) padded triplet against a sparse one.

    ``mode``: "fused" — the epoch-fused, survivor-compacted driver
    (dense/rotated only); "rounds" — the one-launch-per-round driver;
    "auto" — fused where available, rounds for sparse.

    ``prior_hint``: optional (Q, capacity) per-query CI variance priors in
    place of the store's build-time per-arm priors (the near-repeat warm
    start); a seeded prior implies warm start. ``generator`` (a
    ``torch.Generator`` on the store's device, or a seed) feeds the default
    samplers; ``block_sampler`` and ``coord_sampler`` replace them.

    A ``ShardedIndexStore`` goes to ``sharded.sharded_index_knn`` (global
    slot ids), whose per-shard samplers come from ``generator``."""
    if hasattr(store, "shards"):
        from repro_torch.index.sharded import sharded_index_knn
        return sharded_index_knn(store, queries, generator, k=k, impl=impl,
                                 eliminate=eliminate, warm_start=warm_start,
                                 mode=mode, prior_hint=prior_hint)
    cfg = store.cfg if k is None else dataclasses.replace(store.cfg, k=k)
    n_live = store.n_live
    if cfg.k > n_live:
        raise ValueError(
            f"k={cfg.k} exceeds the index's {n_live} live slots — "
            "tombstoned slots can never be returned")
    if mode not in ("auto", "fused", "rounds"):
        raise ValueError(f"unknown mode {mode!r}")
    w = store.prior_weight if warm_start else 0.0
    prior = store.prior_var
    if prior_hint is not None:
        prior = torch.as_tensor(prior_hint, dtype=torch.float32,
                                device=store.device)
        w = store.prior_weight
    if store.kind == "sparse":
        if mode == "fused":
            raise ValueError("the fused epoch driver pulls corpus blocks — "
                             "sparse boxes race on the per-round driver")
        if coord_sampler is None:
            coord_sampler = default_coord_sampler(
                make_generator(0 if generator is None else generator,
                               store.device), store.device)
        q_idx, q_val, q_nnz = queries
        return _sparse_index_knn(
            store.indices, store.values, store.nnz, store.alive, prior,
            q_idx, q_val, q_nnz, coord_sampler, cfg=cfg, d=store.d,
            eliminate=eliminate, prior_weight=w)
    qs = store.prepare_queries(queries, impl=impl)
    if mode == "rounds":
        if block_sampler is None:
            block_sampler = default_block_sampler(
                make_generator(0 if generator is None else generator,
                               store.device), store.device)
        return _dense_index_knn(
            store.x, qs, store.alive, prior, block_sampler, cfg=cfg,
            block=store.block, d=store.d, impl=impl, eliminate=eliminate,
            prior_weight=w)
    return fused_race_topk(
        store.x, qs, store.alive, prior, generator,
        cfg=cfg, block=store.block, d=store.d, impl=impl,
        eliminate=eliminate, prior_weight=w, block_sampler=block_sampler)
