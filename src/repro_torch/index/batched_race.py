"""Cross-query batched racing: the epoch-fused, survivor-compacted driver
(DESIGN.md §4) for dense and rotated stores.

Each epoch pulls T = R·P sampled corpus blocks for the B lowest-LCB
candidates of every query in ONE ``fused_epoch_pull`` launch, merges the
on-chip Welford statistics, lazily evaluates exactly any arm past MAX_PULLS,
and runs the Alg. 1 acceptance step once. Between epochs the host gathers
the survivors into shrinking power-of-two buckets (``index/frontier.py``),
so bookkeeping scales with survivors instead of n.

The host and the device meet once per epoch: one ``.cpu()`` of the survivor
counts, the done flags and the largest pull count among arms still to be
pulled (the counterpart of the reference's ``host_fetch``). The last of
these tells the host whether the next epoch can push any arm past MAX_PULLS,
which is what gates the exact evaluation; the reference gates it with an
on-device ``lax.cond``.

Block ids come from a replaceable ``block_sampler(shape, nb)`` that returns
an int32 tensor on the corpus's device; the default draws from the query's
``torch.Generator``. The tests replace it to replay the reference's draws.

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
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import BMOConfig
from repro_torch.core import confidence as conf
from repro_torch.core.bmo_nn import KNNResult
from repro_torch.core.ucb import (INF, acceptance_step_masked, smallest_k,
                                  topk_from_state_masked)
from repro_torch.device import make_generator
from repro_torch.index.frontier import (FrontierState, bucket_width,
                                        compact_frontier, floor_width,
                                        pow2_floor, survivors)
from repro_torch.kernels import ops as kops

BlockSampler = Callable[[tuple, int], torch.Tensor]


def _dense_exact_theta(x, qs, sel, metric: str, d: int):
    """Exact θ for selected slots: full-row distance / d (Alg. 1's lazy
    exact evaluation). sel (Q, B) → (Q, B). The race passes d = d_pad, the
    scale its pulls estimate."""
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
    prior2 = prior_var[None].expand(Q, n)
    prior_pool = torch.sum(prior2 * alive_f[None], 1) / torch.clamp(
        n_alive, min=1.0)

    all_arms = torch.arange(n, dtype=torch.int32, device=dev)[None].expand(Q, n)
    blk = sample_blocks((Q, n, T0), nb)
    stats = kops.fused_epoch_pull(x, qs, all_arms, blk, block=block,
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
    state and the (Q,) survivor counts, done flags and largest pull count
    among arms the next epoch may select, packed in one fp64 tensor for the
    host."""
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
    host = torch.cat([n_surv.to(torch.float64), done.to(torch.float64),
                      count_hi.to(torch.float64).reshape(1)])
    return st2, host


def _fused_finalize(st: FrontierState, prior_pool, *, cfg: BMOConfig,
                    log_term: float, prior_weight: float):
    ci = _frontier_ci(st, cfg, log_term, prior_pool, prior_weight)
    topk, topk_vals = topk_from_state_masked(
        st.mean, ci, st.accepted, st.rejected, st.valid, st.ids, cfg.k)
    return topk, topk_vals, st.n_exact


def default_block_sampler(generator: torch.Generator,
                          device: torch.device) -> BlockSampler:
    """Uniform block ids from ``generator``, int32 on ``device``."""
    def sample(shape, nb):
        return torch.randint(0, nb, shape, generator=generator,
                             device=device, dtype=torch.int32)
    return sample


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
    while not done.all() and rounds_spent < max_rounds:
        need = int(n_surv[~done].max(initial=1))
        if compaction:
            W_new = bucket_width(need, floor=floor_w, current=st.width)
            if W_new < st.width:
                st = compact_frontier(st, W_new=W_new)
        R = min(R0 * pow2_floor(W0 // max(need, 1)), R_cap)
        st, host = _fused_epoch_step(
            x, qs, st, prior_pool, block_sampler, cfg=cfg, block=block, d=d,
            impl=impl, eliminate=eliminate, prior_weight=prior_weight,
            log_term=log_term, T=R * P, may_cross=count_hi + R * P >= nb)
        rounds_spent += R
        # the per-epoch boundary: survivor counts, done flags and the pull
        # bound cross to the host to drive the reallocation loop
        host = host.cpu().numpy()
        n_surv = host[:Q].astype(np.int64)
        done = host[Q:2 * Q] > 0
        count_hi = float(host[-1])

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


def index_knn(store, queries, generator=None, *, k=None, impl: str = "auto",
              eliminate: bool = True, warm_start: bool = True,
              mode: str = "auto",
              block_sampler: Optional[BlockSampler] = None) -> KNNResult:
    """Batched k-NN of (Q, d) dense queries against a dense or rotated
    IndexStore (slot indices; tombstones excluded). ``mode`` "auto" and
    "fused" both run the epoch-fused driver; the per-round driver is not
    ported yet."""
    cfg = store.cfg if k is None else dataclasses.replace(store.cfg, k=k)
    n_live = store.n_live
    if cfg.k > n_live:
        raise ValueError(
            f"k={cfg.k} exceeds the index's {n_live} live slots — "
            "tombstoned slots can never be returned")
    if mode not in ("auto", "fused", "rounds"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "rounds":
        raise NotImplementedError("the per-round driver (mode='rounds') is "
                                  "not ported yet")
    w = store.prior_weight if warm_start else 0.0
    qs = store.prepare_queries(queries, impl=impl)
    return fused_race_topk(
        store.x, qs, store.alive, store.prior_var, generator,
        cfg=cfg, block=store.block, d=store.d, impl=impl,
        eliminate=eliminate, prior_weight=w, block_sampler=block_sampler)
