"""BMO-UCB (paper Algorithm 1): the acceptance rule, the final ranking, and
the per-query race ``race_topk``.

The reference applies the rule to 1-D arm state and ``vmap``s it over
queries; here it works on the last axis of (..., n) tensors directly.

``race_topk`` is generic over the Monte-Carlo box, like the paper's
formulation: it takes a ``pull_fn`` (sample the arm estimator) and an
``exact_fn`` (evaluate the arm mean exactly at the cost of MAX_PULLS
pulls), plus the CI machinery of ``core/confidence.py``. The reference
runs it in a ``while_loop``; here the host runs the rounds and stops on
the very round the reference stops on.

Ties: ``jax.lax.top_k`` and ``jnp.argmin`` put the lower index first among
equal keys, and the race's decisions depend on it (which arms fill the k
acceptance slots, which row of block ids each selected arm gets, the order
of equal final scores). ``torch.topk`` promises no order among ties, so
every selection whose order can matter goes through ``smallest_k``, a
stable sort.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import BMOConfig
from repro_torch.core import confidence as conf

INF = float("inf")


class RaceState(NamedTuple):
    mean: torch.Tensor          # (n,) running estimate of θ_i
    count: torch.Tensor         # (n,) pulls so far (in estimator samples)
    m2: torch.Tensor            # (n,) Welford sum of squared deviations
    exact: torch.Tensor         # (n,) bool: mean is exact, CI = 0
    accepted: torch.Tensor      # (n,) bool
    rejected: torch.Tensor      # (n,) bool (only when eliminate=True)
    accept_order: torch.Tensor  # (n,) int32 round at which accepted (else big)
    coord_ops: torch.Tensor     # () fp32: coordinate-wise distance comps
    rounds: int                 # rounds run (host-side)


class RaceResult(NamedTuple):
    topk: torch.Tensor          # (k,) arm indices, sorted by estimated θ
    topk_values: torch.Tensor   # (k,) θ estimates for those arms
    coord_ops: torch.Tensor
    rounds: torch.Tensor
    n_exact: torch.Tensor
    state: RaceState


def smallest_k(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` smallest entries along the last axis, ascending,
    the lower index first among ties — ``jax.lax.top_k(-score, k)[1]``."""
    return torch.sort(score, dim=-1, stable=True).indices[..., :k]


def acceptance_step(mean, ci, exact, accepted, rejected, k: int, *,
                    epsilon: float = 0.0, eliminate: bool = True):
    """One vectorized Alg. 1 acceptance/rejection pass over the last axis.
    Returns ``(accept_new, rejected_new)``: the arms newly certified this
    pass (capped at the k still needed, lowest means first) and the updated
    rejection mask."""
    n = mean.shape[-1]
    candidate = ~accepted & ~rejected
    lcb = torch.where(candidate, mean - ci, INF)
    ucb = mean + ci

    # min LCB excluding self among candidates; argmin takes the first minimum
    min1 = torch.amin(lcb, dim=-1, keepdim=True)
    argmin1 = torch.argmin(lcb, dim=-1, keepdim=True)
    is_min = torch.arange(n, device=mean.device) == argmin1
    min2 = torch.amin(torch.where(is_min, INF, lcb), dim=-1, keepdim=True)
    min_excl = torch.where(is_min, min2, min1)

    accept_cert = candidate & (ucb < min_excl)
    # exact-tie progress rule: the lowest-LCB arm, if exact, is accepted
    # when it cannot be beaten (<=); deterministic index tie-break.
    accept_tie = candidate & exact & is_min & (ucb <= min_excl)
    accept_new = accept_cert | accept_tie
    if epsilon > 0:  # PAC rule (Thm 2): selected arm with CI < ε/2
        accept_new = accept_new | (candidate & is_min & (ci < epsilon / 2))

    # never accept more than the k we still need, lowest means first
    still_needed = k - torch.sum(accepted, dim=-1, keepdim=True)
    best = smallest_k(torch.where(accept_new, mean, INF), k)
    slots = torch.arange(k, device=mean.device) < still_needed
    keep = torch.zeros_like(accept_new).scatter(-1, best, slots)
    accept_new = accept_new & keep

    rejected_new = rejected
    if eliminate:
        # an arm can't be top-k if its LCB > the k-th smallest UCB over the
        # non-rejected arms
        ucb_alive = torch.where(~rejected, ucb, INF)
        kth_ucb = torch.kthvalue(ucb_alive, k, dim=-1, keepdim=True).values
        rejected_new = rejected | (candidate & ~accept_new
                                   & ((mean - ci) > kth_ucb))
    return accept_new, rejected_new


def acceptance_step_masked(mean, ci, exact, accepted, rejected, valid, k: int,
                           *, epsilon: float = 0.0, eliminate: bool = True):
    """Compacted-frontier variant: padding entries (``valid`` = False) are
    treated as pre-rejected. ``rejected_new`` includes the padding."""
    return acceptance_step(mean, ci, exact, accepted, rejected | ~valid, k,
                           epsilon=epsilon, eliminate=eliminate)


def topk_from_state(mean, ci, accepted, rejected, k: int):
    """Final ranking: accepted arms first (by mean), then best remaining by
    LCB; rejected arms last. Returns (top-k indices, their means), sorted
    by mean."""
    score = torch.where(accepted, mean - 1e9,
                        torch.where(rejected, INF, mean - ci))
    topk = smallest_k(score, k)
    order = torch.argsort(torch.gather(mean, -1, topk), dim=-1, stable=True)
    topk = torch.gather(topk, -1, order)
    return topk, torch.gather(mean, -1, topk)


def topk_from_state_masked(mean, ci, accepted, rejected, valid, ids, k: int):
    """Compacted-frontier variant: ranks the W-wide buffers (padding
    pre-rejected) and maps the winning positions back to arm ids."""
    pos, vals = topk_from_state(mean, ci, accepted, rejected | ~valid, k)
    return torch.gather(ids, -1, pos), vals


def per_arm(value, shape, device, static: int = 0):
    """A scalar or per-arm ``value`` as an fp32 tensor of ``shape`` (a view
    where it broadcasts), and the upper bound the race's union bound takes:
    ``static``, else the largest value, as an int."""
    t = torch.as_tensor(value, dtype=torch.float32, device=device)
    return t.expand(shape), static or int(torch.max(t))


def pull_slack(count, max_pulls, need) -> torch.Tensor:
    """Largest ``count − max_pulls`` over the arms the next round may
    select (−inf when none): an arm can cross MAX_PULLS in a round of P
    pulls only if this is ≥ −P. The host reads it to gate the exact
    evaluation, which the reference gates with an on-device ``lax.cond``."""
    return torch.amax(torch.where(need, count - max_pulls, -INF))


def race_topk(
    pull_fn: Callable,          # (arm_idx (B,)) -> (B, P) sample values
    exact_fn: Callable,         # (arm_idx (B,)) -> (B,) exact θ
    n: int,
    max_pulls,                  # pulls that constitute an exact evaluation;
                                # scalar or (n,)
    pull_cost: float,           # coordinate-ops per sample (block width)
    exact_cost,                 # coordinate-ops per exact evaluation (d);
                                # scalar or (n,)
    cfg: BMOConfig,
    *,
    device: torch.device,
    eliminate: bool = True,
    max_pulls_static: int = 0,  # upper bound of max_pulls (0: its maximum)
) -> RaceResult:
    """One query's race (Alg. 1, batched as in the paper's App. D-A): per
    round, the ``batch_arms`` lowest-LCB candidates take ``pulls_per_round``
    samples each; an arm whose pull count reaches MAX_PULLS is evaluated
    exactly (CI 0); then one vectorized acceptance/rejection pass. Stops at
    k accepted arms or ``max_rounds``, as the reference's ``while_loop``.

    ``pull_fn`` draws its own randomness (the caller's block sampler) and
    gets arm id −1 for a lane whose result is discarded. The host reads two
    numbers per round: the accepted count (the stop rule) and the pull
    slack that gates the next round's exact evaluation.

    ``max_pulls`` and ``exact_cost`` are per arm where the box's exact
    evaluation costs differ (the sparse box's n_q + n_i); the union bound
    and the round cap take ``max_pulls_static`` or the largest of them."""
    k = cfg.k
    B = min(cfg.batch_arms, n)
    P = cfg.pulls_per_round
    max_pulls, max_pulls_hi = per_arm(max_pulls, (n,), device,
                                      max_pulls_static)
    exact_cost, _ = per_arm(exact_cost, (n,), device)
    log_term = math.log(2.0 / conf.delta_prime(cfg.delta, n, max_pulls_hi))
    # hard cap: everything pulled to exact plus slack
    max_rounds = cfg.max_rounds or int(
        2 * math.ceil(n * max_pulls_hi / max(B * P, 1)) + n + 16)

    def ci_radius(st: RaceState) -> torch.Tensor:
        if cfg.sigma is not None:
            sig_sq = torch.full((n,), float(cfg.sigma) ** 2,
                                dtype=torch.float32, device=device)
        else:
            global_var = conf.pooled_variance(st.m2, st.count)
            sig_sq = conf.empirical_sigma_sq(st.m2, st.count, 1e-12,
                                             global_var)
        c = conf.hoeffding_radius(sig_sq, st.count, log_term)
        return torch.where(st.exact, 0.0, c)

    # initial pulls on every arm (paper App. D-A), as wide pulls over all n
    reps = max(1, max(cfg.init_pulls, 2) // P)
    mean = torch.zeros((n,), dtype=torch.float32, device=device)
    count = torch.zeros_like(mean)
    m2 = torch.zeros_like(mean)
    all_arms = torch.arange(n, device=device)
    ones = torch.ones_like(mean)
    for _ in range(reps):
        mean, count, m2 = conf.welford_batch_update(mean, count, m2,
                                                    pull_fn(all_arms), ones)
    no = torch.zeros((n,), dtype=torch.bool, device=device)
    st = RaceState(
        mean=mean, count=count, m2=m2, exact=no, accepted=no, rejected=no,
        accept_order=torch.full((n,), np.iinfo(np.int32).max,
                                dtype=torch.int32, device=device),
        coord_ops=torch.tensor(n * reps * P * pull_cost, dtype=torch.float32,
                               device=device),
        rounds=0)
    n_accepted = 0
    slack = float(pull_slack(st.count, max_pulls, ~st.exact))

    while n_accepted < k and st.rounds < max_rounds:
        ci = ci_radius(st)
        candidate = ~st.accepted & ~st.rejected

        # ---- selection: B lowest-LCB candidates that still need pulls -----
        need = candidate & ~st.exact
        sel = smallest_k(torch.where(need, st.mean - ci, INF), B)   # (B,)
        sel_valid = need[sel]

        vals = pull_fn(torch.where(sel_valid, sel, -1))             # (B, P)
        nm, nc, n2 = conf.welford_batch_update(
            st.mean[sel], st.count[sel], st.m2[sel], vals,
            sel_valid.to(torch.float32))
        coord_ops = st.coord_ops + torch.sum(sel_valid) * P * pull_cost

        # ---- exact evaluation for arms that crossed MAX_PULLS -------------
        sel_exact = st.exact[sel]
        crossed = (nc >= max_pulls[sel]) & sel_valid & ~sel_exact
        if slack + P >= 0:
            nm = torch.where(crossed, exact_fn(sel), nm)
        coord_ops = coord_ops + torch.sum(crossed * exact_cost[sel])
        st = st._replace(
            mean=st.mean.scatter(0, sel, nm),
            count=st.count.scatter(0, sel, nc),
            m2=st.m2.scatter(0, sel, n2),
            exact=st.exact.scatter(0, sel, sel_exact | crossed),
            coord_ops=coord_ops)

        # ---- acceptance / rejection ---------------------------------------
        accept_new, rejected = acceptance_step(
            st.mean, ci_radius(st), st.exact, st.accepted, st.rejected, k,
            epsilon=cfg.epsilon, eliminate=eliminate)
        st = st._replace(
            accepted=st.accepted | accept_new, rejected=rejected,
            accept_order=torch.where(accept_new, st.rounds, st.accept_order),
            rounds=st.rounds + 1)
        # the round's one host sync: the stop rule and the exact-eval gate
        need = ~st.accepted & ~st.rejected & ~st.exact
        host = torch.stack([torch.sum(st.accepted).to(torch.float32),
                            pull_slack(st.count, max_pulls, need)])
        n_accepted, slack = host.tolist()

    # output: accepted arms first (by mean), then best remaining by LCB
    topk, topk_values = topk_from_state(st.mean, ci_radius(st), st.accepted,
                                        st.rejected, k)
    return RaceResult(
        topk=topk, topk_values=topk_values, coord_ops=st.coord_ops,
        rounds=torch.tensor(st.rounds, dtype=torch.int32, device=device),
        n_exact=torch.sum(st.exact, dtype=torch.int32), state=st)
