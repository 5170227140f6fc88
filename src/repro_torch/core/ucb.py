"""BMO-UCB (paper Algorithm 1): the acceptance rule, the final ranking, and
the per-query race ``race_topk``.

The reference applies the rule to 1-D arm state and ``vmap``s it over
queries; here it works on the last axis of (..., n) tensors directly.

``race_topk`` is generic over the Monte-Carlo box, like the paper's
formulation: it takes a ``pull_fn`` (sample the arm estimator) and an
``exact_fn`` (evaluate the arm mean exactly at the cost of MAX_PULLS
pulls). The reference runs it in a ``while_loop``; here it is the batched
per-round driver (``make_rounds_race``, which ``index/batched_race.py``
drives over a store) at Q = 1, whose host loop stops on the very round the
reference stops on.

Ties: ``jax.lax.top_k`` and ``jnp.argmin`` put the lower index first among
equal keys, and the race's decisions depend on it (which arms fill the k
acceptance slots, which row of block ids each selected arm gets, the order
of equal final scores). ``torch.topk`` promises no order among ties, so
every selection whose order can matter goes through ``smallest_k``, a
stable sort.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import BMOConfig
from repro_torch.core import confidence as conf
from repro_torch.utils.hostsync import host_fetch

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


# ---------------------------------------------------------------------------
# the per-round driver (DESIGN.md §3.2): one (Q, n) arm state, one host sync
# a round; ``race_topk`` is its Q = 1 case and ``index/batched_race.py``
# drives it over a store
# ---------------------------------------------------------------------------


class BatchedRaceState(NamedTuple):
    mean: torch.Tensor        # (Q, n)
    count: torch.Tensor       # (Q, n)
    m2: torch.Tensor          # (Q, n)
    exact: torch.Tensor       # (Q, n) bool
    accepted: torch.Tensor    # (Q, n) bool
    rejected: torch.Tensor    # (Q, n) bool
    accept_order: torch.Tensor  # (Q, n) int32 round of acceptance (else
                                # int32 max)
    coord_ops: torch.Tensor   # (Q,)
    rounds: torch.Tensor      # (Q,) int32 rounds spent while the query was active
    done: torch.Tensor        # (Q,) bool
    round_no: int             # rounds run (host-side)
    all_done: bool            # every query done (host-side, from the round's sync)
    slack: float              # pull slack of the next round (host-side, gates
                              # its exact evaluation; ``pull_slack``)
    ci: tuple = ()            # (radii, m2, count, exact): the CI radii of the
                              # round's acceptance pass and the statistics
                              # they came from, reused while those are the
                              # state's own
    none_done: object = None  # the ``done`` tensor the round's sync found
                              # all False, else None (host-side)


class RoundsRaceFns(NamedTuple):
    """The per-round driver's pieces, exposed so callers can drive the race
    in bounded chunks instead of to certification. All members are closures
    over the box's pull/exact functions."""
    init: Callable        # () -> BatchedRaceState
    body: Callable        # state -> state (one racing round)
    active: Callable      # state -> bool (queries left AND round cap unhit)
    ci_radius: Callable   # state -> (Q, n) CI half-widths
    exact_fn: Callable    # (sel (Q, B)) -> (Q, B) exact θ
    exact_cost: torch.Tensor  # (Q, n) coordinate-op cost of an exact eval
    max_rounds: int


def _prior2(prior_var: torch.Tensor, Q: int, n: int) -> torch.Tensor:
    """(n,) build-time per-arm priors or (Q, n) per-query seeded priors
    (near-repeat warm starts), as (Q, n)."""
    return prior_var[None].expand(Q, n) if prior_var.dim() == 1 else prior_var


def make_rounds_race(
    pull_fn: Callable,          # (sel (Q, B)) -> (Q, B, P) samples
    exact_fn: Callable,         # (sel (Q, B)) -> (Q, B) exact θ
    n: int,
    Q: int,
    max_pulls,                  # pulls that constitute an exact evaluation:
                                # scalar, (n,) or (Q, n)
    pull_cost: float,
    exact_cost,                 # coordinate-ops per exact evaluation:
                                # scalar, (n,) or (Q, n)
    cfg: BMOConfig,
    *,
    device: torch.device,
    eliminate: bool = True,
    dead: Optional[torch.Tensor] = None,       # (n,) bool tombstones
    prior_var: Optional[torch.Tensor] = None,  # (n,) or (Q, n) variance prior
    prior_weight: float = 0.0,
    max_pulls_static: int = 0,  # upper bound of max_pulls (0: its maximum)
) -> RoundsRaceFns:
    """The per-round driver (DESIGN.md §3.2) as init/body/active pieces.
    ``pull_fn`` draws its own randomness (the caller's sampler) and gets
    arm id −1 for a lane whose result is discarded: dead arms at the init,
    and selections that are not valid candidates. The union bound and the
    round cap take ``max_pulls_static``, else the largest ``max_pulls``.

    The round is host-bound at small Q (the paper path races one query at
    a time), so it issues no op it can prove idle: no tombstone mask
    without ``dead``, no prior terms at ``prior_weight`` 0, one CI pass a
    round (the acceptance pass's radii serve the next selection), and no
    freeze of finished queries while the last sync saw none finished. Each
    skipped op is an exact identity, so the decisions are those of the
    full formula."""
    k = cfg.k
    B = min(cfg.batch_arms, n)
    P = cfg.pulls_per_round
    max_pulls, max_pulls_hi = per_arm(max_pulls, (Q, n), device,
                                      max_pulls_static)
    exact_cost, _ = per_arm(exact_cost, (Q, n), device)
    log_term = math.log(2.0 / conf.delta_prime(cfg.delta, n, max_pulls_hi))
    max_rounds = cfg.max_rounds or int(
        2 * math.ceil(n * max_pulls_hi / max(B * P, 1)) + n + 16)

    alive = (torch.ones((n,), dtype=torch.bool, device=device) if dead is None
             else ~dead)
    alive_f = alive.to(torch.float32)
    n_alive = torch.sum(alive_f)
    if prior_var is None:
        prior_var = torch.zeros((n,), dtype=torch.float32, device=device)
        prior_weight = 0.0
    prior2 = _prior2(prior_var, Q, n)
    prior_pool = torch.sum(prior2 * alive_f[None], 1) / torch.clamp(
        n_alive, min=1.0)

    def ci_radius(st: BatchedRaceState) -> torch.Tensor:
        if st.ci and st.ci[1] is st.m2 and st.ci[2] is st.count \
                and st.ci[3] is st.exact:
            return st.ci[0]
        if cfg.sigma is not None:
            sig_sq = torch.full((Q, n), float(cfg.sigma) ** 2,
                                dtype=torch.float32, device=device)
        else:
            # per-query pooled variance over the live arms, warm-started by
            # the prior
            m2, excess = st.m2, torch.clamp(st.count - 1.0, min=0.0)
            if dead is not None:
                m2, excess = m2 * alive_f, excess * alive_f
            num, den = torch.sum(m2, 1), torch.sum(excess, 1)
            if prior_weight:
                num = num + prior_weight * prior_pool
                den = den + prior_weight
            global_var = (num / torch.clamp(den, min=1.0))[:, None]
            sig_sq = conf.empirical_sigma_sq_prior(
                st.m2, st.count, 1e-12, global_var, prior2, prior_weight) \
                if prior_weight else conf.empirical_sigma_sq(
                    st.m2, st.count, 1e-12, global_var)
        c = conf.hoeffding_radius(sig_sq, st.count, log_term)
        return torch.where(st.exact, 0.0, c)

    def sync(st: BatchedRaceState, candidate=None) -> BatchedRaceState:
        # the round's one host sync: the stop rule and the exact-eval gate;
        # ``need``: the arms the next round may select for pulls
        if candidate is None:
            candidate = ~st.accepted & ~st.rejected
        need = candidate & ~st.exact & ~st.done[:, None]
        host = torch.stack([torch.sum(st.done).to(torch.float32),
                            pull_slack(st.count, max_pulls, need)])
        n_done, slack = host_fetch(host).tolist()
        return st._replace(all_done=n_done == Q, slack=slack,
                           none_done=st.done if n_done == 0 else None)

    def init_state() -> BatchedRaceState:
        # wide init (paper App. D-A): every alive arm of every query gets
        # init_pulls samples, as reps of ONE (Q, n, P) launch
        reps = max(1, max(cfg.init_pulls, 2) // P)
        flat = torch.zeros((Q * n,), dtype=torch.float32, device=device)
        mean, count, m2 = flat, flat, flat
        all_arms = torch.where(alive, torch.arange(n, device=device),
                               -1)[None].expand(Q, n)
        mask = alive_f[None].expand(Q, n).reshape(-1)
        for _ in range(reps):
            vals = pull_fn(all_arms)                             # (Q, n, P)
            mean, count, m2 = conf.welford_batch_update(
                mean, count, m2, vals.reshape(Q * n, P), mask)
        no = torch.zeros((Q, n), dtype=torch.bool, device=device)
        return sync(BatchedRaceState(
            mean=mean.reshape(Q, n), count=count.reshape(Q, n),
            m2=m2.reshape(Q, n), exact=no, accepted=no,
            rejected=(~alive)[None].expand(Q, n),
            accept_order=torch.full((Q, n), np.iinfo(np.int32).max,
                                    dtype=torch.int32, device=device),
            coord_ops=torch.full((Q,), float(reps * P * pull_cost),
                                 device=device) * n_alive,
            rounds=torch.zeros((Q,), dtype=torch.int32, device=device),
            done=torch.zeros((Q,), dtype=torch.bool, device=device),
            round_no=0, all_done=False, slack=-INF))

    def active(st: BatchedRaceState) -> bool:
        return not st.all_done and st.round_no < max_rounds

    def body(st: BatchedRaceState) -> BatchedRaceState:
        ci = ci_radius(st)
        running = st.none_done is st.done       # no query is done yet
        sel_need = ~st.accepted & ~st.rejected & ~st.exact
        if not running:
            sel_need = sel_need & ~st.done[:, None]

        # ---- selection: per query, B lowest-LCB candidates ---------------
        sel = smallest_k(torch.where(sel_need, st.mean - ci, INF), B)  # (Q, B)
        sel_valid = torch.gather(sel_need, 1, sel)

        vals = pull_fn(torch.where(sel_valid, sel, -1))          # (Q, B, P)
        nm, nc, n2 = conf.welford_batch_update(
            torch.gather(st.mean, 1, sel), torch.gather(st.count, 1, sel),
            torch.gather(st.m2, 1, sel), vals, sel_valid.to(torch.float32))
        coord_ops = st.coord_ops + torch.sum(sel_valid, 1) * P * pull_cost

        # ---- lazy exact evaluation for arms that crossed MAX_PULLS -------
        sel_exact = torch.gather(st.exact, 1, sel)
        crossed = (nc >= torch.gather(max_pulls, 1, sel)) & sel_valid \
            & ~sel_exact
        if st.slack + P >= 0:
            nm = torch.where(crossed, exact_fn(sel), nm)
        coord_ops = coord_ops + torch.sum(
            crossed * torch.gather(exact_cost, 1, sel), 1)
        st2 = st._replace(
            mean=st.mean.scatter(1, sel, nm),
            count=st.count.scatter(1, sel, nc),
            m2=st.m2.scatter(1, sel, n2),
            exact=st.exact.scatter(1, sel, sel_exact | crossed),
            coord_ops=coord_ops, ci=())
        ci = ci_radius(st2)

        # ---- per-query acceptance / rejection (shared Alg. 1 step) -------
        accept_new, rejected = acceptance_step(
            st2.mean, ci, st2.exact, st2.accepted, st2.rejected, k,
            epsilon=cfg.epsilon, eliminate=eliminate)
        if running:
            accepted = st.accepted | accept_new
            rounds = st.rounds + 1
        else:
            # freeze finished queries
            frozen = st.done[:, None]
            accepted = torch.where(frozen, st.accepted,
                                   st.accepted | accept_new)
            rejected = torch.where(frozen, st.rejected, rejected)
            rounds = torch.where(st.done, st.rounds, st.rounds + 1)

        # done at k certified arms — or when no candidate is left at all
        # (reachable only in a race over fewer than k live slots)
        candidate = ~accepted & ~rejected
        no_candidates = torch.sum(candidate, 1) == 0
        done = st.done | (torch.sum(accepted, 1) >= k) | no_candidates
        accept_order = torch.where(accepted & ~st.accepted, st.round_no,
                                   st.accept_order)
        return sync(st2._replace(accepted=accepted, rejected=rejected,
                                 accept_order=accept_order, rounds=rounds,
                                 done=done, round_no=st.round_no + 1,
                                 ci=(ci, st2.m2, st2.count, st2.exact)),
                    candidate)

    return RoundsRaceFns(init=init_state, body=body, active=active,
                         ci_radius=ci_radius, exact_fn=exact_fn,
                         exact_cost=exact_cost, max_rounds=max_rounds)


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

    It is the per-round driver (``make_rounds_race``)
    over one query: ``pull_fn`` and ``exact_fn`` take one query's arm ids
    and are lifted to the driver's (1, B) selections. ``pull_fn`` draws its
    own randomness (the caller's block sampler) and gets arm id −1 for a
    lane whose result is discarded. The host reads two numbers per round:
    the stop rule and the pull slack that gates the next round's exact
    evaluation.

    ``max_pulls`` and ``exact_cost`` are per arm where the box's exact
    evaluation costs differ (the sparse box's n_q + n_i); the union bound
    and the round cap take ``max_pulls_static`` or the largest of them."""
    fns = make_rounds_race(
        lambda sel: pull_fn(sel[0])[None], lambda sel: exact_fn(sel[0])[None],
        n=n, Q=1, max_pulls=max_pulls, pull_cost=pull_cost,
        exact_cost=exact_cost, cfg=cfg, device=device, eliminate=eliminate,
        max_pulls_static=max_pulls_static)
    st = fns.init()
    while fns.active(st):
        st = fns.body(st)
    # output: accepted arms first (by mean), then best remaining by LCB
    topk, topk_values = topk_from_state(st.mean[0], fns.ci_radius(st)[0],
                                        st.accepted[0], st.rejected[0],
                                        cfg.k)
    state = RaceState(
        mean=st.mean[0], count=st.count[0], m2=st.m2[0], exact=st.exact[0],
        accepted=st.accepted[0], rejected=st.rejected[0],
        accept_order=st.accept_order[0], coord_ops=st.coord_ops[0],
        rounds=st.round_no)
    return RaceResult(
        topk=topk, topk_values=topk_values, coord_ops=state.coord_ops,
        rounds=torch.tensor(st.round_no, dtype=torch.int32, device=device),
        n_exact=torch.sum(state.exact, dtype=torch.int32), state=state)
