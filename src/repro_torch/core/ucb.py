"""BMO-UCB acceptance rule and final ranking (paper Algorithm 1).

The reference applies these to 1-D arm state and ``vmap``s them over
queries; here they work on the last axis of (..., n) tensors directly.

Ties: ``jax.lax.top_k`` and ``jnp.argmin`` put the lower index first among
equal keys, and the race's decisions depend on it (which arms fill the k
acceptance slots, which row of block ids each selected arm gets, the order
of equal final scores). ``torch.topk`` promises no order among ties, so
every selection whose order can matter goes through ``smallest_k``, a
stable sort.
"""
from __future__ import annotations

import torch

INF = float("inf")


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
