"""Confidence intervals and running-moment updates for BMO-UCB (paper §II-C).

The paper's CI (Eq. 3):  C_{i,T} = sqrt(2 σ_i² log(2/δ') / T), collapsing to 0
once the arm is exactly evaluated, with δ' = δ / (n · MAX_PULLS)  (Lemma 1).
σ_i² is each arm's empirical variance from a Welford accumulator, shrunk
toward a pooled variance and floored (paper App. D-A).

Every function keeps the reference's operation order, so the same fp32
inputs give the same fp32 outputs up to the rounding of the reductions.
"""
from __future__ import annotations

import torch


def delta_prime(delta: float, n: int, max_pulls: int) -> float:
    """Per-interval failure budget from Lemma 1's union bound."""
    return delta / (n * max(max_pulls, 1))


def shard_delta(delta: float, shards: int) -> float:
    """Per-shard failure budget: δ/S, so the S shard-local top-k contracts
    union-bound back to the global δ."""
    return delta / max(shards, 1)


def hoeffding_radius(sigma_sq, count, log_term):
    """C = sqrt(2 σ² log(2/δ') / T); ``log_term`` = log(2/δ') precomputed."""
    c = torch.clamp(count, min=1.0)
    return torch.sqrt(2.0 * sigma_sq * log_term / c)


def welford_merge(mean, count, m2, b_mean, b_count, b_m2, mask):
    """Merge pre-reduced batch statistics into running (mean, count, m2)
    (Chan's parallel Welford update). ``mask`` is 1.0 for real updates and
    0.0 for masked arms, which come back unchanged."""
    tot = count + b_count
    delta = b_mean - mean
    new_mean = mean + delta * (b_count / torch.clamp(tot, min=1.0))
    new_m2 = m2 + b_m2 + torch.square(delta) * count * b_count / torch.clamp(
        tot, min=1.0)
    keep = mask > 0
    return (torch.where(keep, new_mean, mean),
            torch.where(keep, tot, count),
            torch.where(keep, new_m2, m2))


def welford_batch_update(mean, count, m2, batch_vals, batch_mask):
    """Merge a (..., B, P) batch of raw samples per arm into running
    (..., B) stats."""
    P = batch_vals.shape[-1]
    b_mean = torch.mean(batch_vals, dim=-1)
    b_m2 = torch.sum(torch.square(batch_vals - b_mean[..., None]), dim=-1)
    return welford_merge(mean, count, m2, b_mean, float(P), b_m2, batch_mask)


def empirical_sigma_sq(m2, count, floor_sq, global_var,
                       shrink_weight: float = 4.0):
    """σ̂² per arm: empirical variance shrunk toward the pooled global
    variance with ``shrink_weight`` pseudo-observations, floored."""
    var = (m2 + shrink_weight * global_var) / torch.clamp(
        count - 1.0 + shrink_weight, min=1.0)
    return torch.clamp(var, min=floor_sq)


def empirical_sigma_sq_prior(m2, count, floor_sq, global_var, prior_var,
                             prior_weight: float, shrink_weight: float = 4.0):
    """σ̂² with a per-arm warm-start prior: ``prior_weight`` pseudo-
    observations of variance ``prior_var`` beside the pooled shrinkage. The
    prior shapes the variance only; CI widths still scale with real counts."""
    var = (m2 + prior_weight * prior_var + shrink_weight * global_var) / \
        torch.clamp(count - 1.0 + prior_weight + shrink_weight, min=1.0)
    return torch.clamp(var, min=floor_sq)


def pooled_variance(m2, count):
    """Global pooled variance Σ m2_i / Σ (count_i − 1)."""
    num = torch.sum(m2)
    den = torch.sum(torch.clamp(count - 1.0, min=0.0))
    return num / torch.clamp(den, min=1.0)


def hoeffding_radius_masked(sigma_sq, count, log_term, valid):
    """Compacted-state CI radius: padding entries (``valid`` = False) get a
    zero radius, so they can never influence a race."""
    return torch.where(valid, hoeffding_radius(sigma_sq, count, log_term),
                       0.0)
