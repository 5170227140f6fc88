"""Survivor-compacted racing frontier (DESIGN.md §4.2).

The racing state lives in (Q, W) buffers over each query's surviving arms.
After each epoch the still-alive entries (accepted + candidates) are
gathered to the front and W shrinks along a power-of-two schedule
n → n/2 → n/4 → …, so bookkeeping scales with survivors instead of n.

Invariant (tested): compaction only ever drops rejected or padding entries
and preserves per-entry statistics exactly, so the race's accept/reject
decisions are identical with and without it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.datasets import next_pow2


class FrontierState(NamedTuple):
    """Bucketed racing state: (Q, W) buffers over the survivor frontier.

    ``ids`` maps buffer positions to arm/slot ids; ``valid`` is False for
    padding (and for dead slots, which enter as invalid + rejected). Block
    ids are drawn outside the state, by the race's block sampler.
    """
    ids: torch.Tensor        # (Q, W) int32 arm/slot ids
    mean: torch.Tensor       # (Q, W) running θ̂
    count: torch.Tensor      # (Q, W) pulls so far
    m2: torch.Tensor         # (Q, W) Welford M2
    prior: torch.Tensor      # (Q, W) warm-start variance prior (gathered)
    exact: torch.Tensor      # (Q, W) bool — mean is exact, CI = 0
    accepted: torch.Tensor   # (Q, W) bool
    rejected: torch.Tensor   # (Q, W) bool
    valid: torch.Tensor      # (Q, W) bool — False for padding entries
    coord_ops: torch.Tensor  # (Q,) coordinate-op counter
    n_exact: torch.Tensor    # (Q,) int32 arms exactly evaluated — a running
                             # counter: compaction may drop exact-then-
                             # rejected entries
    rounds: torch.Tensor     # (Q,) int32 equivalent pull-rounds while active
    done: torch.Tensor       # (Q,) bool

    @property
    def width(self) -> int:
        return self.ids.shape[1]


def survivors(st: FrontierState) -> torch.Tensor:
    """(Q, W) bool — entries the race still owes work or an answer for."""
    return st.valid & ~st.rejected


def compact_frontier(st: FrontierState, *, W_new: int) -> FrontierState:
    """Gather each query's surviving entries into the first ``W_new``
    positions and drop the rest of the buffer.

    Priority: accepted < candidate < (rejected | padding), stably — the
    reference's ``jnp.argsort`` is stable, and the order decides which
    position each arm takes. Statistics ride along untouched.
    """
    key = torch.where(st.accepted, 0, torch.where(survivors(st), 1, 2))
    order = torch.argsort(key, dim=1, stable=True)[:, :W_new]

    def take(a):
        return torch.gather(a, 1, order)

    return st._replace(
        ids=take(st.ids), mean=take(st.mean), count=take(st.count),
        m2=take(st.m2), prior=take(st.prior), exact=take(st.exact),
        accepted=take(st.accepted), rejected=take(st.rejected),
        valid=take(st.valid) & ~take(st.rejected),
    )


def bucket_width(need: int, *, floor: int, current: int) -> int:
    """Next buffer width: power-of-two cover of ``need`` (the max survivor
    count over still-active queries), floored, never growing back above
    ``current``."""
    w = max(next_pow2(max(int(need), 1)), floor)
    return min(w, current)


def floor_width(cfg, n: int, *, B0: int = 0) -> int:
    """Smallest bucket width the shrink schedule may reach for an n-wide
    frontier: ``cfg.frontier_floor`` or max(racing batch, 2k, 32),
    pow2-quantized and capped at n."""
    if not B0:
        B0 = min(cfg.batch_arms, n)
    base = cfg.frontier_floor if cfg.frontier_floor > 0 \
        else max(B0, 2 * cfg.k, 32)
    return min(n, bucket_width(base, floor=1, current=n))


def pow2_floor(m: int) -> int:
    """Largest power of two ≤ max(m, 1): the quantizer of the adaptive
    rounds-per-launch multiplier."""
    return 1 << (max(int(m), 1).bit_length() - 1)
