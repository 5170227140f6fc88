"""``tune_store`` — the end-to-end autotune pass (DESIGN.md §9).

enumerate (candidates.py) → model-prune (seed.py) → race the survivors
(racer.py) → memoize by store signature (sidecar.py). Pure store-level: no
``Index`` handle involved, so the api layer can call down without an
import cycle, and tests can tune a bare store directly.
"""
from __future__ import annotations

import logging
from typing import Tuple

import torch

from repro_torch.device import make_generator
from repro_torch.index.sharded import rows_of
from repro_torch.kernels import ops as kops
from repro_torch.tune import sidecar
from repro_torch.tune.candidates import TunedConfig, candidate_grid
from repro_torch.tune.racer import fold_in, race_candidates, seed_of
from repro_torch.tune.seed import seed_candidates
from repro_torch.tune.signature import signature_of

log = logging.getLogger("repro_torch.tune")

TUNE_QUERIES = 8        # default synthetic tuning batch


def synth_queries(store, rng, Q: int = TUNE_QUERIES) -> torch.Tensor:
    """Synthetic tuning batch for dense/rotated boxes, on the store's
    device: live corpus rows in the corpus's own space plus noise of 0.1
    times each row's standard deviation, drawn from a ``torch.Generator``
    (``rng``: one, or a seed), so the tuning races see realistic distance
    gaps rather than isotropic worst-case ones. A rotated store's rows are
    rotated back first (the transform and the sign flip are their own
    inverses); the reference perturbs the rotated rows and keeps their
    first d columns, which the race rotates again into queries near no row
    (ROADMAP.md Queue 3). Sparse boxes have no dense rows to perturb —
    callers must supply real queries."""
    if store.kind == "sparse":
        raise ValueError("a sparse index needs explicit tuning queries "
                         "(pass the (q_idx, q_val, q_nnz) triplet)")
    g = make_generator(rng, store.device)
    alive = torch.nonzero(store.alive).reshape(-1)
    pick = torch.randint(int(alive.shape[0]), (Q,), generator=g,
                         device=store.device)
    x = rows_of(store, alive[pick])
    if store.kind == "rotated":
        x = kops.fwht(x) * store.signs[None, :]
    noise = 0.1 * torch.randn((Q, store.d_pad), generator=g,
                              device=store.device)
    qs = x + noise * torch.std(x, dim=-1, keepdim=True, unbiased=False)
    return qs[:, : store.d]


def tune_store(store, queries=None, rng=None, *, levels: int = 2,
               reps: int = 1, max_candidates: int = 8,
               prune_ratio: float = 3.0, force: bool = False,
               ) -> Tuple[TunedConfig, dict]:
    """Race the candidate grid on ``store``; returns (winner, report).

    The winner carries measured ``epoch_ms`` / ``round_ms`` (the deadline
    planner's cost basis) and is memoized in the in-process cache keyed by
    the store's signature — equal-signature stores reuse it without
    re-racing unless ``force``. ``rng`` is a seed or a ``torch.Generator``
    (None is seed 0); the synthetic queries and every race draw from seeds
    derived from it.
    """
    sig = signature_of(store)
    if not force:
        hit = sidecar.cache_get(sig)
        if hit is not None:
            return hit, {"signature": sig.to_dict(), "cached": True,
                         "config": hit.to_dict()}
    seed = seed_of(rng)
    if queries is None:
        queries = synth_queries(store, fold_in(seed, 0))
        seed = fold_in(seed, 1)
    cands = candidate_grid(store, backend=sig.backend)
    survivors, model_report = seed_candidates(
        store, cands, max_candidates=max_candidates,
        prune_ratio=prune_ratio)
    log.info("tune: %d candidates, %d after the cost-model prune (sig=%s)",
             len(cands), len(survivors), sig.key())
    winner, results = race_candidates(store, survivors, queries, seed,
                                      levels=levels, reps=reps)
    tuned = winner.cand.with_measured(epoch_ms=winner.epoch_ms,
                                      round_ms=winner.round_ms)
    sidecar.cache_put(sig, tuned)
    default_ms = next((m.median_ms for m in results
                       if m.cand == survivors[0]), float("nan"))
    log.info("tune: winner %s — %.1f ms vs %.1f ms default",
             tuned.to_dict(), winner.median_ms, default_ms)
    report = {
        "signature": sig.to_dict(),
        "cached": False,
        "config": tuned.to_dict(),
        "grid_size": len(cands),
        "raced": len(survivors),
        "model": model_report,
        "measurements": [m.to_dict() for m in results],
        "winner_median_ms": winner.median_ms,
        "default_median_ms": default_ms,
    }
    return tuned, report
