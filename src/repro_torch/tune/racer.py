"""The measurement racer: successive halving over candidate configs
(DESIGN.md §9.4), the reference's schedule on the port's drivers.

Each candidate config is an arm whose "distance" is its measured wall time
per racing batch; successive halving (Neufeld et al. 2014) races the arms
with a deterministic measurement budget:

  level 0: every survivor pays 1 warmup race (first-use costs — kernel
           builds, allocator growth — land here, outside the clock) +
           ``reps`` timed races → keep the faster half;
  level l: survivors pay ``reps · 2^l`` timed races → keep half;
  final:   the minimum-median survivor wins.

Per-epoch / per-round costs are read from a *private* ``ObsContext``
swapped in around each candidate's races: the blocking fused driver's
``repro_race_epoch_ms{kind="fused_blocking"}`` histogram is the
measurement substrate, so the tuner measures what serving later reports,
and the process-default metrics stay unpolluted by tuning traffic.

A race's wall is taken after a ``host_fetch`` of its result, which waits
for the device: no other synchronisation is added.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.obs import ObsContext, set_obs
from repro_torch.tune.candidates import TunedConfig, bind_store
from repro_torch.utils.hostsync import host_fetch

#: histogram kinds the blocking drivers record epoch walls under (the
#: single-shard and the sharded fused drivers)
_EPOCH_KINDS = ("fused_blocking", "sharded_fused_blocking")


def seed_of(rng) -> int:
    """An integer seed from ``rng``: a seed, or a ``torch.Generator``'s
    initial seed (None is 0)."""
    if rng is None:
        return 0
    if isinstance(rng, torch.Generator):
        return int(rng.initial_seed())
    return int(rng)


def fold_in(rng, data: int) -> int:
    """A new seed from ``rng`` and ``data`` (the role of
    ``jax.random.fold_in``: distinct, reproducible streams)."""
    return (seed_of(rng) * 1_000_003 + int(data)) % (1 << 63)


@dataclasses.dataclass
class Measurement:
    cand: TunedConfig
    wall_ms: List[float]            # timed race walls (per rep)
    epoch_ms: float = 0.0           # mean wall per fused epoch
    round_ms: float = 0.0           # mean wall per racing round

    @property
    def median_ms(self) -> float:
        return float(np.median(self.wall_ms)) if self.wall_ms else float("inf")

    def to_dict(self) -> dict:
        return {"cand": self.cand.to_dict(), "wall_ms": list(self.wall_ms),
                "median_ms": self.median_ms, "epoch_ms": self.epoch_ms,
                "round_ms": self.round_ms}


def _race_once(store, queries, rng, mode: str) -> Tuple[float, float]:
    """One timed race; returns (wall_ms, max_rounds_paid)."""
    from repro_torch.index.batched_race import index_knn
    t0 = time.perf_counter()
    res = index_knn(store, queries, rng, mode=mode)
    host_fetch(res.indices)         # block on device completion
    wall = (time.perf_counter() - t0) * 1e3
    return wall, float(np.max(host_fetch(res.rounds)))


def measure_candidate(store, cand: TunedConfig, queries, rng, *,
                      reps: int = 1, warmup: bool = True) -> Measurement:
    """Time ``reps`` races of ``store`` rebound onto ``cand``.

    The warmup race (not timed) pays every first-use cost of the
    candidate's shapes; the timed reps then measure steady-state serving
    cost — the quantity the winner's sidecar promises. Epoch/round costs
    come from the private obs context's ``repro_race_epoch_ms`` histogram.
    """
    bound = bind_store(store, cand.bind(store.cfg))
    mode = cand.mode if cand.mode != "auto" else (
        "rounds" if store.kind == "sparse" else "fused")
    ctx = ObsContext("tune", enabled=False)     # metrics only, no events
    old = set_obs(ctx)
    try:
        if warmup:
            _race_once(bound, queries, seed_of(rng), mode)
        walls, rounds_hi = [], 1.0
        for r in range(reps):
            wall, rounds = _race_once(bound, queries, fold_in(rng, r + 1),
                                      mode)
            walls.append(wall)
            rounds_hi = max(rounds_hi, rounds)
    finally:
        set_obs(old)
    hist_sum = hist_count = 0.0
    for kind in _EPOCH_KINDS:
        h = ctx.registry.histogram("repro_race_epoch_ms",
                                   "wall time of one race epoch (ms)",
                                   kind=kind)
        hist_sum += h.sum
        hist_count += h.count
    n_races = reps + (1 if warmup else 0)
    epoch_ms = hist_sum / hist_count if hist_count else 0.0
    # rounds_hi rounds per race → per-round wall from the epoch histogram
    round_ms = (hist_sum / n_races) / max(rounds_hi, 1.0) if hist_count \
        else float(np.median(walls)) / max(rounds_hi, 1.0)
    return Measurement(cand=cand, wall_ms=walls, epoch_ms=epoch_ms,
                       round_ms=round_ms)


def race_candidates(store, cands: List[TunedConfig], queries, rng, *,
                    levels: int = 2, reps: int = 1,
                    ) -> Tuple[Measurement, List[Measurement]]:
    """Successive halving over ``cands``; returns (winner, all results).

    ``levels`` halving rounds double the rep count as the field narrows,
    so total measurement cost stays ~constant per level while the
    surviving arms get tighter estimates. Measurements accumulate across
    levels (a survivor keeps its earlier reps; medians only sharpen).
    """
    field: List[Measurement] = []
    for c in cands:
        field.append(measure_candidate(store, c, queries, rng, reps=reps))
    results = list(field)           # every measurement, eliminated or not
    for level in range(1, max(levels, 1)):
        if len(field) <= 1:
            break
        field.sort(key=lambda m: m.median_ms)
        field = field[: max((len(field) + 1) // 2, 1)]
        for m in field:
            more = measure_candidate(
                store, m.cand, queries, fold_in(rng, 1000 + level),
                reps=reps * (2 ** level), warmup=False)
            m.wall_ms.extend(more.wall_ms)
            if more.epoch_ms:
                m.epoch_ms = more.epoch_ms
            if more.round_ms:
                m.round_ms = more.round_ms
    field.sort(key=lambda m: m.median_ms)
    return field[0], results
