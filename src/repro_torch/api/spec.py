"""Typed query protocol of the port's index surface (DESIGN.md §6.2).

  * ``QuerySpec`` — what a caller may vary per query batch on the ported
    path (k, racing mode and impl, a δ override, a pull-budget cap, the
    elimination and warm-start switches), validated once at construction.
  * ``KNNResult`` — the result schema of ``Index.query``, the reference's
    schema unchanged: host-side arrays, per-query cost counters.
  * ``ServeStats`` — the handle's serving counters, a subset of the
    reference's fields.
  * ``CompactionPolicy`` — when ``Index.maybe_compact`` rebuilds the slot
    layout.

The port's ``impl`` vocabulary is its own: "auto" (the CUDA kernels on the
card, the plain versions on the CPU), "cuda", "ref".
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

from repro_torch.kernels.ops import IMPLS

MODES = ("auto", "fused", "rounds")

#: schema version of KNNResult.as_dict() — the reference's, since the
#: schema is the same
SCHEMA_VERSION = 6


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """Per-query-batch contract, validated at the boundary. ``None`` means
    "use the index's build-time default"."""

    k: Optional[int] = None            # top-k override (None = store cfg.k)
    mode: str = "auto"                 # auto | fused | rounds driver
    impl: str = "auto"                 # kernel impl (auto/cuda/ref)
    delta: Optional[float] = None      # failure-probability override
    max_rounds: Optional[int] = None   # pull-budget cap (racing rounds)
    eliminate: bool = True             # Alg. 1 elimination on/off
    warm_start: bool = True            # build-time CI variance priors

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r} (want one of {MODES})")
        if self.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.impl!r} (want one of {IMPLS})")
        if self.k is not None and self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.delta is not None and not (0.0 < self.delta < 1.0):
            raise ValueError(f"delta must be in (0, 1), got {self.delta}")
        if self.max_rounds is not None and self.max_rounds < 1:
            raise ValueError(f"max_rounds must be >= 1, got {self.max_rounds}")

    def bind(self, cfg):
        """Apply the spec's overrides to the store's build-time BMOConfig."""
        kw = {}
        if self.k is not None:
            kw["k"] = self.k
        if self.delta is not None:
            kw["delta"] = self.delta
        if self.max_rounds is not None:
            kw["max_rounds"] = self.max_rounds
        return dataclasses.replace(cfg, **kw) if kw else cfg


@dataclasses.dataclass(frozen=True)
class KNNResult:
    """Stable result schema of ``Index.query`` (host-side numpy).
    ``indices`` are slot ids."""

    indices: Any                       # (Q, k) int   — slot ids
    values: Any                        # (Q, k) float — ascending θ
    coord_ops: Any                     # (Q,) coordinate reads paid
    rounds: Any                        # (Q,) racing rounds paid
    n_exact: Any                       # (Q,) lazy exact evaluations
    cache_hits: int = 0                # rows served from a query cache
    shard_coord_ops: Optional[List[float]] = None   # (S,) per-shard reads
    shard_rounds: Optional[List[float]] = None      # (S,) per-shard rounds

    def as_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["schema_version"] = SCHEMA_VERSION
        return out


@dataclasses.dataclass
class ServeStats:
    """The handle's serving counters (``Index.stats``), named as the
    reference's. The cache fields stay 0 until the port has a query
    cache."""

    races: int = 0             # batched races launched
    raced_queries: int = 0     # query rows that paid a race
    cache_hits: int = 0
    cache_misses: int = 0
    cache_entries: int = 0
    near_hits: int = 0         # near-repeat CI warm starts
    compactions: int = 0


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """Tombstone-debt policy: rebuild the slot layout when the dead
    fraction crosses ``threshold`` AND capacity would actually shrink.
    ``threshold >= 1`` disables auto-compaction."""

    threshold: float = 0.5

    def __post_init__(self):
        if self.threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {self.threshold}")
