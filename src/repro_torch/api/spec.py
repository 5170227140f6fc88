"""Typed query protocol of the port's index surface (DESIGN.md §6.2).

  * ``QuerySpec`` — what a caller may vary per query batch (k, racing mode
    and impl, a δ override, a pull-budget cap, the elimination and
    warm-start switches, per-query CI variance priors, the cache policy, an
    anytime ``Deadline`` or ``EffortBudget``), validated once at
    construction. A default-constructed spec is the serving fast path and
    the only spec the query cache serves.
  * ``KNNResult`` — the result schema of ``Index.query``, the reference's
    schema unchanged: host-side arrays, per-query cost counters.
  * ``ServeStats`` — the handle's and the request plane's serving counters,
    field for field the reference's schema (v6); the fleet fields are
    filled by a plane behind a fleet (``repro_torch.fleet``).
  * ``CachePolicy`` — the query LRU and near-repeat warm starts;
    ``CompactionPolicy`` — when ``Index.maybe_compact`` rebuilds the slot
    layout.

The port's ``impl`` vocabulary is its own: "auto" (the CUDA kernels on the
card, the plain versions on the CPU), "cuda", "ref".
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

from repro_torch.api.stream import Deadline, EffortBudget
from repro_torch.kernels.ops import IMPLS

MODES = ("auto", "fused", "rounds")
CACHE_POLICIES = ("use", "bypass", "refresh")

#: schema version of KNNResult.as_dict() — the reference's, since the
#: schema is the same
SCHEMA_VERSION = 6


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """Per-query-batch contract, validated at the boundary. ``None`` means
    "use the index's build-time default" for the overridable fields; a
    default-constructed ``QuerySpec()`` is the cacheable serving fast
    path."""

    k: Optional[int] = None            # top-k override (None = store cfg.k)
    mode: str = "auto"                 # auto | fused | rounds driver
    impl: str = "auto"                 # kernel impl (auto/cuda/ref)
    delta: Optional[float] = None      # failure-probability override
    max_rounds: Optional[int] = None   # pull-budget cap (racing rounds)
    eliminate: bool = True             # Alg. 1 elimination on/off
    warm_start: bool = True            # build-time CI variance priors
    prior_hint: Optional[Any] = None   # (Q, capacity) per-query variance
                                       # priors (near-repeat warm starts)
    cache: str = "use"                 # use | bypass | refresh the query LRU
    deadline: Optional[Any] = None     # stream.Deadline — wall-clock cap;
                                       # the request plane returns the
                                       # certified prefix at expiry
    budget: Optional[Any] = None       # stream.EffortBudget — pull-budget
                                       # cap (epochs / coord_ops)
    use_tuned: bool = True             # serve on the autotuned config
                                       # (repro_torch.tune) when one is
                                       # active; False races on build-time
                                       # defaults

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r} (want one of {MODES})")
        if self.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.impl!r} (want one of {IMPLS})")
        if self.cache not in CACHE_POLICIES:
            raise ValueError(f"unknown cache policy {self.cache!r} "
                             f"(want one of {CACHE_POLICIES})")
        if self.k is not None and self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.delta is not None and not (0.0 < self.delta < 1.0):
            raise ValueError(f"delta must be in (0, 1), got {self.delta}")
        if self.max_rounds is not None and self.max_rounds < 1:
            raise ValueError(f"max_rounds must be >= 1, got {self.max_rounds}")
        if self.deadline is not None and not isinstance(self.deadline,
                                                        Deadline):
            raise ValueError(
                f"deadline must be a repro_torch.api.Deadline, got "
                f"{type(self.deadline).__name__}")
        if self.budget is not None and not isinstance(self.budget,
                                                      EffortBudget):
            raise ValueError(
                f"budget must be a repro_torch.api.EffortBudget, got "
                f"{type(self.budget).__name__}")

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

    @property
    def cacheable(self) -> bool:
        """Only default-contract races may hit or fill the query LRU: a k /
        δ / budget override, a seeded prior, or an anytime early-exit
        contract (deadline / effort budget — the result may be partial)
        changes what the cached result would certify."""
        return (self.k is None and self.delta is None
                and self.max_rounds is None and self.prior_hint is None
                and self.eliminate and self.warm_start
                and self.deadline is None and self.budget is None
                and self.use_tuned)


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
    """Typed serving counters (``Index.stats``, ``RequestPlane.stats``),
    field for field the reference's schema v6.

    ``as_dict()`` is the stable JSON schema; ``__getitem__`` also accepts
    the reference's older string keys (``knn_cache_hits``, …). The fleet
    fields are filled by a plane behind a router (``repro_torch.fleet``)
    and hold their defaults elsewhere.
    """

    races: int = 0             # batched races launched
    raced_queries: int = 0     # cache misses that actually paid a race
    cache_hits: int = 0
    cache_misses: int = 0
    cache_entries: int = 0
    near_hits: int = 0         # near-repeat CI warm starts
    compactions: int = 0
    reshards: int = 0          # live re-shard admin ops (not ported: 0)
    replicas: int = 1          # read replicas serving the fan-out
    shard_coord_ops: Optional[List[float]] = None  # cumulative per shard
    shard_rounds: Optional[List[float]] = None     # max per shard
    # -- request-plane telemetry (schema v2, DESIGN.md §7.4) ---------------
    plane_submitted: int = 0   # tickets submitted
    plane_admitted: int = 0    # tickets admitted into a race group
    plane_completed: int = 0   # tickets finished (any terminal reason)
    plane_shed: int = 0        # tickets shed at admission (backpressure)
    plane_deadline_exits: int = 0   # terminated at the wall-clock deadline
    plane_budget_exits: int = 0     # terminated at the effort budget
    plane_readmitted: int = 0  # tickets re-raced after a mutation fence
    plane_epochs: int = 0      # scheduler epochs run
    plane_queue_depth: int = 0      # tickets waiting for admission (now)
    plane_active: int = 0      # tickets racing (now)
    # 0.0 (never None/NaN) when no terminal latency landed in the window yet
    plane_latency_p50_ms: float = 0.0   # terminal latency percentiles
    plane_latency_p95_ms: float = 0.0
    plane_latency_p99_ms: float = 0.0
    # -- observability (schema v3, DESIGN.md §8) ---------------------------
    obs_events: int = 0        # trace events recorded (ring-buffer total)
    obs_event_drops: int = 0   # events overwritten before export
    obs_epoch_ms: Optional[dict] = None    # race-epoch histogram snapshot
    obs_latency_ms: Optional[dict] = None  # ticket-latency histogram snap
    # -- δ-audit / SLO (schema v5, DESIGN.md §10) --------------------------
    audit_sampled: int = 0     # query rows shadow-audited so far
    audit_mismatches: int = 0  # audited rows violating the 1-δ contract
    # 1.0 = "no claim yet": the Wilson bound carries no evidence until
    # rows have actually been audited (and is 1.0 with auditing off)
    audit_err_upper: float = 1.0
    audit_pending: int = 0     # sampled tickets awaiting the oracle
    slo_alerts: int = 0        # burn-rate alerts fired (lifetime)
    serving_fallback: bool = False  # tuned config forced off (recall guard)
    retune_requested: bool = False  # an Index.tune() re-race is flagged
    # -- fleet rollup (schema v6), behind a router --------------------------
    fleet_namespaces_resident: int = 0
    fleet_namespaces_evicted: int = 0
    fleet_reloads: int = 0
    ns_queue_depth: Optional[dict] = None

    _LEGACY = {
        "knn_races": "races",
        "knn_raced_queries": "raced_queries",
        "knn_cache_hits": "cache_hits",
        "knn_cache_misses": "cache_misses",
        "knn_cache_entries": "cache_entries",
        "knn_near_hits": "near_hits",
        "index_compactions": "compactions",
        "knn_shard_coord_ops": "shard_coord_ops",
        "knn_shard_rounds": "shard_rounds",
    }

    def as_dict(self) -> dict:
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self)}
        out["schema_version"] = SCHEMA_VERSION
        return out

    def __getitem__(self, key: str):
        name = self._LEGACY.get(key, key)
        if name.startswith("_") or not hasattr(self, name):
            raise KeyError(key)
        return getattr(self, name)

    def __contains__(self, key) -> bool:
        try:
            self[key]
        except (KeyError, TypeError):
            return False
        return True


@dataclasses.dataclass(frozen=True)
class CachePolicy:
    """Query-LRU policy: exact-byte repeats are served from memory; a near
    repeat (cosine ≥ ``near_threshold``) still races but has its CI
    variance priors seeded from the cached neighbour. ``capacity=0``
    disables caching."""

    capacity: int = 256
    near_threshold: float = 0.95     # 0 disables near-repeat warm starts
    near_prior_scale: float = 0.25   # variance tightening on seeded arms

    def __post_init__(self):
        if self.capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {self.capacity}")
        if self.near_threshold > 1.0:
            raise ValueError("near_threshold is a cosine similarity; "
                             f"got {self.near_threshold}")


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """Tombstone-debt policy: rebuild the slot layout when the dead
    fraction crosses ``threshold`` AND capacity would actually shrink.
    ``threshold >= 1`` disables auto-compaction."""

    threshold: float = 0.5

    def __post_init__(self):
        if self.threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {self.threshold}")
