"""repro_torch.serve.scale — autoscaling hints from request-plane
telemetry, the reference's policies over the port's ``ServeStats``.

A ``ScalePolicy`` consumes the queue-depth / latency fields the plane adds
to ``ServeStats`` (schema v2) and emits *recommendations* — it never
touches the index itself. The caller decides whether to act on them, so
capacity decisions stay observable and reversible.

The default ``QueueDepthPolicy`` is deliberately boring: sustained queue
depth (or p95 latency over target) scales *out*; a sustained idle queue
scales back *in*; a shard-imbalanced index is told to ``reshard`` before
replicating, because replicas multiply an imbalance instead of fixing it.
Hysteresis comes from requiring ``sustain`` consecutive observations and a
``cooldown`` between actions.

``RecallGuardPolicy`` turns a burning recall SLO (``obs/slo.py``) into the
correctness actions ``apply_guard`` executes on the handle: serve on
build-time defaults, then flag a re-tune. ``FleetPressurePolicy`` reads the
fleet rollup (per-namespace queue depth) and recommends evicting a
namespace or rebalancing placement; ``apply_fleet`` executes that on a
``repro_torch.fleet.Fleet``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.api import ServeStats

ACTIONS = ("none", "add_replicas", "reshard", "fallback_untuned", "retune",
           "evict_namespace", "rebalance")


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One recommendation: do ``action`` with parameter ``value``.
    ``target`` names the namespace a fleet-granularity action applies to
    (empty for whole-plane actions)."""

    action: str = "none"          # none | add_replicas | reshard |
                                  # fallback_untuned | retune |
                                  # evict_namespace | rebalance
    value: int = 0                # target replica count / shard count
    reason: str = ""
    target: str = ""              # namespace for fleet-granularity actions

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown action {self.action!r} "
                             f"(want one of {ACTIONS})")


class ScalePolicy:
    """Interface: feed one ``ServeStats`` snapshot per observation window,
    get a ``ScaleDecision`` back. Implementations keep their own hysteresis
    state; ``recommend`` must stay side-effect-free w.r.t. the index."""

    def recommend(self, stats: ServeStats) -> ScaleDecision:
        raise NotImplementedError


@dataclasses.dataclass
class QueueDepthPolicy(ScalePolicy):
    """Watermark policy over plane queue depth and terminal p95 latency."""

    high_queue: int = 8            # queue depth that signals saturation
    low_queue: int = 0             # queue depth that signals idle capacity
    p95_target_ms: Optional[float] = None   # latency SLO (None = ignore)
    imbalance: float = 2.0         # max/mean shard coord-ops → reshard
    sustain: int = 3               # consecutive hot/cold windows to act
    cooldown: int = 3              # windows to hold after any action
    max_replicas: int = 4
    max_shards: int = 8
    _hot: int = dataclasses.field(default=0, repr=False)
    _cold: int = dataclasses.field(default=0, repr=False)
    _hold: int = dataclasses.field(default=0, repr=False)

    def recommend(self, stats: ServeStats) -> ScaleDecision:
        if self._hold > 0:
            self._hold -= 1
            return ScaleDecision(reason="cooldown")
        hot = stats.plane_queue_depth >= self.high_queue
        # p95 is 0.0 (never None/NaN) on an empty latency window since
        # schema v3, so the SLO comparison is unconditional and an empty
        # window can never read as hot
        if (self.p95_target_ms is not None
                and (stats.plane_latency_p95_ms or 0.0) > self.p95_target_ms):
            hot = True
        cold = (stats.plane_queue_depth <= self.low_queue
                and stats.plane_active == 0)
        self._hot = self._hot + 1 if hot else 0
        self._cold = self._cold + 1 if (cold and not hot) else 0

        if self._hot >= self.sustain:
            self._hot = 0
            self._hold = self.cooldown
            ops = stats.shard_coord_ops
            if ops and sum(ops) > 0:
                mean = sum(ops) / len(ops)
                if mean > 0 and max(ops) / mean >= self.imbalance:
                    target = min(2 * len(ops), self.max_shards)
                    if target > len(ops):
                        return ScaleDecision(
                            "reshard", target,
                            f"queue {stats.plane_queue_depth} high and "
                            f"shard load imbalanced "
                            f"(max/mean {max(ops) / mean:.2f})")
            if stats.replicas < self.max_replicas:
                return ScaleDecision(
                    "add_replicas", stats.replicas + 1,
                    f"queue depth {stats.plane_queue_depth} "
                    f"(p95 {stats.plane_latency_p95_ms}) sustained "
                    f"{self.sustain} windows")
            return ScaleDecision(reason="saturated at max_replicas")
        if self._cold >= self.sustain and stats.replicas > 1:
            self._cold = 0
            self._hold = self.cooldown
            return ScaleDecision(
                "add_replicas", stats.replicas - 1,
                f"idle {self.sustain} windows at {stats.replicas} replicas")
        return ScaleDecision(reason="steady")


class RecallGuardPolicy(ScalePolicy):
    """Correctness guard: consume the SLO engine's recall alerts
    (DESIGN.md §10.3). A burning recall SLO means audited traffic is
    violating the paper's 1-δ contract — overwhelmingly a suspect tuned
    config (the build-time defaults are the conservative reference), so
    the guard first recommends ``fallback_untuned`` (serve every query on
    build defaults) and then ``retune`` (flag the tuned config for a
    re-race). It never escalates past those two — a recall violation that
    survives the fallback is a bug, not a capacity problem.

    Stateless w.r.t. hysteresis on purpose: the burn-rate rules already
    provide multi-window debouncing; duplicating it here would only slow
    the response to served wrong answers."""

    def __init__(self, sink, *, slo: str = "recall"):
        self.sink = sink              # repro_torch.obs.slo.AlertSink
        self.slo = slo

    def recommend(self, stats: ServeStats) -> ScaleDecision:
        burning = self.sink.active(self.slo)
        if not burning:
            return ScaleDecision(reason="recall SLO healthy")
        worst = max(burning, key=lambda a: a.burn_long)
        why = (f"recall SLO burning ({worst.rule}: "
               f"{worst.burn_long:.1f}x of delta budget {worst.budget:g})")
        if not stats.serving_fallback:
            return ScaleDecision("fallback_untuned", 1, why)
        if not stats.retune_requested:
            return ScaleDecision("retune", 1, why + "; fallback active")
        return ScaleDecision(
            reason=why + "; fallback active, re-tune already flagged")


@dataclasses.dataclass
class FleetPressurePolicy(ScalePolicy):
    """Namespace-granularity pressure policy over the fleet rollup fields
    (``ns_queue_depth``, ``fleet_namespaces_resident``), the reference's.

      * queued demand of at least ``high_queue`` in some namespace for
        ``sustain`` windows → ``evict_namespace`` the namespace with the
        least queued demand, freeing a residency slot;
      * when one namespace holds at least ``skew`` of all queued demand →
        ``rebalance``, so placement packs the device windows around the
        live footprint again.

    Recommendation-only: ``apply_fleet`` executes it on the fleet."""

    high_queue: int = 4            # per-namespace depth that reads as demand
    skew: float = 0.5              # one namespace's share of queued demand
    sustain: int = 3               # consecutive windows before acting
    cooldown: int = 3
    _hot: int = dataclasses.field(default=0, repr=False)
    _hold: int = dataclasses.field(default=0, repr=False)

    def recommend(self, stats: ServeStats) -> ScaleDecision:
        if self._hold > 0:
            self._hold -= 1
            return ScaleDecision(reason="cooldown")
        depth = stats.ns_queue_depth or {}
        total = sum(depth.values())
        hot = total > 0 and max(depth.values()) >= self.high_queue
        self._hot = self._hot + 1 if hot else 0
        if self._hot < self.sustain:
            return ScaleDecision(reason="steady")
        self._hot = 0
        self._hold = self.cooldown
        worst = max(depth, key=depth.get)
        coldest = min(depth, key=depth.get)
        if depth[worst] / max(total, 1) >= self.skew:
            return ScaleDecision(
                "rebalance", 0,
                f"namespace {worst!r} holds {depth[worst]}/{total} queued "
                f"tickets (skew >= {self.skew:g})", target=worst)
        return ScaleDecision(
            "evict_namespace", 0,
            f"queued demand across {len(depth)} namespaces with "
            f"{stats.fleet_namespaces_resident} resident — freeing the "
            f"least-demanded slot", target=coldest)


def apply_fleet(fleet, decision: ScaleDecision, *,
                n_devices: Optional[int] = None) -> bool:
    """Execute a fleet-granularity decision on the live ``Fleet``. Returns
    True iff it acted (an eviction refused by the in-flight guard did not).
    ``n_devices`` passes through to ``Fleet.rebalance`` (needed on the
    CPU)."""
    if decision.action == "evict_namespace" and decision.target:
        return fleet.evict(decision.target)
    if decision.action == "rebalance":
        fleet.rebalance(n_devices)
        return True
    return False


def apply_guard(index, decision: ScaleDecision) -> bool:
    """Execute a recall-guard decision on the live handle. Returns True
    iff it acted. (``add_replicas``/``reshard`` stay with the caller —
    those are capacity ops; these two are correctness ops.)"""
    if decision.action == "fallback_untuned":
        index.force_untuned(True)
        return True
    if decision.action == "retune":
        index.request_retune(decision.reason)
        return True
    return False
