"""repro_torch.obs — observability for the port's serving stack
(DESIGN.md §8).

One ``ObsContext`` bundles the three primitives every layer records into:

  * ``registry`` — the metrics registry (counters / gauges / histograms),
    the single source of truth behind the plane's ``ServeStats`` and the
    ``serve/scale.py`` policies;
  * ``events``   — the bounded ring-buffer event log;
  * ``tracer``   — race-level trace spans over that log (per-ticket trace
    ids propagated submit → queue → admit → each race epoch → terminal).

``get_obs()`` returns the process-default context; tests and embedders can
pass their own ``ObsContext`` to ``RequestPlane`` / ``make_session`` for
isolation. ``REPRO_OBS=0`` disables event and span recording (the metric
counters stay on: ``ServeStats`` reads them); ``REPRO_OBS_EVENTS`` sizes the
default ring.

Beside them: ``audit`` (the shadow δ-auditor and flight recorder),
``slo`` (burn-rate alerting), ``export`` (Prometheus text, JSON snapshots)
and ``health`` (one JSON health document), the reference's modules. The
reference's ``jaxmon`` (XLA compile and recompile telemetry) has no
counterpart: the port compiles no XLA programs, and its CUDA kernels are
built once per source and process by ``kernels/_build.py``, which logs each
build.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

from repro_torch.obs.audit import (DeltaAuditor, FlightRecorder,
                                   clopper_pearson_upper, exact_topk,
                                   load_bundle, replay_bundle, wilson_upper)
from repro_torch.obs.export import (dump_events, dump_metrics, events_doc,
                                    json_snapshot, prometheus_text)
from repro_torch.obs.health import dump_health, health_snapshot, print_health
from repro_torch.obs.registry import (DEFAULT_MS_BUCKETS, Counter, EventLog,
                                      Gauge, Histogram, MetricsRegistry)
from repro_torch.obs.slo import (SLO, Alert, AlertSink, BurnRule, SLOEngine,
                                 default_slos, plane_sources)
from repro_torch.obs.trace import NULL_SPAN, Span, Tracer, new_trace_id

__all__ = [
    "Alert", "AlertSink", "BurnRule", "Counter", "DEFAULT_MS_BUCKETS",
    "DeltaAuditor", "EventLog", "FlightRecorder", "Gauge", "Histogram",
    "MetricsRegistry", "NULL_SPAN", "ObsContext", "SLO", "SLOEngine",
    "Span", "Tracer", "clopper_pearson_upper", "default_slos",
    "dump_events", "dump_health", "dump_metrics", "events_doc",
    "exact_topk", "get_obs", "health_snapshot", "json_snapshot",
    "load_bundle", "new_trace_id", "plane_sources", "print_health",
    "prometheus_text", "replay_bundle", "reset_obs", "set_obs",
    "wilson_upper",
]


class ObsContext:
    """One observability namespace: registry + event log + tracer."""

    def __init__(self, name: str = "default", *,
                 event_capacity: int = 16384,
                 enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("REPRO_OBS", "1") != "0"
        self.name = name
        self.enabled = enabled
        self.registry = MetricsRegistry()
        self.events = EventLog(event_capacity)
        self.tracer = Tracer(self.events, enabled=enabled)
        # ring overflow must be visible, not silent: every overwrite counts
        # into the registry, and the first one warns, so a truncated trace
        # never passes for a complete one
        self._drops_counter = self.registry.counter(
            "repro_obs_event_drops_total",
            "trace events overwritten before export (ring overflow)",
            ring=name)
        self._drop_warned = False
        self.events.on_drop = self._on_event_drop

    def _on_event_drop(self, ring) -> None:
        self._drops_counter.inc()
        if not self._drop_warned:
            self._drop_warned = True
            logging.getLogger("repro_torch.obs").warning(
                "trace event ring %r overflowed (capacity %d): oldest "
                "events are being dropped — raise REPRO_OBS_EVENTS or "
                "export more often", self.name, ring.capacity)


_default: Optional[ObsContext] = None


def get_obs() -> ObsContext:
    """The process-default context (created lazily; honours ``REPRO_OBS``)."""
    global _default
    if _default is None:
        cap = int(os.environ.get("REPRO_OBS_EVENTS", "16384"))
        _default = ObsContext("default", event_capacity=cap)
    return _default


def set_obs(ctx: ObsContext) -> ObsContext:
    """Install ``ctx`` as the process default; returns the previous one."""
    global _default
    old = get_obs()
    _default = ctx
    return old


def reset_obs() -> ObsContext:
    """Fresh default context (test isolation)."""
    global _default
    _default = None
    return get_obs()
