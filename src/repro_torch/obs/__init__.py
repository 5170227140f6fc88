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
default ring. The reference's audit, SLO, health, export and compile
telemetry modules are not ported yet (ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

import logging
import os
from typing import Optional

from repro_torch.obs.registry import (DEFAULT_MS_BUCKETS, Counter, EventLog,
                                      Gauge, Histogram, MetricsRegistry)
from repro_torch.obs.trace import NULL_SPAN, Span, Tracer, new_trace_id

__all__ = [
    "Counter", "DEFAULT_MS_BUCKETS", "EventLog", "Gauge", "Histogram",
    "MetricsRegistry", "NULL_SPAN", "ObsContext", "Span", "Tracer",
    "get_obs", "new_trace_id", "reset_obs", "set_obs",
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
