"""Race-level trace spans over the event log (DESIGN.md §8.3); the port's
own copy of the reference's module.

A *span* is one timed phase of one trace (``ph="X"`` in the Chrome trace
event model); an *instant* is a point event (``ph="i"``). Every serving
ticket gets a trace id at submit (``p<plane>.t<ticket>``) that is
propagated through its whole lifecycle — submit → queue → admit → each
race epoch → terminal — so ``tools/trace_view.py`` can reconstruct exactly
where any individual query's pulls, epochs and wall-time went. Race
sessions record under their own ``s<N>`` trace id; the ticket's ``admit``
event carries ``session=<sid>`` as the join key.

Spans are recorded *at end* (one event each, into the bounded ring), so an
abandoned span costs nothing. All timing is ``time.perf_counter()`` on one
clock; exporters convert to microseconds.
"""
from __future__ import annotations

import itertools
import time
from typing import Optional

from repro_torch.obs.registry import EventLog

_ids = itertools.count()


def new_trace_id(prefix: str) -> str:
    """Process-unique trace id: ``<prefix>-<N>``."""
    return f"{prefix}-{next(_ids)}"


class Span:
    """An open span; ``end()`` records it. Usable as a context manager."""

    __slots__ = ("_tracer", "name", "trace", "t0", "attrs", "_open")

    def __init__(self, tracer: "Tracer", name: str, trace: Optional[str],
                 attrs: dict):
        self._tracer = tracer
        self.name = name
        self.trace = trace
        self.attrs = attrs
        self.t0 = time.perf_counter()
        self._open = True

    def end(self, **attrs) -> None:
        if not self._open:          # idempotent: double-end records once
            return
        self._open = False
        if attrs:
            self.attrs.update(attrs)
        self._tracer.complete(self.name, self.t0,
                              time.perf_counter() - self.t0,
                              trace=self.trace, **self.attrs)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class _NullSpan:
    """No-op span handed out by a disabled tracer."""

    __slots__ = ()
    name = trace = None
    t0 = 0.0
    attrs: dict = {}

    def end(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Records spans/instants into an ``EventLog``. Disabled ⇒ every call
    is a cheap no-op (the ≤2% overhead budget's off switch, §8.5)."""

    def __init__(self, log: EventLog, enabled: bool = True):
        self.log = log
        self.enabled = enabled

    def start(self, name: str, trace: Optional[str] = None, **attrs):
        """Open a span whose end is at a different call site (e.g. the
        queue span: opened at submit, ended at admit)."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, trace, attrs)

    def span(self, name: str, trace: Optional[str] = None, **attrs):
        """Context-manager form for lexically scoped phases."""
        return self.start(name, trace, **attrs)

    def complete(self, name: str, t0: float, dur: float,
                 trace: Optional[str] = None, **attrs) -> None:
        """Record an already-timed span (explicit t0/duration, seconds)."""
        if not self.enabled:
            return
        self.log.append({"ph": "X", "name": name, "trace": trace,
                         "ts": t0, "dur": dur, "attrs": attrs})

    def instant(self, name: str, trace: Optional[str] = None,
                **attrs) -> None:
        if not self.enabled:
            return
        self.log.append({"ph": "i", "name": name, "trace": trace,
                         "ts": time.perf_counter(), "dur": 0.0,
                         "attrs": attrs})
