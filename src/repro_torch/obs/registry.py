"""Metrics registry + bounded ring-buffer event log (DESIGN.md §8.1), the
port's own copy of the reference's pure-Python module: the same names,
kinds and semantics, so one dashboard reads either package.

No external deps: three metric kinds (monotone ``Counter``, point-in-time
``Gauge``, explicit-bucket ``Histogram``) keyed by (name, labels) in one
``MetricsRegistry``, and an ``EventLog`` — a preallocated ring buffer whose
append is a single index store plus a list assignment (no locks taken; the
GIL makes the single-writer serving loop race-free, and a torn read from an
exporter thread at worst sees one stale slot, never a partial event).

Naming scheme (§8.2): ``repro_<subsystem>_<what>[_<unit>][_total]`` —
e.g. ``repro_plane_submitted_total``, ``repro_race_epoch_ms``,
``repro_kernel_coord_ops_total``. Counters end in ``_total``; durations are
milliseconds; labels distinguish instances (``plane="p0"``) and kinds
(``kernel="fused_epoch_pull"``), never unbounded values like trace ids.
"""
from __future__ import annotations

import bisect
import re
from typing import Dict, Iterable, List, Optional, Tuple

#: runtime half of the metrics-conformance contract (DESIGN.md §12.6): the
#: reference's metric names, so the port's series read as the reference's
_NAME_RE = re.compile(r"^repro_[a-z0-9_]+$")

#: default duration buckets (ms) — log-spaced to cover one kernel launch
#: (~0.1 ms) through a run-to-certification race under overload (~60 s)
DEFAULT_MS_BUCKETS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                      1000, 2500, 5000, 15000, 60000)


class Counter:
    """Monotonically increasing float."""

    kind = "counter"
    __slots__ = ("name", "help", "labels", "value")

    def __init__(self, name: str, help: str = "", labels: Tuple = ()):
        self.name, self.help, self.labels = name, help, labels
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({v})")
        self.value += v


class Gauge:
    """Point-in-time float."""

    kind = "gauge"
    __slots__ = ("name", "help", "labels", "value")

    def __init__(self, name: str, help: str = "", labels: Tuple = ()):
        self.name, self.help, self.labels = name, help, labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def dec(self, v: float = 1.0) -> None:
        self.value -= v


class Histogram:
    """Explicit-bucket histogram (cumulative ``le`` semantics on export)."""

    kind = "histogram"
    __slots__ = ("name", "help", "labels", "buckets", "counts", "sum",
                 "count")

    def __init__(self, name: str, help: str = "", labels: Tuple = (),
                 buckets: Iterable[float] = DEFAULT_MS_BUCKETS):
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.name, self.help, self.labels = name, help, labels
        self.buckets = bs
        self.counts = [0] * (len(bs) + 1)      # last = +inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        if v != v:                              # NaN never lands in a bucket
            return
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def snapshot(self) -> dict:
        """JSON-stable view: per-bucket (non-cumulative) counts + sum/count."""
        return {"buckets": list(self.buckets), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}

    def quantile(self, q: float) -> float:
        """Approximate quantile by linear interpolation inside the bucket —
        good enough for dashboards; exact percentiles come from the plane's
        bounded latency window. Returns 0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        lo = 0.0
        for i, c in enumerate(self.counts):
            hi = (self.buckets[i] if i < len(self.buckets)
                  else self.buckets[-1])
            if seen + c >= rank:
                if c == 0 or hi == lo:
                    return hi
                return lo + (hi - lo) * (rank - seen) / c
            seen += c
            lo = hi
        return self.buckets[-1]


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """One namespace of metrics, keyed by (name, sorted label items)."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple], object] = {}
        self._help: Dict[str, str] = {}
        self._kind: Dict[str, str] = {}

    def _get(self, kind: str, name: str, help: str, labels: dict,
             **kw):
        if not _NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} does not match "
                f"'repro_[a-z0-9_]+' (naming scheme, DESIGN.md §8.2)")
        if (kind == "counter") != name.endswith("_total"):
            raise ValueError(
                f"{kind} {name!r}: the '_total' suffix is required on "
                f"counters and reserved for them (DESIGN.md §8.2)")
        if name in self._kind and self._kind[name] != kind:
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{self._kind[name]}, not {kind}")
        key = (name, tuple(sorted(labels.items())))
        got = self._metrics.get(key)
        if got is None:
            got = _KINDS[kind](name, help or self._help.get(name, ""),
                               key[1], **kw)
            self._metrics[key] = got
            self._kind[name] = kind
            if help:
                self._help[name] = help
        return got

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_MS_BUCKETS,
                  **labels) -> Histogram:
        return self._get("histogram", name, help, labels, buckets=buckets)

    def collect(self) -> List[object]:
        """All series, grouped by name (stable registration order)."""
        return list(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)


class EventLog:
    """Bounded ring buffer of event dicts.

    ``append`` never allocates buffer space (the ring is preallocated) and
    never blocks; once full, the oldest event is overwritten and counted in
    ``drops`` — backpressure by forgetting history, never by stalling the
    serving loop.
    """

    def __init__(self, capacity: int = 16384):
        if capacity < 1:
            raise ValueError(f"event log capacity must be >= 1, "
                             f"got {capacity}")
        self.capacity = capacity
        self._buf: List[Optional[dict]] = [None] * capacity
        self._head = 0
        self._count = 0       # events currently buffered
        self.total = 0        # events ever appended (lifetime)
        self.drops = 0        # events overwritten before being exported
        self.on_drop = None   # callback(ring) per overwrite — ObsContext
                              # wires the drops counter + warn-once here

    def append(self, event: dict) -> None:
        i = self._head
        if self._buf[i] is not None:
            self.drops += 1
            if self.on_drop is not None:
                self.on_drop(self)
        else:
            self._count += 1
        self._buf[i] = event
        self._head = (i + 1) % self.capacity
        self.total += 1

    def snapshot(self) -> List[dict]:
        """Events oldest-first (non-destructive)."""
        h = self._head
        out = self._buf[h:] + self._buf[:h]
        return [e for e in out if e is not None]

    def clear(self) -> None:
        self._buf = [None] * self.capacity
        self._head = 0
        self._count = 0

    def __len__(self) -> int:
        return self._count
