"""repro_torch.obs.slo — declarative SLOs with multi-window burn-rate
alerting (DESIGN.md §10.3), the port's copy of the reference's
pure-Python module: the same rules, edges and metric names.

An ``SLO`` names a *bad-event ratio* (recall mismatches / audited rows,
slow requests / completed, shed / submitted) and an error budget — for the
recall SLO the budget IS the paper's δ. The ``SLOEngine`` consumes
cumulative (bad, total) pairs per observation, keeps a short history, and
evaluates each SLO's ``BurnRule``s the SRE way: burn rate = (bad fraction
over a window) / budget, and a rule fires only when BOTH its long and its
short window burn exceed the factor — the long window keeps alerts
significant, the short window makes them reset quickly once the problem
stops.

Firing and resolving alerts land in the EventLog (``slo.alert`` /
``slo.resolve`` instants), in ``repro_slo_alerts_total`` /
``repro_slo_burn`` metrics, and in an ``AlertSink`` that
``serve/scale.py``'s ``RecallGuardPolicy`` consumes — a burning recall SLO
forces the ``use_tuned=False`` fallback and flags an ``Index.tune()``
re-race (``serve.scale.apply_guard``): observability driving an action,
not a dashboard.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Tuple

log = logging.getLogger("repro_torch.obs.slo")

SEVERITIES = ("page", "ticket")


@dataclasses.dataclass(frozen=True)
class BurnRule:
    """One multi-window burn-rate rule: fire when the budget burns at
    ≥ ``factor``× over BOTH the long and the short window."""

    long_s: float
    short_s: float
    factor: float
    severity: str = "page"

    def __post_init__(self):
        if self.long_s <= 0 or self.short_s <= 0:
            raise ValueError("burn-rule windows must be > 0, got "
                             f"({self.long_s}, {self.short_s})")
        if self.short_s > self.long_s:
            raise ValueError(
                f"short window ({self.short_s}s) must not exceed the long "
                f"window ({self.long_s}s)")
        if self.factor <= 0:
            raise ValueError(f"factor must be > 0, got {self.factor}")
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r} "
                             f"(want one of {SEVERITIES})")

    @property
    def name(self) -> str:
        return f"{self.factor:g}x/{self.long_s:g}s"


#: default rule pair, scaled down from the classic SRE 1h/5m + 6h/30m
#: ladder to serving-loop timescales (the engine is observation-driven —
#: wall windows only matter relative to how often ``observe`` runs)
DEFAULT_RULES = (
    BurnRule(long_s=60.0, short_s=5.0, factor=10.0, severity="page"),
    BurnRule(long_s=300.0, short_s=30.0, factor=2.0, severity="ticket"),
)


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative objective over a named (bad, total) ratio signal.

    ``budget`` is the allowed bad fraction: δ for the recall SLO, the
    tolerated slow fraction for a latency SLO, the tolerated shed
    fraction for admission."""

    name: str
    source: str                       # signal key in observe()'s dict
    budget: float                     # allowed bad-event fraction
    description: str = ""
    rules: Tuple[BurnRule, ...] = DEFAULT_RULES
    min_events: int = 1               # total events a window needs to fire

    def __post_init__(self):
        if not 0.0 < self.budget < 1.0:
            raise ValueError(
                f"budget must be in (0, 1), got {self.budget} "
                f"(SLO {self.name!r})")
        if not self.rules:
            raise ValueError(f"SLO {self.name!r} needs at least one rule")
        if self.min_events < 1:
            raise ValueError(
                f"min_events must be >= 1, got {self.min_events}")


@dataclasses.dataclass
class Alert:
    """One firing (or resolving) burn-rate alert."""

    slo: str
    severity: str
    rule: str                         # BurnRule.name
    burn_long: float
    burn_short: float
    bad_frac: float                   # long-window bad fraction
    budget: float
    at: float                         # engine clock timestamp
    active: bool = True               # False = this is the resolve edge


class AlertSink:
    """Collects alerts; ``active()`` is the set currently firing (keyed by
    (slo, rule)), which ``RecallGuardPolicy`` consumes."""

    def __init__(self):
        self.alerts: List[Alert] = []
        self._active: Dict[Tuple[str, str], Alert] = {}

    def emit(self, alert: Alert) -> None:
        self.alerts.append(alert)
        key = (alert.slo, alert.rule)
        if alert.active:
            self._active[key] = alert
        else:
            self._active.pop(key, None)

    def active(self, slo: Optional[str] = None) -> List[Alert]:
        return [a for a in self._active.values()
                if slo is None or a.slo == slo]

    def fired(self, slo: Optional[str] = None) -> List[Alert]:
        """Every rising-edge alert ever emitted (resolve edges excluded)."""
        return [a for a in self.alerts
                if a.active and (slo is None or a.slo == slo)]


def default_slos(delta: float, *, latency_ms: Optional[float] = None,
                 latency_budget: float = 0.01,
                 shed_budget: float = 0.05) -> Tuple[SLO, ...]:
    """The serving stack's stock objectives: recall ≥ 1−δ (budget = the
    effective δ — the paper's contract verbatim), optionally a latency SLO
    (≤ ``latency_budget`` of requests slower than ``latency_ms``), and a
    shed-rate SLO."""
    slos = [SLO(name="recall", source="recall", budget=delta,
                description=f"audited recall >= 1-delta (delta={delta:g})")]
    if latency_ms is not None:
        slos.append(SLO(
            name="latency", source="latency", budget=latency_budget,
            description=f"<= {latency_budget:g} of requests slower than "
                        f"{latency_ms:g} ms"))
    slos.append(SLO(name="shed", source="shed", budget=shed_budget,
                    description=f"<= {shed_budget:g} of submissions shed"))
    return tuple(slos)


def plane_sources(plane, auditor=None, *,
                  latency_ms: Optional[float] = None) -> dict:
    """Cumulative (bad, total) pairs for ``default_slos`` from a live
    ``RequestPlane`` (+ its auditor). The latency signal counts terminal
    latencies above the smallest histogram bucket ≥ ``latency_ms`` —
    the threshold snaps to a bucket boundary."""
    auditor = auditor if auditor is not None else \
        getattr(plane, "auditor", None)
    out = {}
    if auditor is not None:
        out["recall"] = (float(auditor.mismatch_rows),
                         float(auditor.sampled_rows))
    out["shed"] = (float(plane._shed.value),
                   float(plane._submitted.value))
    if latency_ms is not None:
        h = plane._h_latency
        slow = float(h.count)
        for b, c in zip(h.buckets, h.counts):
            if b >= latency_ms:
                break
            slow -= c
        out["latency"] = (max(slow, 0.0), float(h.count))
    return out


class SLOEngine:
    """Evaluates a set of ``SLO``s against cumulative (bad, total) signals.

    Feed one ``observe(sources)`` call per observation window; the engine
    differences the cumulative pairs over each rule's windows, computes
    burn rates, and edge-triggers alerts into the sink / EventLog /
    metrics. State is bounded: per-SLO history is trimmed to the longest
    rule window."""

    def __init__(self, slos, *, sink: Optional[AlertSink] = None,
                 obs=None, clock=time.monotonic,
                 labels: Optional[dict] = None):
        slos = tuple(slos)
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.slos = slos
        self.sink = sink if sink is not None else AlertSink()
        self.obs = obs
        self.clock = clock
        self._labels = dict(labels or {})
        self._hist: Dict[str, List[Tuple[float, float, float]]] = \
            {s.name: [] for s in slos}
        self._active: Dict[Tuple[str, str], Alert] = {}
        self.alerts_fired = 0
        if obs is not None:
            reg = obs.registry
            self._c_alerts = {
                (s.name, r.severity): reg.counter(
                    "repro_slo_alerts_total", "burn-rate alerts fired",
                    slo=s.name, severity=r.severity, **self._labels)
                for s in slos for r in s.rules}
            self._g_burn = {
                s.name: reg.gauge(
                    "repro_slo_burn",
                    "error-budget burn rate over the longest rule window "
                    "(1.0 = burning exactly the budget)",
                    slo=s.name, **self._labels)
                for s in slos}
        else:
            self._c_alerts = {}
            self._g_burn = {}

    def _window(self, hist, now: float, window_s: float,
                min_events: int) -> Tuple[float, float]:
        """(bad fraction, total events) over the trailing window: delta of
        the cumulative pair against the earliest sample inside the window
        (or zero if the history starts inside it — cold starts count from
        the beginning)."""
        cutoff = now - window_s
        base_bad = base_total = 0.0
        for (t, bad, total) in hist:
            if t >= cutoff:
                break
            base_bad, base_total = bad, total
        bad, total = hist[-1][1] - base_bad, hist[-1][2] - base_total
        if total < min_events:
            return 0.0, total
        return (bad / total if total > 0 else 0.0), total

    def observe(self, sources: Dict[str, Tuple[float, float]],
                now: Optional[float] = None) -> List[Alert]:
        """One evaluation pass. ``sources`` maps signal name →
        cumulative (bad, total). Returns newly fired rising-edge alerts."""
        now = self.clock() if now is None else now
        fired: List[Alert] = []
        for slo in self.slos:
            if slo.source not in sources:
                continue
            bad, total = sources[slo.source]
            hist = self._hist[slo.name]
            hist.append((now, float(bad), float(total)))
            horizon = max(r.long_s for r in slo.rules)
            while len(hist) > 2 and hist[1][0] < now - horizon:
                hist.pop(0)
            longest = max(slo.rules, key=lambda r: r.long_s)
            frac_longest, _ = self._window(hist, now, longest.long_s,
                                           slo.min_events)
            if slo.name in self._g_burn:
                self._g_burn[slo.name].set(frac_longest / slo.budget)
            for rule in slo.rules:
                frac_l, n_l = self._window(hist, now, rule.long_s,
                                           slo.min_events)
                frac_s, _n_s = self._window(hist, now, rule.short_s, 1)
                burn_l = frac_l / slo.budget
                burn_s = frac_s / slo.budget
                key = (slo.name, rule.name)
                burning = (burn_l >= rule.factor and burn_s >= rule.factor
                           and n_l >= slo.min_events)
                was = key in self._active
                if burning and not was:
                    alert = Alert(slo=slo.name, severity=rule.severity,
                                  rule=rule.name, burn_long=burn_l,
                                  burn_short=burn_s, bad_frac=frac_l,
                                  budget=slo.budget, at=now, active=True)
                    self._active[key] = alert
                    self.sink.emit(alert)
                    fired.append(alert)
                    self.alerts_fired += 1
                    if (slo.name, rule.severity) in self._c_alerts:
                        self._c_alerts[(slo.name, rule.severity)].inc()
                    if self.obs is not None:
                        self.obs.tracer.instant(
                            "slo.alert", slo=slo.name, rule=rule.name,
                            severity=rule.severity, burn_long=burn_l,
                            burn_short=burn_s, budget=slo.budget)
                    log.warning(
                        "SLO %s burning: rule %s fires (burn long=%.2fx "
                        "short=%.2fx of budget %g)", slo.name, rule.name,
                        burn_l, burn_s, slo.budget)
                elif was and not burning:
                    old = self._active.pop(key)
                    resolve = dataclasses.replace(
                        old, burn_long=burn_l, burn_short=burn_s,
                        bad_frac=frac_l, at=now, active=False)
                    self.sink.emit(resolve)
                    if self.obs is not None:
                        self.obs.tracer.instant(
                            "slo.resolve", slo=slo.name, rule=rule.name,
                            burn_long=burn_l)
                    log.info(
                        "SLO %s recovered: rule %s resolved", slo.name,
                        rule.name)
        return fired

    @property
    def active_alerts(self) -> List[Alert]:
        return list(self._active.values())

    def state(self) -> dict:
        """JSON-safe engine state (the health snapshot's slo section)."""
        out = []
        for slo in self.slos:
            hist = self._hist[slo.name]
            now = hist[-1][0] if hist else self.clock()
            rules = []
            for rule in slo.rules:
                frac_l, n_l = (self._window(hist, now, rule.long_s,
                                            slo.min_events)
                               if hist else (0.0, 0.0))
                rules.append({
                    "rule": rule.name,
                    "severity": rule.severity,
                    "factor": rule.factor,
                    "burn": frac_l / slo.budget,
                    "window_events": n_l,
                    "active": (slo.name, rule.name) in self._active,
                })
            out.append({
                "name": slo.name,
                "source": slo.source,
                "budget": slo.budget,
                "description": slo.description,
                "bad_frac": (self._window(hist, now,
                                          max(r.long_s for r in slo.rules),
                                          1)[0] if hist else 0.0),
                "rules": rules,
            })
        return {
            "slos": out,
            "alerts_fired": self.alerts_fired,
            "active": [dataclasses.asdict(a) for a in self.active_alerts],
        }
