"""Exporters: Prometheus text, JSON snapshots, raw event dumps
(DESIGN.md §8.4), the port's copy of the reference's pure-Python module:
the same output shapes byte for byte, so one scraper or dashboard reads
either package.

Three stable output shapes, all derivable offline from one ``ObsContext``:

  * ``prometheus_text`` — the Prometheus exposition format (text/plain
    0.0.4): counters/gauges as single samples, histograms as cumulative
    ``_bucket{le=...}`` series plus ``_sum``/``_count``.
  * ``json_snapshot`` — every series (and optionally the event log) as one
    JSON document, tagged with the API ``schema_version``.
  * ``dump_events`` — the raw event-log snapshot, the document the
    reference's ``tools/trace_view.py`` renders or converts to a
    Perfetto-loadable Chrome trace.
"""
from __future__ import annotations

import collections
import json
from typing import List, Optional

from repro_torch.obs.registry import Counter, Gauge, Histogram, MetricsRegistry


def _esc_label(v) -> str:
    """Label-value escaping per the exposition format: backslash, double
    quote and newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _esc_help(s: str) -> str:
    """HELP-text escaping: backslash and newline only."""
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels, extra: str = "") -> str:
    parts = [f'{k}="{_esc_label(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if v != v:
        return "NaN"
    return repr(v) if isinstance(v, float) and not v.is_integer() \
        else str(int(v))


def prometheus_text(registry: MetricsRegistry) -> str:
    """Prometheus exposition text (text/plain 0.0.4) for every series in
    the registry. Scraper-conformant: all series of one metric name are
    emitted contiguously in one group (registration can interleave
    names), each group carries exactly one ``# TYPE`` (before any sample)
    and at most one ``# HELP`` (escaped), label values are escaped, and
    histograms emit cumulative ``le`` buckets + ``+Inf`` + ``_sum`` +
    ``_count``."""
    groups: "collections.OrderedDict[str, List[object]]" = \
        collections.OrderedDict()
    for m in registry.collect():
        groups.setdefault(m.name, []).append(m)
    lines: List[str] = []
    for name, series in groups.items():
        help_text = next((m.help for m in series if m.help), "")
        if help_text:
            lines.append(f"# HELP {name} {_esc_help(help_text)}")
        lines.append(f"# TYPE {name} {series[0].kind}")
        for m in series:
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"{m.name}{_fmt_labels(m.labels)} "
                             f"{_fmt_value(m.value)}")
            elif isinstance(m, Histogram):
                cum = 0
                for b, c in zip(m.buckets, m.counts):
                    cum += c
                    le = 'le="' + _fmt_value(b) + '"'
                    lines.append(f"{m.name}_bucket"
                                 f"{_fmt_labels(m.labels, le)} {cum}")
                cum += m.counts[-1]
                le_inf = 'le="+Inf"'
                lines.append(f"{m.name}_bucket"
                             f"{_fmt_labels(m.labels, le_inf)} {cum}")
                lines.append(f"{m.name}_sum{_fmt_labels(m.labels)} "
                             f"{_fmt_value(m.sum)}")
                lines.append(
                    f"{m.name}_count{_fmt_labels(m.labels)} {m.count}")
    return "\n".join(lines) + "\n"


def json_snapshot(obs, include_events: bool = False) -> dict:
    """One JSON document: every metric series (+ the event log on demand)."""
    from repro_torch.api.spec import SCHEMA_VERSION
    series = []
    for m in obs.registry.collect():
        entry = {"name": m.name, "kind": m.kind, "labels": dict(m.labels)}
        if isinstance(m, Histogram):
            entry.update(m.snapshot())
        else:
            entry["value"] = m.value
        series.append(entry)
    out = {"schema_version": SCHEMA_VERSION, "metrics": series,
           "events_total": obs.events.total,
           "event_drops": obs.events.drops}
    if include_events:
        out["events"] = obs.events.snapshot()
    return out


def events_doc(obs) -> dict:
    """The raw trace document the reference's ``tools/trace_view.py``
    consumes."""
    from repro_torch.api.spec import SCHEMA_VERSION
    return {"schema_version": SCHEMA_VERSION,
            "clock": "perf_counter_s",
            "event_drops": obs.events.drops,
            "events": obs.events.snapshot()}


def dump_events(path: str, obs) -> None:
    with open(path, "w") as f:
        json.dump(events_doc(obs), f, indent=1)


def dump_metrics(path: str, obs,
                 include_events: Optional[bool] = None) -> None:
    """Write metrics to ``path``: ``.json`` gets the JSON snapshot,
    anything else the Prometheus text format."""
    if path.endswith(".json"):
        with open(path, "w") as f:
            json.dump(json_snapshot(
                obs, include_events=bool(include_events)), f, indent=1)
    else:
        with open(path, "w") as f:
            f.write(prometheus_text(obs.registry))
