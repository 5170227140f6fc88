"""metrics-conformance over the port: one coherent metrics surface
(DESIGN.md §12.6), the reference's rule on ``src/repro_torch``.

Every series the port exports flows through ``obs/registry.py``'s
``MetricsRegistry``,
and the exporters (Prometheus text format, OTLP mapping) assume the
conventions this rule pins:

  * names match ``repro_[a-z0-9_]+`` — one prefix so dashboards can
    glob the whole stack, lowercase+underscore so the Prometheus
    exposition is valid without mangling;
  * counters end in ``_total`` (and nothing else does) — the suffix is
    how PromQL users tell a monotone rate()-able series from a gauge;
  * label keys come from the fixed vocabulary below — a typo'd label
    key (``namepsace``) silently forks a series and every dashboard
    aggregation quietly loses rows;
  * a name is registered with ONE kind across the whole tree — the
    registry raises at runtime on a (name, kind) conflict, but only on
    the code path that hits both call sites; ``finalize()`` catches it
    cross-file at lint time.

Dynamic names (``reg.counter(f"repro_{x}")``) defeat static checking —
they are flagged as findings so each one is either rewritten to a
literal or explicitly allow-listed.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Tuple

from repro_torch.analysis.engine import FileContext, Finding, Rule

NAME_RE = re.compile(r"^repro_[a-z0-9_]+$")

#: the closed label-key vocabulary (keep sorted; extending it is a
#: reviewed DESIGN.md §12.6 change, not a drive-by kwarg)
VOCAB = frozenset({
    "backend", "contract", "kernel", "kind", "namespace", "plane",
    "ring", "severity", "shard", "slo", "store_epoch", "tenant",
})

#: registry-method kwargs that are NOT labels
_NON_LABEL_KWARGS = ("help", "buckets")

_KINDS = ("counter", "gauge", "histogram")


class MetricsConformanceRule(Rule):
    name = "metrics-conformance"
    doc = ("metric names match repro_[a-z0-9_]+, counters end _total, "
           "label keys come from the fixed vocabulary, and each name "
           "has one kind tree-wide")

    def reset(self) -> None:
        # name -> [(kind, path, line)] for the cross-file conflict pass
        self.registrations: Dict[str, List[Tuple[str, str, int]]] = {}

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not (isinstance(fn, ast.Attribute) and fn.attr in _KINDS):
                continue
            # only registry-shaped receivers: reg/registry/...registry
            recv = fn.value
            recv_name = recv.attr if isinstance(recv, ast.Attribute) \
                else recv.id if isinstance(recv, ast.Name) else ""
            if recv_name not in ("reg", "registry", "metrics"):
                continue
            kind = fn.attr
            name_node = node.args[0] if node.args else None
            for kw in node.keywords:
                if kw.arg == "name":
                    name_node = kw.value
            if name_node is None:
                continue
            if not (isinstance(name_node, ast.Constant)
                    and isinstance(name_node.value, str)):
                yield ctx.finding(
                    self.name, name_node,
                    f"dynamic metric name at a {kind}() registration — "
                    f"static conformance checking needs a string literal; "
                    f"enumerate the variants or allow-list this site")
                continue
            mname = name_node.value
            self.registrations.setdefault(mname, []).append(
                (kind, ctx.rel, node.lineno))
            if not NAME_RE.match(mname):
                yield ctx.finding(
                    self.name, name_node,
                    f"metric name {mname!r} does not match "
                    f"'repro_[a-z0-9_]+' — the exporters and dashboard "
                    f"globs assume the repro_ prefix and snake_case")
            if kind == "counter" and not mname.endswith("_total"):
                yield ctx.finding(
                    self.name, name_node,
                    f"counter {mname!r} must end in '_total' — the "
                    f"suffix marks rate()-able monotone series")
            if kind != "counter" and mname.endswith("_total"):
                yield ctx.finding(
                    self.name, name_node,
                    f"{kind} {mname!r} ends in '_total', which is "
                    f"reserved for counters")
            for kw in node.keywords:
                if kw.arg is None or kw.arg in _NON_LABEL_KWARGS \
                        or kw.arg == "name":
                    continue
                if kw.arg not in VOCAB:
                    yield ctx.finding(
                        self.name, kw.value,
                        f"label key {kw.arg!r} on {mname!r} is outside "
                        f"the fixed vocabulary "
                        f"({', '.join(sorted(VOCAB))}) — a typo'd key "
                        f"forks the series; extend VOCAB deliberately "
                        f"if this is a new dimension")

    def finalize(self) -> Iterable[Finding]:
        for mname, regs in sorted(self.registrations.items()):
            kinds = {k for k, _, _ in regs}
            if len(kinds) > 1:
                sites = ", ".join(f"{p}:{ln} ({k})" for k, p, ln in regs)
                first = regs[0]
                yield Finding(
                    rule=self.name, path=first[1], line=first[2], col=0,
                    message=(f"metric {mname!r} registered with "
                             f"conflicting kinds at {sites} — the "
                             f"registry raises at runtime on whichever "
                             f"path hits both"),
                    snippet=f"kinds:{'+'.join(sorted(kinds))}")
