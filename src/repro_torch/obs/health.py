"""repro_torch.obs.health — one JSON health/SLO snapshot for the serving
stack (DESIGN.md §10.4), the reference's document.

``health_snapshot`` folds the δ-auditor's estimator state, the SLO
engine's burn state and active alerts, and the serving-fallback flags on
the handle together with the plane's ``ServeStats`` into a single
schema-versioned JSON document, with the reference's keys, so dashboards
and replay tooling parse either package's.
"""
from __future__ import annotations

import json

import numpy as np


def _jsonify(obj):
    """Best-effort JSON coercion for numpy scalars/arrays inside stats."""
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _jsonify(obj.tolist())
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        v = float(obj)
        return v if np.isfinite(v) else repr(v)
    if isinstance(obj, float) and not np.isfinite(obj):
        return repr(obj)
    return obj


def health_snapshot(*, plane=None, index=None, auditor=None,
                    slo=None, fleet=None) -> dict:
    """One JSON-safe health document. Pass whichever pieces exist — a
    plane implies its index and auditor unless overridden; a fleet adds a
    per-namespace residency/queue rollup (``fleet`` section). ``ok`` is
    the one-bit rollup: no active SLO alert, no audited key in
    δ-violation, and no forced serving fallback."""
    from repro_torch.api.spec import SCHEMA_VERSION
    if plane is not None:
        index = index if index is not None else plane.index
        auditor = auditor if auditor is not None else \
            getattr(plane, "auditor", None)
        if fleet is None and getattr(plane, "router", None) is not None \
                and hasattr(plane.router, "stats"):
            fleet = plane.router
    doc = {"schema_version": SCHEMA_VERSION,
           "generated_by": "repro_torch.obs.health"}
    violations = []
    active_alerts = []
    if plane is not None:
        doc["stats"] = _jsonify(plane.stats.as_dict())
    elif index is not None:
        doc["stats"] = _jsonify(index.stats.as_dict())
    if index is not None:
        doc["index"] = {
            "kind": index.kind,
            "shards": index.n_shards,
            "live": index.n_live,
            "capacity": index.capacity,
            "epoch": index.epoch,
            "k": index.k,
            "delta": float(index.cfg.delta),
            "tuned": index.tuned is not None,
            "serving_fallback": getattr(index, "serving_fallback", False),
            "retune_requested": bool(
                getattr(index, "retune_requested", False)),
        }
    if auditor is not None:
        audit = auditor.summary()
        doc["audit"] = _jsonify(audit)
        violations = [k for k in audit["keys"] if k["violated"]]
    if fleet is not None:
        fdoc = dict(fleet.stats())
        if plane is not None and hasattr(plane, "ns_queue_depth"):
            fdoc["ns_queue_depth"] = plane.ns_queue_depth()
        doc["fleet"] = _jsonify(fdoc)
    if slo is not None:
        state = slo.state()
        doc["slo"] = _jsonify(state)
        active_alerts = state["active"]
    doc["violations"] = _jsonify(violations)
    doc["ok"] = (not violations and not active_alerts
                 and not (index is not None
                          and getattr(index, "serving_fallback", False)))
    return doc


def dump_health(path: str, *, plane=None, index=None, auditor=None,
                slo=None, fleet=None) -> dict:
    """Write ``health_snapshot`` to ``path``; returns the document."""
    doc = health_snapshot(plane=plane, index=index, auditor=auditor,
                          slo=slo, fleet=fleet)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return doc


def print_health(doc: dict, *, out=None) -> None:
    """Terse human rendering of a health snapshot (launcher/bench logs)."""
    import sys
    out = out if out is not None else sys.stderr
    audit = doc.get("audit") or {}
    lines = [f"health ok={doc['ok']}"]
    if audit:
        lines.append(
            f"  audit: {audit['sampled_rows']} rows sampled, "
            f"{audit['mismatch_rows']} mismatches, "
            f"err_upper={audit['err_upper']:.4g} "
            f"(pending {audit['pending']}, dropped {audit['dropped']})")
    for s in (doc.get("slo") or {}).get("slos", []):
        burn = max((r["burn"] for r in s["rules"]), default=0.0)
        lines.append(f"  slo {s['name']}: budget={s['budget']:g} "
                     f"bad_frac={s['bad_frac']:.4g} burn={burn:.2f}x")
    for v in doc.get("violations", []):
        lines.append(f"  VIOLATION: {v}")
    print("\n".join(lines), file=out)
