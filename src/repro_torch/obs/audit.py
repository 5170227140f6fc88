"""repro_torch.obs.audit — the shadow δ-auditor and failure flight
recorder (DESIGN.md §10), the reference's module on the port's oracle.

The paper's whole contract is statistical: the racing index returns exact
nearest neighbors with probability ≥ 1−δ. This module measures that on
served traffic:

  * ``exact_topk`` / ``exact_theta_of`` — a brute-force oracle over the
    dense, rotated and sparse boxes on the ported ``pairwise_dist`` kernel:
    one call of the prepared (padded, rotated) queries against the stored
    rows (ℓ2 on the tensor cores for Q > 4 on the card), over the whole
    capacity or in row chunks; sparse rows are densified in chunks and held
    against the densified queries on the ℓ1 kernel. Both keep the running
    top-k of ``core.oracle.running_topk``, which ``exact_knn_sparse`` keeps
    too. Dead slots read +inf. θ is the
    distance over the true ``store.d`` — the reference's audit scale and
    the scale the port reports values on.
  * ``DeltaAuditor`` — samples a configurable fraction of terminal tickets
    into a bounded per-tenant reservoir (``offer``, one RNG draw plus host
    array copies — nothing expensive on the serving path) and re-answers
    them exactly later (``process``/``flush``, run off the critical path:
    the plane only calls it on idle steps or on demand). Per
    (tenant, store-epoch, tuned-vs-default) empirical error rates carry a
    Wilson/Clopper–Pearson upper confidence bound compared against the
    effective δ, exported as ``repro_audit_{sampled,mismatch}_total``
    counters and ``repro_audit_err_upper`` gauges.
  * ``FlightRecorder`` — every audit mismatch is captured as a replayable
    on-disk bundle (query arrays, QuerySpec, store epoch, tuned config,
    the ticket's trace spans, served-vs-exact ids/θ) written atomically, in
    the reference's layout (either package's ``load_bundle`` reads it);
    ``replay_bundle`` / ``tools/torch_replay_audit.py`` re-run a bundle
    against a loaded index.

Mismatch definition: a served id is *correct* iff its exact θ is within a
tie tolerance of the k-th smallest exact θ (distinct slots may tie — the
1−δ contract promises *a* set of exact nearest neighbors, not a unique
one); a row fails if any served id is invalid, duplicated, or strictly
worse than the k-th exact value plus tolerance. The served ids' θ are read
from the same distance rows as the exact top-k: two kernels (the
tensor-core ℓ2 and a CUDA-core gather) may differ by up to 1e-4 relative,
the whole tie tolerance, and would flag near-ties as mismatches.

Behind a fleet (``router=``), namespaced items resolve their index through
the router when the oracle runs (reloading an evicted namespace, the
plane's own routing contract); an item whose namespace was dropped since
counts as ``unroutable``, and the plane counts a namespaced ticket it
cannot route as ``namespaced``. Keys and metric labels carry the
namespace.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import logging
import math
import os
import random
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.oracle import densify, running_topk, sparse_l1
from repro_torch.kernels import ops as kops
from repro_torch.utils.hostsync import host_fetch

log = logging.getLogger("repro_torch.obs.audit")

#: flight-recorder bundle schema — bump on any layout change so
#: ``tools/torch_replay_audit.py`` can gate.
BUNDLE_SCHEMA = 1

BUNDLE_DOC = "bundle.json"
BUNDLE_ARRAYS = "arrays.npz"

#: tie tolerance for the served-vs-exact θ comparison: θ values are f32
#: distances / d, so equal slots can differ in the last few ulps between
#: the racing driver's accumulation order and the oracle's.
DEFAULT_RTOL = 1e-4
DEFAULT_ATOL = 1e-5

_AUDIT_SKIP_REASONS = ("stale_epoch", "uncertified", "reservoir_full",
                       "namespaced", "unroutable")

#: elements of one (Q, rows) distance chunk of the dense oracle (1 GiB of
#: fp32): at a ticket's Q the whole capacity is one ``pairwise_dist`` call
DENSE_CHUNK_ELEMS = 1 << 28
#: corpus rows densified per ℓ1 call of the sparse oracle (the chunk of
#: ``core.oracle.exact_knn_sparse``)
SPARSE_CHUNK_ROWS = 8192


def _host(a) -> np.ndarray:
    """A host (numpy) copy of an array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().copy()
    return np.array(a)


# -- binomial upper confidence bounds ---------------------------------------

def _norm_ppf(p: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation,
    |rel err| < 1.2e-9 — no scipy in the container)."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"p must be in (0, 1), got {p}")
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                * q + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q
                                + d[3]) * q + 1)
    if p > phigh:
        q = math.sqrt(-2 * math.log(1 - p))
        return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                 * q + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q
                                 + d[3]) * q + 1)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
            * r + a[5]) * q / (((((b[0] * r + b[1]) * r + b[2]) * r
                                 + b[3]) * r + b[4]) * r + 1)


def wilson_upper(failures: int, n: int, confidence: float = 0.95) -> float:
    """One-sided Wilson-score upper bound on a binomial proportion: the
    largest error rate still consistent (at ``confidence``) with seeing
    ``failures`` δ-failures in ``n`` audited rows. 1.0 when nothing has
    been audited yet — no evidence means no claim."""
    if n <= 0:
        return 1.0
    if failures < 0 or failures > n:
        raise ValueError(f"failures must be in [0, {n}], got {failures}")
    z = _norm_ppf(confidence)
    p = failures / n
    z2 = z * z
    center = p + z2 / (2 * n)
    rad = z * math.sqrt(p * (1 - p) / n + z2 / (4 * n * n))
    return min(1.0, (center + rad) / (1 + z2 / n))


def clopper_pearson_upper(failures: int, n: int,
                          confidence: float = 0.95) -> float:
    """Exact (Clopper–Pearson) one-sided upper bound, via bisection on the
    binomial CDF in log space. Slower than ``wilson_upper`` but exact —
    the estimator default stays Wilson; this is the cross-check."""
    if n <= 0:
        return 1.0
    if failures < 0 or failures > n:
        raise ValueError(f"failures must be in [0, {n}], got {failures}")
    if failures >= n:
        return 1.0
    alpha = 1.0 - confidence
    log_comb = [math.lgamma(n + 1) - math.lgamma(i + 1)
                - math.lgamma(n - i + 1) for i in range(failures + 1)]

    def cdf(p: float) -> float:
        if p <= 0.0:
            return 1.0
        if p >= 1.0:
            return 0.0
        lp, l1p = math.log(p), math.log1p(-p)
        return sum(math.exp(lc + i * lp + (n - i) * l1p)
                   for i, lc in enumerate(log_comb))

    lo, hi = failures / n, 1.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if cdf(mid) > alpha:
            lo = mid
        else:
            hi = mid
    return hi


# -- exact oracle over every store box ---------------------------------------

def _scan_sharded(store, queries, k: int, served_ids=None, *,
                  impl: str = "auto"):
    """``_scan`` over a sharded store: each shard's exact candidates with
    their global ids (shard · stride + local), merged by θ with the lower
    global id first among ties, as the serving merge does; a served id is
    read from its own shard."""
    stride = store.stride
    served = (None if served_ids is None
              else np.asarray(served_ids, np.int64))
    ids_all, vals_all, got = [], [], None
    for s, shard in enumerate(store.shards):
        local = None
        if served is not None:
            mine = (served >= s * stride) & (served < (s + 1) * stride)
            local = np.where(mine, served - s * stride, -1)
        ids, vals, g = _scan(shard, queries, k, local, impl=impl)
        ids_all.append(np.where(np.isfinite(vals), ids + s * stride, -1))
        vals_all.append(vals)
        if g is not None:
            got = g if got is None else np.minimum(got, g)
    ids, vals = np.concatenate(ids_all, 1), np.concatenate(vals_all, 1)
    order = np.argsort(vals, axis=1, kind="stable")[:, :min(k, ids.shape[1])]
    return (np.take_along_axis(ids, order, 1),
            np.take_along_axis(vals, order, 1), got)


def _scan(store, queries, k: int, served_ids=None, *, impl: str = "auto"):
    """One pass of the exact oracle over ``store``'s slots: (exact ids,
    exact θ, served θ) as host arrays — (Q, min(k, capacity)) int64 ids of
    the k smallest θ in ascending order (the lower slot first among ties),
    their θ, and the (Q, k') θ of ``served_ids`` (inf where an id is −1,
    out of range or dead), read from the same distance rows; the last is
    None without ``served_ids``. θ = distance / ``store.d``. A sharded
    store's ids are global (``_scan_sharded``)."""
    if hasattr(store, "shards"):
        return _scan_sharded(store, queries, k, served_ids, impl=impl)
    dev = store.device
    if store.kind == "sparse":
        q_idx, q_val, _q_nnz = queries
        qs = densify(torch.as_tensor(q_idx, dtype=torch.int32, device=dev),
                     torch.as_tensor(q_val, dtype=torch.float32, device=dev),
                     store.d)
        chunk = SPARSE_CHUNK_ROWS
        dist = sparse_l1(qs, store.indices, store.values, store.d, impl=impl)
    else:
        qs = store.prepare_queries(queries, impl=impl)
        chunk = max(min(k, store.capacity),
                    DENSE_CHUNK_ELEMS // max(int(qs.shape[0]), 1))

        def dist(s, e):
            return kops.pairwise_dist(qs, store.x[s:e],
                                      metric=store.cfg.metric, impl=impl)
    served = (None if served_ids is None else
              torch.as_tensor(np.asarray(served_ids, np.int64), device=dev))
    ids, best, got = running_topk(dist, store.capacity, int(qs.shape[0]), k,
                                  chunk, device=dev, alive=store.alive,
                                  served=served)
    out = (ids, best / float(store.d))
    if got is not None:
        out += (got / float(store.d),)
    fetched = host_fetch(out)
    ids_h, vals = fetched[0], fetched[1].astype(np.float64)
    return (ids_h.astype(np.int64), vals,
            fetched[2].astype(np.float64) if got is not None else None)


def exact_topk(store, queries, k: int, *, impl: str = "auto"
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Ground-truth top-k over a dense, rotated or sparse store: (Q, k)
    slot ids (ascending exact θ) and the θ values, as host arrays. Dead
    slots never appear; ids are −1 (θ = inf) past the live count."""
    ids, vals, _ = _scan(store, queries, k, impl=impl)
    return _finish_topk(ids, vals, k)


def _finish_topk(ids: np.ndarray, vals: np.ndarray, k: int):
    ids = np.where(np.isfinite(vals), ids, -1)
    if ids.shape[1] < k:            # store smaller than k: pad with -1/inf
        pad = k - ids.shape[1]
        ids = np.concatenate(
            [ids, np.full((ids.shape[0], pad), -1, np.int64)], axis=1)
        vals = np.concatenate(
            [vals, np.full((vals.shape[0], pad), np.inf)], axis=1)
    return ids, vals


def exact_theta_of(store, queries, ids: np.ndarray, *,
                   impl: str = "auto") -> np.ndarray:
    """Exact θ of arbitrary (Q, k) slot ids; inf where an id is invalid
    (−1 / out of range) or tombstoned."""
    ids = np.asarray(ids, np.int64)
    return _scan(store, queries, ids.shape[1], ids, impl=impl)[2]


@dataclasses.dataclass(frozen=True)
class AuditCheck:
    """One oracle comparison: served ids vs the exact answer."""

    row_mismatch: np.ndarray     # (Q,)   bool — row violated the contract
    bad: np.ndarray              # (Q, k) bool — per served id
    served_theta: np.ndarray     # (Q, k) exact θ of the served ids
    exact_ids: np.ndarray        # (Q, k) oracle top-k (global ids)
    exact_vals: np.ndarray       # (Q, k) oracle θ (ascending)

    @property
    def mismatches(self) -> int:
        return int(self.row_mismatch.sum())


def check_topk(store, queries, served_ids, k: int, *,
               rtol: float = DEFAULT_RTOL,
               atol: float = DEFAULT_ATOL) -> AuditCheck:
    """Audit one served batch against the exact oracle. A served id passes
    iff it is a live slot whose exact θ is ≤ the k-th exact θ + tie
    tolerance; a row additionally fails on duplicated served ids (a
    duplicate means some true neighbor is missing). One oracle pass gives
    both sides of the comparison."""
    served_ids = np.asarray(served_ids, np.int64)[:, :k]
    ids, vals, served_theta = _scan(store, queries, k, served_ids)
    exact_ids, exact_vals = _finish_topk(ids, vals, k)
    kth = exact_vals[:, min(k, exact_vals.shape[1]) - 1]
    tol = atol + rtol * np.abs(np.where(np.isfinite(kth), kth, 0.0))
    bad = served_theta > (kth + tol)[:, None]
    row_bad = bad.any(axis=1)
    for i in range(served_ids.shape[0]):
        if len(np.unique(served_ids[i])) < served_ids.shape[1]:
            row_bad[i] = True
    return AuditCheck(row_mismatch=row_bad, bad=bad,
                      served_theta=served_theta,
                      exact_ids=exact_ids, exact_vals=exact_vals)


# -- flight recorder ---------------------------------------------------------

def _spec_doc(spec) -> dict:
    """JSON-safe QuerySpec view (arrays/objects are summarised, never
    serialised — the bundle's arrays.npz carries the data that matters)."""
    return {
        "k": spec.k, "mode": spec.mode, "impl": spec.impl,
        "delta": spec.delta, "max_rounds": spec.max_rounds,
        "eliminate": spec.eliminate, "warm_start": spec.warm_start,
        "cache": spec.cache, "use_tuned": spec.use_tuned,
        "deadline": repr(spec.deadline) if spec.deadline else None,
        "budget": repr(spec.budget) if spec.budget else None,
        "prior_hint": (None if spec.prior_hint is None
                       else f"array{tuple(spec.prior_hint.shape)}"),
    }


def ticket_events(obs, trace_id: str) -> List[dict]:
    """The ticket's trace events plus the race-session spans it joined
    (the ``plane.admit`` instant carries ``session=<sid>`` as the join
    key, DESIGN.md §8.3) — the bundle's why-did-this-certify evidence."""
    if obs is None:
        return []
    evs = obs.events.snapshot()
    mine = [e for e in evs if e.get("trace") == trace_id]
    sids = {e.get("attrs", {}).get("session") for e in mine}
    sids.discard(None)
    race = [e for e in evs if e.get("trace") in sids]
    return mine + race


class FlightRecorder:
    """Writes one replayable bundle directory per audit mismatch:
    ``bundle.json`` (metadata, spec, tuned config, mismatch rows, trace
    events) + ``arrays.npz`` (queries, served/exact ids and θ). Bundles
    are staged in a ``.tmp`` sibling and ``os.replace``d into place, so a
    reader never sees a half-written bundle (same atomic-write idiom as
    the tuned.json sidecar)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._seq = itertools.count()

    def record(self, *, check: AuditCheck, queries, served_ids, served_vals,
               k: int, delta: float, trace_id: str = "", tenant: str = "",
               store_epoch: int = 0, contract: str = "default",
               store_kind: str = "", metric: str = "", spec=None,
               tuned=None, obs=None) -> str:
        """Capture one mismatch. Returns the bundle directory path."""
        safe = "".join(ch if ch.isalnum() or ch in "._-" else "_"
                       for ch in (trace_id or "anon"))
        final = os.path.join(self.root,
                             f"audit-{next(self._seq):04d}-{safe}")
        while os.path.exists(final):       # seq restarts across processes
            final = os.path.join(self.root,
                                 f"audit-{next(self._seq):04d}-{safe}")
        tmp = final + f".tmp-{os.getpid()}"
        os.makedirs(tmp)
        arrays = {
            "served_ids": np.asarray(served_ids, np.int64),
            "served_vals": np.asarray(served_vals, np.float64),
            "served_theta": check.served_theta,
            "exact_ids": check.exact_ids,
            "exact_vals": check.exact_vals,
            "bad": check.bad,
        }
        if isinstance(queries, tuple):
            q_idx, q_val, q_nnz = (_host(a) for a in queries)
            arrays.update(q_idx=q_idx, q_val=q_val, q_nnz=q_nnz)
        else:
            arrays["queries"] = _host(queries)
        np.savez(os.path.join(tmp, BUNDLE_ARRAYS), **arrays)
        doc = {
            "schema_version": BUNDLE_SCHEMA,
            "trace_id": trace_id,
            "tenant": tenant,
            "store_epoch": int(store_epoch),
            "contract": contract,
            "k": int(k),
            "delta": float(delta),
            "store_kind": store_kind,
            "metric": metric,
            "sparse_queries": isinstance(queries, tuple),
            "mismatch_rows": np.nonzero(check.row_mismatch)[0].tolist(),
            "spec": _spec_doc(spec) if spec is not None else None,
            "tuned": (tuned.to_dict() if tuned is not None
                      and hasattr(tuned, "to_dict") else None),
            "written_at": time.time(),
            "events": ticket_events(obs, trace_id),
        }
        with open(os.path.join(tmp, BUNDLE_DOC), "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True, default=str)
        os.replace(tmp, final)
        return final


def load_bundle(path: str) -> Tuple[dict, dict]:
    """(doc, arrays) of one flight-recorder bundle directory."""
    with open(os.path.join(path, BUNDLE_DOC)) as f:
        doc = json.load(f)
    if doc.get("schema_version") != BUNDLE_SCHEMA:
        raise ValueError(
            f"bundle schema {doc.get('schema_version')!r} != "
            f"{BUNDLE_SCHEMA} (bundle {path})")
    with np.load(os.path.join(path, BUNDLE_ARRAYS)) as z:
        arrays = {k: z[k] for k in z.files}
    return doc, arrays


def replay_bundle(index, path: str) -> dict:
    """Re-run a bundle against a loaded ``repro_torch.api.Index``: recompute
    the exact oracle on the CURRENT store and re-check the recorded served
    ids. ``reproduced`` is True when the same rows mismatch again — on an
    index with the same content this is deterministic (the oracle has no
    randomness); on a mutated store ``epoch_match=False`` flags that the
    ground truth itself may have moved."""
    doc, arrays = load_bundle(path)
    queries = ((arrays["q_idx"], arrays["q_val"], arrays["q_nnz"])
               if doc["sparse_queries"] else arrays["queries"])
    check = check_topk(index.store, queries, arrays["served_ids"],
                       int(doc["k"]))
    now_rows = np.nonzero(check.row_mismatch)[0].tolist()
    recorded = list(doc["mismatch_rows"])
    return {
        "bundle": path,
        "schema_version": BUNDLE_SCHEMA,
        "reproduced": now_rows == recorded,
        "mismatch_rows_recorded": recorded,
        "mismatch_rows_now": now_rows,
        "exact_ids_match": bool(
            (check.exact_ids == arrays["exact_ids"]).all()),
        "store_epoch_recorded": doc["store_epoch"],
        "store_epoch_now": index.epoch,
        "epoch_match": doc["store_epoch"] == index.epoch,
        "delta": doc["delta"],
        "k": doc["k"],
        "trace_id": doc["trace_id"],
    }


# -- the shadow auditor ------------------------------------------------------

@dataclasses.dataclass
class _AuditItem:
    """One sampled terminal ticket, queued for off-path oracle work."""

    trace_id: str
    tenant: str
    store_epoch: int
    contract: str                 # "tuned" | "default"
    k: int
    delta: float
    queries: object               # (Q, d) dense or (q_idx, q_val, q_nnz)
    served_ids: np.ndarray        # (Q, k)
    served_vals: np.ndarray       # (Q, k)
    spec: object = None
    namespace: Optional[str] = None   # fleet namespace; None: the default

    @property
    def rows(self) -> int:
        return int(self.served_ids.shape[0])


@dataclasses.dataclass
class _KeyState:
    """Empirical error-rate estimator for one (namespace, tenant,
    store-epoch, contract) key: audited rows, observed δ-failures, the
    tightest δ any audited query promised."""

    sampled: int = 0
    mismatches: int = 0
    delta: float = 1.0

    def err_upper(self, confidence: float) -> float:
        return wilson_upper(self.mismatches, self.sampled, confidence)


class DeltaAuditor:
    """Shadow δ-auditor over one ``repro_torch.api.Index``, or, given a
    ``router`` (a ``repro_torch.fleet.Fleet``), over every namespace a
    fleet's plane serves.

    ``offer`` runs ON the serving path and must stay cheap: one RNG draw
    (``random.Random(seed)``, as the reference's, so one seed samples the
    same tickets in both packages), then host array copies into a bounded
    per-tenant reservoir (overflow drops the oldest pending item, counted —
    backpressure by forgetting audits, never by stalling serving).
    ``process``/``flush`` run the exact oracle OFF the critical path.
    Items whose store epoch fell behind a mutation are skipped (the ground
    truth they were served against no longer exists) and counted as
    ``stale_epoch``; items whose namespace was dropped count as
    ``unroutable``."""

    def __init__(self, index=None, *, router=None, rate: float, obs=None,
                 recorder: Optional[FlightRecorder] = None, seed: int = 0,
                 reservoir: int = 256, confidence: float = 0.95,
                 rtol: float = DEFAULT_RTOL, atol: float = DEFAULT_ATOL,
                 labels: Optional[dict] = None):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"audit rate must be in [0, 1], got {rate}")
        if reservoir < 1:
            raise ValueError(f"reservoir must be >= 1, got {reservoir}")
        if not 0.5 <= confidence < 1.0:
            raise ValueError(
                f"confidence must be in [0.5, 1), got {confidence}")
        if index is None and router is None:
            raise ValueError("DeltaAuditor needs an index, a router "
                             "(fleet), or both")
        self.index = index
        self.router = router
        self.rate = rate
        self.obs = obs
        self.recorder = recorder
        self.confidence = confidence
        self.rtol, self.atol = rtol, atol
        self._rng = random.Random(seed)
        self._labels = dict(labels or {})
        self._reservoir = reservoir
        self._pending: "collections.OrderedDict[str, collections.deque]" = \
            collections.OrderedDict()
        self._states: Dict[Tuple[str, str, int, str], _KeyState] = {}
        self.bundles: List[str] = []
        self.offered = 0              # terminal tickets seen
        self.sampled_tickets = 0      # tickets drawn into the reservoir
        self.dropped = 0              # items evicted by reservoir overflow
        self.skipped: Dict[str, int] = {r: 0 for r in _AUDIT_SKIP_REASONS}
        if obs is not None:
            reg = obs.registry
            self._c_dropped = reg.counter(
                "repro_audit_dropped_total",
                "sampled audits evicted by reservoir overflow",
                **self._labels)
            self._g_pending = reg.gauge(
                "repro_audit_pending",
                "audited rows waiting in the shadow reservoir",
                **self._labels)
            self._h_ms = reg.histogram(
                "repro_audit_ms", "oracle wall time per audited item (ms)",
                **self._labels)
        else:
            self._c_dropped = self._g_pending = self._h_ms = None

    # -- serving-path half ---------------------------------------------------

    def offer(self, *, trace_id: str, tenant: str, store_epoch: int,
              contract: str, k: int, delta: float, queries, served_ids,
              served_vals, spec=None,
              namespace: Optional[str] = None) -> bool:
        """Maybe sample one terminal ticket into the reservoir. Cheap by
        construction — a Bernoulli(rate) draw plus array copies; all
        oracle work waits for ``process``. Returns True iff sampled."""
        self.offered += 1
        if self._rng.random() >= self.rate:
            return False
        if contract not in ("tuned", "default"):
            raise ValueError(
                f"contract must be 'tuned' or 'default', got {contract!r}")
        if isinstance(queries, tuple):
            q = tuple(_host(a) for a in queries)
        else:
            q = _host(queries)
        item = _AuditItem(
            trace_id=trace_id, tenant=tenant, store_epoch=int(store_epoch),
            contract=contract, k=int(k), delta=float(delta), queries=q,
            served_ids=np.array(served_ids, np.int64),
            served_vals=np.array(served_vals), spec=spec,
            namespace=namespace)
        dq = self._pending.setdefault(tenant, collections.deque())
        if len(dq) >= self._reservoir:
            dq.popleft()
            self.dropped += 1
            self.skipped["reservoir_full"] += 1
            if self._c_dropped is not None:
                self._c_dropped.inc()
        dq.append(item)
        self.sampled_tickets += 1
        if self._g_pending is not None:
            self._g_pending.set(self.pending)
        return True

    def note_skip(self, reason: str) -> None:
        """Count a terminal ticket the plane chose not to audit (e.g. a
        partial deadline/budget result — only fully-certified answers
        claim the full 1-δ contract)."""
        self.skipped[reason] = self.skipped.get(reason, 0) + 1

    @property
    def pending(self) -> int:
        return sum(len(dq) for dq in self._pending.values())

    # -- off-path half -------------------------------------------------------

    def _pop_round_robin(self) -> Optional[_AuditItem]:
        for tenant in list(self._pending):
            dq = self._pending[tenant]
            if not dq:
                del self._pending[tenant]
                continue
            item = dq.popleft()
            self._pending.move_to_end(tenant)   # fairness across tenants
            if not dq:
                del self._pending[tenant]
            return item
        return None

    def _key_metrics(self, key):
        namespace, tenant, epoch, contract = key
        if self.obs is None:
            return None, None, None
        reg = self.obs.registry
        lbl = dict(self._labels, tenant=tenant, store_epoch=str(epoch),
                   contract=contract)
        if namespace:
            lbl["namespace"] = namespace
        return (reg.counter("repro_audit_sampled_total",
                            "query rows shadow-audited", **lbl),
                reg.counter("repro_audit_mismatch_total",
                            "audited rows that violated the 1-δ contract",
                            **lbl),
                reg.gauge("repro_audit_err_upper",
                          "Wilson upper confidence bound on the empirical "
                          "error rate (compare against δ)", **lbl))

    def _resolve_index(self, item: _AuditItem):
        """The index the item's ground truth lives in: the bound default
        for an un-namespaced item, the router's handle (reloaded when it
        was evicted) for a namespaced one; None when unroutable."""
        if item.namespace is None:
            return self.index
        if self.router is None:
            return None
        try:
            return self.router.resolve(item.namespace)
        except KeyError:
            return None                     # namespace dropped since

    def _audit(self, item: _AuditItem, index) -> bool:
        """Oracle one item against its resolved index. Returns True iff a
        mismatch was found."""
        t0 = time.perf_counter()
        check = check_topk(index.store, item.queries, item.served_ids,
                           item.k, rtol=self.rtol, atol=self.atol)
        if self._h_ms is not None:
            self._h_ms.observe((time.perf_counter() - t0) * 1e3)
        key = (item.namespace or "", item.tenant, item.store_epoch,
               item.contract)
        state = self._states.setdefault(key, _KeyState())
        state.sampled += item.rows
        state.mismatches += check.mismatches
        state.delta = min(state.delta, item.delta)
        c_sampled, c_mismatch, g_upper = self._key_metrics(key)
        if c_sampled is not None:
            c_sampled.inc(item.rows)
            if check.mismatches:
                c_mismatch.inc(check.mismatches)
            g_upper.set(state.err_upper(self.confidence))
        if check.mismatches == 0:
            if self.obs is not None:
                self.obs.tracer.instant(
                    "audit.pass", trace=item.trace_id, rows=item.rows,
                    store_epoch=item.store_epoch, contract=item.contract)
            return False
        bundle = None
        if self.recorder is not None:
            bundle = self.recorder.record(
                check=check, queries=item.queries,
                served_ids=item.served_ids, served_vals=item.served_vals,
                k=item.k, delta=item.delta, trace_id=item.trace_id,
                tenant=item.tenant, store_epoch=item.store_epoch,
                contract=item.contract, store_kind=index.kind,
                metric=index.cfg.metric, spec=item.spec,
                tuned=index.tuned, obs=self.obs)
            self.bundles.append(bundle)
        log.warning(
            "delta-audit MISMATCH (trace %s, tenant %s): %d/%d rows violate "
            "the 1-delta contract (delta=%g, store_epoch=%d, contract=%s)%s",
            item.trace_id, item.tenant, check.mismatches, item.rows,
            item.delta, item.store_epoch, item.contract,
            f" -> bundle {bundle}" if bundle else "")
        if self.obs is not None:
            self.obs.tracer.instant(
                "audit.mismatch", trace=item.trace_id,
                rows=item.rows, mismatches=check.mismatches,
                store_epoch=item.store_epoch, contract=item.contract,
                bundle=bundle or "")
        return True

    def process(self, limit: Optional[int] = None) -> int:
        """Run the oracle on up to ``limit`` pending items (None = all).
        Call this OFF the serving critical path — the plane does so only
        when no race group is active, or from an explicit flush. Returns
        the number of items processed (audited or skipped)."""
        done = 0
        while limit is None or done < limit:
            item = self._pop_round_robin()
            if item is None:
                break
            done += 1
            index = self._resolve_index(item)
            if index is None:
                self.skipped["unroutable"] += 1
                if self.obs is not None:
                    self.obs.tracer.instant(
                        "audit.skip", trace=item.trace_id,
                        reason="unroutable",
                        namespace=item.namespace or "")
                continue
            if item.store_epoch != index.epoch:
                self.skipped["stale_epoch"] += 1
                if self.obs is not None:
                    self.obs.tracer.instant(
                        "audit.skip", trace=item.trace_id,
                        reason="stale_epoch",
                        item_epoch=item.store_epoch,
                        index_epoch=index.epoch)
                continue
            self._audit(item, index)
        if self._g_pending is not None:
            self._g_pending.set(self.pending)
        return done

    def flush(self) -> int:
        """Drain the whole reservoir through the oracle."""
        return self.process(None)

    # -- reporting -----------------------------------------------------------

    @property
    def sampled_rows(self) -> int:
        return sum(s.sampled for s in self._states.values())

    @property
    def mismatch_rows(self) -> int:
        return sum(s.mismatches for s in self._states.values())

    def err_upper(self) -> float:
        """Global Wilson upper bound over every audited row."""
        return wilson_upper(self.mismatch_rows, self.sampled_rows,
                            self.confidence)

    def summary(self) -> dict:
        """JSON-safe estimator state (the health snapshot's audit section):
        per-key counts, error rates, upper bounds, and whether each key's
        bound still clears its effective δ."""
        keys = []
        for (ns, tenant, epoch, contract), st in sorted(
                self._states.items()):
            upper = st.err_upper(self.confidence)
            keys.append({
                "namespace": ns,
                "tenant": tenant,
                "store_epoch": epoch,
                "contract": contract,
                "sampled": st.sampled,
                "mismatches": st.mismatches,
                "err_rate": (st.mismatches / st.sampled
                             if st.sampled else 0.0),
                "err_upper": upper,
                "delta": st.delta,
                # the bound needs ~log(1-conf)/log(1-δ) clean rows before
                # it can dip under δ — until then "not yet violated" is
                # the honest reading, so gate on observed failures
                "violated": st.mismatches > 0 and upper > st.delta,
            })
        return {
            "rate": self.rate,
            "confidence": self.confidence,
            "method": "wilson",
            "offered": self.offered,
            "sampled_tickets": self.sampled_tickets,
            "sampled_rows": self.sampled_rows,
            "mismatch_rows": self.mismatch_rows,
            "err_upper": self.err_upper(),
            "pending": self.pending,
            "dropped": self.dropped,
            "skipped": dict(self.skipped),
            "bundles": list(self.bundles),
            "keys": keys,
        }
