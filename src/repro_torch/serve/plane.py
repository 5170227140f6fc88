"""repro_torch.serve.plane — the async request plane over one ``Index``
handle or a whole namespace fleet (DESIGN.md §7, §11), the reference's
scheduler on the port's sessions.

``Index.query`` is a blocking, run-to-certification batch call: one hard
query (or one greedy caller) gates everyone sharing the engine. The plane
replaces that surface with admission → deadline-aware micro-batching →
anytime streaming:

  * ``submit(queries, spec) -> Ticket``: admission control. Exact-repeat
    rows are served from the handle's query LRU at submit (zero cost); the
    rest waits in a bounded per-tenant queue — beyond the bound the ticket
    is shed with a reason instead of queueing without bound.
  * Between scheduler epochs, admitted requests from many tickets are
    coalesced into pow2 race batches (join at an epoch boundary) driven
    through ``Index.race`` one epoch at a time; a ticket leaves its group
    the moment it terminates and its rows are retired, so the survivors
    inherit the pull budget. The pad rows of a batch are retired at once.
  * ``poll/stream(ticket) -> AnytimeResult``: the current partial top-k
    with CI radii and the certified-prefix length. A request terminates on
    a wall-clock ``Deadline``, an ``EffortBudget`` or full certification,
    whichever comes first, always with its certified prefix.
  * Fairness: admission round-robins across tenants. A full group table
    still gives deadline tickets one overflow slot.
  * Mutation fence: every group is pinned to the store epoch it started
    against. When a mutation bumps ``Index.epoch`` mid-race, in-flight
    groups either complete against the old (immutable) store or are
    re-admitted against the new one (``PlaneConfig.on_mutation``); a result
    never mixes epochs.

The scheduler is cooperative (``step()`` runs one epoch across all active
groups); ``drain()``, ``stream()`` and the blocking ``query()`` shim drive
it. ``stats`` extends the handle's ``ServeStats`` with the queue and latency
telemetry that ``serve.scale`` policies consume.

A race that cannot launch sheds its tickets with a ``rejected: …`` reason
(never orphaned). With ``PlaneConfig.audit_rate > 0`` a shadow δ-auditor
(``obs/audit.py``) samples fully certified terminal tickets at ``_finish``
(an RNG draw and host copies) and re-answers them with the exact oracle
only on idle steps or through ``audit_step``/``audit_flush`` — never inside
a serving epoch.

Namespace routing (DESIGN.md §11): with ``router=`` (a
``repro_torch.fleet.Fleet``) tickets carry a ``namespace`` label.
``submit(..., namespace="users")`` resolves the backing ``Index`` through
the router at admission (which reloads an evicted namespace), admission
fairness, shedding and the per-namespace quota key on ``(tenant,
namespace)``, race groups never mix namespaces and each fences against its
own index, and per-namespace counters ride the metrics registry under a
``namespace`` label (``repro_plane_ns_*``). ``RequestPlane(index)`` behaves
as before.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.api import Index, QuerySpec, ServeStats
from repro_torch.api.cache import QueryCache
from repro_torch.api.stream import (DONE, QUEUED, R_BUDGET, R_CERTIFIED,
                                    R_DEADLINE, R_SHED, RACING, SHED,
                                    AnytimeResult, Ticket, percentile)
from repro_torch.core.datasets import next_pow2
from repro_torch.obs import get_obs
from repro_torch.utils.hostsync import host_fetch

log = logging.getLogger("repro_torch.serve.plane")

ON_MUTATION = ("complete", "readmit")

#: monotone plane sequence — the ``plane="pN"`` metric label and trace-id
#: prefix that keep multiple planes apart in one shared obs context
_plane_seq = itertools.count()


@dataclasses.dataclass(frozen=True)
class PlaneConfig:
    """Scheduler knobs, the reference's, with its defaults."""

    max_queue: int = 64            # pending tickets per tenant before shed
    max_group_queries: int = 64    # query rows coalesced per race batch
    max_active_groups: int = 4     # concurrent race groups
    on_mutation: str = "complete"  # complete | readmit in-flight groups
    chunk_rounds: int = 0          # sparse rounds per epoch (0 = heuristic)
    latency_window: int = 4096     # terminal latencies kept for percentiles
    # -- shadow δ-audit (DESIGN.md §10) -----------------------------------
    audit_rate: float = 0.0        # fraction of terminal tickets audited
    audit_reservoir: int = 256     # pending audits per tenant before drop
    audit_dir: Optional[str] = None   # flight-recorder bundle directory
    audit_seed: int = 0            # sampling RNG seed (reproducible audits)

    def __post_init__(self):
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_group_queries < 1:
            raise ValueError("max_group_queries must be >= 1, got "
                             f"{self.max_group_queries}")
        if self.max_active_groups < 1:
            raise ValueError("max_active_groups must be >= 1, got "
                             f"{self.max_active_groups} (0 would make "
                             "blocking queries spin forever unadmitted)")
        if self.on_mutation not in ON_MUTATION:
            raise ValueError(f"unknown on_mutation {self.on_mutation!r} "
                             f"(want one of {ON_MUTATION})")
        if self.latency_window < 1:
            raise ValueError("latency_window must be >= 1, got "
                             f"{self.latency_window}")
        if not 0.0 <= self.audit_rate <= 1.0:
            raise ValueError("audit_rate must be in [0, 1], got "
                             f"{self.audit_rate}")
        if self.audit_reservoir < 1:
            raise ValueError("audit_reservoir must be >= 1, got "
                             f"{self.audit_reservoir}")


class _Member(object):
    """One ticket's miss rows inside a race group."""

    def __init__(self, entry: "_Entry", rows: List[int], offset: int):
        self.entry = entry
        self.rows = rows              # ticket-row indices raced here
        self.offset = offset          # first group row of this member


class _Entry(object):
    """Plane-internal ticket state (the public handle is ``.ticket``)."""

    def __init__(self, ticket: Ticket, queries, rng, spec: QuerySpec,
                 is_sparse: bool, index: Index,
                 namespace: Optional[str] = None):
        self.ticket = ticket
        self.queries = queries        # host (numpy) rows
        self.rng = rng
        self.spec = spec
        self.is_sparse = is_sparse
        self.index = index            # the backing handle, resolved at submit
        self.namespace = namespace    # routing label (None: default index)
        Q = ticket.n_queries
        self.cached_rows: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.cache_epoch = -1         # store epoch the cached rows are from
        # frozen certified prefix per row: once an entry certifies it is
        # never revoked nor reordered (anytime monotonicity by construction)
        self.cert_ids: List[List[int]] = [[] for _ in range(Q)]
        self.cert_vals: List[List[float]] = [[] for _ in range(Q)]
        self.group: Optional["_Group"] = None
        self.member: Optional[_Member] = None
        self.coord_ops = np.zeros((Q,), np.float64)
        self.rounds = np.zeros((Q,), np.int64)
        self.epoch = 0                # store epoch the result is valid for
        self.queue_span = None        # open plane.queue span (obs tracer)

    @property
    def miss_rows(self) -> List[int]:
        return [i for i in range(self.ticket.n_queries)
                if i not in self.cached_rows]


class _Group(object):
    """One coalesced race batch: a RaceSession plus its member tickets,
    pinned to one backing index (groups never mix namespaces) and the
    store epoch it launched against."""

    def __init__(self, session, members: List[_Member], store_epoch: int,
                 index: Index):
        self.session = session
        self.members = members
        self.store_epoch = store_epoch
        self.index = index


class RequestPlane:
    """The async request plane over one ``repro_torch.api.Index`` handle,
    or, with ``router=`` (a ``repro_torch.fleet.Fleet``), over every
    namespace the router serves, through one shared scheduler."""

    def __init__(self, index: Optional[Index] = None,
                 config: Optional[PlaneConfig] = None,
                 *, obs=None, router=None):
        if index is None and router is None:
            raise ValueError("RequestPlane needs an index, a router "
                             "(repro_torch.fleet.Fleet), or both")
        self.index = index
        self.router = router
        if router is not None and hasattr(router, "attach_plane"):
            router.attach_plane(self)   # wires the eviction in-flight guard
        self.config = config if config is not None else PlaneConfig()
        self.obs = obs if obs is not None else get_obs()
        self.plane_id = f"p{next(_plane_seq)}"
        # admission queues keyed by (tenant, namespace), as the reference's
        self._queues: "collections.OrderedDict[tuple, collections.deque]" = \
            collections.OrderedDict()
        self._groups: List[_Group] = []
        self._next_id = 0
        self._entries: Dict[int, _Entry] = {}
        self._latencies: collections.deque = collections.deque(
            maxlen=self.config.latency_window)
        # the metrics registry is the single source of truth for the plane
        # counters (DESIGN.md §8.2): ``stats`` reads the same series
        reg = self.obs.registry
        lbl = {"plane": self.plane_id}
        self._submitted = reg.counter(
            "repro_plane_submitted_total", "tickets submitted", **lbl)
        self._admitted = reg.counter(
            "repro_plane_admitted_total",
            "tickets admitted into a race group", **lbl)
        self._completed = reg.counter(
            "repro_plane_completed_total",
            "tickets finished (any terminal reason)", **lbl)
        self._shed = reg.counter(
            "repro_plane_shed_total",
            "tickets shed at admission (backpressure)", **lbl)
        self._deadline_exits = reg.counter(
            "repro_plane_deadline_exits_total",
            "tickets terminated at the wall-clock deadline", **lbl)
        self._budget_exits = reg.counter(
            "repro_plane_budget_exits_total",
            "tickets terminated at the effort budget", **lbl)
        self._readmitted = reg.counter(
            "repro_plane_readmitted_total",
            "tickets re-raced after a mutation fence", **lbl)
        self._epochs = reg.counter(
            "repro_plane_epochs_total", "scheduler epochs run", **lbl)
        self._g_queue = reg.gauge(
            "repro_plane_queue_depth", "tickets waiting for admission",
            **lbl)
        self._g_active = reg.gauge(
            "repro_plane_active", "tickets currently racing", **lbl)
        self._h_latency = reg.histogram(
            "repro_plane_latency_ms", "terminal ticket latency (ms)", **lbl)
        self._h_epoch = reg.histogram(
            "repro_plane_epoch_ms", "wall time of one scheduler epoch (ms)",
            **lbl)
        # shadow δ-auditor (DESIGN.md §10): sampling happens at _finish
        # (cheap — one RNG draw + host copies into a bounded reservoir);
        # the exact oracle runs OFF the critical path, only from
        # audit_step()/audit_flush() or an idle step()
        self.auditor = None
        if self.config.audit_rate > 0.0:
            from repro_torch.obs.audit import DeltaAuditor, FlightRecorder
            recorder = (FlightRecorder(self.config.audit_dir)
                        if self.config.audit_dir else None)
            self.auditor = DeltaAuditor(
                index, router=router, rate=self.config.audit_rate,
                obs=self.obs, recorder=recorder, seed=self.config.audit_seed,
                reservoir=self.config.audit_reservoir, labels=lbl)

    # -- routing -------------------------------------------------------------

    def _resolve(self, namespace: Optional[str]) -> Index:
        """The backing ``Index`` of a namespace label: ``None`` routes to
        the plane's default index, a label goes through the router (which
        reloads an evicted namespace and bumps its LRU recency)."""
        if namespace is None:
            if self.index is None:
                raise ValueError(
                    "this plane routes by namespace (router-only) — "
                    "pass namespace= to submit()")
            return self.index
        if self.router is None:
            raise ValueError(
                f"namespace={namespace!r} submitted to a plane without a "
                "router — construct RequestPlane(router=fleet) to serve "
                "namespaces")
        return self.router.resolve(namespace)

    def _qkey(self, entry: _Entry) -> tuple:
        return (entry.ticket.tenant, entry.namespace)

    def _max_queue(self, namespace: Optional[str]) -> int:
        """Per-namespace admission bound: the router's override when it has
        one, else ``PlaneConfig.max_queue``."""
        if namespace is not None and self.router is not None:
            mq = self.router.namespace_max_queue(namespace)
            if mq is not None:
                return mq
        return self.config.max_queue

    def _ns_metrics(self, namespace: str):
        """Per-namespace series, registered on first use (a registry lookup
        returns the same series again)."""
        reg = self.obs.registry
        lbl = {"plane": self.plane_id, "namespace": namespace}
        return (reg.counter("repro_plane_ns_submitted_total",
                            "tickets submitted per namespace", **lbl),
                reg.counter("repro_plane_ns_completed_total",
                            "tickets finished per namespace", **lbl),
                reg.gauge("repro_plane_ns_queue_depth",
                          "tickets waiting for admission per namespace",
                          **lbl))

    def namespace_load(self) -> Dict[str, int]:
        """Live tickets (queued and racing) per namespace: the fleet's
        eviction guard never takes a namespace with work in flight."""
        load: Dict[str, int] = {}
        for (_t, ns), q in self._queues.items():
            if ns is not None and q:
                load[ns] = load.get(ns, 0) + len(q)
        for g in self._groups:
            for m in g.members:
                ns = m.entry.namespace
                if ns is not None:
                    load[ns] = load.get(ns, 0) + 1
        return load

    # -- admission -----------------------------------------------------------

    def submit(self, queries, spec: Optional[QuerySpec] = None, *,
               tenant: str = "default", namespace: Optional[str] = None,
               rng=None, **overrides) -> Ticket:
        """Admit a query batch. Returns a ``Ticket`` at once: poll or stream
        it, or let ``drain()`` run the plane to quiescence. Keyword
        overrides (``deadline=``, ``budget=``, ``k=``, …) refine the spec
        exactly like ``Index.query``. Queries may be host arrays or tensors;
        the plane keeps them as host (numpy) rows, which the query cache
        keys. ``namespace`` routes the ticket to a fleet namespace (needs a
        router); admission then keys on ``(tenant, namespace)``."""
        if spec is None:
            spec = QuerySpec(**overrides)
        elif overrides:
            spec = dataclasses.replace(spec, **overrides)
        index = self._resolve(namespace)
        is_sparse = isinstance(queries, tuple)
        # reject unraceable submissions HERE, not at group launch: a bad
        # spec admitted into a coalesced bucket would abort co-admitted
        # tickets' admission mid-step
        kind = index.kind
        if is_sparse != (kind == "sparse"):
            raise ValueError(
                f"a {kind!r} index takes "
                f"{'(q_idx, q_val, q_nnz) triplet' if kind == 'sparse' else 'dense (Q, d) array'} "
                "queries")
        if spec.mode == "fused" and kind == "sparse":
            raise ValueError("the fused epoch driver pulls corpus blocks — "
                             "sparse boxes race on the per-round driver")
        if spec.mode == "rounds" and kind != "sparse":
            raise ValueError(
                "anytime sessions drive dense/rotated boxes through the "
                "epoch-fused driver; mode='rounds' is blocking-query only")
        if spec.bind(index.cfg).k > index.n_live:
            raise ValueError(
                f"k={spec.bind(index.cfg).k} exceeds the index's "
                f"{index.n_live} live slots")
        if is_sparse:
            queries = tuple(_host(a) for a in queries)
            Q = queries[0].shape[0]
        else:
            queries = _host(queries).astype(np.float32, copy=False)
            Q = queries.shape[0]
        now = time.monotonic()
        ticket = Ticket(id=self._next_id, tenant=tenant, n_queries=Q,
                        spec=spec, submitted_at=now,
                        trace_id=f"{self.plane_id}.t{self._next_id}")
        self._next_id += 1
        self._submitted.inc()
        nsattr = {} if namespace is None else {"namespace": namespace}
        if namespace is not None:
            self._ns_metrics(namespace)[0].inc()
        tracer = self.obs.tracer
        tracer.instant("plane.submit", trace=ticket.trace_id,
                       tenant=tenant, n_queries=Q, **nsattr)
        entry = _Entry(ticket, queries, rng, spec, is_sparse, index,
                       namespace)
        self._entries[ticket.id] = entry

        q = self._queues.setdefault(self._qkey(entry), collections.deque())
        entry.epoch = index.epoch
        self._consult_cache(entry)
        if not entry.miss_rows:          # fully served from the query LRU —
            self._finish(entry, R_CERTIFIED)   # free, never needs a slot
            return ticket
        if len(q) >= self._max_queue(namespace):
            self._shed.inc()
            ticket.status = SHED
            ticket.reason = "queue_full"
            ticket.finished_at = now
            ticket.result = self._empty_result(entry, R_SHED)
            self._entries.pop(ticket.id, None)
            tracer.instant("plane.shed", trace=ticket.trace_id,
                           reason="queue_full", tenant=tenant, **nsattr)
            return ticket
        entry.queue_span = tracer.start("plane.queue",
                                        trace=ticket.trace_id, tenant=tenant,
                                        **nsattr)
        q.append(entry)
        return ticket

    def _consult_cache(self, entry: _Entry) -> None:
        """Serve exact-repeat rows from the handle's LRU at submit time (the
        ``Index.query`` contract; the shared cache keeps both surfaces
        coherent, and its keys carry the namespace, so two namespaces never
        exchange rows). Near-repeat CI priors are seeded later, at group launch —
        a ticket shed by backpressure must not pay them."""
        index = entry.index
        cache = index._cache
        spec = entry.spec
        entry.cache_epoch = index.epoch
        if (cache is None or entry.is_sparse or not spec.cacheable
                or spec.cache == "bypass"):
            return
        hid = entry.queries
        for i in range(entry.ticket.n_queries):
            got = (None if spec.cache == "refresh"
                   else cache.get(QueryCache.key(hid[i], index._cache_ns)))
            if got is not None:
                entry.cached_rows[i] = (np.asarray(got[0]).copy(),
                                        np.asarray(got[1]).copy())

    # -- scheduling ----------------------------------------------------------

    def _race_key(self, entry: _Entry):
        # use_tuned picks the config the group races: a ticket that opts
        # out of the tuning never rides a tuned group (nor the reverse);
        # id(entry.index) pins a group to one backing handle, so groups
        # never mix namespaces (or a handle before and after a reload)
        s = entry.spec
        return (s.k, s.mode, s.impl, s.delta, s.max_rounds, s.eliminate,
                s.warm_start, s.use_tuned, entry.is_sparse, entry.namespace,
                id(entry.index))

    def _admission_key(self, entry: _Entry):
        """Deadline-aware admission order: earliest absolute deadline
        first, unbounded traffic after, FIFO within a class."""
        dl = entry.spec.deadline
        expiry = (entry.ticket.submitted_at + dl.ms / 1e3 if dl is not None
                  else float("inf"))
        return (expiry, entry.ticket.submitted_at)

    def _pop_ready(self, entry: _Entry, now: float) -> bool:
        """Post-pop admission checks: expire a late ticket, re-consult
        stale cached rows (a mutation moved the epoch — a result never
        mixes store epochs). True iff the entry still needs a race."""
        if self._expire_if_late(entry, now):
            return False
        if entry.cache_epoch != entry.index.epoch:
            entry.cached_rows.clear()
            self._consult_cache(entry)
            if not entry.miss_rows:
                entry.epoch = entry.index.epoch
                self._finish(entry, R_CERTIFIED)
                return False
        return True

    def _pick_deadline_overflow(self, now: float) -> List[_Entry]:
        """EDF scan of the whole queues (not just heads — a deadline ticket
        may sit behind its own tenant's unbounded one) for the overflow
        slot's batch."""
        cands = sorted(
            ((self._admission_key(e), key, e)
             for key, q in self._queues.items() for e in q
             if e.spec.deadline is not None),
            key=lambda c: c[0])
        picked, rows = [], 0
        for _, qkey, entry in cands:
            if picked and (rows + len(entry.miss_rows)
                           > self.config.max_group_queries):
                continue
            self._queues[qkey].remove(entry)
            if not self._pop_ready(entry, now):
                continue
            picked.append(entry)
            rows += len(entry.miss_rows)
            if rows >= self.config.max_group_queries:
                break
        return picked

    def _admit_groups(self, now: float) -> None:
        """Join at an epoch boundary: pop pending tickets across tenant
        queues — at most one per queue per round (fairness against a heavy
        tenant), earliest deadline first within each round — bucket them by
        race compatibility, and launch each bucket as one pow2-coalesced
        race group."""
        budget = (self.config.max_active_groups - len(self._groups))
        if budget <= 0:
            # all group slots busy with long races: deadline-bounded
            # arrivals still get ONE overflow slot (never more — a huge
            # deadline is indistinguishable from run-to-certification)
            if (len(self._groups) <= self.config.max_active_groups
                    and any(e.spec.deadline is not None
                            for q in self._queues.values() for e in q)):
                picked = self._pick_deadline_overflow(now)
                budget = 1
            else:
                return
        else:
            picked = []
            rows = 0
            while rows < self.config.max_group_queries:
                progressed = False
                heads = sorted(
                    (key for key, q in self._queues.items() if q),
                    key=lambda key: self._admission_key(
                        self._queues[key][0]))
                for qkey in heads:
                    q = self._queues[qkey]
                    if not q:
                        continue
                    entry = q[0]
                    need = len(entry.miss_rows)
                    if picked and rows + need > self.config.max_group_queries:
                        continue
                    q.popleft()
                    progressed = True
                    if not self._pop_ready(entry, now):
                        continue
                    picked.append(entry)
                    rows += len(entry.miss_rows)
                    if rows >= self.config.max_group_queries:
                        break
                if not progressed:
                    break
        buckets: "collections.OrderedDict[tuple, List[_Entry]]" = \
            collections.OrderedDict()
        for entry in picked:
            buckets.setdefault(self._race_key(entry), []).append(entry)
        leftover: List[_Entry] = []
        for bucket in buckets.values():
            if budget <= 0:              # out of group slots this pass
                leftover.extend(bucket)
                continue
            self._launch_group(bucket, now)
            budget -= 1
        # requeue unlaunched entries in ORIGINAL pick order (front of their
        # tenant queues) so FIFO/EDF-within-class admission order survives
        for entry in reversed([e for e in picked if e in leftover]):
            self._queues.setdefault(
                self._qkey(entry), collections.deque()).appendleft(entry)

    def _launch_group(self, entries: List[_Entry], now: float) -> None:
        index = entries[0].index
        members: List[_Member] = []
        parts, hints, offset = [], [], 0
        for entry in entries:
            rows = entry.miss_rows
            members.append(_Member(entry, rows, offset))
            if entry.is_sparse:
                parts.append(tuple(a[rows] for a in entry.queries))
            else:
                parts.append(entry.queries[rows])
            # near-repeat warm starts: seeded per miss row from the LRU's
            # cosine neighbours (the Index.query contract), paid only for
            # tickets that actually race
            hint = None
            if (not entry.is_sparse and entry.spec.cacheable
                    and entry.spec.cache != "bypass"):
                hint = index._seeded_priors(entry.queries, rows)
            hints.append(hint)
            offset += len(rows)
        is_sparse = entries[0].is_sparse
        batch = (_concat_sparse(parts) if is_sparse
                 else np.concatenate(parts, axis=0))
        prior_hint = None
        if any(h is not None for h in hints):
            base = np.asarray(host_fetch(index.store.prior_var), np.float32)
            priors = []
            for member, hint in zip(members, hints):
                priors.extend([base] * len(member.rows) if hint is None
                              else list(hint))
            prior_hint = np.stack(priors)
        # the draws' shape (Q, B, T) depends on the padded Q: pad as the
        # reference does
        pad = next_pow2(offset) - offset
        if pad:
            if is_sparse:
                batch = tuple(np.concatenate(
                    [a, np.repeat(a[:1], pad, 0)], 0) for a in batch)
            else:
                batch = np.concatenate(
                    [batch, np.repeat(batch[:1], pad, 0)], 0)
            if prior_hint is not None:
                prior_hint = np.concatenate(
                    [prior_hint, np.repeat(prior_hint[:1], pad, 0)], 0)
        spec = dataclasses.replace(entries[0].spec, prior_hint=prior_hint,
                                   deadline=None, budget=None)
        rng = next((e.rng for e in entries if e.rng is not None), None)
        # the group's tightest remaining wall budget (DESIGN.md §9.7)
        deadline_ms = None
        for entry in entries:
            dl = entry.spec.deadline
            if dl is None:
                continue
            left = (entry.ticket.submitted_at + dl.ms / 1e3 - now) * 1e3
            deadline_ms = left if deadline_ms is None \
                else min(deadline_ms, left)
        if deadline_ms is not None:
            deadline_ms = max(deadline_ms, 0.0)
        try:
            session = index.race(batch, rng, spec=spec,
                                 raced_queries=offset,
                                 chunk_rounds=self.config.chunk_rounds,
                                 obs=self.obs, deadline_ms=deadline_ms)
        except Exception as e:  # noqa: BLE001 — never orphan the bucket
            log.warning("plane %s: race launch rejected (%s): shedding %d "
                        "ticket(s) %s", self.plane_id, e, len(entries),
                        ",".join(e_.ticket.trace_id or "" for e_ in entries))
            for entry in entries:
                self._shed.inc()
                t = entry.ticket
                t.status = SHED
                t.reason = f"rejected: {e}"
                t.finished_at = time.monotonic()
                t.result = self._empty_result(entry, R_SHED)
                self._entries.pop(t.id, None)
                if entry.queue_span is not None:
                    entry.queue_span.end(outcome="shed")
                    entry.queue_span = None
                self.obs.tracer.instant("plane.shed", trace=t.trace_id,
                                        reason=t.reason)
            return
        if pad:
            # pow2 pad rows belong to no ticket: retire them at once so
            # they neither race nor dilute the adaptive pull reallocation
            session.retire(np.arange(session.Q) >= offset)
        group = _Group(session, members, index.epoch, index)
        for member in members:
            entry = member.entry
            entry.group = group
            entry.member = member
            entry.epoch = group.store_epoch
            t = entry.ticket
            t.status = RACING
            if t.admitted_at is None:
                t.admitted_at = now
                self._admitted.inc()
            if entry.queue_span is not None:
                entry.queue_span.end(session=session.sid)
                entry.queue_span = None
            # the admit instant is the ticket ↔ session join key: the
            # session's race.epoch spans record under session.sid
            nsattr = ({} if entry.namespace is None
                      else {"namespace": entry.namespace})
            self.obs.tracer.instant(
                "plane.admit", trace=t.trace_id, session=session.sid,
                rows=len(member.rows), store_epoch=group.store_epoch,
                **nsattr)
        self._groups.append(group)

    def _fence_groups(self) -> None:
        """Mutation fence: a group whose store epoch fell behind either
        completes against its (immutable) old store or is re-admitted."""
        if self.config.on_mutation != "readmit":
            return
        for group in [g for g in self._groups
                      if g.store_epoch != g.index.epoch]:
            epoch = group.index.epoch
            self._groups.remove(group)
            # the epochs paid against the old store are real load: keep
            # them in the per-shard telemetry
            group.index._record_session_telemetry(group.session)
            for member in group.members:
                entry = member.entry
                if entry.ticket.terminal:
                    continue
                # discard partial state computed against the dead epoch —
                # certified prefixes must never mix store epochs
                for i in member.rows:
                    entry.cert_ids[i] = []
                    entry.cert_vals[i] = []
                entry.cached_rows.clear()
                entry.group = entry.member = None
                entry.ticket.status = QUEUED
                self._readmitted.inc()
                self.obs.tracer.instant(
                    "plane.readmit", trace=entry.ticket.trace_id,
                    from_epoch=group.store_epoch, to_epoch=epoch)
                self._consult_cache(entry)
                if not entry.miss_rows:
                    entry.epoch = epoch
                    self._finish(entry, R_CERTIFIED)
                    continue
                entry.queue_span = self.obs.tracer.start(
                    "plane.queue", trace=entry.ticket.trace_id,
                    tenant=entry.ticket.tenant, readmit=True)
                self._queues.setdefault(
                    self._qkey(entry),
                    collections.deque()).appendleft(entry)

    def _harvest(self, group: _Group, *, count_epoch: bool) -> None:
        """Finish every member whose terminal condition holds against the
        group's current snapshot, retiring their rows so survivors inherit
        the pull budget. Called before and after each group epoch — the
        pre-step pass lets a deadline expire at the boundary the ticket is
        already standing on instead of paying one more epoch."""
        now = time.monotonic()
        snap = group.session.snapshot
        retire_rows = []
        for member in list(group.members):
            entry = member.entry
            if count_epoch:
                entry.ticket.epochs += 1
                self._ingest(entry, member, snap, group.store_epoch)
                self._trace_ticket_epoch(entry, member, group, snap)
            reason = self._terminal_reason(entry, member, snap, now)
            if reason is not None:
                self._finish(entry, reason)
                group.members.remove(member)
                if reason != R_CERTIFIED:
                    retire_rows.extend(
                        range(member.offset,
                              member.offset + len(member.rows)))
        if retire_rows:
            mask = np.zeros((group.session.Q,), bool)
            mask[retire_rows] = True
            group.session.retire(mask)
        if not group.members:
            group.index._record_session_telemetry(group.session)
            self._groups.remove(group)

    def _trace_ticket_epoch(self, entry: _Entry, member: _Member,
                            group: _Group, snap) -> None:
        """Per-ticket race-epoch event: the ticket's own worst uncertified
        CI (its member rows only) plus the session's epoch telemetry —
        joinable with the ``race.epoch`` span via ``session``."""
        tracer = self.obs.tracer
        if not tracer.enabled:
            return
        rows = snap.ci[member.offset:member.offset + len(member.rows)]
        worst = float(np.where(np.isfinite(rows), rows,
                               0.0).max(initial=0.0))
        cert = sum(len(ids) for ids in entry.cert_ids)
        info = group.session.last_epoch or {}
        attrs = {k: info[k] for k in
                 ("coord_ops", "rounds", "width", "n_surv", "R")
                 if k in info}
        tracer.instant("ticket.epoch", trace=entry.ticket.trace_id,
                       session=group.session.sid,
                       epoch=entry.ticket.epochs, worst_ci=worst,
                       certified=cert, store_epoch=group.store_epoch,
                       **attrs)

    def step(self) -> int:
        """One scheduler epoch: fence, admit, advance every active group by
        one epoch, harvest terminals. Returns tickets still in flight."""
        t0 = time.perf_counter()
        now = time.monotonic()
        self._fence_groups()
        self._admit_groups(now)
        # a TRUE idle pass: the epoch began with nothing racing and nothing
        # queued — only such passes may do shadow-audit work below, so the
        # step that *finishes* the last ticket (drain's final iteration)
        # never pays the oracle either
        idle_pass = not self._groups and not self._queues
        if self._groups:
            self._epochs.inc()
        for group in list(self._groups):
            self._harvest(group, count_epoch=False)   # pre-step expiries
            if group not in self._groups:
                continue
            group.session.step()
            self._harvest(group, count_epoch=True)
        # expire queued tickets whose deadline passed while waiting
        now = time.monotonic()
        for q in self._queues.values():
            for entry in [e for e in q if self._deadline_passed(e, now)]:
                q.remove(entry)
                entry.epoch = entry.index.epoch
                self._finish(entry, R_DEADLINE)
        # drop drained queues: distinct (tenant, namespace) pairs must not
        # grow the admission scan (or stats) without bound on a long plane
        for key in [key for key, q in self._queues.items() if not q]:
            del self._queues[key]
        if self._groups or self.active:
            self._h_epoch.observe((time.perf_counter() - t0) * 1e3)
        self._g_queue.set(sum(len(q) for q in self._queues.values()))
        self._g_active.set(sum(len(g.members) for g in self._groups))
        for ns, depth in self.ns_queue_depth().items():
            self._ns_metrics(ns)[2].set(depth)
        # shadow audits use IDLE steps only: with races active or tickets
        # queued the oracle never runs inside the serving epoch
        if (self.auditor is not None and idle_pass
                and not self._groups and not self._queues):
            self.auditor.process(1)
        return self.active

    def drain(self, max_epochs: int = 100000) -> None:
        """Run the scheduler until every submitted ticket is terminal."""
        while self.active:
            self.step()
            max_epochs -= 1
            if max_epochs <= 0:
                raise RuntimeError("RequestPlane.drain did not quiesce")

    @property
    def active(self) -> int:
        queued = sum(len(q) for q in self._queues.values())
        racing = sum(len(g.members) for g in self._groups)
        return queued + racing

    # -- termination & result assembly --------------------------------------

    def _deadline_passed(self, entry: _Entry, now: float) -> bool:
        dl = entry.spec.deadline
        return (dl is not None
                and now >= entry.ticket.submitted_at + dl.ms / 1e3)

    def _expire_if_late(self, entry: _Entry, now: float) -> bool:
        if self._deadline_passed(entry, now):
            entry.epoch = entry.index.epoch
            self._finish(entry, R_DEADLINE)
            return True
        return False

    def _terminal_reason(self, entry: _Entry, member: _Member, snap,
                         now: float) -> Optional[str]:
        done = snap.done
        if all(done[member.offset + j] for j in range(len(member.rows))):
            return R_CERTIFIED
        if entry.group is not None and entry.group.session.exhausted:
            return R_BUDGET
        if self._deadline_passed(entry, now):
            return R_DEADLINE
        budget = entry.spec.budget
        if budget is not None:
            if (budget.epochs is not None
                    and entry.ticket.epochs >= budget.epochs):
                return R_BUDGET
            if (budget.coord_ops is not None
                    and float(entry.coord_ops.max()) >= budget.coord_ops):
                return R_BUDGET
        return None

    def _ingest(self, entry: _Entry, member: _Member, snap,
                store_epoch: int) -> None:
        """Fold a group snapshot into the ticket: extend each row's frozen
        certified prefix (never revoked, never reordered) and refresh the
        cost counters."""
        entry.epoch = store_epoch
        for j, i in enumerate(member.rows):
            g = member.offset + j
            entry.coord_ops[i] = snap.coord_ops[g]
            entry.rounds[i] = snap.rounds[g]
            k = snap.ids.shape[1]
            acc = int(snap.acc_count[g])
            bar = float(snap.cand_lcb_min[g])
            frozen_ids = entry.cert_ids[i]
            frozen_vals = entry.cert_vals[i]
            for p in range(len(frozen_ids), acc):
                v = float(snap.values[g, p])
                if not (v < bar) or len(frozen_ids) >= k:
                    break
                gid = int(snap.ids[g, p])
                if gid in frozen_ids:      # δ-failure guard: never duplicate
                    continue
                frozen_ids.append(gid)
                frozen_vals.append(v)

    def _row_result(self, entry: _Entry, i: int, k: int, snap=None,
                    g: Optional[int] = None):
        """(ids, vals, ci, certified) for ticket row i: cached rows are a
        full certified prefix; raced rows are the frozen prefix + a
        best-effort tail from the latest snapshot."""
        if i in entry.cached_rows:
            ids, vals = entry.cached_rows[i]
            return (np.asarray(ids, np.int64),
                    np.asarray(vals, np.float32),
                    np.zeros((k,), np.float32), k)
        ids = list(entry.cert_ids[i])
        vals = list(entry.cert_vals[i])
        ci = [0.0] * len(ids)
        cc = len(ids)
        if snap is not None and g is not None:
            for p in range(snap.ids.shape[1]):
                if len(ids) >= k:
                    break
                gid = int(snap.ids[g, p])
                v = float(snap.values[g, p])
                if gid in entry.cert_ids[i] or not np.isfinite(v):
                    continue
                ids.append(gid)
                vals.append(v)
                ci.append(float(snap.ci[g, p]))
        while len(ids) < k:
            ids.append(-1)
            vals.append(np.inf)
            ci.append(np.inf)
        return (np.asarray(ids, np.int64), np.asarray(vals, np.float32),
                np.asarray(ci, np.float32), cc)

    def _build_result(self, entry: _Entry, terminal: bool,
                      reason: str) -> AnytimeResult:
        k = entry.spec.bind(entry.index.cfg).k
        Q = entry.ticket.n_queries
        ids = np.full((Q, k), -1, np.int64)
        vals = np.full((Q, k), np.inf, np.float32)
        ci = np.full((Q, k), np.inf, np.float32)
        cc = np.zeros((Q,), np.int32)
        member, snap = entry.member, None
        row_of_group = {}
        if member is not None and entry.group is not None:
            snap = entry.group.session.snapshot
            row_of_group = {i: member.offset + j
                            for j, i in enumerate(member.rows)}
        for i in range(Q):
            g = row_of_group.get(i)
            ids[i], vals[i], ci[i], cc[i] = self._row_result(
                entry, i, k, snap if g is not None else None, g)
        return AnytimeResult(
            indices=ids, values=vals, ci_radii=ci, certified_count=cc,
            epoch=entry.epoch, terminal=terminal, reason=reason,
            coord_ops=entry.coord_ops.copy(), rounds=entry.rounds.copy(),
            epochs=entry.ticket.epochs)

    def _empty_result(self, entry: _Entry, reason: str) -> AnytimeResult:
        return self._build_result(entry, True, reason)

    def _finish(self, entry: _Entry, reason: str) -> None:
        t = entry.ticket
        t.status = DONE if reason != R_SHED else SHED
        t.reason = reason
        t.finished_at = time.monotonic()
        t.result = self._build_result(entry, True, reason)
        self._completed.inc()
        if reason == R_DEADLINE:
            self._deadline_exits.inc()
        elif reason == R_BUDGET:
            self._budget_exits.inc()
        self._latencies.append(t.latency_ms)
        self._h_latency.observe(t.latency_ms)
        if entry.namespace is not None:
            self._ns_metrics(entry.namespace)[1].inc()
        self._fill_cache(entry, reason)
        self._offer_audit(entry, reason)
        entry.group = entry.member = None
        if entry.queue_span is not None:     # e.g. deadline expired queued
            entry.queue_span.end(outcome=reason)
            entry.queue_span = None
        nsattr = ({} if entry.namespace is None
                  else {"namespace": entry.namespace})
        self.obs.tracer.instant(
            "plane.shed" if reason == R_SHED else "plane.terminal",
            trace=t.trace_id, reason=reason, latency_ms=t.latency_ms,
            epochs=t.epochs, store_epoch=entry.epoch, **nsattr)
        self._entries.pop(t.id, None)

    def _offer_audit(self, entry: _Entry, reason: str) -> None:
        """Maybe sample this terminal ticket into the shadow-audit
        reservoir. Only FULLY-certified answers claim the complete 1-δ
        contract — partial deadline/budget/shed exits are counted as
        skipped, not audited against a promise they never made."""
        if self.auditor is None:
            return
        if entry.namespace is not None and self.auditor.router is None:
            # a namespaced ticket, but no router to resolve its ground
            # truth through: counted as skipped, not missed
            self.auditor.note_skip("namespaced")
            return
        t = entry.ticket
        res = t.result
        if (reason != R_CERTIFIED
                or int(np.min(res.certified_count)) < res.indices.shape[1]):
            self.auditor.note_skip("uncertified")
            return
        cfg = entry.index._query_cfg(entry.spec)
        self.auditor.offer(
            trace_id=t.trace_id, tenant=t.tenant, store_epoch=entry.epoch,
            contract=("tuned" if entry.index._serving_tuned(entry.spec)
                      else "default"),
            k=res.indices.shape[1], delta=float(cfg.delta),
            queries=entry.queries, served_ids=res.indices,
            served_vals=res.values, spec=entry.spec,
            namespace=entry.namespace)

    def audit_step(self, max_items: int = 1) -> int:
        """Run the δ-audit oracle on up to ``max_items`` pending samples.
        Call between serving work — never inside it; ``step()`` only does
        this on an idle pass (no group racing, nothing queued)."""
        return (self.auditor.process(max_items)
                if self.auditor is not None else 0)

    def audit_flush(self) -> int:
        """Drain the whole audit reservoir through the oracle (shutdown,
        tests). Returns the number of items processed."""
        return self.auditor.flush() if self.auditor is not None else 0

    def _fill_cache(self, entry: _Entry, reason: str) -> None:
        """Fully certified default-contract answers populate the LRU —
        partial (deadline/budget) results never do, and neither does a
        result certified against a superseded store epoch (an
        ``on_mutation='complete'`` group finishing after a mutation must
        not poison the new epoch's cache with, e.g., a deleted id)."""
        index = entry.index
        cache = index._cache
        if (cache is None or reason != R_CERTIFIED or entry.is_sparse
                or not entry.spec.cacheable or entry.spec.cache == "bypass"
                or entry.epoch != index.epoch):
            return
        res = entry.ticket.result
        for i in entry.miss_rows:
            if int(res.certified_count[i]) < res.indices.shape[1]:
                continue
            row = entry.queries[i]
            cache.put(QueryCache.key(row, index._cache_ns),
                      (res.indices[i].copy(), res.values[i].copy()),
                      vec=row, namespace=index._cache_ns)

    # -- consumption ---------------------------------------------------------

    def poll(self, ticket: Ticket) -> AnytimeResult:
        """Non-advancing read of the ticket's current anytime answer."""
        if ticket.result is not None and ticket.terminal:
            return ticket.result
        entry = self._entries[ticket.id]
        reason = "queued" if ticket.status == QUEUED else "partial"
        return self._build_result(entry, False, reason)

    def stream(self, ticket: Ticket) -> Iterator[AnytimeResult]:
        """Drive the scheduler and yield the ticket's refined answer after
        every scheduler epoch, ending with the terminal result."""
        if ticket.terminal:
            yield ticket.result
            return
        while not ticket.terminal:
            self.step()
            yield self.poll(ticket)

    def query(self, queries, rng=None, spec: Optional[QuerySpec] = None,
              *, tenant: str = "default", namespace: Optional[str] = None,
              **overrides) -> AnytimeResult:
        """Blocking shim: submit + drain, with the ``Index.query`` cache and
        counter semantics (``ServeEngine``'s retrieval, under its own
        tenant)."""
        ticket = self.submit(queries, spec, tenant=tenant,
                             namespace=namespace, rng=rng, **overrides)
        while not ticket.terminal:
            self.step()
        if ticket.status == SHED:
            raise RuntimeError(
                f"blocking query shed by the request plane "
                f"({ticket.reason}) — the admission queue is full")
        return ticket.result

    # -- telemetry -----------------------------------------------------------

    def ns_queue_depth(self) -> Dict[str, int]:
        """Waiting tickets per namespace (queued only: the pressure signal
        ``serve.scale.FleetPressurePolicy`` reads)."""
        depth: Dict[str, int] = {}
        for (_t, ns), q in self._queues.items():
            if ns is not None and q:
                depth[ns] = depth.get(ns, 0) + len(q)
        return depth

    @property
    def stats(self) -> ServeStats:
        """The handle's ``ServeStats`` extended with the plane's queue,
        latency and observability telemetry and, behind a router, the
        fleet's rollup. The counters come straight off the obs metrics
        registry. Percentiles are exact over the bounded ``latency_window``
        and 0.0 (never None/NaN) while it is empty. A router-only plane
        starts from an empty ``ServeStats``: no single handle's cache and
        race counters stand for the whole fleet."""
        st = self.index.stats if self.index is not None else ServeStats()
        fleet = self.router
        lat = list(self._latencies)
        queue_depth = sum(len(q) for q in self._queues.values())
        active = sum(len(g.members) for g in self._groups)
        self._g_queue.set(queue_depth)
        self._g_active.set(active)
        p50 = percentile(lat, 50)
        p95 = percentile(lat, 95)
        p99 = percentile(lat, 99)
        return dataclasses.replace(
            st,
            plane_submitted=int(self._submitted.value),
            plane_admitted=int(self._admitted.value),
            plane_completed=int(self._completed.value),
            plane_shed=int(self._shed.value),
            plane_deadline_exits=int(self._deadline_exits.value),
            plane_budget_exits=int(self._budget_exits.value),
            plane_readmitted=int(self._readmitted.value),
            plane_epochs=int(self._epochs.value),
            plane_queue_depth=queue_depth,
            plane_active=active,
            plane_latency_p50_ms=0.0 if p50 is None else float(p50),
            plane_latency_p95_ms=0.0 if p95 is None else float(p95),
            plane_latency_p99_ms=0.0 if p99 is None else float(p99),
            obs_events=self.obs.events.total,
            obs_event_drops=self.obs.events.drops,
            obs_epoch_ms=self._h_epoch.snapshot(),
            obs_latency_ms=self._h_latency.snapshot(),
            audit_sampled=(self.auditor.sampled_rows
                           if self.auditor is not None else 0),
            audit_mismatches=(self.auditor.mismatch_rows
                              if self.auditor is not None else 0),
            audit_err_upper=(self.auditor.err_upper()
                             if self.auditor is not None else 1.0),
            audit_pending=(self.auditor.pending
                           if self.auditor is not None else 0),
            slo_alerts=int(sum(
                m.value for m in self.obs.registry.collect()
                if m.name == "repro_slo_alerts_total")),
            fleet_namespaces_resident=(fleet.resident_count
                                       if fleet is not None else 0),
            fleet_namespaces_evicted=(fleet.evicted_count
                                      if fleet is not None else 0),
            fleet_reloads=fleet.reload_count if fleet is not None else 0,
            ns_queue_depth=(self.ns_queue_depth()
                            if fleet is not None else None),
        )


def _host(a) -> np.ndarray:
    """A host (numpy) copy of a query array or tensor."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _concat_sparse(parts: List[tuple]) -> tuple:
    """Concatenate (q_idx, q_val, q_nnz) padded-CSR triplets along the
    query axis, widening every part to the largest pad width (index 0,
    value 0; nnz untouched — pulls are nnz-bounded)."""
    m = max(p[0].shape[1] for p in parts)

    def widen(a, fill):
        pad = m - a.shape[1]
        if pad == 0:
            return a
        return np.concatenate(
            [a, np.full((a.shape[0], pad), fill, a.dtype)], axis=1)

    q_idx = np.concatenate([widen(p[0], 0) for p in parts], axis=0)
    q_val = np.concatenate([widen(p[1], 0) for p in parts], axis=0)
    q_nnz = np.concatenate([p[2] for p in parts], axis=0)
    return q_idx, q_val, q_nnz
