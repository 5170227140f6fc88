"""``Index`` — the handle in front of the port's index (DESIGN.md §6.1):
build, open or load a dense, rotated or sparse index, single-shard or
sharded over S devices (``index/sharded.py``; a device may repeat), query it
through the typed ``QuerySpec`` protocol, mutate it (insert, delete,
compact) and save it. Results come back in the reference's ``KNNResult``
schema, and a saved directory is the reference's layout: either package
loads it.

Exact-repeat query rows are served from a query LRU (``CachePolicy``,
``api/cache.py``) at zero cost; near repeats race with CI priors seeded from
the cached neighbour. A fleet's handles share one cache: each keys, looks
up and fences only its own namespace (``_cache_ns``, set by
``repro_torch.fleet``). ``Index.race`` opens an epoch-granular resumable race
(``index/anytime.py``), which the request plane (``serve/plane.py``) drives.
``Index.tune`` races the serving config's performance knobs on the store
itself (``repro_torch.tune``); ``save`` persists the winner as a
``tuned.json`` sidecar and ``load`` applies it while the store's signature
still matches.

Side payloads (e.g. kNN-LM next-token ids) attach to the handle and ride
every slot remap (growth, compaction, re-shard): ``payload[result.indices]``
is always aligned. A sharded index's ids are global (shard · stride +
local slot). ``reshard`` re-shards a live index in memory and
``add_replicas`` sets a read fan-out over replica placements
(``api/admin.py``).

The handle is mutable, unlike the stores underneath: every mutation swaps
in a new store and bumps ``epoch``, the fence that callers rely on in
place of store identity.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
from typing import Optional

import numpy as np

from repro_torch.api.cache import QueryCache
from repro_torch.api.spec import (CachePolicy, CompactionPolicy, KNNResult,
                                  QuerySpec, ServeStats)
from repro_torch.core.datasets import next_pow2
from repro_torch.device import make_generator
from repro_torch.index import mutable
from repro_torch.index.batched_race import index_knn
from repro_torch.index.builder import build_index, load_index, save_index
from repro_torch.index.sharded import (ShardedIndexStore, build_sharded_index,
                                       is_sharded_index_dir,
                                       load_sharded_index, reshard,
                                       save_sharded_index, shard_devices,
                                       sharded_compact,
                                       sharded_delete, sharded_insert,
                                       sharded_maybe_compact, with_cfg)
from repro_torch.tune.candidates import tuned_mode
from repro_torch.utils.hostsync import host_fetch

log = logging.getLogger("repro_torch.api")

PAYLOAD_FILE = "payload.npy"


class Index:
    """One handle over a single-shard or sharded racing index.

    Construct through ``Index.build`` (from a corpus), ``Index.load`` (from
    a saved directory) or ``Index.open`` (around an existing store). All
    query and mutation traffic then goes through the handle; the store
    underneath is reachable read-only as ``handle.store``.
    """

    def __init__(self, store, *, payload: Optional[np.ndarray] = None,
                 build_gids: Optional[np.ndarray] = None,
                 cache: Optional[CachePolicy] = None,
                 compaction: Optional[CompactionPolicy] = None):
        self._store = store
        self._base_cfg = store.cfg    # pre-tuning config: the use_tuned=False
                                      # contract races exactly this
        self._tuned = None            # active repro_torch.tune.TunedConfig
        self._force_untuned = False   # recall-guard fallback: serve every
                                      # query on build-time defaults
        self._retune_reason = None    # pending re-tune request (or None)
        self.cache_policy = cache if cache is not None else CachePolicy()
        self.compaction_policy = (compaction if compaction is not None
                                  else CompactionPolicy())
        self._cache = (QueryCache(self.cache_policy.capacity)
                       if self.cache_policy.capacity > 0 else None)
        self._cache_ns: Optional[str] = None  # set by a fleet: a shared
                                              # cache keys and fences on it
        self._payload = payload
        self._build_gids = build_gids
        self._epoch = 0
        self._admin_active: Optional[str] = None
        self._races = 0
        self._raced_queries = 0
        self._near_hits = 0
        self._compactions = 0
        self._n_replicas = 1
        self._replica_stores = None
        self._rr = 0
        self._reshards = 0
        self._shard_coord_ops = None
        self._shard_rounds = None
        self._auto_rng = 0
        self._reset_shard_telemetry()

    # -- constructors -------------------------------------------------------

    @classmethod
    def build(cls, corpus, cfg, rng=0, *, shards: int = 1,
              placement: str = "round_robin",
              capacity: Optional[int] = None, impl: str = "auto",
              payload=None, cache: Optional[CachePolicy] = None,
              compaction: Optional[CompactionPolicy] = None,
              device=None) -> "Index":
        """Preprocess ``corpus`` (n, d) into a served index on ``device``
        (default: the GPU; raises without one); with ``cfg.sparse`` the
        corpus may also be a ``SparseDataset`` (single-shard). ``rng`` is a
        seed or a ``torch.Generator`` on that device. ``shards > 1``
        spreads it over that many shards by ``placement``; ``device`` is
        then None (the first ``shards`` CUDA devices), one device for all
        or a list of one a shard (``index.sharded.shard_devices``).
        ``payload``: optional (n,)-row-aligned side values, kept
        slot-aligned through every remap."""
        if shards > 1:
            store, gids = build_sharded_index(
                corpus, cfg, rng, shards=shards, placement=placement,
                capacity=capacity, impl=impl, device=device)
        else:
            store = build_index(corpus, cfg, rng, capacity=capacity,
                                impl=impl, device=device)
            gids = np.arange(store.n_live, dtype=np.int64)
        handle = cls(store, build_gids=gids, cache=cache,
                     compaction=compaction)
        if payload is not None:
            handle.attach_payload(payload, gids=gids)
        return handle

    @classmethod
    def open(cls, store, *, payload=None, payload_gids=None,
             cache: Optional[CachePolicy] = None,
             compaction: Optional[CompactionPolicy] = None) -> "Index":
        """Wrap an existing ``IndexStore`` or ``ShardedIndexStore``.
        ``payload`` without ``payload_gids`` is taken slot-aligned and must
        cover every live slot (a sharded store's whole capacity)."""
        handle = cls(store, cache=cache, compaction=compaction)
        if payload is not None:
            handle.attach_payload(payload, gids=payload_gids)
        return handle

    @classmethod
    def load(cls, path: str, *, shards: Optional[int] = None,
             cache: Optional[CachePolicy] = None,
             compaction: Optional[CompactionPolicy] = None,
             device=None) -> "Index":
        """Load a saved index directory of either layout onto ``device``
        (default: the GPU; a sharded one as ``Index.build`` places its
        shards); ``shards=S′`` re-shards on the way in. A ``payload.npy``
        sidecar is restored and remapped. A ``tuned.json`` sidecar is
        applied when its signature matches the store as reloaded
        (``repro_torch.tune.load_tuned``); otherwise the index serves its
        build-time config and a warning names the reason."""
        old_ids = None
        if is_sharded_index_dir(path):
            store, old_ids = load_sharded_index(path, shards=shards,
                                                device=device)
        elif shards is not None and shards > 1:
            store, old_ids = reshard(
                ShardedIndexStore([load_index(path, device="cpu")]), shards,
                device=shard_devices(shards, device))
        else:
            store = load_index(path, device=device)
        handle = cls(store, cache=cache, compaction=compaction)
        ppath = os.path.join(path, PAYLOAD_FILE)
        if os.path.exists(ppath):
            saved = np.load(ppath)
            buf = np.zeros((store.capacity,) + saved.shape[1:], saved.dtype)
            if old_ids is None:
                buf[: len(saved)] = saved
            else:
                live = old_ids >= 0
                buf[live] = saved[old_ids[live]]
            handle._payload = buf
        from repro_torch.tune import cache_put, load_tuned, signature_of
        tuned, _why = load_tuned(path, store)
        if tuned is not None:
            handle._apply_tuned(tuned, swap=False)
            cache_put(signature_of(store), tuned)
        return handle

    # -- store-shape properties --------------------------------------------

    @property
    def store(self):
        """The underlying (immutable) store — read-only access; mutate
        through the handle so the epoch fence stays truthful."""
        return self._store

    @property
    def device(self):
        return self._store.device

    @property
    def sharded(self) -> bool:
        return hasattr(self._store, "shards")

    @property
    def n_shards(self) -> int:
        return self._store.n_shards if self.sharded else 1

    @property
    def capacity(self) -> int:
        return self._store.capacity

    @property
    def n_live(self) -> int:
        return self._store.n_live

    @property
    def kind(self) -> str:
        return self._store.kind

    @property
    def cfg(self):
        return self._store.cfg

    @property
    def k(self) -> int:
        return self._store.cfg.k

    @property
    def epoch(self) -> int:
        """Bumped on every mutation swap — the invalidation fence."""
        return self._epoch

    @property
    def tuned(self):
        """The active ``repro_torch.tune.TunedConfig`` (None = build-time
        defaults). Set by ``tune()`` or a valid ``tuned.json`` sidecar at
        ``load``; cleared only by tuning again."""
        return self._tuned

    @property
    def serving_fallback(self) -> bool:
        """True while the recall guard has forced ``use_tuned=False`` for
        ALL queries (``force_untuned``) — the spec's own ``use_tuned`` is
        then ignored until the fallback is lifted."""
        return self._force_untuned

    @property
    def retune_requested(self) -> bool:
        """True while a re-tune has been flagged (``request_retune``) and
        not yet serviced by ``tune()``."""
        return self._retune_reason is not None

    @property
    def retune_reason(self) -> Optional[str]:
        return self._retune_reason

    def force_untuned(self, on: bool = True) -> None:
        """Recall-guard fallback (DESIGN.md §10.3): serve EVERY query on
        the pre-tuning build config until lifted. Cost-only, not an epoch
        event — the tuned config changes racing knobs, never which
        neighbors are correct, so certified cached results stay valid."""
        if on != self._force_untuned:
            log.warning("serving fallback %s: %s the tuned config",
                        "ENGAGED" if on else "lifted",
                        "bypassing" if on else "restoring")
        self._force_untuned = bool(on)

    def request_retune(self, reason: str = "") -> None:
        """Flag that the active tuning is suspect and should be re-raced
        (``tune(force=True)`` clears the flag). Advisory — an operator or
        the caller's policy loop decides when to pay the re-race."""
        self._retune_reason = reason or "requested"

    def _serving_tuned(self, spec: QuerySpec) -> bool:
        """Whether THIS query races the tuned config: needs an active
        tuning, the spec opting in, and no recall-guard fallback."""
        return (self._tuned is not None and spec.use_tuned
                and not self._force_untuned)

    @property
    def payload(self) -> Optional[np.ndarray]:
        """(capacity,)+ slot-aligned side values; index with
        ``KNNResult.indices``."""
        return self._payload

    @property
    def build_gids(self) -> Optional[np.ndarray]:
        """The slot of each original corpus row (−1 once deleted),
        maintained through every remap."""
        return self._build_gids

    @property
    def stats(self) -> ServeStats:
        cache = self._cache      # NB: an *empty* QueryCache is falsy (__len__)
        return ServeStats(
            races=self._races,
            raced_queries=self._raced_queries,
            cache_hits=cache.hits if cache is not None else 0,
            cache_misses=cache.misses if cache is not None else 0,
            cache_entries=len(cache) if cache is not None else 0,
            near_hits=self._near_hits,
            compactions=self._compactions,
            reshards=self._reshards,
            replicas=self._n_replicas,
            shard_coord_ops=(self._shard_coord_ops.tolist()
                             if self._shard_coord_ops is not None else None),
            shard_rounds=(self._shard_rounds.tolist()
                          if self._shard_rounds is not None else None),
            serving_fallback=self._force_untuned,
            retune_requested=self._retune_reason is not None)

    # -- internal plumbing --------------------------------------------------

    def _reset_shard_telemetry(self) -> None:
        if self.sharded:
            self._shard_coord_ops = np.zeros(self.n_shards)
            self._shard_rounds = np.zeros(self.n_shards)
        else:
            self._shard_coord_ops = self._shard_rounds = None

    def _record_shards(self, shard_coord_ops, shard_rounds) -> None:
        """Fold one race's per-shard counters into the cumulative ones."""
        if (self._shard_coord_ops is None or shard_coord_ops is None
                or len(shard_coord_ops) != len(self._shard_coord_ops)):
            return
        self._shard_coord_ops += np.asarray(shard_coord_ops)
        self._shard_rounds = np.maximum(self._shard_rounds,
                                        np.asarray(shard_rounds))

    def _record_session_telemetry(self, session) -> None:
        """Fold a finished RaceSession's per-shard counters into stats
        (the plane calls this when it drops a race group)."""
        self._record_shards(getattr(session, "shard_coord_ops", None),
                            getattr(session, "shard_rounds", None))

    def _swap(self, store) -> None:
        """Epoch fence: install a new store, invalidate the query cache and
        the replica fan-out (both follow the new store lazily)."""
        old_shards = self.n_shards if self.sharded else None
        self._store = store
        self._epoch += 1
        if self._cache is not None:
            # a standalone handle (_cache_ns None) owns the whole cache; a
            # fleet's handle shares it and fences only its own namespace
            self._cache.clear(self._cache_ns)
        self._replica_stores = None
        if (store.n_shards if hasattr(store, "shards") else None) \
                != old_shards:
            self._reset_shard_telemetry()

    def _apply_tuned(self, tuned, *, swap: bool = True) -> None:
        """Install a ``TunedConfig``: rebind the store onto the tuned
        racing knobs (k/δ/metric stay the store's own). ``swap=True`` goes
        through the epoch fence — a live re-tune invalidates the query
        cache; ``swap=False`` is the load-time path (a fresh handle,
        nothing to fence)."""
        new = with_cfg(self._store, tuned.bind(self._store.cfg))
        if swap:
            self._swap(new)
        else:
            # load-time: the handle is not published yet, nothing observes it
            self._store = new
        self._tuned = tuned

    def _remap(self, old_ids: np.ndarray) -> None:
        """Reindex payload and build-row map through an old→new slot map
        (the ``mutable.compact`` contract). Call BEFORE ``_swap``."""
        old_ids = np.asarray(old_ids)
        live = old_ids >= 0
        if self._payload is not None:
            remapped = np.zeros((len(old_ids),) + self._payload.shape[1:],
                                self._payload.dtype)
            remapped[live] = self._payload[old_ids[live]]
            self._payload = remapped
        if self._build_gids is not None:
            lookup = np.full((self.capacity,), -1, np.int64)
            lookup[old_ids[live]] = np.nonzero(live)[0]
            bg = self._build_gids
            ok = bg >= 0
            self._build_gids = np.where(ok, lookup[np.where(ok, bg, 0)], -1)

    def _grow_payload(self, new_capacity: int) -> None:
        if self._payload is not None and new_capacity > len(self._payload):
            grown = np.zeros((new_capacity,) + self._payload.shape[1:],
                             self._payload.dtype)
            grown[: len(self._payload)] = self._payload
            self._payload = grown

    @contextlib.contextmanager
    def _admin_op(self, name: str):
        """Quiesce fence for admin swaps: mutations attempted while the op
        is in flight fail loudly instead of racing the swap."""
        if self._admin_active is not None:
            raise RuntimeError(
                f"admin op {name!r} while {self._admin_active!r} is in "
                "flight")
        self._admin_active = name
        try:
            yield
        finally:
            self._admin_active = None

    def _check_mutable(self, what: str) -> None:
        if self._admin_active is not None:
            raise RuntimeError(
                f"{what} rejected: index is quiesced for admin op "
                f"{self._admin_active!r}")

    def _route(self):
        """Round-robin a race over the replica fan-out (``admin.py``)."""
        if self._n_replicas <= 1:
            return self._store
        if self._replica_stores is None:
            from repro_torch.api.admin import materialize_replicas
            self._replica_stores = materialize_replicas(self._store,
                                                        self._n_replicas)
        store = self._replica_stores[self._rr % len(self._replica_stores)]
        self._rr += 1
        return store

    # -- query --------------------------------------------------------------

    def _query_cfg(self, spec: QuerySpec):
        """The config a spec binds against: the served (tuned) config on
        the fast path, the pre-tuning build config under
        ``use_tuned=False`` or a recall-guard ``force_untuned`` fallback."""
        base = self.cfg if (self._tuned is None
                            or self._serving_tuned(spec)) \
            else self._base_cfg
        return spec.bind(base)

    def _bound_store(self, spec: QuerySpec, store=None):
        """``store`` (default: the primary) with the spec's config
        (``_query_cfg``) bound."""
        store = self._store if store is None else store
        cfg = self._query_cfg(spec)
        if cfg == store.cfg:
            return store
        return with_cfg(store, cfg)

    def _next_rng(self, rng):
        if rng is None:
            rng = self._auto_rng
            self._auto_rng += 1
        return make_generator(rng, self.device)

    def _race(self, queries, rng, spec: QuerySpec, prior_hint):
        mode = tuned_mode(self._tuned if self._serving_tuned(spec) else None,
                          spec.mode)
        raw = index_knn(self._bound_store(spec, self._route()), queries, rng,
                        impl=spec.impl, eliminate=spec.eliminate,
                        warm_start=spec.warm_start, mode=mode,
                        prior_hint=prior_hint)
        if hasattr(raw, "shard_coord_ops"):
            self._record_shards(*host_fetch((raw.shard_coord_ops,
                                             raw.shard_rounds)))
        return raw

    def _seeded_priors(self, hid: np.ndarray, miss):
        """Near-repeat warm starts: per-query CI variance priors for the
        missed rows, tightened on the cached neighbour's top-k arms. Priors
        shape the variance estimate only — the race stays a fresh δ-PAC
        race."""
        pol = self.cache_policy
        if (self._cache is None or pol.near_threshold <= 0
                or len(self._cache) == 0):
            return None
        base = self._store.prior_var.cpu().numpy()
        rows, found = [], False
        for i in miss:
            near = self._cache.get_near(hid[i], pol.near_threshold,
                                        self._cache_ns)
            if near is None:
                rows.append(base)
            else:
                seeded = base.copy()
                seeded[near[0]] *= pol.near_prior_scale
                rows.append(seeded)
                found = True
                self._near_hits += 1
        return np.stack(rows) if found else None

    def query(self, queries, rng=None, *, spec: Optional[QuerySpec] = None,
              **overrides) -> KNNResult:
        """Batched k-NN with the typed query protocol: a ``QuerySpec``,
        keyword overrides (``k=``, ``delta=``, ``mode=``, ``cache=``, …), or
        both. Dense queries are a (Q, d) array; a sparse index takes the
        (q_idx, q_val, q_nnz) padded triplet and races on the per-round
        driver. ``rng`` is a seed or a ``torch.Generator`` on the index's
        device; by default each call takes the next seed of a per-handle
        counter. Returns slot ids (global ids on a sharded index); with a
        read fan-out, successive races round-robin over the replicas.

        Exact-repeat dense rows are served from the query LRU at zero
        coordinate ops unless the spec bypasses it (``cache="bypass"``;
        ``"refresh"`` re-races and overwrites); the missed rows race as
        one batch padded to a power of two, near repeats with seeded CI
        priors. Rows are keyed by their float32 bytes on the host."""
        if spec is None:
            spec = QuerySpec(**overrides)
        elif overrides:
            spec = dataclasses.replace(spec, **overrides)
        gen = self._next_rng(rng)
        use_cache = (self._cache is not None and spec.cacheable
                     and spec.cache != "bypass"
                     and not isinstance(queries, tuple))
        if not use_cache:
            raw = self._race(queries, gen, spec, spec.prior_hint)
            self._races += 1
            self._raced_queries += int(raw.indices.shape[0])
            return self._result(raw)

        hid = np.asarray(queries.cpu() if hasattr(queries, "cpu")
                         else queries, np.float32)
        Q, k = hid.shape[0], spec.bind(self.cfg).k
        idx = np.zeros((Q, k), np.int64)
        vals = np.zeros((Q, k), np.float32)
        coord_ops = np.zeros((Q,), np.float32)
        rounds = np.zeros((Q,), np.int32)
        n_exact = np.zeros((Q,), np.int32)
        keys = [QueryCache.key(row, self._cache_ns) for row in hid]
        shard_ops = shard_rounds = None
        miss = []
        for i in range(Q):
            got = None if spec.cache == "refresh" else self._cache.get(keys[i])
            if got is None:
                miss.append(i)
            else:
                idx[i], vals[i] = got
        if miss:
            sub = hid[miss]
            prior_hint = self._seeded_priors(hid, miss)
            # a power-of-two sub-batch: the draws' shapes, and so the race,
            # depend on the batch, as in the reference
            pad = next_pow2(len(miss)) - len(miss)
            if pad:
                sub = np.concatenate([sub, np.repeat(sub[:1], pad, 0)], 0)
                if prior_hint is not None:
                    prior_hint = np.concatenate(
                        [prior_hint, np.repeat(prior_hint[:1], pad, 0)], 0)
            raw = self._result(self._race(sub, gen, spec, prior_hint))
            shard_ops, shard_rounds = raw.shard_coord_ops, raw.shard_rounds
            for j, i in enumerate(miss):
                idx[i], vals[i] = raw.indices[j], raw.values[j]
                coord_ops[i] = raw.coord_ops[j]
                rounds[i] = raw.rounds[j]
                n_exact[i] = raw.n_exact[j]
                self._cache.put(keys[i], (idx[i].copy(), vals[i].copy()),
                                vec=hid[i], namespace=self._cache_ns)
            self._races += 1
            self._raced_queries += len(miss)
        return KNNResult(indices=idx, values=vals, coord_ops=coord_ops,
                         rounds=rounds, n_exact=n_exact,
                         cache_hits=Q - len(miss),
                         shard_coord_ops=shard_ops, shard_rounds=shard_rounds)

    def race(self, queries, rng=None, *, spec: Optional[QuerySpec] = None,
             raced_queries: Optional[int] = None, chunk_rounds: int = 0,
             obs=None, sid=None, deadline_ms: Optional[float] = None,
             block_sampler=None, coord_sampler=None, **overrides):
        """Epoch-granular resumable race — the anytime twin of ``query``
        (DESIGN.md §7.1). Returns an ``index.anytime.RaceSession``:
        ``step()`` advances one epoch, ``snapshot`` is the partial top-k
        with CI radii and the certified-prefix length. The request plane
        drives it; it never touches the query LRU (partial results must not
        poison the cache).

        ``raced_queries`` overrides the row count recorded in ``stats``
        (the plane pads coalesced batches to powers of two). ``obs``/``sid``
        select the observability context and trace id of the session's
        epoch spans. ``deadline_ms``: the remaining wall budget (default:
        ``spec.deadline``'s); when the race serves a tuned config, the
        session caps each epoch's fused rounds R by what that budget can
        still pay at the tuned ``round_ms`` (DESIGN.md §9.7), and with no
        tuning (or ``use_tuned=False``) the cap stays off.
        ``block_sampler`` / ``coord_sampler`` replace the draws from
        ``rng``."""
        from repro_torch.index.anytime import make_session
        if spec is None:
            spec = QuerySpec(**overrides)
        elif overrides:
            spec = dataclasses.replace(spec, **overrides)
        if spec.mode == "fused" and self.kind == "sparse":
            raise ValueError("the fused epoch driver pulls corpus blocks — "
                             "sparse boxes race on the per-round driver")
        if spec.mode == "rounds" and self.kind != "sparse":
            raise ValueError(
                "anytime sessions drive dense/rotated boxes through the "
                "epoch-fused driver; mode='rounds' is blocking-query only")
        if deadline_ms is None and spec.deadline is not None:
            deadline_ms = spec.deadline.ms
        round_ms = (self._tuned.round_ms if self._serving_tuned(spec)
                    else 0.0)
        session = make_session(
            self._route(), queries, self._next_rng(rng),
            cfg=self._query_cfg(spec), impl=spec.impl,
            eliminate=spec.eliminate, warm_start=spec.warm_start,
            prior_hint=spec.prior_hint, chunk_rounds=chunk_rounds, obs=obs,
            sid=sid, deadline_ms=deadline_ms, round_ms=round_ms,
            block_sampler=block_sampler, coord_sampler=coord_sampler)
        self._races += 1
        self._raced_queries += int(raced_queries if raced_queries is not None
                                   else session.Q)
        return session

    @staticmethod
    def _result(raw) -> KNNResult:
        shard = hasattr(raw, "shard_coord_ops")
        return KNNResult(indices=raw.indices.cpu().numpy(),
                         values=raw.values.cpu().numpy(),
                         coord_ops=raw.coord_ops.cpu().numpy(),
                         rounds=raw.rounds.cpu().numpy(),
                         n_exact=raw.n_exact.cpu().numpy(),
                         shard_coord_ops=(raw.shard_coord_ops.tolist()
                                          if shard else None),
                         shard_rounds=(raw.shard_rounds.tolist()
                                       if shard else None))

    # -- mutation ------------------------------------------------------------

    def attach_payload(self, values, *, gids=None) -> None:
        """Attach (or replace) the slot-aligned side payload. ``gids``
        places row i of ``values`` at slot ``gids[i]``; without it the
        values are taken slot-aligned from 0 and must cover every live
        slot."""
        values = np.asarray(values)
        if gids is None:
            if len(values) > self.capacity:
                raise ValueError(
                    f"payload ({len(values)}) exceeds index capacity "
                    f"({self.capacity}) — wrong index for this datastore?")
            if len(values) < self.n_live:
                raise ValueError(
                    f"payload ({len(values)}) does not cover the index's "
                    f"{self.n_live} live slots — uncovered slots would "
                    "silently serve zeros")
            if self.sharded and len(values) != self.capacity:
                raise ValueError(
                    f"a sharded index needs a capacity-length "
                    f"({self.capacity}) global-id-aligned payload, got "
                    f"{len(values)} (or pass gids=)")
        buf = np.zeros((self.capacity,) + values.shape[1:], values.dtype)
        if gids is None:
            buf[: len(values)] = values
        else:
            buf[np.asarray(gids)] = values
        self._payload = buf

    def insert(self, rows, *, payload=None) -> np.ndarray:
        """Insert (B, d) dense rows (a sparse index compresses them and
        widens its rows when one needs it); returns their slot ids (global
        ids on a sharded index, each row on the least-loaded shard).
        ``payload``: per-row side values written into the attached payload
        at those slots."""
        self._check_mutable("insert")
        if self.sharded:
            store, slots, grow_ids = sharded_insert(self._store, rows)
            if grow_ids is not None:      # the stride grew: ids moved
                self._remap(grow_ids)
        else:
            store, slots = mutable.insert(self._store, rows)
        self._grow_payload(store.capacity)
        if payload is not None:
            if self._payload is None:
                payload = np.asarray(payload)
                self._payload = np.zeros(
                    (store.capacity,) + payload.shape[1:], payload.dtype)
            self._payload[slots] = payload
        self._swap(store)
        return slots

    def delete(self, slot_ids) -> None:
        """Tombstone slots (global ids on a sharded index); their data
        stays until compaction."""
        self._check_mutable("delete")
        store = (sharded_delete(self._store, slot_ids) if self.sharded
                 else mutable.delete(self._store, slot_ids))
        if self._build_gids is not None:
            # a later insert may reuse a freed slot, which must not be
            # attributed to the original corpus row: −1 once deleted
            dead = np.atleast_1d(np.asarray(slot_ids, np.int64))
            self._build_gids = np.where(
                np.isin(self._build_gids, dead), -1, self._build_gids)
        self._swap(store)

    def compact(self) -> np.ndarray:
        """Rebuild the slot layout without the tombstones; payload and
        build map are remapped. Returns the old→new slot map for any
        external side state."""
        self._check_mutable("compact")
        store, old_ids = (sharded_compact(self._store) if self.sharded
                          else mutable.compact(self._store))
        self._remap(old_ids)
        self._swap(store)
        self._compactions += 1
        return old_ids

    def maybe_compact(self, *, threshold: Optional[float] = None
                      ) -> Optional[np.ndarray]:
        """Apply the handle's ``CompactionPolicy`` (or an explicit
        threshold): compact only when the tombstone fraction crosses it
        AND capacity would shrink. Returns the remap when a compaction
        ran, else None."""
        self._check_mutable("compact")
        thr = threshold if threshold is not None \
            else self.compaction_policy.threshold
        compact = (sharded_maybe_compact if self.sharded
                   else mutable.maybe_compact)
        store, old_ids = compact(self._store, threshold=thr)
        if old_ids is None:
            return None
        self._remap(old_ids)
        self._swap(store)
        self._compactions += 1
        return old_ids

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Persist through the checkpoint layer (per-shard checkpoints and
        a manifest when sharded); an attached payload is
        written as a ``payload.npy`` sidecar and an active tuning as a
        ``tuned.json`` sidecar, both inside the same atomic directory
        publish, so ``path`` only ever holds a complete index. The
        checkpoint's config is the pre-tuning build config: the tuning
        lives in the sidecar alone, so a load that rejects the sidecar
        serves the build-time defaults (the reference writes the tuned
        knobs into both; ROADMAP.md Queue 3)."""
        def _sidecars(tmp: str) -> None:
            if self._payload is not None:
                np.save(os.path.join(tmp, PAYLOAD_FILE), self._payload)
            if self._tuned is not None:
                from repro_torch.tune import save_tuned, signature_of
                save_tuned(tmp, signature_of(self._store), self._tuned,
                           measured={"epoch_ms": self._tuned.epoch_ms,
                                     "round_ms": self._tuned.round_ms})

        store = (self._store if self._tuned is None
                 else with_cfg(self._store, self._base_cfg))
        if self.sharded:
            save_sharded_index(store, path, extra=_sidecars)
        else:
            save_index(store, path, extra=_sidecars)

    # -- admin ops -----------------------------------------------------------

    def reshard(self, n_shards: int, *, device=None) -> np.ndarray:
        """Re-shard the live index to ``n_shards`` in memory, with no
        checkpoint round trip (``api/admin.live_reshard``); returns the
        old→new global-id map."""
        from repro_torch.api.admin import live_reshard
        return live_reshard(self, n_shards, device=device)

    def add_replicas(self, n_replicas: int) -> int:
        """Set the read fan-out to ``n_replicas`` (1: the primary only);
        queries round-robin over the replicas. Returns the fan-out."""
        from repro_torch.api.admin import add_replicas
        return add_replicas(self, n_replicas)

    def tune(self, queries=None, rng=None, *, levels: int = 2,
             reps: int = 1, force: bool = False, apply: bool = True,
             **kw) -> dict:
        """Autotune the serving config for THIS store (repro_torch.tune,
        DESIGN.md §9): enumerate the (R, P, B, floor, buffers, mode)
        candidate grid, prune it with the analytic cost model, and race the
        survivors with successive halving on measured wall time.

        Runs as an admin op — mutations are refused while it races — and
        installs the winner through the epoch fence (the epoch bumps, the
        query cache clears). An equal-signature tuning from earlier in the
        process is reused without re-racing unless ``force``. ``queries``
        defaults to a synthetic batch drawn from the corpus (a sparse index
        must pass real queries); ``rng`` is a seed or a ``torch.Generator``.
        ``apply=False`` measures without installing. A fresh tuning lifts a
        recall-guard fallback and clears a pending re-tune request. Returns
        the tuning report dict."""
        from repro_torch.tune import tune_store
        with self._admin_op("tune"):
            tuned, report = tune_store(self._store, queries, rng,
                                       levels=levels, reps=reps,
                                       force=force, **kw)
            report = dict(report, applied=bool(apply))
            if apply:
                self._apply_tuned(tuned)
                if self._force_untuned:
                    self.force_untuned(False)
                self._retune_reason = None
        return report

    def __repr__(self) -> str:
        return (f"Index(kind={self.kind!r}, shards={self.n_shards}, "
                f"live={self.n_live}/{self.capacity}, k={self.k}, "
                f"epoch={self._epoch}, replicas={self._n_replicas}, "
                f"device={self.device})")
