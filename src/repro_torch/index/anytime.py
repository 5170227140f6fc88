"""Epoch-granular resumable races — the anytime engine under the request
plane (DESIGN.md §7.1), single-shard half.

The bandit race is an anytime algorithm: at every epoch boundary each query
holds a partial top-k with per-arm confidence intervals. The blocking
drivers (``batched_race.py``) run that loop to certification inside one
call; this module exposes the same loop as a ``RaceSession`` that a
scheduler drives one epoch at a time:

    sess = make_session(store, queries, seed, cfg=cfg)
    while sess.step():
        partial = sess.snapshot          # host-side anytime view
        ...                              # serve it, check deadlines, retire

The certified-prefix contract (tested against the reference):

  * After every epoch the ≤ k accepted arms of each query are exact-
    evaluated in place (mean ← exact value, CI ← 0; the Welford pool stats
    stay, so the survivor-pooled CI variance is unchanged). Accepted arms
    are never pulled again, so this is a one-time O(k·d) cost per query.
  * ``snapshot.acc_count`` leading entries are accepted arms sorted by
    exact value. Position i is order-certified iff its exact value is
    below the least LCB over every remaining candidate
    (``snapshot.cand_lcb_min``): w.h.p. 1 − δ no candidate can end below
    it, so the certified prefix of a partial answer is the prefix of the
    full-certification answer.
  * A ``done`` query's accepted set is its certificate: its
    ``cand_lcb_min`` is +inf and its whole prefix certifies.

Scale: as in the blocking drivers, a dense session races on the pulls'
ρ/d_pad scale, its exact evaluations too, and the values, CI radii and
``cand_lcb_min`` of its summary are all on that one scale when the device
ranks them. The host converts the three together, in float64, to the
reported θ = ρ/d (× d_pad/d, exactly 1.0 when d_pad = d), so the order
that decides the certified prefix is the same on either scale. The
reference exact-evaluates on ρ/d (ROADMAP.md Queue 3 item 2).

One host sync per epoch: a fused epoch's survivor counts, done flags and
pull bound (the blocking driver's packed tensor) cross to the host in the
same ``host_fetch`` as the summary. The sparse session runs the per-round
driver in chunks: each round syncs once, as the blocking per-round driver
does (the reference runs the chunk in one on-device ``while_loop``), and
the chunk's summary once more.

Sessions exist for all four store boxes: single-shard dense/rotated (the
epoch-fused frontier driver), single-shard sparse (the per-round driver in
bounded-round chunks), and their sharded twins (shard-local states stepped
by one host loop, merged on the host per snapshot; the sharded fused
session exactifies on the pulls' scale too, where the reference's divides
by the true d). Block and coordinate draws come from replaceable samplers,
as in the blocking drivers, so the tests can replay the reference's.
"""
from __future__ import annotations

import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import BMOConfig
from repro_torch.core import confidence as conf
from repro_torch.core.bmo_nn import (BlockSampler, CoordSampler,
                                     default_block_sampler,
                                     default_coord_sampler)
from repro_torch.core.ucb import (INF, BatchedRaceState, RoundsRaceFns,
                                  smallest_k)
from repro_torch.device import make_generator
from repro_torch.index.batched_race import (_dense_exact_theta, _frontier_ci,
                                            _fused_epoch_step, _fused_init,
                                            make_sparse_rounds_race)
from repro_torch.index import sharded as sh
from repro_torch.index.frontier import (FrontierState, bucket_width,
                                        compact_frontier, floor_width,
                                        pow2_floor)
from repro_torch.obs import get_obs, new_trace_id
from repro_torch.obs import profile as obs_profile
from repro_torch.utils.hostsync import host_fetch

_BIG = 1e9


class RaceSummary(NamedTuple):
    """Device-side anytime view of one race batch, refreshed per epoch."""
    ids: torch.Tensor           # (Q, k) slot ids, accepted-first then cands
    values: torch.Tensor        # (Q, k) exact for accepted, estimates after
    ci: torch.Tensor            # (Q, k) CI half-widths (0 where exact)
    acc_count: torch.Tensor     # (Q,) leading accepted entries
    cand_lcb_min: torch.Tensor  # (Q,) least LCB over remaining candidates
    done: torch.Tensor          # (Q,) race finished (k certified / exhausted)
    coord_ops: torch.Tensor     # (Q,)
    rounds: torch.Tensor        # (Q,)
    n_exact: torch.Tensor       # (Q,)


class Partial(NamedTuple):
    """Host-side (numpy) RaceSummary; values, ci and cand_lcb_min in θ = ρ/d
    (float64)."""
    ids: np.ndarray
    values: np.ndarray
    ci: np.ndarray
    acc_count: np.ndarray
    cand_lcb_min: np.ndarray
    done: np.ndarray
    coord_ops: np.ndarray
    rounds: np.ndarray
    n_exact: np.ndarray


def _to_host(summ: RaceSummary, scale: float = 1.0, extra=()):
    """THE per-epoch device→host boundary: one ``host_fetch`` of the whole
    summary and of the ``extra`` tensors (the epoch's packed host tensor).
    ``scale`` converts the race's values to θ on the host. Returns (the
    extra tensors as numpy, the Partial)."""
    got = host_fetch(tuple(extra) + tuple(summ))
    p = Partial(*got[len(extra):])
    p = p._replace(**{f: getattr(p, f).astype(np.float64) * scale
                      for f in ("values", "ci", "cand_lcb_min")})
    return got[:len(extra)], p


def _to_host_shards(summs, scale: float = 1.0, extra=()):
    """``_to_host`` for S per-shard summaries: ONE ``host_fetch`` of the
    ``extra`` tensors and every summary, moved to the first one's device
    (the reference's gather over the shard axis). Returns (the extra
    tensors as numpy, the Partial with (S, ...) fields)."""
    dev = summs[0].ids.device
    flat = [t.to(dev) for t in extra] + [t.to(dev) for sm in summs
                                         for t in sm]
    got = host_fetch(tuple(flat))
    n, F = len(extra), len(RaceSummary._fields)
    parts = [Partial(*got[n + i * F: n + (i + 1) * F])
             for i in range(len(summs))]
    p = Partial(*(np.stack(f) for f in zip(*parts)))
    p = p._replace(**{f: getattr(p, f).astype(np.float64) * scale
                      for f in ("values", "ci", "cand_lcb_min")})
    return got[:n], p


def _merge_shard_partials(p: Partial) -> Partial:
    """Merge S per-shard partial views (fields (S, Q, …)) into one global
    view on the host. Accepted entries, already exact, merge by (θ, global
    id); the best-effort tail interleaves the shards' candidate
    estimates."""
    S, Q, k = p.ids.shape
    ids = np.full((Q, k), -1, np.int64)
    vals = np.full((Q, k), np.inf)
    ci = np.zeros((Q, k))
    acc_count = np.zeros((Q,), np.int32)
    for q in range(Q):
        accepted, cands = [], []
        for s in range(S):
            a = int(p.acc_count[s, q])
            for i in range(k):
                v = float(p.values[s, q, i])
                if not np.isfinite(v):
                    continue
                entry = (v, int(p.ids[s, q, i]), float(p.ci[s, q, i]))
                (accepted if i < a else cands).append(entry)
        accepted.sort(key=lambda e: (e[0], e[1]))
        cands.sort(key=lambda e: (e[0], e[1]))
        for i, (v, g, c) in enumerate((accepted + cands)[:k]):
            vals[q, i], ids[q, i], ci[q, i] = v, g, c
        acc_count[q] = min(len(accepted), k)
    return Partial(
        ids=ids, values=vals, ci=ci, acc_count=acc_count,
        cand_lcb_min=np.min(p.cand_lcb_min, axis=0),
        done=np.all(p.done, axis=0),
        coord_ops=np.sum(p.coord_ops, axis=0),
        rounds=np.max(p.rounds, axis=0),
        n_exact=np.sum(p.n_exact, axis=0),
    )


def _summarize(ids, mean, ci, exact, accepted, rejected, valid, done,
               coord_ops, rounds, n_exact, k: int) -> RaceSummary:
    """Rank the race state into the anytime view: accepted arms first
    (ascending exact value), then the best candidates by current estimate.
    A query with fewer than k rankable entries gets +inf values there, which
    downstream merges drop."""
    acc = accepted & valid
    cand = valid & ~accepted & ~rejected
    score = torch.where(acc, mean - _BIG, torch.where(cand, mean, INF))
    pos = smallest_k(score, k)                  # lax.top_k(-score, k)'s ids

    def take(a, at):
        return torch.gather(a, 1, at)

    picked = take(score, pos)
    out_vals = torch.where(picked == INF, INF, take(mean, pos))
    out_ci = torch.where(take(exact, pos) | (picked == INF), 0.0,
                         take(ci, pos))
    # the − BIG class offset exceeds fp32 resolution, so accepted picks tie
    # on score and arrive in index order: re-sort them by exact value
    # (stably, so the candidate tail keeps its ascending-estimate order)
    order = torch.argsort(torch.where(take(acc, pos), out_vals, INF), dim=1,
                          stable=True)
    pos = take(pos, order)
    out_vals, out_ci = take(out_vals, order), take(out_ci, order)
    cand_min = torch.amin(torch.where(cand, mean - ci, INF), dim=1)
    return RaceSummary(
        ids=take(ids, pos),
        values=out_vals,
        ci=out_ci,
        acc_count=torch.clamp(torch.sum(acc, 1), max=k).to(torch.int32),
        cand_lcb_min=torch.where(done, INF, cand_min),
        done=done,
        coord_ops=coord_ops,
        rounds=rounds,
        n_exact=n_exact,
    )


def _exact_targets(accepted, exact, mean, k: int):
    """Positions of the ≤ k accepted arms that still carry estimates (the
    lowest means first) and which of them need the exact evaluation."""
    need_all = accepted & ~exact
    pos = smallest_k(torch.where(need_all, mean, INF), k)
    return pos, torch.gather(need_all, 1, pos)


def _exactify_frontier(x, qs, st: FrontierState, *, k: int, metric: str,
                       d: int) -> FrontierState:
    """Exact-evaluate the ≤ k accepted arms that still carry estimates, on
    the pulls' ρ/d_pad scale; each costs d coordinate reads. Means and the
    ``exact`` flag change; Welford count/m2 stay, so the survivor-pooled
    CI variance — and every pending decision's radius — is untouched. The
    evaluation runs whether or not a row needs it (the reference's
    ``lax.cond``), so no device value gates it from the host."""
    pos, need = _exact_targets(st.accepted & st.valid, st.exact, st.mean, k)
    slots = torch.where(need, torch.gather(st.ids, 1, pos), 0)
    vals = _dense_exact_theta(x, qs, slots, metric, x.shape[1])
    cur = torch.gather(st.mean, 1, pos)
    return st._replace(
        mean=st.mean.scatter(1, pos, torch.where(need, vals, cur)),
        exact=st.exact.scatter(1, pos, torch.gather(st.exact, 1, pos) | need),
        coord_ops=st.coord_ops + torch.sum(need, 1) * float(d),
        n_exact=st.n_exact + torch.sum(need, 1, dtype=torch.int32))


def _rounds_partial(fns: RoundsRaceFns, st: BatchedRaceState, k: int,
                    gid_base: int = 0):
    """Exactify the accepted arms of the per-round driver's state (through
    the box's own ``exact_fn``, at its coordinate cost) and summarize, the
    ids offset by ``gid_base`` (a shard's first global id)."""
    Q, n = st.mean.shape
    pos, need = _exact_targets(st.accepted, st.exact, st.mean, k)
    vals = fns.exact_fn(pos)
    cur = torch.gather(st.mean, 1, pos)
    st = st._replace(
        mean=st.mean.scatter(1, pos, torch.where(need, vals, cur)),
        exact=st.exact.scatter(1, pos, torch.gather(st.exact, 1, pos) | need),
        coord_ops=st.coord_ops + torch.sum(
            need * torch.gather(fns.exact_cost, 1, pos), 1))
    ci = fns.ci_radius(st)
    ids = torch.arange(gid_base, gid_base + n, dtype=torch.int32,
                       device=st.mean.device)[None].expand(Q, n)
    valid = torch.ones((Q, n), dtype=torch.bool, device=st.mean.device)
    summ = _summarize(ids, st.mean, ci, st.exact, st.accepted, st.rejected,
                      valid, st.done, st.coord_ops, st.rounds,
                      torch.sum(st.exact, 1, dtype=torch.int32), k)
    return st, summ


def _fused_partial(x, qs, st: FrontierState, prior_pool, *, cfg: BMOConfig,
                   d: int, log_term: float, prior_weight: float,
                   gid_base: int = 0):
    st = _exactify_frontier(x, qs, st, k=cfg.k, metric=cfg.metric, d=d)
    ci = _frontier_ci(st, cfg, log_term, prior_pool, prior_weight)
    summ = _summarize(st.ids + gid_base, st.mean, ci, st.exact, st.accepted,
                      st.rejected, st.valid, st.done, st.coord_ops,
                      st.rounds, st.n_exact, cfg.k)
    return st, summ


def _force_done(st, mask: np.ndarray):
    """Freeze rows (plane retire): the drivers never pull or mutate done
    rows."""
    m = torch.as_tensor(np.asarray(mask, bool), device=st.done.device)
    return st._replace(done=st.done | m)


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------


class RaceSession:
    """One resumable race batch. ``step()`` advances one epoch and refreshes
    ``snapshot``; ``retire(mask)`` freezes rows whose ticket left the plane
    (deadline, budget) so the remaining rows get their pull budget.

    The base ``step()`` owns the epoch boundary: it times the concrete
    driver's ``_step_impl()``, then records — on the host, from the snapshot
    the driver already transferred — the epoch's pull and coord-op deltas,
    frontier width, survivors and the CI radius of the worst uncertified
    position, as a ``race.epoch`` span under the session's ``sid`` trace id
    plus registry metrics (DESIGN.md §8.3), under the reference's names.
    """

    kind = "base"
    kernel = "fused_epoch_pull"   # device kernel this box's epochs launch

    def __init__(self, Q: int, k: int, *, obs=None, sid: Optional[str] = None):
        self.Q = Q
        self.k = k
        self.epochs = 0
        self.obs = obs if obs is not None else get_obs()
        self.sid = sid if sid is not None else new_trace_id("s")
        self.last_epoch: Optional[dict] = None
        self._snap: Optional[Partial] = None
        self._retired = np.zeros((Q,), bool)
        self._prev_coord_ops: Optional[float] = None
        self._prev_rounds = 0
        self._deadline_t: Optional[float] = None
        self._round_ms = 0.0

    def set_deadline(self, deadline_ms: Optional[float],
                     round_ms: Optional[float] = None) -> None:
        """Deadline-aware fused-round selection (DESIGN.md §9.7): with a
        wall-clock budget and a measured per-round cost (``round_ms``), the
        fused session caps the rounds fused into the next launch so one
        epoch never overshoots the deadline. ``Index.race`` passes the
        tuned config's measured ``round_ms`` (``repro_torch.tune``) when
        the race serves it, and 0 otherwise, which keeps the cap off."""
        self._deadline_t = (None if deadline_ms is None
                            else time.perf_counter() + deadline_ms / 1e3)
        self._round_ms = float(round_ms or 0.0)

    def _deadline_R(self, R: int) -> int:
        """Cap the adaptive R by the rounds the remaining wall budget can
        pay for, quantized down the R0·2^j chain (the reference's rule)."""
        if self._deadline_t is None or self._round_ms <= 0.0:
            return R
        left_ms = (self._deadline_t - time.perf_counter()) * 1e3
        cap = int(left_ms / self._round_ms)
        R0 = getattr(self, "_R0", 1)
        if cap <= R0:
            return min(R, R0)     # never below the chain's smallest rung
        return min(R, R0 * pow2_floor(cap // R0))

    @property
    def snapshot(self) -> Partial:
        return self._snap

    @property
    def done(self) -> np.ndarray:
        return np.asarray(self._snap.done) | self._retired

    @property
    def exhausted(self) -> bool:
        """Round cap hit with rows unresolved — the driver's safety net."""
        return not self.done.all() and self._rounds_spent >= self._max_rounds

    def retire(self, mask: np.ndarray) -> None:
        self._retired |= np.asarray(mask, bool)
        self._apply_force_done(self._retired)

    def step(self) -> bool:
        if self.done.all() or self._rounds_spent >= self._max_rounds:
            return False
        if self._prev_coord_ops is None:     # baseline excludes init pulls
            self._prev_coord_ops = float(np.sum(self._snap.coord_ops))
            self._prev_rounds = int(np.max(self._snap.rounds, initial=0))
        t0 = time.perf_counter()
        with obs_profile.annotate(f"repro.race.epoch.{self.kind}"):
            alive = self._step_impl()
        self._record_epoch(t0, time.perf_counter() - t0)
        return alive

    def _record_epoch(self, t0: float, dur: float) -> None:
        snap = self._snap
        coord = float(np.sum(snap.coord_ops))
        rounds = int(np.max(snap.rounds, initial=0))
        d_coord = max(coord - self._prev_coord_ops, 0.0)
        d_rounds = max(rounds - self._prev_rounds, 0)
        self._prev_coord_ops, self._prev_rounds = coord, rounds
        finite_ci = np.where(np.isfinite(snap.ci), snap.ci, 0.0)
        info = {
            "epoch": self.epochs,
            "kind": self.kind,
            "coord_ops": d_coord,
            "rounds": d_rounds,
            "worst_ci": float(finite_ci.max(initial=0.0)),
            "active": int(np.sum(~self.done)),
            "done": int(np.sum(self.done)),
        }
        info.update(self._epoch_extra())
        self.last_epoch = info
        reg = self.obs.registry
        reg.counter("repro_race_epochs_total",
                    "race epochs stepped", kind=self.kind).inc()
        reg.counter("repro_race_coord_ops_total",
                    "coordinate reads paid by race epochs",
                    kind=self.kind).inc(d_coord)
        reg.histogram("repro_race_epoch_ms",
                      "wall time of one race epoch (ms)",
                      kind=self.kind).observe(dur * 1e3)
        obs_profile.record_kernel_launch(
            self.obs, self.kernel,
            launches=self._epoch_launches(d_rounds),
            coord_ops=d_coord, pulls=float(d_rounds))
        self.obs.tracer.complete("race.epoch", t0, dur, trace=self.sid,
                                 dur_ms=dur * 1e3, **info)

    def _epoch_extra(self) -> dict:
        """Per-box epoch attributes (frontier width, survivors, R)."""
        return {}

    def _epoch_launches(self, d_rounds: int) -> int:
        """Device programs this epoch issued (per-launch accounting)."""
        return 1

    def _step_impl(self) -> bool:
        raise NotImplementedError

    def _apply_force_done(self, mask) -> None:
        raise NotImplementedError


class FusedSession(RaceSession):
    """Single-shard dense/rotated: the §4 epoch-fused survivor-compacted
    driver, its host loop exposed one epoch at a time (the blocking
    ``fused_race_topk``'s adaptive-R rule; its compaction at most halves the
    frontier per epoch, as below)."""

    kind = "fused"

    def __init__(self, store, queries, rng=0, *, cfg: BMOConfig,
                 impl: str = "auto", eliminate: bool = True,
                 prior=None, prior_weight: float = 0.0,
                 obs=None, sid: Optional[str] = None,
                 block_sampler: Optional[BlockSampler] = None):
        x, qs = store.x, store.prepare_queries(queries, impl=impl)
        n = x.shape[0]
        super().__init__(qs.shape[0], cfg.k, obs=obs, sid=sid)
        nb = x.shape[1] // store.block
        B0 = min(cfg.batch_arms, n)
        P = cfg.pulls_per_round
        if block_sampler is None:
            block_sampler = default_block_sampler(
                make_generator(rng, x.device), x.device)
        self._sampler = block_sampler
        self._cfg, self._x, self._qs = cfg, x, qs
        self._block, self._d, self._impl = store.block, store.d, impl
        self._nb = nb
        self._scale = x.shape[1] / store.d       # ρ/d_pad → θ = ρ/d
        self._eliminate, self._prior_weight = eliminate, prior_weight
        self._log_term = math.log(2.0 / conf.delta_prime(cfg.delta, n, nb))
        self._max_rounds = cfg.max_rounds or int(
            2 * math.ceil(n * nb / max(B0 * P, 1)) + n + 16)
        self._R0 = max(cfg.epoch_rounds, 1)
        self._R_cap = max(1, -(-nb // P))
        self._floor_w = floor_width(cfg, n, B0=B0)
        prior = store.prior_var if prior is None else torch.as_tensor(
            prior, dtype=torch.float32, device=x.device)
        st, self._pool = _fused_init(
            x, qs, store.alive, prior, block_sampler, cfg=cfg,
            block=store.block, impl=impl, prior_weight=prior_weight)
        self._W0 = st.width
        self._rounds_spent = 0
        self._last_R = 0
        self._n_surv = np.full((self.Q,), n)
        # the largest pull count among arms still to be pulled: after the
        # wide init every live arm holds T0 pulls
        self._count_hi = float(max(1, max(cfg.init_pulls, 2) // P) * P)
        self._refresh(st)

    def _refresh(self, st, host=None) -> None:
        """Exactify, summarize, and cross to the host once: the summary
        with the epoch's packed survivor counts, done flags and pull bound
        (``host``)."""
        self._st, summ = _fused_partial(
            self._x, self._qs, st, self._pool, cfg=self._cfg, d=self._d,
            log_term=self._log_term, prior_weight=self._prior_weight)
        got, self._snap = _to_host(summ, self._scale,
                                   () if host is None else (host,))
        if got:
            self._n_surv = got[0][:self.Q].astype(np.int64)
            self._count_hi = float(got[0][-1])

    def _apply_force_done(self, mask) -> None:
        self._st = _force_done(self._st, mask)
        self._n_surv = np.where(self._retired, 0, self._n_surv)

    def _epoch_extra(self) -> dict:
        return {"width": int(self._st.width),
                "n_surv": int(self._n_surv.max(initial=0)),
                "R": self._last_R}

    def _step_impl(self) -> bool:
        need = int(self._n_surv[~self.done].max(initial=1))
        # halve the buffer at most once per epoch (unlike the blocking
        # driver's jump-to-cover): every session walks the same descending
        # width chain, the reference's schedule, on which the replayed
        # decisions depend
        W_new = max(bucket_width(need, floor=self._floor_w,
                                 current=self._st.width),
                    self._st.width // 2)
        if W_new < self._st.width:
            self._st = compact_frontier(self._st, W_new=W_new)
        R = min(self._R0 * pow2_floor(self._W0 // max(need, 1)), self._R_cap)
        R = self._deadline_R(R)
        T = R * self._cfg.pulls_per_round
        st, host = _fused_epoch_step(
            self._x, self._qs, self._st, self._pool, self._sampler,
            cfg=self._cfg, block=self._block, d=self._d, impl=self._impl,
            eliminate=self._eliminate, prior_weight=self._prior_weight,
            log_term=self._log_term, T=T,
            may_cross=self._count_hi + T >= self._nb)
        self._rounds_spent += R
        self._last_R = R
        self.epochs += 1
        self._refresh(st, host)
        return not self.done.all()


class SparseRoundsSession(RaceSession):
    """Single-shard sparse: the §3.2 per-round driver in bounded-round
    chunks (one chunk = one scheduler epoch)."""

    kind = "sparse"
    kernel = "block_pull_multi"   # the reference's label for this box

    def __init__(self, store, queries, rng=0, *, cfg: BMOConfig,
                 eliminate: bool = True, prior=None,
                 prior_weight: float = 0.0, chunk_rounds: int = 0,
                 obs=None, sid: Optional[str] = None,
                 coord_sampler: Optional[CoordSampler] = None):
        q_idx, q_val, q_nnz = queries
        dev = store.device
        if coord_sampler is None:
            coord_sampler = default_coord_sampler(make_generator(rng, dev),
                                                  dev)
        prior = store.prior_var if prior is None else torch.as_tensor(
            prior, dtype=torch.float32, device=dev)
        self._fns = make_sparse_rounds_race(
            store.indices, store.values, store.nnz, store.alive, prior,
            q_idx, q_val, q_nnz, coord_sampler, cfg=cfg, d=store.d,
            eliminate=eliminate, prior_weight=prior_weight)
        super().__init__(int(self._fns.exact_cost.shape[0]), cfg.k, obs=obs,
                         sid=sid)
        self._cfg = cfg
        self._chunk = chunk_rounds or 2 * max(cfg.epoch_rounds, 1)
        self._max_rounds = self._fns.max_rounds
        self._rounds_spent = 0
        self._st, summ = _rounds_partial(self._fns, self._fns.init(), cfg.k)
        _, self._snap = _to_host(summ)

    def _apply_force_done(self, mask) -> None:
        self._st = _force_done(self._st, mask)

    def _epoch_extra(self) -> dict:
        return {"R": self._chunk}

    def _epoch_launches(self, d_rounds: int) -> int:
        # one pull per round of the chunk
        return max(int(d_rounds), 1)

    def _step_impl(self) -> bool:
        st = self._st
        limit = st.round_no + self._chunk
        while self._fns.active(st) and st.round_no < limit:
            st = self._fns.body(st)
        self._st, summ = _rounds_partial(self._fns, st, self._cfg.k)
        self._rounds_spent += self._chunk
        _, self._snap = _to_host(summ)
        self.epochs += 1
        return not self.done.all()


class ShardedFusedSession(RaceSession):
    """Sharded dense/rotated: the shard-local fused race with the shared
    host epoch loop of ``index/sharded.py``, the cross-shard pull-budget
    reallocator included, stepped one epoch at a time; each snapshot
    merges the shards' partial views on the host. One host sync an epoch
    carries every stepped shard's packed vector and every shard's
    summary."""

    kind = "sharded_fused"

    def __init__(self, store, queries, rng=0, *, cfg: BMOConfig,
                 impl: str = "auto", eliminate: bool = True, priors=None,
                 prior_weight: float = 0.0, obs=None,
                 sid: Optional[str] = None, block_samplers=None):
        qs = store.prepare_queries(queries, impl=impl)
        super().__init__(qs.shape[0], cfg.k, obs=obs, sid=sid)
        self._store, self._cfg, self._impl = store, cfg, impl
        self._S, self._stride = store.n_shards, store.stride
        self._qs_of = [qs.to(s.device) for s in store.shards]
        self._samplers = (list(block_samplers) if block_samplers is not None
                          else sh.shard_samplers(rng, store.devices,
                                                 default_block_sampler))
        self._eliminate, self._prior_weight = eliminate, prior_weight
        self._plan = plan = sh.fused_plan(store, cfg)
        self._scale = store.d_pad / store.d      # ρ/d_pad → θ = ρ/d
        self._R0, self._max_rounds = plan.R0, plan.max_rounds
        if priors is None:
            priors = [s.prior_var for s in store.shards]
        states, self._pools, self._host = sh.fused_init(
            store, self._qs_of, priors, self._samplers, cfg=cfg, plan=plan,
            impl=impl, prior_weight=prior_weight)
        self._W0 = states[0].width
        self._rounds_spent = 0
        self._last_R = 0
        self._launches = 0
        self._refresh(states)

    def _refresh(self, states, hosts=()) -> None:
        """Exactify and summarize every shard, then cross to the host once
        with the epoch's packed vectors (``hosts``)."""
        summs = []
        self._st = []
        for s, shard in enumerate(self._store.shards):
            st, summ = _fused_partial(
                shard.x, self._qs_of[s], states[s], self._pools[s],
                cfg=self._cfg, d=shard.d, log_term=self._plan.log_term,
                prior_weight=self._prior_weight, gid_base=s * self._stride)
            self._st.append(st)
            summs.append(summ)
        stepped = [h for h in hosts if h is not None]
        got, per_shard = _to_host_shards(summs, self._scale, stepped)
        if hosts:
            self._host = sh.take_hosts(self._host, hosts, got)
        self.shard_coord_ops = per_shard.coord_ops.sum(axis=1)
        self.shard_rounds = per_shard.rounds.max(axis=1)
        self._snap = _merge_shard_partials(per_shard)

    @property
    def _n_surv(self) -> np.ndarray:
        return self._host[:, :self.Q].astype(np.int64)

    def _apply_force_done(self, mask) -> None:
        self._st = [_force_done(st, mask) for st in self._st]
        self._host[:, :self.Q] = np.where(self._retired[None], 0,
                                          self._host[:, :self.Q])

    def _epoch_extra(self) -> dict:
        return {"width": int(self._st[0].width),
                "n_surv": int(self._n_surv.max(initial=0)),
                "R": self._last_R, "shards": self._S}

    def _epoch_launches(self, d_rounds: int) -> int:
        return self._launches      # one a stepped shard

    def _step_impl(self) -> bool:
        active_q = ~self.done
        n_surv = self._n_surv
        need = int(n_surv[:, active_q].max(initial=1))
        W = self._st[0].width
        # at most halving, as FusedSession.step
        W_new = max(bucket_width(need, floor=self._plan.floor_w, current=W),
                    W // 2)
        states = self._st
        if W_new < W:
            states = [compact_frontier(st, W_new=W_new) for st in states]
        R = sh.realloc_R(self._plan, self._W0, n_surv,
                      np.broadcast_to(active_q, n_surv.shape))
        R = self._deadline_R(R)
        states, hosts = sh.fused_epoch(
            self._store, self._qs_of, states, self._pools, self._samplers,
            self._host, cfg=self._cfg, plan=self._plan, R=R,
            impl=self._impl, eliminate=self._eliminate,
            prior_weight=self._prior_weight)
        self._launches = sum(h is not None for h in hosts)
        self._rounds_spent += R
        self._last_R = R
        self.epochs += 1
        self._refresh(states, hosts)
        return not self.done.all()


class ShardedSparseSession(RaceSession):
    """Sharded sparse: the per-round driver at δ/S on every shard, in
    bounded-round chunks (one chunk = one scheduler epoch); each snapshot
    merges the shards' partial views."""

    kind = "sharded_sparse"
    kernel = "block_pull_multi"

    def __init__(self, store, queries, rng=0, *, cfg: BMOConfig,
                 eliminate: bool = True, priors=None,
                 prior_weight: float = 0.0, chunk_rounds: int = 0,
                 obs=None, sid: Optional[str] = None, coord_samplers=None):
        q_idx, q_val, q_nnz = queries
        cfg = sh._shard_delta(cfg, store.n_shards)
        samplers = (list(coord_samplers) if coord_samplers is not None
                    else sh.shard_samplers(rng, store.devices,
                                           default_coord_sampler))
        if priors is None:
            priors = [s.prior_var for s in store.shards]
        self._fns = [
            make_sparse_rounds_race(
                sh_.indices, sh_.values, sh_.nnz, sh_.alive, priors[s],
                q_idx, q_val, q_nnz, samplers[s], cfg=cfg, d=store.d,
                eliminate=eliminate, prior_weight=prior_weight)
            for s, sh_ in enumerate(store.shards)]
        super().__init__(int(self._fns[0].exact_cost.shape[0]), cfg.k,
                         obs=obs, sid=sid)
        self._cfg, self._S, self._stride = cfg, store.n_shards, store.stride
        self._chunk = chunk_rounds or 2 * max(cfg.epoch_rounds, 1)
        self._max_rounds = self._fns[0].max_rounds
        self._rounds_spent = 0
        self._ingest([fns.init() for fns in self._fns])

    def _ingest(self, states) -> None:
        summs, self._st = [], []
        for s, (fns, st) in enumerate(zip(self._fns, states)):
            st, summ = _rounds_partial(fns, st, self._cfg.k,
                                       gid_base=s * self._stride)
            self._st.append(st)
            summs.append(summ)
        _, per_shard = _to_host_shards(summs)
        self.shard_coord_ops = per_shard.coord_ops.sum(axis=1)
        self.shard_rounds = per_shard.rounds.max(axis=1)
        self._snap = _merge_shard_partials(per_shard)

    def _apply_force_done(self, mask) -> None:
        self._st = [_force_done(st, mask) for st in self._st]

    def _epoch_extra(self) -> dict:
        return {"R": self._chunk, "shards": self._S}

    def _epoch_launches(self, d_rounds: int) -> int:
        return max(int(d_rounds), 1) * self._S

    def _step_impl(self) -> bool:
        states = []
        for fns, st in zip(self._fns, self._st):
            limit = st.round_no + self._chunk
            while fns.active(st) and st.round_no < limit:
                st = fns.body(st)
            states.append(st)
        self._rounds_spent += self._chunk
        self.epochs += 1
        self._ingest(states)
        return not self.done.all()


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------


def make_session(store, queries, rng=0, *, cfg: Optional[BMOConfig] = None,
                 impl: str = "auto", eliminate: bool = True,
                 warm_start: bool = True, prior_hint=None,
                 chunk_rounds: int = 0, obs=None,
                 sid: Optional[str] = None,
                 deadline_ms: Optional[float] = None,
                 round_ms: Optional[float] = None,
                 block_sampler: Optional[BlockSampler] = None,
                 coord_sampler: Optional[CoordSampler] = None,
                 block_samplers=None, coord_samplers=None) -> RaceSession:
    """The resumable session for ``store``'s box and layout — the anytime
    twin of ``index_knn`` (same priors, same δ accounting). ``rng`` (a seed
    or a ``torch.Generator`` on the store's device) feeds the default
    samplers; ``block_sampler`` / ``coord_sampler`` replace them, and on a
    sharded store ``block_samplers`` / ``coord_samplers`` give shard s's at
    s. ``obs``/``sid`` select the observability context and trace id of
    the session's epoch spans. ``deadline_ms`` with ``round_ms`` turns on
    deadline-aware round selection (``RaceSession.set_deadline``)."""
    cfg = cfg if cfg is not None else store.cfg
    if cfg.k > store.n_live:
        raise ValueError(
            f"k={cfg.k} exceeds the index's {store.n_live} live slots — "
            "tombstoned slots can never be returned")
    w = store.prior_weight if (warm_start or prior_hint is not None) else 0.0
    if hasattr(store, "shards"):
        Q = (queries[0] if isinstance(queries, tuple) else queries).shape[0]
        priors = (None if prior_hint is None
                  else sh.shard_priors(store, prior_hint, Q))
        if store.kind == "sparse":
            sess = ShardedSparseSession(
                store, queries, rng, cfg=cfg, eliminate=eliminate,
                priors=priors, prior_weight=w, chunk_rounds=chunk_rounds,
                obs=obs, sid=sid, coord_samplers=coord_samplers)
        else:
            sess = ShardedFusedSession(
                store, queries, rng, cfg=cfg, impl=impl, eliminate=eliminate,
                priors=priors, prior_weight=w, obs=obs, sid=sid,
                block_samplers=block_samplers)
    elif store.kind == "sparse":
        sess = SparseRoundsSession(
            store, queries, rng, cfg=cfg, eliminate=eliminate,
            prior=prior_hint, prior_weight=w, chunk_rounds=chunk_rounds,
            obs=obs, sid=sid, coord_sampler=coord_sampler)
    else:
        sess = FusedSession(store, queries, rng, cfg=cfg, impl=impl,
                            eliminate=eliminate, prior=prior_hint,
                            prior_weight=w, obs=obs, sid=sid,
                            block_sampler=block_sampler)
    if deadline_ms is not None:
        sess.set_deadline(deadline_ms, round_ms)
    return sess
