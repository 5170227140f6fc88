"""The port's request plane (``repro_torch.serve``) on the CPU: every
non-sharded scenario of the reference's ``tests/test_plane.py`` run on the
port, the scale policies, and one plane-level parity test against the
reference's plane on replayed draws.

No test depends on how fast the machine is: a deadline test freezes or
advances the plane module's clock (``FakeClock``), or uses a deadline that
has already passed when the plane looks.
"""
import time

import jax
import numpy as np
import pytest

from repro.api import EffortBudget as JaxEffortBudget
from repro.api import Index as JaxIndex
from repro.configs.base import BMOConfig as JaxBMOConfig
from repro.data import synthetic as jsynthetic
from repro.serve.plane import RequestPlane as JaxRequestPlane
from repro_torch.api import (Deadline, EffortBudget, Index, QuerySpec,
                             ServeStats)
from repro_torch.configs.base import BMOConfig
from repro_torch.core.datasets import SparseDataset
from repro_torch.data.synthetic import (clustered_sparse,
                                        make_knn_benchmark_data)
from repro_torch.index.store import IndexStore
from repro_torch.serve import PlaneConfig, RequestPlane
from repro_torch.serve import plane as plane_mod

from test_torch_replay import carry, replay_sampler


class FakeClock:
    """The plane module's clock, held by the test: ``monotonic`` returns
    ``now`` (seconds), ``perf_counter`` the real one."""

    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        return self.now

    perf_counter = staticmethod(time.perf_counter)


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(plane_mod, "time", c)
    return c


def _dense_cfg(**kw):
    base = dict(k=4, delta=0.01, block=64, batch_arms=16, pulls_per_round=2,
                metric="l2")
    base.update(kw)
    return BMOConfig(**base)


def _dense_index(n=256, d=512, Q=4, seed=1, **kw):
    corpus, queries = make_knn_benchmark_data("dense", n, d, Q, seed=seed)
    return Index.build(corpus, _dense_cfg(**kw), 0, device="cpu"), queries


def _sparse_index():
    corpus = clustered_sparse(200, 2048, seed=4)
    ds = SparseDataset.build(corpus)
    queries = tuple(a[:4].numpy() for a in (ds.indices, ds.values, ds.nnz))
    cfg = BMOConfig(k=3, delta=0.01, block=1, batch_arms=16,
                    pulls_per_round=8, init_pulls=16, metric="l1",
                    sparse=True)
    return Index.build(corpus, cfg, 0, device="cpu"), queries


def _prefix_ok(partial, full):
    """The anytime contract: certified entries are exact (CI 0), ordered,
    and exactly the prefix of the full-certification answer."""
    Q, k = partial.indices.shape
    for q in range(Q):
        cc = int(partial.certified_count[q])
        assert 0 <= cc <= k
        assert partial.indices[q][:cc].tolist() == \
            full.indices[q][:cc].tolist(), (q, cc)
        np.testing.assert_allclose(partial.values[q][:cc],
                                   full.values[q][:cc], rtol=1e-5)
        assert (partial.ci_radii[q][:cc] == 0.0).all()
        if cc < k:
            assert not np.any(partial.ci_radii[q][cc:] < 0)


# ---------------------------------------------------------------------------
# anytime certified-prefix contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "rotated", "sparse"])
def test_anytime_prefix_matches_full_certification(kind):
    """For any effort cutoff, the certified prefix of the partial answer
    equals the full-certification answer's prefix."""
    if kind == "sparse":
        idx, queries = _sparse_index()
    else:
        idx, queries = _dense_index(rotate=(kind == "rotated"))
    full = RequestPlane(idx).query(queries, rng=7, cache="bypass")
    assert full.terminal and full.reason == "certified"
    assert (full.certified_count == idx.k).all()
    assert (np.diff(full.values, axis=1) >= -1e-6).all()   # sorted exact θ

    hit_partial = False
    for epochs in (1, 2, 3, 5, 8):
        res = RequestPlane(idx).query(queries, rng=7, cache="bypass",
                                      budget=EffortBudget(epochs=epochs))
        assert res.terminal
        _prefix_ok(res, full)
        if res.reason == "budget":
            hit_partial = True
            assert res.epochs <= epochs
    assert hit_partial      # at least one cutoff actually truncated a race


def test_anytime_monotonic_certified_count():
    """Streaming one ticket: certified_count never decreases, the certified
    prefix never changes once emitted, and the terminal answer certifies
    all k."""
    idx, queries = _dense_index()
    plane = RequestPlane(idx)
    t = plane.submit(queries, rng=3, cache="bypass")
    prev = None
    seen_prefix = [[] for _ in range(t.n_queries)]
    for partial in plane.stream(t):
        cc = partial.certified_count
        if prev is not None:
            assert (cc >= prev).all(), "certified_count regressed"
        for q in range(t.n_queries):
            ids = partial.indices[q][: int(cc[q])].tolist()
            assert ids[: len(seen_prefix[q])] == seen_prefix[q], \
                "certified prefix was reordered"
            seen_prefix[q] = ids
        prev = cc
    assert t.result.reason == "certified"
    assert (t.result.certified_count == idx.k).all()


# ---------------------------------------------------------------------------
# scheduler termination
# ---------------------------------------------------------------------------

def test_deadline_expiry_returns_certified_prefix(clock):
    """A wall-clock deadline terminates with reason='deadline' and a valid
    certified prefix. The clock passes the deadline after the first
    epoch."""
    idx, queries = _dense_index(n=512, d=1024)
    full = RequestPlane(idx).query(queries, rng=11, cache="bypass")
    plane = RequestPlane(idx)
    t = plane.submit(queries, rng=11, cache="bypass",
                     deadline=Deadline(ms=1.0))
    plane.step()
    assert not t.terminal and t.epochs == 1
    clock.now = 1.0
    plane.drain()
    res = t.result
    assert res.terminal and res.reason == "deadline" and res.epochs == 1
    assert plane.stats.plane_deadline_exits == 1
    _prefix_ok(res, full)
    assert (res.certified_count < idx.k).any()   # one epoch certifies < all


def test_effort_budget_coord_ops():
    idx, queries = _dense_index()
    plane = RequestPlane(idx)
    res = plane.query(queries, rng=2, cache="bypass",
                      budget=EffortBudget(coord_ops=1.0))
    assert res.terminal and res.reason == "budget"
    assert plane.stats.plane_budget_exits == 1


def test_queued_ticket_deadline_expires_without_racing(clock):
    """A ticket whose deadline lapses while still queued terminates with an
    empty certified prefix instead of racing a dead request."""
    idx, queries = _dense_index()
    plane = RequestPlane(idx, PlaneConfig(max_active_groups=1))
    t1 = plane.submit(queries, rng=0, cache="bypass")
    t2 = plane.submit(queries + 1.0, rng=1, cache="bypass",
                      deadline=Deadline(ms=0.5))
    clock.now = 0.002
    plane.drain()
    assert t1.result.reason == "certified"
    assert t2.result.reason == "deadline"
    assert (t2.result.certified_count == 0).all()
    assert t2.epochs == 0


# ---------------------------------------------------------------------------
# fairness / backpressure
# ---------------------------------------------------------------------------

def test_fairness_one_adversarial_heavy_tenant():
    """Admission round-robins across tenants: a light tenant arriving after
    a heavy tenant's flood still gets into the very next race group."""
    idx, queries = _dense_index()
    plane = RequestPlane(idx, PlaneConfig(max_group_queries=8,
                                          max_active_groups=1))
    heavy = [plane.submit(queries + i, tenant="heavy", rng=i,
                          cache="bypass") for i in range(6)]
    light = plane.submit(queries + 100.0, tenant="light", rng=99,
                         cache="bypass")
    plane.step()
    assert light.admitted_at is not None
    assert heavy[0].admitted_at is not None
    assert all(t.admitted_at is None for t in heavy[1:])
    plane.drain()
    assert light.finished_at <= min(t.finished_at for t in heavy[2:])
    assert all(t.result.reason == "certified" for t in heavy + [light])


def test_backpressure_sheds_with_reason():
    idx, queries = _dense_index()
    plane = RequestPlane(idx, PlaneConfig(max_queue=2))
    tickets = [plane.submit(queries + i, rng=i, cache="bypass")
               for i in range(5)]
    shed = [t for t in tickets if t.status == "shed"]
    assert len(shed) == 3 and all(t.reason == "queue_full" for t in shed)
    assert all(t.result.terminal and t.result.reason == "shed"
               for t in shed)
    assert plane.stats.plane_shed == 3
    plane.drain()
    assert all(t.result.reason == "certified"
               for t in tickets if t.status != "shed")


# ---------------------------------------------------------------------------
# mutation fence
# ---------------------------------------------------------------------------

def test_mutation_fence_complete_serves_old_epoch():
    """on_mutation='complete': an in-flight ticket finishes against the
    (immutable) pre-mutation store, its result tagged with that epoch, and
    it does not poison the new epoch's query cache."""
    idx, queries = _dense_index()
    plane = RequestPlane(idx, PlaneConfig(on_mutation="complete"))
    epoch0 = idx.epoch
    t = plane.submit(queries, rng=1, cache="bypass")
    plane.step()                          # ticket racing against epoch0
    idx.insert(np.asarray(queries, np.float32))   # epoch bump mid-race
    assert idx.epoch == epoch0 + 1
    plane.drain()
    assert t.result.reason == "certified"
    assert t.result.epoch == epoch0       # completed against the old store
    assert plane.stats.plane_readmitted == 0
    fresh = plane.query(queries, rng=5)
    assert fresh.epoch == idx.epoch
    assert float(np.sum(fresh.coord_ops)) > 0   # raced, not cache-served


def test_mutation_fence_readmit():
    """on_mutation='readmit': a mutation mid-race re-admits in-flight
    tickets against the new store — a deleted id is never served and no
    result mixes epochs."""
    idx, queries = _dense_index()
    plane = RequestPlane(idx, PlaneConfig(on_mutation="readmit"))
    epoch0 = idx.epoch
    probe = RequestPlane(idx).query(queries, rng=9, cache="bypass")
    top0 = int(probe.indices[0, 0])
    t = plane.submit(queries, rng=1, cache="bypass")
    plane.step()                          # in flight against epoch0
    idx.delete([top0])
    assert idx.epoch == epoch0 + 1
    plane.drain()
    assert t.result.reason == "certified"
    assert t.result.epoch == idx.epoch    # re-raced on the new store
    assert plane.stats.plane_readmitted == 1
    assert top0 not in set(t.result.indices.ravel().tolist())
    fresh = RequestPlane(idx).query(queries, rng=2, cache="bypass")
    assert set(t.result.indices[0].tolist()) == \
        set(fresh.indices[0].tolist())


# ---------------------------------------------------------------------------
# blocking shim parity + stats schema
# ---------------------------------------------------------------------------

def test_blocking_shim_matches_index_query_and_caches():
    idx, queries = _dense_index()
    plane = RequestPlane(idx)
    res = plane.query(queries, rng=1)
    ref = idx.query(queries, 1, cache="bypass")
    for q in range(queries.shape[0]):
        assert set(res.indices[q].tolist()) == set(ref.indices[q].tolist())
    assert float(np.sum(res.coord_ops)) > 0
    # an exact repeat is served from the shared LRU at zero cost
    res2 = plane.query(queries, rng=8)
    assert float(np.sum(res2.coord_ops)) == 0.0
    np.testing.assert_array_equal(res.indices, res2.indices)
    st = plane.stats
    assert st.cache_hits == queries.shape[0]
    # partial (deadline/budget) results never poison the cache
    plane.query(queries + 1.0, rng=2, budget=EffortBudget(epochs=1))
    assert plane.stats.cache_entries == st.cache_entries


def test_serve_stats_schema_and_legacy_keys():
    from repro_torch.api.spec import SCHEMA_VERSION
    assert SCHEMA_VERSION == 6
    idx, queries = _dense_index()
    plane = RequestPlane(idx)
    plane.query(queries, rng=1)
    d = plane.stats.as_dict()
    assert d["schema_version"] == 6
    for f in ("plane_submitted", "plane_shed", "plane_queue_depth",
              "plane_latency_p99_ms", "obs_events", "obs_event_drops",
              "obs_epoch_ms", "obs_latency_ms"):
        assert f in d
    st = plane.stats
    assert st["knn_races"] == st.races == 1
    assert st["knn_cache_misses"] == st.cache_misses
    assert "knn_cache_hits" in st
    legacy = ServeStats()
    assert legacy["knn_near_hits"] == 0
    with pytest.raises(KeyError):
        legacy["nope"]


def test_plane_config_validation_and_what_is_not_ported():
    with pytest.raises(ValueError, match="max_active_groups"):
        PlaneConfig(max_active_groups=0)
    with pytest.raises(ValueError, match="on_mutation"):
        PlaneConfig(on_mutation="nope")
    with pytest.raises(ValueError, match="max_queue"):
        PlaneConfig(max_queue=0)
    idx, queries = _dense_index()
    with pytest.raises(ValueError, match="audit_rate"):
        PlaneConfig(audit_rate=1.5)
    with pytest.raises(ValueError, match="audit_reservoir"):
        PlaneConfig(audit_reservoir=0)
    # namespace routing (once refused as Queue 1 item 8) needs a router
    with pytest.raises(ValueError, match="an index, a router"):
        RequestPlane()
    with pytest.raises(ValueError, match="without a router"):
        RequestPlane(idx).submit(queries, namespace="users")


def test_audited_plane_serves_what_an_unaudited_plane_serves():
    """A plane with ``audit_rate=0.5`` answers every ticket as a plane
    without the auditor does (sampling and the oracle change no answer);
    its idle steps audit the sampled tickets, all clean."""
    idx, queries = _dense_index()
    results = []
    for cfg in (PlaneConfig(), PlaneConfig(audit_rate=0.5, audit_seed=3)):
        plane = RequestPlane(Index.open(idx.store), cfg)
        tickets = [plane.submit(queries[i:i + 2], rng=i, tenant=f"t{i}",
                                cache="bypass",
                                **({"budget": EffortBudget(epochs=3)}
                                   if i == 1 else {}))
                   for i in range(3)]
        plane.drain()
        while plane.auditor is not None and plane.auditor.pending:
            plane.step()                      # idle steps audit
        results.append([(t.reason, t.result.indices.copy(),
                         t.result.certified_count.copy()) for t in tickets])
        if plane.auditor is not None:
            s = plane.auditor.summary()
            assert s["offered"] == 2 and s["skipped"]["uncertified"] == 1
            assert plane.stats.audit_sampled == 2 * s["sampled_tickets"]
            assert plane.stats.audit_mismatches == 0
    for (r0, i0, c0), (r1, i1, c1) in zip(*results):
        assert r0 == r1
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(c0, c1)


def test_deadline_overflow_reaches_non_head_tickets(clock):
    """With every group slot busy, a deadline ticket queued behind its own
    tenant's unbounded ticket still reaches the overflow slot."""
    idx, queries = _dense_index()
    plane = RequestPlane(idx, PlaneConfig(max_active_groups=1))
    blocker = plane.submit(queries, rng=0, cache="bypass")
    plane.step()                          # the only slot is now busy
    unbounded = plane.submit(queries + 1.0, tenant="t", rng=1,
                             cache="bypass")
    urgent = plane.submit(queries + 2.0, tenant="t", rng=2, cache="bypass",
                          deadline=Deadline(ms=30000.0))
    plane.step()
    assert urgent.admitted_at is not None     # took the overflow slot
    assert unbounded.admitted_at is None      # still parked behind the slot
    plane.drain()
    assert all(t.terminal for t in (blocker, unbounded, urgent))


def test_requeue_preserves_same_tenant_fifo():
    idx, queries = _dense_index()
    plane = RequestPlane(idx, PlaneConfig(max_active_groups=1))
    t1 = plane.submit(queries, rng=0, k=2, cache="bypass")
    t2 = plane.submit(queries, rng=1, k=3, cache="bypass")
    t3 = plane.submit(queries, rng=2, k=4, cache="bypass")
    plane.step()                          # launches t1's bucket only
    assert t1.admitted_at is not None
    queued_ids = [e.ticket.id for e in plane._queues[("default", None)]]
    assert queued_ids == [t2.id, t3.id]   # FIFO survives the requeue
    plane.drain()
    assert [t.result.reason for t in (t1, t2, t3)] == ["certified"] * 3


def test_submit_validates_unraceable_specs():
    idx, queries = _dense_index()
    plane = RequestPlane(idx)
    with pytest.raises(ValueError, match="rounds"):
        plane.submit(queries, mode="rounds")
    with pytest.raises(ValueError, match="live slots"):
        plane.submit(queries, k=10000)
    with pytest.raises(ValueError, match="dense"):
        plane.submit((queries, queries, queries[:, 0]))


def test_launch_failure_sheds_instead_of_orphaning():
    """A race that becomes unlaunchable between submit and admission (here:
    deletes drop n_live below k) sheds its tickets with a reason."""
    idx, queries = _dense_index()
    plane = RequestPlane(idx)
    t1 = plane.submit(queries, rng=0, cache="bypass")
    t2 = plane.submit(queries + 1.0, rng=1, cache="bypass")
    idx.delete(list(range(254)))          # 2 live slots < k=4
    plane.drain()
    assert t1.terminal and t2.terminal
    assert t1.status == "shed" and t1.reason.startswith("rejected")
    assert "live slots" in t1.reason


def test_query_spec_deadline_budget_validation():
    with pytest.raises(ValueError, match="Deadline"):
        QuerySpec(deadline=5.0)
    with pytest.raises(ValueError, match="EffortBudget"):
        QuerySpec(budget=3)
    with pytest.raises(ValueError, match="deadline"):
        Deadline(ms=0)
    with pytest.raises(ValueError, match="epochs or coord_ops"):
        EffortBudget()
    with pytest.raises(ValueError, match="cache policy"):
        QuerySpec(cache="nope")
    assert not QuerySpec(deadline=Deadline(ms=5.0)).cacheable
    assert QuerySpec().cacheable


# ---------------------------------------------------------------------------
# autoscaling hints
# ---------------------------------------------------------------------------

def _stats(queue=0, active=0, p95=None, replicas=1, shard_ops=None):
    return ServeStats(replicas=replicas, shard_coord_ops=shard_ops,
                      plane_queue_depth=queue, plane_active=active,
                      plane_latency_p95_ms=p95)


def test_scale_policy_scales_out_on_sustained_queue():
    from repro_torch.serve.scale import QueueDepthPolicy
    pol = QueueDepthPolicy(high_queue=8, sustain=3, cooldown=2)
    decisions = [pol.recommend(_stats(queue=q)) for q in (12, 15, 11)]
    assert [d.action for d in decisions[:2]] == ["none", "none"]
    assert decisions[2].action == "add_replicas" and decisions[2].value == 2
    assert pol.recommend(_stats(queue=20)).action == "none"
    assert pol.recommend(_stats(queue=20)).action == "none"
    assert pol.recommend(_stats(queue=0)).action == "none"


def test_scale_policy_latency_slo_and_scale_in():
    from repro_torch.serve.scale import QueueDepthPolicy
    pol = QueueDepthPolicy(high_queue=1000, p95_target_ms=50.0, sustain=2,
                           cooldown=0)
    assert pol.recommend(_stats(p95=80.0)).action == "none"
    d = pol.recommend(_stats(p95=90.0))
    assert d.action == "add_replicas" and d.value == 2
    pol2 = QueueDepthPolicy(sustain=2, cooldown=0)
    assert pol2.recommend(_stats(replicas=2)).action == "none"
    d2 = pol2.recommend(_stats(replicas=2))
    assert d2.action == "add_replicas" and d2.value == 1


def test_scale_policy_prefers_reshard_on_imbalance():
    from repro_torch.serve.scale import QueueDepthPolicy
    pol = QueueDepthPolicy(high_queue=4, sustain=1, imbalance=2.0)
    d = pol.recommend(_stats(queue=9, shard_ops=[100.0, 0.0]))
    assert d.action == "reshard" and d.value == 4
    pol2 = QueueDepthPolicy(high_queue=4, sustain=1, imbalance=2.0)
    d2 = pol2.recommend(_stats(queue=9, shard_ops=[50.0, 50.0]))
    assert d2.action == "add_replicas"


# ---------------------------------------------------------------------------
# plane-level parity with the reference
# ---------------------------------------------------------------------------

def _replayed(idx):
    """The port's handle racing on the reference's draws: a ticket's integer
    ``rng`` s becomes the replay of ``PRNGKey(s)``, as the reference's plane
    is given it."""
    race = idx.race

    def replayed_race(queries, rng=None, **kw):
        return race(queries, None,
                    block_sampler=replay_sampler(jax.random.PRNGKey(rng)),
                    **kw)
    idx.race = replayed_race
    return idx


def _view(ticket, plane):
    """What a ticket shows after a step: its status and reason, and each
    row's certified prefix (ids and values)."""
    res = ticket.result if ticket.terminal else plane.poll(ticket)
    rows = []
    for q in range(res.indices.shape[0]):
        cc = int(res.certified_count[q])
        rows.append((res.indices[q][:cc].tolist(), res.values[q][:cc]))
    return ticket.status, ticket.reason, res.reason, ticket.epochs, rows


def test_plane_makes_the_reference_decisions_at_every_step():
    """The same submissions through the reference's plane and the port's,
    on the same store and the reference's draws: after every ``step()``
    every ticket has the same status, terminal reason, epochs and certified
    prefix (values at fp32 tolerance). The submissions coalesce into padded
    groups (5 rows → 8), carry effort budgets, tenants, k overrides, an
    exact repeat served from the cache and near repeats raced with seeded
    priors."""
    corpus, queries = jsynthetic.make_knn_benchmark_data("dense", 256, 512,
                                                         6, seed=1)
    jcfg = JaxBMOConfig(k=4, delta=0.01, block=64, batch_arms=16,
                        pulls_per_round=2, metric="l2")
    jidx = JaxIndex.build(corpus, jcfg, jax.random.PRNGKey(0))
    idx = _replayed(Index.open(IndexStore.from_arrays(
        *carry(jidx.store), device="cpu")))
    near = queries[:2] + np.float32(1e-3)
    waves = [
        [dict(rows=slice(0, 2), rng=3, tenant="a"),
         dict(rows=slice(2, 3), rng=4, tenant="b", budget={"epochs": 2}),
         dict(rows=slice(3, 5), rng=5, tenant="a", k=3, cache="bypass")],
        [dict(rows=slice(5, 6), rng=6, tenant="b",
              budget={"coord_ops": 40_000.0})],
        [dict(rows=slice(0, 2), rng=7, tenant="c"),          # exact repeat
         dict(rows=near, rng=8, tenant="c")],                 # near repeat
    ]
    planes = (JaxRequestPlane(jidx), RequestPlane(idx))
    tickets = ([], [])
    for wave in waves:
        for sub in wave:
            sub = dict(sub)
            rows = sub.pop("rows")
            q = queries[rows] if isinstance(rows, slice) else rows
            seed = sub.pop("rng")
            budget = sub.pop("budget", None)
            tickets[0].append(planes[0].submit(
                q, rng=jax.random.PRNGKey(seed), **sub,
                budget=budget and JaxEffortBudget(**budget)))
            tickets[1].append(planes[1].submit(
                q, rng=seed, **sub, budget=budget and EffortBudget(**budget)))
        steps = 0
        while planes[0].active or planes[1].active:
            assert (planes[0].step() > 0) == (planes[1].step() > 0)
            steps += 1
            for jt, t in zip(*tickets):
                want, got = _view(jt, planes[0]), _view(t, planes[1])
                assert got[:4] == want[:4], (steps, t.id)
                for (wi, wv), (gi, gv) in zip(want[4], got[4]):
                    assert gi == wi, (steps, t.id)
                    np.testing.assert_allclose(gv, wv, rtol=2e-4, atol=1e-5)
    reasons = [t.result.reason for t in tickets[1]]
    assert reasons == ["certified", "budget", "certified", "budget",
                       "certified", "certified"]
    assert float(np.sum(tickets[1][4].result.coord_ops)) == 0.0   # cached
    st, jst = planes[1].stats, planes[0].stats
    assert st.near_hits == jst.near_hits == 2
    assert (st.cache_hits, st.races) == (jst.cache_hits, jst.races)
