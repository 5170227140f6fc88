"""The port's shadow δ-audit, SLO alerting, exporters and health document
(``repro_torch.obs``), the recall guard (``repro_torch.serve.scale``) and
the audited request plane, held against the JAX package on the CPU.

* Bounds: ``wilson_upper`` and ``clopper_pearson_upper`` equal to the
  reference's to 1e-12 over a grid.
* The oracle: ``exact_topk`` ids equal to the reference's, θ within the
  plain ``pairwise_dist``'s stated error (ℓ2: 1e-4 relative plus
  1e-6·(‖q‖² + ‖x‖²)/d; sparse ℓ1: rtol 1e-5), and ``check_topk``'s
  decisions (row mismatches, bad positions)
  equal, for dense, rotated and sparse stores with tombstones, with right,
  wrong, dead, invalid and duplicate served ids.
* The auditor: one seed samples the same tickets in both packages;
  reservoir drops and stale-epoch skips counted alike; a bundle written by
  either package reads in the other's ``load_bundle`` and replays there.
* SLOs and exporters: the engine's fire and resolve edges equal to the
  reference's on one source series; ``prometheus_text`` byte-equal after
  the same registry operations; ``health_snapshot``'s keys equal; the
  recall guard's fallback → retune chain on the live handle.
* The plane: an injected corruption below the plane is caught, bundled and
  reproduced by ``tools/torch_replay_audit.py`` after a save and load; the
  oracle never runs while a group is racing.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.api import Index as JaxIndex
from repro.api import ServeStats as JaxServeStats
from repro.configs.base import BMOConfig as JaxBMOConfig
from repro.core.datasets import SparseDataset as JaxSparseDataset
from repro.data import synthetic as jsynthetic
from repro.index import mutable as jmutable
from repro.index.builder import build_index as jax_build_index
from repro.obs import ObsContext as JaxObsContext
from repro.obs import audit as jaudit
from repro.obs import export as jexport
from repro.obs import health as jhealth
from repro.obs import slo as jslo
from repro.obs.registry import MetricsRegistry as JaxMetricsRegistry
from repro.serve import scale as jscale
from repro.serve.plane import PlaneConfig as JaxPlaneConfig
from repro.serve.plane import RequestPlane as JaxRequestPlane
from repro_torch.api import Index, QuerySpec, ServeStats
from repro_torch.configs.base import BMOConfig
from repro_torch.index.store import IndexStore
from repro_torch.obs import ObsContext
from repro_torch.obs import audit
from repro_torch.obs import export
from repro_torch.obs import health
from repro_torch.obs import slo
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serve import PlaneConfig, RequestPlane
from repro_torch.serve import scale
from repro_torch.tune import TunedConfig

from test_torch_replay import carry, triplet

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# binomial bounds
# ---------------------------------------------------------------------------

GRID = [(f, n) for n in (0, 1, 2, 7, 20, 100, 512, 2000)
        for f in sorted({0, 1, n // 3, n // 2, max(n - 1, 0), n}) if f <= n]


@pytest.mark.parametrize("confidence", [0.5, 0.9, 0.95, 0.99])
def test_error_bounds_are_the_reference_bounds(confidence):
    for f, n in GRID:
        for ours, theirs in ((audit.wilson_upper, jaudit.wilson_upper),
                             (audit.clopper_pearson_upper,
                              jaudit.clopper_pearson_upper)):
            assert abs(ours(f, n, confidence)
                       - theirs(f, n, confidence)) <= 1e-12, (f, n)
    # 0 failures in 512 rows clears δ = 0.01 at 95%
    assert audit.wilson_upper(0, 512) < 0.01
    with pytest.raises(ValueError):
        audit.wilson_upper(3, 2)


# ---------------------------------------------------------------------------
# the exact oracle
# ---------------------------------------------------------------------------

DEAD = np.array([3, 17, 40, 41, 90])


def _stores(kind, n=160, d=96, Q=6, seed=5):
    """Reference and port stores of one corpus with DEAD tombstoned, and
    the queries (sparse: the padded triplet)."""
    if kind == "sparse":
        corpus, q = jsynthetic.make_knn_benchmark_data("sparse", n, d, Q,
                                                       seed=seed)
        jstore = jax_build_index(JaxSparseDataset.build(corpus),
                                 JaxBMOConfig(k=4, block=1, metric="l1",
                                              sparse=True),
                                 jax.random.PRNGKey(0))
        queries = triplet(JaxSparseDataset.build(q))
    else:
        corpus, queries = jsynthetic.make_knn_benchmark_data(
            "dense", n, d, Q, seed=seed)
        jstore = jax_build_index(corpus, JaxBMOConfig(
            k=4, block=32, rotate=kind == "rotated"), jax.random.PRNGKey(0))
    jstore = jmutable.delete(jstore, DEAD)
    return jstore, IndexStore.from_arrays(*carry(jstore), device="cpu"), \
        queries


def _theta_tol(kind, jstore, queries):
    """θ's tolerance against the reference's gathered differences: sparse
    ℓ1 rtol 1e-5 (fp32 sums in another order); dense ℓ2 the plain
    ``pairwise_dist``'s contract, 1e-4 relative plus 1e-6·(‖q‖² + ‖x‖²)
    over d (its norm expansion cancels)."""
    if kind == "sparse":
        return dict(rtol=1e-5, atol=1e-7)
    qs = np.asarray(jstore.prepare_queries(np.asarray(queries)), np.float64)
    x = np.asarray(jstore.x, np.float64)
    norms = (qs ** 2).sum(1).max() + (x ** 2).sum(1).max()
    return dict(rtol=1e-4, atol=1e-6 * norms / jstore.d)


def _served(exact_ids):
    """Served ids: row 0 right, row 1 a duplicate, row 2 a far slot, row 3
    a dead slot, row 4 −1, row 5 the exact ids reversed (still right)."""
    s = exact_ids.copy()
    s[1, 1] = s[1, 0]
    s[2, 0] = int(np.setdiff1d(np.arange(150), np.r_[s[2], DEAD])[-1])
    s[3, 2] = DEAD[0]
    s[4, 3] = -1
    s[5] = s[5][::-1]
    return s


@pytest.mark.parametrize("kind", ["dense", "rotated", "sparse"])
def test_oracle_and_audit_decisions_are_the_reference(kind):
    jstore, store, queries = _stores(kind)
    k = 4
    want_ids, want_vals = jaudit.exact_topk(jstore, queries, k)
    ids, vals = audit.exact_topk(store, queries, k)
    np.testing.assert_array_equal(ids, want_ids)
    tol = _theta_tol(kind, jstore, queries)
    np.testing.assert_allclose(vals, want_vals, **tol)
    assert not np.isin(ids, DEAD).any()
    served = _served(want_ids)
    want = jaudit.check_topk(jstore, queries, served, k)
    got = audit.check_topk(store, queries, served, k)
    np.testing.assert_array_equal(got.row_mismatch, want.row_mismatch)
    np.testing.assert_array_equal(got.bad, want.bad)
    np.testing.assert_array_equal(got.exact_ids, want.exact_ids)
    assert got.row_mismatch.tolist() == [False, True, True, True, True,
                                         False]
    fin = np.isfinite(want.served_theta)
    np.testing.assert_array_equal(np.isfinite(got.served_theta), fin)
    np.testing.assert_allclose(got.served_theta[fin], want.served_theta[fin],
                               **tol)
    np.testing.assert_allclose(
        audit.exact_theta_of(store, queries, served)[fin],
        got.served_theta[fin], rtol=0, atol=0)


def test_oracle_chunks_and_small_stores(monkeypatch):
    jstore, store, queries = _stores("rotated")
    whole = audit.check_topk(store, queries, _served(
        jaudit.exact_topk(jstore, queries, 4)[0]), 4)
    monkeypatch.setattr(audit, "DENSE_CHUNK_ELEMS", 6 * 7)   # 7-row chunks
    chunked = audit.check_topk(store, queries, whole.exact_ids, 4)
    np.testing.assert_array_equal(chunked.exact_ids, whole.exact_ids)
    np.testing.assert_array_equal(chunked.exact_vals, whole.exact_vals)
    assert not chunked.row_mismatch.any()
    # more neighbours asked for than live slots: −1 / inf past the count
    big_ids, big_vals = audit.exact_topk(store, queries, store.n_live + 3)
    want_ids, _ = jaudit.exact_topk(jstore, queries, store.n_live + 3)
    np.testing.assert_array_equal(big_ids, want_ids)
    assert (big_ids[:, -3:] == -1).all() and np.isinf(big_vals[:, -3:]).all()


# ---------------------------------------------------------------------------
# the auditor
# ---------------------------------------------------------------------------

def _handles(kind="dense"):
    jstore, store, queries = _stores(kind)
    return JaxIndex.open(jstore), Index.open(store), queries


def _offer_all(aud, queries, ids, n, tenants=("a", "b")):
    out = []
    for i in range(n):
        out.append(aud.offer(trace_id=f"t{i}", tenant=tenants[i % 2],
                             store_epoch=0, contract="default", k=4,
                             delta=0.01, queries=queries, served_ids=ids,
                             served_vals=np.zeros(ids.shape)))
    return out


def test_one_seed_samples_the_same_tickets():
    jidx, idx, queries = _handles()
    ids = jaudit.exact_topk(jidx.store, queries, 4)[0]
    for seed in (0, 7):
        mine = _offer_all(audit.DeltaAuditor(idx, rate=0.3, seed=seed),
                          queries, ids, 60)
        theirs = _offer_all(jaudit.DeltaAuditor(jidx, rate=0.3, seed=seed),
                            queries, ids, 60)
        assert mine == theirs and 0 < sum(mine) < 60


def test_reservoir_drops_and_stale_epochs_are_counted_alike():
    jidx, idx, queries = _handles()
    ids = jaudit.exact_topk(jidx.store, queries, 4)[0]
    summaries = []
    for pkg, index in ((audit, idx), (jaudit, jidx)):
        aud = pkg.DeltaAuditor(index, rate=1.0, reservoir=2,
                               obs=(ObsContext("t") if pkg is audit
                                    else JaxObsContext("t")))
        _offer_all(aud, queries, ids, 5)
        assert aud.pending == 4 and aud.dropped == 1
        assert aud.process(1) == 1          # one audited on epoch 0
        index.delete([int(ids[0, 0])])      # the store moves on
        assert aud.flush() == 3             # the rest are stale
        s = aud.summary()
        s.pop("bundles")
        summaries.append(s)
    assert summaries[0] == summaries[1]
    assert summaries[0]["skipped"]["stale_epoch"] == 3
    assert summaries[0]["skipped"]["reservoir_full"] == 1
    assert summaries[0]["sampled_rows"] == len(queries)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bundles_read_and_replay_across_packages(tmp_path, kind, writer):
    jidx, idx, queries = _handles(kind)
    ids = jaudit.exact_topk(jidx.store, queries, 4)[0]
    bad = _served(ids)
    pkg, index = (jaudit, jidx) if writer == "jax" else (audit, idx)
    check = pkg.check_topk(index.store, queries, bad, 4)
    path = pkg.FlightRecorder(str(tmp_path)).record(
        check=check, queries=queries, served_ids=bad,
        served_vals=np.zeros(bad.shape), k=4, delta=0.01, trace_id="p0.t3",
        tenant="a", store_epoch=0, contract="tuned", store_kind=kind,
        metric=index.cfg.metric,
        tuned=TunedConfig(epoch_rounds=2, pulls_per_round=1, batch_arms=8))
    assert os.path.basename(path) == "audit-0000-p0.t3"
    (doc, arrays), (jdoc, jarrays) = (audit.load_bundle(path),
                                      jaudit.load_bundle(path))
    assert doc == jdoc and sorted(arrays) == sorted(jarrays)
    for name in arrays:
        np.testing.assert_array_equal(arrays[name], jarrays[name])
    assert doc["mismatch_rows"] == [1, 2, 3, 4]
    for mod, handle in ((audit, idx), (jaudit, jidx)):
        rep = mod.replay_bundle(handle, path)
        assert rep["reproduced"] and rep["epoch_match"]
        assert rep["exact_ids_match"]


# ---------------------------------------------------------------------------
# SLOs, exporters, health
# ---------------------------------------------------------------------------

def _series():
    """One cumulative (bad, total) series: clean, burning, recovering."""
    out, bad, total = [], 0.0, 0.0
    for t in range(0, 600, 5):
        burning = 120 <= t < 160 or 300 <= t < 310
        total += 10.0
        bad += 6.0 if burning else 0.0
        out.append((float(t), bad, total))
    return out


def test_slo_edges_are_the_reference_edges():
    rules = [(m.BurnRule(long_s=60.0, short_s=5.0, factor=10.0,
                         severity="page"),
              m.BurnRule(long_s=300.0, short_s=30.0, factor=2.0,
                         severity="ticket")) for m in (slo, jslo)]
    engines = []
    for m, r, ctx in ((slo, rules[0], ObsContext("t")),
                      (jslo, rules[1], JaxObsContext("t"))):
        clock = {"t": 0.0}
        eng = m.SLOEngine((m.SLO(name="recall", source="recall",
                                 budget=0.05, rules=r),),
                          obs=ctx, clock=lambda c=clock: c["t"])
        engines.append((eng, clock, ctx))
    for t, bad, total in _series():
        fired = []
        for eng, clock, _ in engines:
            clock["t"] = t
            fired.append([a.__dict__ for a in
                          eng.observe({"recall": (bad, total)})])
        assert fired[0] == fired[1]
    (eng, _, ctx), (jeng, _, jctx) = engines
    assert [a.__dict__ for a in eng.sink.alerts] == \
        [a.__dict__ for a in jeng.sink.alerts]
    assert {a.active for a in eng.sink.alerts} == {True, False}
    assert eng.state() == jeng.state()
    assert export.prometheus_text(ctx.registry).replace(
        'ring="t"', "") == jexport.prometheus_text(jctx.registry).replace(
        'ring="t"', "")


def _fill(reg):
    reg.counter("repro_a_total", "a counter", kind="x").inc(3)
    reg.counter("repro_a_total", "a counter", kind='q"uo\\te\n').inc(0.5)
    reg.gauge("repro_g", "a gauge\nwith a newline").set(-2.25)
    h = reg.histogram("repro_h_ms", "a histogram", plane="p0")
    for v in (0.1, 3.0, 7.5, 1e9, float("inf")):
        h.observe(v)
    reg.counter("repro_b_total", "").inc()
    reg.gauge("repro_g", "a gauge\nwith a newline", extra="1").set(float("nan"))
    reg.counter("repro_a_total", "a counter", kind="y").inc(2)


def test_prometheus_text_and_json_are_the_reference_bytes(tmp_path):
    reg, jreg = MetricsRegistry(), JaxMetricsRegistry()
    _fill(reg)
    _fill(jreg)
    assert export.prometheus_text(reg) == jexport.prometheus_text(jreg)
    ctx, jctx = ObsContext("x"), JaxObsContext("x")
    _fill(ctx.registry)
    _fill(jctx.registry)
    ctx.tracer.instant("e", trace="t")
    jctx.tracer.instant("e", trace="t")
    a, b = export.json_snapshot(ctx), jexport.json_snapshot(jctx)
    assert json.dumps(a, sort_keys=True, default=str) == \
        json.dumps(b, sort_keys=True, default=str)
    export.dump_metrics(str(tmp_path / "m.prom"), ctx)
    assert (tmp_path / "m.prom").read_text() == \
        jexport.prometheus_text(jctx.registry)


def _keys(doc, prefix=""):
    out = set()
    for k, v in doc.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("stats",):
            out |= _keys(v, prefix + k + ".")
    return out


def test_health_snapshot_keys_are_the_reference_keys():
    jidx, idx, queries = _handles()
    docs = []
    for mod, pcfg, plane_cls, index, ctx, slomod in (
            (health, PlaneConfig, RequestPlane, idx, ObsContext("h"), slo),
            (jhealth, JaxPlaneConfig, JaxRequestPlane, jidx,
             JaxObsContext("h"), jslo)):
        plane = plane_cls(index, pcfg(audit_rate=1.0), obs=ctx)
        rng = 1 if plane_cls is RequestPlane else jax.random.PRNGKey(1)
        plane.submit(queries, rng=rng, cache="bypass")
        plane.drain()
        plane.audit_flush()
        eng = slomod.SLOEngine(slomod.default_slos(0.01),
                               obs=ctx)
        eng.observe(slomod.plane_sources(plane))
        doc = mod.health_snapshot(plane=plane, slo=eng)
        json.dumps(doc)
        docs.append(doc)
    assert _keys(docs[0]) == _keys(docs[1])
    assert set(docs[0]["stats"]) == set(docs[1]["stats"])
    assert docs[0]["ok"] and docs[1]["ok"]
    assert docs[0]["audit"]["sampled_rows"] == len(queries)
    assert docs[0]["audit"]["mismatch_rows"] == 0


def test_recall_guard_chain_on_the_live_handle():
    idx = Index.open(_stores("dense")[1])
    idx._apply_tuned(TunedConfig.from_cfg(idx.cfg).with_measured(
        epoch_ms=1.0, round_ms=0.5))
    sinks = (slo.AlertSink(), jslo.AlertSink())
    guards = (scale.RecallGuardPolicy(sinks[0]),
              jscale.RecallGuardPolicy(sinks[1]))
    actions = []
    for step in range(4):
        if step == 1:
            for m, s in ((slo, sinks[0]), (jslo, sinks[1])):
                s.emit(m.Alert(slo="recall", severity="page",
                               rule="10x/60s", burn_long=20.0,
                               burn_short=20.0, bad_frac=1.0, budget=0.05,
                               at=0.0))
        st = idx.stats
        d = guards[0].recommend(st)
        jd = guards[1].recommend(JaxServeStats(**{
            f: getattr(st, f) for f in ("serving_fallback",
                                        "retune_requested")}))
        assert (d.action, d.reason) == (jd.action, jd.reason)
        actions.append(d.action)
        acted = scale.apply_guard(idx, d)
        assert acted == (d.action != "none")
    assert actions == ["none", "fallback_untuned", "retune", "none"]
    assert idx.serving_fallback and idx.retune_requested
    assert isinstance(idx.stats, ServeStats) and idx.stats.serving_fallback
    assert not idx._serving_tuned(QuerySpec())
    idx.tune(force=True, levels=1, max_candidates=1)
    assert not idx.serving_fallback and not idx.retune_requested


# ---------------------------------------------------------------------------
# the audited plane
# ---------------------------------------------------------------------------

def _plane_index():
    corpus, queries = jsynthetic.make_knn_benchmark_data("dense", 256, 256,
                                                         4, seed=1)
    cfg = BMOConfig(k=4, delta=0.05, block=64, batch_arms=16)
    return Index.build(corpus, cfg, 0, device="cpu"), queries


def test_injected_failure_is_caught_bundled_and_replayed(tmp_path):
    """Corrupt ONE served result below the plane — scheduler, cache and
    certification all believe it — and the auditor flags exactly that
    ticket, writes a bundle, and the replay tool reproduces it after a
    save and load (the reference's tests/test_slo.py scenario)."""
    idx, queries = _plane_index()
    obs = ObsContext("t", enabled=True)
    plane = RequestPlane(idx, PlaneConfig(
        audit_rate=1.0, audit_dir=str(tmp_path / "bundles")), obs=obs)
    good = plane.submit(queries, rng=1, cache="bypass")
    plane.drain()
    real_build = plane._build_result

    def corrupted(entry, terminal, reason):
        res = real_build(entry, terminal, reason)
        if terminal and reason == "certified":
            res.indices[0, 0] = res.indices[0, 1]
            plane._build_result = real_build       # one ticket only
        return res

    plane._build_result = corrupted
    bad = plane.submit(queries + 0.002, rng=2, cache="bypass")
    plane.drain()
    assert plane.stats.audit_pending == 2
    plane.audit_flush()
    s = plane.auditor.summary()
    assert s["mismatch_rows"] == 1 and s["sampled_rows"] == 8
    assert len(s["bundles"]) == 1
    bundle = s["bundles"][0]
    doc, arrays = audit.load_bundle(bundle)
    assert doc["trace_id"] == bad.trace_id != good.trace_id
    assert doc["mismatch_rows"] == [0] and doc["contract"] == "default"
    assert arrays["served_ids"][0, 0] == arrays["served_ids"][0, 1]
    assert any(e.get("trace") == bad.trace_id for e in doc["events"])
    rep = audit.replay_bundle(idx, bundle)
    assert rep["reproduced"] and rep["epoch_match"]

    index_dir = tmp_path / "idx"
    idx.save(str(index_dir))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_replay_audit.py"),
         "--device", "cpu", "--index-dir", str(index_dir), "--json",
         str(tmp_path / "replay.json"), bundle],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "REPRODUCED" in out.stdout
    rep_doc = json.loads((tmp_path / "replay.json").read_text())
    assert rep_doc["reports"][0]["reproduced"]
    st = plane.stats
    assert (st.audit_sampled, st.audit_mismatches) == (8, 1)
    doc = health.health_snapshot(plane=plane)
    assert not doc["ok"] and len(doc["violations"]) == 1


def test_oracle_never_runs_while_a_group_races(monkeypatch):
    idx, queries = _plane_index()
    plane = RequestPlane(idx, PlaneConfig(audit_rate=1.0))
    seen = []
    real = audit.check_topk

    def watched(*a, **kw):
        seen.append((len(plane._groups), sum(map(len,
                                                 plane._queues.values()))))
        return real(*a, **kw)

    monkeypatch.setattr(audit, "check_topk", watched)
    tickets = [plane.submit(queries[i:i + 1], rng=i, cache="bypass",
                            tenant=f"t{i}") for i in range(4)]
    plane.drain()
    assert seen == [] and plane.auditor.pending == 4
    # idle steps audit one item each, with nothing racing or queued
    for _ in range(4):
        plane.step()
    assert seen == [(0, 0)] * 4 and plane.auditor.pending == 0
    assert plane.stats.audit_sampled == 4 and plane.stats.audit_mismatches == 0
    assert all(t.reason == "certified" for t in tickets)
