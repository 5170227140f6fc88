"""The port's tuner (``repro_torch.tune``) and the handle around it, held
against the JAX package's ``repro.tune`` on the CPU.

* Records: store signatures, candidate grids (the port's "cuda" grid
  against the reference's "tpu" one: both race 2 and 4 kernel buffers),
  ``bind`` / ``tuned_mode``, and ``tuned.json`` sidecars written by either
  package and read by the other, with every rejection reason. Integers,
  strings and booleans exactly.
* The racer: successive halving in both packages with ``_race_once``
  stubbed (monkeypatched) from one table of walls: the same winner, the
  same halving order, the same walls (exact: the walls are the table's).
* The cost model's contract: the identity candidate first, ``rounds``
  candidates unscored and kept, at most ``max_candidates`` survivors.
* The blocking fused driver's obs records: a replayed race in both
  packages leaves equal launch and pull counters and epoch-histogram
  counts (exact) and coordinate reads at fp32 tolerance (rtol 2e-4 / atol
  1e-5), with one ``host_fetch`` an epoch in the port.
* The handle: ``tune`` under the epoch fence, ``apply=False``,
  ``use_tuned=False``, ``load`` applying a sidecar, a replayed race under
  a tuned config against the reference's, the tuned ``round_ms`` reaching
  the session, and the deadline cap on the pow2 chain on a held clock.
"""
import dataclasses
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

import repro.tune as jtune
from repro.api import Index as JaxIndex
from repro.configs.base import BMOConfig as JaxBMOConfig
from repro.core.datasets import SparseDataset as JaxSparseDataset
from repro.data import synthetic as jsynthetic
from repro.index import anytime as janytime
from repro.index.batched_race import fused_race_topk as jax_fused_race_topk
from repro.index.batched_race import index_knn as jax_index_knn
from repro.index.builder import build_index as jax_build_index
from repro.obs import ObsContext as JaxObsContext
from repro.obs import set_obs as jax_set_obs
from repro.tune import racer as jracer
import repro_torch.tune as tune
from repro_torch.api import Index
from repro_torch.configs.base import BMOConfig
from repro_torch.index import anytime
from repro_torch.index.batched_race import fused_race_topk, index_knn
from repro_torch.index.store import IndexStore
from repro_torch.obs import ObsContext, set_obs
from repro_torch.tune import racer
from repro_torch.utils import hostsync

from test_torch_replay import (CASES, FP32, carry, case_data, cfg_kw,
                               replay_sampler)

KINDS = ("dense", "rotated", "sparse")


def _both_stores(kind, n=200, d=256, Q=4, seed=3):
    """A reference store and the port's store carried from it (CPU)."""
    if kind == "sparse":
        corpus, queries = jsynthetic.make_knn_benchmark_data(
            "sparse", n, d, Q, seed=seed)
        jcfg = JaxBMOConfig(k=3, block=1, metric="l1", sparse=True)
        jstore = jax_build_index(JaxSparseDataset.build(corpus), jcfg,
                                 jax.random.PRNGKey(0))
    else:
        corpus, queries = jsynthetic.make_knn_benchmark_data(
            "dense", n, d, Q, seed=seed)
        jcfg = JaxBMOConfig(k=3, block=32, rotate=kind == "rotated")
        jstore = jax_build_index(corpus, jcfg, jax.random.PRNGKey(0))
    store = IndexStore.from_arrays(*carry(jstore), device="cpu")
    return jstore, store, queries


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_signature_is_the_reference_signature(kind):
    jstore, store, _ = _both_stores(kind)
    want = jtune.signature_of(jstore, backend="cpu")
    got = tune.signature_of(store)
    assert got.to_dict() == want.to_dict()
    assert got.dtype == "float32" and got.backend == "cpu"
    assert tune.SIGNATURE_SCHEME == jtune.SIGNATURE_SCHEME


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", [("cpu", "cpu"), ("cuda", "tpu")],
                         ids=["cpu", "cuda-vs-tpu"])
def test_candidate_grid_is_the_reference_grid(kind, backend):
    ours, theirs = backend
    jstore, store, _ = _both_stores(kind)
    got = [c.to_dict() for c in tune.candidate_grid(store, backend=ours)]
    want = [c.to_dict() for c in jtune.candidate_grid(jstore,
                                                      backend=theirs)]
    assert got == want
    bufs = {c["kernel_buffers"] for c in got if c["mode"] == "fused"}
    if kind != "sparse":
        assert bufs == ({2, 4} if ours == "cuda" else {2})
    # the default is the store's own device type
    assert tune.candidate_grid(store) == tune.candidate_grid(store,
                                                             backend="cpu")


def test_candidate_grid_drops_buffers_the_schedule_cannot_hold():
    # block 256 at this width: the pair schedule's ring holds 2 slots in
    # shared memory and not 4, even at one warp a block
    fake = types.SimpleNamespace(kind="dense", cfg=BMOConfig(block=256),
                                 n_live=4096, d=3_334_656, block=256,
                                 d_pad=3_334_656)
    grid = tune.candidate_grid(fake, backend="cuda")
    assert grid and {c.kernel_buffers for c in grid} == {2}


def test_bind_and_tuned_mode_are_the_reference():
    cfg = BMOConfig(k=7, delta=0.05, metric="l1", max_rounds=99)
    t = tune.TunedConfig(epoch_rounds=8, pulls_per_round=1, batch_arms=64,
                         frontier_floor=128, kernel_buffers=4, mode="fused",
                         epoch_ms=3.0, round_ms=0.5)
    jt = jtune.TunedConfig(**t.to_dict())
    bound = t.bind(cfg)
    assert dataclasses.asdict(bound) == dataclasses.asdict(
        jt.bind(JaxBMOConfig(**dataclasses.asdict(cfg))))
    for f in ("k", "delta", "metric", "max_rounds", "block", "init_pulls"):
        assert getattr(bound, f) == getattr(cfg, f)
    assert (bound.epoch_rounds, bound.batch_arms, bound.kernel_buffers) == \
        (8, 64, 4)
    assert tune.TunedConfig.from_cfg(bound, mode="fused") == \
        dataclasses.replace(t, epoch_ms=0.0, round_ms=0.0)
    assert t.with_measured(epoch_ms=1, round_ms=2).round_ms == 2.0
    for tuned in (None, t):
        for mode in ("auto", "fused", "rounds"):
            assert tune.tuned_mode(tuned, mode) == jtune.tuned_mode(
                None if tuned is None else jt, mode)
    assert tune.TUNED_VERSION == jtune.TUNED_VERSION
    assert tune.TUNED_FILE == jtune.TUNED_FILE


REASONS = ("ok", "missing", "unreadable", "version", "malformed",
           "signature")


@pytest.mark.parametrize("reason", REASONS)
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sidecar_read_across_packages(tmp_path, writer, reason):
    """A ``tuned.json`` written by one package reads in the other with the
    same verdict and reason, and the same config when accepted."""
    jstore, store, _ = _both_stores("rotated")
    path = str(tmp_path)
    cfg = dict(epoch_rounds=2, pulls_per_round=4, batch_arms=16,
               frontier_floor=128, kernel_buffers=2, mode="fused",
               epoch_ms=1.25, round_ms=0.625)
    pkg, sig_store = (jtune, jstore) if writer == "jax" else (tune, store)
    sig = (pkg.signature_of(sig_store, backend="cpu") if pkg is jtune
           else pkg.signature_of(sig_store))
    fpath = os.path.join(path, "tuned.json")
    if reason in ("ok", "signature"):
        if reason == "signature":
            sig = dataclasses.replace(sig, n_bucket=sig.n_bucket * 2)
        pkg.save_tuned(path, sig, pkg.TunedConfig(**cfg),
                       measured={"round_ms": 0.625})
    elif reason == "unreadable":
        with open(fpath, "w") as f:
            f.write("{not json")
    elif reason == "version":
        pkg.save_tuned(path, sig, pkg.TunedConfig(**cfg))
        doc = json.load(open(fpath))
        doc["version"] = 99
        json.dump(doc, open(fpath, "w"))
    elif reason == "malformed":
        with open(fpath, "w") as f:
            json.dump({"version": 1, "config": cfg}, f)
    got, why = tune.load_tuned(path, store)
    want, jwhy = jtune.load_tuned(path, jstore)
    assert why == jwhy == reason
    if reason == "ok":
        assert got.to_dict() == want.to_dict() == cfg
    else:
        assert got is None and want is None
    assert not os.path.exists(fpath + ".tmp")


@pytest.mark.parametrize("rotate", [False, True], ids=["dense", "rotated"])
def test_synthetic_tuning_queries_sit_near_live_rows(rotate):
    """The tuner's synthetic queries are live rows plus 0.1·σ noise in the
    corpus's space: each lies far nearer its nearest row than the median
    row (ratio under 0.05; queries of the benchmark data: about 0.001).
    The reference's rotated store perturbs the rotated rows and keeps d of
    their columns, so the race rotates them again into queries near no row
    (ratio about 0.9; ROADMAP.md Queue 3 item 7)."""
    corpus, _ = jsynthetic.make_knn_benchmark_data("dense", 2000, 1100, 8,
                                                   seed=0)
    jstore = jax_build_index(corpus, JaxBMOConfig(k=5, block=128,
                                                  rotate=rotate),
                             jax.random.PRNGKey(0))
    store = IndexStore.from_arrays(*carry(jstore), device="cpu")
    dead = np.arange(0, 2000, 3)
    store = dataclasses.replace(store, alive=store.alive.clone())
    store.alive[dead] = False

    def ratio(qs):
        d = ((np.asarray(qs, np.float64)[:, None, :]
              - corpus[None].astype(np.float64)) ** 2).sum(-1)
        return np.median(d.min(1) / np.median(d, 1)), d.argmin(1)

    qs = tune.synth_queries(store, 1)
    assert qs.shape == (8, 1100) and qs.dtype == torch.float32
    got, nearest = ratio(qs.numpy())
    assert got < 0.05 and not np.isin(nearest, dead).any()
    torch.testing.assert_close(qs, tune.synth_queries(store, 1))
    want, _ = ratio(jtune.synth_queries(jstore, jax.random.PRNGKey(1)))
    assert (want > 0.5) == rotate


# ---------------------------------------------------------------------------
# the racer and the cost model
# ---------------------------------------------------------------------------

def _wall_table(cands):
    """Walls a candidate's races take, by its knobs: every candidate its
    own sequence, so medians, halvings and the winner are all decided by
    the table."""
    rs = np.random.default_rng(11)
    return {_knobs(c.to_dict()): list(rs.uniform(1.0, 100.0, 64))
            for c in cands}


def _knobs(d):
    return (d["epoch_rounds"], d["pulls_per_round"], d["batch_arms"],
            d["frontier_floor"], d["kernel_buffers"])


def _stub(table, calls):
    def race_once(store, queries, rng, mode):
        key = _knobs(dataclasses.asdict(store.cfg)) + (mode,)
        n = sum(1 for c in calls if c == key)
        calls.append(key)
        return table[key[:-1]][n], 5.0
    return race_once


def test_successive_halving_is_the_reference_order(monkeypatch):
    jstore, store, queries = _both_stores("dense")
    cands = tune.candidate_grid(store)[:9]
    jcands = [jtune.TunedConfig(**c.to_dict()) for c in cands]
    table = _wall_table(cands)
    calls, jcalls = [], []
    monkeypatch.setattr(racer, "_race_once", _stub(table, calls))
    monkeypatch.setattr(jracer, "_race_once", _stub(table, jcalls))
    win, results = tune.race_candidates(store, cands, queries, 0, levels=3,
                                        reps=2)
    jwin, jresults = jtune.race_candidates(jstore, jcands, queries,
                                           jax.random.PRNGKey(0), levels=3,
                                           reps=2)
    assert calls == jcalls
    assert win.cand.to_dict() == jwin.cand.to_dict()
    assert [m.to_dict() for m in results] == [m.to_dict() for m in jresults]
    assert win.median_ms == min(m.median_ms for m in results
                                if len(m.wall_ms) == len(win.wall_ms))


def test_cost_model_keeps_identity_and_rounds_and_caps_survivors():
    _, store, _ = _both_stores("rotated")
    cands = tune.candidate_grid(store, backend="cuda")
    for cap in (1, 2, 8):
        survivors, report = tune.seed_candidates(store, cands,
                                                 max_candidates=cap)
        assert survivors[0] == cands[0] and len(survivors) <= cap
        assert len(report) == len(cands)
    survivors, report = tune.seed_candidates(store, cands)
    assert len(survivors) == 8
    assert any(c.mode == "rounds" for c in survivors)
    scores = {json.dumps(r["cand"], sort_keys=True): r["e"] for r in report}
    fused = [scores[json.dumps(c.to_dict(), sort_keys=True)]
             for c in survivors[1:] if c.mode == "fused"]
    assert fused == sorted(fused) and all(e > 0 for e in fused)
    # the model prefers the launch that amortizes its fixed cost over the
    # most pulled elements
    big = tune.TunedConfig(epoch_rounds=8, pulls_per_round=4, batch_arms=64)
    small = tune.TunedConfig(epoch_rounds=2, pulls_per_round=1,
                             batch_arms=16)
    kw = dict(Q=8, n=store.n_live, d_pad=store.d_pad, block=store.block,
              metric="l2", dtype="float32")
    assert tune.model_efficiency(big, **kw) < tune.model_efficiency(small,
                                                                    **kw)
    # sparse stores pass through unscored
    _, sp, _ = _both_stores("sparse")
    sc = tune.candidate_grid(sp)
    assert tune.seed_candidates(sp, sc)[0] == sc


# ---------------------------------------------------------------------------
# the blocking fused driver's obs records
# ---------------------------------------------------------------------------

def _series(registry):
    """The racing drivers' series: kernel counters, epoch histograms."""
    out = {}
    for m in registry.collect():
        if not m.name.startswith(("repro_kernel_", "repro_race_epoch_ms")):
            continue
        key = (m.name, tuple(sorted(dict(m.labels).items())))
        out[key] = m.count if m.kind == "histogram" else m.value
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_fused_driver_records_what_the_reference_records(case):
    corpus, queries, rotate = case_data(case)
    jstore = jax_build_index(corpus, JaxBMOConfig(**cfg_kw(rotate)),
                             jax.random.PRNGKey(0))
    store = IndexStore.from_arrays(*carry(jstore), device="cpu")
    key = jax.random.PRNGKey(5)
    jctx, ctx = JaxObsContext("j"), ObsContext("t")
    jold, old = jax_set_obs(jctx), set_obs(ctx)
    try:
        jax_fused_race_topk(
            jstore.x, jstore.prepare_queries(queries), jstore.alive,
            jstore.prior_var, key, cfg=jstore.cfg, block=jstore.block,
            d=jstore.d, impl="auto", eliminate=True,
            prior_weight=jstore.prior_weight)
        qs = store.prepare_queries(queries)
        hostsync.reset_syncs()
        fused_race_topk(store.x, qs, store.alive, store.prior_var,
                        cfg=store.cfg, block=store.block, d=store.d,
                        impl="auto", eliminate=True,
                        prior_weight=store.prior_weight,
                        block_sampler=replay_sampler(key))
        syncs = hostsync.syncs()
    finally:
        jax_set_obs(jold)
        set_obs(old)
    want, got = _series(jctx.registry), _series(ctx.registry)
    coord = ("repro_kernel_coord_ops_total",
             (("kernel", "fused_epoch_pull"),))
    np.testing.assert_allclose(got.pop(coord), want.pop(coord), **FP32)
    assert got == want
    launches = got[("repro_kernel_launches_total",
                    (("kernel", "fused_epoch_pull"),))]
    assert launches == got[("repro_race_epoch_ms",
                            (("kind", "fused_blocking"),))] > 0
    assert syncs == launches          # one host_fetch an epoch, no more


# ---------------------------------------------------------------------------
# the handle
# ---------------------------------------------------------------------------

def _index(n=256, d=128, Q=4, **kw):
    corpus, queries = jsynthetic.make_knn_benchmark_data("dense", n, d, Q,
                                                         seed=2)
    cfg = dict(k=3, delta=0.05, block=32, batch_arms=16)
    cfg.update(kw)
    return Index.build(corpus, BMOConfig(**cfg), 0, device="cpu"), queries


TUNED = dict(epoch_rounds=2, pulls_per_round=1, batch_arms=8,
             frontier_floor=128, kernel_buffers=2, mode="fused",
             epoch_ms=4.0, round_ms=2.0)


def _fixed_winner(monkeypatch, cfg=TUNED):
    """Replace the race with a fixed winner (the handle's plumbing is what
    these tests hold)."""
    calls = []

    def fake(store, queries=None, rng=None, **kw):
        calls.append(kw)
        return (tune.TunedConfig(**cfg),
                {"signature": tune.signature_of(store).to_dict(),
                 "cached": False, "config": cfg})
    monkeypatch.setattr(tune, "tune_store", fake)
    return calls


def test_tune_installs_through_the_epoch_fence(monkeypatch):
    idx, queries = _index()
    idx.query(queries, 1)
    assert idx.stats.cache_entries == len(queries)
    build_cfg = idx.cfg
    calls = _fixed_winner(monkeypatch)
    report = idx.tune(levels=1, force=True)
    assert report["applied"] and calls[0]["force"] and calls[0]["levels"] == 1
    assert idx.epoch == 1 and idx.stats.cache_entries == 0
    assert idx.tuned == tune.TunedConfig(**TUNED)
    assert idx.cfg == idx.tuned.bind(build_cfg)

    # a mutation while the tuner races is refused
    def racing(store, queries=None, rng=None, **kw):
        idx.insert(np.asarray(queries)[:1])
    monkeypatch.setattr(tune, "tune_store", racing)
    with pytest.raises(RuntimeError, match="quiesced for admin op 'tune'"):
        idx.tune(queries)
    assert idx.epoch == 1


def test_tune_apply_false_measures_without_installing(monkeypatch):
    idx, _ = _index()
    _fixed_winner(monkeypatch)
    report = idx.tune(apply=False)
    assert report["applied"] is False and idx.tuned is None
    assert idx.epoch == 0


def test_use_tuned_false_races_the_build_config(monkeypatch):
    idx, queries = _index()
    fresh, _ = _index()
    _fixed_winner(monkeypatch)
    idx.tune()
    got = idx.query(queries, 3, use_tuned=False)
    want = fresh.query(queries, 3)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.rounds, want.rounds)
    tuned = idx.query(queries, 3, cache="bypass")
    bound = dataclasses.replace(fresh.store, cfg=idx.tuned.bind(fresh.cfg))
    direct = index_knn(bound, queries, 3)
    np.testing.assert_array_equal(tuned.indices, direct.indices.numpy())
    np.testing.assert_array_equal(tuned.rounds, direct.rounds.numpy())
    # the recall-guard fallback serves every query on the build config
    idx.force_untuned(True)
    assert idx.stats.serving_fallback
    np.testing.assert_array_equal(idx.query(queries, 3,
                                            cache="bypass").rounds,
                                  want.rounds)


def test_load_applies_a_matching_sidecar(tmp_path, monkeypatch):
    idx, queries = _index()
    _fixed_winner(monkeypatch)
    idx.tune()
    path = str(tmp_path / "idx")
    idx.save(path)
    doc = json.load(open(os.path.join(path, "tuned.json")))
    assert doc["config"] == TUNED and doc["signature"]["backend"] == "cpu"
    assert doc["measured"] == {"epoch_ms": 4.0, "round_ms": 2.0}
    tune.cache_clear()
    loaded = Index.load(path, device="cpu")
    assert loaded.tuned == idx.tuned and loaded.cfg == idx.cfg
    assert loaded.epoch == 0
    assert tune.cache_get(tune.signature_of(loaded.store)) == idx.tuned
    np.testing.assert_array_equal(loaded.query(queries, 1).indices,
                                  idx.query(queries, 1).indices)
    # the loaded handle's use_tuned=False contract is the build config
    np.testing.assert_array_equal(
        loaded.query(queries, 2, use_tuned=False).rounds,
        _index()[0].query(queries, 2).rounds)
    # the reference loads the port's directory and applies the same tuning
    jidx = JaxIndex.load(path)
    assert jidx.tuned.to_dict() == idx.tuned.to_dict()


def test_tune_runs_real_races_and_reuses_the_cache():
    idx, _ = _index(n=128, d=64)
    tune.cache_clear()
    report = idx.tune(levels=2, max_candidates=3)
    assert not report["cached"] and report["raced"] == 3
    assert report["grid_size"] == len(tune.candidate_grid(idx.store))
    assert len(report["measurements"]) == 3
    winner = tune.TunedConfig(**report["config"])
    assert idx.tuned == winner and winner.round_ms > 0
    # the per-round driver records no epochs: its round cost comes from
    # the race walls
    assert (winner.epoch_ms > 0) == (winner.mode != "rounds")
    again = Index.open(idx.store).tune()
    assert again["cached"] and again["config"] == report["config"]
    idx.request_retune("suspect")
    idx.force_untuned(True)
    assert idx.retune_requested and idx.retune_reason == "suspect"
    idx.tune(force=True, levels=1, max_candidates=1)
    assert not idx.retune_requested and not idx.serving_fallback


@pytest.mark.parametrize("rotate", [False, True], ids=["dense", "rotated"])
def test_replayed_race_under_a_tuned_config_is_the_reference_race(rotate):
    corpus, queries = jsynthetic.make_knn_benchmark_data("dense", 300, 256,
                                                         4, seed=7)
    jidx = JaxIndex.build(corpus, JaxBMOConfig(**cfg_kw(rotate)),
                          jax.random.PRNGKey(0))
    idx = Index.open(IndexStore.from_arrays(*carry(jidx.store),
                                            device="cpu"))
    jidx._apply_tuned(jtune.TunedConfig(**TUNED))
    idx._apply_tuned(tune.TunedConfig(**TUNED))
    assert dataclasses.asdict(idx.cfg) == dataclasses.asdict(jidx.cfg)
    key = jax.random.PRNGKey(9)
    want = jax_index_knn(jidx.store, queries, key)
    got = index_knn(idx.store, queries, block_sampler=replay_sampler(key))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.rounds.numpy(), np.asarray(want.rounds))
    np.testing.assert_allclose(got.coord_ops.numpy(),
                               np.asarray(want.coord_ops), **FP32)


def test_race_passes_the_tuned_round_cost(monkeypatch):
    idx, queries = _index()
    assert idx.race(queries, 0, deadline_ms=1e3)._round_ms == 0.0
    _fixed_winner(monkeypatch)
    idx.tune()
    sess = idx.race(queries, 0, deadline_ms=1e3)
    assert sess._round_ms == 2.0 and sess._deadline_t is not None
    assert idx.race(queries, 0, deadline_ms=1e3,
                    use_tuned=False)._round_ms == 0.0
    # the tuned knobs are what the session races
    assert sess._R0 == TUNED["epoch_rounds"]


class HeldClock:
    """``time.perf_counter`` held by the test."""

    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        return self.now


def test_deadline_caps_fused_rounds_on_the_pow2_chain(monkeypatch):
    """``_deadline_R`` in both packages on one held clock: the same cap at
    every budget (the reference's tests/test_tune.py scenario)."""
    jstore, store, queries = _both_stores("dense", d=1024)
    clock = HeldClock()
    monkeypatch.setattr(anytime, "time", clock)
    monkeypatch.setattr(janytime, "time", clock)
    sess = anytime.make_session(store, queries, 0, cfg=store.cfg)
    jsess = janytime.make_session(jstore, queries, jax.random.PRNGKey(0),
                                  cfg=jstore.cfg)
    R0, R_cap = sess._R0, sess._R_cap
    assert (R0, R_cap) == (jsess._R0, jsess._R_cap)
    assert sess._deadline_R(R_cap) == R_cap           # no deadline
    for budget, round_ms in ((1e6, 1.0), (0.01, 50.0), (100.0, 1.0),
                             (37.0, 3.0), (0.01, 0.0)):
        for s in (sess, jsess):
            s.set_deadline(budget, round_ms=round_ms)
        clock.now += 0.004                             # 4 ms spent
        for R in (R_cap, 1 << 20, R0):
            got = sess._deadline_R(R)
            assert got == jsess._deadline_R(R)
            if round_ms > 0 and got != R:
                assert got >= R0 and got % R0 == 0
                assert (got // R0) & ((got // R0) - 1) == 0
    sess.set_deadline(0.01, round_ms=50.0)
    assert sess._deadline_R(R_cap) == min(R_cap, R0)
