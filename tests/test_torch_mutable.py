"""The port's mutable index (``index/mutable.py``) and its handle
(``api/handle.py``), held against the JAX package on the CPU.

* Mutation parity: one sequence (insert with growth, delete, insert into
  freed slots, ``maybe_compact`` below and above its threshold, compact)
  applied through both packages' handles gives the same slot ids, remaps,
  ``alive``, capacity, epoch, payload and ``build_gids``; ``x`` bit for
  bit on the dense box and at fp32 tolerance (rtol 2e-4 / atol 1e-5) on the
  rotated box, whose rows go through each package's own transform;
  ``prior_var`` at fp32 tolerance. Then both packages race the
  reference-mutated store on the reference's replayed draws and make the
  same decisions.
* The reference's own handle and mutation tests (``tests/test_api.py``,
  ``tests/test_index.py``), on the port's own draws.
* Value semantics: a mutation never writes into the old store.
* The sparse box: the reference's sparse mutation sequence (with a growth
  and a widening of m) gives the same slots, remaps and arrays in both
  packages, and a sparse directory saved by either loads in the other bit
  for bit and races to the same decisions.
* What the port does not serve yet raises ``NotImplementedError`` (a
  sharded directory, ``shards > 1``), and a ``tuned.json`` sidecar is
  logged and not applied.
"""
import dataclasses
import logging
import os

import jax
import numpy as np
import pytest
import torch

from repro.api import Index as JaxIndex
from repro.configs.base import BMOConfig as JaxBMOConfig
from repro.index.builder import build_index as jax_build_index
from repro.index.builder import save_index as jax_save_index
from repro_torch.api import CompactionPolicy, Index, KNNResult, QuerySpec
from repro_torch.configs.base import BMOConfig
from repro_torch.core import oracle
from repro_torch.data.synthetic import make_knn_benchmark_data
from repro_torch.index import (build_index, compact, delete, free_slots,
                               index_knn, insert, maybe_compact,
                               tombstone_fraction)
from repro_torch.index import builder
from repro_torch.index.store import IndexStore

from test_torch_index import _assert_same_race, _race_both
from test_torch_replay import FP32, brute_force, carry, cfg_kw, sets

# ---------------------------------------------------------------------------
# mutation parity with the reference
# ---------------------------------------------------------------------------


def assert_same_race_on_the_pulls_scale(jstore, store, queries):
    """Both packages race the stores on the reference's replayed draws and
    make the same decisions. Here d = 100 pads to d_pad = 128, where the
    reference compares exact evaluations on ρ/d with pulls on ρ/d_pad and
    the port races on ρ/d_pad on purpose (ROADMAP.md Queue 3 item 1), so
    both race with d = d_pad: the reference without that fault."""
    _assert_same_race(*_race_both(dataclasses.replace(jstore, d=jstore.d_pad),
                                  dataclasses.replace(store, d=store.d_pad),
                                  queries, True))


def _both_handles(monkeypatch, rotate, n=200, d=100):
    """The reference's handle and the port's, built from one corpus (d 100
    pads to d_pad 128) with one payload; the port takes the reference's
    rotation signs in place of its own draw."""
    corpus, queries = make_knn_benchmark_data("dense", n, d, 4, seed=7)
    payload = np.arange(n, dtype=np.int32) * 10
    jidx = JaxIndex.build(corpus, JaxBMOConfig(**cfg_kw(rotate)),
                          jax.random.PRNGKey(0), payload=payload)
    if rotate:
        signs = torch.from_numpy(np.array(jidx.store.signs))
        monkeypatch.setattr(builder, "_rademacher", lambda dp, g, dev: signs)
    idx = Index.build(corpus, BMOConfig(**cfg_kw(rotate)), device="cpu",
                      payload=payload)
    return jidx, idx, corpus, queries


def _assert_same_state(jidx, idx, rotate):
    assert (idx.capacity, idx.n_live, idx.epoch) == \
        (jidx.capacity, jidx.n_live, jidx.epoch)
    js, st = jidx.store, idx.store
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(js.alive))
    if rotate:
        np.testing.assert_allclose(st.x.numpy(), np.asarray(js.x), **FP32)
    else:
        np.testing.assert_array_equal(st.x.numpy(), np.asarray(js.x))
    np.testing.assert_allclose(st.prior_var.numpy(),
                               np.asarray(js.prior_var), **FP32)
    np.testing.assert_array_equal(idx.payload, jidx.payload)
    assert idx.payload.dtype == jidx.payload.dtype
    np.testing.assert_array_equal(idx.build_gids, jidx.build_gids)


@pytest.mark.parametrize("rotate", [False, True], ids=["dense", "rotated"])
def test_mutation_sequence_matches_the_reference(monkeypatch, rotate):
    jidx, idx, corpus, queries = _both_handles(monkeypatch, rotate)
    r = np.random.default_rng(3)
    assert idx.capacity == 256
    _assert_same_state(jidx, idx, rotate)

    def both(op, *args, **kw):
        got = getattr(idx, op)(*args, **kw)
        want = getattr(jidx, op)(*args, **kw)
        _assert_same_state(jidx, idx, rotate)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
        return got

    # insert 100 rows: 56 free slots, so capacity grows 256 -> 512
    rows = np.concatenate([queries + 1e-3, corpus[:96] * 0.5 + 0.1])
    slots = both("insert", rows.astype(np.float32),
                 payload=np.arange(100, dtype=np.int32) + 5000)
    assert idx.capacity == 512 and len(slots) == 100
    # delete 40 slots, built and inserted ones
    dead = np.concatenate([r.choice(200, 30, replace=False),
                           slots[r.choice(100, 10, replace=False)]])
    both("delete", dead)
    # insert 30 rows into the freed slots
    again = both("insert", r.normal(size=(30, 100)).astype(np.float32),
                 payload=np.arange(30, dtype=np.int32) + 9000)
    assert set(again.tolist()) <= set(dead.tolist())
    # 290 of 512 live: below the threshold, nothing happens
    assert both("maybe_compact") is None
    # 230 of 512 live: past it, and capacity shrinks to 256
    live = np.nonzero(np.asarray(jidx.store.alive))[0]
    both("delete", r.choice(live, 60, replace=False))
    old_ids = both("maybe_compact")
    assert old_ids is not None and idx.capacity == 256
    both("delete", [3, 17, 100])
    both("compact")
    assert idx.stats.compactions == 2 and idx.epoch == 7

    # the reference-mutated store, carried across, races the same
    store = IndexStore.from_arrays(*carry(jidx.store), device="cpu")
    assert_same_race_on_the_pulls_scale(jidx.store, store, queries)


# ---------------------------------------------------------------------------
# the reference's handle tests (tests/test_api.py), on the port
# ---------------------------------------------------------------------------

def _cfg(**kw):
    base = dict(k=3, delta=0.01, block=32, batch_arms=16, metric="l2")
    base.update(kw)
    return BMOConfig(**base)


def _data(n=200, d=256, Q=4, seed=0):
    return make_knn_benchmark_data("dense", n, d, Q, seed=seed)


def test_handle_build_query_mutate_save_load(tmp_path):
    corpus, queries = _data()
    ex = oracle.exact_knn(corpus, queries, 3, device="cpu")
    idx = Index.build(corpus, _cfg(), 0, device="cpu",
                      payload=np.arange(200, dtype=np.int32))
    assert (idx.n_live, idx.k, idx.kind) == (200, 3, "dense")
    res = idx.query(queries, 1)
    assert isinstance(res, KNNResult)
    assert sets(res.indices) == sets(ex.indices)
    assert (np.diff(res.values, axis=1) >= -1e-6).all()

    # k override via kwargs == via spec
    r_kw = idx.query(queries, 2, k=2)
    r_sp = idx.query(queries, 2, spec=QuerySpec(k=2))
    assert r_kw.indices.shape == (4, 2)
    np.testing.assert_array_equal(r_kw.indices, r_sp.indices)
    # δ and budget overrides rebind the racing cfg without touching the store
    r_tight = idx.query(queries, 3, delta=0.001, max_rounds=500)
    assert set(r_tight.indices[0].tolist()) == set(ex.indices[0].tolist())
    assert idx.cfg.delta == 0.01

    # mutation: the payload rides insert and compaction remaps
    epoch0 = idx.epoch
    gids = idx.insert(queries[:1], payload=np.asarray([999], np.int32))
    assert idx.epoch == epoch0 + 1
    r2 = idx.query(queries[:1], 4)
    assert int(r2.indices[0, 0]) == int(gids[0])
    assert int(idx.payload[r2.indices[0, 0]]) == 999
    idx.delete(list(range(100, 200)))
    assert idx.maybe_compact() is not None          # policy default 0.5
    assert idx.stats.compactions == 1
    r3 = idx.query(queries[:1], 5)
    assert int(idx.payload[r3.indices[0, 0]]) == 999
    assert (idx.stats.races, idx.stats.raced_queries) == (6, 18)

    # persistence: the payload sidecar rides save and load
    path = os.path.join(tmp_path, "idx")
    idx.save(path)
    idx2 = Index.load(path, device="cpu")
    assert idx2.n_live == idx.n_live
    r4 = idx2.query(queries[:1], 5)
    np.testing.assert_array_equal(r4.indices, r3.indices)
    np.testing.assert_array_equal(r4.values, r3.values)
    assert int(idx2.payload[r4.indices[0, 0]]) == 999


def test_attach_payload_validation():
    corpus, _ = _data()
    idx = Index.build(corpus, _cfg(), 0, device="cpu")
    with pytest.raises(ValueError, match="exceeds index capacity"):
        idx.attach_payload(np.zeros(idx.capacity + 1, np.int32))
    with pytest.raises(ValueError, match="does not cover"):
        idx.attach_payload(np.zeros(idx.n_live - 1, np.int32))
    idx.attach_payload(np.zeros(idx.n_live, np.int32))   # prefix covers live
    assert len(idx.payload) == idx.capacity


def test_build_gids_invalidated_on_delete_and_slot_reuse():
    corpus, _ = _data(n=64, d=64)
    idx = Index.build(corpus, _cfg(block=16), 0, device="cpu")
    gid5 = int(idx.build_gids[5])
    idx.delete([gid5])
    assert idx.build_gids[5] == -1
    new_gid = idx.insert(corpus[5:6] * 2.0)        # reuses the freed slot
    assert int(new_gid[0]) == gid5
    assert idx.build_gids[5] == -1                 # still not row 5's slot


def test_admin_fence_blocks_mutations():
    corpus, _ = _data(n=64, d=64)
    idx = Index.build(corpus, _cfg(block=16), 0, device="cpu")
    with idx._admin_op("test-op"):
        with pytest.raises(RuntimeError, match="quiesced"):
            idx.insert(corpus[:1])
        with pytest.raises(RuntimeError, match="quiesced"):
            idx.delete([0])
        with pytest.raises(RuntimeError, match="quiesced"):
            idx.maybe_compact()
        with pytest.raises(RuntimeError, match="in flight"):
            with idx._admin_op("another"):
                pass
    idx.delete([0])                                # fence lifted
    assert idx.epoch == 1


def test_compaction_policy():
    with pytest.raises(ValueError):
        CompactionPolicy(threshold=0.0)
    corpus, _ = _data(n=120, d=64)
    idx = Index.build(corpus, _cfg(block=16), 0, device="cpu",
                      compaction=CompactionPolicy(threshold=1.0))
    idx.delete(list(range(100)))
    assert idx.maybe_compact() is None             # threshold ≥ 1: never
    assert idx.maybe_compact(threshold=0.5) is not None
    assert idx.capacity == 32 and idx.stats.compactions == 1


# ---------------------------------------------------------------------------
# the reference's mutation tests (tests/test_index.py), on the port
# ---------------------------------------------------------------------------

def _fresh_equals(store, corpus_rows, queries, cfg, slot_of_row):
    """Post-mutation top-k == fresh build on the mutated corpus (slot ids
    mapped through ``slot_of_row``)."""
    fresh = build_index(np.asarray(corpus_rows), cfg, device="cpu")
    want = index_knn(fresh, queries, 9)
    got = index_knn(store, queries, 9)
    want_slots = [set(int(slot_of_row[j]) for j in row)
                  for row in want.indices.tolist()]
    assert sets(got.indices) == want_slots


def test_mutation_round_trip_dense():
    corpus, queries = _data(200, 512, 3, seed=11)
    cfg = BMOConfig(k=3, delta=0.01, block=64, batch_arms=16, metric="l2")
    store = build_index(corpus, cfg, device="cpu")
    truth = brute_force(corpus, queries, 3)

    # delete the two best arms of query 0: they must disappear from results
    kill = sorted(truth[0])[:2]
    store = delete(store, kill)
    res = index_knn(store, queries, 1)
    for row in sets(res.indices):
        assert not (row & set(kill))
    mask = np.ones(len(corpus), bool)
    mask[kill] = False
    _fresh_equals(store, corpus[mask], queries, cfg, np.nonzero(mask)[0])

    # near-duplicates of the queries become the top-1, in the freed slots
    store, slots = insert(store, queries + 1e-3)
    assert set(slots.tolist()) <= set(kill) | set(range(200, store.capacity))
    res = index_knn(store, queries, 2)
    for i in range(len(queries)):
        assert int(res.indices[i, 0]) == int(slots[i])

    # compact: the same results through the old→new slot map
    before = index_knn(store, queries, 3)
    store2, old_ids = compact(store)
    assert store2.n_live == store.n_live
    after = index_knn(store2, queries, 3)
    remapped = [set(int(old_ids[j]) for j in row)
                for row in after.indices.tolist()]
    assert remapped == sets(before.indices)


@pytest.mark.parametrize("rotate", [False, True], ids=["dense", "rotated"])
def test_mutation_growth(rotate):
    corpus, queries = _data(60, 100, 2, seed=6)
    store = build_index(corpus, BMOConfig(**cfg_kw(rotate)), device="cpu",
                        capacity=64)
    # 5 rows into 4 free slots force a growth: max(2·64, next_pow2(65))
    store, slots = insert(store, np.concatenate([queries + 1e-3,
                                                 corpus[:3] * 3.0]))
    assert store.capacity == 128 and store.n_live == 65
    assert slots.tolist() == [60, 61, 62, 63, 64]
    assert store.x.shape == (128, store.d_pad) == (128, 128)
    assert store.prior_var.shape == (128,)
    res = index_knn(store, queries, 1)
    assert res.indices[:, 0].tolist() == slots[:2].tolist()


@pytest.mark.parametrize("bad", [[-1], [64], [3, 70]])
def test_delete_refuses_slots_outside_the_store(bad):
    corpus, _ = _data(40, 64, 1)
    store = build_index(corpus, _cfg(block=16), device="cpu")    # cap 64
    with pytest.raises(ValueError, match=r"\[0, 64\)"):
        delete(store, bad)
    assert delete(store, []).n_live == 40


def _assert_same_sparse_store(jstore, store):
    assert (store.capacity, store.n_live, store.m) == \
        (jstore.capacity, jstore.n_live, jstore.m)
    for name in ("alive", "indices", "values", "nnz"):
        np.testing.assert_array_equal(getattr(store, name).numpy(),
                                      np.asarray(getattr(jstore, name)), name)
    np.testing.assert_allclose(store.prior_var.numpy(),
                               np.asarray(jstore.prior_var), rtol=1e-6)


def test_sparse_mutation_sequence_matches_the_reference():
    """The reference's sparse mutation test's sequence through both
    packages: 5 rows, one denser than any stored, into 4 free slots (a
    growth and a widening of m), a delete, ``maybe_compact`` below and
    above its threshold, ``compact``: the same slots, remaps and arrays."""
    from repro.data.synthetic import clustered_sparse
    from repro.index import mutable as jmutable
    corpus = clustered_sparse(60, 512, seed=6)
    cfg = dict(k=2, delta=0.01, block=1, batch_arms=16, pulls_per_round=8,
               init_pulls=16, metric="l1", sparse=True)
    jstore = jax_build_index(corpus, JaxBMOConfig(**cfg),
                             jax.random.PRNGKey(0), capacity=64)
    store = build_index(corpus, BMOConfig(**cfg), device="cpu", capacity=64)
    _assert_same_sparse_store(jstore, store)
    r = np.random.default_rng(0)
    rows = np.where(r.random((5, 512)) < 0.5, r.exponential(1.0, (5, 512)),
                    0).astype(np.float32)
    jstore, jslots = jmutable.insert(jstore, rows)
    store, slots = insert(store, rows)
    assert slots.tolist() == jslots.tolist() == [60, 61, 62, 63, 64]
    assert store.m > 42 and store.capacity == 128
    _assert_same_sparse_store(jstore, store)
    dead = list(range(0, 60, 2)) + [61, 100]
    jstore, store = jmutable.delete(jstore, dead), delete(store, dead)
    _assert_same_sparse_store(jstore, store)
    for threshold in (0.9, 0.5):
        jstore, jold = jmutable.maybe_compact(jstore, threshold=threshold)
        store, old = maybe_compact(store, threshold=threshold)
        assert (old is None) == (jold is None) == (threshold == 0.9)
    np.testing.assert_array_equal(old, jold)
    _assert_same_sparse_store(jstore, store)
    jstore, jold = jmutable.compact(jmutable.delete(jstore, [1]))
    store, old = compact(delete(store, [1]))
    np.testing.assert_array_equal(old, jold)
    _assert_same_sparse_store(jstore, store)
    assert (store.indices[store.n_live:] == 512).all()


def test_maybe_compact_threshold_policy():
    corpus, queries = _data(120, 256, 2, seed=17)
    cfg = BMOConfig(k=2, delta=0.05, block=32, batch_arms=16, metric="l2")
    store = build_index(corpus, cfg, device="cpu")              # cap 128
    same, old_ids = maybe_compact(store, threshold=0.5)
    assert old_ids is None and same is store                    # 8/128 dead

    store = delete(store, list(range(60, 120)))                 # 68/128 dead
    assert tombstone_fraction(store) == 68 / 128
    compacted, old_ids = maybe_compact(store, threshold=0.5)
    assert old_ids is not None
    assert compacted.capacity == 64 and compacted.n_live == 60
    assert old_ids.tolist() == list(range(60)) + [-1] * 4
    want = index_knn(store, queries, 3)
    got = index_knn(compacted, queries, 3)
    remapped = [set(int(old_ids[j]) for j in row)
                for row in got.indices.tolist()]
    assert remapped == sets(want.indices)


def test_compact_zeroes_the_empty_slots():
    corpus, _ = _data(40, 64, 1)
    store = build_index(corpus, _cfg(block=16), device="cpu")    # cap 64
    store2, old_ids = compact(delete(store, list(range(0, 40, 2))))
    assert store2.capacity == 32 and old_ids[:20].tolist() == \
        list(range(1, 40, 2))
    assert torch.equal(store2.x[:20], store.x[1:40:2])
    assert torch.equal(store2.prior_var[:20], store.prior_var[1:40:2])
    assert (store2.x[20:] == 0).all() and (store2.prior_var[20:] == 0).all()
    assert store2.alive.tolist() == [True] * 20 + [False] * 12


@pytest.mark.parametrize("rotate", [False, True], ids=["dense", "rotated"])
def test_save_load_round_trip(tmp_path, rotate):
    cfg = BMOConfig(k=3, delta=0.01, batch_arms=16, metric="l2", block=64,
                    rotate=rotate)
    corpus, queries = _data(100, 256, 2, seed=3)
    store = build_index(corpus, cfg, device="cpu")
    path = os.path.join(tmp_path, "idx")
    builder.save_index(store, path)
    store2 = builder.load_index(path, device="cpu")
    assert isinstance(store2, IndexStore) and store2.kind == store.kind
    assert store2.meta() == store.meta()
    for name, arr in store.arrays().items():
        assert torch.equal(store2.arrays()[name], arr)
    r1 = index_knn(store, queries, 1)
    r2 = index_knn(store2, queries, 1)
    assert torch.equal(r1.indices, r2.indices)
    assert torch.equal(r1.values, r2.values)


# ---------------------------------------------------------------------------
# value semantics
# ---------------------------------------------------------------------------

def _snapshot(store):
    return {k: v.clone() for k, v in store.arrays().items()}, store.n_live


def _assert_unchanged(store, snap):
    arrays, n_live = snap
    for name, arr in store.arrays().items():
        assert torch.equal(arr, arrays[name]), name
    assert store.n_live == n_live == int(store.alive.sum())


@pytest.mark.parametrize("rotate", [False, True], ids=["dense", "rotated"])
def test_mutations_leave_the_old_store_unchanged(rotate):
    corpus, queries = _data(60, 100, 2, seed=6)
    idx = Index.build(corpus, BMOConfig(**cfg_kw(rotate)), device="cpu",
                      capacity=64)
    steps = [lambda: idx.insert(queries), lambda: idx.delete([0, 1, 61]),
             lambda: idx.insert(np.ones((8, 100), np.float32)),
             lambda: idx.delete(list(range(2, 50))), idx.compact]
    for step in steps:
        old = idx.store
        snap = _snapshot(old)
        step()
        assert idx.store is not old
        _assert_unchanged(old, snap)
        assert idx.n_live == int(idx.store.alive.sum())
    assert free_slots(idx.store).tolist() == list(range(idx.n_live, 32))


# ---------------------------------------------------------------------------
# what the port does not serve yet
# ---------------------------------------------------------------------------

def test_sharded_index_raises_not_implemented(tmp_path):
    """Once a refusal pin (Queue 1 item 7); the sharded index is ported:
    ``build(shards=2)``, a single-shard directory loaded at two shards, and
    a sharded directory read back, each answering the brute-force top-k
    (``tests/test_torch_sharded.py`` and ``test_torch_admin.py`` hold them
    to the reference)."""
    corpus, queries = _data(64, 64, 2)
    truth = [set(r) for r in np.argsort(
        ((queries[:, None] - corpus[None]) ** 2).sum(-1), 1)[:, :3].tolist()]
    idx = Index.build(corpus, _cfg(block=16), device="cpu", shards=2)
    assert idx.n_shards == 2
    row_of = np.full(idx.capacity, -1)
    row_of[idx.build_gids] = np.arange(64)
    assert [set(r) for r in row_of[idx.query(queries).indices].tolist()] \
        == truth
    path = str(tmp_path / "idx")
    Index.build(corpus, _cfg(block=16), device="cpu").save(path)
    resharded = Index.load(path, shards=2, device="cpu")
    assert resharded.n_shards == 2 and resharded.n_live == 64
    spath = str(tmp_path / "sharded")
    idx.save(spath)
    assert os.path.exists(os.path.join(spath, "manifest.msgpack"))
    back = Index.load(spath, device="cpu")
    assert back.n_shards == 2
    assert [set(r) for r in row_of[back.query(queries).indices].tolist()] \
        == truth


def test_a_saved_sparse_index_loads_in_both_packages(tmp_path):
    """A sparse directory saved by the reference loads in the port and the
    port's in the reference, every array bit for bit; both loaded stores
    race the same queries to the same decisions on the reference's draws."""
    from repro.core.datasets import SparseDataset as JaxSparseDataset
    from repro.data.synthetic import clustered_sparse
    from repro.index.batched_race import index_knn as jax_index_knn
    from repro.index.builder import load_index as jax_load_index
    from test_torch_replay import replay_coord_sampler, triplet
    corpus = clustered_sparse(40, 128, seed=3)
    cfg = dict(k=3, delta=0.01, batch_arms=16, metric="l1", block=1,
               pulls_per_round=8, init_pulls=16, sparse=True)
    jstore = jax_build_index(corpus, JaxBMOConfig(**cfg),
                             jax.random.PRNGKey(0))
    jax_save_index(jstore, str(tmp_path / "from_jax"))
    loaded = Index.load(str(tmp_path / "from_jax"), device="cpu")
    loaded.save(str(tmp_path / "from_port"))
    back = jax_load_index(str(tmp_path / "from_port"))
    assert loaded.kind == back.kind == "sparse"
    assert loaded.store.meta() == back.meta() == jstore.meta()
    for name, arr in jstore.arrays().items():
        np.testing.assert_array_equal(loaded.store.arrays()[name].numpy(),
                                      np.asarray(arr), name)
        np.testing.assert_array_equal(np.asarray(back.arrays()[name]),
                                      np.asarray(arr), name)
        assert back.arrays()[name].dtype == arr.dtype
    q = triplet(JaxSparseDataset.build(corpus[:2]))
    key = jax.random.PRNGKey(1)
    want = jax_index_knn(back, q, key)
    got = index_knn(loaded.store, q, coord_sampler=replay_coord_sampler(key))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.rounds.numpy(), np.asarray(want.rounds))


def _saved_tuned_index(tmp_path):
    """A small CPU index with a tuned config installed, saved with its
    ``tuned.json``: (index, the tuned config, the build config, its path,
    the queries)."""
    from repro_torch.tune import TunedConfig, cache_clear
    corpus, queries = _data(64, 64, 2)
    idx = Index.build(corpus, _cfg(block=16), device="cpu")
    build_cfg = idx.cfg
    tuned = TunedConfig(epoch_rounds=2, pulls_per_round=1, batch_arms=4,
                        mode="fused", round_ms=0.5)
    idx._apply_tuned(tuned)
    path = str(tmp_path / "idx")
    idx.save(path)
    cache_clear()
    return idx, tuned, build_cfg, path, corpus, queries


def test_tuned_sidecar_applies_when_its_signature_matches(tmp_path):
    """A ``tuned.json`` whose signature matches the reloaded store is
    applied: the loaded index serves the tuned config and answers as the
    index that was saved."""
    idx, tuned, build_cfg, path, _, queries = _saved_tuned_index(tmp_path)
    loaded = Index.load(path, device="cpu")
    assert loaded.tuned == tuned and loaded.cfg == tuned.bind(build_cfg)
    np.testing.assert_array_equal(loaded.query(queries, 1).indices,
                                  idx.query(queries, 1).indices)


def test_tuned_sidecar_is_logged_and_not_applied(tmp_path, caplog):
    """A drifted ``tuned.json`` (the sidecar of one store beside a store of
    another scale bucket) is logged with its reason and not applied: the
    index serves its build-time config."""
    _, _, build_cfg, path, corpus, _ = _saved_tuned_index(tmp_path)
    other = str(tmp_path / "other")
    Index.build(corpus[:30], _cfg(block=16), device="cpu").save(other)
    with open(os.path.join(path, "tuned.json")) as f, \
            open(os.path.join(other, "tuned.json"), "w") as g:
        g.write(f.read())
    with caplog.at_level(logging.WARNING, logger="repro_torch.tune"):
        drifted = Index.load(other, device="cpu")
    assert any("tuned.json" in r.getMessage() and "signature drift"
               in r.getMessage() for r in caplog.records)
    assert drifted.tuned is None and drifted.cfg == build_cfg
