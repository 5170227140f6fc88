"""The port's anytime sessions, query cache and handle cache, held against
the JAX package on the CPU.

* Sessions: the port's and the reference's ``make_session`` over the same
  store, the reference's draws replayed through the port's samplers,
  stepped epoch by epoch. Equal exactly: the snapshot's ids, ``acc_count``
  and ``done``, ``rounds``, the frontier width and whether the race goes
  on. To fp32 tolerance (rtol 2e-4 / atol 1e-5, sums taken in another
  order): values, CI radii, ``cand_lcb_min`` and coordinate ops. Dense,
  rotated (d = d_pad), sparse (in chunks of rounds), and a row retired
  mid-race.
* Scale (ROADMAP.md Queue 3 item 2): with d = 1100 → d_pad = 2048 the
  reference's session exact-evaluates on ρ/d and loses recall; the port's
  races on ρ/d_pad and finishes exact, reporting θ = ρ/d.
* One host sync per epoch, counted through ``utils.hostsync.host_fetch``.
* ``QueryCache`` against the reference's on one sequence, keys byte-equal;
  the handle's cache and its epoch fence (the reference's
  ``tests/test_api.py`` scenario on the port).
"""
import jax
import numpy as np
import pytest
import torch

from repro.api.cache import QueryCache as JaxQueryCache
from repro.configs.base import BMOConfig as JaxBMOConfig
from repro.core import datasets as jdatasets
from repro.data import synthetic as jsynthetic
from repro.index.anytime import make_session as jax_make_session
from repro.index.builder import build_index as jax_build_index
from repro_torch.api import CachePolicy, Index, QueryCache
from repro_torch.configs.base import BMOConfig
from repro_torch.index.anytime import make_session
from repro_torch.index.store import IndexStore
from repro_torch.utils import hostsync

from test_torch_replay import (FP32, carry, replay_coord_sampler,
                               replay_sampler, sets, triplet)

SPARSE_CFG = dict(k=3, delta=0.01, block=1, batch_arms=16,
                  pulls_per_round=8, init_pulls=16, metric="l1", sparse=True)


def _dense_stores(rotate, n=300, d=1024, Q=4, seed=33):
    corpus, queries = jsynthetic.make_knn_benchmark_data("dense", n, d, Q,
                                                         seed=seed)
    cfg = JaxBMOConfig(k=3, delta=0.01, block=64, batch_arms=16,
                       pulls_per_round=2, metric="l2", rotate=rotate)
    jstore = jax_build_index(corpus, cfg, jax.random.PRNGKey(0))
    return jstore, IndexStore.from_arrays(*carry(jstore), device="cpu"), \
        queries


def _sparse_stores():
    corpus = jsynthetic.clustered_sparse(200, 512, seed=4)
    jstore = jax_build_index(corpus, JaxBMOConfig(**SPARSE_CFG),
                             jax.random.PRNGKey(0))
    queries = triplet(jdatasets.SparseDataset.build(corpus[:4]))
    return jstore, IndexStore.from_arrays(*carry(jstore), device="cpu"), \
        queries


def _assert_same_snapshot(want, got, what):
    for f in ("ids", "acc_count", "done", "rounds"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{what}: {f}")
    for f in ("values", "ci", "cand_lcb_min", "coord_ops"):
        np.testing.assert_allclose(getattr(got, f),
                                   np.asarray(getattr(want, f)), **FP32,
                                   err_msg=f"{what}: {f}")


def _lockstep(jsess, sess, retire=None):
    """Step both sessions to the end, their snapshots compared after the
    init and every epoch; after epoch ``retire`` both retire the first row
    still racing. Returns (the epochs run, the retired row, its rounds when
    retired)."""
    epoch, row, rounds = 0, None, None
    while True:
        _assert_same_snapshot(jsess.snapshot, sess.snapshot, f"epoch {epoch}")
        if hasattr(jsess, "_st") and hasattr(jsess._st, "ids"):
            assert sess._st.width == jsess._st.width, epoch
        if retire is not None and epoch == retire:
            row = int(np.flatnonzero(~sess.done)[0])
            rounds = int(sess.snapshot.rounds[row])
            mask = np.arange(sess.Q) == row
            jsess.retire(mask)
            sess.retire(mask)
        going = sess.step()
        assert going == jsess.step(), epoch
        epoch += 1
        if not going:
            break
    assert sess.done.all() and jsess.done.all()
    return epoch, row, rounds


@pytest.mark.parametrize("box,retire", [
    ("dense", None), ("rotated", None), ("sparse", None),
    ("dense", 1), ("sparse", 2)],
    ids=["dense", "rotated", "sparse", "dense-retire", "sparse-retire"])
def test_replayed_session_makes_the_reference_decisions(box, retire):
    key = jax.random.PRNGKey(5)
    if box == "sparse":
        jstore, store, queries = _sparse_stores()
        sampler = {"coord_sampler": replay_coord_sampler(key)}
    else:
        jstore, store, queries = _dense_stores(box == "rotated")
        sampler = {"block_sampler": replay_sampler(key)}
    jsess = jax_make_session(jstore, queries, key)
    sess = make_session(store, queries, **sampler)
    assert sess.kind == jsess.kind
    epochs, row, rounds = _lockstep(jsess, sess, retire)
    assert epochs >= 3
    if retire is not None:          # the retired row stopped where it was
        assert sess.snapshot.rounds[row] == rounds
        assert sess.snapshot.acc_count[row] < sess.k


def test_session_is_exact_where_the_reference_loses_recall():
    """With d_pad ≠ d (1100 → 2048) the reference's session exact-evaluates
    on ρ/d and returns the wrong top-k for queries 2, 6 and 7 (ROADMAP.md
    Queue 3 item 2). The port's, on the reference's draws, races on ρ/d_pad
    and returns the exact top-k with the values θ = ρ/d."""
    corpus, queries = jsynthetic.make_knn_benchmark_data("dense", 3000,
                                                         1100, 8, seed=0)
    cfg = JaxBMOConfig(k=5, delta=0.01, block=128, batch_arms=32,
                       metric="l2", rotate=True)
    jstore = jax_build_index(corpus, cfg, jax.random.PRNGKey(0))
    store = IndexStore.from_arrays(*carry(jstore), device="cpu")
    assert (store.d, store.d_pad) == (1100, 2048)
    c, q = corpus.astype(np.float64), queries.astype(np.float64)
    dist = (q * q).sum(1)[:, None] + (c * c).sum(1)[None] - 2.0 * q @ c.T
    truth = [set(r) for r in np.argsort(dist, 1, kind="stable")[:, :5].tolist()]
    key = jax.random.PRNGKey(1)

    jsess = jax_make_session(jstore, queries, key)
    while jsess.step():
        pass
    missed = [i for i, row in enumerate(sets(jsess.snapshot.ids))
              if row != truth[i]]
    assert missed == [2, 6, 7]

    sess = make_session(store, queries, block_sampler=replay_sampler(key))
    while sess.step():
        pass
    snap = sess.snapshot
    assert sets(snap.ids) == truth
    assert (snap.acc_count == 5).all() and (snap.ci == 0).all()
    theta = np.take_along_axis(dist, snap.ids.astype(np.int64), 1) / 1100
    np.testing.assert_allclose(snap.values, theta, rtol=2e-4)


@pytest.mark.parametrize("box", ["dense", "sparse"])
def test_one_host_sync_per_fused_epoch(box):
    """A fused session crosses to the host once at its init and once per
    epoch; the sparse session once per round of a chunk and once for the
    chunk's summary."""
    if box == "sparse":
        _, store, queries = _sparse_stores()
    else:
        _, store, queries = _dense_stores(False)
    hostsync.reset_syncs()
    sess = make_session(store, queries, 3, chunk_rounds=4)
    init = hostsync.syncs()
    per_epoch = []
    while True:
        before, rounds = hostsync.syncs(), sess._rounds_spent
        going = sess.step()
        per_epoch.append(hostsync.syncs() - before)
        if not going:
            break
    if box == "dense":
        assert init == 1 and per_epoch == [1] * len(per_epoch)
    else:
        # the init's round sync and the summary; then the chunk's rounds
        assert init == 2 and all(2 <= s <= 5 for s in per_epoch)


def test_make_session_guards():
    _, store, queries = _dense_stores(False)
    with pytest.raises(ValueError, match="live slots"):
        make_session(store, queries, cfg=BMOConfig(k=10_000))

    # a sharded store (once refused as Queue 1 item 7) opens its own
    # session, under the same k guard
    from repro_torch.index.sharded import build_sharded_index
    sharded, _ = build_sharded_index(store.x[:300].numpy(), store.cfg,
                                     shards=2, device="cpu")
    sess = make_session(sharded, queries, 1)
    assert sess.kind == "sharded_fused" and sess.Q == len(queries)
    with pytest.raises(ValueError, match="live slots"):
        make_session(sharded, queries, cfg=BMOConfig(k=10_000))


def test_host_fetch_is_one_copy_of_any_dtypes():
    parts = (torch.arange(5, dtype=torch.int32), torch.tensor([True, False]),
             torch.randn(2, 3), torch.tensor(2.5, dtype=torch.float64), 7)
    hostsync.reset_syncs()
    got = hostsync.host_fetch(parts)
    assert hostsync.syncs() == 1 and got[-1] == 7
    for want, arr in zip(parts[:-1], got[:-1]):
        assert arr.dtype == want.numpy().dtype and arr.shape == want.shape
        np.testing.assert_array_equal(arr, want.numpy())
    host = np.ones(3)
    assert hostsync.host_fetch(host) is host and hostsync.syncs() == 1


# ---------------------------------------------------------------------------
# the query cache and the handle's cache
# ---------------------------------------------------------------------------

def test_query_cache_is_the_references():
    r = np.random.default_rng(0)
    rows = r.normal(size=(6, 32)).astype(np.float32)
    near = rows[1] + np.float32(1e-3) * r.normal(size=32).astype(np.float32)
    got, want = QueryCache(4), JaxQueryCache(4)
    for cache in (got, want):
        assert QueryCache.key(rows[0]) == JaxQueryCache.key(rows[0])
        assert QueryCache.key(rows[0], "ns") == JaxQueryCache.key(rows[0],
                                                                  "ns")
    trace = []
    for cache in (got, want):
        out = []
        for i in range(5):
            cache.put(cache.key(rows[i]), (np.arange(3) + i, rows[i][:3]),
                      vec=rows[i])
        out.append(cache.get(cache.key(rows[0])))       # evicted
        out.append(cache.get(cache.key(rows[2]))[0])    # hit, now newest
        cache.put(cache.key(rows[5]), (np.arange(3) + 5, rows[5][:3]),
                  vec=rows[5])                           # evicts row 1
        out.append(cache.get_near(near, 0.95))           # row 1 is gone
        out.append(cache.get_near(rows[3] * 2.0, 0.95)[0])
        out.append(cache.get_near(np.zeros(32, np.float32), 0.5))
        out.append(sorted(cache._od))
        cache.clear()
        out.append(len(cache))
        out.append((cache.hits, cache.misses))
        trace.append(out)
    g, w = trace
    assert g[0] is None and w[0] is None
    np.testing.assert_array_equal(g[1], w[1])
    assert g[2] is None and w[2] is None
    np.testing.assert_array_equal(g[3], w[3])
    assert g[4] is None and w[4] is None
    assert g[5] == w[5] and g[6] == w[6] == 0 and g[7] == w[7]


def test_handle_cache_hits_refresh_and_epoch_fence():
    """The reference's ``tests/test_api.py`` scenario on the port."""
    corpus, queries = jsynthetic.make_knn_benchmark_data("dense", 200, 256,
                                                         4, seed=0)
    cfg = BMOConfig(k=3, delta=0.01, block=32, batch_arms=16,
                    pulls_per_round=2, metric="l2")
    idx = Index.build(corpus, cfg, device="cpu",
                      cache=CachePolicy(capacity=8, near_threshold=0.0))
    r1 = idx.query(queries, 1)
    assert r1.cache_hits == 0 and float(r1.coord_ops.sum()) > 0
    r2 = idx.query(queries, 9)                      # rng must not matter
    assert r2.cache_hits == 4 and float(r2.coord_ops.sum()) == 0.0
    np.testing.assert_array_equal(r1.indices, r2.indices)
    st = idx.stats
    assert (st.races, st.raced_queries, st.cache_hits) == (1, 4, 4)
    # refresh forces a re-race and overwrites the entries
    r3 = idx.query(queries, 2, cache="refresh")
    assert r3.cache_hits == 0 and idx.stats.races == 2
    # bypass leaves the cache untouched
    idx.query(queries, 3, cache="bypass")
    assert idx.stats.cache_entries == 4
    # a tensor query keys like its numpy rows
    assert idx.query(torch.from_numpy(queries), 4).cache_hits == 4
    # epoch fence: any mutation invalidates
    idx.delete([int(r1.indices[0, 0])])
    assert idx.stats.cache_entries == 0
    # an EMPTY QueryCache is falsy (__len__): the cumulative counters
    # survive the invalidation
    assert idx.stats.cache_hits == 8 and idx.stats.cache_misses == 4
    r5 = idx.query(queries, 4)
    assert r5.cache_hits == 0
    assert int(r1.indices[0, 0]) not in set(r5.indices[0].tolist())


def test_handle_near_repeat_seeds_priors_and_pads_misses():
    """A near repeat races with priors seeded from its cached neighbour
    (``near_hits``); the missed rows race as a power-of-two batch, and a
    seeded ``prior_hint`` passes through ``query`` uncached."""
    corpus, queries = jsynthetic.make_knn_benchmark_data("dense", 200, 256,
                                                         3, seed=2)
    cfg = BMOConfig(k=3, delta=0.01, block=32, batch_arms=16,
                    pulls_per_round=2, metric="l2")
    idx = Index.build(corpus, cfg, device="cpu")
    first = idx.query(queries, 1)
    assert idx.stats.raced_queries == 3
    near = queries + np.float32(1e-3)
    res = idx.query(near, 2)
    assert idx.stats.near_hits == 3 and res.cache_hits == 0
    np.testing.assert_array_equal(np.sort(res.indices, 1),
                                  np.sort(first.indices, 1))
    hint = np.tile(idx.store.prior_var.numpy(), (3, 1))
    res = idx.query(queries, 3, prior_hint=hint)
    assert res.cache_hits == 0 and idx.stats.races == 3
    assert sets(res.indices) == sets(first.indices)


def test_race_refuses_rounds_on_a_dense_box():
    corpus, queries = jsynthetic.make_knn_benchmark_data("dense", 64, 128,
                                                         2, seed=0)
    idx = Index.build(corpus, BMOConfig(k=2, block=32), device="cpu")
    with pytest.raises(ValueError, match="blocking-query only"):
        idx.race(queries, mode="rounds")
    sess = idx.race(queries, 0, raced_queries=1)
    assert sess.kind == "fused" and idx.stats.raced_queries == 1
