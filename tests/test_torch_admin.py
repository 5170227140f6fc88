"""The sharded store's lifecycle, files and admin operations held against
the JAX package on the CPU, and the handle over a sharded index.

The reference needs its mesh only to race; building, mutating, saving,
loading and re-sharding a ``ShardedIndexStore`` run in this process on
both sides.

* Placement (``index/placement.py``): round-robin, least-loaded, the
  addressing and ``balance`` give the reference's integers.
* Global-id maps: build, least-loaded insert with uniform growth,
  tombstones, compaction and re-shard return the reference's maps, and
  the stores' arrays agree (bit for bit where the data only moves; the
  priors, computed by each package, at fp32 tolerance).
* Files: a sharded directory written by either package loads in the other
  with equal arrays and manifest; ``load(shards=S′)`` re-shards.
* ``live_reshard`` is bit-identical to a save at S and a load at S′.
* The handle: build, query, mutate, save and load at two shards (payload
  and build map kept aligned), the read fan-out, the admin fence, and the
  per-shard telemetry.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import BMOConfig as JaxBMOConfig
from repro.data.synthetic import make_knn_benchmark_data
from repro.index import placement as jplc
from repro.index import sharded as jsh
from repro_torch.api import Index
from repro_torch.configs.base import BMOConfig
from repro_torch.index import placement as plc
from repro_torch.index import sharded as sh
from repro_torch.index.store import IndexStore

from test_torch_replay import FP32

CFG = dict(k=3, delta=0.01, block=32, batch_arms=16, metric="l2")


def _jax_store(corpus, S, rotate=False, **kw):
    return jsh.build_sharded_index(
        corpus, JaxBMOConfig(rotate=rotate, **CFG), jax.random.PRNGKey(0),
        shards=S, **kw)


def _carry(jstore, device="cpu"):
    """A reference sharded store as the port's, shard by shard."""
    return sh.ShardedIndexStore(
        [IndexStore.from_arrays({k: np.asarray(v) for k, v in
                                 s.arrays().items()}, s.meta(), device=device)
         for s in jstore.shards], jstore.placement)


def _same_store(store, jstore, exact_priors=True):
    assert store.n_shards == jstore.n_shards
    assert (store.stride, store.capacity, store.n_live) == \
        (jstore.stride, jstore.capacity, jstore.n_live)
    assert store.live_per_shard == jstore.live_per_shard
    for s, js in zip(store.shards, jstore.shards):
        assert s.meta() == js.meta()
        for name, arr in js.arrays().items():
            got = s.arrays()[name].numpy()
            if name == "prior_var" and not exact_priors:
                np.testing.assert_allclose(got, np.asarray(arr), **FP32)
            else:
                np.testing.assert_array_equal(got, np.asarray(arr), name)


# ---------------------------------------------------------------------------
# placement and global-id maps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loads,n", [([0, 0, 0], 10), ([5, 0, 3, 5], 8),
                                     ([2, 2], 5), ([7], 3)])
def test_placement_is_the_references(loads, n):
    for policy in plc.PLACEMENTS:
        np.testing.assert_array_equal(plc.assign(policy, loads, n),
                                      jplc.assign(policy, loads, n))
    np.testing.assert_array_equal(plc.assign_round_robin(n, len(loads),
                                                         start=1),
                                  jplc.assign_round_robin(n, len(loads),
                                                          start=1))
    assert plc.balance(loads) == jplc.balance(loads)
    with pytest.raises(ValueError, match="unknown placement"):
        plc.assign("hash", loads, n)
    gid = plc.global_id(torch.tensor([3, 1]), torch.tensor([17, 0]), 128)
    assert plc.shard_of(gid, 128).tolist() == [3, 1]
    assert plc.local_of(gid, 128).tolist() == [17, 0]
    assert int(plc.global_id(3, 17, 128)) == jplc.global_id(3, 17, 128)


@pytest.mark.parametrize("placement", ["round_robin", "least_loaded"])
@pytest.mark.parametrize("S", [2, 3])
def test_build_gids_and_layout_are_the_references(S, placement):
    corpus, _ = make_knn_benchmark_data("dense", 70, 96, 1, seed=2)
    jstore, jgids = _jax_store(corpus, S, placement=placement)
    store, gids = sh.build_sharded_index(
        corpus, BMOConfig(**CFG), 0, shards=S, placement=placement,
        device="cpu")
    np.testing.assert_array_equal(gids, jgids)
    _same_store(store, jstore, exact_priors=False)
    assert store.stacked_x.shape == (S, store.stride, store.d_pad)
    for i in (0, 13, 69):
        s, l = plc.shard_of(gids[i], store.stride), plc.local_of(
            gids[i], store.stride)
        np.testing.assert_array_equal(store.shards[s].x[l, :96].numpy(),
                                      corpus[i])


def test_mutation_maps_are_the_references():
    """Least-loaded inserts that grow the stride, tombstones, the global
    compaction policy and compaction: the same ids and maps and the same
    arrays, step by step."""
    corpus, queries = make_knn_benchmark_data("dense", 60, 96, 40, seed=3)
    jstore, jgids = _jax_store(corpus, 2)
    store = _carry(jstore)
    steps = [("insert", queries[:5]), ("delete", jgids[:20]),
             ("insert", queries[5:40]), ("delete", np.arange(3, 80, 2)),
             ("maybe", 0.9), ("maybe", 0.3), ("compact", None)]
    for op, arg in steps:
        if op == "insert":
            jstore, jg, jold = jsh.sharded_insert(jstore, arg)
            store, g, old = sh.sharded_insert(store, arg)
            np.testing.assert_array_equal(g, jg)
            assert (old is None) == (jold is None)
            if old is not None:
                np.testing.assert_array_equal(old, jold)
        elif op == "delete":
            arg = arg[arg < jstore.capacity]
            jstore = jsh.sharded_delete(jstore, arg)
            store = sh.sharded_delete(store, arg)
        else:
            if op == "maybe":
                jstore, jold = jsh.sharded_maybe_compact(jstore,
                                                         threshold=arg)
                store, old = sh.sharded_maybe_compact(store, threshold=arg)
            else:
                jstore, jold = jsh.sharded_compact(jstore)
                store, old = sh.sharded_compact(store)
            assert (old is None) == (jold is None)
            if old is not None:
                np.testing.assert_array_equal(old, jold)
        assert sh.tombstone_fraction(store) == jsh.tombstone_fraction(jstore)
        _same_store(store, jstore, exact_priors=False)   # inserts' priors
        assert store.stacked_x is not None
    with pytest.raises(ValueError, match="global ids"):
        sh.sharded_delete(store, [store.capacity])


@pytest.mark.parametrize("S0,S1", [(2, 3), (3, 1), (1, 4)])
def test_reshard_is_the_references(S0, S1):
    corpus, _ = make_knn_benchmark_data("dense", 50, 64, 1, seed=4)
    jstore, jgids = _jax_store(corpus, S0, rotate=True)
    jstore = jsh.sharded_delete(jstore, jgids[[1, 7, 30]])
    want, jold = jsh.reshard(jstore, S1)
    got, old = sh.reshard(_carry(jstore), S1)
    np.testing.assert_array_equal(old, jold)
    _same_store(got, want)
    assert got.stacked_x is not None


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "rotated", "sparse"])
def test_sharded_directories_load_in_either_package(tmp_path, kind):
    if kind == "sparse":
        from repro.data.synthetic import clustered_sparse
        corpus = clustered_sparse(40, 128, seed=1)
        jcfg = JaxBMOConfig(k=3, delta=0.01, batch_arms=16, metric="l1",
                            block=1, pulls_per_round=8, init_pulls=16,
                            sparse=True)
        jstore, jgids = jsh.build_sharded_index(
            corpus, jcfg, jax.random.PRNGKey(0), shards=2)
    else:
        corpus, _ = make_knn_benchmark_data("dense", 45, 80, 1, seed=5)
        jstore, jgids = _jax_store(corpus, 3, rotate=kind == "rotated")
    jstore = jsh.sharded_delete(jstore, jgids[[0, 4]])
    jdir, pdir = str(tmp_path / "j"), str(tmp_path / "p")
    jsh.save_sharded_index(jstore, jdir)
    store, old = sh.load_sharded_index(jdir, device="cpu")
    assert old is None and sh.is_sharded_index_dir(jdir)
    _same_store(store, jstore)
    assert sh.read_manifest(jdir) == jsh.read_manifest(jdir)

    sh.save_sharded_index(store, pdir)
    assert sh.read_manifest(pdir) == jsh.read_manifest(jdir)
    back, _ = jsh.load_sharded_index(pdir)
    _same_store(store, back)
    # a load at S′ re-shards on the way in, as the reference's does
    re_p, old_p = sh.load_sharded_index(pdir, shards=1, device="cpu")
    re_j, old_j = jsh.load_sharded_index(jdir, shards=1)
    np.testing.assert_array_equal(old_p, old_j)
    _same_store(re_p, re_j)


@pytest.mark.parametrize("S0,S1", [(4, 2), (2, 3)])
def test_live_reshard_is_bit_identical_to_save_and_load(tmp_path, S0, S1):
    corpus, queries = make_knn_benchmark_data("dense", 90, 100, 3, seed=6)
    idx = Index.build(corpus, BMOConfig(rotate=True, **CFG), 1, shards=S0,
                      device="cpu", payload=np.arange(90) + 7)
    idx.delete(idx.build_gids[[2, 3, 50]])
    idx.insert(queries, payload=[1, 2, 3])
    path = str(tmp_path / "idx")
    idx.save(path)
    epoch = idx.epoch
    old_ids = idx.reshard(S1)
    assert idx.n_shards == S1 and idx.epoch == epoch + 1
    assert idx.stats.reshards == 1
    loaded = Index.load(path, shards=S1, device="cpu")
    for a, b in zip(idx.store.shards, loaded.store.shards):
        for name, arr in a.arrays().items():
            assert torch.equal(arr, b.arrays()[name]), name
    np.testing.assert_array_equal(idx.payload, loaded.payload)
    live = old_ids >= 0
    assert (idx.payload[live] != 0).all() and (idx.payload[~live] == 0).all()
    rows = np.array([0, 1, 4, 5])             # rows 2 and 3 were deleted
    got = idx.query(corpus[rows], cache="bypass")
    assert (idx.payload[got.indices[:, 0]] == rows + 7).all()


def test_live_reshard_refuses_missing_devices_and_keeps_serving(
        monkeypatch):
    """Too few devices for S′ (``shard_devices`` raises, as with fewer
    CUDA devices than shards): the op fails before touching the handle."""
    from repro_torch.api import admin
    corpus, queries = make_knn_benchmark_data("dense", 40, 64, 2, seed=7)
    idx = Index.build(corpus, BMOConfig(**CFG), device="cpu")

    def too_few(n, device=None, **kw):
        raise RuntimeError(f"{n} index shards need {n} devices")

    monkeypatch.setattr(admin, "shard_devices", too_few)
    with pytest.raises(RuntimeError, match="keeps serving"):
        idx.reshard(4)
    assert idx.n_shards == 1 and idx.epoch == 0
    assert idx.query(queries).indices.shape == (2, 3)
    with pytest.raises(ValueError, match="n_shards"):
        idx.reshard(0)


# ---------------------------------------------------------------------------
# the handle over a sharded index
# ---------------------------------------------------------------------------

def test_sharded_handle_queries_mutates_and_keeps_payload_aligned(tmp_path):
    corpus, queries = make_knn_benchmark_data("dense", 100, 128, 4, seed=8)
    idx = Index.build(corpus, BMOConfig(**CFG), 3, shards=2, device="cpu",
                      payload=np.arange(100) + 1)
    assert idx.sharded and idx.n_shards == 2 and "shards=2" in repr(idx)
    res = idx.query(corpus[:4])
    assert (idx.payload[res.indices[:, 0]] == np.arange(4) + 1).all()
    assert len(res.shard_coord_ops) == 2
    assert idx.stats.shard_coord_ops == pytest.approx(res.shard_coord_ops)
    gids = idx.insert(queries, payload=[201, 202, 203, 204])
    assert (idx.payload[gids] == [201, 202, 203, 204]).all()
    res = idx.query(queries, cache="bypass")
    assert (res.indices[:, 0] == gids).all()
    idx.delete(idx.build_gids[:90])
    assert (idx.build_gids[:90] == -1).all()
    old = idx.maybe_compact(threshold=0.5)
    assert old is not None and idx.stats.compactions == 1
    res = idx.query(corpus[95:99], cache="bypass")
    assert (idx.payload[res.indices[:, 0]] == np.arange(96, 100)).all()
    path = str(tmp_path / "i")
    idx.save(path)
    assert sh.is_sharded_index_dir(path)
    back = Index.load(path, device="cpu")
    assert back.n_shards == 2
    np.testing.assert_array_equal(back.payload, idx.payload)
    with pytest.raises(ValueError, match="capacity-length"):
        idx.attach_payload(np.arange(idx.n_live))


def test_read_fan_out_round_robins_and_the_fence_holds():
    corpus, queries = make_knn_benchmark_data("dense", 64, 64, 2, seed=9)
    idx = Index.build(corpus, BMOConfig(**CFG), shards=2, device="cpu")
    assert idx.add_replicas(3) == 3 and idx.stats.replicas == 3
    a = idx.query(queries, rng=5, cache="bypass")
    b = idx.query(queries, rng=5, cache="bypass")
    np.testing.assert_array_equal(a.indices, b.indices)
    assert idx._rr == 2 and len(idx._replica_stores) == 3
    idx.insert(queries)                 # a mutation drops the replicas
    assert idx._replica_stores is None
    with idx._admin_op("reshard"):
        with pytest.raises(RuntimeError, match="quiesced"):
            idx.insert(queries)
    with pytest.raises(ValueError, match="n_replicas"):
        idx.add_replicas(0)
