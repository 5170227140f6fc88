"""The port's sharded index (``repro_torch.index.sharded``), its sessions
and ``core.distributed`` held against the JAX package on the CPU.

The reference races a sharded store on a mesh of S devices, so its side
runs once, in one subprocess on a CPU inflated to 4 devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_sharded_index.py:_run`` does), and writes its stores (with its
own ``save_sharded_index``) and results to a directory the tests read. The
port loads those stores (a directory written by either package reads in
the other) with its shards on ``cpu``, and replays the reference's draws:
shard s of a race keyed ``key`` draws from ``fold_in(key, s)``
(``test_torch_replay.replay_sampler``).

* Sharded fused races at S ∈ {2, 4} (dense and rotated), the rounds race
  and the sparse box at S = 2: the same global top-k ids, rounds, exact
  evaluations and per-shard rounds; values and coordinate ops at fp32
  tolerance (rtol 2e-4 / atol 1e-5).
* The sharded fused session stepped to the end: the same merged ids,
  certified counts and epochs.
* ``distributed_knn`` on a 2 × 2 grid: the same ids, values, rounds and
  coordinate ops.
* Queue 3 item 2 (ROADMAP.md): at d = 1100 → d_pad = 2048 the reference's
  sharded fused and rounds races and its sharded session miss a query;
  the port's, on the same draws, race on ρ/d_pad and are exact.
* On the port's own draws: every sharded path returns the brute-force
  top-k, one host sync an epoch, and the merge helpers equal the
  reference's on identical operands.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import sharded as jsh
from repro_torch.configs.base import BMOConfig
from repro_torch.core.distributed import distributed_knn
from repro_torch.core.datasets import SparseDataset
from repro_torch.data.synthetic import make_knn_benchmark_data
from repro_torch.index import sharded as sh
from repro_torch.index.anytime import make_session
from repro_torch.utils import hostsync

from test_torch_replay import FP32, replay_coord_sampler, replay_sampler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DENSE_CFG = dict(k=3, delta=0.01, block=64, batch_arms=16, pulls_per_round=2,
                 metric="l2")
SPARSE_CFG = dict(k=3, delta=0.01, block=1, batch_arms=16, pulls_per_round=8,
                  init_pulls=16, metric="l1", sparse=True)
PIN_CFG = dict(k=5, delta=0.01, block=128, batch_arms=32, metric="l2",
               rotate=True)

# the reference's side: stores saved with its own save_sharded_index,
# results in one npz
REFERENCE = r'''
import os, sys
import repro
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import BMOConfig
from repro.core.datasets import SparseDataset
from repro.core.distributed import distributed_knn
from repro.data.synthetic import clustered_sparse, make_knn_benchmark_data
from repro.index import build_sharded_index, index_knn, save_sharded_index
from repro.index.anytime import make_session

out = sys.argv[1]
res = {}

def keep(name, r, fields):
    for f in fields:
        res[f"{name}/{f}"] = np.asarray(getattr(r, f))

KNN = ("indices", "values", "coord_ops", "rounds", "n_exact",
       "shard_coord_ops", "shard_rounds")
DENSE = dict(%(dense)s)
corpus, queries = make_knn_benchmark_data("dense", 512, 256, 6, seed=1)
res["dense/corpus"], res["dense/queries"] = corpus, queries
for rotate in (False, True):
    cfg = BMOConfig(rotate=rotate, **DENSE)
    for S in (2, 4):
        name = f"fused-{'rot' if rotate else 'dense'}-{S}"
        store, gids = build_sharded_index(corpus, cfg, jax.random.PRNGKey(0),
                                          shards=S)
        save_sharded_index(store, os.path.join(out, name))
        res[f"{name}/gids"] = gids
        keep(name, index_knn(store, queries, jax.random.PRNGKey(1)), KNN)
        if S == 2:
            keep(f"rounds-{name}", index_knn(store, queries,
                 jax.random.PRNGKey(2), mode="rounds"), KNN)
            sess = make_session(store, queries, jax.random.PRNGKey(3))
            while sess.step():
                pass
            keep(f"session-{name}", sess.snapshot,
                 ("ids", "acc_count", "done", "rounds", "n_exact"))
            res[f"session-{name}/epochs"] = np.asarray(sess.epochs)

sp = clustered_sparse(200, 512, seed=4)
ds = SparseDataset.build(sp)
store, gids = build_sharded_index(sp, BMOConfig(**dict(%(sparse)s)),
                                  jax.random.PRNGKey(0), shards=2)
save_sharded_index(store, os.path.join(out, "sparse-2"))
res["sparse-2/gids"] = gids
res["sparse/corpus"] = sp
keep("sparse-2", index_knn(store, (ds.indices[:4], ds.values[:4],
                                   ds.nnz[:4]), jax.random.PRNGKey(5)), KNN)

mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
X, qs = make_knn_benchmark_data("dense", 256, 512, 4, seed=0)
cfg = BMOConfig(k=3, delta=0.01, block=64, batch_arms=16, pulls_per_round=2,
                init_pulls=4, metric="l2")
keep("dist", distributed_knn(jnp.asarray(X), jnp.asarray(qs), cfg, mesh,
                             jax.random.PRNGKey(0), impl="ref"),
     ("indices", "values", "coord_ops", "rounds"))

corpus, queries = make_knn_benchmark_data("dense", 4000, 1100, 16, seed=0)
store, gids = build_sharded_index(corpus, BMOConfig(**dict(%(pin)s)),
                                  jax.random.PRNGKey(0), shards=2)
save_sharded_index(store, os.path.join(out, "pin"))
res["pin/gids"] = gids
keep("pin", index_knn(store, queries, jax.random.PRNGKey(1)), KNN)
keep("pin-rounds", index_knn(store, queries, jax.random.PRNGKey(1),
                             mode="rounds"), KNN)
sess = make_session(store, queries, jax.random.PRNGKey(1))
while sess.step():
    pass
keep("pin-session", sess.snapshot, ("ids", "acc_count", "done"))
np.savez(os.path.join(out, "results.npz"), **res)
print("OK")
''' % dict(dense=DENSE_CFG, sparse=SPARSE_CFG, pin=PIN_CFG)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded_ref"))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    run = subprocess.run([sys.executable, "-c", REFERENCE, out],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=900)
    assert run.returncode == 0 and "OK" in run.stdout, run.stderr[-3000:]
    with np.load(os.path.join(out, "results.npz")) as data:
        res = {k: data[k] for k in data.files}
    return out, res


def _load(ref, name):
    out, _ = ref
    store, old = sh.load_sharded_index(os.path.join(out, name), device="cpu")
    assert old is None
    return store


def _samplers(key, S, make=replay_sampler):
    return [make(jax.random.fold_in(key, s)) for s in range(S)]


def _same_knn(got, res, name, exact_fields=("indices", "rounds", "n_exact",
                                            "shard_rounds")):
    for f in exact_fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      res[f"{name}/{f}"], err_msg=f)
    for f in ("values", "coord_ops", "shard_coord_ops"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   res[f"{name}/{f}"], err_msg=f, **FP32)


def _truth(corpus, queries, k, metric="l2"):
    c, q = corpus.astype(np.float64), queries.astype(np.float64)
    if metric == "l1":
        dist = np.abs(q[:, None] - c[None]).sum(-1)
    else:
        dist = (q * q).sum(1)[:, None] + (c * c).sum(1)[None] - 2.0 * q @ c.T
    return dist, [set(r) for r in
                  np.argsort(dist, 1, kind="stable")[:, :k].tolist()]


def _rows(gids, capacity, ids):
    row_of = np.full(capacity, -1)
    row_of[gids] = np.arange(len(gids))
    return [set(r) for r in row_of[np.asarray(ids)].tolist()]


# ---------------------------------------------------------------------------
# replayed races against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["fused-dense-2", "fused-dense-4",
                                  "fused-rot-2", "fused-rot-4"])
def test_sharded_fused_race_makes_the_reference_decisions(ref, name):
    store = _load(ref, name)
    _, res = ref
    assert store.d == store.d_pad          # no scale difference here
    got = sh.sharded_index_knn(
        store, res["dense/queries"],
        block_samplers=_samplers(jax.random.PRNGKey(1), store.n_shards))
    _same_knn(got, res, name)


def test_sharded_rounds_race_makes_the_reference_decisions(ref):
    store = _load(ref, "fused-dense-2")
    _, res = ref
    got = sh.sharded_index_knn(
        store, res["dense/queries"], mode="rounds",
        block_samplers=_samplers(jax.random.PRNGKey(2), 2))
    _same_knn(got, res, "rounds-fused-dense-2")


@pytest.mark.parametrize("name", ["fused-dense-2", "fused-rot-2"])
def test_sharded_fused_session_makes_the_reference_decisions(ref, name):
    store = _load(ref, name)
    _, res = ref
    sess = make_session(store, res["dense/queries"],
                        block_samplers=_samplers(jax.random.PRNGKey(3), 2))
    while sess.step():
        pass
    snap, pre = sess.snapshot, f"session-{name}"
    for f in ("ids", "acc_count", "done", "rounds", "n_exact"):
        np.testing.assert_array_equal(np.asarray(getattr(snap, f)),
                                      res[f"{pre}/{f}"], err_msg=f)
    assert sess.epochs == int(res[f"{pre}/epochs"])


def test_sharded_sparse_race_makes_the_reference_decisions(ref):
    store = _load(ref, "sparse-2")
    _, res = ref
    assert store.kind == "sparse"
    ds = SparseDataset.build(torch.from_numpy(res["sparse/corpus"]))
    q = (ds.indices[:4], ds.values[:4], ds.nnz[:4])
    got = sh.sharded_index_knn(
        store, q, coord_samplers=_samplers(jax.random.PRNGKey(5), 2,
                                           replay_coord_sampler))
    _same_knn(got, res, "sparse-2")
    _, truth = _truth(res["sparse/corpus"], res["sparse/corpus"][:4], 3,
                      "l1")
    assert _rows(res["sparse-2/gids"], store.capacity, got.indices) == truth


def test_distributed_knn_on_a_grid_is_the_references(ref):
    _, res = ref
    X, qs = make_knn_benchmark_data("dense", 256, 512, 4, seed=0)
    key = jax.random.PRNGKey(0)

    def cell(i, j):
        # data row i folds its index into the key; each round's (or the
        # init's) subkey folds in the model part j before the draw
        state = {"key": jax.random.fold_in(key, i)}

        def sample(shape, nb):
            state["key"], sub = jax.random.split(state["key"])
            return torch.from_numpy(np.array(jax.random.randint(
                jax.random.fold_in(sub, j), shape, 0, nb)))
        return sample

    cfg = BMOConfig(k=3, delta=0.01, block=64, batch_arms=16,
                    pulls_per_round=2, init_pulls=4, metric="l2")
    got = distributed_knn(X, qs, cfg, [["cpu", "cpu"], ["cpu", "cpu"]],
                          block_samplers=cell)
    np.testing.assert_array_equal(got.indices.numpy(), res["dist/indices"])
    assert int(got.rounds) == int(res["dist/rounds"])
    np.testing.assert_allclose(got.values.numpy(), res["dist/values"], **FP32)
    np.testing.assert_allclose(float(got.coord_ops),
                               float(res["dist/coord_ops"]), **FP32)
    _, truth = _truth(X, qs, 3)
    assert [set(r) for r in got.indices.tolist()] == truth


def test_sharded_races_are_exact_where_the_reference_loses_recall(ref):
    """Queue 3 item 2: with d_pad ≠ d (1100 → 2048) the reference's sharded
    races and its sharded session (S = 2) exact-evaluate arms on ρ/d while
    their pulls estimate ρ/d_pad. On this input its fused race, its rounds
    race and its session all miss query 11. The port, on the reference's
    own draws, races on ρ/d_pad and returns the exact top-k from all three,
    with θ = ρ/d values. (The single-shard pin's input, 3,000 rows and 8
    queries, loses no query at S = 2: each shard races half the rows.)"""
    store = _load(ref, "pin")
    _, res = ref
    assert (store.d, store.d_pad) == (1100, 2048)
    corpus, queries = make_knn_benchmark_data("dense", 4000, 1100, 16,
                                              seed=0)
    dist, truth = _truth(corpus, queries, 5)
    gids = res["pin/gids"]

    def missed(ids):
        return [i for i, row in enumerate(_rows(gids, store.capacity, ids))
                if row != truth[i]]

    assert missed(res["pin/indices"]) == [11]
    assert missed(res["pin-rounds/indices"]) == [11]
    assert missed(res["pin-session/ids"]) == [11]

    key = jax.random.PRNGKey(1)
    got = sh.sharded_index_knn(store, queries,
                               block_samplers=_samplers(key, 2))
    assert missed(got.indices) == []
    row_of = np.full(store.capacity, -1)
    row_of[gids] = np.arange(len(gids))
    theta = np.take_along_axis(dist, row_of[got.indices.numpy()], 1) / 1100
    np.testing.assert_allclose(got.values.numpy(), theta, rtol=2e-4)
    got = sh.sharded_index_knn(store, queries, mode="rounds",
                               block_samplers=_samplers(key, 2))
    assert missed(got.indices) == []
    sess = make_session(store, queries, block_samplers=_samplers(key, 2))
    while sess.step():
        pass
    assert missed(sess.snapshot.ids) == []


# ---------------------------------------------------------------------------
# merge helpers on identical operands
# ---------------------------------------------------------------------------

def test_merge_and_guard_are_the_references():
    r = np.random.default_rng(0)
    S, Q, k = 3, 5, 4
    vals = r.integers(0, 6, (S, Q, k)).astype(np.float32)   # many ties
    vals[1, 2, 3] = np.inf
    gids = r.permutation(S * Q * k).reshape(S, Q, k).astype(np.int32)

    @jax.jit
    def want_merge(v, g):
        return jax.vmap(lambda v, g: jsh.merge_local_topk(v, g, "s", k),
                        axis_name="s")(v, g)

    wi, wv = want_merge(jnp.asarray(vals), jnp.asarray(gids))
    gi, gv = sh.merge_local_topk(torch.from_numpy(vals),
                                 torch.from_numpy(gids), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi)[0])
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv)[0])

    idx = r.integers(0, 10, (Q, k)).astype(np.int32)
    alive = r.random(10) < 0.5
    got = sh.guard_local_topk(torch.from_numpy(idx), torch.from_numpy(
        vals[0]), torch.from_numpy(alive))
    want = jsh.guard_local_topk(jnp.asarray(idx), jnp.asarray(vals[0]),
                                jnp.asarray(alive))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the port's own draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("rotate", [False, True], ids=["dense", "rotated"])
def test_sharded_paths_find_the_exact_neighbours(S, rotate):
    corpus, queries = make_knn_benchmark_data("dense", 300, 200, 4, seed=3)
    store, gids = sh.build_sharded_index(
        corpus, BMOConfig(rotate=rotate, **DENSE_CFG), 0, shards=S,
        device="cpu")
    assert store.stacked_x is not None and store.stacked_x.shape[0] == S
    _, truth = _truth(corpus, queries, 3)
    for mode in ("fused", "rounds"):
        res = sh.sharded_index_knn(store, queries, 1, mode=mode)
        assert _rows(gids, store.capacity, res.indices) == truth, mode
        assert res.shard_coord_ops.shape == (S,)
    sess = make_session(store, queries, 2)
    while sess.step():
        pass
    assert _rows(gids, store.capacity, sess.snapshot.ids) == truth
    assert sess.snapshot.done.all() and len(sess.shard_rounds) == S


def test_sharded_fused_race_syncs_once_an_epoch():
    from repro_torch.obs import ObsContext, set_obs
    corpus, queries = make_knn_benchmark_data("dense", 300, 256, 4, seed=5)
    store, _ = sh.build_sharded_index(corpus, BMOConfig(**DENSE_CFG), 0,
                                      shards=3, device="cpu")
    ctx = ObsContext("t", enabled=True)
    old = set_obs(ctx)
    try:
        hostsync.reset_syncs()
        sh.sharded_index_knn(store, queries, 0)
        syncs = hostsync.syncs()
    finally:
        set_obs(old)
    h = ctx.registry.histogram("repro_race_epoch_ms",
                               "wall time of one race epoch (ms)",
                               kind="sharded_fused_blocking")
    assert h.count > 0 and syncs == h.count
    launches = ctx.registry.counter(
        "repro_kernel_launches_total", "", kernel="fused_epoch_pull").value
    assert h.count <= launches <= 3 * h.count


def test_sharded_sparse_session_finds_the_exact_neighbours():
    from repro.data.synthetic import clustered_sparse
    sp = clustered_sparse(160, 512, seed=2)
    store, gids = sh.build_sharded_index(sp, BMOConfig(**SPARSE_CFG), 0,
                                         shards=2, device="cpu")
    ds = SparseDataset.build(torch.from_numpy(sp))
    q = (ds.indices[:3], ds.values[:3], ds.nnz[:3])
    sess = make_session(store, q, 4, chunk_rounds=16)
    while sess.step():
        pass
    _, truth = _truth(sp, sp[:3], 3, "l1")
    assert _rows(gids, store.capacity, sess.snapshot.ids) == truth
    assert sess.kind == "sharded_sparse" and sess.snapshot.done.all()


def test_shard_devices_refuse_too_few_devices():
    with pytest.raises(RuntimeError, match="need 2 devices"):
        sh.shard_devices(2, device_offset=torch.cuda.device_count()
                         if torch.cuda.is_available() else 0)
    assert sh.shard_devices(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="2 devices for 3 shards"):
        sh.shard_devices(3, ["cpu", "cpu"])
