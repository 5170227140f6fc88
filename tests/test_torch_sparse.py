"""The port's sparse box (§IV-A, Eq. 12) held against the JAX package on the
CPU, at a small size (n ≤ 300, d ≤ 512).

* Data: ``SparseDataset.build`` exactly; ``clustered_sparse`` and
  ``make_knn_benchmark_data("sparse")`` with ``device=None`` bit for bit;
  the device path's law (sorted supports of int(d·0.07·1.5) coordinates,
  Exponential values, queries that are corpus rows).
* Pulls: ``sparse_pull_one`` on the reference's replayed draws gives the
  reference's values exactly, on every edge case of the lookup (the pad
  sentinel, an empty arm, an empty query, both, a tombstoned slot, an
  explicit zero in a triplet); ``_sparse_lookup`` is the reference's
  ``searchsorted`` lookup.
* Exact values: ``sparse_exact_theta`` and ``_sparse_prior`` at rtol 1e-6
  (sums taken in another order); ``exact_knn_sparse`` ids equal, θ at
  rtol 1e-5, ``coord_ops`` equal.
* Races on replayed draws: the per-round driver (``_sparse_index_knn``)
  and ``knn``: ids, rounds, exact-evaluation counts and ``coord_ops``
  equal, values at fp32 tolerance. With tombstones, every round alike up
  to a near-tie that float32 rounding orders otherwise (ROADMAP.md Queue
  3), and the exact top-k.
* Per-arm ``max_pulls`` and ``exact_cost`` in ``race_topk`` and
  ``make_rounds_race``: the reference's decisions on replayed dense pulls,
  and the scalar form deciding exactly as a broadcast tensor.
* Scale: the sparse box pads nothing in d, so θ is ‖q − x‖₁/d on both
  sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import BMOConfig as JaxBMOConfig
from repro.core import bmo_nn as jbmo
from repro.core import datasets as jdatasets
from repro.core import oracle as joracle
from repro.core import ucb as jucb
from repro.data import synthetic as jsynthetic
from repro.index import batched_race as jbr
from repro.index.builder import _sparse_prior as jax_sparse_prior
from repro.index.builder import build_index as jax_build_index
from repro.index.mutable import delete as jax_delete
from repro_torch.api import Index
from repro_torch.configs.base import BMOConfig
from repro_torch.core import bmo_nn, datasets, oracle, ucb
from repro_torch.data import synthetic
from repro_torch.index import batched_race
from repro_torch.index.builder import _sparse_prior
from repro_torch.index.store import IndexStore

from test_torch_replay import (FP32, carry, coord_draws, paper_coord_samplers,
                               replay_coord_sampler, replay_sampler, sets,
                               triplet)

CFG = dict(k=3, delta=0.01, block=1, batch_arms=16, pulls_per_round=8,
           init_pulls=16, metric="l1", sparse=True)


def _corpus(n=200, d=512, seed=4):
    return jsynthetic.clustered_sparse(n, d, seed=seed)


def _pair(x):
    """The same rows as a reference and a port ``SparseDataset``."""
    return (jdatasets.SparseDataset.build(x),
            datasets.SparseDataset.build(x))


def _l1_theta(corpus, queries):
    return np.abs(queries[:, None, :].astype(np.float64)
                  - corpus[None].astype(np.float64)).sum(-1) / corpus.shape[1]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_sparse_dataset_build_is_the_references(as_tensor):
    x = _corpus(60, 256, seed=1)
    x[3] = 0.0                                        # an empty row
    x[5, 7] = -0.0                                    # not a nonzero
    want = jdatasets.SparseDataset.build(x)
    got = datasets.SparseDataset.build(torch.from_numpy(x) if as_tensor
                                       else x, chunk_elems=1000)
    assert got.d == want.d and got.m == want.m
    for name, dtype in (("indices", torch.int32), ("values", torch.float32),
                        ("nnz", torch.int32)):
        assert getattr(got, name).dtype == dtype
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


def test_clustered_sparse_numpy_path_is_the_reference():
    np.testing.assert_array_equal(
        synthetic.clustered_sparse(50, 300, seed=9),
        jsynthetic.clustered_sparse(50, 300, seed=9))
    for got, want in zip(
            synthetic.make_knn_benchmark_data("sparse", 50, 300, 4, seed=2),
            jsynthetic.make_knn_benchmark_data("sparse", 50, 300, 4,
                                               seed=2)):
        np.testing.assert_array_equal(got, want)


def test_clustered_sparse_device_path_draws_the_law():
    n, d = 300, 512
    width = int(d * 0.07 * 1.5)                       # 53 per support
    g = torch.Generator()
    g.manual_seed(3)
    ds, (qi, qv, qn) = synthetic.make_knn_benchmark_data(
        "sparse", n, d, 5, device="cpu", generator=g)
    assert isinstance(ds, datasets.SparseDataset) and ds.d == d
    assert ds.m == int(ds.nnz.max()) <= width
    cols = torch.arange(ds.m)
    real = cols < ds.nnz[:, None]
    assert (ds.indices[~real] == d).all() and (ds.values[~real] == 0).all()
    assert (ds.values[real] > 0).all()
    assert (torch.diff(ds.indices.long(), dim=1)[real[:, 1:]] > 0).all()
    # each row lies in one of 32 cluster supports of `width` coordinates,
    # keeping about 2/3: a row shares about 2/3 of its coordinates with a
    # row of its cluster, about width/d with a row of another
    groups = []
    for row, cnt in zip(ds.indices.tolist(), ds.nnz.tolist()):
        cols = set(row[:cnt])
        home = next((g for g in groups if len(g & cols) * 3 > cnt), None)
        if home is None:
            groups.append(cols)
        else:
            home |= cols
    assert len(groups) <= 32 and all(len(g) <= width for g in groups)
    assert abs(float(ds.nnz.float().mean()) / width - 2 / 3) < 0.05
    # exponential(scale 2): mean 2
    assert abs(float(ds.values[real].mean()) - 2.0) < 0.2
    # the queries are corpus rows, as wide as their largest nnz
    assert qi.shape[1] == max(int(qn.max()), 1)
    dense = oracle.densify(ds.indices, ds.values, d)
    qd = oracle.densify(qi, qv, d)
    assert all(bool((dense == row).all(1).any()) for row in qd)
    # the same generator state draws the same corpus
    g.manual_seed(3)
    again, _ = synthetic.make_knn_benchmark_data("sparse", n, d, 5,
                                                 device="cpu", generator=g)
    assert torch.equal(again.indices, ds.indices)
    assert torch.equal(again.values, ds.values)


# ---------------------------------------------------------------------------
# pulls, lookups, exact values
# ---------------------------------------------------------------------------

def _edge_corpus(d=64):
    """Rows: ordinary, an empty row, a full row (no pad), a row holding the
    coordinates 0 and d − 1, ordinary again (the tombstoned slot)."""
    r = np.random.default_rng(0)
    x = np.where(r.random((5, d)) < 0.3, r.exponential(1.0, (5, d)),
                 0).astype(np.float32)
    x[1] = 0.0
    x[2] = r.exponential(1.0, d).astype(np.float32) + 0.1
    x[3] = 0.0
    x[3, [0, d - 1]] = [1.5, 2.5]
    return x


def _query_triplets(x, d):
    """Queries: a corpus row, an empty one, one with an explicit zero
    (coordinate 5 listed with value 0), one with coordinate d − 1; as
    triplets padded to a common width (pads index d, value 0)."""
    rows = [np.nonzero(x[0])[0], np.array([], np.int64),
            np.array([2, 5, 9]), np.array([0, 7, d - 1])]
    vals = [x[0, rows[0]], np.array([], np.float32),
            np.array([1.0, 0.0, 3.0], np.float32),
            np.array([1.0, 0.5, 2.0], np.float32)]
    mq = max(len(r) for r in rows) + 1
    qi = np.full((4, mq), d, np.int32)
    qv = np.zeros((4, mq), np.float32)
    for i, (r, v) in enumerate(zip(rows, vals)):
        qi[i, :len(r)], qv[i, :len(r)] = r, v
    return qi, qv, np.array([len(r) for r in rows], np.int32)


def test_sparse_lookup_is_the_references_searchsorted():
    d = 64
    x = _edge_corpus(d)
    jds, ds = _pair(x)
    rows = np.repeat(np.arange(5), d + 1)
    t = np.tile(np.arange(d + 1), 5)                 # every coordinate and d
    v, found = bmo_nn._sparse_lookup(ds.indices, ds.values,
                                     torch.from_numpy(rows),
                                     torch.from_numpy(t).to(torch.int32))
    jv, jfound = jax.vmap(lambda r, tt: jbmo._sparse_lookup(
        jds.indices[r], jds.values[r], tt))(rows, t)
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_sparse_pull_one_replays_the_reference_on_every_edge_case():
    """All (query, arm) pairs of the edge rows, including the tombstoned
    slot 4 (its data stays; the race never pulls it), 64 pulls each, on
    the reference's draws: the values are the reference's exactly."""
    d = 64
    x = _edge_corpus(d)
    jds, ds = _pair(x)
    qi, qv, qn = _query_triplets(x, d)
    jstore = jax_delete(jax_build_index(x, JaxBMOConfig(**CFG),
                                        jax.random.PRNGKey(0)), [4])
    store = IndexStore.from_arrays(*carry(jstore), device="cpu")
    sds = datasets.SparseDataset(store.indices, store.values, store.nnz, d)
    qs = bmo_nn.sparse_queries(qi, qv, qn, d, "cpu")
    Q, B, P = 4, 5, 64
    arms = np.tile(np.arange(B), (Q, 1))
    key = jax.random.PRNGKey(2)
    an = torch.from_numpy(np.array(store.nnz)[arms])[..., None].expand(
        Q, B, P)
    draws = coord_draws(key, torch.from_numpy(qn)[:, None, None].expand(
        Q, B, P), an)
    got = bmo_nn.sparse_pull_one(sds, qs, torch.from_numpy(arms), draws,
                                 chunk=B * P)         # a chunk per query
    keys = jax.random.split(key, Q * B * P).reshape(Q, B, P, 2)
    jds_store = jdatasets.SparseDataset(jstore.indices, jstore.values,
                                        jstore.nnz, d)
    want = jax.jit(jax.vmap(lambda a, b, c, arm_row, kq: jax.vmap(
        lambda arm, kb: jax.vmap(lambda kk: jbmo.sparse_pull_one(
            jds_store, a, b, c, arm, kk))(kb))(arm_row, kq)))(
        qi, qv, qn, arms, keys)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # both sides empty (query 1 against row 1): exactly 0
    assert (got[1, 1] == 0).all()
    # a discarded lane (arm −1) reads as an empty arm
    lane = bmo_nn.sparse_pull_one(sds, qs, torch.full((Q, B), -1), draws)
    assert torch.isfinite(lane).all() and (lane[1] == 0).all()


def test_sparse_exact_theta_matches_the_reference():
    d = 64
    x = _edge_corpus(d)
    jds, ds = _pair(x)
    qi, qv, qn = _query_triplets(x, d)
    qs = bmo_nn.sparse_queries(qi, qv, qn, d, "cpu")
    arms = torch.arange(5).expand(4, 5)
    got = bmo_nn.sparse_exact_theta(ds, qs, arms, chunk=7)
    want = jax.vmap(lambda a, b: jbmo.sparse_exact_theta(
        jds, a, b, jnp.arange(5)))(qi, qv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # and θ is ‖q − x‖₁/d with no d_pad: the explicit zero counts as a zero
    qd = oracle.densify(torch.from_numpy(qi), torch.from_numpy(qv), d)
    np.testing.assert_allclose(got.numpy(), _l1_theta(x, qd.numpy()),
                               rtol=1e-6)


def test_sparse_prior_matches_the_reference():
    x = _corpus(100, 256, seed=5)
    x[7] = 0.0
    jds, ds = _pair(x)
    np.testing.assert_allclose(
        _sparse_prior(ds.values, ds.nnz, ds.d).numpy(),
        np.asarray(jax_sparse_prior(jds.values, jds.nnz, jds.d)), rtol=1e-6)


@pytest.mark.parametrize("chunk", [64, 8192])
def test_exact_knn_sparse_matches_the_reference(chunk):
    corpus, queries = jsynthetic.make_knn_benchmark_data("sparse", 300, 512,
                                                         6, seed=2)
    corpus[11] = corpus[40]                           # an exact tie
    queries[0] = corpus[40]
    jds, ds = _pair(corpus)
    qi, qv, qn = triplet(jdatasets.SparseDataset.build(queries))
    want = joracle.exact_knn_sparse(jds, qi, qv, qn, 4)
    got = oracle.exact_knn_sparse(ds, qi, qv, qn, 4, chunk=chunk,
                                  device="cpu")
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    assert got.indices[0, :2].tolist() == [11, 40]
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               rtol=1e-5)
    assert float(got.coord_ops) == float(want.coord_ops)


# ---------------------------------------------------------------------------
# races on the reference's draws
# ---------------------------------------------------------------------------

def _jax_sparse_fns(jstore, q):
    return jbr.make_sparse_rounds_race(
        jstore.indices, jstore.values, jstore.nnz, jstore.alive,
        jstore.prior_var, *q, cfg=jstore.cfg, d=jstore.d, eliminate=True,
        prior_weight=jstore.prior_weight)


def _lockstep(jfns, fns, key, B: int):
    """Both packages' per-round races on the reference's draws, one round
    at a time, their masks, counts and means compared after each. Returns (the
    port's final state, the reference's, None) when every round agreed; at
    the first round that did not, (None, None, the largest relative LCB gap
    between two arms that the two packages selected, B a query, in
    another order)."""
    jbody, jci = jax.jit(jfns.body), jax.jit(jfns.ci_radius)
    jst, st = jfns.init(key), fns.init()
    while fns.active(st):
        prev, jprev = st, jst
        st, jst = fns.body(st), jbody(jst)
        same = all(np.array_equal(getattr(st, f).numpy(),
                                  np.asarray(getattr(jst, f)))
                   for f in ("count", "accepted", "rejected", "exact"))
        # two arms that swap lanes take each other's draws: their means part
        if not same or not np.allclose(st.mean.numpy(), np.asarray(jst.mean),
                                       rtol=1e-5, atol=1e-6):
            break
    else:
        return st, jst, None
    # the round's selection order: LCBs of the arms that still need pulls
    need = (~prev.accepted & ~prev.rejected & ~prev.exact).numpy()
    lcb = np.where(need, (prev.mean - fns.ci_radius(prev)).numpy(), np.inf)
    jlcb = np.where(need, np.asarray(jprev.mean - jci(jprev)), np.inf)
    gap = 0.0
    for q in range(lcb.shape[0]):
        order = np.argsort(lcb[q], kind="stable")[:B]
        jorder = np.argsort(jlcb[q], kind="stable")[:B]
        for a, b in zip(order, jorder):
            if a != b:
                gap = max(gap, abs(lcb[q, a] - lcb[q, b]) / abs(lcb[q, a]),
                          abs(jlcb[q, a] - jlcb[q, b]) / abs(jlcb[q, a]))
    return None, None, gap


def test_replayed_sparse_rounds_race_makes_the_reference_decisions():
    corpus = _corpus()
    jstore = jax_build_index(corpus, JaxBMOConfig(**CFG),
                             jax.random.PRNGKey(0))
    q = triplet(jdatasets.SparseDataset.build(corpus[:4]))
    key = jax.random.PRNGKey(5)
    fns = _jax_sparse_fns(jstore, q)
    jst = jax.lax.while_loop(fns.active, fns.body, fns.init(key))
    topk, topk_vals = jax.vmap(
        lambda m, c, a, r: jucb.topk_from_state(m, c, a, r, jstore.cfg.k)
    )(jst.mean, fns.ci_radius(jst), jst.accepted, jst.rejected)
    store = IndexStore.from_arrays(*carry(jstore), device="cpu")
    got = batched_race._sparse_index_knn(
        store.indices, store.values, store.nnz, store.alive, store.prior_var,
        *q, replay_coord_sampler(key), cfg=store.cfg, d=store.d,
        eliminate=True, prior_weight=store.prior_weight)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(topk))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(topk_vals),
                               **FP32)
    np.testing.assert_array_equal(got.rounds.numpy(), np.asarray(jst.rounds))
    np.testing.assert_array_equal(got.n_exact.numpy(),
                                  np.asarray(jnp.sum(jst.exact, 1)))
    np.testing.assert_array_equal(got.coord_ops.numpy(),
                                  np.asarray(jst.coord_ops))


def test_replayed_sparse_race_with_tombstones_diverges_only_at_a_near_tie():
    """With slots 5, 40 and 96 tombstoned, both races decide alike, round
    for round, until round 65: there the port orders two arms whose lower
    bounds lie 3e-8 apart (rounding: the reference's XLA reductions are
    not sequential, the port's sums run in torch's order), the reference
    finds them equal, and from then on each arm gets the other's draws
    (ROADMAP.md Queue 3). Every decision before is the reference's; the
    port's answer is still the exact top-k, with no dead slot."""
    corpus = _corpus()
    dead = [5, 40, 96]
    jstore = jax_delete(jax_build_index(corpus, JaxBMOConfig(**CFG),
                                        jax.random.PRNGKey(0)), dead)
    q = triplet(jdatasets.SparseDataset.build(corpus[:4]))
    key = jax.random.PRNGKey(5)
    store = IndexStore.from_arrays(*carry(jstore), device="cpu")

    def port_fns(sampler):
        return batched_race.make_sparse_rounds_race(
            store.indices, store.values, store.nnz, store.alive,
            store.prior_var, *q, sampler, cfg=store.cfg, d=store.d,
            eliminate=True, prior_weight=store.prior_weight)

    st, jst, gap = _lockstep(_jax_sparse_fns(jstore, q),
                             port_fns(replay_coord_sampler(key)), key,
                             store.cfg.batch_arms)
    assert st is None and 0 < gap < 1e-6
    got = batched_race.index_knn(store, q,
                                 coord_sampler=replay_coord_sampler(key))
    want = jbr.index_knn(jstore, q, key)
    live = np.ones(200, bool)
    live[dead] = False
    theta = np.where(live, _l1_theta(corpus, corpus[:4]), np.inf)
    truth = np.argsort(theta, 1, kind="stable")[:, :3]
    assert sets(got.indices) == sets(want.indices) == sets(truth)


def test_replayed_knn_sparse_makes_the_reference_decisions():
    corpus = _corpus()
    jds, ds = _pair(corpus)
    q = triplet(jdatasets.SparseDataset.build(corpus[:3]))
    key = jax.random.PRNGKey(3)
    want = jbmo.knn(jds, q, JaxBMOConfig(**CFG), key)
    got = bmo_nn.knn(ds, q, BMOConfig(**CFG), device="cpu",
                     coord_samplers=paper_coord_samplers(key, 3))
    for name in ("indices", "rounds", "n_exact", "coord_ops"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **FP32)
    # θ = ‖q − x‖₁/d on both sides: the exact-evaluated winners' values
    theta = _l1_theta(corpus, corpus[:3])
    np.testing.assert_allclose(
        got.values.numpy(), np.take_along_axis(theta, got.indices.numpy(), 1),
        rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# per-arm MAX_PULLS and exact cost on the dense drivers
# ---------------------------------------------------------------------------

def _dense_case(seed=1):
    r = np.random.default_rng(seed)
    x = r.normal(size=(40, 256)).astype(np.float32)
    q = r.normal(size=(256,)).astype(np.float32)
    return x, q, r.integers(1, 5, 40).astype(np.float32)


def test_race_topk_takes_per_arm_max_pulls_as_the_reference():
    x, q, mp = _dense_case()
    cfg = dict(k=3, delta=0.05, block=64, batch_arms=8, pulls_per_round=2,
               metric="l2")
    jds = jdatasets.DenseDataset.build(x, block=64)
    key = jax.random.PRNGKey(4)
    cost = mp * 64.0
    want = jucb.race_topk(
        jbmo._dense_pull_fn(jds, jnp.asarray(q), JaxBMOConfig(**cfg), "ref"),
        jbmo._dense_exact_fn(jds, jnp.asarray(q), JaxBMOConfig(**cfg), "ref"),
        n=40, max_pulls=jnp.asarray(mp), pull_cost=64.0,
        exact_cost=jnp.asarray(cost), cfg=JaxBMOConfig(**cfg), rng=key,
        max_pulls_static=4)
    ds = datasets.DenseDataset.build(x, block=64)
    got = ucb.race_topk(
        bmo_nn._dense_pull_fn(ds, torch.from_numpy(q), BMOConfig(**cfg), "ref",
                              replay_sampler(key)),
        bmo_nn._dense_exact_fn(ds, torch.from_numpy(q), BMOConfig(**cfg),
                               "ref"),
        n=40, max_pulls=torch.from_numpy(mp), pull_cost=64.0,
        exact_cost=torch.from_numpy(cost), cfg=BMOConfig(**cfg),
        device=torch.device("cpu"), max_pulls_static=4)
    np.testing.assert_array_equal(got.topk.numpy(), np.asarray(want.topk))
    assert int(got.rounds) == int(want.rounds)
    assert int(got.n_exact) == int(want.n_exact)
    assert float(got.coord_ops) == float(want.coord_ops)
    np.testing.assert_array_equal(got.state.exact.numpy(),
                                  np.asarray(want.state.exact))


@pytest.mark.parametrize("form", ["(n,)", "(Q, n)"])
def test_rounds_race_scalar_form_decides_as_before(form):
    """``max_pulls``/``exact_cost`` as a scalar and as the same values
    broadcast per arm (or per query and arm): identical decisions, rounds
    and coord_ops; and the (Q, n) form gives each query its own."""
    x, q, _ = _dense_case(2)
    qs = torch.from_numpy(np.stack([q, -q, q * 0.5]))
    cfg = BMOConfig(k=3, delta=0.05, block=64, batch_arms=8,
                    pulls_per_round=2, metric="l2")
    xt = torch.from_numpy(x)

    def race(max_pulls, exact_cost):
        sample = replay_sampler(jax.random.PRNGKey(6))

        def pull(sel):
            blk = sample(tuple(sel.shape) + (2,), 4)
            return batched_race.kops.block_pull_multi(xt, qs, sel, blk,
                                                      block=64)
        return batched_race.batched_race_topk(
            pull, lambda sel: batched_race._dense_exact_theta(
                xt, qs, sel, "l2", 256),
            n=40, Q=3, max_pulls=max_pulls, pull_cost=64.0,
            exact_cost=exact_cost, cfg=cfg, device=torch.device("cpu"))

    scalar = race(4.0, 256.0)
    shape = (40,) if form == "(n,)" else (3, 40)
    tensor = race(torch.full(shape, 4.0), torch.full(shape, 256.0))
    for name in ("indices", "values", "coord_ops", "rounds", "n_exact"):
        assert torch.equal(getattr(scalar, name), getattr(tensor, name)), name


# ---------------------------------------------------------------------------
# the handle and own draws
# ---------------------------------------------------------------------------

def test_sparse_index_finds_the_exact_neighbours_through_the_handle():
    corpus, queries = jsynthetic.make_knn_benchmark_data("sparse", 240, 512,
                                                         4, seed=7)
    cfg = BMOConfig(**CFG)
    by_dense = Index.build(corpus, cfg, device="cpu")
    by_csr = Index.build(datasets.SparseDataset.build(corpus), cfg,
                         device="cpu")
    for a, b in zip(by_dense.store.arrays().values(),
                    by_csr.store.arrays().values()):
        assert torch.equal(a, b)
    q = triplet(jdatasets.SparseDataset.build(queries))
    res = by_csr.query(q, 1)
    truth = np.argsort(_l1_theta(corpus, queries), 1, kind="stable")[:, :3]
    assert sets(res.indices) == sets(truth)
    assert by_csr.kind == "sparse"
    with pytest.raises(ValueError, match="sparse"):
        by_csr.query(q, 1, mode="fused")
    # a sharded sparse index (once refused: ROADMAP.md Queue 1 item 7)
    sharded = Index.build(corpus, cfg, device="cpu", shards=2)
    row_of = np.full(sharded.capacity, -1)
    row_of[sharded.build_gids] = np.arange(len(corpus))
    assert sets(row_of[sharded.query(q, 1).indices]) == sets(truth)
    assert by_csr.query(q, 2, k=2).indices.shape == (4, 2)
