"""The port's per-round driver (``index_knn(mode="rounds")``) held against
the JAX package on the CPU.

* Decisions: with the reference's block draws replayed (one split + randint
  for the init and one per round), the driver gives identical top-k ids,
  rounds and exact-evaluation counts, and its final state the identical
  accepted, rejected and exact masks. Values, coordinate-ops and the
  running means at fp32 tolerance (rtol 2e-4 / atol 1e-5: sums taken in
  another order).
* Tombstones with a k override, and per-query (Q, n) priors in both modes,
  race the same as in the reference.
* Own draws: ``Index.query(mode="rounds")`` returns the brute-force top-k.
* Where the port departs from the reference on purpose (d_pad ≠ d; ROADMAP.md
  Queue 3), it returns the exact top-k where the reference does not.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import BMOConfig as JaxBMOConfig
from repro.core import ucb as jucb
from repro.data import synthetic as jsynthetic
from repro.index import batched_race as jbr
from repro.index.builder import build_index as jax_build_index
from repro.index.store import IndexStore as JaxIndexStore
from repro.kernels import ops as jops
from repro_torch.api import Index
from repro_torch.configs.base import BMOConfig
from repro_torch.index.batched_race import (_dense_exact_theta, index_knn,
                                            make_rounds_race)
from repro_torch.kernels import ops
from repro_torch.index.store import IndexStore

from test_torch_replay import (CASES, FP32, brute_force, carry, case_data,
                           cfg_kw, replay_sampler, sets)


def _jax_rounds_fns(jstore, queries, cfg):
    """The reference's per-round race pieces on a dense/rotated store, as
    its ``_dense_index_knn`` assembles them."""
    x, qs = jstore.x, jstore.prepare_queries(queries)
    nb = x.shape[1] // jstore.block

    def pull(sel, k):
        blk = jax.random.randint(k, sel.shape + (cfg.pulls_per_round,), 0, nb)
        return jops.block_pull_multi(x, qs, sel, blk, block=jstore.block,
                                     metric=cfg.metric, impl="ref")

    def exact(sel):
        return jbr._dense_exact_theta(x, qs, sel, cfg.metric, jstore.d)

    return jbr.make_rounds_race(
        pull, exact, n=x.shape[0], Q=qs.shape[0], max_pulls=float(nb),
        pull_cost=float(jstore.block), exact_cost=float(jstore.d), cfg=cfg,
        eliminate=True, dead=~jstore.alive, prior_var=jstore.prior_var,
        prior_weight=jstore.prior_weight)


def _torch_rounds_state(store, queries, key, cfg):
    """The port's per-round race, assembled as its ``_dense_index_knn``
    assembles it, driven round by round to the end; its final state."""
    x, qs = store.x, store.prepare_queries(queries)
    nb = store.n_blocks
    sample = replay_sampler(key)

    def pull(sel):
        blk = sample(tuple(sel.shape) + (cfg.pulls_per_round,), nb)
        return ops.block_pull_multi(x, qs, sel, blk, block=store.block,
                                    metric=cfg.metric)

    def exact(sel):
        return _dense_exact_theta(x, qs, sel, cfg.metric, store.d_pad)

    fns = make_rounds_race(
        pull, exact, n=x.shape[0], Q=qs.shape[0], max_pulls=float(nb),
        pull_cost=float(store.block), exact_cost=float(store.d), cfg=cfg,
        device=x.device, dead=~store.alive, prior_var=store.prior_var,
        prior_weight=store.prior_weight)
    st = fns.init()
    while fns.active(st):
        st = fns.body(st)
    return st


def _race_both(jstore, store, queries, *, k=None):
    """Race both packages on the reference's draws; compare the results and
    the final states."""
    key = jax.random.PRNGKey(5)
    jcfg = jstore.cfg if k is None else dataclasses.replace(jstore.cfg, k=k)
    cfg = store.cfg if k is None else dataclasses.replace(store.cfg, k=k)
    fns = _jax_rounds_fns(jstore, queries, jcfg)
    jst = jax.lax.while_loop(fns.active, fns.body, fns.init(key))
    # the final ranking of the reference's ``run_to_certification``, on the
    # state it ends in (one JAX race instead of two)
    topk, topk_vals = jax.vmap(
        lambda m, c, a, r: jucb.topk_from_state(m, c, a, r, jcfg.k)
    )(jst.mean, fns.ci_radius(jst), jst.accepted, jst.rejected)
    want = jbr.KNNResult(indices=topk, values=topk_vals,
                         coord_ops=jst.coord_ops, rounds=jst.rounds,
                         n_exact=jnp.sum(jst.exact, 1))
    got = index_knn(store, queries, k=k, mode="rounds",
                    block_sampler=replay_sampler(key))
    _assert_same_result(want, got)
    st = _torch_rounds_state(store, queries, key, cfg)
    assert st.round_no == int(jst.round_no)
    for name in ("accepted", "rejected", "exact", "done", "rounds"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(jst, name)), name)
    for name in ("mean", "count", "m2", "coord_ops"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jst, name)), **FP32)
    return got


def _assert_same_result(want, got):
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.rounds.numpy(), np.asarray(want.rounds))
    np.testing.assert_array_equal(got.n_exact.numpy(),
                                  np.asarray(want.n_exact))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **FP32)
    np.testing.assert_allclose(got.coord_ops.numpy(),
                               np.asarray(want.coord_ops), **FP32)


def _stores(case, **override):
    corpus, queries, rotate = case_data(case)
    jstore = jax_build_index(corpus, JaxBMOConfig(**cfg_kw(rotate)),
                             jax.random.PRNGKey(0))
    arrays, meta = carry(jstore, **override)
    if override:
        jstore = JaxIndexStore.from_arrays(arrays, meta)
    return corpus, queries, jstore, IndexStore.from_arrays(arrays, meta,
                                                           device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_replayed_rounds_race_makes_the_reference_decisions(case):
    _, queries, jstore, store = _stores(case)
    _race_both(jstore, store, queries)


def test_replayed_rounds_race_with_tombstones_and_k_override():
    """Dead slots carried across through ``alive`` are never pulled or
    returned, and a k override races the same in both packages."""
    corpus, queries, _ = case_data("n300-dense")
    truth = brute_force(corpus, queries, 3)
    kill = sorted(truth[0])[:2] + [7, 11]
    jstore = jax_build_index(corpus, JaxBMOConfig(**cfg_kw(False)),
                             jax.random.PRNGKey(0))
    alive = np.asarray(jstore.alive).copy()
    alive[kill] = False
    _, _, jstore, store = _stores("n300-dense", alive=alive)
    got = _race_both(jstore, store, queries, k=2)
    assert got.indices.shape == (4, 2)
    for row in sets(got.indices):
        assert not row & set(kill)


@pytest.mark.parametrize("mode", ["rounds", "fused"])
def test_per_query_priors_make_the_reference_decisions(mode):
    """``prior_hint``: (Q, capacity) per-query variance priors in place of
    the store's per-arm ones, in both drivers."""
    corpus, queries = jsynthetic.make_knn_benchmark_data("dense", 120, 256, 3,
                                                         seed=2)
    jstore = jax_build_index(corpus, JaxBMOConfig(**cfg_kw(False)),
                             jax.random.PRNGKey(0))
    store = IndexStore.from_arrays(*carry(jstore), device="cpu")
    r = np.random.default_rng(3)
    prior = (np.asarray(jstore.prior_var)[None]
             * r.uniform(0.25, 4.0, (len(queries), jstore.capacity))
             ).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jbr.index_knn(jstore, queries, key, mode=mode,
                         prior_hint=jnp.asarray(prior))
    got = index_knn(store, queries, mode=mode, prior_hint=prior,
                    block_sampler=replay_sampler(key))
    _assert_same_result(want, got)
    plain = index_knn(store, queries, mode=mode,
                      block_sampler=replay_sampler(key))
    assert not np.array_equal(plain.coord_ops.numpy(), got.coord_ops.numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_rounds_query_finds_the_exact_neighbours(case):
    corpus, queries, rotate = case_data(case)
    idx = Index.build(corpus, BMOConfig(**cfg_kw(rotate)), device="cpu")
    res = idx.query(queries, 7, mode="rounds")
    assert res.indices.shape == (len(queries), 3)
    assert sets(res.indices) == brute_force(corpus, queries, 3)
    assert (np.diff(res.values, axis=1) >= 0).all()
    assert (res.coord_ops > 0).all() and (res.rounds > 0).all()


def test_replayed_rounds_race_is_exact_where_the_reference_loses_recall():
    """With d_pad ≠ d (1100 → 2048) the reference's per-round driver
    returns the wrong top-k for queries 21, 30 and 31 of this input
    (ROADMAP.md Queue 3). The port, on the reference's own draws, returns
    the exact top-k, with the values θ = ρ/d."""
    corpus, queries = jsynthetic.make_knn_benchmark_data("dense", 3000,
                                                         1100, 32, seed=0)
    cfg = JaxBMOConfig(k=5, delta=0.01, block=128, batch_arms=32,
                       metric="l2", rotate=True)
    jstore = jax_build_index(corpus, cfg, jax.random.PRNGKey(0))
    store = IndexStore.from_arrays(*carry(jstore), device="cpu")
    assert (store.d, store.d_pad) == (1100, 2048)
    c, q = corpus.astype(np.float64), queries.astype(np.float64)
    dist = (q * q).sum(1)[:, None] + (c * c).sum(1)[None] - 2.0 * q @ c.T
    truth = [set(r) for r in np.argsort(dist, 1, kind="stable")[:, :5].tolist()]

    want = jbr.index_knn(jstore, queries, jax.random.PRNGKey(1), mode="rounds")
    missed = [i for i, row in enumerate(sets(want.indices)) if row != truth[i]]
    assert missed == [21, 30, 31]

    res = index_knn(store, queries, mode="rounds",
                    block_sampler=replay_sampler(jax.random.PRNGKey(1)))
    assert sets(res.indices) == truth
    theta = np.take_along_axis(dist, res.indices.numpy().astype(np.int64),
                               1) / store.d
    np.testing.assert_allclose(res.values.numpy(), theta, rtol=2e-4)
