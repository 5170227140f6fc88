"""The paper's own Algorithm 2 path and the exact oracle, held against the
JAX package on the CPU.

* ``exact_knn`` returns the reference's ids (ties included) and values.
* With the reference's draws replayed (the rotation signs, then one key per
  query), ``race_topk`` through ``query_dense``, ``knn`` (dense, rotated,
  ℓ1) and ``knn_graph`` make the reference's decisions: identical ids,
  rounds, exact-evaluation counts and accepted/rejected/exact masks.
  Values and coordinate-ops at fp32 tolerance (rtol 2e-4 / atol 1e-5).
* Own draws: ``knn`` returns the oracle's top-k, the sparse box's too (its
  replayed races are in ``test_torch_sparse.py``).
* Scale: the race compares exact evaluations on the pulls' ρ/d_pad scale
  and reports θ = ρ/d (ROADMAP.md Queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import BMOConfig as JaxBMOConfig
from repro.core import bmo_nn as jbmo
from repro.core import datasets as jdatasets
from repro.core import oracle as joracle
from repro.data import synthetic as jsynthetic
from repro_torch.configs.base import BMOConfig
from repro_torch.core import bmo_nn, datasets, oracle
from repro_torch.kernels import ref

from test_torch_replay import FP32, paper_samplers, replay_sampler, sets

# the configurations of the reference's own paper-path tests (test_bmo.py)
PAPER = {
    "dense": ((400, 1024, 6, 1), dict(k=3, delta=0.01, block=64,
                                      batch_arms=16, pulls_per_round=2,
                                      metric="l2")),
    "rotated": ((300, 512, 4, 2), dict(k=3, delta=0.01, block=64,
                                       batch_arms=16, metric="l2",
                                       rotate=True)),
    "l1": ((200, 512, 4, 3), dict(k=2, delta=0.01, block=64, batch_arms=16,
                                  metric="l1")),
}


def _paper_data(case):
    (n, d, Q, seed), kw = PAPER[case]
    corpus, queries = jsynthetic.make_knn_benchmark_data("dense", n, d, Q,
                                                         seed=seed)
    return corpus, queries, kw


def _assert_same_knn(want, got):
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.rounds.numpy(), np.asarray(want.rounds))
    np.testing.assert_array_equal(got.n_exact.numpy(),
                                  np.asarray(want.n_exact))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **FP32)
    np.testing.assert_allclose(got.coord_ops.numpy(),
                               np.asarray(want.coord_ops), **FP32)


# ---------------------------------------------------------------------------
# the exact oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,Q,k,metric,batch", [
    (400, 1024, 6, 3, "l2", 256), (200, 512, 4, 2, "l1", 256),
    (70, 300, 5, 4, "l2", 2), (90, 130, 7, 5, "l1", 3)])
def test_exact_knn_matches_reference(n, d, Q, k, metric, batch):
    corpus, queries = jsynthetic.make_knn_benchmark_data("dense", n, d, Q,
                                                         seed=n)
    want = joracle.exact_knn(corpus, queries, k, metric, batch=batch)
    got = oracle.exact_knn(corpus, queries, k, metric, batch=batch,
                           device="cpu")
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **FP32)
    assert float(got.coord_ops) == float(want.coord_ops)
    assert got.indices.dtype == torch.int64 and got.values.shape == (Q, k)


def test_exact_knn_takes_the_lower_index_among_ties():
    """Duplicate corpus rows are exact ties: the lower index comes first,
    as ``lax.top_k`` gives it."""
    r = np.random.default_rng(0)
    base = r.normal(size=(6, 64)).astype(np.float32)
    corpus = np.concatenate([base, base, base])          # rows i, i+6, i+12
    queries = base[[4, 1]] + 0.01
    want = joracle.exact_knn(corpus, queries, 5)
    got = oracle.exact_knn(corpus, queries, 5, device="cpu")
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert got.indices[0, :3].tolist() == [4, 10, 16]


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def test_dense_dataset_matches_reference(rng):
    x = rng.normal(size=(9, 300)).astype(np.float32)
    q = rng.normal(size=(2, 300)).astype(np.float32)
    want = jdatasets.DenseDataset.build(x, block=64)
    got = datasets.DenseDataset.build(torch.from_numpy(x), block=64)
    assert (got.n, got.d, got.d_pad, got.n_blocks, got.block) == \
        (want.n, want.d, want.d_pad, want.n_blocks, want.block)
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.pad_query(q).numpy(),
                                  np.asarray(want.pad_query(q)))


def test_hadamard_rotate_matches_reference(rng):
    x = rng.normal(size=(5, 100)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want, jsigns = jdatasets.hadamard_rotate(jnp.asarray(x), key)
    got, signs = datasets.hadamard_rotate(
        torch.from_numpy(x), None,
        sign_sampler=lambda dp: torch.from_numpy(np.array(jsigns)))
    assert got.shape == (5, 128)
    np.testing.assert_array_equal(signs.numpy(), np.asarray(jsigns))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    g = torch.Generator().manual_seed(1)
    _, own = datasets.hadamard_rotate(torch.from_numpy(x), g)
    assert set(own.tolist()) == {-1.0, 1.0}


# ---------------------------------------------------------------------------
# race_topk and the paper path, on the reference's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["dense", "l1"])
@pytest.mark.parametrize("eliminate", [True, False])
def test_replayed_race_topk_makes_the_reference_decisions(case, eliminate):
    corpus, queries, kw = _paper_data(case)
    jds = jdatasets.DenseDataset.build(corpus, block=kw["block"])
    ds = datasets.DenseDataset.build(torch.from_numpy(corpus),
                                     block=kw["block"])
    key = jax.random.PRNGKey(11)
    want = jbmo.query_dense(jds, jds.pad_query(queries[0]), JaxBMOConfig(**kw),
                            key, eliminate=eliminate)
    got = bmo_nn.query_dense(ds, ds.pad_query(queries[0]), BMOConfig(**kw),
                             eliminate=eliminate,
                             block_sampler=replay_sampler(key))
    np.testing.assert_array_equal(got.topk.numpy(), np.asarray(want.topk))
    assert int(got.rounds) == int(want.rounds)
    assert int(got.n_exact) == int(want.n_exact)
    np.testing.assert_allclose(got.topk_values.numpy(),
                               np.asarray(want.topk_values), **FP32)
    np.testing.assert_allclose(float(got.coord_ops), float(want.coord_ops),
                               **FP32)
    for name in ("accepted", "rejected", "exact", "accept_order"):
        np.testing.assert_array_equal(getattr(got.state, name).numpy(),
                                      np.asarray(getattr(want.state, name)),
                                      name)
    for name in ("mean", "count", "m2"):
        np.testing.assert_allclose(getattr(got.state, name).numpy(),
                                   np.asarray(getattr(want.state, name)),
                                   **FP32)


@pytest.mark.parametrize("case", list(PAPER))
def test_replayed_knn_makes_the_reference_decisions(case):
    corpus, queries, kw = _paper_data(case)
    key = jax.random.PRNGKey(PAPER[case][0][3])
    want = jbmo.knn(corpus, queries, JaxBMOConfig(**kw), key)
    dp = datasets.next_pow2(corpus.shape[1]) if kw.get("rotate") else None
    got = bmo_nn.knn(corpus, queries, BMOConfig(**kw), device="cpu",
                     **paper_samplers(key, len(queries), dp))
    _assert_same_knn(want, got)


def test_replayed_knn_graph_makes_the_reference_decisions():
    corpus, _ = jsynthetic.make_knn_benchmark_data("dense", 64, 256, 1,
                                                   seed=5)
    kw = dict(k=2, delta=0.05, block=32, batch_arms=16, metric="l2")
    key = jax.random.PRNGKey(4)
    want = jbmo.knn_graph(corpus, JaxBMOConfig(**kw), key)
    got = bmo_nn.knn_graph(corpus, BMOConfig(**kw), device="cpu",
                           **paper_samplers(key, len(corpus)))
    _assert_same_knn(want, got)
    for i, row in enumerate(got.indices.tolist()):
        assert i not in row


# ---------------------------------------------------------------------------
# own draws, scale, and what is not ported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(PAPER))
def test_knn_finds_the_oracles_neighbours(case):
    corpus, queries, kw = _paper_data(case)
    res = bmo_nn.knn(corpus, queries, BMOConfig(**kw), 3, device="cpu")
    ex = oracle.exact_knn(corpus, queries, kw["k"], kw["metric"],
                          device="cpu")
    assert sets(res.indices) == sets(ex.indices)
    assert (np.diff(res.values.numpy(), axis=1) >= 0).all()


def test_exact_evaluation_is_on_the_pulls_scale(rng):
    """With d = 200 padded to d_pad = 256, an exact evaluation equals the
    mean of the pulls over every block (ρ/d_pad), and ``knn`` reports
    θ = ρ/d."""
    x = rng.normal(size=(8, 200)).astype(np.float32)
    q = rng.normal(size=(200,)).astype(np.float32)
    cfg = BMOConfig(k=3, delta=0.01, block=64, batch_arms=4, metric="l2")
    ds = datasets.DenseDataset.build(torch.from_numpy(x), block=64)
    qp = ds.pad_query(q)
    arms = torch.arange(8)
    every = torch.arange(ds.n_blocks).expand(8, ds.n_blocks)
    torch.testing.assert_close(
        bmo_nn._dense_exact_fn(ds, qp, cfg, "auto")(arms),
        ref.block_pull_ref(ds.x, qp, arms, every, 64).mean(1),
        rtol=2e-4, atol=1e-5)
    res = bmo_nn.knn(x, q[None], cfg, 0, device="cpu")
    theta = ((x.astype(np.float64) - q) ** 2).sum(1) / 200
    idx = res.indices.numpy()[0]
    assert set(idx) == set(np.argsort(theta)[:3])
    np.testing.assert_allclose(res.values.numpy()[0], theta[idx], rtol=2e-4)


def test_knn_sparse_finds_the_oracles_neighbours():
    """``knn`` on a sparse corpus (the reference's ``test_knn_sparse_exact``
    data, on the port's own draws) returns ``exact_knn_sparse``'s top-k,
    and refuses a dense corpus for the sparse box."""
    corpus = jsynthetic.clustered_sparse(200, 2048, seed=4)
    ds = datasets.SparseDataset.build(corpus)
    q = (ds.indices[:4], ds.values[:4], ds.nnz[:4])
    cfg = BMOConfig(k=3, delta=0.01, block=1, batch_arms=16,
                    pulls_per_round=8, init_pulls=16, metric="l1",
                    sparse=True)
    ex = oracle.exact_knn_sparse(ds, *q, 3, device="cpu")
    res = bmo_nn.knn(ds, q, cfg, 0, device="cpu")
    assert sets(res.indices) == sets(ex.indices)
    with pytest.raises(TypeError, match="SparseDataset"):
        bmo_nn.knn(corpus, q, cfg, device="cpu")


def test_paper_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    x = np.zeros((4, 64), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        oracle.exact_knn(x, x, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        bmo_nn.knn(x, x, BMOConfig(k=1, block=32))
    cfg = dataclasses.replace(BMOConfig(k=1, block=32), rotate=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        bmo_nn.knn_graph(x, cfg)
