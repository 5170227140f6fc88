"""BMO k-means (paper §V-A) through the port, held against the JAX package
on the CPU: the bandit assignment step against the exact one, Lloyd's
update against the reference's (fp32 tolerance: rtol 2e-4 / atol 1e-5),
and the reference's four k-means tests (``tests/test_kmeans.py``) on the
port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import BMOConfig as JaxBMOConfig
from repro.core import kmeans as jkmeans
from repro.data.synthetic import clustered_dense
from repro_torch.configs.base import BMOConfig
from repro_torch.core import kmeans

from test_torch_replay import FP32


def _init_idx(key, n, k):
    """The reference's initial centroid choice in ``kmeans``."""
    _, sub = jax.random.split(key)
    return np.asarray(jax.random.choice(sub, n, (k,), replace=False))


def test_assignment_matches_exact():
    pts = clustered_dense(300, 512, n_clusters=8, noise=0.05, seed=0)
    cents = pts[:10]
    cfg = BMOConfig(k=1, delta=0.01, block=64, batch_arms=8,
                    pulls_per_round=2, metric="l2")
    a_bmo, ops = kmeans.assign_bmo(pts, cents, cfg, 0, device="cpu")
    a_ex, ex_ops = kmeans.assign_exact(pts, cents, device="cpu")
    acc = float((a_bmo == a_ex).float().mean())
    assert acc >= 0.99, acc
    assert 0 < float(ops) < float(ex_ops)
    want, _ = jkmeans.assign_exact(jnp.asarray(pts), jnp.asarray(cents))
    np.testing.assert_array_equal(a_ex.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,k", [(200, 4), (90, 7)])
def test_lloyd_update_is_the_references(n, k):
    pts = np.random.default_rng(n).normal(size=(n, 48)).astype(np.float32)
    assign = np.random.default_rng(k).integers(0, k - 1, n)  # one empty
    got = kmeans.lloyd_update(torch.from_numpy(pts), torch.from_numpy(assign),
                              k)
    want = jkmeans.lloyd_update(jnp.asarray(pts), jnp.asarray(assign), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    assert (got[k - 1] == 0).all()


def test_kmeans_from_the_references_init_is_the_references():
    """From the reference's ``init_idx``: the exact path gives the
    reference's assignments and centroids (fp32 tolerance), and the bandit
    path gives the exact path's assignments."""
    pts = clustered_dense(240, 256, n_clusters=6, noise=0.05, seed=5)
    key = jax.random.PRNGKey(4)
    init = _init_idx(key, 240, 6)
    jcfg = JaxBMOConfig(k=1, delta=0.01, block=32, batch_arms=8,
                        metric="l2")
    want = jkmeans.kmeans(pts, 6, 3, jcfg, key, use_bmo=False)
    cfg = BMOConfig(k=1, delta=0.01, block=32, batch_arms=8, metric="l2")
    exact = kmeans.kmeans(pts, 6, 3, cfg, device="cpu", init_idx=init,
                          use_bmo=False)
    np.testing.assert_array_equal(exact.assignment.numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_allclose(exact.centroids.numpy(),
                               np.asarray(want.centroids), **FP32)
    assert float(exact.exact_ops) == float(want.exact_ops)
    bmo = kmeans.kmeans(pts, 6, 3, cfg, 1, device="cpu", init_idx=init)
    np.testing.assert_array_equal(bmo.assignment.numpy(),
                                  exact.assignment.numpy())
    np.testing.assert_allclose(bmo.centroids.numpy(),
                               exact.centroids.numpy(), **FP32)
    assert 0 < float(bmo.coord_ops) < float(bmo.exact_ops)


def test_kmeans_objective_decreases():
    pts = clustered_dense(200, 256, n_clusters=4, noise=0.05, seed=1)
    cfg = BMOConfig(k=1, delta=0.05, block=32, batch_arms=8, metric="l2")

    def objective(res):
        d = pts - res.centroids.numpy()[res.assignment.numpy()]
        return float((d ** 2).sum())

    r1 = kmeans.kmeans(pts, 4, 1, cfg, 2, device="cpu")
    r3 = kmeans.kmeans(pts, 4, 3, cfg, 2, device="cpu")
    assert objective(r3) <= objective(r1) * 1.01


def test_kmeans_counts_ops():
    pts = clustered_dense(128, 256, n_clusters=4, seed=2)
    cfg = BMOConfig(k=1, delta=0.05, block=32, batch_arms=8, metric="l2")
    res = kmeans.kmeans(pts, 4, 2, cfg, 3, device="cpu")
    assert float(res.coord_ops) > 0
    assert float(res.exact_ops) == 2 * 128 * 4 * 256


def test_lloyd_update_means():
    pts = torch.tensor([[0.0, 0.0], [2.0, 2.0], [10.0, 10.0]])
    c = kmeans.lloyd_update(pts, torch.tensor([0, 0, 1]), 2)
    np.testing.assert_allclose(c.numpy(), [[1.0, 1.0], [10.0, 10.0]])
