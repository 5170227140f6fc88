"""Helpers shared by the port's replayed-draw tests — the reference's random
draws handed to the port's samplers, the small datasets of the reference's
index tests, numpy ground truth — and the tests that the replay follows the
reference's key schedule."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import BMOConfig as JaxBMOConfig
from repro.core import bmo_nn as jbmo
from repro.core import datasets as jdatasets
from repro.data import synthetic as jsynthetic
from repro_torch.kernels import ops

FP32 = dict(rtol=2e-4, atol=1e-5)

# the datasets of the reference's index tests (tests/test_index.py)
CASES = {
    "n500-dense": ((500, 1024, 5, 21), False),
    "n500-rotated": ((500, 1024, 5, 21), True),
    "n300-dense": ((300, 1024, 4, 33), False),
}


def cfg_kw(rotate):
    return dict(k=3, delta=0.01, block=64, batch_arms=16, pulls_per_round=2,
                metric="l2", rotate=rotate)


def case_data(case):
    (n, d, Q, seed), rotate = CASES[case]
    corpus, queries = jsynthetic.make_knn_benchmark_data("dense", n, d, Q,
                                                         seed=seed)
    return corpus, queries, rotate


def carry(jstore, **arrays_override):
    """A reference store's arrays (as numpy) and metadata, for
    ``IndexStore.from_arrays``."""
    arrays = {k: np.asarray(v) for k, v in jstore.arrays().items()}
    arrays.update(arrays_override)
    return arrays, jstore.meta()


def brute_force(corpus, queries, k):
    """Exact top-k sets by float64 squared distance."""
    d = ((queries[:, None, :].astype(np.float64)
          - corpus[None].astype(np.float64)) ** 2).sum(-1)
    return [set(row) for row in np.argsort(d, 1, kind="stable")[:, :k].tolist()]


def sets(idx):
    return [set(row) for row in np.asarray(idx).tolist()]


def replay_sampler(key):
    """The reference's block draws, in order: each call splits the key and
    draws ``randint(sub, shape, 0, nb)``, exactly as the reference's drivers
    take them (its init and every epoch or round)."""
    state = {"key": key}

    def sample(shape, nb):
        state["key"], sub = jax.random.split(state["key"])
        return torch.from_numpy(np.array(jax.random.randint(sub, shape, 0,
                                                            nb)))
    return sample


def paper_samplers(key, Q, dp=None):
    """The draws of the reference's ``core.bmo_nn.knn``: with a rotation
    (``dp`` its width), one split for the Rademacher signs first; then one
    key per query, each replayed as that query's block sampler. Returns the
    port's ``knn`` keyword arguments."""
    out = {}
    if dp is not None:
        key, sub = jax.random.split(key)
        signs = torch.from_numpy(np.array(jax.random.rademacher(
            sub, (dp,), jnp.float32)))
        out["sign_sampler"] = lambda width: signs
    keys = jax.random.split(key, Q)
    out["block_samplers"] = lambda i: replay_sampler(keys[i])
    return out


def coord_draws(key, q_nnz, arm_nnz):
    """The reference's sparse-pull draws for one pull key each: the key is
    split into one key per entry of ``q_nnz``'s shape (row-major, as the
    reference's ``split(key, Q·B·P).reshape(Q, B, P, 2)``), and each of
    those in three: ``uniform``, ``randint(0, max(q_nnz, 1))`` and
    ``randint(0, max(arm_nnz, 1))``, the bounds traced per entry."""
    shape = tuple(q_nnz.shape)

    def bound(count):
        return jnp.asarray(np.maximum(np.asarray(count).reshape(-1), 1),
                           jnp.int32)

    draws = _coord_draws(key, bound(q_nnz), bound(arm_nnz))
    return tuple(torch.from_numpy(np.array(a)).reshape(shape) for a in draws)


@jax.jit
def _coord_draws(key, q_top, a_top):
    def one(k, q_hi, a_hi):
        k1, k2, k3 = jax.random.split(k, 3)
        return (jax.random.uniform(k1), jax.random.randint(k2, (), 0, q_hi),
                jax.random.randint(k3, (), 0, a_hi))
    return jax.vmap(one)(jax.random.split(key, q_top.shape[0]), q_top, a_top)


def replay_coord_sampler(key):
    """The reference's sparse-pull draws, in order: each call splits the key
    (its drivers split once for each init rep and each round) and draws
    ``coord_draws`` from the subkey."""
    state = {"key": key}

    def sample(q_nnz, arm_nnz):
        state["key"], sub = jax.random.split(state["key"])
        return coord_draws(sub, q_nnz, arm_nnz)
    return sample


def paper_coord_samplers(key, Q):
    """The draws of the reference's sparse ``core.bmo_nn.knn``: one key per
    query, each replayed as that query's coordinate sampler."""
    keys = jax.random.split(key, Q)
    return lambda i: replay_coord_sampler(keys[i])


def triplet(jds):
    """A reference ``SparseDataset``'s rows as the (idx, val, nnz) numpy
    triplet (writable copies)."""
    return tuple(np.array(a) for a in (jds.indices, jds.values, jds.nnz))


# ---------------------------------------------------------------------------
# the replay follows the reference's key schedule
# ---------------------------------------------------------------------------

def test_paper_samplers_replay_the_rotation_signs():
    key = jax.random.PRNGKey(3)
    x = np.random.default_rng(0).normal(size=(4, 100)).astype(np.float32)
    _, want = jdatasets.hadamard_rotate(jnp.asarray(x),
                                        jax.random.split(key)[1])
    got = paper_samplers(key, 2, dp=128)["sign_sampler"](128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_replay_sampler_replays_the_reference_pulls():
    """The first draw of query i's replayed sampler is the block set the
    reference's ``knn`` pulls at that query's init: one split of the
    query's key, then ``randint``."""
    r = np.random.default_rng(1)
    x = r.normal(size=(12, 256)).astype(np.float32)
    q = r.normal(size=(256,)).astype(np.float32)
    cfg = JaxBMOConfig(k=2, block=64, batch_arms=4)
    ds = jdatasets.DenseDataset.build(x, block=64)
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, 3)
    arms = np.arange(12, dtype=np.int32)
    want = jbmo._dense_pull_fn(ds, jnp.asarray(q), cfg, "ref")(
        jnp.asarray(arms), jax.random.split(keys[2])[1])
    blk = paper_samplers(key, 3)["block_samplers"](2)((12, 2), 4)
    got = ops.block_pull(torch.from_numpy(x), torch.from_numpy(q),
                         torch.from_numpy(arms), blk, block=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_coord_draws_replay_the_reference_pull_draws():
    """``coord_draws`` gives, entry for entry, the three numbers the
    reference's ``sparse_pull_one`` draws from the same pull key, with
    ``randint``'s bound traced per entry (zero counts draw from [0, 1))."""
    key = jax.random.PRNGKey(11)
    q_nnz = np.array([[0, 3, 7], [1, 0, 120]], np.int32)
    a_nnz = np.array([[5, 0, 2], [0, 9, 4000]], np.int32)
    u, jq, ja = coord_draws(key, torch.from_numpy(q_nnz),
                            torch.from_numpy(a_nnz))
    keys = jax.random.split(key, 6).reshape(2, 3, 2)
    for i in range(2):
        for j in range(3):
            k1, k2, k3 = jax.random.split(keys[i, j], 3)
            assert float(u[i, j]) == float(jax.random.uniform(k1))
            assert int(jq[i, j]) == int(jax.random.randint(
                k2, (), 0, jnp.maximum(jnp.int32(q_nnz[i, j]), 1)))
            assert int(ja[i, j]) == int(jax.random.randint(
                k3, (), 0, jnp.maximum(jnp.int32(a_nnz[i, j]), 1)))
    assert (jq.numpy() < np.maximum(q_nnz, 1)).all()
    assert (ja.numpy() < np.maximum(a_nnz, 1)).all()
