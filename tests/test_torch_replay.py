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
