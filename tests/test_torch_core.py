"""The port's racing maths held against the JAX package: confidence radii
and Welford updates (fp32 tolerance), the Alg. 1 acceptance step and the
final ranking (identical masks and ids, ties included), the frontier
compaction, and the config/spec records."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import spec as jspec
from repro.configs.base import BMOConfig as JaxBMOConfig
from repro.core import bmo_nn as jbmo
from repro.core import confidence as jconf
from repro.core import ucb as jucb
from repro.core.datasets import next_pow2 as jnext_pow2
from repro.index import frontier as jfront
from repro_torch.api.spec import KNNResult, QuerySpec
from repro_torch.configs.base import BMOConfig
from repro_torch.core import bmo_nn, confidence as conf, ucb
from repro_torch.core.datasets import next_pow2
from repro_torch.index import frontier

FP32 = dict(rtol=2e-4, atol=1e-5)


def test_bmo_config_fields_match_reference():
    ours = {(f.name, f.default) for f in dataclasses.fields(BMOConfig)}
    theirs = {(f.name, f.default) for f in dataclasses.fields(JaxBMOConfig)}
    assert ours == theirs
    cfg = JaxBMOConfig(k=7, rotate=True, sigma=0.5)
    assert dataclasses.asdict(BMOConfig(**dataclasses.asdict(cfg))) == \
        dataclasses.asdict(cfg)


def test_result_records_match_reference():
    assert bmo_nn.KNNResult._fields == jbmo.KNNResult._fields
    assert [f.name for f in dataclasses.fields(KNNResult)] == \
        [f.name for f in dataclasses.fields(jspec.KNNResult)]


@pytest.mark.parametrize("x", [1, 2, 3, 5, 64, 100, 1000, 100_000])
def test_next_pow2(x):
    assert next_pow2(x) == jnext_pow2(x)


# ---------------------------------------------------------------------------
# confidence
# ---------------------------------------------------------------------------

def _moments(rng, n=64):
    mean = rng.normal(size=(n,)).astype(np.float32)
    count = rng.integers(0, 20, (n,)).astype(np.float32)
    m2 = np.abs(rng.normal(size=(n,))).astype(np.float32) * count
    return mean, count, m2


@pytest.mark.parametrize("name", [
    "hoeffding_radius", "hoeffding_radius_masked", "welford_merge",
    "welford_batch_update", "empirical_sigma_sq", "empirical_sigma_sq_prior",
    "pooled_variance"])
def test_confidence_matches_reference(rng, name):
    mean, count, m2 = _moments(rng)
    n = mean.shape[0]
    mask = (rng.random(n) < 0.7).astype(np.float32)
    prior = np.abs(rng.normal(size=(n,))).astype(np.float32)
    args = {
        "hoeffding_radius": (m2, count, 9.3),
        "hoeffding_radius_masked": (m2, count, 9.3, mask > 0),
        "welford_merge": (mean, count, m2, rng.normal(size=(n,)).astype(
            np.float32), 6.0, np.abs(m2[::-1]).copy(), mask),
        "welford_batch_update": (mean, count, m2, rng.normal(
            size=(n, 5)).astype(np.float32), mask),
        "empirical_sigma_sq": (m2, count, 1e-12, np.float32(0.7)),
        "empirical_sigma_sq_prior": (m2, count, 1e-12, np.float32(0.7),
                                     prior, 4.0),
        "pooled_variance": (m2, count),
    }[name]

    def conv(a, lib):
        if not isinstance(a, np.ndarray):
            return a
        return torch.from_numpy(a) if lib == "torch" else jnp.asarray(a)

    got = getattr(conf, name)(*[conv(a, "torch") for a in args])
    want = getattr(jconf, name)(*[conv(a, "jax") for a in args])
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FP32)


def test_delta_splits_match_reference():
    assert conf.delta_prime(0.01, 500, 16) == jconf.delta_prime(0.01, 500, 16)
    assert conf.delta_prime(0.05, 10, 0) == jconf.delta_prime(0.05, 10, 0)
    assert conf.shard_delta(0.01, 4) == jconf.shard_delta(0.01, 4)
    assert conf.shard_delta(0.01, 0) == jconf.shard_delta(0.01, 0)


# ---------------------------------------------------------------------------
# acceptance step and final ranking
# ---------------------------------------------------------------------------

def _race_state(seed, Q=6, W=48):
    """Random per-query frontier state with deliberate ties: means and
    radii on a coarse grid, so equal LCBs, UCBs and means are common."""
    r = np.random.default_rng(seed)
    mean = (r.integers(0, 12, (Q, W)) / 4.0).astype(np.float32)
    ci = (r.integers(0, 4, (Q, W)) / 8.0).astype(np.float32)
    exact = r.random((Q, W)) < 0.2
    ci[exact] = 0.0
    valid = r.random((Q, W)) < 0.9
    accepted = (r.random((Q, W)) < 0.05) & valid
    rejected = (r.random((Q, W)) < 0.3) & ~accepted
    ids = np.stack([r.permutation(4 * W)[:W] for _ in range(Q)]).astype(
        np.int32)
    return dict(mean=mean, ci=ci, exact=exact, accepted=accepted,
                rejected=rejected, valid=valid, ids=ids)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("epsilon", [0.0, 0.3])
@pytest.mark.parametrize("eliminate", [True, False])
def test_acceptance_step_masked_matches_reference(seed, epsilon, eliminate):
    s = _race_state(seed)
    k = 4
    keys = ("mean", "ci", "exact", "accepted", "rejected", "valid")
    want = jax.vmap(lambda m, c, e, a, r, v: jucb.acceptance_step_masked(
        m, c, e, a, r, v, k, epsilon=epsilon, eliminate=eliminate))(
        *[jnp.asarray(s[key]) for key in keys])
    got = ucb.acceptance_step_masked(
        *[torch.from_numpy(s[key]) for key in keys], k, epsilon=epsilon,
        eliminate=eliminate)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_topk_from_state_masked_matches_reference(seed):
    s = _race_state(seed)
    k = 5
    keys = ("mean", "ci", "accepted", "rejected", "valid", "ids")
    want_ids, want_vals = jax.vmap(
        lambda m, c, a, r, v, i: jucb.topk_from_state_masked(
            m, c, a, r, v, i, k))(*[jnp.asarray(s[key]) for key in keys])
    got_ids, got_vals = ucb.topk_from_state_masked(
        *[torch.from_numpy(s[key]) for key in keys], k)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_vals.numpy(), np.asarray(want_vals))


def test_smallest_k_takes_lower_index_first_on_ties():
    score = torch.tensor([[3.0, 1.0, 1.0, float("inf"), 1.0, 0.5],
                          [float("inf")] * 6])
    assert ucb.smallest_k(score, 4).tolist() == [[5, 1, 2, 4], [0, 1, 2, 3]]
    _, want = jax.lax.top_k(-jnp.asarray(score.numpy()), 4)
    assert ucb.smallest_k(score, 4).tolist() == np.asarray(want).tolist()


# ---------------------------------------------------------------------------
# frontier
# ---------------------------------------------------------------------------

def _frontier_pair(seed, Q=5, W=64):
    s = _race_state(seed, Q, W)
    r = np.random.default_rng(seed + 100)
    arrays = dict(
        ids=s["ids"], mean=s["mean"],
        count=r.integers(1, 30, (Q, W)).astype(np.float32),
        m2=r.random((Q, W)).astype(np.float32),
        prior=r.random((Q, W)).astype(np.float32),
        exact=s["exact"], accepted=s["accepted"], rejected=s["rejected"],
        valid=s["valid"])
    per_q = dict(coord_ops=r.random(Q).astype(np.float32),
                 n_exact=r.integers(0, 5, Q).astype(np.int32),
                 rounds=r.integers(0, 9, Q).astype(np.int32),
                 done=r.random(Q) < 0.3)
    jst = jfront.FrontierState(
        **{k: jnp.asarray(v) for k, v in {**arrays, **per_q}.items()},
        rng=jax.random.PRNGKey(0))
    pst = frontier.FrontierState(
        **{k: torch.from_numpy(v) for k, v in {**arrays, **per_q}.items()})
    return jst, pst


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("W_new", [32, 16])
def test_compact_frontier_matches_reference(seed, W_new):
    jst, pst = _frontier_pair(seed)
    want = jfront.compact_frontier(jst, W_new=W_new)
    got = frontier.compact_frontier(pst, W_new=W_new)
    assert got.width == W_new
    for name in frontier.FrontierState._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(frontier.survivors(pst).numpy(),
                                  np.asarray(jfront.survivors(jst)))


def test_bucket_schedule_matches_reference():
    for need in (1, 3, 31, 33, 200, 4096):
        for floor, current in ((32, 512), (64, 64), (1, 4096)):
            assert frontier.bucket_width(need, floor=floor, current=current) \
                == jfront.bucket_width(need, floor=floor, current=current)
    for m in (0, 1, 2, 3, 255, 256, 1000):
        assert frontier.pow2_floor(m) == jfront.pow2_floor(m)
    for kw in (dict(), dict(k=40), dict(batch_arms=8), dict(frontier_floor=100)):
        for n in (20, 500, 131072):
            assert frontier.floor_width(BMOConfig(**kw), n) == \
                jfront.floor_width(JaxBMOConfig(**kw), n)


# ---------------------------------------------------------------------------
# query spec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    dict(mode="nope"), dict(impl="pallas"), dict(k=0), dict(delta=0.0),
    dict(delta=1.0), dict(max_rounds=0)])
def test_query_spec_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        QuerySpec(**bad)


def test_query_spec_binds_like_the_reference():
    cfg = BMOConfig(k=5, delta=0.01)
    spec = QuerySpec(k=3, delta=0.05, max_rounds=7, impl="cuda")
    want = jspec.QuerySpec(k=3, delta=0.05, max_rounds=7).bind(
        JaxBMOConfig(k=5, delta=0.01))
    assert dataclasses.asdict(spec.bind(cfg)) == dataclasses.asdict(want)
    assert QuerySpec().bind(cfg) is cfg
