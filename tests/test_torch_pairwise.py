"""The tensor-core ℓ2 kernel's arithmetic (``csrc/pairwise_dist_sm90.cu``)
on the CPU, through its plain replay ``ref.pairwise_l2_split_tf32``: split
TF32 products, slice and master sums, flagging at the kernel's
``flag_ratio(d)`` and the difference-form repair. The kernel itself runs
only on the card (``tests/test_torch_cuda.py``).

Tolerances: against a float64 brute force at rtol 1e-5 / atol 1e-4, the
card tests' own check of the exactness judge, with exactly 0.0 on the
diagonal where a set is held against itself; against the JAX package's
Pallas kernel (interpret mode), in its hardware form ``l2_dot`` and its
difference form, at rtol 1e-4 / atol 1e-3, the port's kernel tests'
tolerance for pairwise distances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pairwise_dist import pairwise_dist_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.pairwise_dist import (ROWWISE_MAX_Q, flag_ratio,
                                               gamma, variant)


def _exact(qs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(qs.double()[:, None] - x.double()[None]),
                     -1)


def _close(got, want) -> bool:
    return bool(((got.double() - want).abs() <= 1e-5 * want + 1e-4).all())


def _inputs(kind: str, rng) -> tuple:
    """(queries, corpus, the corpus row of each query where the two share
    rows, else None), fp32."""
    if kind == "randn":
        return (rng.normal(size=(9, 300)), rng.normal(size=(50, 300)), None)
    if kind == "wide":                       # d = 12,288, few rows
        x = rng.normal(size=(6, 12288))
        return x, x, np.arange(6)
    x = 3.0 * rng.normal(size=(48, 512))
    if kind == "duplicates":                 # queries repeat corpus rows,
        return x[:12], np.concatenate([x, x[:4]]), np.arange(12)   # some twice
    if kind == "near_duplicates":
        return x[:12] + 1e-3 * rng.normal(size=(12, 512)), x, None
    if kind == "offset":                     # norms far above the distances
        return x[:12] + 100.0, x + 100.0, np.arange(12)
    raise ValueError(kind)


def _tensors(kind, rng):
    qs, x, same = _inputs(kind, rng)
    return (torch.from_numpy(qs.astype(np.float32)),
            torch.from_numpy(x.astype(np.float32)), same)


ADVERSARIAL = ["duplicates", "near_duplicates", "offset", "wide"]


@pytest.mark.parametrize("kind", ["randn"] + ADVERSARIAL)
def test_replay_with_repair_is_exact(rng, kind):
    qs, x, same = _tensors(kind, rng)
    got, flagged = ref.pairwise_l2_split_tf32(qs, x, flag_ratio(qs.shape[1]))
    assert got.dtype == torch.float32 and got.shape == (qs.shape[0], x.shape[0])
    assert _close(got, _exact(qs, x))
    if same is not None:
        assert got[np.arange(len(same)), same].tolist() == [0.0] * len(same)
        assert bool(flagged[np.arange(len(same)), same].all())
    if kind == "randn":
        assert not bool(flagged.any())


@pytest.mark.parametrize("kind", ADVERSARIAL)
def test_replay_without_repair_is_not(rng, kind):
    """The same inputs through the expanded form alone: cancellation costs
    more than the tolerance, so the repair is what makes the kernel exact."""
    qs, x, _ = _tensors(kind, rng)
    raw, flagged = ref.pairwise_l2_split_tf32(qs, x)
    assert not bool(flagged.any())
    assert not _close(raw, _exact(qs, x))


@pytest.mark.parametrize("kind", ["randn"] + ADVERSARIAL)
def test_unrepaired_error_stays_under_gamma(rng, kind):
    """The replay's expanded form errs by less than gamma(d)·(‖q‖² + ‖x‖²),
    the bound the flagging assumes (the card checks the kernel's own)."""
    qs, x, _ = _tensors(kind, rng)
    raw, _ = ref.pairwise_l2_split_tf32(qs, x)
    scale = (torch.sum(qs.double() ** 2, -1)[:, None]
             + torch.sum(x.double() ** 2, -1)[None])
    err = (raw.double() - _exact(qs, x)).abs() / scale
    assert float(err.max()) < gamma(qs.shape[1])


@pytest.mark.parametrize("Q,n,d", [(9, 50, 300), (16, 130, 512), (5, 64, 64),
                                   (12, 40, 2048)])
@pytest.mark.parametrize("form", ["l2_dot", "l2"])
def test_replay_matches_jax_kernel(rng, Q, n, d, form):
    qs = rng.normal(size=(Q, d)).astype(np.float32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    want = pairwise_dist_pallas(jnp.asarray(qs), jnp.asarray(X), metric=form,
                                interpret=True)
    got, _ = ref.pairwise_l2_split_tf32(torch.from_numpy(qs),
                                        torch.from_numpy(X), flag_ratio(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


def test_tf32_rounding_and_split():
    a = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11),
                      1 + 3 * 2 ** -11, 0.0, -2.5])
    assert ref.tf32_round(a).tolist() == [1 + 2 ** -10, 1.0, -(1 + 2 ** -10),
                                          1 + 2 ** -9, 0.0, -2.5]
    assert ref.tf32_truncate(a).tolist() == [1.0, 1.0, -1.0, 1 + 2 ** -10,
                                             0.0, -2.5]
    v = torch.from_numpy(np.random.default_rng(3).normal(size=1000)
                         .astype(np.float32))
    hi = ref.tf32_round(v)
    assert torch.equal(hi + (v - hi), v)               # the split is exact
    assert bool(((v - hi).abs() <= 2.0 ** -11 * v.abs()).all())


def test_gamma_and_flag_ratio():
    assert gamma(32) == 2.0 ** -19 + 2.0 ** -23
    assert gamma(12288) < gamma(16384) < 5e-6
    assert flag_ratio(12288) == gamma(12288) / 1e-4


@pytest.mark.parametrize("metric,Q,d,aligned,want", [
    ("l2", 256, 12288, True, "tensor_cores"),
    ("l2", ROWWISE_MAX_Q + 1, 300, True, "tensor_cores"),
    ("l2", ROWWISE_MAX_Q, 16384, True, "cuda_cores"),
    ("l2", 1, 16384, True, "cuda_cores"),
    ("l2", 70, 77, True, "cuda_cores"),
    ("l2", 256, 12288, False, "cuda_cores"),
    ("l1", 256, 12288, True, "cuda_cores")])
def test_pairwise_variant_rule(metric, Q, d, aligned, want):
    assert variant(metric, Q, d, aligned) == want
