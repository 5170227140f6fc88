"""The port's kernel modules held against the JAX package's kernels: the
plain PyTorch versions (what the CPU runs, and what the CUDA kernels are
checked against on the card) vs the Pallas kernels in interpret mode, on
the same seeded numpy inputs.

Tolerances: fp32 statistics at rtol 2e-4 / atol 1e-5, as the reference's
own kernel sweep (sums are taken in another order); bf16 at 5e-2 (one
bf16 rounding of values of order 1)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import confidence as jconf
from repro.kernels import ops as jops
from repro_torch.core import confidence as conf
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_race import fused_epoch_pull_cuda
from repro_torch.kernels.fwht import fwht_cuda

FP32 = dict(rtol=2e-4, atol=1e-5)


def _np(t):
    return t.detach().to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# fwht
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 8, 64, 256, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwht_matches_jax_kernel(rng, d, dtype):
    x = rng.normal(size=(5, d)).astype(np.float32)
    want = jops.fwht(jnp.asarray(x).astype(dtype), impl="interpret")
    got = ops.fwht(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (5, d)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_fwht_matches_explicit_hadamard(rng):
    d = 32
    H = np.array([[1.0]])
    while H.shape[0] < d:
        H = np.block([[H, H], [H, -H]])
    H = H / np.sqrt(d)
    x = rng.normal(size=(7, d)).astype(np.float32)
    got = ops.fwht(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, x @ H.T, atol=1e-5)


# ---------------------------------------------------------------------------
# fused_epoch_pull
# ---------------------------------------------------------------------------

def _pull_inputs(rng, Q, n, d, block, B, T):
    X = rng.normal(size=(n, d)).astype(np.float32)
    qs = rng.normal(size=(Q, d)).astype(np.float32)
    arm = rng.integers(0, n, (Q, B)).astype(np.int32)
    blk = rng.integers(0, d // block, (Q, B, T)).astype(np.int32)
    return X, qs, arm, blk


@pytest.mark.parametrize("Q,n,d,block,B,T", [
    (3, 16, 256, 128, 4, 6),     # T = R·P for (R, P) = (3, 2)
    (5, 32, 512, 64, 8, 2),      # single-round epoch (R = 1)
    (2, 8, 1024, 256, 6, 12),
    (4, 64, 384, 128, 16, 9),    # odd T, d_pad not a power of two
])
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_fused_epoch_pull_matches_jax_kernel(rng, Q, n, d, block, B, T,
                                             metric):
    X, qs, arm, blk = _pull_inputs(rng, Q, n, d, block, B, T)
    want = jops.fused_epoch_pull(jnp.asarray(X), jnp.asarray(qs),
                                 jnp.asarray(arm), jnp.asarray(blk),
                                 block=block, metric=metric, impl="interpret")
    got = ops.fused_epoch_pull(*map(torch.from_numpy, (X, qs, arm, blk)),
                               block=block, metric=metric)
    assert got.shape == (Q, B, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_fused_epoch_pull_stats_match_raw_pulls(rng):
    """The (mean, M2) reduction over T pulls merges into running state
    exactly like feeding the T raw pull values through the per-round
    Welford update — in the port, and in agreement with the reference."""
    Q, n, d, block, B, T = 2, 16, 512, 64, 4, 8
    X, qs, arm, blk = _pull_inputs(rng, Q, n, d, block, B, T)
    mean0 = rng.normal(size=(Q * B,)).astype(np.float32)
    count0 = rng.integers(2, 10, (Q * B,)).astype(np.float32)
    m20 = np.abs(rng.normal(size=(Q * B,)).astype(np.float32))
    mask = np.ones((Q * B,), np.float32)
    tX, tq, ta, tb = map(torch.from_numpy, (X, qs, arm, blk))
    raw = ref.block_pull_multi_ref(tX, tq, ta, tb, block)
    stats = ops.fused_epoch_pull(tX, tq, ta, tb, block=block)
    state = tuple(map(torch.from_numpy, (mean0, count0, m20)))
    want = conf.welford_batch_update(*state, raw.reshape(Q * B, T),
                                     torch.from_numpy(mask))
    got = conf.welford_merge(*state, stats[..., 0].reshape(-1), float(T),
                             stats[..., 1].reshape(-1), torch.from_numpy(mask))
    jstats = jops.fused_epoch_pull(*map(jnp.asarray, (X, qs, arm, blk)),
                                   block=block, impl="interpret")
    jgot = jconf.welford_merge(
        *map(jnp.asarray, (mean0, count0, m20)),
        jstats[..., 0].reshape(-1), float(T), jstats[..., 1].reshape(-1),
        jnp.asarray(mask))
    for g, w, j in zip(got, want, jgot):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **FP32)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **FP32)


def test_fused_epoch_pull_skips_negative_arms(rng):
    """A negative arm id marks a discarded lane: (0, 0), other lanes
    unchanged."""
    X, qs, arm, blk = map(torch.from_numpy,
                          _pull_inputs(rng, 3, 16, 256, 64, 5, 4))
    full = ops.fused_epoch_pull(X, qs, arm, blk, block=64)
    masked_arm = arm.clone()
    masked_arm[1, 2] = -1
    masked = ops.fused_epoch_pull(X, qs, masked_arm, blk, block=64)
    assert masked[1, 2].tolist() == [0.0, 0.0]
    keep = masked_arm >= 0
    torch.testing.assert_close(masked[keep], full[keep], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_auto_on_cpu_uses_plain_versions(rng):
    """impl="auto" on a CPU tensor never reaches a kernel wrapper."""
    X, qs, arm, blk = map(torch.from_numpy,
                          _pull_inputs(rng, 2, 8, 256, 64, 3, 2))
    before = (fused_epoch_pull_cuda.launches, fwht_cuda.launches)
    torch.testing.assert_close(
        ops.fused_epoch_pull(X, qs, arm, blk, block=64),
        ref.fused_epoch_pull_ref(X, qs, arm, blk, 64), rtol=0, atol=0)
    torch.testing.assert_close(ops.fwht(X), ref.fwht_ref(X), rtol=0, atol=0)
    assert (fused_epoch_pull_cuda.launches, fwht_cuda.launches) == before


@pytest.mark.parametrize("kernel", ["fwht", "fused_epoch_pull"])
def test_cuda_impl_on_cpu_tensor_raises(rng, kernel):
    X, qs, arm, blk = map(torch.from_numpy,
                          _pull_inputs(rng, 2, 8, 256, 64, 3, 2))
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "fwht":
            ops.fwht(X, impl="cuda")
        else:
            ops.fused_epoch_pull(X, qs, arm, blk, block=64, impl="cuda")


@pytest.mark.parametrize("kernel", ["fwht", "fused_epoch_pull"])
def test_kernel_wrappers_refuse_cpu_tensors(rng, kernel):
    """The wrappers launch or raise; they never compute on the CPU."""
    X, qs, arm, blk = map(torch.from_numpy,
                          _pull_inputs(rng, 2, 8, 256, 64, 3, 2))
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "fwht":
            fwht_cuda(X)
        else:
            fused_epoch_pull_cuda(X, qs, arm, blk, block=64)


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown impl"):
        ops.fwht(torch.zeros(2, 4), impl="pallas")
