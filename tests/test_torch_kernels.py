"""The port's kernel modules held against the JAX package's kernels: the
plain PyTorch versions (what the CPU runs, and what the CUDA kernels are
checked against on the card) vs the Pallas kernels in interpret mode, on
the same seeded numpy inputs.

Tolerances, as the reference's own kernel sweep (sums are taken in another
order): fp32 statistics at rtol 2e-4 / atol 1e-5; pulls at rtol 1e-5, and
2e-2 for bf16 inputs; pairwise distances at rtol 1e-4 / atol 1e-3; the
bf16 transform at 5e-2 (one bf16 rounding of values of order 1)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import confidence as jconf
from repro.kernels import ops as jops
from repro_torch.core import confidence as conf
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro.kernels.flash_attn import flash_attention_pallas
from repro_torch.kernels.block_pull import block_pull_cuda, block_pull_multi_cuda
from repro_torch.kernels.flash_attn import (flash_attention_cuda, tc_output,
                                            variant)
from repro_torch.kernels.fused_race import fused_epoch_pull_cuda
from repro_torch.kernels.fwht import fwht_cuda
from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda

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
# block_pull, block_pull_multi
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,block,B,P", [
    (16, 256, 128, 4, 2),
    (32, 512, 64, 8, 3),
    (8, 1024, 256, 8, 1),
    (64, 384, 128, 16, 5),
])
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_block_pull_matches_jax_kernel(rng, n, d, block, B, P, metric):
    X = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(d,)).astype(np.float32)
    arm = rng.integers(0, n, B).astype(np.int32)
    blk = rng.integers(0, d // block, (B, P)).astype(np.int32)
    want = jops.block_pull(*map(jnp.asarray, (X, q, arm, blk)), block=block,
                           metric=metric, impl="interpret")
    got = ops.block_pull(*map(torch.from_numpy, (X, q, arm, blk)),
                         block=block, metric=metric)
    assert got.shape == (B, P) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_pull_dtypes_match_jax_kernel(rng, dtype):
    X = rng.normal(size=(8, 256)).astype(np.float32)
    q = rng.normal(size=(256,)).astype(np.float32)
    arm = np.arange(4, dtype=np.int32)
    blk = np.zeros((4, 2), np.int32)
    want = jops.block_pull(jnp.asarray(X).astype(dtype),
                           jnp.asarray(q).astype(dtype), jnp.asarray(arm),
                           jnp.asarray(blk), block=128, impl="interpret")
    tdt = getattr(torch, dtype)
    got = ops.block_pull(torch.from_numpy(X).to(tdt), torch.from_numpy(q).to(
        tdt), torch.from_numpy(arm), torch.from_numpy(blk), block=128)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("Q,n,d,block,B,P", [
    (3, 16, 256, 128, 4, 2),
    (5, 32, 512, 64, 8, 3),
    (2, 8, 1024, 256, 8, 1),
])
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_block_pull_multi_matches_jax_kernel(rng, Q, n, d, block, B, P,
                                             metric):
    X, qs, arm, blk = _pull_inputs(rng, Q, n, d, block, B, P)
    want = jops.block_pull_multi(*map(jnp.asarray, (X, qs, arm, blk)),
                                 block=block, metric=metric, impl="interpret")
    tX, tq, ta, tb = map(torch.from_numpy, (X, qs, arm, blk))
    got = ops.block_pull_multi(tX, tq, ta, tb, block=block, metric=metric)
    assert got.shape == (Q, B, P) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    # row q of the multi-query pull == the single-query pull for that query
    for qi in range(Q):
        single = ops.block_pull(tX, tq[qi], ta[qi], tb[qi], block=block,
                                metric=metric)
        np.testing.assert_allclose(got[qi].numpy(), single.numpy(), rtol=1e-5)


def test_block_pull_full_coverage_equals_exact(rng):
    """Pulling every block once averages to the exact θ — in the port, and
    in agreement with the reference's kernel."""
    n, d, block = 6, 512, 128
    X = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(d,)).astype(np.float32)
    nb = d // block
    blk = np.broadcast_to(np.arange(nb, dtype=np.int32)[None], (n, nb)).copy()
    arm = np.arange(n, dtype=np.int32)
    pulls = ops.block_pull(*map(torch.from_numpy, (X, q, arm, blk)),
                           block=block)
    theta = ops.pairwise_dist(torch.from_numpy(q)[None],
                              torch.from_numpy(X))[0] / d
    np.testing.assert_allclose(pulls.mean(1).numpy(), theta.numpy(), rtol=1e-4)
    jpulls = jops.block_pull(*map(jnp.asarray, (X, q, arm, blk)), block=block,
                             impl="interpret")
    np.testing.assert_allclose(pulls.numpy(), np.asarray(jpulls), rtol=1e-5)


def test_block_pull_multi_skips_negative_arms(rng):
    """A negative arm id marks a discarded lane: its pulls are 0, other
    lanes unchanged."""
    X, qs, arm, blk = map(torch.from_numpy,
                          _pull_inputs(rng, 3, 16, 256, 64, 5, 4))
    full = ops.block_pull_multi(X, qs, arm, blk, block=64)
    masked_arm = arm.clone()
    masked_arm[2, 1] = -1
    masked = ops.block_pull_multi(X, qs, masked_arm, blk, block=64)
    assert masked[2, 1].tolist() == [0.0] * 4
    keep = masked_arm >= 0
    torch.testing.assert_close(masked[keep], full[keep], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# pairwise_dist
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Q,n,d", [(4, 16, 64), (9, 50, 300), (8, 128, 512),
                                   (1, 7, 1000)])
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_pairwise_dist_matches_jax_kernel(rng, Q, n, d, metric):
    qs = rng.normal(size=(Q, d)).astype(np.float32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    want = jops.pairwise_dist(jnp.asarray(qs), jnp.asarray(X), metric=metric,
                              impl="interpret")
    got = ops.pairwise_dist(torch.from_numpy(qs), torch.from_numpy(X),
                            metric=metric)
    assert got.shape == (Q, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_pairwise_dist_ref_is_the_reference_ref(rng, metric):
    """The plain version keeps the reference's chunked form: with d over
    one 2048-wide chunk it matches the JAX plain version to fp32 rounding."""
    qs = rng.normal(size=(3, 2500)).astype(np.float32)
    X = rng.normal(size=(20, 2500)).astype(np.float32)
    want = jref.pairwise_dist_ref(jnp.asarray(qs), jnp.asarray(X), metric)
    got = ref.pairwise_dist_ref(torch.from_numpy(qs), torch.from_numpy(X),
                                metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_pairwise_zero_distance(rng):
    X = rng.normal(size=(5, 128)).astype(np.float32)
    d = ops.pairwise_dist(torch.from_numpy(X), torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(np.diag(d), 0.0, atol=1e-3)
    jd = jops.pairwise_dist(jnp.asarray(X), jnp.asarray(X), impl="interpret")
    np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-4, atol=1e-3)


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
# flash_attention
# ---------------------------------------------------------------------------

def _flash_pair(rng, B, H, KV, Sq, Sk, D, causal, off, bq=64, bk=64,
                dtype="float32"):
    """The Pallas kernel (interpret mode) on K/V repeated to H heads, as its
    caller passes them, and the port's op on the same K/V repeated and, with
    KV < H, unrepeated (query head h reads KV head h // (H / KV))."""
    q = rng.normal(size=(B, H, Sq, D)).astype(np.float32)
    k = rng.normal(size=(B, KV, Sk, D)).astype(np.float32)
    v = rng.normal(size=(B, KV, Sk, D)).astype(np.float32)
    G = H // KV
    want = flash_attention_pallas(
        jnp.asarray(q).astype(dtype),
        jnp.repeat(jnp.asarray(k).astype(dtype), G, axis=1),
        jnp.repeat(jnp.asarray(v).astype(dtype), G, axis=1),
        causal=causal, q_offset=off, bq=bq, bk=bk, interpret=True)
    tq, tk, tv = (torch.from_numpy(t).to(getattr(torch, dtype))
                  for t in (q, k, v))
    got = [ops.flash_attention(tq, tk.repeat_interleave(G, dim=1),
                               tv.repeat_interleave(G, dim=1), causal=causal,
                               q_offset=off)]
    if G > 1:
        got.append(ops.flash_attention(tq, tk, tv, causal=causal,
                                       q_offset=off))
    for g in got:
        assert g.dtype == getattr(torch, dtype) and g.shape == (B, H, Sq, D)
    return np.asarray(want.astype(jnp.float32)), [_np(g) for g in got]


@pytest.mark.parametrize("B,H,KV,Sq,Sk,D,causal,off", [
    (2, 4, 4, 128, 128, 32, True, 0),
    (1, 2, 2, 64, 256, 16, True, 192),     # decode-ish: q at the cache tail
    (2, 4, 2, 128, 128, 32, True, 0),      # GQA
    (2, 4, 4, 128, 128, 32, False, 0),     # bidirectional
    (1, 1, 1, 64, 64, 128, True, 0),
])
def test_flash_attention_matches_jax_kernel(rng, B, H, KV, Sq, Sk, D, causal,
                                            off):
    want, got = _flash_pair(rng, B, H, KV, Sq, Sk, D, causal, off)
    for g in got:
        np.testing.assert_allclose(g, want, atol=3e-5)


@pytest.mark.parametrize("bq,bk", [(32, 64), (64, 32), (128, 128)])
def test_flash_attention_matches_jax_kernel_block_shapes(rng, bq, bk):
    want, got = _flash_pair(rng, 1, 2, 2, 128, 128, 32, True, 0, bq=bq, bk=bk)
    np.testing.assert_allclose(got[0], want, atol=3e-5)


def test_flash_attention_bf16_matches_jax_kernel(rng):
    want, got = _flash_pair(rng, 1, 2, 2, 64, 64, 32, True, 0,
                            dtype="bfloat16")
    np.testing.assert_allclose(got[0], want, atol=3e-2, rtol=3e-2)


def test_flash_attention_survives_one_hot_rows(rng):
    """Score spreads in the hundreds, as the LM's init makes them: the
    result is finite, and on rows whose softmax is one-hot to 1e-6 it is
    the largest score's value row (the kernel's tiled version of this is in
    tests/test_torch_cuda.py)."""
    q = torch.from_numpy(rng.normal(size=(1, 2, 64, 16)).astype(np.float32)) * 40
    k = torch.from_numpy(rng.normal(size=(1, 1, 64, 16)).astype(np.float32)) * 40
    v = torch.from_numpy(rng.normal(size=(1, 1, 64, 16)).astype(np.float32))
    out = ops.flash_attention(q, k, v)
    assert bool(torch.isfinite(out).all())
    s = torch.einsum("bhqd,bksd->bhqs", q, k) / 4.0       # 1/√D
    s = s.masked_fill(torch.ones(64, 64, dtype=torch.bool).triu(1), -math.inf)
    top = v[0, 0][s.argmax(-1)[0]]
    one_hot = (s.softmax(-1).amax(-1)[0] > 1 - 1e-6)
    assert int(one_hot.sum()) > 64
    torch.testing.assert_close(out[0][one_hot], top[one_hot], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("scale,causal,off", [
    ((1.0, 1.0), True, 0), ((1.0, 1.0), False, 0), ((1.0, 1.0), True, 37),
    ((11.0, 25.0), True, 0),               # the LM's init spreads: one-hot
    ((40.0, 40.0), False, 0)])
def test_flash_attention_bf16_p_stays_within_its_bound(rng, scale, causal,
                                                       off):
    """The bound the tensor-core kernel is held to on the card: rounding p
    to bf16 for the product with v (the normaliser summing the fp32 p)
    moves an output by at most 2⁻⁸·max|v|, since |Σⱼ(p̂ⱼ − pⱼ)vⱼ| / l ≤
    2⁻⁸·Σⱼ pⱼ|vⱼ| / l. fp32 inputs, so no other rounding enters."""
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               * c for shape, c in (((2, 10, 96, 128), scale[0]),
                                    ((2, 2, 160, 128), scale[1]),
                                    ((2, 2, 160, 128), 1.0)))
    exact = ref.flash_attention_ref(q, k, v, causal, off)
    rounded = ref.flash_attention_ref(q, k, v, causal, off,
                                      p_dtype=torch.bfloat16)
    gap = float((rounded - exact).abs().max())
    assert 0 < gap <= 2.0 ** -8 * float(v.abs().max())


def test_flash_attention_ref_keeps_p_in_fp32_by_default(rng):
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 4, 64, 32))
                                .astype(np.float32)) for _ in range(3))
    torch.testing.assert_close(
        ref.flash_attention_ref(q, k, v),
        ref.flash_attention_ref(q, k, v, p_dtype=torch.float32),
        rtol=0, atol=0)


def _online_bf16_p(q, k, v, causal, off, tile=128):
    """The tensor-core kernel's arithmetic in plain PyTorch: key tiles of
    128, p rounded to bf16 relative to the running max, the accumulator
    rescaled by exp(m_old − m_new), the normaliser summing the fp32 p."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, KV, H // KV, Sq, D)
    m = torch.full((B, KV, H // KV, Sq, 1), -math.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, H // KV, Sq, v.shape[-1]))
    for k0 in range(0, Sk, tile):
        s = torch.einsum("bkgqd,bksd->bkgqs", qf,
                         k[:, :, k0:k0 + tile].float()) / math.sqrt(D)
        if causal:
            kpos = torch.arange(k0, min(k0 + tile, Sk))
            s = s.masked_fill(kpos[None] > torch.arange(Sq)[:, None] + off,
                              -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bkgqs,bksd->bkgqd", p.to(torch.bfloat16).float(),
            v[:, :, k0:k0 + tile].float())
        m = m_new
    return (acc / l.clamp(min=1e-30)).reshape(B, H, Sq, -1).to(q.dtype)


@pytest.mark.parametrize("scale,causal,off", [
    ((1.0, 1.0), True, 0), ((1.0, 1.0), False, 0), ((1.0, 1.0), True, 300),
    ((11.0, 25.0), True, 0),               # the LM's init spreads: one-hot
    ((3.0, 3.0), False, 0)])
def test_flash_attention_tc_bounds_hold_the_kernels_arithmetic(
        rng, scale, causal, off):
    """The tensor-core kernel's rounding (``_online_bf16_p``, three key
    tiles) stays within both bounds it is held to on the card."""
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .mul(c).to(torch.bfloat16)
               for shape, c in (((1, 10, 200, 128), scale[0]),
                                ((1, 2, 330, 128), scale[1]),
                                ((1, 2, 330, 128), 1.0)))
    got = _online_bf16_p(q, k, v, causal, off).float()
    for name, want, limit in ref.flash_attention_tc_bounds(q, k, v, causal,
                                                           off):
        assert bool(((got - want.float()).abs() <= limit).all()), name


def test_flash_attention_tc_bounds_catch_an_off_by_one_diagonal(rng):
    """A causal mask one key too wide is caught by the bound against the
    plain version with p in bf16."""
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 4, 512, 128))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    wrong = ref.flash_attention_ref(q, k, v, True, 1,
                                    p_dtype=torch.bfloat16).float()
    (name, want, limit), _ = ref.flash_attention_tc_bounds(q, k, v)
    assert name == "p_bf16"
    assert not bool(((wrong - want.float()).abs() <= limit).all())


@pytest.mark.parametrize("dtype,D,Dv,want", [
    (torch.bfloat16, 128, 128, "tensor_cores"),
    (torch.float32, 128, 128, "cuda_cores"),
    (torch.bfloat16, 64, 64, "cuda_cores"),
    (torch.bfloat16, 128, 64, "cuda_cores"),
    (torch.bfloat16, 32, 32, "cuda_cores")])
def test_flash_attention_variant_rule(dtype, D, Dv, want):
    """The fixed rule: bf16 at D = Dv = 128 (the LM path's heads) takes the
    tensor-core kernel, everything else the CUDA-core one."""
    assert variant(dtype, D, Dv) == want


def test_tensor_core_output_is_a_view_of_bshd_storage():
    """The tensor-core kernel writes (B, Sq, H, Dv) storage and returns its
    (B, H, Sq, Dv) view, so the model's transpose back and reshape to
    (B, Sq, H·Dv) copy nothing."""
    out = tc_output(2, 5, 7, 128)
    assert out.shape == (2, 5, 7, 128) and out.dtype == torch.bfloat16
    flat = out.transpose(1, 2).reshape(2, 7, -1)
    assert flat.data_ptr() == out.data_ptr() and flat._base is not None


def test_tensor_core_wrapper_refuses_cpu_tensors():
    """bf16 at head width 128, the tensor-core variant's inputs, on the CPU:
    the wrapper raises, it does not run the plain version."""
    q = torch.zeros((1, 2, 4, 128), dtype=torch.bfloat16)
    assert variant(q.dtype, 128, 128) == "tensor_cores"
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q[:, :1], q[:, :1])


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

WRAPPERS = {
    "fwht": (fwht_cuda, ops.fwht,
             lambda X, qs, arm, blk: ((X,), {})),
    "fused_epoch_pull": (fused_epoch_pull_cuda, ops.fused_epoch_pull,
                         lambda X, qs, arm, blk: ((X, qs, arm, blk),
                                                  dict(block=64))),
    "block_pull_multi": (block_pull_multi_cuda, ops.block_pull_multi,
                         lambda X, qs, arm, blk: ((X, qs, arm, blk),
                                                  dict(block=64))),
    "block_pull": (block_pull_cuda, ops.block_pull,
                   lambda X, qs, arm, blk: ((X, qs[0], arm[0], blk[0]),
                                            dict(block=64))),
    "pairwise_dist": (pairwise_dist_cuda, ops.pairwise_dist,
                      lambda X, qs, arm, blk: ((qs, X), {})),
    "flash_attention": (flash_attention_cuda, ops.flash_attention,
                        lambda X, qs, arm, blk: ((X.reshape(1, 4, 4, 128),
                                                  qs.reshape(1, 1, 4, 128),
                                                  qs.reshape(1, 1, 4, 128)),
                                                 {})),
}


PLAIN = {"fwht": ref.fwht_ref, "fused_epoch_pull": ref.fused_epoch_pull_ref,
         "block_pull_multi": ref.block_pull_multi_ref,
         "block_pull": ref.block_pull_ref,
         "pairwise_dist": ref.pairwise_dist_ref,
         "flash_attention": ref.flash_attention_ref}


def test_auto_on_cpu_uses_plain_versions(rng):
    """impl="auto" on a CPU tensor never reaches a kernel wrapper: it gives
    exactly what the plain function gives."""
    operands = tuple(map(torch.from_numpy,
                         _pull_inputs(rng, 2, 8, 256, 64, 3, 2)))
    before = [w.launches for w, _, _ in WRAPPERS.values()]
    for name, (_, op, args) in WRAPPERS.items():
        a, kw = args(*operands)
        torch.testing.assert_close(op(*a, **kw), PLAIN[name](*a, **kw),
                                   rtol=0, atol=0)
    assert [w.launches for w, _, _ in WRAPPERS.values()] == before


@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_cuda_impl_on_cpu_tensor_raises(rng, kernel):
    _, op, args = WRAPPERS[kernel]
    a, kw = args(*map(torch.from_numpy, _pull_inputs(rng, 2, 8, 256, 64, 3, 2)))
    with pytest.raises(ValueError, match="CUDA"):
        op(*a, **kw, impl="cuda")


@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_kernel_wrappers_refuse_cpu_tensors(rng, kernel):
    """The wrappers launch or raise; they never compute on the CPU."""
    wrapper, _, args = WRAPPERS[kernel]
    a, kw = args(*map(torch.from_numpy, _pull_inputs(rng, 2, 8, 256, 64, 3, 2)))
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*a, **kw)


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown impl"):
        ops.fwht(torch.zeros(2, 4), impl="pallas")
