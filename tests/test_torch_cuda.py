"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs, and the query path on the card. These need an
NVIDIA GPU and ``nvcc``; without a GPU they skip. On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 statistics and pulls at rtol 2e-4 / atol 1e-5 (sums
taken in another order), the fp32 transform at 1e-5, bf16 at 5e-2 (the
transform) and 2e-2 (the pulls, as the reference's kernel sweep). Pairwise
distances: ℓ1 at rtol 1e-4 / atol 1e-3; ℓ2 at |got − want| ≤ 1e-4·|want| +
1e-6·(‖q‖² + ‖x‖²), because the plain version's norm expansion cancels."""
import numpy as np
import pytest
import torch

from repro_torch.api import Index
from repro_torch.configs.base import BMOConfig
from repro_torch.core import bmo_nn, oracle
from repro_torch.data.synthetic import make_knn_benchmark_data
from repro_torch.kernels import ops
from repro_torch.kernels.block_pull import block_pull_cuda, block_pull_multi_cuda
from repro_torch.kernels.fused_race import fused_epoch_pull_cuda
from repro_torch.kernels.fwht import fwht_cuda
from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


@pytest.mark.parametrize("d", [2, 8, 64, 1024, 16384, 32768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwht_kernel_matches_plain(gen, d, dtype):
    x = torch.randn((37, d), generator=gen, device="cuda").to(dtype)
    before = fwht_cuda.launches
    got = ops.fwht(x)
    torch.cuda.synchronize()
    assert fwht_cuda.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got.float(), ops.fwht(x, impl="ref").float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("Q,n,d,block,B,T", [
    (3, 16, 256, 128, 4, 6), (5, 32, 512, 64, 8, 2), (2, 8, 1024, 256, 6, 12),
    (4, 64, 384, 128, 16, 9), (4, 64, 256, 32, 5, 3)])
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_fused_epoch_pull_kernel_matches_plain(gen, Q, n, d, block, B, T,
                                               metric):
    x = torch.randn((n, d), generator=gen, device="cuda")
    qs = torch.randn((Q, d), generator=gen, device="cuda")
    arm = torch.randint(0, n, (Q, B), generator=gen, device="cuda")
    arm[0, 0] = -1
    blk = torch.randint(0, d // block, (Q, B, T), generator=gen,
                        device="cuda")
    before = fused_epoch_pull_cuda.launches
    got = ops.fused_epoch_pull(x, qs, arm, blk, block=block, metric=metric)
    torch.cuda.synchronize()
    assert fused_epoch_pull_cuda.launches == before + 1
    want = ops.fused_epoch_pull(x, qs, arm, blk, block=block, metric=metric,
                                impl="ref")
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5)


def test_fused_epoch_pull_flags_out_of_range_ids(gen):
    x = torch.randn((8, 256), generator=gen, device="cuda")
    qs = torch.randn((2, 256), generator=gen, device="cuda")
    arm = torch.tensor([[0, 8], [1, 2]], device="cuda")
    blk = torch.zeros((2, 2, 3), dtype=torch.int32, device="cuda")
    blk[1, 1, 2] = 2
    out = ops.fused_epoch_pull(x, qs, arm, blk, block=128).cpu()
    assert torch.isnan(out[0, 1]).all() and torch.isnan(out[1, 1]).all()
    assert torch.isfinite(out[0, 0]).all() and torch.isfinite(out[1, 0]).all()


@pytest.mark.parametrize("Q,n,d,block,B,P", [
    (3, 16, 256, 128, 4, 2), (5, 32, 512, 64, 8, 3), (2, 8, 1024, 256, 8, 1),
    (4, 64, 384, 128, 16, 5), (3, 40, 256, 32, 7, 2)])
@pytest.mark.parametrize("metric", ["l2", "l1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_pull_kernels_match_plain(gen, Q, n, d, block, B, P, metric,
                                        dtype):
    x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    qs = torch.randn((Q, d), generator=gen, device="cuda").to(dtype)
    arm = torch.randint(0, n, (Q, B), generator=gen, device="cuda")
    arm[0, 0] = -1
    blk = torch.randint(0, d // block, (Q, B, P), generator=gen,
                        device="cuda")
    tol = dict(rtol=2e-4, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=2e-2, atol=2e-2)
    before = (block_pull_multi_cuda.launches, block_pull_cuda.launches)
    got = ops.block_pull_multi(x, qs, arm, blk, block=block, metric=metric)
    one = ops.block_pull(x, qs[1], arm[1], blk[1], block=block, metric=metric)
    torch.cuda.synchronize()
    assert (block_pull_multi_cuda.launches, block_pull_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float32 and got.shape == (Q, B, P)
    assert got[0, 0].tolist() == [0.0] * P
    want = ops.block_pull_multi(x, qs, arm, blk, block=block, metric=metric,
                                impl="ref")
    torch.testing.assert_close(got, want, **tol)
    torch.testing.assert_close(one, want[1], **tol)


def test_block_pull_flags_out_of_range_ids(gen):
    x = torch.randn((8, 256), generator=gen, device="cuda")
    qs = torch.randn((2, 256), generator=gen, device="cuda")
    arm = torch.tensor([[0, 8], [1, 2]], device="cuda")
    blk = torch.zeros((2, 2, 3), dtype=torch.int32, device="cuda")
    blk[1, 0, 2] = 2
    out = ops.block_pull_multi(x, qs, arm, blk, block=128).cpu()
    assert torch.isnan(out[0, 1]).all() and torch.isnan(out[1, 0, 2])
    assert torch.isfinite(out[0, 0]).all() and torch.isfinite(out[1, 1]).all()


def _pairwise_close(got, want, qs, x, metric):
    if metric == "l1":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
        return
    scale = (qs * qs).sum(1)[:, None] + (x * x).sum(1)[None]
    assert bool(((got - want).abs() <= 1e-4 * want.abs() + 1e-6 * scale).all())


@pytest.mark.parametrize("Q,n,d", [(4, 16, 64), (9, 50, 300), (8, 128, 512),
                                   (1, 7, 1000), (1, 32, 16384),
                                   (70, 130, 77), (3, 1000, 33)])
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_pairwise_dist_kernel_matches_plain(gen, Q, n, d, metric):
    qs = torch.randn((Q, d), generator=gen, device="cuda")
    x = torch.randn((n, d), generator=gen, device="cuda")
    before = pairwise_dist_cuda.launches
    got = ops.pairwise_dist(qs, x, metric=metric)
    torch.cuda.synchronize()
    assert pairwise_dist_cuda.launches == before + 1
    assert got.shape == (Q, n) and got.dtype == torch.float32
    want = ops.pairwise_dist(qs, x, metric=metric, impl="ref")
    _pairwise_close(got, want, qs, x, metric)
    exact = ((qs.double()[:, None] - x.double()[None]).abs()
             ** (1 if metric == "l1" else 2)).sum(-1)
    torch.testing.assert_close(got.double(), exact, rtol=1e-5, atol=1e-4)


def test_pairwise_dist_zero_distance(gen):
    x = torch.randn((70, 128), generator=gen, device="cuda")
    assert float(torch.diagonal(ops.pairwise_dist(x, x)).abs().max()) == 0.0


def test_kernels_reject_unsupported_shapes(gen):
    x = torch.randn((8, 384), generator=gen, device="cuda")
    arm = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    blk = torch.zeros((1, 1, 1), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="block"):
        ops.fused_epoch_pull(x, x[:1], arm, blk, block=96)
    with pytest.raises(ValueError, match="block"):
        ops.block_pull_multi(x, x[:1], arm, blk, block=96)
    with pytest.raises(ValueError, match="one type"):
        ops.block_pull(x, x[0].to(torch.bfloat16), arm[0], blk[0], block=128)
    with pytest.raises(ValueError, match="fp32"):
        ops.pairwise_dist(x.to(torch.bfloat16), x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="power of two"):
        ops.fwht(x)


@pytest.mark.parametrize("rotate", [False, True], ids=["dense", "rotated"])
def test_index_query_on_the_card(gen, rotate):
    corpus, queries = make_knn_benchmark_data("dense", 500, 1024, 5, seed=21)
    cfg = BMOConfig(k=3, delta=0.01, block=64, batch_arms=16,
                    pulls_per_round=2, metric="l2", rotate=rotate)
    res = Index.build(corpus, cfg).query(queries)
    dist = ((queries[:, None, :].astype(np.float64)
             - corpus[None].astype(np.float64)) ** 2).sum(-1)
    truth = np.argsort(dist, 1, kind="stable")[:, :3]
    assert [set(r) for r in res.indices.tolist()] == \
        [set(r) for r in truth.tolist()]


def _small_truth(k):
    corpus, queries = make_knn_benchmark_data("dense", 500, 1024, 5, seed=21)
    dist = ((queries[:, None, :].astype(np.float64)
             - corpus[None].astype(np.float64)) ** 2).sum(-1)
    return corpus, queries, [set(r) for r in np.argsort(
        dist, 1, kind="stable")[:, :k].tolist()]


@pytest.mark.parametrize("rotate", [False, True], ids=["dense", "rotated"])
def test_rounds_driver_on_the_card(gen, rotate):
    corpus, queries, truth = _small_truth(3)
    cfg = BMOConfig(k=3, delta=0.01, block=64, batch_arms=16,
                    pulls_per_round=2, metric="l2", rotate=rotate)
    before = block_pull_multi_cuda.launches
    res = Index.build(corpus, cfg).query(queries, mode="rounds")
    assert block_pull_multi_cuda.launches > before
    assert [set(r) for r in res.indices.tolist()] == truth


@pytest.mark.parametrize("rotate", [False, True], ids=["dense", "rotated"])
def test_paper_path_and_oracle_on_the_card(gen, rotate):
    corpus, queries, truth = _small_truth(3)
    cfg = BMOConfig(k=3, delta=0.01, block=64, batch_arms=16,
                    pulls_per_round=2, metric="l2", rotate=rotate)
    before = (block_pull_cuda.launches, pairwise_dist_cuda.launches)
    res = bmo_nn.knn(corpus, queries, cfg, 0)
    ex = oracle.exact_knn(corpus, queries, 3)
    assert block_pull_cuda.launches > before[0]
    assert pairwise_dist_cuda.launches > before[1]
    assert [set(r) for r in res.indices.tolist()] == truth
    assert [set(r) for r in ex.indices.tolist()] == truth
