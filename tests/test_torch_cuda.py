"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs, and the query path on the card. These need an
NVIDIA GPU and ``nvcc``; without a GPU they skip. On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 statistics at rtol 2e-4 / atol 1e-5 (sums taken in
another order), the fp32 transform at 1e-5, bf16 at 5e-2."""
import numpy as np
import pytest
import torch

from repro_torch.api import Index
from repro_torch.configs.base import BMOConfig
from repro_torch.data.synthetic import make_knn_benchmark_data
from repro_torch.kernels import ops
from repro_torch.kernels.fused_race import fused_epoch_pull_cuda
from repro_torch.kernels.fwht import fwht_cuda

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


def test_kernels_reject_unsupported_shapes(gen):
    x = torch.randn((8, 384), generator=gen, device="cuda")
    arm = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    blk = torch.zeros((1, 1, 1), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="block"):
        ops.fused_epoch_pull(x, x[:1], arm, blk, block=96)
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
