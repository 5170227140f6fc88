"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs, and the query path on the card. These need an
NVIDIA GPU and ``nvcc``; without a GPU they skip. On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 statistics and pulls at rtol 2e-4 / atol 1e-5 (sums
taken in another order), the fp32 transform at 1e-5, bf16 at 5e-2 (the
transform) and 2e-2 (the pulls, as the reference's kernel sweep). Pairwise
distances: ℓ1 at rtol 1e-4 / atol 1e-3; ℓ2 at |got − want| ≤ 1e-4·|want| +
1e-6·(‖q‖² + ‖x‖²), because the plain version's norm expansion cancels;
both, and ℓ2 on inputs made to cancel (which the tensor-core variant
repairs), also against a float64 brute force at rtol 1e-5 / atol 1e-4.
Flash attention: fp32 at rtol/atol 3e-5 (the reference kernel test's
3e-5). The CUDA-core kernel's bf16 outputs within one bf16 ulp (rtol 8e-3,
atol 1e-4), since both round the same fp32 values. The tensor-core kernel
(bf16 at head width 128) rounds p to bf16 for the product with v; it is
held to both bounds of ``ref.flash_attention_tc_bounds``, where each is
derived: against the plain version with p in bf16 (its contract) at one
bf16 ulp plus 6·2⁻⁸ times each output's own rounding spread, and against
the plain version with p in fp32 at one ulp plus (2⁻⁸ + 1e-4)·max|v|. The
LM forward in fp32 at 1e-4, its bf16 loss at 1e-3 relative. The namespace
fleet on the card: evict → reload bit-identical (a sharded namespace
included), and an evicted store's device memory released. Training: one
SMOKE train step on the card against the same step on the CPU (fp32, every
leaf within 1e-4 of its largest entry, grad_norm at 1e-4), and the
Supervisor's restart
bit-identical to an uninterrupted run under deterministic algorithms."""
import gc

import numpy as np
import pytest
import torch

from repro_torch.api import Index
from repro_torch.configs.base import BMOConfig
from repro_torch.core import bmo_nn, oracle
from repro_torch.data.synthetic import make_knn_benchmark_data
from repro_torch.kernels import ops, ref
from repro_torch.configs import get_arch
from repro_torch.kernels.block_pull import block_pull_cuda, block_pull_multi_cuda
from repro_torch.kernels.flash_attn import flash_attention_cuda, variant
from repro_torch.kernels.fused_race import fused_epoch_pull_cuda
from repro_torch.kernels.fwht import fwht_cuda
from repro_torch.kernels.pairwise_dist import (flagged_pairs,
                                               pairwise_dist_cuda,
                                               reset_flagged)
from repro_torch.models import build_model
from repro_torch.train.loss import lm_loss

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


FWHT_DS = [2 ** k for k in range(1, 16)]


def _fwht_checked(x):
    """The kernel on x, launched once, against the plain version."""
    before = fwht_cuda.launches
    got = ops.fwht(x)
    torch.cuda.synchronize()
    assert fwht_cuda.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    tol = 1e-5 if x.dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got.float(), ops.fwht(x, impl="ref").float(),
                               rtol=tol, atol=tol)
    return got


@pytest.mark.parametrize("d", FWHT_DS)
@pytest.mark.parametrize("rows", [1, 37, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwht_kernel_matches_plain(gen, d, rows, dtype):
    """Every d the kernel takes; 37 and 1,000 rows leave the narrow plans'
    last block ragged."""
    _fwht_checked(torch.randn((rows, d), generator=gen, device="cuda").to(dtype))


@pytest.mark.parametrize("d", [2, 8, 2048, 4096, 16384, 32768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwht_kernel_takes_3d_and_strided_inputs(gen, d, dtype):
    base = torch.randn((6, 7, 2 * d), generator=gen, device="cuda").to(dtype)
    _fwht_checked(base[..., :d].contiguous())             # 3-D
    _fwht_checked(base[..., ::2])                         # strided columns
    _fwht_checked(base.transpose(0, 1)[..., d:])          # permuted, offset
    flat = base.reshape(-1)[1:1 + 5 * d].reshape(5, d)    # off a 16-byte line
    assert flat.data_ptr() % 16
    _fwht_checked(flat)


@pytest.mark.parametrize("d", FWHT_DS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwht_kernel_on_zeros_and_huge_values(gen, d, dtype):
    """Rows of exact zeros (exactly zero out), rows with one ±1e30 among
    zeros or among unit values, and rows with one +1e30 and one −1e30:
    every partial sum is exact or absorbed, whatever the order of stages."""
    rows = 12
    x = torch.randn((rows, d), generator=gen, device="cuda")
    x[:6] = 0.0
    col = torch.randint(0, d, (rows,), generator=gen, device="cuda")
    sign = torch.where(torch.arange(rows, device="cuda") % 2 == 0, 1e30, -1e30)
    r = torch.arange(2, rows, device="cuda")
    x[r, col[2:]] = sign[2:]
    x[4:6, (col[4:6] + 1) % d] = -sign[4:6]               # a cancelling pair
    got = _fwht_checked(x.to(dtype))
    assert (got[:2] == 0).all()
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("d", FWHT_DS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwht_kernel_follows_its_plan(gen, d, dtype):
    """The kernel launches with ``fwht_plan.plan``'s numbers, and computes
    what ``ref.fwht_staged`` replays: the same fp32 additions in the same
    order, so bit for bit where d = 4^k (the division by √d is a product
    by 2^-k there, as PyTorch's by a scalar on the card is); elsewhere the
    kernel divides and PyTorch multiplies by the reciprocal, one fp32 ulp
    apart (one bf16 ulp after the cast, at a rounding tie)."""
    from repro_torch.kernels.fwht import kernel_plan
    from repro_torch.kernels.fwht_plan import plan
    p = plan(d, dtype)
    got_plan = kernel_plan(d, dtype)
    assert (got_plan["E"], got_plan["threads"], got_plan["rows_per_block"],
            got_plan["smem"]) == (p.E, p.threads, p.rows_per_block, p.smem)
    assert got_plan["blocks_per_sm"] >= 1
    x = torch.randn((37, d), generator=gen, device="cuda").to(dtype)
    got, want = ops.fwht(x), ref.fwht_staged(x, p)
    if d.bit_length() % 2 == 1:                           # d = 4^k
        assert torch.equal(got, want)
    else:
        rtol = 1.2e-7 if dtype == torch.float32 else 7.9e-3
        torch.testing.assert_close(got, want, rtol=rtol, atol=0)


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


# --- the pull kernels' two schedules (kernels/pull_schedule.py) ------------

def _pull_case(gen, Q, n, d, block, B, T, dtype=torch.float32, shared=True):
    """Operands with a negative arm (0 or (0, 0)), an arm past the corpus
    (NaN) and a block past the row (NaN for its pull); the arms either one
    vector every query shares (expanded) or one row per query. Returns the
    operands and what the plain version is given in the bad lanes' place."""
    x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    qs = torch.randn((Q, d), generator=gen, device="cuda").to(dtype)
    nb = d // block
    if shared:
        vec = torch.randint(0, n, (B,), generator=gen, device="cuda",
                            dtype=torch.int32)
        vec[1], vec[3] = -1, n
        arm = vec[None].expand(Q, B)
    else:
        arm = torch.randint(0, n, (Q, B), generator=gen, device="cuda",
                            dtype=torch.int32)
        arm[:, 1], arm[:, 3] = -1, n
    blk = torch.randint(0, nb, (Q, B, T), generator=gen, device="cuda",
                        dtype=torch.int32)
    blk[Q - 1, B - 1, T - 1] = nb
    plain_arm = torch.where(arm >= n, -1, arm)
    plain_blk = torch.clamp(blk, max=nb - 1)
    return x, qs, arm, blk, plain_arm, plain_blk


def _hold_to_plain(got, want, arm, n, blk, nb, per_pull):
    """Negative arms give 0, bad lanes NaN, the rest the plain version's
    values at rtol 2e-4 / atol 1e-5."""
    bad_blk = blk >= nb
    nan = (arm >= n)[..., None] | (bad_blk if per_pull
                                   else bad_blk.any(-1, keepdim=True))
    nan = nan.expand_as(got)
    assert torch.isnan(got[nan]).all()
    assert (got[(arm < 0)[..., None].expand_as(got)] == 0).all()
    torch.testing.assert_close(got[~nan], want[~nan], rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("schedule", ["rows", "pair"])
@pytest.mark.parametrize("block", [32, 64, 128, 256])
@pytest.mark.parametrize("metric", ["l2", "l1"])
@pytest.mark.parametrize("T", [1, 7])
def test_fused_epoch_pull_schedules_match_plain(gen, schedule, block, metric,
                                                T):
    n, d = 40, 1024
    x, qs, arm, blk, parm, pblk = _pull_case(gen, 5, n, d, block, 9, T)
    counter = f"launches_{schedule}"
    before = getattr(fused_epoch_pull_cuda, counter)
    got = fused_epoch_pull_cuda(x, qs, arm, blk, block=block, metric=metric,
                                _schedule=schedule)
    torch.cuda.synchronize()
    assert getattr(fused_epoch_pull_cuda, counter) == before + 1
    want = ref.fused_epoch_pull_ref(x, qs, parm, pblk, block, metric)
    _hold_to_plain(got, want, arm, n, blk, d // block, per_pull=False)


@pytest.mark.parametrize("n_buf", [2, 3, 8])
@pytest.mark.parametrize("shared", [False, True], ids=["general", "expanded"])
@pytest.mark.parametrize("B,T", [(37, 128), (5, 2), (64, 33)])
def test_fused_epoch_pull_pair_streaming_depth(gen, n_buf, shared, B, T):
    """The pair schedule at n_buf slots an arm, over arm sets that fill and
    do not fill a block's warps, with T above and below the blocks a row
    holds (128 at d_pad 16,384, block 128): its distinct blocks read once."""
    n, d, block = 300, 16384, 128
    x, qs, arm, blk, parm, pblk = _pull_case(gen, 3, n, d, block, B, T,
                                             shared=shared)
    got = fused_epoch_pull_cuda(x, qs, arm, blk, block=block, n_buf=n_buf,
                                _schedule="pair")
    want = ref.fused_epoch_pull_ref(x, qs, parm, pblk, block)
    _hold_to_plain(got, want, arm, n, blk, d // block, per_pull=False)


@pytest.mark.parametrize("schedule", ["rows", "pair"])
@pytest.mark.parametrize("block", [32, 64, 128, 256])
@pytest.mark.parametrize("metric", ["l2", "l1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [1, 3])
def test_block_pull_multi_schedules_match_plain(gen, schedule, block, metric,
                                                dtype, P):
    n, d = 40, 1024
    x, qs, arm, blk, parm, pblk = _pull_case(gen, 5, n, d, block, 9, P,
                                             dtype=dtype)
    counter = f"launches_{schedule}"
    before = getattr(block_pull_multi_cuda, counter)
    got = block_pull_multi_cuda(x, qs, arm, blk, block=block, metric=metric,
                                _schedule=schedule)
    torch.cuda.synchronize()
    assert getattr(block_pull_multi_cuda, counter) == before + 1
    want = ref.block_pull_multi_ref(x, qs, parm, pblk, block, metric)
    _hold_to_plain(got, want, arm, n, blk, d // block, per_pull=True)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 16384),
                                     (torch.bfloat16, 16384),
                                     (torch.bfloat16, 32768)])
def test_pull_rows_schedule_stages_wide_rows(gen, dtype, d):
    """One staged row a block takes d·itemsize of dynamic shared memory: 64
    KB at fp32 and d_pad 16,384 or at bf16 and 32,768, above the 48 KB
    default (32 KB at bf16 and 16,384, below it)."""
    n, block = 50, 128
    x, qs, arm, blk, parm, pblk = _pull_case(gen, 4, n, d, block, 11, 2,
                                             dtype=dtype)
    got = block_pull_multi_cuda(x, qs, arm, blk, block=block,
                                _schedule="rows")
    want = ref.block_pull_multi_ref(x, qs, parm, pblk, block)
    _hold_to_plain(got, want, arm, n, blk, d // block, per_pull=True)
    if dtype == torch.float32:
        got = fused_epoch_pull_cuda(x, qs, arm, blk, block=block,
                                    _schedule="rows")
        want = ref.fused_epoch_pull_ref(x, qs, parm, pblk, block)
        _hold_to_plain(got, want, arm, n, blk, d // block, per_pull=False)


@pytest.mark.parametrize("n_buf", [2, 8])
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("T", [1, 7, 300])
def test_fused_epoch_pull_pair_reads_unstaged_query_slices(gen, n_buf, block,
                                                           T):
    """A 256 KB fp32 row does not fit in shared memory: the pair schedule
    streams the corpus slices through its ring and reads the query slices
    from device memory."""
    n, d = 8, 65536
    x, qs, arm, blk, parm, pblk = _pull_case(gen, 2, n, d, block, 6, T,
                                             shared=False)
    got = fused_epoch_pull_cuda(x, qs, arm, blk, block=block, n_buf=n_buf)
    want = ref.fused_epoch_pull_ref(x, qs, parm, pblk, block)
    _hold_to_plain(got, want, arm, n, blk, d // block, per_pull=False)


def test_pull_schedules_follow_the_operands(gen):
    """An expanded arm tensor at a wide init's proportions takes the rows
    schedule, a general one the pair schedule; a row too wide for shared
    memory takes the pair schedule with the query slices read from device
    memory, and cannot be forced onto rows."""
    n, d, block = 64, 1024, 32
    x, qs, arm, blk, parm, pblk = _pull_case(gen, 64, n, d, block, 16, 2)
    counts = lambda w: (w.launches_rows, w.launches_pair)
    for wrapper, plain, per_pull in (
            (fused_epoch_pull_cuda, ref.fused_epoch_pull_ref, False),
            (block_pull_multi_cuda, ref.block_pull_multi_ref, True)):
        for a, pa, which in ((arm, parm, 0), (arm.contiguous(),
                                              parm.contiguous(), 1)):
            before = counts(wrapper)
            got = wrapper(x, qs, a, blk, block=block)
            after = counts(wrapper)
            assert after[which] == before[which] + 1
            assert after[1 - which] == before[1 - which]
            _hold_to_plain(got, plain(x, qs, pa, pblk, block), a, n, blk,
                           d // block, per_pull)
    wide = 65536                                  # a 256 KB fp32 row
    x, qs, arm, blk, parm, pblk = _pull_case(gen, 2, 8, wide, 128, 6, 3)
    got = fused_epoch_pull_cuda(x, qs, arm, blk, block=128)
    _hold_to_plain(got, ref.fused_epoch_pull_ref(x, qs, parm, pblk, 128),
                   arm, 8, blk, wide // 128, per_pull=False)
    with pytest.raises(ValueError, match="rows schedule"):
        fused_epoch_pull_cuda(x, qs, arm, blk, block=128, _schedule="rows")


def _pairwise_close(got, want, qs, x, metric):
    if metric == "l1":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
        return
    scale = (qs * qs).sum(1)[:, None] + (x * x).sum(1)[None]
    assert bool(((got - want).abs() <= 1e-4 * want.abs() + 1e-6 * scale).all())


@pytest.mark.parametrize("Q,n,d", [(4, 16, 64), (9, 50, 300), (8, 128, 512),
                                   (1, 7, 1000), (1, 32, 16384),
                                   (70, 130, 77), (3, 1000, 33),
                                   (256, 1001, 256)])
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


def _cancelling(kind: str, gen) -> tuple:
    """(queries, corpus, the corpus row of each query where the two share
    rows, else None): inputs on which ‖q‖² + ‖x‖² − 2·q·x cancels, as the
    CPU tests of the kernel's replay (``tests/test_torch_pairwise.py``)."""
    if kind == "wide":                       # d = 12,288, few rows
        x = torch.randn((6, 12288), generator=gen, device="cuda")
        return x, x, torch.arange(6)
    x = 3.0 * torch.randn((48, 512), generator=gen, device="cuda")
    if kind == "duplicates":                 # some corpus rows twice
        return x[:12], torch.cat([x, x[:4]]), torch.arange(12)
    if kind == "near_duplicates":
        noise = torch.randn((12, 512), generator=gen, device="cuda")
        return x[:12] + 1e-3 * noise, x, None
    return x[:12] + 100.0, x + 100.0, torch.arange(12)     # "offset"


@pytest.mark.parametrize("kind", ["duplicates", "near_duplicates", "offset",
                                  "wide"])
def test_pairwise_dist_tensor_cores_repair_cancellation(gen, kind):
    """The tensor-core variant on inputs made to cancel: its repair pass
    flags pairs, and the result holds to float64 as the CUDA-core kernel's
    does, with exactly 0.0 where a query is a corpus row."""
    qs, x, same = _cancelling(kind, gen)
    before = (pairwise_dist_cuda.launches_tc, pairwise_dist_cuda.launches_cc)
    reset_flagged()
    got = ops.pairwise_dist(qs, x)
    torch.cuda.synchronize()
    assert (pairwise_dist_cuda.launches_tc, pairwise_dist_cuda.launches_cc) \
        == (before[0] + 1, before[1])
    assert flagged_pairs() >= (1 if same is None else len(same))
    exact = ((qs.double()[:, None] - x.double()[None]) ** 2).sum(-1)
    torch.testing.assert_close(got.double(), exact, rtol=1e-5, atol=1e-4)
    if same is not None:
        assert got[torch.arange(len(same)), same].tolist() == [0.0] * len(same)


def test_pairwise_dist_variants_by_shape(gen):
    """The oracle's shape (256 queries against 100,000 rows at d = 12,288)
    takes the tensor cores; d = 77 (rows TMA cannot describe) and ℓ1 the
    CUDA cores."""
    x = torch.randn((100_000, 12_288), generator=gen, device="cuda")
    qs = torch.randn((256, 12_288), generator=gen, device="cuda")
    counters = lambda: (pairwise_dist_cuda.launches_tc,
                        pairwise_dist_cuda.launches_cc)
    before = counters()
    got = ops.pairwise_dist(qs, x)
    torch.cuda.synchronize()
    assert counters() == (before[0] + 1, before[1])
    exact = ((qs[:8].double()[:, None] - x[:1000].double()[None]) ** 2).sum(-1)
    torch.testing.assert_close(got[:8, :1000].double(), exact, rtol=1e-5,
                               atol=1e-4)
    del x, got
    for metric, (Q, n, d) in (("l2", (70, 130, 77)), ("l1", (70, 130, 128))):
        before = counters()
        ops.pairwise_dist(torch.randn((Q, d), generator=gen, device="cuda"),
                          torch.randn((n, d), generator=gen, device="cuda"),
                          metric=metric)
        assert counters() == (before[0], before[1] + 1)


def _cuda_kernels_per_call(fn, calls: int = 10) -> float:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(ev, "is_user_annotation", False)) / calls


@pytest.mark.parametrize("arm_type", [torch.int64, torch.int32])
@pytest.mark.parametrize("blk_type", [torch.int32, torch.int64])
def test_block_pull_takes_its_ids_as_they_are(gen, arm_type, blk_type):
    """One CUDA kernel a call (no conversion of the ids), whichever of int32
    and int64 they are, and the same pulls as the plain version."""
    x = torch.randn((1000, 1024), generator=gen, device="cuda")
    q = torch.randn((1024,), generator=gen, device="cuda")
    arm = torch.randint(0, 1000, (32,), generator=gen, device="cuda",
                        dtype=arm_type)
    blk = torch.randint(0, 8, (32, 2), generator=gen, device="cuda",
                        dtype=blk_type)
    run = lambda: block_pull_cuda(x, q, arm, blk, block=128)
    assert _cuda_kernels_per_call(run) == 1.0
    torch.testing.assert_close(run(), ref.block_pull_ref(x, q, arm, blk, 128),
                               rtol=2e-4, atol=1e-5)


def test_exact_evaluation_is_one_cuda_kernel(gen):
    """The paper path's exact evaluation: one query against the rows its
    int64 arm ids select, one CUDA kernel a call."""
    x = torch.randn((1000, 16384), generator=gen, device="cuda")
    q = torch.randn((16384,), generator=gen, device="cuda")
    rows = x[torch.randint(0, 1000, (32,), generator=gen, device="cuda")]
    assert _cuda_kernels_per_call(lambda: pairwise_dist_cuda(q[None], rows)) \
        == 1.0


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


def _mutable_case(rotate):
    """16 queries over 500 rows of d = 1,000 (d_pad 1,024): enough that the
    wide init takes the rows schedule (Q·T·block = 2,048 ≥ d_pad)."""
    corpus, queries = make_knn_benchmark_data("dense", 500, 1000, 16, seed=4)
    cfg = BMOConfig(k=3, delta=0.01, block=64, batch_arms=16,
                    pulls_per_round=2, metric="l2", rotate=rotate)
    return corpus, queries, cfg


@pytest.mark.parametrize("rotate", [False, True], ids=["dense", "rotated"])
def test_index_save_load_round_trip_on_the_card(gen, tmp_path, rotate):
    corpus, queries, cfg = _mutable_case(rotate)
    idx = Index.build(corpus, cfg, payload=np.arange(500) * 2)
    path = str(tmp_path / "idx")
    idx.save(path)
    loaded = Index.load(path)
    assert loaded.device.type == "cuda"
    assert loaded.store.meta() == idx.store.meta()
    for name, arr in idx.store.arrays().items():
        got = loaded.store.arrays()[name]
        assert got.is_cuda and got.dtype == arr.dtype
        assert torch.equal(got, arr), name
    np.testing.assert_array_equal(loaded.payload, idx.payload)
    want, got = idx.query(queries, 1), loaded.query(queries, 1)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.values, want.values)


def test_rotated_insert_launches_fwht_once(gen):
    corpus, queries, cfg = _mutable_case(True)
    idx = Index.build(corpus, cfg)
    rows = torch.from_numpy(queries + 1e-3).cuda()
    before = fwht_cuda.launches
    slots = idx.insert(rows)
    assert fwht_cuda.launches == before + 1
    st = idx.store
    padded = torch.nn.functional.pad(rows, (0, st.d_pad - rows.shape[1]))
    want = ref.fwht_ref(padded * st.signs[None, :])
    torch.testing.assert_close(st.x[torch.from_numpy(slots).cuda()], want,
                               rtol=1e-5, atol=1e-5)
    res = idx.query(queries)
    assert res.indices[:, 0].tolist() == slots.tolist()


@pytest.mark.parametrize("rotate", [False, True], ids=["dense", "rotated"])
def test_query_after_deletes_skips_dead_slots_on_the_rows_schedule(gen,
                                                                   rotate):
    corpus, queries, cfg = _mutable_case(rotate)
    dist = ((queries[:, None, :].astype(np.float64)
             - corpus[None].astype(np.float64)) ** 2).sum(-1)
    kill = sorted(set(np.argsort(dist, 1)[:, :2].ravel().tolist())
                  | set(range(0, 500, 7)))
    live = np.setdiff1d(np.arange(500), kill)
    truth = [set(live[r].tolist()) for r in
             np.argsort(dist[:, live], 1, kind="stable")[:, :3]]
    idx = Index.build(corpus, cfg)
    idx.delete(kill)
    rows0 = fused_epoch_pull_cuda.launches_rows
    res = idx.query(queries)
    assert fused_epoch_pull_cuda.launches_rows == rows0 + 1     # the init
    assert not set(res.indices.ravel().tolist()) & set(kill)
    assert [set(r) for r in res.indices.tolist()] == truth


def test_fused_session_on_the_card_certifies_with_one_sync_an_epoch(gen):
    """An anytime session on the card (``Index.race``, rotated box with d =
    1100 padded to 2048) certifies the exact top-k with θ = ρ/d, and each
    epoch crosses to the host once: one ``host_fetch``, and one
    synchronizing CUDA call by torch's sync debug mode."""
    import warnings
    from repro_torch.utils import hostsync
    corpus, queries = make_knn_benchmark_data("dense", 3000, 1100, 8, seed=0)
    cfg = BMOConfig(k=5, delta=0.01, block=128, batch_arms=32, rotate=True)
    idx = Index.build(corpus, cfg)
    sess = idx.race(queries, 0)
    per_epoch = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        while True:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                before = hostsync.syncs()
                going = sess.step()
            per_epoch.append((hostsync.syncs() - before, sum(
                "synchroniz" in str(w.message) for w in caught)))
            if not going:
                break
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert per_epoch == [(1, 1)] * len(per_epoch)
    c, q = corpus.astype(np.float64), queries.astype(np.float64)
    dist = (q * q).sum(1)[:, None] + (c * c).sum(1)[None] - 2.0 * q @ c.T
    truth = np.argsort(dist, 1, kind="stable")[:, :5]
    snap = sess.snapshot
    assert [set(r) for r in snap.ids.tolist()] == \
        [set(r) for r in truth.tolist()]
    assert (snap.acc_count == 5).all() and (snap.ci == 0).all()
    theta = np.take_along_axis(dist, snap.ids.astype(np.int64), 1) / 1100
    np.testing.assert_allclose(snap.values, theta, rtol=2e-4)


def test_sparse_box_on_the_card_matches_the_cpu(gen):
    """The sparse box's pulls (Eq. 12: a binary search in each arm's row and
    the queries' position table), its exact evaluations and its oracle
    (``pairwise_dist`` ℓ1 on densified chunks) on the card, against the
    same calls on the CPU from the same corpus and draws: pulls at rtol
    1e-6 (elementwise fp32 on both), exact θ at rtol 1e-5 (sums in another
    order), the oracle's ids equal and θ at rtol 1e-5; then a query of the
    index finds the oracle's top-k."""
    corpus, (qi, qv, qn) = make_knn_benchmark_data(
        "sparse", 3000, 4096, 16, device="cuda", generator=gen)
    corpus.nnz[5] = 0                               # an empty row
    corpus.indices[5] = corpus.d
    corpus.values[5] = 0.0
    cpu = corpus.to("cpu")
    qs = bmo_nn.sparse_queries(qi, qv, qn, corpus.d, "cuda")
    qs_cpu = bmo_nn.sparse_queries(qi.cpu(), qv.cpu(), qn.cpu(), corpus.d,
                                   "cpu")
    arm = torch.randint(-1, 3000, (16, 32), generator=gen, device="cuda")
    arm[:, 0] = 5
    an = torch.where(arm >= 0, corpus.nnz[arm.clamp(min=0)], 0)
    draws = bmo_nn.default_coord_sampler(gen, torch.device("cuda"))(
        qn[:, None, None].expand(16, 32, 4), an[..., None].expand(16, 32, 4))
    got = bmo_nn.sparse_pull_one(corpus, qs, arm, draws)
    want = bmo_nn.sparse_pull_one(cpu, qs_cpu, arm.cpu(),
                                  tuple(t.cpu() for t in draws))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0.0)
    live = arm.clamp(min=0)
    torch.testing.assert_close(
        bmo_nn.sparse_exact_theta(corpus, qs, live).cpu(),
        bmo_nn.sparse_exact_theta(cpu, qs_cpu, live.cpu()), rtol=1e-5,
        atol=0.0)
    before = pairwise_dist_cuda.launches_cc
    ex = oracle.exact_knn_sparse(corpus, qi, qv, qn, 5, chunk=1024)
    assert pairwise_dist_cuda.launches_cc == before + 3
    ex_cpu = oracle.exact_knn_sparse(cpu, qi.cpu(), qv.cpu(), qn.cpu(), 5,
                                     chunk=1024, device="cpu")
    assert torch.equal(ex.indices.cpu(), ex_cpu.indices)
    torch.testing.assert_close(ex.values.cpu(), ex_cpu.values, rtol=1e-5,
                               atol=0.0)
    cfg = BMOConfig(k=5, delta=0.01, block=1, batch_arms=32,
                    pulls_per_round=8, init_pulls=16, metric="l1",
                    sparse=True)
    res = Index.build(corpus, cfg).query((qi, qv, qn))
    assert [set(r) for r in res.indices.tolist()] == \
        [set(r) for r in ex.indices.tolist()]


FLASH_FP32 = dict(rtol=3e-5, atol=3e-5)
FLASH_BF16_CUDA_CORES = dict(rtol=8e-3, atol=1e-4)


def _tc_close(got, q, k, v, causal=True, off=0):
    """The tensor-core kernel's output within both of its bounds (module
    docstring)."""
    assert bool(torch.isfinite(got).all())
    for name, want, limit in ref.flash_attention_tc_bounds(q, k, v, causal,
                                                           off):
        err = (got.float() - want.float()).abs()
        assert bool((err <= limit).all()), (name, float((err - limit).max()))


def _qkv(gen, B, H, KV, Sq, Sk, D, dtype, scale=(1.0, 1.0)):
    q = torch.randn((B, H, Sq, D), generator=gen, device="cuda") * scale[0]
    k = torch.randn((B, KV, Sk, D), generator=gen, device="cuda") * scale[1]
    v = torch.randn((B, KV, Sk, D), generator=gen, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,D,causal,off", [
    (2, 4, 4, 128, 128, 32, True, 0),      # the reference kernel test's grid
    (1, 2, 2, 64, 256, 16, True, 192),
    (2, 4, 2, 128, 128, 32, True, 0),
    (2, 4, 4, 128, 128, 32, False, 0),
    (1, 1, 1, 64, 64, 128, True, 0),
    (2, 40, 8, 512, 512, 128, True, 0),    # the LM path's heads, shorter
    (1, 3, 1, 100, 100, 64, True, 0),      # ragged tiles
    (1, 2, 1, 77, 200, 24, True, 123),
    (1, 2, 1, 77, 200, 24, False, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(gen, B, H, KV, Sq, Sk, D, causal,
                                              off, dtype):
    q, k, v = _qkv(gen, B, H, KV, Sq, Sk, D, dtype)
    tc = variant(dtype, D, D) == "tensor_cores"
    before = (flash_attention_cuda.launches, flash_attention_cuda.launches_tc)
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches, flash_attention_cuda.launches_tc) \
        == (before[0] + 1, before[1] + tc)
    assert got.dtype == dtype and got.shape == (B, H, Sq, D)
    want = ops.flash_attention(q, k, v, causal=causal, q_offset=off,
                               impl="ref")
    if tc:
        _tc_close(got, q, k, v, causal, off)
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   **(FLASH_FP32 if dtype == torch.float32
                                      else FLASH_BF16_CUDA_CORES))


@pytest.mark.parametrize("B,H,KV,Sq,Sk,causal,off", [
    (1, 40, 8, 512, 512, True, 0),         # the LM path's heads, G = 5
    (1, 40, 8, 512, 512, False, 0),
    (1, 2, 1, 77, 200, True, 123),         # ragged tiles, q at the tail
    (1, 2, 1, 77, 200, False, 0),
    (1, 2, 2, 300, 300, True, 0),          # G = 1, ragged
    (1, 5, 1, 100, 700, True, 600),        # q_offset > 0, Sk > Sq, G = 5
    (1, 5, 1, 100, 700, False, 0),
    (2, 10, 2, 256, 384, True, 128),       # offset on a tile edge
    (1, 5, 5, 129, 129, True, 0),          # one row past a tile
    (1, 1, 1, 1, 1, True, 0),              # one query, one key
])
def test_flash_attention_tensor_core_kernel_matches_plain(
        gen, B, H, KV, Sq, Sk, causal, off):
    """bf16 at head width 128 takes the tensor-core kernel, within both of
    its bounds."""
    q, k, v = _qkv(gen, B, H, KV, Sq, Sk, 128, torch.bfloat16)
    before = (flash_attention_cuda.launches_tc,
              flash_attention_cuda.launches_cc)
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches_tc,
            flash_attention_cuda.launches_cc) == (before[0] + 1, before[1])
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, Sq, 128)
    _tc_close(got, q, k, v, causal, off)


def test_flash_attention_tensor_core_error_against_sdpa(gen):
    """At the LM's heads the kernel's max and RMS errors against the plain
    version are at most twice those of scaled_dot_product_attention on the
    same inputs (the yardstick only: the port never calls it)."""
    q, k, v = _qkv(gen, 2, 40, 8, 512, 512, 128, torch.bfloat16)
    want = ops.flash_attention(q, k, v, impl="ref").float()

    def errors(got):
        err = got.float() - want
        return float(err.abs().max()), float(err.pow(2).mean().sqrt())

    mine = errors(ops.flash_attention(q, k, v))
    lib = errors(torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    assert mine[0] <= 2 * lib[0] and mine[1] <= 2 * lib[1], (mine, lib)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_one_hot_rows(gen, dtype):
    """The LM's init spreads: q entries near 11, k near 25, so scores spread
    over hundreds and the online max jumps between the key tiles; rescale
    factors underflow to 0 and every output stays finite (bf16 takes the
    tensor-core kernel)."""
    q, k, v = _qkv(gen, 1, 40, 8, 512, 512, 128, dtype, scale=(11.0, 25.0))
    got = ops.flash_attention(q, k, v)
    assert bool(torch.isfinite(got).all())
    want = ops.flash_attention(q, k, v, impl="ref")
    if dtype == torch.bfloat16:
        _tc_close(got, q, k, v)
    else:
        torch.testing.assert_close(got, want, **FLASH_FP32)


def test_flash_attention_tensor_core_output_lives_in_bshd_storage(gen):
    """The tensor-core kernel returns the (B, H, Sq, Dv) view of (B, Sq, H,
    Dv) storage, so the model's transpose back and reshape copy nothing."""
    q, k, v = _qkv(gen, 2, 10, 2, 200, 200, 128, torch.bfloat16)
    got = ops.flash_attention(q, k, v)
    assert got.shape == (2, 10, 200, 128)
    assert got.transpose(1, 2).is_contiguous()
    flat = got.transpose(1, 2).reshape(2, 200, -1)
    assert flat.data_ptr() == got.data_ptr()
    _tc_close(got, q, k, v)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_kernel_reads_strided_views(gen, D):
    """(B, S, H, D) projections pass as (B, H, S, D) views, uncopied; the
    result equals the contiguous call's bit for bit (D 128 takes the
    tensor-core kernel)."""
    q, k, v = (torch.randn((2, 256, h, D), generator=gen, device="cuda")
               .to(torch.bfloat16) for h in (8, 2, 2))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    got = ops.flash_attention(*views)
    want = ops.flash_attention(*(t.contiguous() for t in views))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_attention_kernel_rejects_what_it_does_not_take(gen):
    q, k, v = _qkv(gen, 1, 2, 1, 64, 64, 32, torch.float32)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, k, v, q_offset=-1)
    with pytest.raises(ValueError, match="one type"):
        ops.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q[..., :12], k[..., :12], v[..., :12])
    with pytest.raises(ValueError, match="no backward"):
        ops.flash_attention(q.requires_grad_(), k, v)


def test_flash_attention_tc_takes_only_bf16_at_width_128(gen):
    """fp32 at head width 128 and bf16 at 64 take the CUDA-core kernel."""
    for dtype, D in ((torch.float32, 128), (torch.bfloat16, 64)):
        q, k, v = _qkv(gen, 1, 2, 1, 64, 64, D, dtype)
        before = (flash_attention_cuda.launches_tc,
                  flash_attention_cuda.launches_cc)
        got = ops.flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert (flash_attention_cuda.launches_tc,
                flash_attention_cuda.launches_cc) == (before[0], before[1] + 1)
        torch.testing.assert_close(
            got.float(), ops.flash_attention(q, k, v, impl="ref").float(),
            **(FLASH_FP32 if dtype == torch.float32
               else FLASH_BF16_CUDA_CORES))


def test_dense_lm_bf16_takes_the_tensor_core_kernel(gen):
    """qwen2.5-14b SMOKE at its own head width of 128 in bf16: every layer's
    attention goes through the tensor-core kernel, and the loss stays near
    the plain version's (the per-layer bound is held above)."""
    cfg = get_arch("qwen2.5-14b").smoke.scaled(attn_impl="pallas",
                                               head_dim=128)
    model = build_model(cfg, param_dtype=torch.bfloat16, rng=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens, "labels": tokens.roll(-1, dims=1)}
    with torch.inference_mode():
        before = flash_attention_cuda.launches_tc
        loss, _ = lm_loss(model, batch)
        torch.cuda.synchronize()
        assert flash_attention_cuda.launches_tc == before + cfg.n_layers
        plain, _ = lm_loss(model, batch, impl="ref")
    assert abs(float(loss) - float(plain)) <= 1e-2 * abs(float(plain))


def test_dense_lm_on_the_card(gen):
    """qwen2.5-14b SMOKE (head_dim 32) with attn_impl "pallas": one kernel
    launch per layer, and the forward and loss of the plain version."""
    cfg = get_arch("qwen2.5-14b").smoke.scaled(attn_impl="pallas",
                                               head_dim=32)
    model = build_model(cfg, rng=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens, "labels": tokens.roll(-1, dims=1)}
    with torch.inference_mode():
        before = flash_attention_cuda.launches
        got, _ = model(batch, compute_dtype=torch.float32)
        torch.cuda.synchronize()
        assert flash_attention_cuda.launches == before + cfg.n_layers
        want, _ = model(batch, compute_dtype=torch.float32, impl="ref")
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        loss, _ = lm_loss(model, batch)
        plain, _ = lm_loss(model, batch, impl="ref")
    assert abs(float(loss) - float(plain)) <= 1e-3 * abs(float(plain))


@pytest.mark.parametrize("B,H,KV,Sq,Sk,D,causal,off", [
    (1, 96, 8, 256, 256, 192, True, 0),    # nemotron-4-340b's heads, shorter
    (1, 12, 1, 200, 200, 192, False, 0),   # ragged, bidirectional
    (1, 4, 2, 77, 300, 192, True, 223),    # q at the tail of the keys
    (2, 4, 4, 128, 128, 256, True, 0),     # the widest it takes
    (1, 2, 1, 100, 100, 136, True, 0),     # just past the narrow variant
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_wide_head_kernel_matches_plain(gen, B, H, KV, Sq, Sk,
                                                        D, causal, off, dtype):
    """Head widths above 128 take the CUDA-core kernel's wide
    instantiation (up to 256)."""
    q, k, v = _qkv(gen, B, H, KV, Sq, Sk, D, dtype)
    before = (flash_attention_cuda.launches_tc,
              flash_attention_cuda.launches_cc)
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches_tc,
            flash_attention_cuda.launches_cc) == (before[0], before[1] + 1)
    assert got.dtype == dtype and got.shape == (B, H, Sq, D)
    want = ops.flash_attention(q, k, v, causal=causal, q_offset=off,
                               impl="ref")
    torch.testing.assert_close(got.float(), want.float(),
                               **(FLASH_FP32 if dtype == torch.float32
                                  else FLASH_BF16_CUDA_CORES))


def test_flash_attention_rejects_heads_past_256(gen):
    q, k, v = _qkv(gen, 1, 2, 1, 64, 64, 264, torch.float32)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q, k, v)


FAMILY_ARCHS = ["xlstm-350m", "zamba2-2.7b", "qwen2-vl-2b", "whisper-base",
                "granite-34b", "nemotron-4-340b", "llama3-405b"]


def _family_batch(cfg, gen, B=2, S=32):
    """What the family's forward reads, on the card: token ids, embeddings
    with M-RoPE streams for the VLM, frames and S // 8 decoder tokens for
    whisper."""
    if cfg.family == "vlm":
        pos = torch.arange(S, device="cuda")
        return {"embeds": torch.randn((B, S, cfg.d_model), generator=gen,
                                      device="cuda"),
                "positions3": torch.stack([pos // 8, pos % 8 + pos // 8,
                                           pos])[:, None].expand(3, B, S)}
    tokens = torch.randint(0, cfg.vocab_size, (B, S // cfg.dec_seq_div
                                               if cfg.family == "audio"
                                               else S),
                           generator=gen, device="cuda")
    if cfg.family == "audio":
        return {"frames": torch.randn((B, S, cfg.d_model), generator=gen,
                                      device="cuda"), "tokens": tokens}
    return {"tokens": tokens}


def _flash_launches(model) -> int:
    """Fused attention launches of one cache-free forward."""
    cfg = model.cfg
    return {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
            "audio": cfg.enc_layers + cfg.dec_layers}.get(cfg.family,
                                                          cfg.n_layers)


def _prompt_and_step(cfg, batch, n):
    """The first n decoder positions as the prompt, position n as one
    decode step's input."""
    key = "embeds" if cfg.family == "vlm" else "tokens"
    prompt = dict(batch, **{key: batch[key][:, :n]})
    if "positions3" in batch:
        prompt["positions3"] = batch["positions3"][:, :, :n]
    step = batch[key][:, n:n + 1]
    return prompt, ({"embeds": step} if cfg.family == "vlm" else step)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_forward_and_decode_on_the_card(gen, arch):
    """Each family at its SMOKE size in fp32 with attn_impl "pallas": the
    cache-free forward launches the fused op once per attention layer and
    gives the plain version's logits; a prefill and one decode step on the
    card give the same model's on the CPU. The xLSTM is held in aggregate
    (``tests/test_torch_ssm.py``: its steps round their outputs to bf16, so
    sums in another order flip ulps): relative L2 error at most 2e-3."""
    from repro_torch.serve import init_cache
    cfg = get_arch(arch).smoke.scaled(attn_impl="pallas")
    model = build_model(cfg, rng=0)
    cpu = build_model(cfg, device="cpu", rng=0)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    batch = _family_batch(cfg, gen)
    f32 = torch.float32

    def close(got, want):
        got, want = got.float().cpu(), want.float().cpu()
        if cfg.family == "ssm":
            assert float((got - want).norm() / want.norm()) <= 2e-3
        else:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)

    with torch.inference_mode():
        before = flash_attention_cuda.launches
        got, _ = model(batch, compute_dtype=f32)
        torch.cuda.synchronize()
        assert flash_attention_cuda.launches == before + _flash_launches(model)
        want, _ = model(batch, compute_dtype=f32, impl="ref")
        close(got, want)
        n = batch["tokens"].shape[1] - 1 if "tokens" in batch else 24
        outs = []
        for m, dev in ((model, "cuda"), (cpu, "cpu")):
            prompt, step = _prompt_and_step(cfg, batch, n)
            move = lambda t: {k: v.to(dev) for k, v in t.items()} \
                if isinstance(t, dict) else t.to(dev)
            cache = init_cache(m, 2, 32 if cfg.family == "audio" else n + 4,
                               dtype=f32)
            _, cache = m.prefill(move(prompt), cache, compute_dtype=f32)
            logits, cache = m.decode_step(cache, move(step), compute_dtype=f32)
            assert cache["index"] == n + 1
            outs.append(logits)
        close(*outs)


def test_tune_on_the_card_installs_and_round_trips(gen, tmp_path):
    """``Index.tune()`` races real races on the card (its grid varies the
    fused pull's ring of 2 and 4 buffers), installs the winner through the
    epoch fence, and ``save`` → ``load`` applies it again; the tuned index
    still returns the exact top-k."""
    from repro_torch.tune import cache_clear
    corpus, queries, truth = _small_truth(3)
    cfg = BMOConfig(k=3, delta=0.01, block=64, batch_arms=16,
                    pulls_per_round=2, metric="l2", rotate=True)
    idx = Index.build(corpus, cfg)
    cache_clear()
    report = idx.tune(levels=2, max_candidates=4)
    assert report["signature"]["backend"] == "cuda"
    assert {m["cand"]["kernel_buffers"] for m in report["model"]} == {2, 4}
    assert idx.epoch == 1 and idx.tuned is not None
    assert idx.tuned.round_ms > 0 and idx.tuned.epoch_ms > 0
    assert idx.cfg == idx.tuned.bind(cfg)
    res = idx.query(queries, 1)
    assert [set(r) for r in res.indices.tolist()] == truth
    path = str(tmp_path / "idx")
    idx.save(path)
    cache_clear()
    loaded = Index.load(path)
    assert loaded.tuned == idx.tuned and loaded.cfg == idx.cfg
    np.testing.assert_array_equal(loaded.query(queries, 1).indices,
                                  res.indices)


@pytest.mark.parametrize("rotate", [False, True], ids=["dense", "rotated"])
def test_audit_oracle_on_the_card_decides_as_the_plain_version(gen, rotate):
    """``check_topk`` on the card (one ``pairwise_dist`` of a ticket of 8
    rows: split TF32 on the tensor cores) makes the plain version's
    decisions on the same store, with wrong, dead and duplicate ids."""
    from repro_torch.index.store import IndexStore
    from repro_torch.obs import audit
    corpus, queries = make_knn_benchmark_data("dense", 3000, 1100, 8, seed=0)
    cfg = BMOConfig(k=5, delta=0.01, block=128, batch_arms=32, rotate=rotate)
    idx = Index.build(corpus, cfg)
    idx.delete(np.arange(0, 3000, 7))
    store = idx.store
    cpu = IndexStore.from_arrays(
        {k: v.cpu().numpy() for k, v in store.arrays().items()},
        store.meta(), device="cpu")
    ids, _ = audit.exact_topk(cpu, queries, 5)
    served = ids.copy()
    served[1, 1] = served[1, 0]
    served[2, 0] = 7
    served[3, 4] = 2999
    served[4, 2] = -1
    before = pairwise_dist_cuda.launches_tc
    got = audit.check_topk(store, queries, served, 5)
    assert pairwise_dist_cuda.launches_tc == before + 1
    want = audit.check_topk(cpu, queries, served, 5)
    np.testing.assert_array_equal(got.exact_ids, want.exact_ids)
    np.testing.assert_array_equal(got.row_mismatch, want.row_mismatch)
    np.testing.assert_array_equal(got.bad, want.bad)
    assert got.row_mismatch.tolist()[:5] == [False, True, True, True, True]
    # θ: the plain version's ℓ2 contract, 1e-4 relative plus
    # 1e-6·(‖q‖² + ‖x‖²)/d (its norm expansion cancels)
    qs = cpu.prepare_queries(queries).double()
    norms = float((qs ** 2).sum(1).max() + (cpu.x.double() ** 2).sum(1).max())
    np.testing.assert_allclose(got.exact_vals, want.exact_vals, rtol=1e-4,
                               atol=1e-6 * norms / cpu.d)


def test_audited_plane_on_the_card_runs_the_oracle_only_when_idle(gen,
                                                                   monkeypatch):
    from repro_torch.obs import audit
    from repro_torch.serve import PlaneConfig, RequestPlane
    corpus, queries, truth = _small_truth(3)
    cfg = BMOConfig(k=3, delta=0.01, block=64, batch_arms=16, rotate=True)
    idx = Index.build(corpus, cfg)
    plane = RequestPlane(idx, PlaneConfig(audit_rate=1.0))
    seen = []
    real = audit.check_topk

    def watched(*a, **kw):
        seen.append((len(plane._groups),
                     sum(map(len, plane._queues.values()))))
        return real(*a, **kw)

    monkeypatch.setattr(audit, "check_topk", watched)
    tickets = [plane.submit(queries[i:i + 1], rng=i, tenant=f"t{i}",
                            cache="bypass") for i in range(len(queries))]
    plane.drain()
    assert seen == []
    while plane.auditor.pending:
        plane.step()
    assert seen and set(seen) == {(0, 0)}
    assert plane.stats.audit_sampled == len(queries)
    assert plane.stats.audit_mismatches == 0
    assert [set(t.result.indices[0].tolist()) for t in tickets] == truth


def test_knn_lm_engine_on_the_card_retrieves_the_exact_top_k(gen):
    """qwen2.5-14b SMOKE served on the card with the kNN-LM hook and
    appends: every decode step's retrieval launches ``fused_epoch_pull``,
    its ids are the float64 brute force's top-k of that step's hidden rows
    over the rows live at that step (computed on the CPU), the vote uses
    the payload, and the appended rows carry the generated tokens."""
    from repro_torch.serve import KNNLMConfig, ServeEngine
    cfg = get_arch("qwen2.5-14b").smoke
    model = build_model(cfg, param_dtype=torch.bfloat16, rng=0)
    r = np.random.default_rng(0)
    keys = r.normal(size=(512, cfg.d_model)).astype(np.float32)
    ids = r.integers(0, cfg.vocab_size, 512).astype(np.int32)
    knn = KNNLMConfig(lam=0.3, bmo=BMOConfig(k=4, delta=0.05, block=32,
                                             batch_arms=16))
    engine = ServeEngine(model, batch_size=2, max_seq=24, knn_lm=knn,
                         datastore=(keys, ids), index_append=True)
    seen = []
    query = engine.plane.query

    def recorded(hidden, **kw):
        live = engine.index.store.x[engine.index.store.alive].cpu().numpy()
        res = query(hidden, **kw)
        seen.append((hidden.cpu().numpy(), live, res.indices))
        return res
    engine.plane.query = recorded
    prompts = r.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    before = fused_epoch_pull_cuda.launches
    out, ops = engine.generate(prompts, 6)
    assert fused_epoch_pull_cuda.launches > before and ops > 0
    assert len(seen) == 5
    alive = engine.index.store.alive.cpu().numpy()
    for hidden, live, got in seen:
        d = ((hidden[:, None, :].astype(np.float64)
              - live[None].astype(np.float64)) ** 2).sum(-1)
        want = np.argsort(d, 1, kind="stable")[:, :4]
        # before any compaction the live rows are the slots in order
        assert [set(g) for g in got.tolist()] == [set(w) for w in
                                                  want.tolist()]
    new = np.nonzero(alive)[0][512:]
    assert sorted(engine.index.payload[new].tolist()) == sorted(
        out[:, 1:].reshape(-1).tolist())


def test_serving_cli_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.launch import serve
    run = serve.main(["--arch", "qwen2.5-14b", "--smoke", "--batch", "2",
                      "--prompt-len", "8", "--new-tokens", "4", "--knn-lm",
                      "--datastore-size", "256", "--index-dir",
                      str(tmp_path / "idx"), "--index-append",
                      "--audit-rate", "1.0", "--slo", "--health-dump",
                      str(tmp_path / "health.json")])
    assert run["tokens"].shape == (2, 4) and run["retrieval_ops"] > 0
    assert run["audit"]["mismatch_rows"] == 0
    assert (tmp_path / "health.json").exists()


def test_sharded_index_on_the_card_certifies_with_one_sync_an_epoch(gen):
    """A sharded index with both shards on ``cuda:0`` (rotated box, d = 1100
    padded to 2048): the blocking race returns the exact top-k with one
    ``host_fetch`` an epoch, and a session over it crosses to the host once
    an epoch (one ``host_fetch``, one synchronizing CUDA call by torch's
    sync debug mode) and certifies the exact top-k."""
    import warnings
    from repro_torch.index.sharded import sharded_index_knn
    from repro_torch.obs import ObsContext, set_obs
    from repro_torch.utils import hostsync
    corpus, queries = make_knn_benchmark_data("dense", 3000, 1100, 8, seed=0)
    cfg = BMOConfig(k=5, delta=0.01, block=128, batch_arms=32, rotate=True)
    idx = Index.build(corpus, cfg, shards=2, device=["cuda:0"] * 2)
    assert idx.store.stacked_x.shape == (2, 2048, 2048)
    c, q = corpus.astype(np.float64), queries.astype(np.float64)
    dist = (q * q).sum(1)[:, None] + (c * c).sum(1)[None] - 2.0 * q @ c.T
    truth = [set(r) for r in np.argsort(dist, 1, kind="stable")[:, :5]
             .tolist()]
    row_of = np.full(idx.capacity, -1)
    row_of[idx.build_gids] = np.arange(len(corpus))

    ctx = ObsContext("t", enabled=True)
    old = set_obs(ctx)
    try:
        before = fused_epoch_pull_cuda.launches
        hostsync.reset_syncs()
        res = sharded_index_knn(idx.store, queries, 0)
        syncs = hostsync.syncs()
    finally:
        set_obs(old)
    epochs = ctx.registry.histogram(
        "repro_race_epoch_ms", "wall time of one race epoch (ms)",
        kind="sharded_fused_blocking").count
    assert epochs > 0 and syncs == epochs
    assert fused_epoch_pull_cuda.launches - before >= 2 + epochs
    assert [set(r) for r in row_of[res.indices.cpu().numpy()].tolist()] \
        == truth

    sess = idx.race(queries, 0)
    per_epoch = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        while True:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                before = hostsync.syncs()
                going = sess.step()
            per_epoch.append((hostsync.syncs() - before, sum(
                "synchroniz" in str(w.message) for w in caught)))
            if not going:
                break
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert per_epoch == [(1, 1)] * len(per_epoch)
    snap = sess.snapshot
    assert snap.done.all() and (snap.acc_count == 5).all()
    assert [set(r) for r in row_of[snap.ids].tolist()] == truth


def test_kmeans_on_the_card(gen):
    """BMO k-means on the card: the assignment races on ``block_pull``,
    the exact assignment runs on ``pairwise_dist``; the final assignment
    agrees with ``assign_exact`` to the final centroids on ≥ 99% of the
    points, at fewer coordinate reads than exact Lloyd."""
    from repro_torch.core import kmeans
    from repro_torch.data.synthetic import clustered_dense
    pts = clustered_dense(256, 2048, n_clusters=8, noise=0.1, seed=3,
                          device="cuda")
    cfg = BMOConfig(k=1, delta=0.01, block=64, batch_arms=8,
                    pulls_per_round=1, init_pulls=1)
    b0, p0 = block_pull_cuda.launches, pairwise_dist_cuda.launches
    res = kmeans.kmeans(pts, 8, 2, cfg, 0)
    assert block_pull_cuda.launches > b0
    exact, _ = kmeans.assign_exact(pts, res.centroids)
    assert pairwise_dist_cuda.launches > p0
    assert float((res.assignment == exact).float().mean()) >= 0.99
    assert torch.isfinite(res.centroids).all()
    assert 0 < float(res.coord_ops) < float(res.exact_ops)


def _fleet_on_card(tmp_path, max_resident=1):
    from repro_torch.fleet import Fleet, FleetConfig
    cfg = BMOConfig(k=5, delta=0.01, block=128, batch_arms=32, rotate=True)
    fleet = Fleet(str(tmp_path / "fleet"),
                  FleetConfig(max_resident=max_resident))
    data = [make_knn_benchmark_data("dense", 2048, 512, 4, seed=40 + i,
                                    device="cuda") for i in range(2)]
    fleet.create("a", data[0][0], cfg, 1)
    fleet.create("s", data[1][0], cfg, 2, shards=2)
    return fleet, [q for _, q in data]


def test_fleet_evict_reload_bit_identical_on_the_card(gen, tmp_path):
    """A namespace queried, evicted and queried again on the card with the
    same seed returns the same ids and values, a sharded one (S = 2, on
    one card or on two) included, through the fused pull and the fwht."""
    fleet, (qa, qs) = _fleet_on_card(tmp_path)
    plane = fleet.serve()
    f0, w0 = fused_epoch_pull_cuda.launches, fwht_cuda.launches
    for name, q in (("a", qa), ("s", qs)):
        before = plane.query(q, rng=7, namespace=name, cache="bypass")
        assert fleet.peek(name) is not None and fleet.evict(name)
        after = plane.query(q, rng=7, namespace=name, cache="bypass")
        np.testing.assert_array_equal(before.indices, after.indices)
        np.testing.assert_array_equal(before.values, after.values)
        assert before.reason == "certified"
    one_card = torch.cuda.device_count() < 2
    assert fleet.get("s").store.devices == [
        torch.device("cuda", 0), torch.device("cuda", 0 if one_card else 1)]
    assert fleet.reload_count >= 2
    assert fused_epoch_pull_cuda.launches > f0 and fwht_cuda.launches > w0


def test_fleet_eviction_releases_device_memory(gen, tmp_path):
    """After an eviction no tensor of the evicted store stays allocated:
    not in the plane, its auditor, the shared cache or the fleet."""
    from repro_torch.serve.plane import PlaneConfig
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    fleet, (qa, qs) = _fleet_on_card(tmp_path, max_resident=2)
    plane = fleet.serve(PlaneConfig(audit_rate=1.0))
    plane.query(qa, rng=1, namespace="a")
    plane.query(qs, rng=2, namespace="s")
    plane.audit_flush()
    del qa, qs
    one = sum(t.numel() * t.element_size() for t in
              fleet.peek("a").store.arrays().values() if t is not None)
    held = torch.cuda.memory_allocated() - base
    assert held >= one
    assert fleet.evict("a") and fleet.evict("s")
    gc.collect()
    assert torch.cuda.memory_allocated() - base <= 0.1 * one


def test_engine_on_a_fleet_plane_releases_an_evicted_namespace(gen,
                                                              tmp_path):
    """A kNN-LM engine serving a fleet's namespace on the card pins no
    handle: evicting the namespace frees its store's device memory, and
    the next decode step reloads it."""
    from repro_torch.fleet import Fleet, FleetConfig
    from repro_torch.serve import KNNLMConfig, ServeEngine
    cfg = get_arch("qwen2.5-14b").smoke
    model = build_model(cfg, param_dtype=torch.bfloat16, rng=0)
    r = np.random.default_rng(0)
    keys = r.normal(size=(16384, cfg.d_model)).astype(np.float32)
    ids = r.integers(0, cfg.vocab_size, 16384).astype(np.int32)
    knn = KNNLMConfig(lam=0.3, bmo=BMOConfig(k=4, delta=0.05, block=32,
                                             batch_arms=16))
    fleet = Fleet(str(tmp_path / "fleet"), FleetConfig(max_resident=2))
    fleet.create("ds", keys, knn.bmo, 7, payload=ids)
    engine = ServeEngine(model, batch_size=2, max_seq=24, knn_lm=knn,
                         plane=fleet.serve(), plane_namespace="ds")
    prompts = r.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    engine.generate(prompts, 3)
    one = sum(t.numel() * t.element_size() for t in
              fleet.peek("ds").store.arrays().values() if t is not None)
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    assert fleet.evict("ds")
    gc.collect()
    assert torch.cuda.memory_allocated() <= held - 0.9 * one
    before = fused_epoch_pull_cuda.launches
    out, ops = engine.generate(prompts, 3)
    assert fleet.reload_count == 1 and ops > 0
    assert fused_epoch_pull_cuda.launches > before


def test_fleet_rebalance_moves_a_sharded_window_across_cards(gen, tmp_path):
    """With four cards and no device given, each S = 2 namespace spans two
    cards of its own; ``rebalance`` moves the one whose window moved onto
    its new cards through the epoch fence, with the same answers, and a
    reload places it there again."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    from repro_torch.fleet import Fleet, FleetConfig
    cfg = BMOConfig(k=5, delta=0.01, block=128, batch_arms=32, rotate=True)
    fleet = Fleet(str(tmp_path / "fleet"), FleetConfig(max_resident=2))
    data = {name: make_knn_benchmark_data("dense", 2048 + 256 * i, 512, 4,
                                          seed=50 + i, device="cuda")
            for i, name in enumerate("ab")}
    for i, (name, (corpus, _)) in enumerate(data.items()):
        fleet.create(name, corpus, cfg, i, shards=2)
        assert fleet.peek(name).store.devices == [
            torch.device("cuda", 0), torch.device("cuda", 1)]
    plane = fleet.serve()
    before = {n: plane.query(q, rng=3, namespace=n, cache="bypass")
              for n, (_, q) in data.items()}
    epochs = {n: fleet.peek(n).epoch for n in data}
    plan = fleet.rebalance()
    assert plan == {"b": 0, "a": 2}         # the heavier one stays put
    moved = "a"
    store = fleet.peek(moved).store
    assert store.device_offset == 2
    assert fleet.peek(moved).epoch == epochs[moved] + 1     # fenced
    assert fleet.peek("b").epoch == epochs["b"]
    assert store.devices == [torch.device("cuda", 2), torch.device("cuda", 3)]
    for n, (_, q) in data.items():
        got = plane.query(q, rng=3, namespace=n, cache="bypass")
        np.testing.assert_array_equal(got.indices, before[n].indices)
        np.testing.assert_allclose(got.values, before[n].values, rtol=1e-6)
    assert fleet.evict(moved)
    again = fleet.get(moved).store
    assert again.device_offset == 2
    assert again.devices == [torch.device("cuda", 2), torch.device("cuda", 3)]


def _smoke_train(device: str, state_from=None):
    """qwen2.5-14b SMOKE, AdamW at fp32 parameters and compute, grad
    accumulation 2, from ``state_from``'s parameters (the CPU's draw) with
    v at 0.01 (a step linear in the gradient): (state, metrics) after one
    step of 8 × 64 tokens."""
    import dataclasses
    from repro_torch.configs import TrainConfig
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.train.steps import init_train_state, make_train_step
    entry = get_arch("qwen2.5-14b")
    plan = dataclasses.replace(entry.plan, fsdp=False, tp=False, sp=False,
                               grad_accum=2, compute_dtype="float32")
    tcfg = TrainConfig(lr=1e-3, warmup_steps=0, total_steps=4)
    model = build_model(entry.smoke, device=device, rng=0)
    state = init_train_state(model, plan, tcfg, 0)
    with torch.no_grad():
        if state_from is not None:
            for n, p in state["params"].items():
                p.copy_(state_from[n])
        for v in state["opt"]["v"].values():
            v.fill_(0.01)
    start = {n: p.detach().clone() for n, p in state["params"].items()}
    batch = ShardedLoader(entry.smoke.vocab_size, 8, 64, seed=0,
                          device=device).get(0)
    state, metrics = make_train_step(model, plan, tcfg)(state, batch)
    return state, metrics, start


def test_train_step_on_the_card_matches_the_cpu(gen):
    """One SMOKE step from the same parameters: loss and lr at 1e-5
    relative, grad_norm at 1e-4 (its sum of squares runs in another order
    on each side), every parameter and AdamW leaf within 1e-4 of its
    largest entry (TF32 off: the card's fp32 matmuls are fp32)."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want, wmet, start = _smoke_train("cpu")
        got, gmet, _ = _smoke_train("cuda", start)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-4), ("lr", 1e-7)):
        np.testing.assert_allclose(float(gmet[k]), float(wmet[k]),
                                   rtol=rtol)
    pairs = [(got["params"][n], want["params"][n]) for n in want["params"]]
    pairs += [(got["opt"][k][n], want["opt"][k][n]) for k in ("m", "v")
              for n in want["opt"][k]]
    for g, w in pairs:
        w = w.detach().float()
        np.testing.assert_allclose(g.detach().float().cpu().numpy(),
                                   w.numpy(), rtol=0.0,
                                   atol=1e-4 * float(w.abs().max()))


def test_supervisor_restart_is_bit_identical_on_the_card(gen, tmp_path):
    """The training CLI at ``--smoke`` on the card, uninterrupted and with
    a failure at step 5 after the step-2 checkpoint, in a process of its
    own that sets ``CUBLAS_WORKSPACE_CONFIG`` before any CUDA work and runs
    under ``torch.use_deterministic_algorithms(True)``: the final
    checkpoints hold the same bits."""
    import json
    import os
    import subprocess
    import sys
    from repro_torch.checkpoint import load_arrays
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = ["--arch", "qwen2.5-14b", "--smoke", "--steps", "8", "--batch",
            "4", "--seq", "64", "--ckpt-every", "3", "--log-every", "100"]
    code = (
        "import json, torch\n"
        "torch.use_deterministic_algorithms(True)\n"
        "from repro_torch.launch import train\n"
        f"a = train.main({args!r} + ['--ckpt-dir', {str(tmp_path / 'a')!r}])\n"
        f"b = train.main({args!r} + ['--ckpt-dir', {str(tmp_path / 'b')!r}, "
        "'--fail-at', '5'])\n"
        "print(json.dumps([a, b]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=root, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    clean, faulty = json.loads(run.stdout.strip().splitlines()[-1])
    assert clean["loss"] == faulty["loss"] and clean["step"] == 8
    a = load_arrays(str(tmp_path / "a" / "step_00000007"))
    b = load_arrays(str(tmp_path / "b" / "step_00000007"))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# the multi-device plans: two ranks on cuda:0, joined by gloo
# ---------------------------------------------------------------------------

def test_plans_tp_serving_on_the_card(gen, monkeypatch):
    """qwen2.5-14b SMOKE served under its plan (tp) by two ranks on cuda:0,
    fp32 compute and cache, against one rank on the card: logits at 1e-4."""
    import test_torch_plan_ranks as ranks
    from repro_torch import dist as rdist
    import repro_torch.serve.steps as steps
    monkeypatch.setattr(steps, "COMPUTE_DTYPE", torch.float32)
    tokens = np.random.default_rng(2).integers(0, 256, (2, 12))
    got = rdist.spawn(ranks.serve_tp_rank, 2, ("qwen2.5-14b", tokens, 8,
                                               "float32"), device="cuda",
                      timeout=600)
    want = ranks.serve_logits("qwen2.5-14b", tokens, 8, device="cuda")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_plans_pipeline_and_compression_on_the_card(gen):
    """The GPipe schedule over two stage ranks on cuda:0 (its send/recv
    staged through host memory) against sequential application, and
    ``compressed_psum`` over two ranks bit for bit."""
    import test_torch_plan_ranks as ranks
    from repro_torch import dist as rdist
    r = np.random.default_rng(5)
    W = (r.normal(size=(4, 16, 16)) * 0.2).astype(np.float32)
    x = r.normal(size=(3, 4, 16)).astype(np.float32)
    y, g = rdist.spawn(ranks.pipeline_rank, 2, (W, x, 2), device="cuda",
                       timeout=600)
    Wt = torch.from_numpy(W).requires_grad_(True)
    want = torch.stack([_tanh_layers(Wt, xm) for xm in torch.from_numpy(x)])
    torch.sum(want ** 2).backward()
    torch.testing.assert_close(y, want.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g, Wt.grad, rtol=1e-4, atol=1e-5)
    gr = r.normal(size=(2, 4096)).astype(np.float32)
    er = (r.normal(size=(2, 4096)) * 1e-2).astype(np.float32)
    assert rdist.spawn(ranks.compressed, 2, (gr, er), device="cuda",
                       timeout=600) == [(True, True)] * 2


def _tanh_layers(W, x):
    for w in W:
        x = torch.tanh(x @ w)
    return x
