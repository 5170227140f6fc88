"""The pull wrappers' schedule choice (``kernels/pull_schedule.py``), which
reads only shapes, strides and types and so runs here on the CPU: an
expanded arm tensor takes the rows schedule at a wide init's proportions,
a general one the pair schedule, a row too wide for shared memory never
the row-staging forms, and the expanded tensor is never copied out to
(Q, B). The kernels themselves are held to their plain versions in
``test_torch_cuda.py``."""
import pytest
import torch

from repro_torch.kernels import pull_schedule as ps
from repro_torch.kernels.fused_race import N_BUF, fused_epoch_pull_cuda

# the main path's shapes: the wide init over a 131,072-row capacity and an
# epoch of 32 arms × 128 pulls, d_pad 16,384, block 128
Q, CAP, D_PAD, BLOCK = 1024, 131072, 16384, 128


def _expanded(Q, B, dtype=torch.int32):
    return torch.arange(B, dtype=dtype)[None].expand(Q, B)


def test_expanded_arms_take_the_rows_schedule():
    arms = _expanded(Q, CAP)
    assert ps.shares_arms(arms)
    fused = ps.fused_schedule(Q, CAP, 2, D_PAD, BLOCK, N_BUF,
                              ps.shares_arms(arms))
    assert fused == ps.Schedule("rows", smem=D_PAD * 4)   # one row a block
    assert fused.smem <= ps.SMEM_BYTES
    for itemsize in (4, 2):                       # fp32 and bf16 corpora
        multi = ps.block_pull_schedule(Q, CAP, 2, D_PAD, BLOCK, itemsize,
                                       True)
        assert multi == ps.Schedule("rows", smem=D_PAD * itemsize)


@pytest.mark.parametrize("make", [
    lambda: torch.randint(0, CAP, (Q, 32), dtype=torch.int32),
    lambda: _expanded(Q, 32).contiguous(),
    lambda: torch.randint(0, CAP, (32, Q), dtype=torch.int32).T],
    ids=["random", "materialised", "transposed"])
def test_general_arms_take_the_pair_schedule(make):
    arms = make()
    assert not ps.shares_arms(arms)
    fused = ps.fused_schedule(Q, 32, 128, D_PAD, BLOCK, N_BUF,
                              ps.shares_arms(arms))
    assert fused == ps.Schedule("pair", warps=8, stage_query=True,
                                smem=ps.pair_smem(True, D_PAD, BLOCK, 8,
                                                  N_BUF))
    assert ps.block_pull_schedule(Q, 32, 2, D_PAD, BLOCK, 4, False) == \
        ps.Schedule("pair")


def test_shared_arms_with_few_pulls_take_the_pair_schedule():
    """Staging a row pays only where the queries pull at least a row's
    worth of it: Q·T·block ≥ d_pad. One query's arms go pair-wise."""
    assert ps.fused_schedule(1, CAP, 2, D_PAD, BLOCK, N_BUF, True).name == \
        "pair"
    assert ps.block_pull_schedule(63, CAP, 2, D_PAD, BLOCK, 4, True).name \
        == "pair"
    assert ps.block_pull_schedule(64, CAP, 2, D_PAD, BLOCK, 4, True).name \
        == "rows"
    assert ps.shares_arms(torch.zeros((1, 5), dtype=torch.int32))


@pytest.mark.parametrize("d_pad", [65536, 131072])
def test_wide_rows_take_no_row_staging_form(d_pad):
    """A row above shared memory's 227 KB neither takes the rows schedule
    nor stages the query row in the pair schedule, which then reads the
    query slices from device memory."""
    assert d_pad * 4 > ps.SMEM_BYTES
    got = ps.fused_schedule(Q, CAP, 2, d_pad, BLOCK, N_BUF, True)
    assert got.name == "pair" and not got.stage_query
    assert got.smem == ps.pair_smem(False, d_pad, BLOCK, got.warps, N_BUF) \
        <= ps.SMEM_BYTES
    assert ps.block_pull_schedule(Q, CAP, 2, d_pad, BLOCK, 4, True).name \
        == "pair"
    with pytest.raises(ValueError, match="rows schedule"):
        ps.fused_schedule(Q, CAP, 2, d_pad, BLOCK, N_BUF, True, force="rows")


def test_pair_schedule_shrinks_to_fit_its_ring():
    """n_buf deepens each arm's ring; where the query row and the ring no
    longer fit together the row is not staged, then the block takes fewer
    warps, and a ring that fits no warp is refused."""
    staged = ps.fused_schedule(Q, 32, 128, D_PAD, BLOCK, 8, False)
    assert staged.stage_query and staged.warps == 8
    deep = ps.fused_schedule(Q, 32, 128, D_PAD, 256, 12, False)
    assert not deep.stage_query and 1 <= deep.warps < 8
    assert deep.smem <= ps.SMEM_BYTES
    with pytest.raises(ValueError, match="do not fit"):
        ps.fused_schedule(Q, 32, 128, D_PAD, 256, 64, False)


def test_pair_schedule_takes_warps_for_its_arms():
    assert ps.fused_schedule(Q, 5, 8, D_PAD, BLOCK, N_BUF, False).warps == 2
    assert ps.fused_schedule(Q, 4, 8, D_PAD, BLOCK, N_BUF, False).warps == 1
    assert ps.fused_schedule(Q, 500, 8, D_PAD, BLOCK, N_BUF,
                             False).warps == ps.PAIR_WARPS


def test_forcing_a_schedule():
    arms = _expanded(4, 8)
    assert ps.fused_schedule(4, 8, 2, 256, 32, N_BUF, True,
                             force="rows").name == "rows"
    assert ps.fused_schedule(Q, CAP, 2, D_PAD, BLOCK, N_BUF, True,
                             force="pair").name == "pair"
    with pytest.raises(ValueError, match="rows schedule"):
        ps.block_pull_schedule(4, 8, 2, 256, 32, 4, False, force="rows")
    with pytest.raises(ValueError, match="unknown schedule"):
        ps.block_pull_schedule(4, 8, 2, 256, 32, 4, True, force="tiles")
    assert ps.shares_arms(arms)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_expanded_arms_are_never_copied_out(dtype):
    """The kernels get a shared vector as its one (B,) row with stride 0:
    an int32 one is the expanded tensor's own storage, an int64 one a
    converted copy of the row alone."""
    arms = _expanded(Q, CAP, dtype)
    got, stride = ps.arm_operand(arms)
    assert stride == 0 and got.shape == (CAP,) and got.dtype == torch.int32
    assert got.untyped_storage().nbytes() == CAP * 4
    if dtype == torch.int32:
        assert got.data_ptr() == arms.data_ptr()
    # the pair kernel of block_pull_multi reads int64 ids as they are
    got, stride = ps.arm_operand(arms, (torch.int32, torch.int64))
    assert stride == 0 and got.data_ptr() == arms.data_ptr()


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_one_querys_arm_vector_goes_as_it_is(dtype):
    """block_pull's (B,) arm vector: its own storage with stride 0, where
    its type is one the kernel reads."""
    arms = torch.arange(7, dtype=dtype)
    got, stride = ps.arm_operand(arms, (torch.int32, torch.int64))
    assert stride == 0 and got.data_ptr() == arms.data_ptr()
    got, stride = ps.arm_operand(arms)
    assert stride == 0 and got.dtype == torch.int32
    assert torch.equal(got.long(), arms.long())
    if dtype == torch.int32:
        assert got.data_ptr() == arms.data_ptr()


def test_general_arms_go_as_one_contiguous_tensor():
    arms = torch.randint(0, 100, (8, 32), dtype=torch.int64)
    got, stride = ps.arm_operand(arms)
    assert stride == 32 and got.dtype == torch.int32 and got.is_contiguous()
    assert torch.equal(got.long(), arms)
    view = arms.T.contiguous().T                  # strides (1, 8)
    got, stride = ps.arm_operand(view, (torch.int64,))
    assert stride == 32 and got.is_contiguous() and torch.equal(got, arms)


def test_pair_smem_counts_every_region():
    """The epoch's block: the 64 KB query row, 8 warps × 2 slots × 4 arms ×
    512 B of ring, 32 arms' tables of 128 values and bitmaps of 4 words,
    64 slot ids and 17 barriers."""
    assert ps.pair_smem(True, D_PAD, BLOCK, 8, 2) == (
        65536 + 32768 + 32 * 128 * 4 + 32 * 4 * 4 + 64 * 4 + 17 * 8)
    # unstaged: the same ring, the query slices read from device memory
    assert ps.pair_smem(False, D_PAD, BLOCK, 8, 2) == \
        ps.pair_smem(True, D_PAD, BLOCK, 8, 2) - 65536


def test_the_wrapper_raises_on_cpu_tensors():
    x = torch.zeros((4, 256))
    with pytest.raises(ValueError, match="CUDA"):
        fused_epoch_pull_cuda(x, x[:1], _expanded(1, 4),
                              torch.zeros((1, 4, 2), dtype=torch.int32),
                              block=128)
