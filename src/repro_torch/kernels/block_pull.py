"""The BMO Monte-Carlo pull on the card, for one query or a batch: wrappers
around the CUDA kernel in ``csrc/block_pull.cu`` (the port of the TPU
kernels ``repro/kernels/block_pull.py``; see the source for its design).

``block_pull_multi_cuda`` serves the per-round driver (one launch per
round, every active query's frontier at once, and its wide init);
``block_pull_cuda`` serves the paper's per-query Algorithm 2 path. Both go
through the same C entry point, one kernel a call, and keep their own
launch counters. The plain versions are
``ref.block_pull_multi_ref`` and ``ref.block_pull_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_race import BLOCKS, METRICS
from repro_torch.kernels.pull_schedule import (arm_operand,
                                               block_pull_schedule,
                                               shares_arms)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the id types the kernel reads as they are; others are converted to int32
IDS = {torch.int32: 0, torch.int64: 1}
#: the arm types each schedule reads as they are
_ARM_TYPES = {False: tuple(IDS), True: (torch.int32,)}

_ENTRY = _build.Entry("block_pull", "block_pull_multi",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 6
                      + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _launch(x, qs, arm_idx, blk_idx, out_shape, Q: int, B: int, P: int, *,
            block: int, metric: str, name: str,
            rows: bool = False) -> torch.Tensor:
    """Checks what the kernel takes, from the tensors' attributes alone (a
    message is built only to raise), and launches it into a new
    ``out_shape`` fp32 tensor, (Q, B, P) or, for one query, (B, P): on the
    rows schedule when ``rows``, else on the pair schedule. int32 and int64
    ids go in as they are (the rows schedule takes its arm vector as
    int32); an arm tensor shared by every query goes as its one (B,) row
    (``pull_schedule.arm_operand``)."""
    index = x.get_device()                   # -1 on the CPU
    if index < 0 or qs.get_device() != index \
            or arm_idx.get_device() != index or blk_idx.get_device() != index:
        raise ValueError(f"{name} needs every operand on one CUDA device")
    dtype = DTYPES.get(x.dtype)
    if dtype is None or qs.dtype != x.dtype:
        raise ValueError(f"{name} takes a corpus and queries of one type, "
                         f"fp32 or bf16; got {x.dtype} and {qs.dtype}")
    n, d_pad = x.shape
    if block not in BLOCKS or d_pad % block:
        raise ValueError(f"block={block} with d_pad={d_pad}: the kernel takes "
                         f"a block in {BLOCKS} that divides d_pad")
    code = METRICS.get(metric)
    if code is None:
        raise ValueError(f"unknown metric {metric!r}")
    # multi: qs (Q, d_pad), arm (Q, B); single: q (d_pad,), arm (B,)
    if qs.shape != out_shape[:-2] + (d_pad,) \
            or arm_idx.shape != out_shape[:-1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, qs {tuple(qs.shape)}, "
                         f"arm {tuple(arm_idx.shape)}, blk {tuple(blk_idx.shape)}"
                         " do not agree")
    if (B if rows else (Q * B * P + 7) // 8) >= 2 ** 31:
        raise ValueError(f"Q·B·P={Q * B * P} pulls exceed the kernel's grid")
    x = x.contiguous()
    qs = qs.contiguous()
    arm, arm_stride = arm_operand(arm_idx, _ARM_TYPES[rows])
    if blk_idx.dtype not in IDS:
        blk_idx = blk_idx.to(torch.int32)
    blk = blk_idx.contiguous()
    xp, qp = x.data_ptr(), qs.data_ptr()
    if (xp | qp) % 16:
        raise ValueError(f"{name} needs 16-byte aligned rows")
    out = x.new_empty(out_shape, dtype=torch.float32)
    if Q * B * P:
        _build.launch(_ENTRY, index, name, xp, qp,
                      arm.data_ptr(), blk.data_ptr(), out.data_ptr(), n,
                      d_pad, Q, B, P, arm_stride, block, code, dtype,
                      IDS[arm.dtype], IDS[blk.dtype], int(rows))
    return out


def block_pull_multi_cuda(x: torch.Tensor, qs: torch.Tensor,
                          arm_idx: torch.Tensor, blk_idx: torch.Tensor, *,
                          block: int, metric: str = "l2",
                          _schedule: Optional[str] = None) -> torch.Tensor:
    """x (n, d_pad) and qs (Q, d_pad), both fp32 or both bf16; arm_idx
    (Q, B) and blk_idx (Q, B, P) int (int32 and int64 are read as they are,
    other types converted); all on one CUDA device. Returns
    (Q, B, P) fp32 block-mean distances. A negative arm id gives 0 without
    reading; an out-of-range arm or block id gives NaN. The schedule follows
    from the operands (``pull_schedule.block_pull_schedule``: only an arm
    tensor shared by every query can take the rows schedule, so a general
    one goes straight to the pair schedule); ``_schedule`` forces one, for
    the tests."""
    if blk_idx.dim() != 3 or arm_idx.dim() != 2:
        raise ValueError(f"block_pull_multi_cuda takes arm (Q, B) and blk "
                         f"(Q, B, P); got {tuple(arm_idx.shape)}, "
                         f"{tuple(blk_idx.shape)}")
    Q, B, P = blk_idx.shape
    shared = shares_arms(arm_idx)
    rows = (_schedule is not None or shared) and block_pull_schedule(
        Q, B, P, x.shape[-1], block, x.element_size(), shared,
        _schedule).name == "rows"
    out = _launch(x, qs, arm_idx, blk_idx, (Q, B, P), Q, B, P, block=block,
                  metric=metric, name="block_pull_multi_cuda", rows=rows)
    if Q * B * P:
        block_pull_multi_cuda.launches += 1
        if rows:
            block_pull_multi_cuda.launches_rows += 1
        else:
            block_pull_multi_cuda.launches_pair += 1
    return out


def block_pull_cuda(x: torch.Tensor, q: torch.Tensor, arm_idx: torch.Tensor,
                    blk_idx: torch.Tensor, *, block: int,
                    metric: str = "l2") -> torch.Tensor:
    """The single-query pull: q (d_pad,), arm_idx (B,), blk_idx (B, P) →
    (B, P) fp32; otherwise as ``block_pull_multi_cuda``, on the pair
    schedule."""
    if q.dim() != 1 or arm_idx.dim() != 1 or blk_idx.dim() != 2:
        raise ValueError(f"block_pull_cuda takes q (d_pad,), arm (B,) and "
                         f"blk (B, P); got {tuple(q.shape)}, "
                         f"{tuple(arm_idx.shape)}, {tuple(blk_idx.shape)}")
    B, P = blk_idx.shape
    out = _launch(x, q, arm_idx, blk_idx, (B, P), 1, B, P, block=block,
                  metric=metric, name="block_pull_cuda")
    if B * P:
        block_pull_cuda.launches += 1
    return out


# launches in all and, for the batched pull, of each schedule
block_pull_multi_cuda.launches = 0
block_pull_multi_cuda.launches_rows = 0
block_pull_multi_cuda.launches_pair = 0
block_pull_cuda.launches = 0
