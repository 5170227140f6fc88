"""The round-fused BMO racing pull on the card: wrapper around the CUDA
kernel in ``csrc/fused_epoch_pull.cu`` (the port of the TPU kernel
``repro/kernels/fused_race.py``; see the source for its design).

One launch pulls T = R·P sampled corpus blocks for each of the Q·B selected
(query, arm) pairs and reduces them on-chip to per-arm Welford (mean, M2).
The plain version is ``ref.fused_epoch_pull_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pull_schedule import (arm_operand, fused_schedule,
                                               shares_arms)

N_BUF = 2  # default pulls in flight per arm (the reference's VMEM slots)
BLOCKS = (32, 64, 128, 256)
METRICS = {"l2": 0, "l1": 1}


_ENTRY = _build.Entry("fused_epoch_pull", "fused_epoch_pull_f32",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 6
                      + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def fused_epoch_pull_cuda(x: torch.Tensor, qs: torch.Tensor,
                          arm_idx: torch.Tensor, blk_idx: torch.Tensor, *,
                          block: int, metric: str = "l2",
                          n_buf: int = N_BUF,
                          _schedule: Optional[str] = None) -> torch.Tensor:
    """x (n, d_pad) fp32; qs (Q, d_pad) fp32; arm_idx (Q, B) int; blk_idx
    (Q, B, T) int, all on one CUDA device. Returns (Q, B, 2) fp32 per-arm
    (mean, M2) of the T pulled block distances. A negative arm id gives
    (0, 0) without reading; an out-of-range arm or block id gives NaN.
    ``n_buf`` is the pair schedule's streaming depth: the pulls of each arm
    in flight. The schedule follows from the operands
    (``pull_schedule.fused_schedule``); ``_schedule`` forces one, for the
    tests."""
    n, d_pad = x.shape
    Q, B, T = blk_idx.shape
    if not (x.is_cuda and qs.device == x.device and arm_idx.device == x.device
            and blk_idx.device == x.device):
        raise ValueError("fused_epoch_pull_cuda needs every operand on one "
                         "CUDA device")
    if x.dtype != torch.float32 or qs.dtype != torch.float32:
        raise ValueError(f"fused_epoch_pull_cuda takes fp32 corpus and "
                         f"queries, got {x.dtype} and {qs.dtype}")
    if block not in BLOCKS or d_pad % block:
        raise ValueError(f"block={block} with d_pad={d_pad}: the kernel takes "
                         f"a block in {BLOCKS} that divides d_pad")
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if n_buf < 2:
        raise ValueError(f"need at least 2 streaming slots, got {n_buf}")
    if qs.shape != (Q, d_pad) or arm_idx.shape != (Q, B):
        raise ValueError(f"shapes x {tuple(x.shape)}, qs {tuple(qs.shape)}, "
                         f"arm {tuple(arm_idx.shape)}, blk {tuple(blk_idx.shape)}"
                         " do not agree")
    sched = fused_schedule(Q, B, T, d_pad, block, n_buf,
                           shares_arms(arm_idx), _schedule)
    # a pair block serves one query; a rows block one arm
    grid = Q if sched.name == "pair" else B
    if T < 1 or grid >= 2 ** 31:
        raise ValueError(f"T={T}, Q={Q}, B={B} outside the kernel's grid")
    x = x.contiguous()
    qs = qs.contiguous()
    arm, arm_stride = arm_operand(arm_idx)
    blk = blk_idx.to(torch.int32).contiguous()
    if x.data_ptr() % 16 or qs.data_ptr() % 16:
        raise ValueError("fused_epoch_pull_cuda needs 16-byte aligned rows")
    out = torch.empty((Q, B, 2), dtype=torch.float32, device=x.device)
    if Q * B == 0:
        return out
    code = 2 if sched.name == "rows" else 0 if sched.stage_query else 1
    _build.launch(_ENTRY, x.get_device(), "fused_epoch_pull",
                  x.data_ptr(), qs.data_ptr(), arm.data_ptr(), blk.data_ptr(),
                  out.data_ptr(), n, d_pad, Q, B, T, arm_stride, block,
                  METRICS[metric], n_buf, code, sched.warps)
    fused_epoch_pull_cuda.launches += 1
    if sched.name == "rows":
        fused_epoch_pull_cuda.launches_rows += 1
    else:
        fused_epoch_pull_cuda.launches_pair += 1
    return out


# launches in all, and of each schedule
fused_epoch_pull_cuda.launches = 0
fused_epoch_pull_cuda.launches_rows = 0
fused_epoch_pull_cuda.launches_pair = 0
