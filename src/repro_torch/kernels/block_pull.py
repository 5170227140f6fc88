"""The BMO Monte-Carlo pull on the card, for one query or a batch: wrappers
around the CUDA kernel in ``csrc/block_pull.cu`` (the port of the TPU
kernels ``repro/kernels/block_pull.py``; see the source for its design).

``block_pull_multi_cuda`` serves the per-round driver (one launch per
round, every active query's frontier at once); ``block_pull_cuda`` serves
the paper's per-query Algorithm 2 path. Both launch the same kernel and
keep their own launch counters. The plain versions are
``ref.block_pull_multi_ref`` and ``ref.block_pull_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_race import BLOCKS, METRICS

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _entry():
    fn = _build.library("block_pull").block_pull_multi
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(x, qs, arm_idx, blk_idx, *, block: int, metric: str,
            name: str) -> torch.Tensor:
    n, d_pad = x.shape
    Q, B, P = blk_idx.shape
    if not (x.is_cuda and qs.device == x.device and arm_idx.device == x.device
            and blk_idx.device == x.device):
        raise ValueError(f"{name} needs every operand on one CUDA device")
    if x.dtype not in DTYPES or qs.dtype != x.dtype:
        raise ValueError(f"{name} takes a corpus and queries of one type, "
                         f"fp32 or bf16; got {x.dtype} and {qs.dtype}")
    if block not in BLOCKS or d_pad % block:
        raise ValueError(f"block={block} with d_pad={d_pad}: the kernel takes "
                         f"a block in {BLOCKS} that divides d_pad")
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if qs.shape != (Q, d_pad) or arm_idx.shape != (Q, B):
        raise ValueError(f"shapes x {tuple(x.shape)}, qs {tuple(qs.shape)}, "
                         f"arm {tuple(arm_idx.shape)}, blk {tuple(blk_idx.shape)}"
                         " do not agree")
    if (Q * B * P + 7) // 8 >= 2 ** 31:
        raise ValueError(f"Q·B·P={Q * B * P} pulls exceed the kernel's grid")
    x = x.contiguous()
    qs = qs.contiguous()
    arm = arm_idx.to(torch.int32).contiguous()
    blk = blk_idx.to(torch.int32).contiguous()
    if x.data_ptr() % 16 or qs.data_ptr() % 16:
        raise ValueError(f"{name} needs 16-byte aligned rows")
    out = torch.empty((Q, B, P), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _entry()(x.data_ptr(), qs.data_ptr(), arm.data_ptr(),
                      blk.data_ptr(), out.data_ptr(), n, d_pad, Q, B, P,
                      block, METRICS[metric], DTYPES[x.dtype], stream)
    _build.check(rc, f"{name} launch")
    return out


def block_pull_multi_cuda(x: torch.Tensor, qs: torch.Tensor,
                          arm_idx: torch.Tensor, blk_idx: torch.Tensor, *,
                          block: int, metric: str = "l2") -> torch.Tensor:
    """x (n, d_pad) and qs (Q, d_pad), both fp32 or both bf16; arm_idx
    (Q, B) int; blk_idx (Q, B, P) int; all on one CUDA device. Returns
    (Q, B, P) fp32 block-mean distances. A negative arm id gives 0 without
    reading; an out-of-range arm or block id gives NaN."""
    out = _launch(x, qs, arm_idx, blk_idx, block=block, metric=metric,
                  name="block_pull_multi_cuda")
    block_pull_multi_cuda.launches += 1
    return out


def block_pull_cuda(x: torch.Tensor, q: torch.Tensor, arm_idx: torch.Tensor,
                    blk_idx: torch.Tensor, *, block: int,
                    metric: str = "l2") -> torch.Tensor:
    """The single-query pull: q (d_pad,), arm_idx (B,), blk_idx (B, P) →
    (B, P) fp32; otherwise as ``block_pull_multi_cuda``."""
    if q.dim() != 1 or arm_idx.dim() != 1 or blk_idx.dim() != 2:
        raise ValueError(f"block_pull_cuda takes q (d_pad,), arm (B,) and "
                         f"blk (B, P); got {tuple(q.shape)}, "
                         f"{tuple(arm_idx.shape)}, {tuple(blk_idx.shape)}")
    out = _launch(x, q[None], arm_idx[None], blk_idx[None], block=block,
                  metric=metric, name="block_pull_cuda")
    block_pull_cuda.launches += 1
    return out[0]


block_pull_multi_cuda.launches = 0
block_pull_cuda.launches = 0
