"""Exact pairwise distances on the card: wrapper around the CUDA kernel in
``csrc/pairwise_dist.cu`` (the port of the TPU kernel
``repro/kernels/pairwise_dist.py``; see the source for its design). The
plain version is ``ref.pairwise_dist_ref``.

This is the exactness judge (``core/oracle.exact_knn``) and the paper
path's exact evaluation, so it accumulates ``(q − x)²`` or ``|q − x|`` in
fp32 directly: no norm expansion and no TF32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_race import METRICS


def _entry():
    fn = _build.library("pairwise_dist").pairwise_dist_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def pairwise_dist_cuda(qs: torch.Tensor, x: torch.Tensor, *,
                       metric: str = "l2") -> torch.Tensor:
    """qs (Q, d) and x (n, d), fp32 on one CUDA device → (Q, n) fp32
    sum-form distances (ℓ2² or ℓ1)."""
    if not (qs.is_cuda and x.device == qs.device):
        raise ValueError("pairwise_dist_cuda needs both operands on one CUDA "
                         "device")
    if qs.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError(f"pairwise_dist_cuda takes fp32, got {qs.dtype} and "
                         f"{x.dtype}")
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if qs.dim() != 2 or x.dim() != 2 or qs.shape[1] != x.shape[1]:
        raise ValueError(f"shapes qs {tuple(qs.shape)} and x {tuple(x.shape)} "
                         "do not agree")
    Q, d = qs.shape
    n = x.shape[0]
    if Q > 65535 * 64 or (Q <= 4 and Q * n >= 2 ** 31):
        raise ValueError(f"Q={Q}, n={n} outside the kernel's grid")
    qs = qs.contiguous()
    x = x.contiguous()
    out = torch.empty((Q, n), dtype=torch.float32, device=qs.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    with torch.cuda.device(qs.device):
        rc = _entry()(qs.data_ptr(), x.data_ptr(), out.data_ptr(), Q, n, d,
                      METRICS[metric], stream)
    _build.check(rc, "pairwise_dist launch")
    pairwise_dist_cuda.launches += 1
    return out


pairwise_dist_cuda.launches = 0
