"""Fused flash attention on the card: wrapper around the CUDA kernel in
``csrc/flash_attn.cu`` (the port of the TPU kernel
``repro/kernels/flash_attn.py``; see the source for its design). The plain
version is ``ref.flash_attention_ref``.

The kernel reads grouped KV heads directly (query head h reads KV head
h // (H / KV)), so the model passes its KV heads unrepeated, and it takes
q, k and v through their strides, so the (B, S, H, D) projections pass as
(B, H, S, D) views without a copy. It has no backward: the port runs the
forward only.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def _entry():
    fn = _build.library("flash_attn").flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 17
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> bool:
    """Rows the kernel can read with 16-byte vector loads."""
    step = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % step == 0 for s, n in zip(t.stride()[:-1], t.shape)
                    if n > 1))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         q_offset: int = 0) -> torch.Tensor:
    """q (B, H, Sq, D), k (B, KV, Sk, D), v (B, KV, Sk, Dv), one type (fp32
    or bf16) on one CUDA device, H % KV == 0, D and Dv multiples of 8 up to
    128, q_offset ≥ 0. Returns (B, H, Sq, Dv) in q's type."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs q, k and v on one CUDA "
                         "device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda takes q, k and v of one type, "
                         f"fp32 or bf16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise ValueError("flash_attention_cuda has no backward; call it under "
                         "torch.no_grad() or torch.inference_mode()")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_cuda takes (B, H, S, D) tensors")
    B, H, Sq, D = q.shape
    KV, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if (k.shape != (B, KV, Sk, D) or v.shape[:3] != (B, KV, Sk)
            or H % KV):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if not (0 < D <= MAX_HEAD_DIM and 0 < Dv <= MAX_HEAD_DIM
            and D % 8 == 0 and Dv % 8 == 0):
        raise ValueError(f"head dims D={D}, Dv={Dv}: the kernel takes "
                         f"multiples of 8 up to {MAX_HEAD_DIM}")
    if q_offset < 0:
        raise ValueError(f"q_offset={q_offset}: the kernel takes q_offset ≥ 0")
    if H > 65535 or B > 65535:
        raise ValueError(f"B={B}, H={H} outside the kernel's grid")
    if Sk == 0:
        raise ValueError("flash_attention_cuda needs at least one key")
    q, k, v = (t if _aligned(t) else t.contiguous() for t in (q, k, v))
    if not all(map(_aligned, (q, k, v))):
        raise ValueError("flash_attention_cuda needs 16-byte aligned rows")
    out = torch.empty((B, H, Sq, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      q.stride(0), q.stride(1), q.stride(2),
                      k.stride(0), k.stride(1), k.stride(2),
                      v.stride(0), v.stride(1), v.stride(2),
                      B, H, KV, Sq, Sk, D, Dv, q_offset, int(causal),
                      DTYPES[q.dtype], 1.0 / math.sqrt(D), stream)
    _build.check(rc, "flash_attention launch")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
