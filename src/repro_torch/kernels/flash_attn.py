"""Fused flash attention on the card: the port of the TPU kernel
``repro/kernels/flash_attn.py`` as two CUDA kernels, picked by a fixed rule
(``variant``; see each source for its design):

* "tensor_cores" — ``csrc/flash_attn_sm90.cu``, bf16 at D = Dv = 128 (the
  LM path's heads): wgmma, TMA and warp specialisation. It rounds the
  probabilities to bf16 for the product with v, which adds at most
  2⁻⁸·max|v| to an output (the plain version with ``p_dtype=bf16`` is that
  contract exactly). Its output lives in (B, Sq, H, Dv) storage and is
  returned as the (B, H, Sq, Dv) view, so the model's transpose back and
  reshape are free.
* "cuda_cores" — ``csrc/flash_attn.cu``, every other case (fp32, and bf16
  at other widths): fp32 FMA, p kept in fp32 as the TPU kernel keeps it.
  It has two instantiations, one for head dims up to 128 and one up to
  ``MAX_HEAD_DIM`` (256: nemotron-4-340b's 192), picked inside the
  library.

There is no fallback between them: a kernel that fails to build or launch
raises. Both read grouped KV heads directly (query head h reads KV head
h // (H / KV)), so the model passes its KV heads unrepeated, and both take
q, k and v through their strides, so the (B, S, H, D) projections pass as
(B, H, S, D) views without a copy. The plain version is
``ref.flash_attention_ref``. There is no backward: the port runs the
forward only.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
#: the tensor-core kernel's head width, and the bound on Sq and Sk that keeps
#: its TMA coordinates in 32 bits
TC_HEAD_DIM = 128
TC_MAX_SEQ = 1 << 30


_ENTRY = _build.Entry("flash_attn", "flash_attention",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 17
                      + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                         ctypes.c_void_p])
_ENTRY_TC = _build.Entry("flash_attn_sm90", "flash_attention_sm90",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 18
                         + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def variant(dtype: torch.dtype, D: int, Dv: int) -> str:
    """Which kernel takes a call: "tensor_cores" for bf16 at D = Dv = 128,
    "cuda_cores" for everything else."""
    if dtype == torch.bfloat16 and D == Dv == TC_HEAD_DIM:
        return "tensor_cores"
    return "cuda_cores"


def _aligned(t: torch.Tensor) -> bool:
    """Rows both kernels can read: 16-byte vector loads, and tensor maps,
    which take positive strides that are multiples of 16 bytes."""
    step = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s > 0 and s % step == 0
                    for s, n in zip(t.stride()[:-1], t.shape) if n > 1))


def tc_output(B: int, H: int, Sq: int, Dv: int, dtype=torch.bfloat16,
              device=None) -> torch.Tensor:
    """The tensor-core kernel's output: (B, Sq, H, Dv) storage, returned as
    its (B, H, Sq, Dv) view."""
    return torch.empty((B, Sq, H, Dv), dtype=dtype,
                       device=device).transpose(1, 2)


def _checked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             q_offset: int) -> tuple:
    """Raises on what neither kernel takes; returns q, k and v with rows
    both can read (copied only where they cannot)."""
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
    return q, k, v


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         q_offset: int = 0) -> torch.Tensor:
    """q (B, H, Sq, D), k (B, KV, Sk, D), v (B, KV, Sk, Dv), one type (fp32
    or bf16) on one CUDA device, H % KV == 0, D and Dv multiples of 8 up to
    ``MAX_HEAD_DIM``, q_offset ≥ 0. Returns (B, H, Sq, Dv) in q's type;
    from the tensor-core kernel (``variant``), a view of (B, Sq, H, Dv)
    storage."""
    q, k, v = _checked(q, k, v, q_offset)
    B, H, Sq, D = q.shape
    KV, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if variant(q.dtype, D, Dv) == "tensor_cores":
        return _tensor_cores(q, k, v, causal, q_offset)
    out = torch.empty((B, H, Sq, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _build.launch(_ENTRY, q.get_device(), "flash_attention",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  q.stride(0), q.stride(1), q.stride(2),
                  k.stride(0), k.stride(1), k.stride(2),
                  v.stride(0), v.stride(1), v.stride(2),
                  B, H, KV, Sq, Sk, D, Dv, q_offset, int(causal),
                  DTYPES[q.dtype], 1.0 / math.sqrt(D))
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_cc += 1
    return out


def _tensor_cores(q, k, v, causal: bool, q_offset: int) -> torch.Tensor:
    B, H, Sq, _ = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if Sq >= TC_MAX_SEQ or Sk >= TC_MAX_SEQ:
        raise ValueError(f"Sq={Sq}, Sk={Sk}: the tensor-core kernel takes "
                         f"sequences below {TC_MAX_SEQ}")
    out = tc_output(B, H, Sq, TC_HEAD_DIM, device=q.device)
    if out.numel() == 0:
        return out
    _build.launch(_ENTRY_TC, q.get_device(),
                  "flash_attention (tensor cores)",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  q.stride(0), q.stride(1), q.stride(2),
                  k.stride(0), k.stride(1), k.stride(2),
                  v.stride(0), v.stride(1), v.stride(2),
                  out.stride(0), out.stride(1), out.stride(2),
                  B, H, KV, Sq, Sk, q_offset, int(causal),
                  1.0 / math.sqrt(TC_HEAD_DIM))
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_tc += 1
    return out


# launches in all, and of each variant
flash_attention_cuda.launches = 0
flash_attention_cuda.launches_tc = 0
flash_attention_cuda.launches_cc = 0
