"""The normalized fast Walsh–Hadamard transform on the card: wrapper around
the CUDA kernel in ``csrc/fwht.cu`` (the port of the TPU kernel
``repro/kernels/fwht.py``; see the source for its design). The plain
version is ``ref.fwht_ref``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_D = 32768
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


_ENTRY = _build.Entry("fwht", "fwht_rows",
                      [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def fwht_cuda(x: torch.Tensor) -> torch.Tensor:
    """x (..., d) fp32 or bf16 on a CUDA device, d a power of two ≤ 32768
    → FWHT(x)/√d along the last axis, in x's type."""
    d = x.shape[-1]
    if not x.is_cuda:
        raise ValueError("fwht_cuda needs a CUDA tensor")
    if x.dtype not in DTYPES:
        raise ValueError(f"fwht_cuda takes fp32 or bf16, got {x.dtype}")
    if d < 2 or d > MAX_D or d & (d - 1):
        raise ValueError(f"d={d}: the kernel takes a power of two in "
                         f"[2, {MAX_D}]")
    src = x.contiguous()
    out = torch.empty_like(src)
    rows = src.numel() // d
    if rows == 0:
        return out
    _build.launch(_ENTRY, x.get_device(), "fwht", src.data_ptr(),
                  out.data_ptr(), rows, d, DTYPES[x.dtype])
    fwht_cuda.launches += 1
    return out


fwht_cuda.launches = 0
