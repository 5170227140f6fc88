"""The normalized fast Walsh–Hadamard transform on the card: wrapper around
the CUDA kernel in ``csrc/fwht.cu`` (the port of the TPU kernel
``repro/kernels/fwht.py``; see the source for its design, and
``kernels/fwht_plan.py`` for the plan it launches with). The plain version
is ``ref.fwht_ref``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fwht_plan import plan

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


_ENTRY = _build.Entry("fwht", "fwht_rows",
                      [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def fwht_cuda(x: torch.Tensor) -> torch.Tensor:
    """x (..., d) fp32 or bf16 on a CUDA device, d a power of two ≤ 32768
    → FWHT(x)/√d along the last axis, in x's type."""
    if not x.is_cuda:
        raise ValueError("fwht_cuda needs a CUDA tensor")
    d = x.shape[-1]
    plan(d, x.dtype)                      # raises on a d or type it lacks
    src = x.contiguous()
    if src.data_ptr() % 16:               # a view that starts mid-vector
        src = src.clone()
    out = torch.empty_like(src)
    rows = src.numel() // d
    if rows == 0:
        return out
    _build.launch(_ENTRY, x.get_device(), "fwht", src.data_ptr(),
                  out.data_ptr(), rows, d, DTYPES[x.dtype])
    fwht_cuda.launches += 1
    return out


fwht_cuda.launches = 0


def kernel_plan(d: int, dtype: torch.dtype) -> dict:
    """The plan ``csrc/fwht.cu`` launches with for (d, dtype) on the current
    device, as the kernel reports it, with the blocks an SM holds at once
    (the occupancy calculator, from ptxas's registers and the shared
    memory)."""
    out = (ctypes.c_int * 5)()
    fn = _build.library("fwht").fwht_plan_of
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(d, DTYPES[dtype], ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"fwht_plan_of: CUDA error {rc}")
    return dict(zip(("E", "threads", "rows_per_block", "smem",
                     "blocks_per_sm"), out))
