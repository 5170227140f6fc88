"""Exact pairwise distances on the card: the port of the TPU kernel
``repro/kernels/pairwise_dist.py`` as two CUDA kernels, picked by shape
(``variant``; see each source for its design). The plain version is
``ref.pairwise_dist_ref``.

This is the exactness judge (``core/oracle.exact_knn``) and the paper
path's exact evaluation, so neither kernel drops to plain TF32:

* "tensor_cores" — ``csrc/pairwise_dist_sm90.cu``, ℓ2 with more than
  ``ROWWISE_MAX_Q`` queries and rows TMA can describe (d % 4 == 0, 16-byte
  aligned): ‖q‖² + ‖x‖² − 2·q·x with the cross term in split TF32 (three
  TF32 products, about 21 bits each), then an exact repair: every entry
  within ``flag_ratio(d)``·(‖q‖² + ‖x‖²) of cancelling is recomputed as
  Σ(q − x)² on the CUDA cores. Every entry is within 1e-4 of its exact
  value, relatively, and x against itself gives exactly 0.0 on the
  diagonal. ``pairwise_dist_cuda.flagged`` counts the repaired pairs.
* "cuda_cores" — ``csrc/pairwise_dist.cu``, everything else (ℓ1 at every
  shape, ℓ2 with at most ``ROWWISE_MAX_Q`` queries, ℓ2 with d % 4 != 0):
  Σ(q − x)² or Σ|q − x| accumulated in fp32, no norm expansion.

This is a dispatch by shape, not a fallback: a kernel that fails to build
or launch raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_race import METRICS

#: up to this many queries the CUDA-core kernel takes a row-wise schedule
#: (the paper path's exact evaluation); above it the tiled one
ROWWISE_MAX_Q = 4
_FP32 = torch.float32

_CUDA_CORES = _build.Entry("pairwise_dist", "pairwise_dist_f32",
                           [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3
                           + [ctypes.c_int, ctypes.c_void_p])
_TENSOR_CORES = _build.Entry("pairwise_dist_sm90", "pairwise_l2_sm90",
                             [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3
                             + [ctypes.c_float, ctypes.c_void_p])


def gamma(d: int) -> float:
    """The tensor-core kernel's error per unit of ‖q‖² + ‖x‖² at width d
    (derived in ``csrc/pairwise_dist_sm90.cu``)."""
    return 2.0 ** -19 + 2.0 ** -23 * math.sqrt(d / 32)


def flag_ratio(d: int) -> float:
    """Entries at most this times ‖q‖² + ‖x‖² are repaired: elsewhere an
    error of gamma(d)·(‖q‖² + ‖x‖²) is within 1e-4 of the value."""
    return gamma(d) / 1e-4


def variant(metric: str, Q: int, d: int, aligned: bool = True) -> str:
    """Which kernel takes a call: "tensor_cores" for ℓ2 with Q >
    ROWWISE_MAX_Q, d % 4 == 0 and 16-byte aligned operands, "cuda_cores"
    for everything else."""
    if metric == "l2" and Q > ROWWISE_MAX_Q and d % 4 == 0 and aligned:
        return "tensor_cores"
    return "cuda_cores"


def pairwise_dist_cuda(qs: torch.Tensor, x: torch.Tensor, *,
                       metric: str = "l2", repair: bool = True) -> torch.Tensor:
    """qs (Q, d) and x (n, d), fp32 on one CUDA device → (Q, n) fp32
    sum-form distances (ℓ2² or ℓ1). ``repair=False`` returns the tensor-core
    variant's expanded form as it comes, nothing repaired: only for
    measuring its error (``chip_smoke.py``)."""
    index = qs.get_device()                  # -1 on the CPU
    if index < 0 or x.get_device() != index:
        raise ValueError("pairwise_dist_cuda needs both operands on one CUDA "
                         "device")
    if qs.dtype is not _FP32 or x.dtype is not _FP32:
        raise ValueError(f"pairwise_dist_cuda takes fp32, got {qs.dtype} and "
                         f"{x.dtype}")
    code = METRICS.get(metric)
    if code is None:
        raise ValueError(f"unknown metric {metric!r}")
    if qs.ndim != 2 or x.ndim != 2 or qs.shape[1] != x.shape[1]:
        raise ValueError(f"shapes qs {tuple(qs.shape)} and x {tuple(x.shape)} "
                         "do not agree")
    Q, d = qs.shape
    n = len(x)
    qs = qs.contiguous()
    x = x.contiguous()
    qp, xp = qs.data_ptr(), x.data_ptr()
    if variant(metric, Q, d, not (qp | xp) % 16) == "tensor_cores":
        return _tensor_cores(qs, x, qp, xp, index, repair)
    if Q > 65535 * 64 or (Q <= ROWWISE_MAX_Q and Q * n >= 2 ** 31):
        raise ValueError(f"Q={Q}, n={n} outside the kernel's grid")
    out = qs.new_empty((Q, n))
    if Q * n:
        _build.launch(_CUDA_CORES, index, "pairwise_dist", qp, xp,
                      out.data_ptr(), Q, n, d, code)
        pairwise_dist_cuda.launches_cc += 1
        pairwise_dist_cuda.launches += 1
    return out


def _tensor_cores(qs, x, qp: int, xp: int, index: int,
                  repair: bool) -> torch.Tensor:
    (Q, d), n = qs.shape, len(x)
    if max(Q, n, d) >= 2 ** 31:
        raise ValueError(f"Q={Q}, n={n}, d={d}: the tensor-core kernel takes "
                         "each below 2^31")
    out = qs.new_empty((Q, n))
    if not n:
        return out
    # the split queries and their norms; the call's flag count, then the
    # flagged pairs
    scratch = qs.new_empty(2 * Q * d + Q)
    pairs = qs.new_empty(1 + Q * n, dtype=torch.int64)
    total = pairwise_dist_cuda.flagged.get(index)
    if total is None:
        total = qs.new_zeros(1, dtype=torch.int64)
        pairwise_dist_cuda.flagged[index] = total
    _build.launch(_TENSOR_CORES, index, "pairwise_dist (tensor cores)",
                  qp, xp, out.data_ptr(), scratch.data_ptr(), pairs.data_ptr(),
                  total.data_ptr(), Q, n, d,
                  flag_ratio(d) if repair else -math.inf)
    pairwise_dist_cuda.launches_tc += 1
    pairwise_dist_cuda.launches += 1
    return out


def flagged_pairs() -> int:
    """Pairs the tensor-core kernel has flagged and repaired since the last
    ``reset_flagged`` (reads the device counters: a sync)."""
    return sum(int(t.item()) for t in pairwise_dist_cuda.flagged.values())


def reset_flagged() -> None:
    for t in pairwise_dist_cuda.flagged.values():
        t.zero_()


# launches in all, and of each variant; flagged pairs by device index (a
# running total on the device, added to by each tensor-core call)
pairwise_dist_cuda.launches = 0
pairwise_dist_cuda.launches_tc = 0
pairwise_dist_cuda.launches_cc = 0
pairwise_dist_cuda.flagged = {}
