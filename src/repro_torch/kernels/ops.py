"""Dispatch between each ported kernel and its plain PyTorch version.

``impl``:
  * "auto" — the CUDA kernel for a CUDA tensor, the plain version for a CPU
             tensor,
  * "cuda" — the CUDA kernel; raises on a CPU tensor,
  * "ref"  — the plain version, on any device.

There is no fallback: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as kref
from repro_torch.kernels.block_pull import block_pull_cuda, block_pull_multi_cuda
from repro_torch.kernels.flash_attn import flash_attention_cuda
from repro_torch.kernels.fused_race import N_BUF, fused_epoch_pull_cuda
from repro_torch.kernels.fwht import fwht_cuda
from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda

IMPLS = ("auto", "cuda", "ref")


def _resolve(impl: str, t: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (want one of {IMPLS})")
    if impl == "auto":
        return "cuda" if t.is_cuda else "ref"
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs a CUDA tensor; this one is on "
                         f"{t.device}")
    return impl


def fwht(x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    if _resolve(impl, x) == "ref":
        return kref.fwht_ref(x)
    return fwht_cuda(x)


def block_pull(x, q, arm_idx, blk_idx, *, block: int, metric: str = "l2",
               impl: str = "auto"):
    """Single-query pull: q (d_pad,), arm_idx (B,), blk_idx (B, P) →
    (B, P)."""
    if _resolve(impl, x) == "ref":
        return kref.block_pull_ref(x, q, arm_idx, blk_idx, block, metric)
    return block_pull_cuda(x, q, arm_idx, blk_idx, block=block, metric=metric)


def block_pull_multi(x, qs, arm_idx, blk_idx, *, block: int,
                     metric: str = "l2", impl: str = "auto"):
    """Cross-query batched pull: arm_idx (Q, B), blk_idx (Q, B, P) →
    (Q, B, P)."""
    if _resolve(impl, x) == "ref":
        return kref.block_pull_multi_ref(x, qs, arm_idx, blk_idx, block,
                                         metric)
    return block_pull_multi_cuda(x, qs, arm_idx, blk_idx, block=block,
                                 metric=metric)


def pairwise_dist(qs, x, *, metric: str = "l2", impl: str = "auto"):
    """Exact (Q, n) sum-form distances (ℓ2² or ℓ1) of qs (Q, d) to x (n, d)."""
    if _resolve(impl, qs) == "ref":
        return kref.pairwise_dist_ref(qs, x, metric)
    return pairwise_dist_cuda(qs, x, metric=metric)


def fused_epoch_pull(x, qs, arm_idx, blk_idx, *, block: int,
                     metric: str = "l2", impl: str = "auto",
                     n_buf: int = N_BUF):
    """Round-fused epoch pull: arm_idx (Q, B), blk_idx (Q, B, R·P) →
    (Q, B, 2) per-arm (mean, M2) Welford batch statistics. ``n_buf`` is the
    kernel's load-ahead depth (``BMOConfig.kernel_buffers``; the plain
    version ignores it)."""
    if _resolve(impl, x) == "ref":
        return kref.fused_epoch_pull_ref(x, qs, arm_idx, blk_idx, block,
                                         metric)
    return fused_epoch_pull_cuda(x, qs, arm_idx, blk_idx, block=block,
                                 metric=metric, n_buf=n_buf)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    impl: str = "auto"):
    """Fused attention: q (B, H, Sq, D), k (B, KV, Sk, D), v (B, KV, Sk, Dv)
    with H % KV == 0 (query head h reads KV head h // (H / KV)) → (B, H, Sq,
    Dv) in q's type. The model's one call site is ``GQAAttention`` with
    ``attn_impl="pallas"`` and no cache."""
    if _resolve(impl, q) == "ref":
        return kref.flash_attention_ref(q, k, v, causal, q_offset)
    return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
