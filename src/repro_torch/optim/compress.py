"""int8 error-feedback gradient compression and global-norm clipping: the
port of ``repro/optim/compress.py``.

The reference compresses a data-parallel all-reduce: each of S shards of a
``shard_map`` quantizes (grad + error carry) to int8 with a scale shared by
all shards (the max over them), the int8 payloads are summed in int16
(exact: S ≤ 256 shards of ±127), and the quantization residual is carried
to the next step. The port holds the S ranks on one device as a leading
rank axis (``compressed_mean``), with the same integers, sums and scale;
across cards it waits for sharding (ROADMAP.md Queue 1 item 9c-ii).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.optim.optimizers import row_slices


def _quantize(g: torch.Tensor):
    """(int8 q, fp32 scale): g / (max|g| / 127) rounded half to even and
    clipped to ±127; the scale is 1 for an all-zero g."""
    g = g.to(torch.float32)
    amax = torch.amax(torch.abs(g))
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_leaf(g: torch.Tensor, e: torch.Tensor):
    """One leaf of ``compressed_mean``: g and e (S, ...), rank axis first.
    Returns (q (S, ...) int8, the int16 sum over ranks, the shared fp32
    scale, the mean (...) fp32, the new error (S, ...) fp32)."""
    S = g.shape[0]
    g = g.to(torch.float32) + e
    amax = torch.amax(torch.abs(g))           # the max over every rank
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    total = torch.sum(q.to(torch.int16), dim=0, dtype=torch.int16)
    mean = total.to(torch.float32) * scale / S
    new_e = g - q.to(torch.float32) * scale
    return q, total, scale, mean, new_e


def compressed_mean(grads: Dict[str, torch.Tensor],
                    error: Dict[str, torch.Tensor]):
    """The reference's ``compressed_psum`` over S ranks held as the leading
    axis of every leaf: (the dequantized mean over ranks of each leaf, the
    new error carry of each rank)."""
    mean, new_e = {}, {}
    for name, g in grads.items():
        _, _, _, mean[name], new_e[name] = compress_leaf(g, error[name])
    return mean, new_e


def init_error(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """√(Σ g²) over every leaf, in fp32 (a 0-dim tensor on the leaves'
    device), a slice of a leaf at a time."""
    total = None
    for leaf in tree.values():
        for sl in row_slices(leaf):
            part = torch.sum(torch.square(leaf[sl].to(torch.float32)))
            total = part if total is None else total + part
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """Every leaf times min(1, max_norm / max(norm, 1e-9)), in fp32 and
    cast back to its type, in place. Returns (grads, norm)."""
    norm = global_norm(grads)
    factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for leaf in grads.values():
        for sl in row_slices(leaf):
            leaf[sl] = leaf[sl].to(torch.float32) * factor
    return grads, norm
