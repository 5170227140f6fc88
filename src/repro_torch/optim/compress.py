"""int8 error-feedback gradient compression and global-norm clipping: the
port of ``repro/optim/compress.py``.

The reference compresses a data-parallel all-reduce: each of S shards of a
``shard_map`` quantizes (grad + error carry) to int8 with a scale shared by
all shards (the max over them), the int8 payloads are summed exactly, and
the quantization residual is carried to the next step.
``compressed_psum`` does that over the ranks of a ``torch.distributed``
group; ``compressed_mean`` holds the S ranks on one device as a leading
rank axis, with the same integers, sums and scale, so the two give the
same bits. The reference sums an int16 payload (exact for S ≤ 256); gloo
and NCCL reduce no int16, so the port's all-reduce sums int32, exact for
any S (ROADMAP.md Queue 3).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.optim.optimizers import local, row_slices
from repro_torch.sharding.context import is_dtensor


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


def compressed_psum(grads: Dict[str, torch.Tensor], group,
                    error: Dict[str, torch.Tensor]):
    """The reference's ``compressed_psum`` over the ranks of ``group``
    (None: the default group), every rank calling: each leaf g + e is
    quantized to int8 with the scale max|g + e| / 127 over every rank (one
    all-reduce of the max), the int8 payloads summed exactly as int32 (one
    all-reduce), the mean dequantized. Returns (the mean of each leaf,
    the same on every rank; this rank's new error carry)."""
    import torch.distributed as dist
    S = dist.get_world_size(group)
    mean, new_e = {}, {}
    for name, g in grads.items():
        g = g.to(torch.float32) + error[name]
        amax = torch.amax(torch.abs(g))
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.where(amax > 0, amax / 127.0, 1.0)
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        total = q.to(torch.int32)
        dist.all_reduce(total, group=group)
        mean[name] = total.to(torch.float32) * scale / S
        new_e[name] = g - q.to(torch.float32) * scale
    return mean, new_e


def init_error(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def _replicas(t) -> int:
    """How many ranks hold each element of a DTensor: the product of the
    mesh dims it is replicated over (1 for a plain tensor)."""
    if not is_dtensor(t):
        return 1
    n = 1
    for size, pl in zip(t.device_mesh.mesh.shape, t.placements):
        if pl.is_replicate():
            n *= int(size)
    return n


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """√(Σ g²) over every leaf, in fp32 (a 0-dim tensor on the leaves'
    device), a slice of a leaf at a time. Leaves laid out on a mesh
    (DTensors, every rank calling) add their shards' sums, each divided by
    the number of ranks holding that shard, and one all-reduce over the
    group gives the global sum."""
    total, meshed = None, False
    for leaf in tree.values():
        meshed = meshed or is_dtensor(leaf)
        loc = local(leaf)
        for sl in row_slices(loc):
            part = torch.sum(torch.square(loc[sl].to(torch.float32)))
            part = part / _replicas(leaf) if _replicas(leaf) > 1 else part
            total = part if total is None else total + part
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    if meshed:
        import torch.distributed as dist
        dist.all_reduce(total)
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """Every leaf times min(1, max_norm / max(norm, 1e-9)), in fp32 and
    cast back to its type, in place (a DTensor's shards on each rank).
    Returns (grads, norm)."""
    norm = global_norm(grads)
    factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for leaf in grads.values():
        loc = local(leaf)
        for sl in row_slices(loc):
            loc[sl] = loc[sl].to(torch.float32) * factor
    return grads, norm
