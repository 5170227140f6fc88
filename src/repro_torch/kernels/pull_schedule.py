"""Which schedule the two pull kernels take (``csrc/fused_epoch_pull.cu``,
``csrc/block_pull.cu``; each source describes both).

The choice reads only the operands' shapes, strides and types, and is made
before the launch: never on a failure, never by the caller (the wrappers'
``_schedule`` argument, which forces one, is for the tests alone).

* **rows**: every query races the same arm vector (an expanded (Q, B) arm
  tensor, stride 0 along the queries: what the drivers' wide inits pass),
  the rows' bytes are no more than the pulls of them would read (Q·T·block
  ≥ d_pad), and a row fits in shared memory. A block stages one corpus
  row once and walks every query, with 8 warps (``csrc/pull_common.cuh``).
* **pair**: everything else. ``fused_epoch_pull`` stages the query row in
  shared memory when it fits beside the ring of ``n_buf`` slots, and reads
  the query slices from device memory otherwise; its block takes as many
  warps (four arms each) as the arms and shared memory allow.
  ``block_pull_multi`` reads both slices from device memory, one warp a
  pull.

The arm tensor goes to the kernel as ``arm_operand`` gives it: a shared
vector as one (B,) vector with stride 0, never copied out to (Q, B). A
choice is a pure function of its integers, so each is worked out once
(``lru_cache``): an epoch's call pays a lookup.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

#: dynamic shared memory one block may opt into on sm_90 (H100), less a
#: kilobyte for the kernels' static barriers
SMEM_BYTES = 232_448 - 1024
#: warps a block of fused_epoch_pull's pair schedule, four arms to a warp
PAIR_WARPS = 8
GROUPS_PER_WARP = 4
SCHEDULES = ("rows", "pair")


@dataclasses.dataclass(frozen=True)
class Schedule:
    name: str                   # "rows" or "pair"
    warps: int = 0              # fused pair: warps a block
    stage_query: bool = False   # fused pair: the query row in shared memory
    smem: int = 0               # dynamic shared memory a block, bytes


def shares_arms(arm_idx: torch.Tensor) -> bool:
    """Whether every query races the same arm vector: a (Q, B) arm tensor
    with stride 0 along the queries (``expand``), or a single query."""
    return arm_idx.dim() == 2 and (arm_idx.shape[0] == 1
                                   or arm_idx.stride(0) == 0)


def arm_operand(arm_idx: torch.Tensor, ids=(torch.int32,)
                ) -> Tuple[torch.Tensor, int]:
    """(ids, row stride) as the kernels read them: arm[q·stride + b]. A
    (B,) vector (one query's arms) and a shared (Q, B) one go as that one
    row with stride 0; any other (Q, B) tensor as a contiguous one with
    stride B. Types outside ``ids`` are converted to int32."""
    if arm_idx.dim() == 2:
        if not shares_arms(arm_idx):
            if arm_idx.dtype not in ids:
                arm_idx = arm_idx.to(torch.int32)
            return arm_idx.contiguous(), arm_idx.shape[1]
        arm_idx = arm_idx[0]
    if arm_idx.dtype not in ids:
        arm_idx = arm_idx.to(torch.int32)
    return arm_idx.contiguous(), 0


def pair_smem(stage_query: bool, d_pad: int, block: int, warps: int,
              n_buf: int) -> int:
    """Bytes of shared memory a block of fused_epoch_pull's pair schedule
    takes (``pair_smem`` in ``csrc/fused_epoch_pull.cu``): the query row
    when staged, the ring, each arm's table of block values, its bitmap of
    blocks, the blocks each slot holds, and the barriers."""
    nb = d_pad // block
    words = (nb + 31) // 32
    arms = warps * GROUPS_PER_WARP
    size = 4 * d_pad if stage_query else 0
    size += warps * n_buf * GROUPS_PER_WARP * block * 4
    size += arms * nb * 4 + arms * words * 4 + warps * n_buf * GROUPS_PER_WARP * 4
    size = (size + 7) & ~7
    return size + (warps * n_buf + 1) * 8


def _rows(Q: int, T: int, d_pad: int, block: int, itemsize: int,
          shared: bool, force: Optional[str]) -> Optional[Schedule]:
    """The rows schedule where it applies (or is forced), else None."""
    if force not in (None, *SCHEDULES):
        raise ValueError(f"unknown schedule {force!r}")
    row_bytes = d_pad * itemsize
    fits = row_bytes <= SMEM_BYTES
    if force == "rows":
        if not (shared and fits):
            raise ValueError("the rows schedule needs one arm vector shared "
                             "by every query and a row that fits in shared "
                             f"memory (d_pad={d_pad})")
    elif force == "pair" or not (shared and fits and Q * T * block >= d_pad):
        return None
    return Schedule("rows", smem=row_bytes)


@functools.lru_cache(maxsize=1024)
def fused_schedule(Q: int, B: int, T: int, d_pad: int, block: int,
                   n_buf: int, shared: bool,
                   force: Optional[str] = None) -> Schedule:
    """The schedule of one ``fused_epoch_pull`` launch (fp32 operands)."""
    rows = _rows(Q, T, d_pad, block, 4, shared, force)
    if rows is not None:
        return rows
    want = max(1, min(PAIR_WARPS, -(-B // GROUPS_PER_WARP)))
    smem = pair_smem(True, d_pad, block, want, n_buf)
    if smem <= SMEM_BYTES:
        return Schedule("pair", warps=want, stage_query=True, smem=smem)
    for warps in range(want, 0, -1):
        smem = pair_smem(False, d_pad, block, warps, n_buf)
        if smem <= SMEM_BYTES:
            return Schedule("pair", warps=warps, smem=smem)
    raise ValueError(f"n_buf={n_buf} slots of block {block} with "
                     f"d_pad={d_pad} do not fit in shared memory")


@functools.lru_cache(maxsize=1024)
def block_pull_schedule(Q: int, B: int, P: int, d_pad: int, block: int,
                        itemsize: int, shared: bool,
                        force: Optional[str] = None) -> Schedule:
    """The schedule of one ``block_pull_multi`` launch."""
    return _rows(Q, P, d_pad, block, itemsize, shared, force) \
        or Schedule("pair")
