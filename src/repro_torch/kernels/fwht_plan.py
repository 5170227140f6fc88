"""How ``csrc/fwht.cu`` cuts one (d, type) transform into registers, lanes,
warps and one exchange through shared memory (the source's note says why).

Everything here is worked out from (d, type) alone, and is what the kernel
launches with: ``csrc/fwht.cu``'s ``Plan`` computes the same numbers at
compile time, and ``fwht_plan_of`` there reports them, so a card test holds
the two to each other. ``ref.fwht_staged`` replays a plan's data movement
and order of stages on the CPU.

A block transforms a tile of ``rows_per_block`` contiguous rows, 2**tile_log
values; value i of the tile (i = row · d + column) has bits 0..tile_log-1.
A *layout* says which bit of i each bit of a thread's coordinates holds:
its register j (``e_log`` bits, the low ``vec_log`` of them the values of
one 16-byte access), its lane (5 bits) and its warp. Bits at or above
log2(d) tell rows apart and are never staged.

* **narrow** (d ≤ 2**(e_log+5)): a warp holds whole rows. Registers hold
  bits [0, vec_log) and [vec_log+5, e_log+5), lanes [vec_log, vec_log+5):
  stages in registers, then across lanes by shuffles; no shared memory.
  Four warps a block; the last block's rows past the tensor are masked.
* **wide** (one row a block): the load puts the row's top bits in the
  registers and the bits above the lanes in the warps; after the register
  and lane stages, one write and one read of the row through shared memory
  (fp32) bring the warps' bits into the registers for the last stages, in
  the narrow layout, from which the row is stored.

Both layouts put bits [0, vec_log) in one 16-byte access and bits
[vec_log, vec_log+5) in the lanes, so each warp's access to device memory is
512 contiguous bytes, and its access to shared memory is 32 distinct
16-byte slots: free of bank conflicts.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

MAX_LOG_D = 15
#: warps a block of the narrow kernel
NARROW_WARPS = 4
#: log2 of the values a thread holds, where that covers the row (below)
E_LOG = 6
LANE_BITS = 5


@dataclasses.dataclass(frozen=True)
class Layout:
    """Bit of the tile index held by each bit of a thread's register index,
    lane and warp (least significant first)."""
    reg: Tuple[int, ...]
    lane: Tuple[int, ...]
    warp: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Plan:
    d: int
    itemsize: int               # 4 (fp32) or 2 (bf16)
    vec_log: int                # log2 values of one 16-byte access
    e_log: int                  # log2 E, the values a thread holds
    wide: bool                  # one row a block, one exchange in shared memory
    threads: int
    rows_per_block: int
    smem: int                   # dynamic shared bytes a block
    load: Layout                # where the loaded values lie
    store: Layout               # where they lie when stored
    reg_stages_load: Tuple[int, ...]    # bits staged in registers after the load
    lane_stages: Tuple[int, ...]        # bits staged by shuffles, in order
    reg_stages_store: Tuple[int, ...]   # bits staged after the exchange

    @property
    def E(self) -> int:
        return 1 << self.e_log

    @property
    def tile_log(self) -> int:
        return (self.rows_per_block * self.d).bit_length() - 1

    @property
    def smem_bytes_per_row(self) -> int:
        """Bytes a row moves through shared memory: one write and one read
        of its fp32 values (wide), none (narrow)."""
        return 2 * 4 * self.d if self.wide else 0

    def smem_addr(self, i: int) -> int:
        """Float slot in shared memory of the row's value i (wide): the
        vector's 4-float groups stay whole, the lanes' groups next to each
        other, a bf16 vector's second group above the lanes."""
        v = self.vec_log
        lane = (i >> v) & 31
        group = (i >> 2) & ((1 << (v - 2)) - 1)
        return (i & 3) | (lane << 2) | (group << 7) | (i >> (v + 5) << (v + 5))


def _bits(lo: int, hi: int) -> Tuple[int, ...]:
    return tuple(range(lo, hi))


@functools.lru_cache(maxsize=None)
def plan(d: int, dtype: torch.dtype) -> Plan:
    """The kernel's plan for rows of length ``d`` (a power of two in
    [2, 32768]) of type ``dtype`` (fp32 or bf16)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fwht takes fp32 or bf16, got {dtype}")
    if d < 2 or d > 1 << MAX_LOG_D or d & (d - 1):
        raise ValueError(f"d={d}: the kernel takes a power of two in "
                         f"[2, {1 << MAX_LOG_D}]")
    itemsize = 4 if dtype == torch.float32 else 2
    v = 2 if itemsize == 4 else 3
    L = d.bit_length() - 1
    # the load and the store stage e_log + 5 and e_log - v of the bits
    e = E_LOG if L <= 2 * E_LOG - v + LANE_BITS else E_LOG + 1
    lanes = _bits(v, v + LANE_BITS)
    narrow_reg = _bits(0, v) + _bits(v + LANE_BITS, e + LANE_BITS)
    if L <= e + LANE_BITS:
        tile_log = e + LANE_BITS + NARROW_WARPS.bit_length() - 1
        layout = Layout(narrow_reg, lanes, _bits(e + LANE_BITS, tile_log))
        return Plan(d, itemsize, v, e, False, 32 * NARROW_WARPS,
                    1 << (tile_log - L), 0, layout, layout,
                    tuple(b for b in narrow_reg if b < L),
                    tuple(b for b in lanes if b < L), ())
    top = L - (e - v)                   # the row's top e - v bits
    load = Layout(_bits(0, v) + _bits(top, L), lanes, _bits(v + LANE_BITS, top))
    store = Layout(narrow_reg, lanes, _bits(e + LANE_BITS, L))
    return Plan(d, itemsize, v, e, True, 1 << (L - e), 1, 4 * d, load, store,
                load.reg, lanes, tuple(b for b in store.reg if b not in load.reg))
