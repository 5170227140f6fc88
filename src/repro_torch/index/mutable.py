"""Online mutation of a dense or rotated IndexStore (DESIGN.md §3.3): the
served datastore grows while it serves, without a rebuild.

  * ``insert`` writes new rows into free (tombstoned or never-used) slots,
    doubling capacity only when none are free; it returns the slot ids so
    the caller can keep side payloads aligned,
  * ``delete`` is a tombstone flip: dead slots enter every later race
    pre-rejected, as arm id −1 in the wide init's pull,
  * ``compact`` rebuilds a dense slot layout once tombstones accumulate,
    returning the old→new slot map for payload reindexing.

Each call returns a new store (``dataclasses.replace``) with new tensors
for the fields it changes and never writes into the old store's tensors:
``IndexStore.n_live`` is cached per instance, and ``Index.store`` is handed
out read-only. So an insert copies the corpus tensor once, as the
reference's ``.at[].set`` does.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.datasets import next_pow2
from repro_torch.index.builder import _row_block_stats
from repro_torch.index.store import KINDS, IndexStore, free_slots
from repro_torch.kernels import ops as kops

log = logging.getLogger("repro_torch.index")


def _check_kind(store: IndexStore) -> None:
    if store.kind not in KINDS:
        raise NotImplementedError(
            f"mutating a {store.kind!r} store is not ported yet (the sparse "
            "box is ROADMAP.md Queue 1 item 2)")


def _pad_rows(t: torch.Tensor, extra: int) -> torch.Tensor:
    return torch.cat([t, t.new_zeros((extra,) + tuple(t.shape[1:]))])


def _grow(store: IndexStore, need: int) -> IndexStore:
    cap = store.capacity
    new_cap = max(2 * cap, next_pow2(cap + need))
    extra = new_cap - cap
    log.info("growing index capacity %d -> %d", cap, new_cap)
    return dataclasses.replace(
        store, alive=_pad_rows(store.alive, extra),
        prior_var=_pad_rows(store.prior_var, extra),
        x=_pad_rows(store.x, extra))


def insert(store: IndexStore, rows) -> Tuple[IndexStore, np.ndarray]:
    """Insert (B, d) dense rows (numpy or a tensor; a 1-D row is one row).
    The rotated box rotates them with the *cached* signs. Returns (new
    store, slot ids (B,) as int64 numpy)."""
    _check_kind(store)
    x_rows = torch.as_tensor(rows, dtype=torch.float32, device=store.device)
    if x_rows.dim() == 1:
        x_rows = x_rows[None]
    bsz = x_rows.shape[0]
    pad = store.d_pad - x_rows.shape[1]
    if pad < 0:
        raise ValueError(f"rows of width {x_rows.shape[1]} do not fit the "
                         f"store's {store.d_pad} columns")
    free = free_slots(store)
    if len(free) < bsz:
        store = _grow(store, bsz - len(free))
        free = free_slots(store)
    slots = free[:bsz]
    sl = torch.from_numpy(slots).to(store.device)
    if pad:
        x_rows = torch.nn.functional.pad(x_rows, (0, pad))
    if store.kind == "rotated":
        x_rows = kops.fwht(x_rows * store.signs[None, :])
    return dataclasses.replace(
        store, alive=store.alive.index_fill(0, sl, True),
        x=store.x.index_copy(0, sl, x_rows),
        prior_var=store.prior_var.index_copy(
            0, sl, _row_block_stats(x_rows, store.block, store.cfg.metric)),
    ), slots


def delete(store: IndexStore, slot_ids) -> IndexStore:
    """Tombstone slots; their data stays until ``compact``. Every id must
    lie in [0, capacity): checked on the host, since an index out of range
    on the card would end the CUDA context."""
    _check_kind(store)
    ids = np.atleast_1d(np.asarray(slot_ids, np.int64))
    if ids.size and (ids.min() < 0 or ids.max() >= store.capacity):
        raise ValueError(f"slot ids must lie in [0, {store.capacity}), got "
                         f"[{ids.min()}, {ids.max()}]")
    sl = torch.from_numpy(ids).to(store.device)
    return dataclasses.replace(store, alive=store.alive.index_fill(0, sl,
                                                                   False))


def tombstone_fraction(store: IndexStore) -> float:
    """Fraction of capacity occupied by dead slots (tombstones and the
    never-used tail): the state every race still pays a mask for."""
    return 1.0 - store.n_live / max(store.capacity, 1)


def maybe_compact(store: IndexStore, *, threshold: float = 0.5,
                  ) -> Tuple[IndexStore, Optional[np.ndarray]]:
    """Compact once the tombstone fraction crosses ``threshold`` and the
    power-of-two capacity would shrink. Returns ``(store, old_ids)``:
    ``old_ids`` is None when no compaction ran, else ``compact``'s map.
    The shrink check runs on plain ints before the O(capacity·d) gather,
    so an over-eager threshold costs nothing a call."""
    _check_kind(store)
    if (tombstone_fraction(store) > threshold
            and next_pow2(max(store.n_live, 1)) < store.capacity):
        return compact(store)
    return store, None


def compact(store: IndexStore) -> Tuple[IndexStore, np.ndarray]:
    """Rebuild a dense slot layout without the tombstones. Returns (new
    store, old_ids (new_cap,) int64 numpy): ``old_ids[j]`` is the previous
    slot of new slot j, −1 for an empty slot."""
    _check_kind(store)
    live = torch.nonzero(store.alive).flatten()
    n = live.numel()
    cap = next_pow2(max(n, 1))
    old_ids = np.full((cap,), -1, np.int64)
    old_ids[:n] = live.cpu().numpy()
    log.info("compacted index: %d live slots, capacity %d -> %d",
             n, store.capacity, cap)
    return dataclasses.replace(
        store, alive=torch.arange(cap, device=store.device) < n,
        prior_var=_take_pad(store.prior_var, live, cap),
        x=_take_pad(store.x, live, cap)), old_ids


def _take_pad(arr: torch.Tensor, sl: torch.Tensor, cap: int) -> torch.Tensor:
    """Rows ``sl`` of ``arr``, then zeros up to ``cap`` rows: one gather
    into the new tensor (the tail gathers row 0 and is zeroed)."""
    n = sl.numel()
    taken = arr.index_select(0, torch.cat([sl, sl.new_zeros(cap - n)]))
    taken[n:] = 0
    return taken
