"""Online mutation of an IndexStore (DESIGN.md §3.3): the served datastore
grows while it serves, without a rebuild.

  * ``insert`` writes new rows into free (tombstoned or never-used) slots,
    doubling capacity only when none are free, and widens a sparse store's
    CSR rows when a new row has more nonzeros than they hold; it returns
    the slot ids so the caller can keep side payloads aligned,
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

from repro_torch.core.datasets import SparseDataset, next_pow2
from repro_torch.index.builder import _row_block_stats, _sparse_prior
from repro_torch.index.store import IndexStore, free_slots
from repro_torch.kernels import ops as kops

log = logging.getLogger("repro_torch.index")


def _pad_rows(t: torch.Tensor, extra: int, fill=0) -> torch.Tensor:
    return torch.cat([t, t.new_full((extra,) + tuple(t.shape[1:]), fill)])


def _grow(store: IndexStore, need: int) -> IndexStore:
    cap = store.capacity
    new_cap = max(2 * cap, next_pow2(cap + need))
    log.info("growing index capacity %d -> %d", cap, new_cap)
    return _grow_rows(store, new_cap - cap)


def _grow_rows(store: IndexStore, extra: int) -> IndexStore:
    """``store`` with ``extra`` dead slots appended."""
    kw = dict(alive=_pad_rows(store.alive, extra),
              prior_var=_pad_rows(store.prior_var, extra))
    if store.kind == "sparse":
        kw.update(indices=_pad_rows(store.indices, extra, store.d),
                  values=_pad_rows(store.values, extra),
                  nnz=_pad_rows(store.nnz, extra))
    else:
        kw.update(x=_pad_rows(store.x, extra))
    return dataclasses.replace(store, **kw)


def insert(store: IndexStore, rows) -> Tuple[IndexStore, np.ndarray]:
    """Insert (B, d) dense rows (numpy or a tensor; a 1-D row is one row)
    into any kind: the rotated box rotates them with the *cached* signs,
    the sparse box compresses them. Returns (new store, slot ids (B,) as
    int64 numpy)."""
    x_rows = torch.as_tensor(rows, dtype=torch.float32, device=store.device)
    if x_rows.dim() == 1:
        x_rows = x_rows[None]
    bsz = x_rows.shape[0]
    width = store.d if store.kind == "sparse" else store.d_pad
    if x_rows.shape[1] > width:
        raise ValueError(f"rows of width {x_rows.shape[1]} do not fit the "
                         f"store's {width} columns")
    free = free_slots(store)
    if len(free) < bsz:
        store = _grow(store, bsz - len(free))
        free = free_slots(store)
    slots = free[:bsz]
    sl = torch.from_numpy(slots).to(store.device)
    if store.kind == "sparse":
        return _insert_sparse(store, sl, x_rows), slots
    pad = store.d_pad - x_rows.shape[1]
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


def _insert_sparse(store: IndexStore, sl: torch.Tensor,
                   rows: torch.Tensor) -> IndexStore:
    new = SparseDataset.build(rows, d=store.d)
    store = _widen_sparse(store, new.m)
    pad = store.m - new.m
    idx = torch.cat([new.indices, new.indices.new_full((len(rows), pad),
                                                       store.d)], 1)
    val = torch.nn.functional.pad(new.values, (0, pad))
    return dataclasses.replace(
        store, alive=store.alive.index_fill(0, sl, True),
        indices=store.indices.index_copy(0, sl, idx),
        values=store.values.index_copy(0, sl, val),
        nnz=store.nnz.index_copy(0, sl, new.nnz),
        prior_var=store.prior_var.index_copy(
            0, sl, _sparse_prior(val, new.nnz, store.d)))


def _widen_sparse(store: IndexStore, m_new: int) -> IndexStore:
    """A sparse store whose rows hold ``m_new`` entries, if they hold
    fewer: the new columns are padding (index d, value 0)."""
    if m_new <= store.m:
        return store
    extra = m_new - store.m
    log.info("widening sparse index m %d -> %d", store.m, m_new)
    return dataclasses.replace(
        store,
        indices=torch.nn.functional.pad(store.indices, (0, extra),
                                        value=store.d),
        values=torch.nn.functional.pad(store.values, (0, extra)))


def delete(store: IndexStore, slot_ids) -> IndexStore:
    """Tombstone slots; their data stays until ``compact``. Every id must
    lie in [0, capacity): checked on the host, since an index out of range
    on the card would end the CUDA context."""
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
    if (tombstone_fraction(store) > threshold
            and next_pow2(max(store.n_live, 1)) < store.capacity):
        return compact(store)
    return store, None


def compact(store: IndexStore) -> Tuple[IndexStore, np.ndarray]:
    """Rebuild a dense slot layout without the tombstones. Returns (new
    store, old_ids (new_cap,) int64 numpy): ``old_ids[j]`` is the previous
    slot of new slot j, −1 for an empty slot."""
    live = torch.nonzero(store.alive).flatten()
    n = live.numel()
    cap = next_pow2(max(n, 1))
    old_ids = np.full((cap,), -1, np.int64)
    old_ids[:n] = live.cpu().numpy()
    log.info("compacted index: %d live slots, capacity %d -> %d",
             n, store.capacity, cap)
    kw = dict(alive=torch.arange(cap, device=store.device) < n,
              prior_var=_take_pad(store.prior_var, live, cap))
    if store.kind == "sparse":
        kw.update(indices=_take_pad(store.indices, live, cap, store.d),
                  values=_take_pad(store.values, live, cap),
                  nnz=_take_pad(store.nnz, live, cap))
    else:
        kw.update(x=_take_pad(store.x, live, cap))
    return dataclasses.replace(store, **kw), old_ids


def _take_pad(arr: torch.Tensor, sl: torch.Tensor, cap: int,
              fill=0) -> torch.Tensor:
    """Rows ``sl`` of ``arr``, then ``fill`` up to ``cap`` rows: one gather
    into the new tensor (the tail gathers row 0 and is overwritten)."""
    n = sl.numel()
    taken = arr.index_select(0, torch.cat([sl, sl.new_zeros(cap - n)]))
    taken[n:] = fill
    return taken
