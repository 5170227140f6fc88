"""One racing index spread over S shards (DESIGN.md §5).

The paper's O((n+d)·log²(nd/δ)) bound is per machine; past one device the
slot axis of the ``IndexStore`` is partitioned over S shards and raced
shard-locally:

  * **Devices.** A shard lives on a torch device; the store holds one
    device a shard. By default they are the first S visible CUDA devices
    from ``device_offset`` (the reference's 1-D mesh over the first S
    devices). A caller may pass the list, and a device may repeat: that is
    how S shards run on one card, or on the CPU in the tests (the
    reference inflates its CPU device count instead). Where every shard
    sits on one device, a dense or rotated store keeps its rows in ONE
    (S, stride, d_pad) tensor and each shard's ``x`` is a view of it.
  * **Addressing** (``placement.py``): every shard owns ``stride`` slots
    and ``global_id = shard · stride + local_slot``. The stride is uniform
    across shards and changes only on global growth, compaction or
    re-shard, each of which returns an old→new global-id map (the
    ``mutable.compact`` contract) for payload reindexing.
  * **Racing.** Each shard races its own slots and certifies its own local
    top-k, launching its own kernels. Dense and rotated stores run the
    epoch-fused driver with one host epoch loop shared by the shards: a
    fused launch per racing shard an epoch, shard-local survivor compaction
    at a common bucket width, and a cross-shard pull-budget reallocator
    (the fused round count R scales with the global pull budget over the
    total surviving work, so a shard that has certified hands its share to
    the shards still racing). One host sync an epoch carries every shard's
    survivor counts, done flags, coordinate reads and pull bound. Sparse
    stores, and dense ones with ``mode="rounds"``, run the per-round driver
    shard by shard.
  * **Merge.** θ is a per-coordinate average, so the global top-k lies in
    the union of the per-shard certified top-ks. Each shard exact-evaluates
    its ≤ k winners (an ordering certificate within a shard says little
    about how its estimates compare with another shard's), the (values,
    global ids) of every shard are gathered on the first shard's device and
    one top-k reduce finishes the query; that gather is the reference's
    ``all_gather``. A shard with fewer than k live slots certifies its
    whole live set and pads its contribution with +inf values.

Failure budget: the per-round drivers race at δ/S; the fused driver takes
δ′ at the global slot count S·stride. Either way the per-interval budget is
the single-shard union bound over S·stride slots.

Scale: the pulls estimate ρ/d_pad, and every exact evaluation here is on
that scale too, the merge's included; reported values are × d_pad/d. The
reference divides its sharded exact evaluations by the true d and loses
recall when d_pad ≠ d (ROADMAP.md, Queue 3 item 2).

Lifecycle: ``build_sharded_index`` (round-robin or least-loaded placement),
``sharded_insert`` (each row to the least-loaded shard, uniform growth),
``sharded_delete`` (tombstones), ``sharded_maybe_compact`` (the global
threshold policy), and persistence as per-shard checkpoint directories
plus a manifest, in the reference's layout: either package reads the
other's, and a store saved at S loads at S′ (``reshard``).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import manager, msgpack_lite
from repro_torch.configs.base import BMOConfig
from repro_torch.core import confidence as conf
from repro_torch.core.bmo_nn import (BlockSampler, CoordSampler,
                                     default_block_sampler,
                                     default_coord_sampler,
                                     sparse_exact_theta, sparse_queries)
from repro_torch.core.datasets import SparseDataset, next_pow2
from repro_torch.core.ucb import INF, smallest_k
from repro_torch.device import make_generator
from repro_torch.index import mutable
from repro_torch.index import placement as plc
from repro_torch.index.batched_race import (_dense_exact_theta, _frontier_ci,
                                            _fused_epoch_step, _fused_init,
                                            _sparse_index_knn,
                                            local_dense_race)
from repro_torch.index.builder import build_index
from repro_torch.index.frontier import (FrontierState, bucket_width,
                                        compact_frontier, floor_width,
                                        pow2_floor)
from repro_torch.index.mutable import _grow_rows, _take_pad, _widen_sparse
from repro_torch.index.store import IndexStore
from repro_torch.obs import get_obs
from repro_torch.obs import profile as obs_profile
from repro_torch.utils.hostsync import host_fetch

log = logging.getLogger("repro_torch.index")

MANIFEST = "manifest.msgpack"


class ShardedKNNResult(NamedTuple):
    """``KNNResult``'s fields, with global slot ids, and the per-shard
    counters the engine reports as ``knn_shard_*`` stats."""
    indices: torch.Tensor          # (Q, k) global slot ids
    values: torch.Tensor           # (Q, k) ascending θ
    coord_ops: torch.Tensor        # (Q,) summed over shards
    rounds: torch.Tensor           # (Q,) max over shards
    n_exact: torch.Tensor          # (Q,) summed over shards
    shard_coord_ops: torch.Tensor  # (S,) coordinate ops per shard
    shard_rounds: torch.Tensor     # (S,) max rounds per shard


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------


def shard_devices(n_shards: int, device=None, *,
                  device_offset: int = 0) -> List[torch.device]:
    """The device of each of ``n_shards`` shards. ``device``: None for the
    first ``n_shards`` visible CUDA devices from ``device_offset`` (raises
    when there are fewer), one device for every shard on it, or a list of
    one device a shard (repeats allowed)."""
    if n_shards < 1:
        raise ValueError(f"shards must be >= 1, got {n_shards}")
    if isinstance(device, (list, tuple)):
        devs = [torch.device(d) for d in device]
        if len(devs) != n_shards:
            raise ValueError(f"{len(devs)} devices for {n_shards} shards")
        return devs
    if device is not None:
        return [torch.device(device)] * n_shards
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    hi = device_offset + n_shards
    if visible < hi:
        raise RuntimeError(
            f"{n_shards} index shards at device offset {device_offset} need "
            f"{hi} devices but only {visible} CUDA devices are visible — "
            "pass the shards' devices explicitly (a device may repeat, e.g. "
            f"device=['cuda:0'] * {n_shards} or device='cpu')")
    return [torch.device("cuda", i) for i in range(device_offset, hi)]


def _one_device(devices: Sequence[torch.device]) -> bool:
    return all(d == devices[0] for d in devices)


def _new_stack(n_shards: int, stride: int, d_pad: int, kind: str,
               devices: Sequence[torch.device]) -> Optional[torch.Tensor]:
    """One (S, stride, d_pad) tensor for a dense or rotated store whose
    shards share a device, else None (each shard keeps its own rows)."""
    if kind == "sparse" or not _one_device(devices):
        return None
    return torch.empty((n_shards, stride, d_pad), dtype=torch.float32,
                       device=devices[0])


def _place_x(stack: Optional[torch.Tensor], s: int,
             x: torch.Tensor) -> torch.Tensor:
    """Shard s's rows: copied into slice s of ``stack`` (the view is
    returned, and ``x`` may be freed), or ``x`` itself."""
    if stack is None:
        return x
    stack[s].copy_(x)
    return stack[s]


def _restack(shards: List[IndexStore]) -> List[IndexStore]:
    """Shards whose rows sit in one stacked tensor again, after a mutation
    gave some of them rows of their own; unchanged when they already do,
    are sparse, or live on more than one device."""
    devs = [s.device for s in shards]
    if shards[0].kind == "sparse" or not _one_device(devs):
        return shards
    base = shards[0].x._base
    if (base is not None and base.dim() == 3
            and base.shape[0] == len(shards)
            and all(s.x._base is base and s.x.data_ptr() == base[i].data_ptr()
                    for i, s in enumerate(shards))):
        return shards
    stack = _new_stack(len(shards), shards[0].capacity, shards[0].d_pad,
                       shards[0].kind, devs)
    out = list(shards)
    for i in range(len(out)):
        out[i] = dataclasses.replace(out[i], x=_place_x(stack, i, out[i].x))
    return out


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedIndexStore:
    """S per-shard ``IndexStore``s with one capacity (the stride): one
    logical index. Immutable like ``IndexStore``: every mutation builds a
    new instance."""
    shards: List[IndexStore]
    placement: str = "round_robin"
    device_offset: int = 0    # first visible device of this placement —
                              # read replicas (api/admin.py) place copies
                              # of the shards on disjoint device slices

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def stride(self) -> int:
        return self.shards[0].capacity

    @property
    def capacity(self) -> int:
        return self.n_shards * self.stride

    @property
    def n_live(self) -> int:
        return sum(s.n_live for s in self.shards)

    @property
    def kind(self) -> str:
        return self.shards[0].kind

    @property
    def cfg(self) -> BMOConfig:
        return self.shards[0].cfg

    @property
    def d(self) -> int:
        return self.shards[0].d

    @property
    def d_pad(self) -> int:
        return self.shards[0].d_pad

    @property
    def m(self) -> int:
        return self.shards[0].m

    @property
    def block(self) -> int:
        return self.shards[0].block

    @property
    def signs(self) -> Optional[torch.Tensor]:
        return self.shards[0].signs

    @property
    def prior_weight(self) -> float:
        return self.shards[0].prior_weight

    @property
    def devices(self) -> List[torch.device]:
        return [s.device for s in self.shards]

    @property
    def device(self) -> torch.device:
        """The first shard's device, where results are merged."""
        return self.shards[0].device

    @property
    def prior_var(self) -> torch.Tensor:
        """(capacity,) per-arm priors in global-id order (shard-major), on
        the first shard's device."""
        return torch.cat([s.prior_var.to(self.device) for s in self.shards])

    @property
    def alive(self) -> torch.Tensor:
        """(capacity,) tombstone mask in global-id order."""
        return torch.cat([s.alive.to(self.device) for s in self.shards])

    @property
    def live_per_shard(self) -> List[int]:
        return [s.n_live for s in self.shards]

    @property
    def stacked_x(self) -> Optional[torch.Tensor]:
        """The (S, stride, d_pad) tensor whose slices are the shards' rows,
        or None where the shards do not share one."""
        if self.kind == "sparse":
            return None
        base = self.shards[0].x._base
        if (base is not None and base.dim() == 3
                and all(s.x._base is base for s in self.shards)):
            return base
        return None

    def prepare_queries(self, queries, impl: str = "auto") -> torch.Tensor:
        """Pad (and rotate: the shards share one rotation) a (Q, d) batch
        on the first shard's device."""
        return self.shards[0].prepare_queries(queries, impl=impl)

    def query(self, queries, generator=None, *, k=None, impl: str = "auto"):
        return sharded_index_knn(self, queries, generator, k=k, impl=impl)


def rows_of(store, ids: torch.Tensor) -> torch.Tensor:
    """The stored (d_pad-wide) rows of slot or global ids ``ids`` of a
    dense or rotated store, single-shard or sharded, on its (first
    shard's) device."""
    if not hasattr(store, "shards"):
        return store.x[ids]
    stride = store.stride
    out = torch.empty((ids.shape[0], store.d_pad), dtype=torch.float32,
                      device=store.device)
    for s, shard in enumerate(store.shards):
        mine = (ids // stride) == s
        local = (ids[mine] % stride).to(shard.device)
        out[mine] = shard.x[local].to(out.device)
    return out


def with_cfg(store, cfg: BMOConfig):
    """``store`` with its racing config rebound (every shard's, for a
    sharded store), arrays untouched."""
    if hasattr(store, "shards"):
        return dataclasses.replace(
            store, shards=[dataclasses.replace(s, cfg=cfg)
                           for s in store.shards])
    return dataclasses.replace(store, cfg=cfg)


# ---------------------------------------------------------------------------
# build / mutate
# ---------------------------------------------------------------------------


def _rows(corpus, rows: np.ndarray):
    if isinstance(corpus, torch.Tensor):
        return corpus.index_select(
            0, torch.from_numpy(rows).to(corpus.device))
    return corpus[rows]


def build_sharded_index(corpus, cfg: BMOConfig, rng=0, *, shards: int,
                        placement: str = "round_robin",
                        capacity: Optional[int] = None, impl: str = "auto",
                        device=None, device_offset: int = 0
                        ) -> Tuple[ShardedIndexStore, np.ndarray]:
    """Partition ``corpus`` (n, d; numpy or a tensor) over ``shards``
    per-shard stores on ``device`` (``shard_devices``). Returns ``(store,
    global_ids)`` with ``global_ids[i]`` the global slot of corpus row i.
    ``capacity``: total slots, split evenly; default the next power of two
    of the heaviest shard. All shards share one rotation, drawn once from
    ``rng`` (a seed or a ``torch.Generator``)."""
    n = corpus.shape[0]
    devs = shard_devices(shards, device, device_offset=device_offset)
    sid = plc.assign(placement, np.zeros(shards, np.int64), n)
    rows_of = [np.nonzero(sid == s)[0] for s in range(shards)]
    per_cap = (capacity // shards if capacity
               else next_pow2(max(1, max(len(r) for r in rows_of))))
    stores: List[IndexStore] = []
    stack = None
    for s, rows in enumerate(rows_of):
        st = build_index(_rows(corpus, rows), cfg,
                         rng if s == 0 else 0, capacity=per_cap, impl=impl,
                         device=devs[s],
                         signs=None if s == 0 else stores[0].signs)
        if s == 0:
            stack = _new_stack(shards, per_cap, st.d_pad if st.x is not None
                               else 0, st.kind, devs)
        if stack is not None:
            st = dataclasses.replace(st, x=_place_x(stack, s, st.x))
        stores.append(st)
    if cfg.sparse:                     # one padded-CSR width across shards
        m_max = max(s.m for s in stores)
        stores = [_widen_sparse(s, m_max) for s in stores]
    gids = np.empty((n,), np.int64)
    for s, rows in enumerate(rows_of):
        gids[rows] = s * per_cap + np.arange(len(rows))
    log.info("built sharded %s index: n=%d shards=%d stride=%d (%s)",
             stores[0].kind, n, shards, per_cap, placement)
    return (ShardedIndexStore(stores, placement, device_offset=device_offset),
            gids)


def _grow_to(shard: IndexStore, cap: int) -> IndexStore:
    """Pad one shard to an exact capacity (uniform-stride growth)."""
    extra = cap - shard.capacity
    if extra <= 0:
        return shard
    return _grow_rows(shard, extra)


def _stride_remap(S: int, old_stride: int, new_stride: int) -> np.ndarray:
    """old→new global-id map for a stride change (the compact contract:
    ``old_ids[new_gid]`` is the previous gid, −1 where no slot existed)."""
    old_ids = np.full((S * new_stride,), -1, np.int64)
    keep = min(old_stride, new_stride)
    for s in range(S):
        old_ids[s * new_stride: s * new_stride + keep] = \
            s * old_stride + np.arange(keep)
    return old_ids


def sharded_insert(store: ShardedIndexStore, rows
                   ) -> Tuple[ShardedIndexStore, np.ndarray,
                              Optional[np.ndarray]]:
    """Insert (B, d) dense rows, each routed to the least-loaded shard.
    Returns ``(store, global_ids (B,), old_ids)``: ``old_ids`` is None
    unless a shard's growth changed the stride, and then it is the global
    old→new slot map (reindex payloads with it before using the new
    ids)."""
    if isinstance(rows, torch.Tensor):
        rows = rows.to(torch.float32)
    else:
        rows = np.asarray(rows, np.float32)
    if rows.ndim == 1:
        rows = rows[None]
    bsz = rows.shape[0]
    S, old_stride = store.n_shards, store.stride
    sid = plc.assign_least_loaded(store.live_per_shard, bsz)
    shards = list(store.shards)
    local_slots = np.empty((bsz,), np.int64)
    for s in sorted(set(sid.tolist())):
        mask = sid == s
        shards[s], slots = mutable.insert(shards[s], _rows(rows,
                                                           np.nonzero(mask)[0]))
        local_slots[mask] = slots
    new_stride = max(s.capacity for s in shards)
    if new_stride != old_stride:
        shards = [_grow_to(s, new_stride) for s in shards]
    if store.kind == "sparse":
        m_max = max(s.m for s in shards)
        shards = [_widen_sparse(s, m_max) for s in shards]
    gids = sid.astype(np.int64) * new_stride + local_slots
    old_ids = (None if new_stride == old_stride
               else _stride_remap(S, old_stride, new_stride))
    if old_ids is not None:
        log.info("sharded index stride grew %d -> %d (global-id remap)",
                 old_stride, new_stride)
    return (dataclasses.replace(store, shards=_restack(shards)), gids,
            old_ids)


def sharded_delete(store: ShardedIndexStore, global_ids) -> ShardedIndexStore:
    """Tombstone global slots (O(1) a shard). Every id must lie in
    [0, capacity)."""
    gids = np.atleast_1d(np.asarray(global_ids, np.int64))
    if gids.size and (gids.min() < 0 or gids.max() >= store.capacity):
        raise ValueError(f"global ids must lie in [0, {store.capacity}), "
                         f"got [{gids.min()}, {gids.max()}]")
    stride = store.stride
    shards = list(store.shards)
    for s in np.unique(gids // stride):
        shards[s] = mutable.delete(shards[s],
                                   gids[gids // stride == s] % stride)
    return dataclasses.replace(store, shards=shards)


def tombstone_fraction(store: ShardedIndexStore) -> float:
    return 1.0 - store.n_live / max(store.capacity, 1)


def _compacted_shard(shard: IndexStore, live: torch.Tensor, cap: int,
                     stack: Optional[torch.Tensor], s: int) -> IndexStore:
    """Shard ``shard`` with the rows ``live`` packed to the front of ``cap``
    slots (its rows into slice s of ``stack`` where there is one)."""
    kw = dict(alive=torch.arange(cap, device=shard.device) < live.numel(),
              prior_var=_take_pad(shard.prior_var, live, cap))
    if shard.kind == "sparse":
        kw.update(indices=_take_pad(shard.indices, live, cap, shard.d),
                  values=_take_pad(shard.values, live, cap),
                  nnz=_take_pad(shard.nnz, live, cap))
    else:
        kw.update(x=_place_x(stack, s, _take_pad(shard.x, live, cap)))
    return dataclasses.replace(shard, **kw)


def sharded_compact(store: ShardedIndexStore
                    ) -> Tuple[ShardedIndexStore, np.ndarray]:
    """Rebuild every shard's slot layout without its tombstones, at one
    (uniform-stride) capacity. Returns (store, old_ids) with the global
    old→new slot map (−1 for empty slots)."""
    S, old_stride = store.n_shards, store.stride
    live = [torch.nonzero(s.alive).flatten() for s in store.shards]
    counts = [int(l.numel()) for l in live]
    new_stride = max(1, next_pow2(max(1, max(counts))))
    stack = _new_stack(S, new_stride, store.d_pad if store.kind != "sparse"
                       else 0, store.kind, store.devices)
    shards = []
    old_ids = np.full((S * new_stride,), -1, np.int64)
    for s, (shard, sl) in enumerate(zip(store.shards, live)):
        shards.append(_compacted_shard(shard, sl, new_stride, stack, s))
        old_ids[s * new_stride: s * new_stride + counts[s]] = \
            s * old_stride + sl.cpu().numpy()
    log.info("compacted sharded index: stride %d -> %d (%d live)",
             old_stride, new_stride, store.n_live)
    return dataclasses.replace(store, shards=shards), old_ids


def sharded_maybe_compact(store: ShardedIndexStore, *,
                          threshold: float = 0.5
                          ) -> Tuple[ShardedIndexStore, Optional[np.ndarray]]:
    """The global compaction policy (``mutable.maybe_compact``'s contract
    over the sharded store): rebuild only when the global tombstone
    fraction crosses ``threshold`` and the uniform stride would shrink."""
    if (store.capacity and tombstone_fraction(store) > threshold
            and next_pow2(max(max(store.live_per_shard), 1)) < store.stride):
        return sharded_compact(store)
    return store, None


# ---------------------------------------------------------------------------
# persistence: per-shard checkpoints + manifest, re-shard on load
# ---------------------------------------------------------------------------


def save_sharded_index(store: ShardedIndexStore, path: str, *,
                       extra=None) -> None:
    """``path/shard_%04d/`` (the single-shard checkpoint layout, one a
    shard) and ``path/manifest.msgpack``, staged in a sibling and published
    with one rename (``manager.staged_dir``) with any ``extra(tmp)``
    sidecars: a crash mid-save leaves the previous index whole."""
    with manager.staged_dir(path) as tmp:
        for s, shard in enumerate(store.shards):
            manager.save(os.path.join(tmp, f"shard_{s:04d}"),
                         shard.arrays(), meta=shard.meta())
        manifest = {
            "version": 1,
            "n_shards": store.n_shards,
            "stride": store.stride,
            "placement": store.placement,
            "kind": store.kind,
            "live_per_shard": store.live_per_shard,
            "capacities": [s.capacity for s in store.shards],
        }
        with open(os.path.join(tmp, MANIFEST), "wb") as f:
            f.write(msgpack_lite.packb(manifest))
        if extra is not None:
            extra(tmp)


def is_sharded_index_dir(path: str) -> bool:
    return os.path.exists(os.path.join(path, MANIFEST))


def read_manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST), "rb") as f:
        return msgpack_lite.unpackb(f.read())


def load_sharded_index(path: str, *, shards: Optional[int] = None,
                       device=None
                       ) -> Tuple[ShardedIndexStore, Optional[np.ndarray]]:
    """Load a saved sharded index onto ``device`` (``shard_devices``);
    ``shards=S′`` re-shards on the way in, from the host copy of the saved
    arrays, so the S-shard store never sits on the device. Returns
    ``(store, old_ids)``: ``old_ids`` is None when the shard count is
    unchanged, else the old→new global-id map (compact contract)."""
    manifest = read_manifest(path)
    S0 = int(manifest["n_shards"])
    placement = manifest.get("placement", "round_robin")
    S = S0 if shards is None else shards
    devs = shard_devices(S, device)
    host = S != S0
    stack = None
    stores = []
    for s in range(S0):
        sdir = os.path.join(path, f"shard_{s:04d}")
        arrays, meta = manager.load_arrays(sdir), manager.read_meta(sdir)
        x = arrays.pop("x", None)
        st = IndexStore.from_arrays(arrays, meta,
                                    device="cpu" if host else devs[s])
        if x is not None:
            x = torch.from_numpy(x)
            if s == 0 and not host:
                stack = _new_stack(S0, x.shape[0], x.shape[1], st.kind, devs)
            if not host:
                x = (x.to(devs[s]) if stack is None
                     else _place_x(stack, s, x))
            st = dataclasses.replace(st, x=x)
        stores.append(st)
    store = ShardedIndexStore(stores, placement)
    if not host:
        return store, None
    return reshard(store, S, device=devs)


def reshard(store: ShardedIndexStore, n_shards: int, *, device=None
            ) -> Tuple[ShardedIndexStore, np.ndarray]:
    """Redistribute the live rows of ``store`` over ``n_shards`` shards on
    ``device`` (``shard_devices``; default: the store's one device repeated
    where its shards share one, else the first visible CUDA devices):
    round-robin in ascending old-global-id order, so an S→S′→S round trip
    is the identity on row data. Per-slot arrays move untouched, and the
    rotation is not redrawn. Returns ``(store, old_ids)`` with the global
    old→new slot map."""
    S0, stride0 = store.n_shards, store.stride
    if device is None and _one_device(store.devices):
        device = store.devices[0]
    devs = shard_devices(n_shards, device)
    alive = np.concatenate([s.alive.cpu().numpy() for s in store.shards])
    old_gids = np.nonzero(alive)[0]               # ascending global ids
    n = len(old_gids)
    sid = plc.assign_round_robin(n, n_shards)
    counts = np.bincount(sid, minlength=n_shards)
    new_stride = max(1, next_pow2(max(1, int(counts.max(initial=1)))))
    proto = store.shards[0]
    names = (("indices", "values", "nnz") if store.kind == "sparse"
             else ("x",)) + ("prior_var",)
    stack = _new_stack(n_shards, new_stride,
                       proto.d_pad if store.kind != "sparse" else 0,
                       store.kind, devs)
    shards = []
    old_ids = np.full((n_shards * new_stride,), -1, np.int64)
    for t in range(n_shards):
        src = old_gids[sid == t]                  # ascending
        dev = devs[t]
        kw = dict(alive=torch.arange(new_stride, device=dev) < len(src))
        for name in names:
            like = getattr(proto, name)
            fill = proto.d if name == "indices" else 0
            if name == "x" and stack is not None:
                out = stack[t]
                out[len(src):] = 0
            else:
                out = torch.full((new_stride,) + tuple(like.shape[1:]), fill,
                                 dtype=like.dtype, device=dev)
            at = 0
            # the ascending ids run through the old shards in order: one
            # gather a contributing old shard
            for s in range(S0):
                part = src[(src // stride0) == s] % stride0
                if len(part):
                    arr = getattr(store.shards[s], name)
                    out[at:at + len(part)] = arr.index_select(
                        0, torch.from_numpy(part).to(arr.device)).to(dev)
                    at += len(part)
            kw[name] = out
        if proto.signs is not None:
            kw["signs"] = proto.signs.to(dev)
        shards.append(dataclasses.replace(proto, **kw))
        old_ids[t * new_stride: t * new_stride + len(src)] = src
    log.info("re-sharded index: %d shards (stride %d) -> %d shards "
             "(stride %d), %d live rows", S0, stride0, n_shards, new_stride,
             n)
    return ShardedIndexStore(shards, store.placement), old_ids


# ---------------------------------------------------------------------------
# racing: shard-local races + the certified merge
# ---------------------------------------------------------------------------


def merge_local_topk(vals: torch.Tensor, gids: torch.Tensor, k: int):
    """Reduce the (D, Q, k) per-shard certified top-ks to the global (Q, k)
    top-k (indices, ascending values); invalid entries arrive as +inf.
    Ties go to the lower shard and position, as the reference's
    ``lax.top_k`` over the gathered (Q, D·k) row."""
    D, Q, _ = vals.shape
    v = vals.permute(1, 0, 2).reshape(Q, D * k)
    g = gids.permute(1, 0, 2).reshape(Q, D * k)
    pos = smallest_k(v, k)
    return torch.gather(g, 1, pos), torch.gather(v, 1, pos)


def guard_local_topk(indices, values, alive):
    """Mask junk entries of a shard-local top-k before the merge: a shard
    with fewer than k live slots fills its missing entries from its dead
    (pre-rejected) padding, and elimination never rejects a live arm while
    fewer than k live candidates exist, so deadness is exactly the junk
    test. Their values become +inf, which the merge drops."""
    return torch.where(alive[indices.long()], values, INF)


def _shard_delta(cfg: BMOConfig, S: int) -> BMOConfig:
    """δ/S per shard-local race, so δ′ = δ/(S·stride·MAX_PULLS) per
    interval: the single-shard driver's union bound over S·stride slots."""
    return dataclasses.replace(cfg, delta=conf.shard_delta(cfg.delta, S))


def _finish_local(vals, gids, coord_ops, rounds, n_exact, k: int,
                  scale: float) -> ShardedKNNResult:
    """Merge the per-shard (Q, k) results on the first shard's device and
    reduce the per-query and per-shard counters, every driver's last step.
    ``scale`` takes the merged values from the race's scale to θ."""
    dev = vals[0].device
    stack = lambda ts: torch.stack([t.to(dev) for t in ts])   # noqa: E731
    v, g = stack(vals), stack(gids)
    co, ro, ne = stack(coord_ops), stack(rounds), stack(n_exact)
    idx, merged = merge_local_topk(v, g, k)
    return ShardedKNNResult(
        indices=idx, values=merged * scale, coord_ops=torch.sum(co, 0),
        rounds=torch.amax(ro, 0), n_exact=torch.sum(ne, 0),
        shard_coord_ops=torch.sum(co, 1), shard_rounds=torch.amax(ro, 1))


def shard_priors(store: ShardedIndexStore, prior_hint, Q: int):
    """Each shard's priors: its build-time (stride,) ones, or its (Q,
    stride) slice of a (Q, capacity) global per-query hint."""
    if prior_hint is None:
        return [s.prior_var for s in store.shards]
    hint = torch.as_tensor(prior_hint, dtype=torch.float32)
    S, stride = store.n_shards, store.stride
    hint = hint.reshape(Q, S, stride)
    return [hint[:, s].to(sh.device) for s, sh in enumerate(store.shards)]


def shard_samplers(generator, devices: Sequence[torch.device], make):
    """One sampler a shard from ``generator`` (a seed or a
    ``torch.Generator`` on the first device), made by ``make(generator,
    device)``: one shared generator where the shards share a device, else
    one generator a device, seeded from ``generator``."""
    gen0 = make_generator(0 if generator is None else generator, devices[0])
    if _one_device(devices):
        shared = make(gen0, devices[0])
        return [shared] * len(devices)
    seeds = torch.randint(0, 2 ** 62, (len(devices),), generator=gen0,
                          device=devices[0]).tolist()
    return [make(make_generator(sd, dev), dev)
            for sd, dev in zip(seeds, devices)]


def _rounds_dense(store: ShardedIndexStore, qs, priors, samplers, *,
                  cfg: BMOConfig, impl: str, eliminate: bool,
                  prior_weight: float) -> ShardedKNNResult:
    S, stride, d = store.n_shards, store.stride, store.d
    cfg_s = _shard_delta(cfg, S)
    vals, gids, coord, rounds, n_exact = [], [], [], [], []
    for s, shard in enumerate(store.shards):
        q = qs.to(shard.device)
        res = local_dense_race([shard.x], [q], shard.alive, priors[s],
                               [samplers[s]], cfg=cfg_s, block=shard.block,
                               exact_cost=float(d), impl=impl,
                               eliminate=eliminate, prior_weight=prior_weight)
        exact_vals = _dense_exact_theta(shard.x, q, res.indices, cfg.metric,
                                        shard.d_pad)
        vals.append(guard_local_topk(res.indices, exact_vals, shard.alive))
        gids.append(s * stride + res.indices.to(torch.int64))
        coord.append(res.coord_ops + float(cfg.k * d))
        rounds.append(res.rounds)
        n_exact.append(res.n_exact)
    return _finish_local(vals, gids, coord, rounds, n_exact, cfg.k,
                         store.d_pad / d)


def _rounds_sparse(store: ShardedIndexStore, queries, priors, samplers, *,
                   cfg: BMOConfig, eliminate: bool,
                   prior_weight: float) -> ShardedKNNResult:
    S, stride, d = store.n_shards, store.stride, store.d
    cfg_s = _shard_delta(cfg, S)
    q_idx, q_val, q_nnz = queries
    vals, gids, coord, rounds, n_exact = [], [], [], [], []
    for s, shard in enumerate(store.shards):
        dev = shard.device
        res = _sparse_index_knn(
            shard.indices, shard.values, shard.nnz, shard.alive, priors[s],
            q_idx, q_val, q_nnz, samplers[s], cfg=cfg_s, d=d,
            eliminate=eliminate, prior_weight=prior_weight)
        ds = SparseDataset(indices=shard.indices, values=shard.values,
                           nnz=shard.nnz, d=d)
        qs = sparse_queries(q_idx, q_val, q_nnz, d, dev)
        exact_vals = sparse_exact_theta(ds, qs, res.indices)
        vals.append(guard_local_topk(res.indices, exact_vals, shard.alive))
        gids.append(s * stride + res.indices.to(torch.int64))
        coord.append(res.coord_ops + torch.sum(
            shard.nnz[res.indices.long()].to(torch.float32)
            + qs.nnz[:, None].to(torch.float32), 1))
        rounds.append(res.rounds)
        n_exact.append(res.n_exact)
    return _finish_local(vals, gids, coord, rounds, n_exact, cfg.k, 1.0)


# -- epoch-fused sharded driver ---------------------------------------------


class FusedPlan(NamedTuple):
    """The shared host loop's constants (the reference's, at the global
    slot count)."""
    log_term: float
    R0: int
    R_cap: int
    floor_w: int
    max_rounds: int
    nb: int
    T0: int


def fused_plan(store: ShardedIndexStore, cfg: BMOConfig) -> FusedPlan:
    S, stride = store.n_shards, store.stride
    nb = store.d_pad // store.block
    P = cfg.pulls_per_round
    B0 = min(cfg.batch_arms, stride)
    return FusedPlan(
        # δ′ at the GLOBAL slot count: the per-arm budget of the
        # single-shard fused driver over the same corpus
        log_term=math.log(2.0 / conf.delta_prime(cfg.delta, S * stride, nb)),
        R0=max(cfg.epoch_rounds, 1), R_cap=max(1, -(-nb // P)),
        floor_w=floor_width(cfg, stride, B0=B0),
        max_rounds=cfg.max_rounds or int(
            2 * math.ceil(stride * nb / max(B0 * P, 1)) + stride + 16),
        nb=nb, T0=max(1, max(cfg.init_pulls, 2) // P) * P)


def realloc_R(plan: FusedPlan, W0: int, n_surv: np.ndarray,
              active: np.ndarray) -> int:
    """The cross-shard pull-budget reallocator: the epoch's budget is
    S·W0·R0 pulls, and R fuses enough rounds to spend it over the total
    surviving work, so a certified shard's share flows to the shards still
    racing. With S = 1 it is the single-shard rule R0·max(1, W0/need),
    power-of-two quantized."""
    S = n_surv.shape[0]
    total_need = sum(int(n_surv[s][active[s]].max(initial=0))
                     for s in range(S))
    return min(plan.R0 * pow2_floor((S * W0) // max(total_need, 1)),
               plan.R_cap)


def fused_epoch(store: ShardedIndexStore, qs_of, states, pools, samplers,
                host_prev: np.ndarray, *, cfg: BMOConfig, plan: FusedPlan,
                R: int, impl: str, eliminate: bool, prior_weight: float):
    """One shared epoch: a fused launch on every shard with a query still
    racing (``host_prev``, the last sync, says which; a shard whose
    queries are all done would change nothing). Returns (states, each
    shard's packed (survivor counts, done flags, coordinate reads, pull
    bound) on the first shard's device or None where it was not stepped);
    ``take_hosts`` reads them back after the epoch's one sync."""
    T = R * cfg.pulls_per_round
    Q = qs_of[0].shape[0]
    states = list(states)
    hosts = []
    for s, shard in enumerate(store.shards):
        if (host_prev[s, Q:2 * Q] > 0).all():
            hosts.append(None)
            continue
        states[s], h = _fused_epoch_step(
            shard.x, qs_of[s], states[s], pools[s], samplers[s], cfg=cfg,
            block=shard.block, d=shard.d, impl=impl, eliminate=eliminate,
            prior_weight=prior_weight, log_term=plan.log_term, T=T,
            may_cross=float(host_prev[s, -1]) + T >= plan.nb)
        hosts.append(h.to(store.device))
    return states, hosts


def take_hosts(host_prev: np.ndarray, hosts, fetched) -> np.ndarray:
    """The (S, 2Q + 2) host view after an epoch: the fetched rows of the
    stepped shards, the previous rows (with no coordinate reads) of the
    others."""
    Q = (host_prev.shape[1] - 2) // 2
    host = host_prev.copy()
    host[:, 2 * Q] = 0.0
    it = iter(fetched)
    for s, h in enumerate(hosts):
        if h is not None:
            host[s] = next(it)
    return host


def _fused_finalize(shard: IndexStore, q, st: FrontierState, pool, *,
                    cfg: BMOConfig, log_term: float, prior_weight: float):
    """One shard's certified local top-k, exact-evaluated on the pulls'
    scale, with junk entries (only possible below k live slots) at +inf."""
    k = cfg.k
    ci = _frontier_ci(st, cfg, log_term, pool, prior_weight)
    score = torch.where(st.accepted & st.valid, st.mean - 1e9,
                        torch.where(st.rejected | ~st.valid, INF,
                                    st.mean - ci))
    pos = smallest_k(score, k)                            # (Q, k)
    slots = torch.gather(st.ids, 1, pos)
    vals = _dense_exact_theta(shard.x, q, slots, cfg.metric, shard.d_pad)
    ok = torch.gather(score, 1, pos) < INF
    return slots, torch.where(ok, vals, INF)


def fused_init(store: ShardedIndexStore, qs_of, priors, samplers, *,
               cfg: BMOConfig, plan: FusedPlan, impl: str,
               prior_weight: float):
    """Every shard's wide init; returns (states, pools, host (S, 2Q + 2))
    with the init's survivor counts and pull bound (no sync: the counts
    are the stride and T0)."""
    states, pools = [], []
    for s, shard in enumerate(store.shards):
        st, pool = _fused_init(shard.x, qs_of[s], shard.alive, priors[s],
                               samplers[s], cfg=cfg, block=shard.block,
                               impl=impl, prior_weight=prior_weight)
        states.append(st)
        pools.append(pool)
    S, Q = store.n_shards, qs_of[0].shape[0]
    host = np.zeros((S, 2 * Q + 2))
    host[:, :Q] = store.stride
    host[:, -1] = plan.T0
    return states, pools, host


def _sharded_fused_race(store: ShardedIndexStore, qs, priors, samplers, *,
                        cfg: BMOConfig, impl: str, eliminate: bool,
                        prior_weight: float) -> ShardedKNNResult:
    """The epoch-fused race run shard-locally with the host epoch loop
    shared across shards (DESIGN.md §5.2). Records each epoch's wall time
    as ``repro_race_epoch_ms{kind="sharded_fused_blocking"}`` and its
    ``fused_epoch_pull`` launches, as the reference does."""
    S, stride = store.n_shards, store.stride
    Q = qs.shape[0]
    plan = fused_plan(store, cfg)
    qs_of = [qs.to(s.device) for s in store.shards]
    states, pools, host = fused_init(store, qs_of, priors, samplers, cfg=cfg,
                                     plan=plan, impl=impl,
                                     prior_weight=prior_weight)
    W0 = states[0].width
    rounds_spent = 0
    obs = get_obs()
    epoch_ms = obs.registry.histogram(
        "repro_race_epoch_ms", "wall time of one race epoch (ms)",
        kind="sharded_fused_blocking")
    while True:
        n_surv = host[:, :Q].astype(np.int64)
        done = host[:, Q:2 * Q] > 0
        if done.all() or rounds_spent >= plan.max_rounds:
            break
        active = ~done
        need = int(n_surv[active].max(initial=1))
        W = states[0].width
        W_new = bucket_width(need, floor=plan.floor_w, current=W)
        if W_new < W:
            states = [compact_frontier(st, W_new=W_new) for st in states]
        R = realloc_R(plan, W0, n_surv, active)
        t0 = time.perf_counter()
        with obs_profile.annotate("repro.race.epoch.sharded_fused_blocking"):
            states, hosts = fused_epoch(
                store, qs_of, states, pools, samplers, host, cfg=cfg,
                plan=plan, R=R, impl=impl, eliminate=eliminate,
                prior_weight=prior_weight)
            # the epoch's one sync: every stepped shard's packed vector
            stepped = [h for h in hosts if h is not None]
            host = take_hosts(host, hosts, host_fetch(tuple(stepped)))
        rounds_spent += R
        epoch_ms.observe((time.perf_counter() - t0) * 1e3)
        obs_profile.record_kernel_launch(
            obs, "fused_epoch_pull", launches=len(stepped),
            coord_ops=float(np.sum(host[:, 2 * Q])), pulls=float(R))

    vals, gids, coord, rounds, n_exact = [], [], [], [], []
    for s, shard in enumerate(store.shards):
        st = states[s]
        slots, v = _fused_finalize(shard, qs_of[s], st, pools[s], cfg=cfg,
                                   log_term=plan.log_term,
                                   prior_weight=prior_weight)
        vals.append(v)
        gids.append(s * stride + slots.to(torch.int64))
        coord.append(st.coord_ops + float(cfg.k * store.d))
        rounds.append(st.rounds)
        n_exact.append(st.n_exact)
    return _finish_local(vals, gids, coord, rounds, n_exact, cfg.k,
                         store.d_pad / store.d)


# ---------------------------------------------------------------------------
# front end
# ---------------------------------------------------------------------------


def sharded_index_knn(store: ShardedIndexStore, queries, generator=None, *,
                      k=None, impl: str = "auto", eliminate: bool = True,
                      warm_start: bool = True, mode: str = "auto",
                      prior_hint=None,
                      block_samplers: Optional[Sequence[BlockSampler]] = None,
                      coord_samplers: Optional[Sequence[CoordSampler]] = None
                      ) -> ShardedKNNResult:
    """Batched k-NN against a ``ShardedIndexStore``: shard-local races and
    the certified merge. ``index_knn``'s contract (it dispatches here),
    with global slot ids in the result. ``generator`` (a seed or a
    ``torch.Generator``) feeds the default samplers (``shard_samplers``);
    ``block_samplers`` / ``coord_samplers`` give shard s's sampler at s."""
    cfg = store.cfg if k is None else dataclasses.replace(store.cfg, k=k)
    n_live = store.n_live
    if cfg.k > n_live:
        raise ValueError(
            f"k={cfg.k} exceeds the index's {n_live} live slots — "
            "tombstoned slots can never be returned")
    if mode not in ("auto", "fused", "rounds"):
        raise ValueError(f"unknown mode {mode!r}")
    Q = (queries[0] if isinstance(queries, tuple) else queries).shape[0]
    w = store.prior_weight if (warm_start or prior_hint is not None) else 0.0
    priors = shard_priors(store, prior_hint, Q)
    if store.kind == "sparse":
        if mode == "fused":
            raise ValueError("the fused epoch driver pulls corpus blocks — "
                             "sparse boxes race on the per-round driver")
        if coord_samplers is None:
            coord_samplers = shard_samplers(generator, store.devices,
                                            default_coord_sampler)
        return _rounds_sparse(store, queries, priors, coord_samplers,
                              cfg=cfg, eliminate=eliminate, prior_weight=w)
    if block_samplers is None:
        block_samplers = shard_samplers(generator, store.devices,
                                        default_block_sampler)
    qs = store.prepare_queries(queries, impl=impl)
    if mode == "rounds":
        return _rounds_dense(store, qs, priors, block_samplers, cfg=cfg,
                             impl=impl, eliminate=eliminate, prior_weight=w)
    return _sharded_fused_race(store, qs, priors, block_samplers, cfg=cfg,
                               impl=impl, eliminate=eliminate,
                               prior_weight=w)


__all__ = ["MANIFEST", "ShardedIndexStore", "ShardedKNNResult",
           "build_sharded_index", "guard_local_topk", "is_sharded_index_dir",
           "load_sharded_index", "local_dense_race", "merge_local_topk",
           "read_manifest", "reshard", "save_sharded_index", "shard_devices",
           "sharded_compact", "sharded_delete", "sharded_index_knn",
           "sharded_insert", "sharded_maybe_compact", "tombstone_fraction",
           "with_cfg"]
