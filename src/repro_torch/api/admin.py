"""Admin operations on a live index handle (DESIGN.md §6.3).

``live_reshard`` re-shards a serving index in memory, without a save/load
cycle:

  1. **quiesce**: the handle's admin fence rejects mutations for the
     duration of the swap (``Index._admin_op``),
  2. **remap**: the live rows are redistributed over S′ shards by the
     deterministic uniform-stride remap the checkpoint path uses
     (``index/sharded.reshard``: round-robin in ascending old-global-id
     order), so the result is bit-identical to a save followed by a load
     at S′; the attached payload and build-row map follow the returned
     old→new global-id map,
  3. **swap under the epoch fence**: ``Index._swap`` installs the new
     store, bumps ``epoch``, clears the query cache (global ids moved) and
     drops materialized replicas (they are derived again lazily).

``add_replicas`` sets the read fan-out: the store is materialized on r
device slices (``ShardedIndexStore.device_offset``; a single-shard store
is copied to a device of its own) and ``Index.query`` round-robins batches
over them. Replicas are derived state: every mutation or re-shard drops
them, and the next query rebuilds them from the primary.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from repro_torch.index.sharded import (ShardedIndexStore, shard_devices,
                                       reshard as _reshard)

log = logging.getLogger("repro_torch.api")


def _cuda_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def live_reshard(handle, n_shards: int, *, device=None) -> np.ndarray:
    """Re-shard a live handle to ``n_shards`` without a save/load cycle.
    ``device`` places the new shards (``index.sharded.shard_devices``);
    by default a store whose shards share one device keeps it, and any
    other takes the first ``n_shards`` visible CUDA devices. Returns the
    old→new global-id map for external side state; the attached payload
    is already remapped."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    store = handle._store
    if not hasattr(store, "shards"):
        # a single-shard store is the S = 1 sharded store: one remap rule
        store = ShardedIndexStore([store])
    if device is None and len(set(store.devices)) == 1:
        device = store.devices[0]
    # place the new shards BEFORE touching the handle: an S′-shard store
    # without its devices would turn every later query into an outage,
    # while the old store keeps serving until the swap is viable
    try:
        devs = shard_devices(n_shards, device)
    except RuntimeError as e:
        raise RuntimeError(
            f"cannot live-reshard to {n_shards} shards: {e} — the handle "
            "keeps serving at the current shard count") from None
    with handle._admin_op("reshard"):
        old_s = store.n_shards
        new_store, old_ids = _reshard(store, n_shards, device=devs)
        handle._remap(old_ids)
        handle._swap(new_store)
        handle._reshards += 1
        log.info("live reshard: S=%d -> S=%d (epoch %d, %d live rows, "
                 "no checkpoint)", old_s, n_shards, handle.epoch,
                 new_store.n_live)
    return old_ids


def add_replicas(handle, n_replicas: int) -> int:
    """Set the handle's read fan-out. Replicas are placed lazily (by the
    first query after this call or after any mutation);
    ``materialize_replicas`` does the device work."""
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    handle._n_replicas = n_replicas
    handle._replica_stores = None
    log.info("read fan-out set to %d replica(s)", n_replicas)
    return n_replicas


def _copy_to(store, dev: torch.device):
    fields = ("alive", "x", "signs", "indices", "values", "nnz", "prior_var")
    return dataclasses.replace(store, **{
        f: getattr(store, f).to(dev) for f in fields
        if getattr(store, f) is not None})


def materialize_replicas(store, n_replicas: int):
    """Replica i of a sharded store lives on the CUDA devices
    [i·S, (i+1)·S); a single-shard store is copied to CUDA device i mod the
    device count. Where those devices are missing or are the primary's own
    (a CPU store, a store whose shards repeat one device, one card), the
    replica shares the primary's placement with a warning: the fan-out
    still round-robins, correct though not parallel."""
    visible = _cuda_count()
    out = [store]
    for i in range(1, n_replicas):
        if hasattr(store, "shards"):
            S = store.n_shards
            off = i * S
            on_cuda = all(d.type == "cuda" for d in store.devices)
            distinct = len(set(store.devices)) == S
            if on_cuda and distinct and off + S <= visible:
                devs = [torch.device("cuda", off + s) for s in range(S)]
                out.append(dataclasses.replace(
                    store, device_offset=off,
                    shards=[_copy_to(sh, dev)
                            for sh, dev in zip(store.shards, devs)]))
            else:
                log.warning(
                    "replica %d needs devices [%d, %d) but only %d CUDA "
                    "devices are visible or the shards share a device — "
                    "sharing the primary's placement", i, off, off + S,
                    visible)
                out.append(store)
        else:
            dev = (torch.device("cuda", i % visible)
                   if store.device.type == "cuda" and visible else
                   store.device)
            out.append(store if dev == store.device else _copy_to(store, dev))
    return out
