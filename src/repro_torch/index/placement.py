"""Slot placement for the sharded index (DESIGN.md §5.1).

Global addressing is row-major over (shard, local slot): every shard owns the
same number of slots (the *stride*, the per-shard capacity, kept uniform
across shards so the addressing stays a pair of integer ops):

    global_id = shard * stride + local_slot

The stride changes only on a global growth, compaction or re-shard event,
and each of those returns an old→new global-id map (the ``mutable.compact``
contract) so side payloads can be reindexed.

Two placement policies cover build and steady-state insert traffic:

  * ``round_robin``: item i goes to shard ``(start + i) % S``; balanced for
    bulk builds and deterministic (the manifest round trip and re-shard
    rely on that),
  * ``least_loaded``: each item goes to the currently lightest shard (ties
    to the lowest shard id); the default for online inserts, where deletes
    have made the shards uneven.

The shard-id assignments are host-side numpy (the reference's integers);
the addressing functions take numpy arrays, tensors or ints alike.
"""
from __future__ import annotations

import numpy as np

PLACEMENTS = ("round_robin", "least_loaded")


def assign_round_robin(n_items: int, n_shards: int, *,
                       start: int = 0) -> np.ndarray:
    """(n_items,) shard ids, cycling from ``start``."""
    return ((start + np.arange(n_items)) % n_shards).astype(np.int32)


def assign_least_loaded(loads, n_items: int) -> np.ndarray:
    """(n_items,) shard ids, each item routed to the lightest shard
    (``loads`` = live counts per shard; ties go to the lower shard id)."""
    loads = np.asarray(loads, np.int64).copy()
    out = np.empty((n_items,), np.int32)
    for i in range(n_items):
        s = int(np.argmin(loads))
        out[i] = s
        loads[s] += 1
    return out


def assign(policy: str, loads, n_items: int) -> np.ndarray:
    if policy == "round_robin":
        # start the cycle at the lightest shard, so repeated small batches
        # do not all land on shard 0
        return assign_round_robin(n_items, len(loads),
                                  start=int(np.argmin(loads)))
    if policy == "least_loaded":
        return assign_least_loaded(loads, n_items)
    raise ValueError(f"unknown placement {policy!r} (want one of {PLACEMENTS})")


# -- global ↔ (shard, local) addressing -------------------------------------


def global_id(shard, local, stride: int):
    return shard * stride + local


def shard_of(gid, stride: int):
    return gid // stride


def local_of(gid, stride: int):
    return gid % stride


def balance(live_counts) -> float:
    """max/mean load imbalance (1.0 = balanced), as the sharded benchmarks
    and the engine's stats report it."""
    live = np.asarray(live_counts, np.float64)
    mean = live.mean()
    return float(live.max() / mean) if mean > 0 else 1.0
