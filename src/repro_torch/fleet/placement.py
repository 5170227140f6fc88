"""Namespace → device placement (DESIGN.md §11.2), the port's own copy of
the reference's planner: the same plan from the same footprints.

Every sharded namespace occupies a contiguous device window ``[offset,
offset + shards)`` (``ShardedIndexStore.device_offset``). ``plan_placement``
bin-packs namespaces onto the devices by live-row footprint: heaviest
namespace first, each at the window whose heaviest device stays lightest
(ties to the lowest offset), so the plan is deterministic and the manifest
round-trips it. Pure numpy: nothing here touches a device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def plan_placement(footprints: Dict[str, Tuple[int, int]],
                   n_devices: int) -> Dict[str, int]:
    """Greedy contiguous-window bin-packing of namespaces onto devices.

    ``footprints``: namespace → ``(n_shards, live_rows)``. Returns
    namespace → device offset. Namespaces are taken in (−live_rows, name)
    order and windows scanned low to high. A namespace with at least as
    many shards as there are devices is pinned at offset 0."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    load = np.zeros((n_devices,), np.float64)
    plan: Dict[str, int] = {}
    for ns in sorted(footprints, key=lambda ns: (-footprints[ns][1], ns)):
        shards, rows = footprints[ns]
        shards = max(1, int(shards))
        if shards >= n_devices:
            off, span = 0, n_devices
        else:
            share = rows / shards
            costs = [load[o:o + shards].max() + share
                     for o in range(n_devices - shards + 1)]
            off, span = int(np.argmin(costs)), shards
        plan[ns] = off
        load[off:off + span] += rows / span
    return plan


def device_load(footprints: Dict[str, Tuple[int, int]],
                plan: Dict[str, int], n_devices: int) -> np.ndarray:
    """(n_devices,) live rows per device under ``plan``."""
    load = np.zeros((n_devices,), np.float64)
    for ns, off in plan.items():
        shards, rows = footprints[ns]
        span = min(max(1, int(shards)), n_devices)
        load[off:off + span] += rows / span
    return load
