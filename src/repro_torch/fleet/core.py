"""``Fleet`` — many named namespaces, one device set, one request plane
(DESIGN.md §11.1), the port of ``repro/fleet/core.py``.

A namespace is one ``repro_torch.api.Index`` (single-shard or sharded) and
its durable state under ``<root>/ns/<name>/`` (checkpoint, payload, tuned
sidecar). The fleet owns the routing table, an LRU residency set (at most
``max_resident`` namespaces materialized on the device; the rest live as
checkpoints and reload on their next touch), the shared namespace-keyed
``QueryCache`` and the placement plan of the sharded namespaces.

Serving goes through one shared ``RequestPlane``: ``fleet.serve()`` (or
``RequestPlane(router=fleet)``) and tickets with a ``namespace=`` label.
Admission fairness, the per-namespace ``max_queue`` and shedding key on
``(tenant, namespace)``, and the plane's ``namespace_load`` keeps the fleet
from evicting a namespace with tickets in flight. A plane's default index
(``serve(default=…)``) is pinned too: the plane holds that handle, so
evicting it would free nothing and leave two handles of one namespace.

Durability: ``create`` checkpoints a namespace at once, an eviction
re-checkpoints it only when its epoch moved since the last save (both
through the staged-directory publish of ``checkpoint/manager.py``), the
manifest (``fleet.json``) is rewritten atomically after every membership
or placement change, and ``Fleet.open(root)`` recovers the fleet without
materializing an index. The root's layout is the reference's: either
package opens the other's.

Devices: namespaces are built and reloaded onto the fleet's ``device``
(default: the current CUDA device; raises without one unless
``device="cpu"``). The plan (``placement.py``) gives each sharded namespace
a window of devices. Where the fleet was given no device and there are CUDA
devices for the whole window, the namespace's shards live on them
(``index.sharded.shard_devices(S, device_offset=off)``), and ``rebalance``
moves a resident namespace whose window moved onto its new devices through
the epoch fence. Otherwise (one card, an explicit device, the CPU) its
shards repeat the fleet's device: the offset is recorded in the store and
the manifest, and no tensor moves.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import re
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.api import Index
from repro_torch.api.cache import QueryCache
from repro_torch.device import resolve_device
from repro_torch.fleet.manifest import load_manifest, save_manifest
from repro_torch.fleet.placement import plan_placement
from repro_torch.index.sharded import (is_sharded_index_dir, read_manifest,
                                       shard_devices)

log = logging.getLogger("repro_torch.fleet")

#: file-system- and metric-label-safe names (no NUL, which the cache key
#: prefix relies on; no separators; no dot-prefixed traversal)
_NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,127}$")

NS_SUBDIR = "ns"


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet-level knobs, the reference's (per-namespace overrides ride
    ``create``)."""

    max_resident: int = 8          # namespaces materialized at once
    cache_capacity: int = 1024     # shared namespace-keyed query LRU
    default_max_queue: Optional[int] = None  # per-namespace admission
                                   # bound (None: the plane's max_queue)

    def __post_init__(self):
        if self.max_resident < 1:
            raise ValueError(
                f"max_resident must be >= 1, got {self.max_resident}")
        if self.cache_capacity < 0:
            raise ValueError(
                f"cache_capacity must be >= 0, got {self.cache_capacity}")


class _NsState(object):
    """Routing-table row: the index when materialized, and its record."""

    def __init__(self, name: str, meta: dict,
                 index: Optional[Index] = None):
        self.name = name
        self.meta = meta          # shards/device_offset/max_queue/n_live/kind
        self.index = index        # None while evicted (checkpoint on disk)
        self.last_used = 0        # fleet touch counter (LRU recency)
        self.saved_epoch = -1     # index epoch at the last checkpoint


class Fleet:
    """The namespace fleet. ``Fleet(root)`` starts a fleet or adopts the
    one at ``root``; ``Fleet.open(root)`` requires its manifest."""

    def __init__(self, root: str, config: Optional[FleetConfig] = None, *,
                 device=None):
        self.root = root
        self.config = config if config is not None else FleetConfig()
        self.device = resolve_device(device)
        # no device given: sharded namespaces may span distinct CUDA
        # devices (their placement windows)
        self._spread = device is None
        os.makedirs(os.path.join(root, NS_SUBDIR), exist_ok=True)
        self._ns: Dict[str, _NsState] = {}
        self._cache = (QueryCache(self.config.cache_capacity)
                       if self.config.cache_capacity > 0 else None)
        self._clock = 0           # monotone touch counter
        self._reloads = 0
        self._evictions = 0
        self.plane = None         # attached by RequestPlane(router=self)
        doc = load_manifest(root)
        if doc is not None:
            for name, rec in doc["namespaces"].items():
                self._ns[name] = _NsState(name, dict(rec))

    # -- constructors --------------------------------------------------------

    @classmethod
    def open(cls, root: str, config: Optional[FleetConfig] = None, *,
             device=None) -> "Fleet":
        """Recover a fleet from its root. Strict: a missing or invalid
        manifest raises. Namespaces materialize on their first touch."""
        if load_manifest(root) is None:
            raise FileNotFoundError(
                f"no fleet manifest at {root!r} — is this a fleet root?")
        return cls(root, config, device=device)

    # -- plumbing ------------------------------------------------------------

    def _dir(self, name: str) -> str:
        return os.path.join(self.root, NS_SUBDIR, name)

    def _check_name(self, name: str) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(
                f"bad namespace name {name!r} (want {_NAME_RE.pattern})")

    def _state(self, name: str) -> _NsState:
        st = self._ns.get(name)
        if st is None:
            raise KeyError(f"unknown namespace {name!r} "
                           f"(have {sorted(self._ns)})")
        return st

    def _touch(self, st: _NsState) -> None:
        self._clock += 1
        st.last_used = self._clock

    def _window(self, shards: int, offset: int):
        """Where a namespace of ``shards`` shards at device ``offset``
        lives: its own CUDA devices when the fleet may spread and they
        exist, else the fleet's device (repeated for every shard)."""
        if (shards > 1 and self._spread and self.device.type == "cuda"
                and torch.cuda.device_count() >= offset + shards):
            return shard_devices(shards, device_offset=offset)
        return self.device

    def _adopt(self, st: _NsState, index: Index) -> None:
        """Wire a materialized index into the fleet: the shared namespace-
        keyed query cache replaces the handle's own, so exact and near
        repeats stay warm across evict/reload while two namespaces never
        exchange rows (the key carries the namespace)."""
        index._cache = self._cache
        index._cache_ns = st.name
        st.index = index
        self._touch(st)

    def _manifest_records(self) -> dict:
        recs = {}
        for name, st in self._ns.items():
            meta = dict(st.meta)
            if st.index is not None:
                meta["n_live"] = int(st.index.n_live)
                meta["shards"] = int(st.index.n_shards)
                meta["kind"] = st.index.kind
            recs[name] = meta
        return recs

    def _save_manifest(self) -> None:
        save_manifest(self.root, self._manifest_records())

    def _checkpoint(self, st: _NsState) -> bool:
        """Save a resident namespace when its epoch moved since the last
        save (a clean one is already on disk, so its eviction is free)."""
        if st.index is None or st.saved_epoch == st.index.epoch:
            return False
        st.index.save(self._dir(st.name))
        st.saved_epoch = st.index.epoch
        st.meta["n_live"] = int(st.index.n_live)
        return True

    def _pinned(self, name: str) -> bool:
        """Tickets in flight on the attached plane, or the plane's default
        handle."""
        if self.plane is None:
            return False
        st = self._ns.get(name)
        return bool(self.plane.namespace_load().get(name)) or (
            st is not None and st.index is not None
            and self.plane.index is st.index)

    # -- lifecycle -----------------------------------------------------------

    def create(self, name: str, corpus, cfg, rng=0, *, shards: int = 1,
               payload=None, max_queue: Optional[int] = None,
               **build_kw) -> Index:
        """Build, register and checkpoint a namespace on the fleet's
        device. Build kwargs (``placement=``, ``capacity=``, ``impl=``, …)
        pass through to ``Index.build``. ``max_queue`` bounds this
        namespace's admission queue on the shared plane (None: the fleet's,
        else the plane's default)."""
        self._check_name(name)
        if name in self._ns:
            raise ValueError(f"namespace {name!r} already exists — "
                             "drop() it first")
        if self._cache is not None:
            # a crashed drop may have left stale cached rows
            self._cache.evict_namespace(name)
        index = Index.build(corpus, cfg, rng, shards=shards, payload=payload,
                            device=self._window(shards, 0), **build_kw)
        st = _NsState(name, {
            "shards": int(index.n_shards),
            "device_offset": 0,
            "max_queue": (max_queue if max_queue is not None
                          else self.config.default_max_queue),
            "n_live": int(index.n_live),
            "kind": index.kind,
        })
        self._adopt(st, index)
        self._ns[name] = st
        self._checkpoint(st)       # durable from birth: open() can see it
        self._save_manifest()
        self._maybe_evict(exclude=name)
        return index

    def get(self, name: str) -> Index:
        """The namespace's ``Index``, reloaded from its checkpoint when it
        was evicted; bumps its LRU recency."""
        return self.resolve(name)

    def resolve(self, name: str) -> Index:
        """Router hook for ``RequestPlane``: the contract of ``get``."""
        st = self._state(name)
        if st.index is None:
            self._reload(st)
        else:
            self._touch(st)
        return st.index

    def peek(self, name: str) -> Optional[Index]:
        """The index if resident, else None; never reloads, never touches."""
        return self._state(name).index

    def drop(self, name: str) -> None:
        """Remove a namespace: its routing entry, its directory and its
        slice of the shared cache (a namespace created again under the name
        starts cold)."""
        st = self._state(name)
        if self.plane is not None and self.plane.namespace_load().get(name):
            raise RuntimeError(
                f"namespace {name!r} has in-flight tickets — drain before "
                "drop()")
        del self._ns[name]
        st.index = None
        if self._cache is not None:
            self._cache.evict_namespace(name)
        shutil.rmtree(self._dir(name), ignore_errors=True)
        self._save_manifest()

    # -- residency / eviction ------------------------------------------------

    @property
    def namespaces(self) -> List[str]:
        return sorted(self._ns)

    @property
    def resident(self) -> List[str]:
        return sorted(n for n, s in self._ns.items() if s.index is not None)

    @property
    def resident_count(self) -> int:
        return sum(1 for s in self._ns.values() if s.index is not None)

    @property
    def evicted_count(self) -> int:
        return len(self._ns) - self.resident_count

    @property
    def reload_count(self) -> int:
        return self._reloads

    @property
    def eviction_count(self) -> int:
        return self._evictions

    def namespace_max_queue(self, name: str) -> Optional[int]:
        """The namespace's admission bound on the shared plane (router
        hook); None defers to the plane's ``max_queue``."""
        st = self._ns.get(name)
        return None if st is None else st.meta.get("max_queue")

    def evict(self, name: str) -> bool:
        """Checkpoint and free one namespace. Refused (False) when it is
        already cold or pinned by the attached plane (``_pinned``). The
        shared cache keeps its entries: the reload restores the same store,
        so they stay valid (``drop`` purges them)."""
        st = self._state(name)
        if st.index is None or self._pinned(name):
            return False
        self._checkpoint(st)
        st.index = None
        self._evictions += 1
        self._save_manifest()
        log.info("evicted namespace %r (resident=%d/%d)", name,
                 self.resident_count, self.config.max_resident)
        return True

    def _maybe_evict(self, exclude: Optional[str] = None) -> int:
        """LRU-evict until at most ``max_resident`` namespaces are
        materialized, skipping pinned ones and ``exclude`` (the namespace
        that triggered the scan)."""
        evicted = 0
        while self.resident_count > self.config.max_resident:
            cands = sorted(
                (s for s in self._ns.values()
                 if s.index is not None and s.name != exclude),
                key=lambda s: s.last_used)
            for st in cands:
                if self.evict(st.name):
                    evicted += 1
                    break
            else:                   # everything resident is pinned
                break
        return evicted

    def enforce_residency(self) -> int:
        """Run the LRU scan again; returns how many namespaces it freed.
        The plane materializes a namespace at ``submit`` and never lets one
        with tickets in flight go, so cold traffic can push the resident
        set past ``max_resident`` until those tickets drain: serve loops
        call this between steps."""
        return self._maybe_evict()

    def _reload(self, st: _NsState) -> None:
        """Materialize an evicted namespace from its checkpoint (payload
        and tuned sidecar ride ``Index.load``) onto its placement, and
        rejoin the residency set (possibly evicting the coldest other)."""
        path = self._dir(st.name)
        off = int(st.meta.get("device_offset", 0))
        shards = (int(read_manifest(path)["n_shards"])
                  if is_sharded_index_dir(path) else 1)
        index = Index.load(path, device=self._window(shards, off))
        if off and index.sharded:
            # a fresh handle: placement binds before any launch, no fence
            index._store = dataclasses.replace(index._store,
                                               device_offset=off)
        self._adopt(st, index)
        st.saved_epoch = index.epoch
        self._reloads += 1
        log.info("reloaded namespace %r (n_live=%d)", st.name, index.n_live)
        self._maybe_evict(exclude=st.name)

    # -- placement -----------------------------------------------------------

    def footprints(self) -> Dict[str, tuple]:
        """namespace → (n_shards, live_rows), from the index when resident,
        else from the manifest record."""
        out = {}
        for name, st in self._ns.items():
            if st.index is not None:
                out[name] = (st.index.n_shards, int(st.index.n_live))
            else:
                out[name] = (int(st.meta.get("shards", 1)),
                             int(st.meta.get("n_live", 0)))
        return out

    def rebalance(self, n_devices: Optional[int] = None) -> Dict[str, int]:
        """Plan placement again by live-row footprint over ``n_devices``
        (default: the CUDA device count; on the CPU the caller passes it)
        and apply it. A resident sharded namespace whose window moved swaps
        in its store at the new offset through the epoch fence: moved onto
        the window's devices where the namespace spans distinct CUDA
        devices, else with the offset recorded and no tensor moved (see the
        module docstring). Cold namespaces take their offset at reload.
        Returns the plan; shard counts change only through ``reshard``."""
        if n_devices is None:
            if self.device.type != "cuda":
                raise ValueError("rebalance() on the CPU needs n_devices")
            n_devices = torch.cuda.device_count()
        plan = plan_placement(self.footprints(), n_devices)
        for name, off in plan.items():
            st = self._ns[name]
            if st.meta.get("device_offset", 0) == off:
                continue
            st.meta["device_offset"] = off
            if st.index is not None and st.index.sharded:
                st.index._swap(self._placed(st.index.store, off))
        self._save_manifest()
        return plan

    def _placed(self, store, off: int):
        """``store`` at device offset ``off``: its shards copied onto the
        window's devices when it has distinct ones, else as they are."""
        devs = self._window(store.n_shards, off)
        if isinstance(devs, list) and devs != store.devices:
            from repro_torch.api.admin import _copy_to
            return dataclasses.replace(
                store, device_offset=off,
                shards=[_copy_to(sh, dev)
                        for sh, dev in zip(store.shards, devs)])
        return dataclasses.replace(store, device_offset=off)

    def reshard(self, name: str, n_shards: int) -> np.ndarray:
        """Change one namespace's shard count (``Index.reshard``, live, on
        the namespace's placement). Returns the old→new global-id map."""
        st = self._state(name)
        index = self.resolve(name)
        old_ids = index.reshard(n_shards, device=self._window(
            n_shards, int(st.meta.get("device_offset", 0))))
        st.meta["shards"] = int(index.n_shards)
        self._save_manifest()
        return old_ids

    # -- serving / persistence -----------------------------------------------

    def serve(self, config=None, *, obs=None, default: Optional[str] = None):
        """One shared ``RequestPlane`` over every namespace (tickets carry
        ``namespace=``), attached as the fleet's eviction guard.
        ``default=`` binds that namespace's handle as the plane's default
        index: un-namespaced tickets route to it, and it stays resident
        while the plane holds it."""
        from repro_torch.serve.plane import RequestPlane
        index = self.get(default) if default is not None else None
        return RequestPlane(index, config=config, obs=obs, router=self)

    def attach_plane(self, plane) -> None:
        """Called by ``RequestPlane(router=self)``: wires the plane's
        ``namespace_load`` into eviction."""
        self.plane = plane

    def flush(self) -> int:
        """Checkpoint every dirty resident namespace and the manifest
        (shutdown path). Returns the namespaces written."""
        wrote = sum(1 for st in self._ns.values() if self._checkpoint(st))
        self._save_manifest()
        return wrote

    def stats(self) -> dict:
        """Fleet rollup (the ``health_snapshot`` fleet section)."""
        return {
            "namespaces": len(self._ns),
            "resident": self.resident_count,
            "evicted": self.evicted_count,
            "reloads": self._reloads,
            "evictions": self._evictions,
            "max_resident": self.config.max_resident,
            "cache_entries": (len(self._cache)
                              if self._cache is not None else 0),
            "ns_queue_depth": (self.plane.ns_queue_depth()
                               if self.plane is not None else {}),
        }

    def __contains__(self, name: str) -> bool:
        return name in self._ns

    def __len__(self) -> int:
        return len(self._ns)

    def __repr__(self) -> str:
        return (f"Fleet(root={self.root!r}, namespaces={len(self._ns)}, "
                f"resident={self.resident_count}/"
                f"{self.config.max_resident}, device={self.device})")
