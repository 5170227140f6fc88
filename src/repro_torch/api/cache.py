"""Query LRU for the index handle (DESIGN.md §6.2), the port's own copy of
the reference's: the same key bytes for the same float32 row, so both
packages key a query alike. Keys are taken from host (numpy) rows, never
from a device tensor's storage.

Keys are the raw query bytes — only *exact* repeats hit and short-circuit
the race, which is the safe contract for a δ-PAC result. A *near* repeat
(cosine similarity to a cached query above a threshold) still races, but
``get_near`` hands the caller the cached neighbour's result so the race's
CI variance priors can be seeded from it (priors tighten early rounds
without faking evidence; see ``confidence.empirical_sigma_sq_prior``).

Namespacing (DESIGN.md §11.4): a fleet shares one cache across many
namespaces, so keys carry a namespace prefix (``ns + "\\x00" + bytes``) and
near-repeat lookups only scan vectors admitted under the *same* namespace —
two namespaces holding identical query vectors must never exchange rows or
priors. ``evict_namespace`` drops every entry of a dropped/evicted
namespace so a recreated namespace of the same name starts cold.

Zero-norm guard: cosine similarity divides by vector norms, so zero (or
non-finite) query vectors must MISS the near lookup rather than NaN-match,
and zero-norm vectors are never admitted to the near-match matrix.
"""
from __future__ import annotations

import collections
from typing import Optional

import numpy as np


class QueryCache:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self._od: collections.OrderedDict = collections.OrderedDict()
        self._vecs: collections.OrderedDict = collections.OrderedDict()
        self._vec_ns: dict = {}  # key -> namespace ("" for the default)
        self._mats: dict = {}  # namespace -> (keys, stacked unit vectors);
                               # rebuilt lazily after any mutation

    @staticmethod
    def key(row: np.ndarray, namespace: Optional[str] = None) -> bytes:
        """Cache key = namespace prefix + raw query bytes. Namespace names
        never contain NUL (validated at ``Fleet.create``), so the prefix
        cannot collide across namespaces or with the un-namespaced form."""
        prefix = (namespace or "").encode() + b"\x00"
        return prefix + np.ascontiguousarray(row, np.float32).tobytes()

    def get(self, key: bytes):
        hit = self._od.get(key)
        if hit is not None:
            self._od.move_to_end(key)
            self.hits += 1
            return hit
        self.misses += 1
        return None

    def get_near(self, row: np.ndarray, threshold: float,
                 namespace: Optional[str] = None):
        """Best cached entry *of this namespace* with cosine(row, cached
        query) ≥ threshold, or None. Called only on exact misses, so a match
        is a genuinely *near* (never identical-bytes) neighbour. O(entries·d)
        numpy scan — the cache is small by construction."""
        ns = namespace or ""
        if not self._vecs or threshold <= 0:
            return None
        norm = float(np.linalg.norm(row))
        if norm == 0.0 or not np.isfinite(norm):
            # a zero (or NaN/inf) query has no direction: dividing by its
            # norm would NaN-match — it must miss instead
            return None
        if ns not in self._mats:
            keys = [k for k in self._vecs if self._vec_ns.get(k, "") == ns]
            if not keys:
                return None
            self._mats[ns] = (keys, np.stack([self._vecs[k] for k in keys]))
        keys, mat = self._mats[ns]
        sims = mat @ (np.asarray(row, np.float32) / norm)
        j = int(np.argmax(sims))
        if not (sims[j] >= threshold):     # NaN compares False → miss
            return None
        return self._od[keys[j]]

    def put(self, key: bytes, value, vec: Optional[np.ndarray] = None,
            namespace: Optional[str] = None) -> None:
        ns = namespace or ""
        self._od[key] = value
        self._od.move_to_end(key)
        if vec is not None:
            norm = float(np.linalg.norm(vec))
            if norm > 0 and np.isfinite(norm):
                self._vecs[key] = np.asarray(vec, np.float32) / norm
                self._vecs.move_to_end(key)
                self._vec_ns[key] = ns
                self._mats.pop(ns, None)
        while len(self._od) > self.capacity:
            old, _ = self._od.popitem(last=False)
            if self._vecs.pop(old, None) is not None:
                self._mats.pop(self._vec_ns.pop(old, ""), None)

    def __len__(self) -> int:
        return len(self._od)

    def evict_namespace(self, namespace: Optional[str]) -> int:
        """Drop every entry belonging to ``namespace`` (the eviction hook a
        Fleet calls on drop/evict and an Index calls on its epoch fence).
        Returns the number of result entries removed."""
        prefix = (namespace or "").encode() + b"\x00"
        doomed = [k for k in self._od if k.startswith(prefix)]
        for k in doomed:
            del self._od[k]
            self._vecs.pop(k, None)
            self._vec_ns.pop(k, None)
        self._mats.pop(namespace or "", None)
        return len(doomed)

    def clear(self, namespace: Optional[str] = None) -> None:
        """Clear the whole cache, or — when the owner serves exactly one
        namespace — just that namespace's slice of a shared cache."""
        if namespace is not None:
            self.evict_namespace(namespace)
            return
        self._od.clear()
        self._vecs.clear()
        self._vec_ns.clear()
        self._mats.clear()
