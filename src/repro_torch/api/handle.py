"""``Index`` — the handle in front of the port's index (DESIGN.md §6.1):
build a single-shard dense or rotated index and query it through the typed
``QuerySpec`` protocol. Results come back in the reference's ``KNNResult``
schema."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.api.spec import KNNResult, QuerySpec
from repro_torch.device import make_generator
from repro_torch.index.batched_race import index_knn
from repro_torch.index.builder import build_index


class Index:
    """One handle over a single-shard racing index; the store underneath is
    reachable read-only as ``handle.store``."""

    def __init__(self, store):
        self._store = store
        self._auto_rng = 0

    @classmethod
    def build(cls, corpus, cfg, rng=0, *, capacity: Optional[int] = None,
              impl: str = "auto", device=None) -> "Index":
        """Preprocess ``corpus`` (n, d) into a served index on ``device``
        (default: the GPU; raises without one). ``rng`` is a seed or a
        ``torch.Generator`` on that device."""
        return cls(build_index(corpus, cfg, rng, capacity=capacity,
                               impl=impl, device=device))

    @property
    def store(self):
        return self._store

    @property
    def device(self):
        return self._store.device

    @property
    def cfg(self):
        return self._store.cfg

    def query(self, queries, rng=None, *, spec: Optional[QuerySpec] = None,
              **overrides) -> KNNResult:
        """Batched k-NN of a (Q, d) query array with the typed query
        protocol: a ``QuerySpec``, keyword overrides (``k=``, ``delta=``,
        ``mode=``, …), or both. ``rng`` is a seed or a ``torch.Generator``
        on the index's device; by default each call takes the next seed of
        a per-handle counter. Returns slot ids."""
        if spec is None:
            spec = QuerySpec(**overrides)
        elif overrides:
            spec = dataclasses.replace(spec, **overrides)
        store = self._store
        cfg = spec.bind(store.cfg)
        if cfg != store.cfg:      # k / δ / budget overrides
            store = dataclasses.replace(store, cfg=cfg)
        if rng is None:
            rng = self._auto_rng
            self._auto_rng += 1
        raw = index_knn(store, queries, make_generator(rng, self.device),
                        impl=spec.impl, eliminate=spec.eliminate,
                        warm_start=spec.warm_start, mode=spec.mode)
        return self._result(raw)

    @staticmethod
    def _result(raw) -> KNNResult:
        return KNNResult(indices=raw.indices.cpu().numpy(),
                         values=raw.values.cpu().numpy(),
                         coord_ops=raw.coord_ops.cpu().numpy(),
                         rounds=raw.rounds.cpu().numpy(),
                         n_exact=raw.n_exact.cpu().numpy())

    def __repr__(self) -> str:
        st = self._store
        return (f"Index(kind={st.kind!r}, live={st.n_live}/{st.capacity}, "
                f"k={st.cfg.k}, device={self.device})")
