"""Store signatures — the cache key of a tuned configuration
(DESIGN.md §9.2), the reference's record.

A tuned config is only as good as the workload it was raced on. The
signature captures every store property that moves the cost landscape the
racer optimized over — corpus scale (pow2-bucketed, so inserts don't
invalidate a tuning until the scale actually doubles), dimensionality,
dtype, box kind (dense / rotated / sparse), the backing device, the shard
count, and the corpus block width. Two stores with equal signatures share
a tuned config; a signature mismatch at load time means the sidecar was
tuned for a different workload and is ignored (the index serves its
build-time defaults) rather than half-applied.

The fields and their spelling are the reference's, so a ``tuned.json``
written by either package validates in the other: ``dtype`` is written as
the reference writes it ("float32", not "torch.float32"), and ``backend``
is "cuda" for a store on the card and "cpu" for one on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.core.datasets import next_pow2

#: bump when the signature fields change — old sidecars then fail closed.
SIGNATURE_SCHEME = 1


@dataclasses.dataclass(frozen=True)
class StoreSignature:
    scheme: int       # SIGNATURE_SCHEME at write time
    n_bucket: int     # next_pow2(n_live): scale bucket, insert-stable
    d: int            # corpus dimensionality (pre-padding)
    dtype: str        # corpus dtype ("float32", "bfloat16", …)
    kind: str         # dense | rotated | sparse
    backend: str      # the store's device type at tune time (cuda / cpu)
    shards: int       # shard count (1 = single shard)
    block: int        # corpus block width the kernels pull at

    def key(self) -> tuple:
        return dataclasses.astuple(self)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StoreSignature":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: d[k] for k in fields})


def backend_of(store) -> str:
    """The signature's ``backend``: the type of the device the store's
    arrays live on ("cuda" or "cpu")."""
    return store.device.type


def signature_of(store, backend: str = "") -> StoreSignature:
    """Signature of an ``IndexStore`` or ``ShardedIndexStore`` as served
    (``backend`` defaults to the store's device type)."""
    leaf = store.shards[0] if hasattr(store, "shards") else store
    arr = leaf.x if leaf.x is not None else leaf.values
    return StoreSignature(
        scheme=SIGNATURE_SCHEME,
        n_bucket=next_pow2(max(store.n_live, 1)),
        d=store.d,
        dtype=str(arr.dtype).replace("torch.", ""),
        kind=store.kind,
        backend=backend or backend_of(store),
        shards=store.n_shards if hasattr(store, "shards") else 1,
        block=store.block,
    )
