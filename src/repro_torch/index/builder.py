"""One-time index preprocessing (DESIGN.md §3.1): corpus → IndexStore.

  * dense:   blocked, padded, capacity-padded corpus layout,
  * rotated: the §IV-B Hadamard rotation is cached — the sign vector and
    the pre-rotated corpus are stored, so serving only rotates queries,
  * sparse:  the capacity-padded CSR layout (§IV-A box),
  * per-arm block statistics, the warm-start priors for the racing CIs.

Persistence goes through ``checkpoint/manager.py``'s atomic save, in the
reference's directory layout: an index saved by either package loads in the
other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.checkpoint import manager
from repro_torch.configs.base import BMOConfig
from repro_torch.core.datasets import SparseDataset, next_pow2
from repro_torch.core.datasets import rademacher as _rademacher
from repro_torch.device import make_generator, resolve_device
from repro_torch.index.store import IndexStore
from repro_torch.kernels import ops as kops


def _row_block_stats(x: torch.Tensor, block: int, metric: str):
    """Per-arm variance across blocks of the row's block values — the
    query-independent part of the pull-value variance."""
    n, d_pad = x.shape
    xb = x.reshape(n, d_pad // block, block)
    v = torch.mean(torch.abs(xb) if metric == "l1" else xb * xb, dim=-1)
    return torch.var(v, dim=-1, unbiased=False)


def _sparse_prior(values: torch.Tensor, nnz: torch.Tensor, d: int):
    """Eq. 12 pull values are (tot/2d)·(1+…)·|v|: scale the per-row value
    variance by the squared support mass so empty/light rows start tight."""
    mask = torch.arange(values.shape[1], device=values.device) < nnz[:, None]
    cnt = torch.clamp(nnz.to(torch.float32), min=1.0)
    mean = torch.sum(torch.abs(values) * mask, 1) / cnt
    var = torch.sum(torch.square(torch.abs(values) - mean[:, None]) * mask,
                    1) / cnt
    return var * (nnz.to(torch.float32) / d) ** 2


def build_index(corpus, cfg: BMOConfig, rng=0, *,
                capacity: Optional[int] = None, impl: str = "auto",
                device=None, signs: Optional[torch.Tensor] = None
                ) -> IndexStore:
    """Preprocess ``corpus`` into an IndexStore on ``device`` (default: the
    GPU). ``corpus``: a dense (n, d) numpy array or tensor, or, with
    ``cfg.sparse``, also a ``SparseDataset``. ``cfg.rotate`` and
    ``cfg.sparse`` select the §IV box; ``rng`` (a seed or a
    ``torch.Generator`` on the device) draws the rotated box's signs;
    ``signs`` (d_pad,) gives them instead (the shards of a sharded index
    share one rotation). ``capacity`` defaults to the next power of two."""
    dev = resolve_device(device)
    if cfg.sparse:
        return _build_sparse(corpus, cfg, capacity, dev)
    x = torch.as_tensor(corpus, dtype=torch.float32, device=dev)
    n, d = x.shape
    kind = "rotated" if cfg.rotate else "dense"
    given, signs = signs, None
    if cfg.rotate:
        if cfg.metric != "l2":
            raise ValueError("rotation preserves only ℓ2")
        if cfg.block & (cfg.block - 1):
            raise ValueError("the rotated box needs a power-of-two block")
        dp = max(next_pow2(d), cfg.block)
        x = torch.nn.functional.pad(x, (0, dp - d))
        signs = (_rademacher(dp, make_generator(rng, dev), dev)
                 if given is None else given[:dp].to(dev))
        x = kops.fwht(x * signs[None, :], impl=impl)
    # blocked layout
    pad = (-x.shape[1]) % cfg.block
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        if signs is not None:  # keep signs aligned with d_pad for queries
            signs = torch.nn.functional.pad(signs, (0, pad), value=1.0)
    cap = capacity or next_pow2(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < corpus rows {n}")
    if cap > n:
        x = torch.nn.functional.pad(x, (0, 0, 0, cap - n))
    alive = torch.arange(cap, device=dev) < n
    prior_var = _row_block_stats(x, cfg.block, cfg.metric)
    return IndexStore(kind=kind, cfg=cfg, d=d, alive=alive, x=x,
                      block=cfg.block, signs=signs, prior_var=prior_var)


def _build_sparse(corpus, cfg: BMOConfig, capacity: Optional[int],
                  dev: torch.device) -> IndexStore:
    ds = (corpus.to(dev) if isinstance(corpus, SparseDataset)
          else SparseDataset.build(corpus, device=dev))
    n, m, d = ds.n, ds.m, ds.d
    cap = capacity or next_pow2(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < corpus rows {n}")
    pad = cap - n
    indices = torch.cat([ds.indices, ds.indices.new_full((pad, m), d)])
    values = torch.nn.functional.pad(ds.values, (0, 0, 0, pad))
    nnz = torch.nn.functional.pad(ds.nnz, (0, pad))
    return IndexStore(kind="sparse", cfg=cfg, d=d,
                      alive=torch.arange(cap, device=dev) < n,
                      indices=indices, values=values, nnz=nnz,
                      prior_var=_sparse_prior(values, nnz, d))


# ---------------------------------------------------------------------------
# persistence (checkpoint/manager.py)
# ---------------------------------------------------------------------------


def save_index(store: IndexStore, path: str, *, extra=None) -> None:
    """Atomic write of the store's arrays and metadata. ``extra(tmpdir)``:
    an optional callback staging sidecars (the payload) into the same
    all-or-nothing publish."""
    manager.save(path, store.arrays(), meta=store.meta(), extra=extra)


def load_index(path: str, *, device=None) -> IndexStore:
    """The store saved at ``path``, on ``device`` (default: the GPU)."""
    return IndexStore.from_arrays(manager.load_arrays(path),
                                  manager.read_meta(path), device=device)
