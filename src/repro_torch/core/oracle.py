"""Exact k-NN oracles (the paper's 'exact computation' baseline and the
judge of exactness): dense, and sparse (ℓ1, §IV-A)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.datasets import SparseDataset
from repro_torch.core.ucb import smallest_k
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops


class OracleResult(NamedTuple):
    indices: torch.Tensor    # (Q, k)
    values: torch.Tensor     # (Q, k) θ = ρ/d
    coord_ops: torch.Tensor  # () total coordinate-wise distance computations


def exact_knn(corpus, queries, k: int, metric: str = "l2", *,
              impl: str = "auto", batch: int = 256,
              device=None) -> OracleResult:
    """Brute force: the full (Q, n) distance matrix, ``batch`` queries at a
    time, and its k smallest entries per row (the lower index first among
    ties, as ``lax.top_k``). Costs Q·n·d. Runs on ``device`` (default: the
    GPU)."""
    dev = resolve_device(device)
    x = torch.as_tensor(corpus, dtype=torch.float32, device=dev)
    qs = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    Q, d = qs.shape
    n = x.shape[0]
    idx_out, val_out = [], []
    for s in range(0, Q, batch):
        dist = kops.pairwise_dist(qs[s:s + batch], x, metric=metric,
                                  impl=impl)
        idx = smallest_k(dist, k)
        idx_out.append(idx)
        val_out.append(torch.gather(dist, 1, idx) / d)
    return OracleResult(torch.cat(idx_out), torch.cat(val_out),
                        torch.tensor(float(Q) * n * d))


def densify(indices: torch.Tensor, values: torch.Tensor, d: int
            ) -> torch.Tensor:
    """(r, m) padded CSR rows → (r, d) dense fp32 rows (pads dropped)."""
    r = indices.shape[0]
    flat = torch.zeros(r * d + 1, dtype=torch.float32, device=values.device)
    rows = torch.arange(r, device=indices.device)[:, None] * d
    # every pad lands on the one spare element past the rows
    at = torch.where(indices < d, rows + indices, r * d)
    flat.scatter_(0, at.reshape(-1), values.reshape(-1).to(torch.float32))
    return flat[:r * d].view(r, d)


def sparse_l1(qs: torch.Tensor, indices: torch.Tensor, values: torch.Tensor,
              d: int, *, impl: str = "auto"):
    """``dist(s, e)`` for ``running_topk``: ℓ1 distances of the dense
    (Q, d) queries ``qs`` to rows [s, e) of a padded-CSR corpus, the rows
    scattered to (e − s, d) and held against the queries by
    ``pairwise_dist``."""
    def dist(s: int, e: int) -> torch.Tensor:
        return kops.pairwise_dist(qs, densify(indices[s:e], values[s:e], d),
                                  metric="l1", impl=impl)
    return dist


def running_topk(dist, n: int, Q: int, k: int, chunk: int, *, device,
                 alive: torch.Tensor | None = None,
                 served: torch.Tensor | None = None):
    """The min(k, n) smallest of the (Q, n) distances that ``dist(s, e)``
    gives for columns [s, e), ``chunk`` columns at a time, as a running
    top-k: (ids, distances), ascending, the lower column first among ties
    (the kept k come first and hold lower columns, and the sort is
    stable). ``alive`` (n,) bool reads dead columns as +inf. ``served``
    (Q, m) int64 column ids: their distances, read from the same chunks
    (+inf where an id is out of range or dead), come third; None without
    ``served``."""
    kk = min(k, n)
    best = torch.zeros((Q, 0), dtype=torch.float32, device=device)
    ids = torch.zeros((Q, 0), dtype=torch.int64, device=device)
    got = ok = None
    if served is not None:
        ok = (served >= 0) & (served < n)
        if alive is not None:
            ok &= alive[torch.where(ok, served, 0)]
        got = torch.full(served.shape, float("inf"), dtype=torch.float32,
                         device=device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        dd = dist(s, e)
        if alive is not None:
            dd = torch.where(alive[s:e][None, :], dd, float("inf"))
        if served is not None:
            here = ok & (served >= s) & (served < e)
            th = torch.gather(dd, 1, torch.where(here, served - s, 0))
            got = torch.where(here, th, got)
        cand = torch.cat([best, dd], 1)
        cand_ids = torch.cat([ids, torch.arange(s, e, device=device)
                              .expand(Q, -1)], 1)
        keep = smallest_k(cand, kk)
        best, ids = torch.gather(cand, 1, keep), torch.gather(cand_ids, 1,
                                                              keep)
    return ids, best, got


def exact_knn_sparse(ds: SparseDataset, q_idx, q_val, q_nnz, k: int, *,
                     impl: str = "auto", chunk: int = 8192,
                     device=None) -> OracleResult:
    """Exact ℓ1 k-NN of the (q_idx, q_val, q_nnz) padded queries against
    the sparse corpus: θ = ‖q − x‖₁/d, the k smallest per query, the lower
    index first among ties. Reports the reference's sparsity-aware cost,
    Σ_i (n_q + n_i) per query. Computes it densely: ``chunk`` corpus rows
    at a time are scattered to (chunk, d) and held against the densified
    queries by ``pairwise_dist`` (ℓ1), keeping a running top-k. Runs on
    ``device`` (default: the GPU)."""
    dev = resolve_device(device)
    ds = ds.to(dev)
    d, n = ds.d, ds.n
    qi = torch.as_tensor(q_idx, dtype=torch.int32, device=dev)
    qv = torch.as_tensor(q_val, dtype=torch.float32, device=dev)
    qn = torch.as_tensor(q_nnz, dtype=torch.int32, device=dev)
    Q = qi.shape[0]
    ids, best, _ = running_topk(
        sparse_l1(densify(qi, qv, d), ds.indices, ds.values, d, impl=impl),
        n, Q, k, chunk, device=dev)
    cost = (Q * torch.sum(ds.nnz, dtype=torch.float64)
            + torch.sum(qn, dtype=torch.float64) * n)
    return OracleResult(ids, best / best.new_tensor(float(d)),
                        cost.to(torch.float32))
