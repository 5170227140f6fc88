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
    qs = densify(qi, qv, d)
    best = torch.zeros((Q, 0), dtype=torch.float32, device=dev)
    ids = torch.zeros((Q, 0), dtype=torch.int64, device=dev)
    for s in range(0, n, chunk):
        x = densify(ds.indices[s:s + chunk], ds.values[s:s + chunk], d)
        dist = kops.pairwise_dist(qs, x, metric="l1", impl=impl)
        del x
        # the kept k come first and hold lower indices: a stable sort keeps
        # the lower index first among ties
        cand = torch.cat([best, dist], 1)
        cand_ids = torch.cat([ids, torch.arange(
            s, s + dist.shape[1], device=dev).expand(Q, -1)], 1)
        keep = smallest_k(cand, k)
        best, ids = torch.gather(cand, 1, keep), torch.gather(cand_ids, 1,
                                                              keep)
    cost = (Q * torch.sum(ds.nnz, dtype=torch.float64)
            + torch.sum(qn, dtype=torch.float64) * n)
    return OracleResult(ids, best / best.new_tensor(float(d)),
                        cost.to(torch.float32))
