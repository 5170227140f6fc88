"""Synthetic data. LM side: deterministic Zipf-ish token streams keyed by
(seed, step, shard), the reference's ``lm_batch`` in numpy, bit for bit.

kNN side: corpora matched to the paper's two datasets (§V): a
Tiny-ImageNet-like clustered heavy-tail mixture (dense) and a
10x-Genomics-like corpus, ~7% nonzero with exponential magnitudes on
cluster-structured supports (sparse).

With ``device=None`` the generators are numpy and return the very arrays
the reference's ``repro.data.synthetic`` returns for the same seed. With a
``device`` they draw the same distribution with ``torch`` on that device
(from ``generator``, or one seeded with ``seed``) and return tensors there,
so a full-size corpus is made on the card in a moment instead of in numpy;
the sparse corpus comes as a ``SparseDataset``, never as a dense array.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.datasets import SparseDataset, place_rows


def lm_batch(vocab: int, batch: int, seq: int, *, seed: int, step: int,
             shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
    """Deterministic (tokens, labels) int32 batch; labels are the tokens
    shifted by one. A Zipf(1.3) marginal folded onto the vocabulary, with
    each position repeating the one before it with probability 0.3."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, shard, n_shards]))
    ranks = rng.zipf(1.3, size=(batch, seq + 1)) % vocab
    rep = rng.random((batch, seq + 1)) < 0.3
    ranks[:, 1:][rep[:, 1:]] = ranks[:, :-1][rep[:, 1:]]
    toks = ranks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def clustered_dense(n: int, d: int, *, n_clusters: int = 64,
                    noise: float = 0.15, heavy_tail: float = 1.0,
                    seed: int = 0, device=None,
                    generator: Optional[torch.Generator] = None):
    """Image-like corpus: cluster centers with per-point heavy-tailed scale.
    Most inter-point gaps are large (cheap to race); same-cluster points are
    the hard arms."""
    if device is None:
        rng = np.random.default_rng(seed)
        centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
        assign = rng.integers(0, n_clusters, n)
        scale = (1.0 + heavy_tail * rng.exponential(1.0, size=(n, 1))
                 ).astype(np.float32)
        pts = centers[assign] + noise * scale * rng.normal(
            size=(n, d)).astype(np.float32)
        return pts.astype(np.float32)
    g = generator if generator is not None else _seeded(seed, device)
    centers = torch.randn((n_clusters, d), generator=g, device=device)
    assign = torch.randint(0, n_clusters, (n,), generator=g, device=device)
    scale = 1.0 + heavy_tail * torch.empty((n, 1), device=device).exponential_(
        1.0, generator=g)
    pts = torch.randn((n, d), generator=g, device=device)
    pts.mul_(noise * scale).add_(centers[assign])   # in place: n·d is large
    return pts


# rows whose nonzeros a device draw compresses at once (int64 coordinates
# of about 2/3 of chunk · int(d·sparsity·1.5) entries)
CHUNK_ROWS = 16384


def clustered_sparse(n: int, d: int, *, sparsity: float = 0.07,
                     n_clusters: int = 32, seed: int = 0, device=None,
                     generator: Optional[torch.Generator] = None):
    """RNA-seq-like corpus: each of ``n_clusters`` clusters has a support of
    ``int(d·sparsity·1.5)`` coordinates; a row keeps each coordinate of its
    cluster's support with probability 2/3 (so ~``sparsity`` of d is
    nonzero), with Exponential(scale 2.0) values. numpy: the dense (n, d)
    array; on a device: the same law as a ``SparseDataset`` there, its rows
    compressed CHUNK_ROWS at a time."""
    if device is None:
        rng = np.random.default_rng(seed)
        out = np.zeros((n, d), np.float32)
        supports = [rng.choice(d, size=int(d * sparsity * 1.5), replace=False)
                    for _ in range(n_clusters)]
        for i in range(n):
            c = rng.integers(0, n_clusters)
            sup = supports[c]
            keep = rng.random(len(sup)) < (sparsity / (sparsity * 1.5))
            idx = sup[keep]
            out[i, idx] = rng.exponential(2.0, size=len(idx)).astype(
                np.float32)
        return out
    g = generator if generator is not None else _seeded(seed, device)
    width = int(d * sparsity * 1.5)
    supports = torch.sort(torch.argsort(torch.rand(
        (n_clusters, d), generator=g, device=device), dim=1)[:, :width],
        dim=1).values.to(torch.int32)
    assign = torch.randint(0, n_clusters, (n,), generator=g, device=device)
    keep = torch.rand((n, width), generator=g, device=device) < (
        sparsity / (sparsity * 1.5))
    nnz = torch.sum(keep, 1, dtype=torch.int32)
    m = max(int(nnz.max()) if n else 0, 1)
    indices = torch.full((n, m), d, dtype=torch.int32, device=device)
    values = torch.empty((n, m), device=device).exponential_(
        0.5, generator=g)                            # rate 1/2: scale 2.0
    for s in range(0, n, CHUNK_ROWS):
        r, c = torch.nonzero(keep[s:s + CHUNK_ROWS], as_tuple=True)
        place_rows(indices, None, s, r, nnz[s:s + CHUNK_ROWS],
                   supports[assign[s + r], c], None)
    values.masked_fill_(torch.arange(m, device=device) >= nnz[:, None], 0.0)
    return SparseDataset(indices=indices, values=values, nnz=nnz, d=d)


def make_knn_benchmark_data(kind: str, n: int, d: int, n_queries: int,
                            seed: int = 0, *, device=None,
                            generator: Optional[torch.Generator] = None
                            ) -> Tuple:
    """(corpus, queries): queries are perturbed corpus points (dense) or
    copies of corpus points (sparse); the paper queries points of the
    dataset itself. numpy: the reference's arrays. On a device, sparse:
    (a ``SparseDataset``, the (q_idx, q_val, q_nnz) padded triplet of the
    copied rows, as wide as their largest nnz)."""
    if kind not in ("dense", "sparse"):
        raise ValueError(f"unknown kind {kind!r}")
    if kind == "sparse":
        if device is None:
            rng = np.random.default_rng(seed + 1)
            corpus = clustered_sparse(n, d, seed=seed)
            qidx = rng.integers(0, n, n_queries)
            return corpus, corpus[qidx].copy()
        g = generator if generator is not None else _seeded(seed, device)
        corpus = clustered_sparse(n, d, device=device, generator=g)
        qidx = torch.randint(0, n, (n_queries,), generator=g, device=device)
        q_nnz = corpus.nnz[qidx]
        mq = max(int(q_nnz.max()) if n_queries else 0, 1)
        return corpus, (corpus.indices[qidx, :mq], corpus.values[qidx, :mq],
                        q_nnz)
    if device is None:
        rng = np.random.default_rng(seed + 1)
        corpus = clustered_dense(n, d, seed=seed)
        qidx = rng.integers(0, n, n_queries)
        queries = corpus[qidx] + 0.05 * rng.normal(
            size=(n_queries, d)).astype(np.float32)
        return corpus, queries.astype(np.float32)
    g = generator if generator is not None else _seeded(seed, device)
    corpus = clustered_dense(n, d, device=device, generator=g)
    qidx = torch.randint(0, n, (n_queries,), generator=g, device=device)
    queries = corpus[qidx] + 0.05 * torch.randn((n_queries, d), generator=g,
                                                device=device)
    return corpus, queries


def _seeded(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g
