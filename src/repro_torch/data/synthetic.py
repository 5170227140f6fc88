"""Synthetic k-NN corpora matched to the paper's dense dataset (Tiny-ImageNet-
like: a clustered heavy-tail mixture, §V).

With ``device=None`` the generators are numpy and return the very arrays
the reference's ``repro.data.synthetic`` returns for the same seed. With a
``device`` they draw the same distribution with ``torch`` on that device
(from ``generator``, or one seeded with ``seed``) and return tensors there,
so a full-size corpus is made on the card in a moment instead of in numpy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


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


def make_knn_benchmark_data(kind: str, n: int, d: int, n_queries: int,
                            seed: int = 0, *, device=None,
                            generator: Optional[torch.Generator] = None
                            ) -> Tuple:
    """(corpus, queries): queries are perturbed corpus points (the paper
    queries points of the dataset itself). Dense only for now."""
    if kind != "dense":
        raise NotImplementedError(f"{kind!r} data is not ported yet")
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
