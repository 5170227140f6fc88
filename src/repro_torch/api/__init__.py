"""repro_torch.api — the port's client surface: ``Index.build`` →
``Index.query`` with the typed ``QuerySpec`` → ``KNNResult`` protocol.

    from repro_torch.api import Index
    idx = Index.build(corpus, cfg)            # on the GPU
    res = idx.query(queries, k=10, delta=0.001)
"""
from repro_torch.api.handle import Index
from repro_torch.api.spec import KNNResult, QuerySpec

__all__ = ["Index", "KNNResult", "QuerySpec"]
