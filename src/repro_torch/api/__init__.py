"""repro_torch.api — the port's client surface: ``Index.build`` /
``Index.load`` / ``Index.open`` → ``Index.query`` with the typed
``QuerySpec`` → ``KNNResult`` protocol; ``insert``, ``delete``,
``compact`` / ``maybe_compact`` (``CompactionPolicy``) and ``save``.

    from repro_torch.api import Index
    idx = Index.build(corpus, cfg)            # on the GPU
    res = idx.query(queries, k=10, delta=0.001)
    idx.insert(rows); idx.delete(slots); idx.maybe_compact()
    idx.save(path); idx = Index.load(path)    # the reference's layout
"""
from repro_torch.api.handle import Index
from repro_torch.api.spec import (CompactionPolicy, KNNResult, QuerySpec,
                                  ServeStats)

__all__ = ["CompactionPolicy", "Index", "KNNResult", "QuerySpec",
           "ServeStats"]
