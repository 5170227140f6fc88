"""repro_torch.api — the port's client surface: ``Index.build`` /
``Index.load`` / ``Index.open`` → ``Index.query`` with the typed
``QuerySpec`` → ``KNNResult`` protocol (exact repeats served from the query
LRU, ``CachePolicy``); ``insert``, ``delete``, ``compact`` /
``maybe_compact`` (``CompactionPolicy``) and ``save``; and the anytime
protocol (``api/stream.py``): ``Index.race`` opens an epoch-granular
resumable race, and the request plane (``repro_torch.serve.RequestPlane``)
turns ``Deadline`` / ``EffortBudget`` specs into tickets with streamed
``AnytimeResult`` partials.

    from repro_torch.api import Index, Deadline
    idx = Index.build(corpus, cfg)            # on the GPU
    res = idx.query(queries, k=10, delta=0.001)
    idx.insert(rows); idx.delete(slots); idx.maybe_compact()
    idx.save(path); idx = Index.load(path)    # the reference's layout

    from repro_torch.serve import RequestPlane
    plane = RequestPlane(idx)
    t = plane.submit(queries, deadline=Deadline(ms=50.0))
    for partial in plane.stream(t):           # AnytimeResult
        ...
"""
from repro_torch.api.cache import QueryCache
from repro_torch.api.handle import Index
from repro_torch.api.spec import (CachePolicy, CompactionPolicy, KNNResult,
                                  QuerySpec, ServeStats)
from repro_torch.api.stream import (AnytimeResult, Deadline, EffortBudget,
                                    Ticket)

__all__ = ["AnytimeResult", "CachePolicy", "CompactionPolicy", "Deadline",
           "EffortBudget", "Index", "KNNResult", "QueryCache", "QuerySpec",
           "ServeStats", "Ticket"]
