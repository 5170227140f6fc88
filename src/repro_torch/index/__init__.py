"""repro_torch.index — the port's batched-racing BMO-NN index, dense and
rotated boxes: build once (``build_index``), serve many (``index_knn``)."""
from repro_torch.index.batched_race import (batched_race_topk,
                                            fused_race_topk, index_knn,
                                            make_rounds_race)
from repro_torch.index.builder import build_index
from repro_torch.index.frontier import FrontierState
from repro_torch.index.store import IndexStore

__all__ = ["FrontierState", "IndexStore", "batched_race_topk", "build_index",
           "fused_race_topk", "index_knn", "make_rounds_race"]
