"""repro_torch.index — the port's batched-racing BMO-NN index, dense and
rotated boxes: build once (``build_index``), serve many (``index_knn``),
mutate online (``insert``/``delete``/``compact``) and persist
(``save_index``/``load_index``)."""
from repro_torch.index.batched_race import (batched_race_topk,
                                            fused_race_topk, index_knn,
                                            make_rounds_race)
from repro_torch.index.builder import build_index, load_index, save_index
from repro_torch.index.frontier import FrontierState
from repro_torch.index.mutable import (compact, delete, insert,
                                       maybe_compact, tombstone_fraction)
from repro_torch.index.store import IndexStore, free_slots

__all__ = ["FrontierState", "IndexStore", "batched_race_topk", "build_index",
           "compact", "delete", "free_slots", "fused_race_topk", "index_knn",
           "insert", "load_index", "make_rounds_race", "maybe_compact",
           "save_index", "tombstone_fraction"]
