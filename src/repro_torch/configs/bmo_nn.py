"""The paper's own workload configs for BMO-NN k-nearest-neighbour retrieval.

  * dense:  Tiny-ImageNet-like n=100k, d=12288 (§V, Figs 2/3), rotated box
  * sparse: 10x-genomics-like  n=100k, d=28672, 7% nnz (§V, Fig 4b)
  * smoke:  a small dense box for quick runs
"""
import dataclasses

from repro_torch.configs.base import BMOConfig


@dataclasses.dataclass(frozen=True)
class BMONNWorkload:
    name: str
    n_points: int
    dim: int
    n_queries: int
    sparsity: float            # fraction of nonzeros (1.0 = dense)
    bmo: BMOConfig


DENSE = BMONNWorkload(
    name="bmo-nn-dense",
    n_points=100_000,
    dim=12_288,
    n_queries=1024,
    sparsity=1.0,
    bmo=BMOConfig(k=5, delta=0.01, block=128, batch_arms=32, metric="l2",
                  rotate=True),
)

SPARSE = BMONNWorkload(
    name="bmo-nn-sparse",
    n_points=100_000,
    dim=28_672,
    n_queries=1024,
    sparsity=0.07,
    bmo=BMOConfig(k=5, delta=0.01, block=1, batch_arms=32, metric="l1",
                  sparse=True),
)

SMOKE = BMONNWorkload(
    name="bmo-nn-smoke",
    n_points=256,
    dim=512,
    n_queries=8,
    sparsity=1.0,
    bmo=BMOConfig(k=3, delta=0.05, block=32, batch_arms=8, metric="l2"),
)
