from repro_torch.configs.base import (BMOConfig, ModelConfig, ParallelPlan,
                                      TrainConfig)
from repro_torch.configs.registry import ArchEntry, get_arch, list_archs

__all__ = ["ArchEntry", "BMOConfig", "ModelConfig", "ParallelPlan",
           "TrainConfig", "get_arch", "list_archs"]
