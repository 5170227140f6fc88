from repro_torch.configs.base import (SHAPES, BMOConfig, ModelConfig,
                                      ParallelPlan, ShapeConfig, TrainConfig)
from repro_torch.configs.registry import ArchEntry, get_arch, list_archs

__all__ = ["ArchEntry", "BMOConfig", "ModelConfig", "ParallelPlan", "SHAPES",
           "ShapeConfig", "TrainConfig", "get_arch", "list_archs"]
