"""Architecture registry: ``get_arch(<id>)`` → (ModelConfig, ParallelPlan,
SMOKE), over the reference's architectures in its order, and the
reference's per-shape skips."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

from repro_torch.configs.base import ModelConfig, ParallelPlan

_MODULES = {
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "whisper-base": "repro_torch.configs.whisper_base",
}

# shapes skipped per arch (with reason), the reference's table
SKIPS = {
    "long_500k": {
        "deepseek-v3-671b": "full attention (MLA) — quadratic history",
        "dbrx-132b": "full attention — quadratic history",
        "granite-34b": "full attention — quadratic history",
        "nemotron-4-340b": "full attention — quadratic history",
        "llama3-405b": "full attention — quadratic history",
        "qwen2.5-14b": "full attention — quadratic history",
        "qwen2-vl-2b": "full attention — quadratic history",
        "whisper-base": "full attention enc-dec — quadratic history",
    },
}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    config: ModelConfig
    plan: ParallelPlan
    smoke: ModelConfig


def get_arch(arch_id: str) -> ArchEntry:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch_id])
    return ArchEntry(arch_id, mod.CONFIG, mod.PLAN, mod.SMOKE)


def list_archs():
    return list(_MODULES)


def shape_skip_reason(arch_id: str, shape_name: str) -> Optional[str]:
    return SKIPS.get(shape_name, {}).get(arch_id)
