"""Architecture registry: ``get_arch(<id>)`` → (ModelConfig, ParallelPlan,
SMOKE), over the architectures the port runs. The reference's other ids
are known and raise ``NotImplementedError``: ``ROADMAP.md`` lists them as
still to be ported."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig, ParallelPlan

_MODULES = {
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
}

# the reference's architectures that the port does not run yet
_NOT_PORTED = ("xlstm-350m", "zamba2-2.7b", "deepseek-v3-671b", "dbrx-132b",
               "granite-34b", "nemotron-4-340b", "llama3-405b", "qwen2-vl-2b",
               "whisper-base")


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    config: ModelConfig
    plan: ParallelPlan
    smoke: ModelConfig


def get_arch(arch_id: str) -> ArchEntry:
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet (see ROADMAP.md); the port runs "
            f"{sorted(_MODULES)}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch_id])
    return ArchEntry(arch_id, mod.CONFIG, mod.PLAN, mod.SMOKE)


def list_archs():
    return list(_MODULES)
