"""family → model class dispatch, over every family of the reference."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

MODEL_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def build_model(cfg: ModelConfig, **kw):
    """The model of ``cfg.family``; ``kw`` goes to its constructor
    (``param_dtype``, ``device``, ``rng``)."""
    if cfg.family == "dense":
        from repro_torch.models.transformer import DenseLM
        return DenseLM(cfg, **kw)
    if cfg.family == "moe":
        from repro_torch.models.moe import MoELM
        return MoELM(cfg, **kw)
    if cfg.family == "ssm":
        from repro_torch.models.ssm import XLSTM
        return XLSTM(cfg, **kw)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import Zamba2
        return Zamba2(cfg, **kw)
    if cfg.family == "vlm":
        from repro_torch.models.vlm import VLM
        return VLM(cfg, **kw)
    if cfg.family == "audio":
        from repro_torch.models.audio import Whisper
        return Whisper(cfg, **kw)
    raise ValueError(f"unknown family {cfg.family!r}")
