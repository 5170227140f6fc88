"""family → model class dispatch. The port runs every family but the MoE
one, which is still to be ported (see ROADMAP.md)."""
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
        raise NotImplementedError(
            "the 'moe' family is not ported yet (see ROADMAP.md)")
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
