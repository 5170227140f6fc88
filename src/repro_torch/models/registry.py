"""family → model class dispatch. The port runs the dense family; the other
five are still to be ported (see ROADMAP.md)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

MODEL_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def build_model(cfg: ModelConfig, **kw):
    """The model of ``cfg.family``; ``kw`` goes to its constructor
    (``param_dtype``, ``device``, ``rng``)."""
    if cfg.family == "dense":
        from repro_torch.models.transformer import DenseLM
        return DenseLM(cfg, **kw)
    if cfg.family in MODEL_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (see ROADMAP.md)")
    raise ValueError(f"unknown family {cfg.family!r}")
