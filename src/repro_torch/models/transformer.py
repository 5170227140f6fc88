"""Dense decoder-only transformer LM (llama3 / qwen2.5 / granite / nemotron
families): the cache-free forward of ``repro/models/transformer.py``.

The reference scans one stacked parameter tree over the layers; here each
layer is a module of an ``nn.ModuleList``. ``cache_specs``, ``prefill`` and
``decode_step`` wait for the serving slice (see ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import make_generator, resolve_device
from repro_torch.models import common as cm


class DenseLayer(nn.Module):
    """One pre-norm block: ``ln1`` → attention → residual, ``ln2`` → MLP →
    residual (the reference's ``_layer``)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1 = cm.new_param((cfg.d_model,), torch.float32, device, "ones")
        self.attn = cm.GQAAttention(cfg, dtype, device)
        self.ln2 = cm.new_param((cfg.d_model,), torch.float32, device, "ones")
        self.mlp = cm.MLP(cfg, dtype, device)

    def forward(self, x, positions, compute_dtype, impl: str):
        h = cm.rmsnorm(x, self.ln1, self.eps)
        x = x + self.attn(h, positions, compute_dtype=compute_dtype,
                          impl=impl)
        h = cm.rmsnorm(x, self.ln2, self.eps)
        return x + self.mlp(h, compute_dtype)


class DenseLM(nn.Module):
    """The dense LM. Parameters keep the reference's tree and layouts
    (``embed.tok``, ``layers.<i>.attn.wq``, ``final_norm``, …) and are drawn
    on ``device`` from ``rng`` (a seed or a ``torch.Generator``) by the
    reference's init rule. ``param_dtype`` is the type of the matmul
    weights, the embedding and the biases; the norm weights are fp32. Every
    use casts a weight to the compute dtype (the norms to fp32) first, so
    storing them in bf16 leaves a bf16 forward unchanged and halves the
    memory (14.77 B parameters of qwen2.5-14b: 29.5 GB)."""

    def __init__(self, cfg: ModelConfig, *, param_dtype=torch.float32,
                 device=None, rng=0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = cm.Embed(cfg, param_dtype, device)
        self.layers = nn.ModuleList(DenseLayer(cfg, param_dtype, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = cm.new_param((cfg.d_model,), torch.float32, device,
                                       "ones")
        g = make_generator(rng, device)
        for p in self.parameters():
            cm.init_leaf(p, g)

    def forward(self, batch: dict, *, remat: str = "full",
                compute_dtype=torch.bfloat16, return_hidden: bool = False,
                impl: str = "auto"):
        """batch: {"tokens": (B, S) int, optional "positions": (B, S)}.
        Returns (logits (B, S, V) in the compute dtype, None) or, with
        return_hidden, (logits, None, final hidden (B, S, d)); the None
        stands where the reference returns its KV cache. ``remat`` is
        accepted and ignored: it only matters to a backward pass, which the
        port does not run. ``impl`` picks the fused attention op's
        implementation under ``attn_impl="pallas"``."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self.embed.embed(tokens, compute_dtype)
        positions: Optional[torch.Tensor] = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        for layer in self.layers:
            x = layer(x, positions, compute_dtype, impl)
        x = cm.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        logits = self.embed.lm_head(x, compute_dtype)
        if return_hidden:
            return logits, None, x
        return logits, None
