"""Dense decoder-only transformer LM (llama3 / qwen2.5 / granite / nemotron
families) with KV-cache prefill and decode: the port of
``repro/models/transformer.py``.

The reference scans one stacked parameter tree over the layers; here each
layer is a module of an ``nn.ModuleList``. The KV cache keeps the
reference's stacked layout, (n_layers, B, max_seq, KV, head_dim), and is
written in place, where the reference updates a donated buffer; its
``index`` (the filled length) is a host int, so a decode step places its
token without reading the device.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.sharding.context import shard_act
from repro_torch.models.common import CacheSpec


class DenseLayer(nn.Module):
    """One pre-norm block: ``ln1`` → attention → residual, ``ln2`` → MLP →
    residual (the reference's ``_layer``)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1 = cm.norm_param(cfg.d_model, device)
        self.attn = cm.GQAAttention(cfg, dtype, device)
        self.ln2 = cm.norm_param(cfg.d_model, device)
        self.mlp = cm.MLP(cfg, dtype, device)

    def forward(self, x, positions, compute_dtype, impl: str, cache_kv=None,
                cache_index: int = 0, causal: bool = True, positions3=None):
        """The block's output; ``cache_kv`` (this layer's cache entries) is
        written in place."""
        h = cm.rmsnorm(x, self.ln1, self.eps)
        attn_out, _ = self.attn(h, positions, compute_dtype=compute_dtype,
                                impl=impl, cache_kv=cache_kv,
                                cache_index=cache_index, causal=causal,
                                positions3=positions3)
        x = x + shard_act(attn_out)
        h = cm.rmsnorm(x, self.ln2, self.eps)
        return x + shard_act(self.mlp(h, compute_dtype))


class DenseLM(nn.Module):
    """The dense LM. Parameters keep the reference's tree and layouts
    (``embed.tok``, ``layers.<i>.attn.wq``, ``final_norm``, …) and are drawn
    on ``device`` from ``rng`` (a seed or a ``torch.Generator``) by the
    reference's init rule. ``param_dtype`` is the type of the matmul
    weights, the embedding and the biases; the norm weights are fp32. Every
    use casts a weight to the compute dtype (the norms to fp32) first, so
    storing them in bf16 leaves a bf16 forward unchanged and halves the
    memory (14.77 B parameters of qwen2.5-14b: 29.5 GB)."""

    stacked = ("layers",)

    def __init__(self, cfg: ModelConfig, *, param_dtype=torch.float32,
                 device=None, rng=0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = cm.Embed(cfg, param_dtype, device)
        self.layers = nn.ModuleList(DenseLayer(cfg, param_dtype, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = cm.norm_param(cfg.d_model, device)
        cm.draw_params(self, rng, device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def forward(self, batch: dict, *, remat: str = "full",
                compute_dtype=torch.bfloat16, return_hidden: bool = False,
                impl: str = "auto", cache: Optional[dict] = None,
                cache_index: int = 0):
        """batch: {"tokens": (B, S) int, optional "positions": (B, S)}.
        Returns (logits (B, S, V) in the compute dtype, new_cache) or, with
        return_hidden, (logits, new_cache, final hidden (B, S, d)) — the
        hidden states after the final norm, which the kNN-LM hook retrieves
        with. Without a cache, new_cache is None; with one (``cache_specs``'
        layout), the S positions from ``cache_index`` (default positions
        ``cache_index + arange(S)``) are written into its tensors in place
        and new_cache is a dict over the same tensors with ``index``
        advanced by S. ``remat`` ("none" | "full" | "dots") wraps each
        layer as the reference's ``_remat`` does, while autograd records
        and without a cache (``cm.remat``). ``impl`` picks the fused
        attention op's implementation under ``attn_impl="pallas"`` (the
        cache-free forward only)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = shard_act(self.embed.embed(tokens, compute_dtype))
        positions: Optional[torch.Tensor] = batch.get("positions")
        if positions is None:
            positions = (torch.arange(S, device=tokens.device)
                         + cache_index)[None].expand(B, S)
        mode = remat if cache is None else "none"
        for i, layer in enumerate(self.layers):
            x = cm.remat(mode, layer, x, positions, compute_dtype, impl,
                         cache_kv=_layer_kv(cache, i, self.cfg.kv_quant),
                         cache_index=cache_index)
        new_cache = None
        if cache is not None:
            new_cache = dict(cache, index=cache["index"] + S)
        x = cm.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        logits = self.embed.lm_head(x, compute_dtype)
        if return_hidden:
            return logits, new_cache, x
        return logits, new_cache

    # -- serving ------------------------------------------------------------

    def input_specs(self, shape) -> dict:
        """The inputs of a ``ShapeConfig`` as ``meta`` tensors, the
        reference's ``input_specs``."""
        return cm.token_input_specs(shape)

    def cache_specs(self, batch_size: int, max_seq: int,
                    dtype=torch.bfloat16) -> dict:
        """The KV cache's leaves as ``CacheSpec``s, the reference's layout:
        k and v (n_layers, B, max_seq, KV, head_dim) in ``dtype``, or under
        ``kv_quant`` int8 values with (n_layers, B, max_seq, KV) bf16 scales
        starting at 1; ``index`` the filled length."""
        cfg = self.cfg
        kv_shape = (cfg.n_layers, batch_size, max_seq, cfg.n_kv_heads,
                    cfg.head_dim_)
        index = CacheSpec((), torch.int32, "zeros")
        if cfg.kv_quant:
            s_shape = kv_shape[:-1]
            ax, s_ax = cm.KV_AXES, cm.KV_AXES[:-1]
            return {"k_q": CacheSpec(kv_shape, torch.int8, "zeros", axes=ax),
                    "k_s": CacheSpec(s_shape, torch.bfloat16, "ones",
                                     1.0, s_ax),
                    "v_q": CacheSpec(kv_shape, torch.int8, "zeros", axes=ax),
                    "v_s": CacheSpec(s_shape, torch.bfloat16, "ones",
                                     1.0, s_ax),
                    "index": index}
        return {"k": CacheSpec(kv_shape, dtype, "zeros", axes=cm.KV_AXES),
                "v": CacheSpec(kv_shape, dtype, "zeros", axes=cm.KV_AXES),
                "index": index}

    def decode_step(self, cache: dict, tokens: torch.Tensor, *,
                    compute_dtype=torch.bfloat16,
                    return_hidden: bool = False):
        """tokens (B, 1) at position ``cache["index"]`` (the current
        length). Returns (logits, new_cache[, hidden])."""
        B = tokens.shape[0]
        index = cache["index"]
        positions = torch.full((B, 1), index, dtype=torch.int64,
                               device=tokens.device)
        return self(
            {"tokens": tokens, "positions": positions}, remat="none",
            compute_dtype=compute_dtype, cache=cache, cache_index=index,
            return_hidden=return_hidden)

    def prefill(self, batch: dict, cache: dict, *, remat: str = "none",
                compute_dtype=torch.bfloat16):
        """The prompt ``batch["tokens"]`` (B, S) written into the cache from
        position 0. Returns (logits, new_cache)."""
        return self(batch, remat=remat, compute_dtype=compute_dtype,
                    cache=cache, cache_index=0)


def _layer_kv(cache: Optional[dict], i: int, kv_quant: bool):
    """Layer i's views of the stacked cache (None without one)."""
    if cache is None:
        return None
    if kv_quant:
        return ((cache["k_q"][i], cache["k_s"][i]),
                (cache["v_q"][i], cache["v_s"][i]))
    return cache["k"][i], cache["v"][i]
