"""zamba2-2.7b: a Mamba2 backbone with one *shared* attention + MLP block
applied after every ``attn_every`` Mamba2 layers, the port of
``repro/models/hybrid.py``. The shared block's weights are reused at each
application; each application keeps its own slice of the KV cache."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.sharding.context import shard_act
from repro_torch.models import ssm
from repro_torch.models.common import CacheSpec
from repro_torch.models.transformer import DenseLayer


class MambaLayer(nn.Module):
    """A pre-norm Mamba2 layer: x + mamba(rmsnorm(x, ln))."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln = cm.norm_param(cfg.d_model, device)
        self.mamba = ssm.Mamba2(cfg, dtype, device)

    def forward(self, x, state, compute_dtype):
        out, _ = self.mamba(cm.rmsnorm(x, self.ln, self.eps), state,
                            compute_dtype)
        return x + shard_act(out)


class Zamba2(nn.Module):
    """Parameters keep the reference's tree: ``layers.<i>.ln`` and
    ``layers.<i>.mamba.*`` (stacked in the reference), the unstacked
    ``shared`` block (``ln1``, ``attn``, ``ln2``, ``mlp``), ``embed`` and
    ``final_norm``, drawn as ``DenseLM``'s. The cache holds ``mamba`` (the
    Mamba2 states of all layers), ``k`` and ``v`` (n_layers / attn_every,
    B, max_seq, KV, head_dim), one slice an application of the shared
    block, and ``index``, a host int."""

    stacked = ("layers",)

    def __init__(self, cfg: ModelConfig, *, param_dtype=torch.float32,
                 device=None, rng=0):
        super().__init__()
        device = resolve_device(device)
        if not (cfg.attn_every > 0 and cfg.n_layers % cfg.attn_every == 0):
            raise ValueError(f"n_layers={cfg.n_layers} is not a multiple of "
                             f"attn_every={cfg.attn_every}")
        self.cfg = cfg
        self.groups = cfg.n_layers // cfg.attn_every
        self.per_group = cfg.attn_every
        self.embed = cm.Embed(cfg, param_dtype, device)
        self.layers = nn.ModuleList(MambaLayer(cfg, param_dtype, device)
                                    for _ in range(cfg.n_layers))
        self.shared = DenseLayer(cfg, param_dtype, device)
        self.final_norm = cm.norm_param(cfg.d_model, device)
        cm.draw_params(self, rng, device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def input_specs(self, shape) -> dict:
        """The inputs of a ``ShapeConfig`` as ``meta`` tensors, the
        reference's ``input_specs``."""
        return cm.token_input_specs(shape)

    def cache_specs(self, batch_size: int, max_seq: int,
                    dtype=torch.bfloat16) -> dict:
        cfg = self.cfg
        kv_shape = (self.groups, batch_size, max_seq, cfg.n_kv_heads,
                    cfg.head_dim_)
        return {"mamba": ssm.mamba2_state_specs(cfg, cfg.n_layers, batch_size,
                                                dtype),
                "k": CacheSpec(kv_shape, dtype, "zeros", axes=cm.KV_AXES),
                "v": CacheSpec(kv_shape, dtype, "zeros", axes=cm.KV_AXES),
                "index": CacheSpec((), torch.int32, "zeros")}

    def forward(self, batch: dict, *, remat: str = "full",
                compute_dtype=torch.bfloat16, impl: str = "auto",
                cache: Optional[dict] = None, cache_index: int = 0):
        """batch: {"tokens": (B, S), optional "positions": (B, S)}. Returns
        (logits, new_cache), as ``DenseLM``'s; ``impl`` goes to the shared
        block's fused attention op. ``remat`` wraps each Mamba2 layer and
        each group (its layers and the shared block) without a cache, as
        the reference's ``_remat`` wraps its two bodies."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = shard_act(self.embed.embed(tokens, compute_dtype))
        positions = batch.get("positions")
        if positions is None:
            positions = (torch.arange(S, device=tokens.device)
                         + cache_index)[None].expand(B, S)
        mode = remat if cache is None else "none"
        for gi in range(self.groups):
            x = cm.remat(mode, self._group, gi, x, positions, compute_dtype,
                         impl, cache, cache_index, mode)
        x = cm.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        logits = self.embed.lm_head(x, compute_dtype)
        new_cache = None
        if cache is not None:
            new_cache = dict(cache, index=cache["index"] + S)
        return logits, new_cache

    def _group(self, gi: int, x, positions, compute_dtype, impl: str,
               cache: Optional[dict], cache_index: int, mode: str):
        """Group gi: its ``attn_every`` Mamba2 layers (each under ``mode``)
        and the shared block against the group's KV slice."""
        mamba = cache["mamba"] if cache is not None else None
        for j in range(self.per_group):
            li = gi * self.per_group + j
            x = cm.remat(mode, self.layers[li], x,
                         ssm.layer_views(mamba, li), compute_dtype)
        kv = (cache["k"][gi], cache["v"][gi]) if cache is not None else None
        return self.shared(x, positions, compute_dtype, impl, cache_kv=kv,
                           cache_index=cache_index)

    def decode_step(self, cache: dict, tokens: torch.Tensor, *,
                    compute_dtype=torch.bfloat16):
        """tokens (B, 1) at position ``cache["index"]``."""
        B = tokens.shape[0]
        index = cache["index"]
        positions = torch.full((B, 1), index, dtype=torch.int64,
                               device=tokens.device)
        return self({"tokens": tokens, "positions": positions}, remat="none",
                    compute_dtype=compute_dtype, cache=cache,
                    cache_index=index)

    def prefill(self, batch: dict, cache: dict, *, remat: str = "none",
                compute_dtype=torch.bfloat16):
        return self(batch, remat=remat, compute_dtype=compute_dtype,
                    cache=cache, cache_index=0)
