"""qwen2-vl-2b's backbone: the dense decoder LM with M-RoPE (three rotary
position streams, temporal / height / width), the port of
``repro/models/vlm.py``. The vision tower is a stub, as in the reference:
the inputs are precomputed embeddings merged into the token stream
(``embeds`` (B, S, d)) and the (3, B, S) position ids M-RoPE reads
(``positions3``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import common as cm
from repro_torch.sharding.context import shard_act
from repro_torch.models.transformer import DenseLM, _layer_kv


class VLM(DenseLM):
    """``DenseLM``'s parameters and cache; the forward reads embeddings and
    rotates by ``positions3``."""

    def input_specs(self, shape) -> dict:
        """The inputs of a ``ShapeConfig`` as ``meta`` tensors, the
        reference's: bf16 embeddings and the (3, B, S) position streams
        (labels to train); one embedding (B, 1, d) to decode."""
        B, S, d = shape.global_batch, shape.seq_len, self.cfg.d_model
        i32 = torch.int32
        if shape.kind == "decode":
            return {"embeds": cm.meta_spec((B, 1, d), torch.bfloat16)}
        out = {"embeds": cm.meta_spec((B, S, d), torch.bfloat16),
               "positions3": cm.meta_spec((3, B, S), i32)}
        if shape.kind == "train":
            out["labels"] = cm.meta_spec((B, S), i32)
        return out

    def forward(self, batch: dict, *, remat: str = "full",
                compute_dtype=torch.bfloat16, impl: str = "auto",
                cache: Optional[dict] = None, cache_index: int = 0):
        """batch: {"embeds": (B, S, d) float, optional "positions3": (3, B,
        S) int; default every stream at ``cache_index + arange(S)``}.
        Returns (logits, new_cache), as ``DenseLM``'s; ``remat`` wraps each
        layer as there."""
        x = shard_act(batch["embeds"].to(compute_dtype))
        B, S = x.shape[:2]
        positions3 = batch.get("positions3")
        if positions3 is None:
            p = torch.arange(S, device=x.device) + cache_index
            positions3 = p[None, None].expand(3, B, S)
        mode = remat if cache is None else "none"
        for i, layer in enumerate(self.layers):
            x = cm.remat(mode, layer, x, None, compute_dtype, impl,
                         cache_kv=_layer_kv(cache, i, self.cfg.kv_quant),
                         cache_index=cache_index, positions3=positions3)
        new_cache = None
        if cache is not None:
            new_cache = dict(cache, index=cache["index"] + S)
        x = cm.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return self.embed.lm_head(x, compute_dtype), new_cache

    def decode_step(self, cache: dict, batch, *,
                    compute_dtype=torch.bfloat16):
        """batch: {"embeds": (B, 1, d)}, or a (B, 1) token array embedded
        through the table (the reference's fallback); text-mode decode,
        all three position streams at ``cache["index"]``."""
        if isinstance(batch, dict):
            embeds = batch["embeds"]
        else:
            embeds = self.embed.tok[batch]
        B = embeds.shape[0]
        index = cache["index"]
        pos = torch.full((3, B, 1), index, dtype=torch.int64,
                         device=embeds.device)
        return self({"embeds": embeds, "positions3": pos}, remat="none",
                    compute_dtype=compute_dtype, cache=cache,
                    cache_index=index)
