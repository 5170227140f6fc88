"""whisper-base: the encoder-decoder transformer, the port of
``repro/models/audio.py``. The conv frontend is a stub, as in the
reference: the inputs are post-conv frame embeddings (``frames`` (B,
S_enc, d)). The encoder is bidirectional over sinusoidal positions; the
decoder is causal with learned positions (``dec_pos``), a self-attention KV
cache, and cross-attention onto the encoder's keys and values, projected
once per sequence. The decoder's length is S_enc // dec_seq_div."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.sharding.context import shard_act
from repro_torch.models.common import CacheSpec
from repro_torch.models.transformer import DenseLayer

# learned decoder positions, the reference's table
DEC_POSITIONS = 8192


class DecoderLayer(nn.Module):
    """Self-attention (``ln1``, ``self_attn``), cross-attention (``ln_x``,
    ``cross_attn``: no rotation, keys and values projected beforehand) and
    the MLP (``ln2``, ``mlp``), each pre-norm with a residual."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.cfg = cfg
        ones = lambda: cm.norm_param(cfg.d_model, device)
        self.ln1 = ones()
        self.self_attn = cm.GQAAttention(cfg, dtype, device)
        self.ln_x = ones()
        self.cross_attn = cm.GQAAttention(cfg, dtype, device)
        self.ln2 = ones()
        self.mlp = cm.MLP(cfg, dtype, device)

    def cross_kv(self, enc_out: torch.Tensor, compute_dtype):
        """This layer's cross keys and values, (B, S_enc, KV, hd) each."""
        B, S, d = enc_out.shape
        e = enc_out.to(compute_dtype)
        ca = self.cross_attn
        k, v = (e @ w.to(compute_dtype).reshape(d, -1) for w in (ca.wk, ca.wv))
        return (k.view(B, S, ca.wk.shape[1], ca.wk.shape[2]),
                v.view(B, S, ca.wv.shape[1], ca.wv.shape[2]))

    def forward(self, x, positions, cross_k, cross_v, compute_dtype,
                impl: str, cache_kv=None, cache_index: int = 0):
        cfg, cd = self.cfg, compute_dtype
        B, S, d = x.shape
        h = cm.rmsnorm(x, self.ln1, cfg.norm_eps)
        a, _ = self.self_attn(h, positions, compute_dtype=cd, impl=impl,
                              cache_kv=cache_kv, cache_index=cache_index)
        x = x + shard_act(a)
        h = cm.rmsnorm(x, self.ln_x, cfg.norm_eps)
        ca = self.cross_attn
        q = (h.to(cd) @ ca.wq.to(cd).reshape(d, -1)).view(
            B, S, ca.wq.shape[1], ca.wq.shape[2])
        attn = cm.sdpa(q, cross_k.to(cd), cross_v.to(cd), causal=False,
                       chunk=cfg.attn_chunk if S > cfg.attn_chunk else 0)
        xo = attn.to(cd).reshape(B, S, -1) @ ca.wo.to(cd).reshape(-1, d)
        x = x + shard_act(xo.to(x.dtype))
        h = cm.rmsnorm(x, self.ln2, cfg.norm_eps)
        return x + shard_act(self.mlp(h, cd))


class Whisper(nn.Module):
    """Parameters keep the reference's tree: ``embed`` (tied), ``dec_pos``,
    ``enc_layers.<i>.*`` and ``dec_layers.<i>.*`` (stacked in the
    reference), ``enc_norm`` and ``dec_norm``, drawn as ``DenseLM``'s. The
    cache holds the decoder's self-attention ``k`` and ``v`` (dec_layers,
    B, max(max_seq // dec_seq_div, 8), KV, hd), the cross keys and values
    ``cross_k`` and ``cross_v`` (dec_layers, B, max_seq, KV, hd), where
    max_seq is the encoder's length, and ``index``, a host int."""

    stacked = ("enc_layers", "dec_layers")

    def __init__(self, cfg: ModelConfig, *, param_dtype=torch.float32,
                 device=None, rng=0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d = cfg.d_model
        self.embed = cm.Embed(cfg, param_dtype, device)
        self.dec_pos = cm.new_param((DEC_POSITIONS, d), param_dtype, device,
                                    "embed", axes=(None, "embed"))
        self.enc_layers = nn.ModuleList(DenseLayer(cfg, param_dtype, device)
                                        for _ in range(cfg.enc_layers))
        self.dec_layers = nn.ModuleList(DecoderLayer(cfg, param_dtype, device)
                                        for _ in range(cfg.dec_layers))
        self.enc_norm = cm.norm_param(d, device)
        self.dec_norm = cm.norm_param(d, device)
        cm.draw_params(self, rng, device)

    @property
    def device(self) -> torch.device:
        return self.enc_norm.device

    # -- encoder ------------------------------------------------------------

    def encode(self, frames: torch.Tensor, *, compute_dtype=torch.bfloat16,
               impl: str = "auto", remat: str = "none") -> torch.Tensor:
        """frames (B, S_enc, d) → the encoder's output (B, S_enc, d):
        sinusoidal positions added, bidirectional attention (through the
        fused op under ``attn_impl="pallas"``), the final norm; ``remat``
        wraps each layer (``cm.remat``)."""
        cfg = self.cfg
        B, S, d = frames.shape
        pos = torch.from_numpy(cm.sinusoidal_embedding(S, d)).to(
            device=frames.device, dtype=compute_dtype)
        x = shard_act(frames.to(compute_dtype) + pos[None])
        positions = torch.arange(S, device=frames.device)[None].expand(B, S)
        for layer in self.enc_layers:
            x = cm.remat(remat, layer, x, positions, compute_dtype, impl,
                         causal=False)
        return cm.rmsnorm(x, self.enc_norm, cfg.norm_eps)

    def cross_kv(self, enc_out: torch.Tensor, compute_dtype):
        """Every decoder layer's cross keys and values, stacked: (dec_layers,
        B, S_enc, KV, hd) each, in the compute dtype."""
        ks, vs = zip(*(layer.cross_kv(enc_out, compute_dtype)
                       for layer in self.dec_layers))
        return torch.stack(ks), torch.stack(vs)

    # -- decoder ------------------------------------------------------------

    def decode(self, tokens: torch.Tensor, cross_k, cross_v, *,
               compute_dtype=torch.bfloat16, impl: str = "auto",
               cache: Optional[dict] = None, cache_index: int = 0,
               remat: str = "none"):
        """tokens (B, S) at positions ``cache_index + arange(S)`` against the
        stacked cross keys and values. Returns (logits, new_cache): None
        without a cache; with one ({"k", "v", "index"}), the S positions
        written into k and v in place, and the cross keys and values
        carried in the new cache. ``remat`` wraps each layer without a
        cache (``cm.remat``)."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self.embed.embed(tokens, compute_dtype)
        pos_ids = torch.arange(S, device=tokens.device) + cache_index
        x = x + self.dec_pos[pos_ids][None].to(compute_dtype)
        positions = pos_ids[None].expand(B, S)
        mode = remat if cache is None else "none"
        for i, layer in enumerate(self.dec_layers):
            kv = (cache["k"][i], cache["v"][i]) if cache is not None else None
            x = cm.remat(mode, layer, x, positions, cross_k[i], cross_v[i],
                         compute_dtype, impl, cache_kv=kv,
                         cache_index=cache_index)
        new_cache = None
        if cache is not None:
            new_cache = {"k": cache["k"], "v": cache["v"],
                         "cross_k": cross_k, "cross_v": cross_v,
                         "index": cache["index"] + S}
        x = cm.rmsnorm(x, self.dec_norm, cfg.norm_eps)
        return self.embed.lm_head(x, compute_dtype), new_cache

    # -- the common interface -----------------------------------------------

    def forward(self, batch: dict, *, remat: str = "full",
                compute_dtype=torch.bfloat16, impl: str = "auto",
                cache: Optional[dict] = None, cache_index: int = 0):
        """batch: {"frames": (B, S_enc, d), "tokens": (B, S_dec)}. Returns
        (logits (B, S_dec, V), new_cache). ``remat`` wraps the encoder's
        and the decoder's layers, as the reference's does."""
        enc = self.encode(batch["frames"], compute_dtype=compute_dtype,
                          impl=impl, remat=remat)
        ck, cv = self.cross_kv(enc, compute_dtype)
        return self.decode(batch["tokens"], ck, cv,
                           compute_dtype=compute_dtype, impl=impl,
                           cache=cache, cache_index=cache_index, remat=remat)

    def input_specs(self, shape) -> dict:
        """The inputs of a ``ShapeConfig`` as ``meta`` tensors, the
        reference's: bf16 frames (B, S, d) and decoder tokens of
        max(S // dec_seq_div, 8) (labels to train); one token to decode."""
        cfg = self.cfg
        B, S, d = shape.global_batch, shape.seq_len, cfg.d_model
        dec_len = max(S // cfg.dec_seq_div, 8)
        i32 = torch.int32
        if shape.kind == "decode":
            return {"tokens": cm.meta_spec((B, 1), i32)}
        out = {"frames": cm.meta_spec((B, S, d), torch.bfloat16),
               "tokens": cm.meta_spec((B, dec_len), i32)}
        if shape.kind == "train":
            out["labels"] = cm.meta_spec((B, dec_len), i32)
        return out

    def cache_specs(self, batch_size: int, max_seq: int,
                    dtype=torch.bfloat16) -> dict:
        """``max_seq`` is the encoder's length; the decoder's cache holds
        max(max_seq // dec_seq_div, 8) positions."""
        cfg = self.cfg
        dec_len = max(max_seq // cfg.dec_seq_div, 8)
        kv = lambda s: CacheSpec((cfg.dec_layers, batch_size, s,
                                  cfg.n_kv_heads, cfg.head_dim_), dtype,
                                 "zeros", axes=cm.KV_AXES)
        return {"k": kv(dec_len), "v": kv(dec_len), "cross_k": kv(max_seq),
                "cross_v": kv(max_seq),
                "index": CacheSpec((), torch.int32, "zeros")}

    def prefill(self, batch: dict, cache: dict, *, remat: str = "none",
                compute_dtype=torch.bfloat16):
        """The frames encoded and projected into the new cache's cross keys
        and values, and the prompt ``batch["tokens"]`` written into its
        self-attention cache from position 0."""
        return self(batch, remat=remat, compute_dtype=compute_dtype,
                    cache=cache, cache_index=0)

    def decode_step(self, cache: dict, tokens: torch.Tensor, *,
                    compute_dtype=torch.bfloat16):
        """tokens (B, 1) at position ``cache["index"]``, against the
        cache's cross keys and values."""
        return self.decode(tokens, cache["cross_k"], cache["cross_v"],
                           compute_dtype=compute_dtype, cache=cache,
                           cache_index=cache["index"])
