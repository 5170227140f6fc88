"""Shared model layers: norms, RoPE, GQA attention with its KV-cache
branches, MLP flavours, embedding and LM head — the port of
``repro/models/common.py``.

Parameters keep the reference's layouts (``wq`` (d, h, hd), ``wo`` (h, hd,
d), ``wi_gate`` (d, f), …) and its initialisation rule (``init_leaf``), so a
reference parameter tree carries across by copying (``models/convert.py``).

Dtype policy, as the reference's code has it: every matmul runs in the
compute dtype with its weights cast to it; softmax and norms run in fp32 and
cast back; the residual stream stays in the compute dtype (the reference's
module docstring says fp32, its code does not).

Training: no parameter asks for a gradient outside ``grads_on``, so a
forward outside training records no graph. Inside it, ``remat`` wraps a
layer body as the reference's ``_remat`` does ("none", "full", or "dots",
which keeps the outputs of matmuls without batch dims), and the online
softmax recomputes each KV chunk in the backward, as the reference's
``jax.checkpoint`` on its chunk body does.

Not ported: ``layernorm``, which no model of the reference calls.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import make_generator
from repro_torch.kernels import ops
from repro_torch.sharding import context as sctx
from repro_torch.sharding.spec import placements

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def new_param(shape, dtype: torch.dtype, device, init: str,
              scale: Optional[float] = None,
              by_slice: bool = False, *, axes: tuple) -> nn.Parameter:
    """An uninitialised parameter tagged with its reference init rule
    ("fanin" | "embed" | "normal" | "ones" | "zeros" | "scalar"), the
    rule's ``scale`` and its logical axes (``axes``, one name or None a
    dim: the reference's ``ParamSpec.axes`` without the leading
    ``"layers"`` of a stacked leaf, which the sharding rules map from,
    ``sharding.spec``); ``init_leaf`` fills it, one slice along the first
    axis at a time under ``by_slice`` (an MoE's stacked experts). It asks
    for no gradient: training turns gradients on for one model at a time
    (``grads_on``)."""
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} rank != shape {tuple(shape)} rank")
    p = nn.Parameter(torch.empty(tuple(shape), dtype=dtype, device=device),
                     requires_grad=False)
    p.init = init
    p.scale = scale
    p.by_slice = by_slice
    p.axes = tuple(axes)
    return p


def norm_param(d: int, device) -> nn.Parameter:
    """An RMSNorm weight: (d,) fp32 ones, logical axis "act_embed" (the
    reference's ``rmsnorm_spec``)."""
    return new_param((d,), torch.float32, device, "ones", axes=("act_embed",))


def draw_params(model: nn.Module, rng, device) -> None:
    """Every parameter of ``model`` drawn by its init rule from ``rng`` (a
    seed or a ``torch.Generator``) on ``device``; nothing on ``meta``,
    where a model is built for its shapes and axes alone."""
    if torch.device(device).type == "meta":
        return
    g = make_generator(rng, device)
    for p in model.parameters():
        init_leaf(p, g)


@contextlib.contextmanager
def grads_on(model: nn.Module):
    """Every parameter of ``model`` asks for a gradient inside the block and
    stops asking when it exits (its ``.grad`` is left to the caller), so
    only a training step records a graph: a forward of the same model
    outside it, a serving step included, records none."""
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    try:
        yield model
    finally:
        for p in params:
            p.requires_grad_(False)


def meta_spec(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype``: the counterpart of the
    reference's ``jax.ShapeDtypeStruct``, nothing allocated."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def token_input_specs(shape) -> dict:
    """The token families' inputs of a ``ShapeConfig``, the reference's
    ``input_specs``: tokens and labels (B, S) int32 to train, tokens (B, S)
    to prefill, one new token (B, 1) to decode against a cache of S."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": meta_spec((B, S), torch.int32),
                "labels": meta_spec((B, S), torch.int32)}
    if shape.kind == "prefill":
        return {"tokens": meta_spec((B, S), torch.int32)}
    return {"tokens": meta_spec((B, 1), torch.int32)}


REMAT_MODES = ("none", "full", "dots")
_ATEN = torch.ops.aten
# what "dots" keeps: the reference's checkpoint_dots_with_no_batch_dims
# saves every dot_general without batch dims, a weight product such as
# "bsd,df->bsf", which PyTorch runs as mm (matmul folds the leading dims)
# or as a bmm of one batch (einsum); attention's and the experts' batched
# products are recomputed
_NO_BATCH_DOTS = (_ATEN.mm.default, _ATEN.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _NO_BATCH_DOTS or (op is _ATEN.bmm.default
                                and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _records(fn, args) -> bool:
    """Whether autograd records ``fn(*args)``: gradients are enabled and a
    tensor argument, or a parameter of the module ``fn`` is (or is bound
    to), asks for one."""
    if not torch.is_grad_enabled():
        return False
    if any(isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return True
    owner = fn if isinstance(fn, nn.Module) else getattr(fn, "__self__", None)
    return isinstance(owner, nn.Module) and any(
        p.requires_grad for p in owner.parameters())


def remat(mode: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under the reference's ``_remat(fn, mode)``:
    "none" keeps every activation for the backward, "full" keeps the
    inputs and recomputes the body in the backward, "dots" recomputes all
    but the outputs of matmuls without batch dims. Only while autograd
    records the call (``_records``); otherwise a plain call, so a serving
    forward is unchanged. The body draws no random numbers, so no RNG
    state is kept. Recomputation repeats the same operations, so the
    gradients are the same bits under every mode."""
    if mode not in REMAT_MODES:
        raise ValueError(f"remat {mode!r} is not one of {REMAT_MODES}")
    if mode == "none" or not _records(fn, args):
        return fn(*args, **kwargs)
    extra = {}
    if mode == "dots":
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **extra, **kwargs)


class CacheSpec(NamedTuple):
    """One cache leaf: shape, dtype, the rule it starts by ("zeros", "ones"
    or "scalar"), the scalar's value and the logical axes, the reference's
    ``ParamSpec`` fields that a cache uses (its stacked leaves keep their
    leading ``"layers"``: the port's cache is stacked too)."""
    shape: tuple
    dtype: torch.dtype
    init: str
    scale: float = 0.0
    axes: tuple = ()


# the logical axes of a stacked KV cache leaf (n_layers, B, S, KV, hd)
KV_AXES = ("layers", "batch", "kv_len", "kv_heads", "head_dim")


@torch.no_grad()
def init_leaf(p: torch.Tensor, generator: torch.Generator) -> None:
    """The reference's ``_init_leaf`` (``sharding/spec.py``): zeros, ones,
    the constant ``scale`` for "scalar", N(0, scale or 0.02) for "embed"
    and "normal", and N(0, (scale or 1)²/fan_in) for "fanin" with fan_in =
    shape[-2] for every tensor of rank ≥ 2 — so ``wq`` (d, h, hd) draws
    with std 1/√h, not 1/√d. Draws in fp32 and casts to the parameter's
    type; a ``by_slice`` parameter draws each slice along its first axis in
    turn, so deepseek's (256, 7,168, 2,048) experts take one expert's 59 MB
    of fp32 at a time, not 15 GB."""
    scale = p.scale
    if p.init == "zeros":
        p.zero_()
    elif p.init == "ones":
        p.fill_(1.0)
    elif p.init == "scalar":
        p.fill_(scale if scale is not None else 0.0)
    else:
        if p.init == "fanin":
            fan_in = p.shape[-2] if p.dim() >= 2 else p.shape[-1]
            std = (scale if scale is not None else 1.0) / math.sqrt(
                max(fan_in, 1))
        else:
            std = scale if scale is not None else 0.02
        for part in (p.unbind(0) if getattr(p, "by_slice", False) else (p,)):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=p.device,
                                   dtype=torch.float32).mul_(std))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x · rsqrt(mean(x²) + eps) · w in fp32, cast back. Every projection
    reads a norm's output, so under sequence parallelism (a DTensor x
    split along its sequence) the norm's output is gathered whole along
    the sequence first, as Megatron's sequence parallelism gathers before
    its column-parallel products; the residual stream stays split
    (``sharding.context.shard_act`` at each residual add)."""
    if sctx.is_dtensor(x):
        x = sctx.whole_sequence(x)
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def _rope_cos_sin(positions: torch.Tensor, rot_dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, rot_dim//2), fp32."""
    half = rot_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.to(torch.float32)[..., None] * freqs   # (..., S, half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, D); positions (B, S). Rotates all D dims in the
    split-halves form: x[..., :D/2] against x[..., D/2:]."""
    cos, sin = _rope_cos_sin(positions, x.shape[-1], theta)  # (B, S, D/2)
    cos = cos[..., None, :]                                   # (B, S, 1, D/2)
    sin = sin[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE. x (B, S, H, D); positions3 (3, B, S);
    ``sections`` split the D/2 frequencies into (temporal, height, width)
    bands, each rotated by its own position stream."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim/2 = {half}")
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    cos_parts, sin_parts = [], []
    start = 0
    for i, sec in enumerate(sections):
        pos = positions3[i].to(torch.float32)             # (B, S)
        ang = pos[..., None] * freqs[start:start + sec]   # (B, S, sec)
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
        start += sec
    cos = torch.cat(cos_parts, dim=-1)[..., None, :]     # (B, S, 1, D/2)
    sin = torch.cat(sin_parts, dim=-1)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embedding(seq_len: int, d: int) -> np.ndarray:
    """Whisper's encoder positions: (seq_len, d) fp32, sin of the first d/2
    frequencies then cos, computed in float64 as the reference does."""
    pos = np.arange(seq_len)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Attention (GQA / MQA), chunked for long sequences
# ---------------------------------------------------------------------------


def _mask(Sq: int, kv_pos: torch.Tensor, *, causal: bool, q_offset: int,
          kv_valid_len: Optional[int]) -> Optional[torch.Tensor]:
    """(Sq, len(kv_pos)) True where a query may read a key: at or before its
    own position (causal) and below ``kv_valid_len``. None: no mask."""
    mask = None
    if causal:
        q_pos = torch.arange(Sq, device=kv_pos.device) + q_offset
        mask = kv_pos[None, :] <= q_pos[:, None]
    if kv_valid_len is not None:
        valid = (kv_pos < kv_valid_len)[None, :]
        mask = valid if mask is None else mask & valid
    return mask


def _sdpa(q, k, v, *, causal: bool, q_offset: int, kv_valid_len=None):
    """q (B,Sq,H,D), k/v (B,Sk,KV,D) -> (B,Sq,H,D). fp32 scores and softmax;
    the probabilities are cast to q's type before the product with v.
    ``q_offset``: absolute position of q[0] for the causal mask.
    ``kv_valid_len``: keys at or past this position are masked out (a KV
    cache's unwritten tail)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32))
    scores = scores / math.sqrt(D)
    mask = _mask(Sq, torch.arange(k.shape[1], device=q.device),
                 causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len)
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


# keys above which ``sdpa`` takes the online softmax, and its KV chunk
FLASH_THRESHOLD = 2048
KV_CHUNK = 1024


def _sdpa_flash(q, k, v, *, causal: bool, q_offset: int, kv_valid_len=None):
    """Online-softmax (flash-style) attention over KV chunks, carrying
    (running max, normaliser, accumulator) in fp32; the (Sq, Sk) score matrix
    is never materialised. Each chunk's probabilities are cast to q's type
    for the product with v, whose result is accumulated in fp32."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    Dv = v.shape[-1]
    kv_chunk = KV_CHUNK if Sk % KV_CHUNK == 0 else Sk
    qg = q.reshape(B, Sq, KV, G, D).to(torch.float32)
    m = torch.full((B, KV, G, Sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, Dv), dtype=torch.float32, device=q.device)
    for start in range(0, Sk, kv_chunk):
        # under autograd each chunk's scores are recomputed in the
        # backward: only the carries and the chunk's inputs are kept
        m, l, acc = remat("full", _flash_chunk, m, l, acc, qg,
                          k[:, start:start + kv_chunk],
                          v[:, start:start + kv_chunk], start, causal,
                          q_offset, kv_valid_len, q.dtype)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype)


def _flash_chunk(m, l, acc, qg, kc, vc, start: int, causal: bool,
                 q_offset: int, kv_valid_len, q_dtype):
    """One KV chunk of the online softmax: the carries (m, l, acc) updated
    by keys ``kc`` and values ``vc`` at positions ``start`` on."""
    D = qg.shape[-1]
    s = torch.einsum("bqkgd,bskd->bkgqs", qg,
                     kc.to(torch.float32)) / math.sqrt(D)
    mask = _mask(qg.shape[1], torch.arange(kc.shape[1], device=qg.device)
                 + start, causal=causal, q_offset=q_offset,
                 kv_valid_len=kv_valid_len)
    if mask is not None:
        s = torch.where(mask, s, -1e30)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    scale = torch.exp(m - m_new)
    l = l * scale + torch.sum(p, dim=-1)
    acc = acc * scale[..., None] + torch.einsum(
        "bkgqs,bskd->bkgqd", p.to(q_dtype), vc).to(torch.float32)
    return m_new, l, acc


def sdpa(q, k, v, *, causal: bool, q_offset: int = 0,
         kv_valid_len: Optional[int] = None, chunk: int = 0):
    """Scaled dot-product attention, the plain path of ``attn_impl`` "auto"
    and "xla" and of both KV-cache branches. More than FLASH_THRESHOLD keys
    take the online softmax over KV chunks, unless there are at most 8
    queries (a decode step); ``chunk`` > 0 below Sq splits the queries into
    chunks of that size, each with its own causal offset."""
    Sq, Sk = q.shape[1], k.shape[1]
    use_flash = Sk > FLASH_THRESHOLD and Sq > 8

    def one(qc, off):
        if use_flash:
            return _sdpa_flash(qc, k, v, causal=causal, q_offset=off,
                               kv_valid_len=kv_valid_len)
        return _sdpa(qc, k, v, causal=causal, q_offset=off,
                     kv_valid_len=kv_valid_len)

    if chunk <= 0 or Sq <= chunk:
        return one(q, q_offset)
    if Sq % chunk:
        raise ValueError(f"Sq={Sq} is not a multiple of the q chunk {chunk}")
    return torch.cat([one(q[:, s:s + chunk], q_offset + s)
                      for s in range(0, Sq, chunk)], dim=1)


def head_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """"bsd,dhk->bshk": ``x`` (B, S, d) by ``w`` (d, h, k). A weight laid
    out over its last dim (the ``head_dim`` backup, where the model axis
    does not divide the heads) runs as a column-parallel product on each
    rank's slice of k, x gathered over that axis: the product's (h·k) dim
    split over ranks could not be viewed as (h, k)."""
    B, S, d = x.shape
    if not (sctx.is_dtensor(w) and any(
            p.is_shard(2) for p in w.placements)):
        return (x @ w.reshape(d, -1)).view(B, S, w.shape[1], w.shape[2])
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = w.device_mesh
    # x keeps its batch or sequence split; it is gathered over the axis
    # that splits k
    x_pl = [Replicate() if wp.is_shard(2)
            else (p if p.is_shard(0) or p.is_shard(1) else Replicate())
            for p, wp in zip(sctx.as_dtensor(x, mesh).placements,
                             w.placements)]
    w_pl = [Shard(2) if wp.is_shard(2) else Replicate()
            for wp in w.placements]
    out_pl = [Shard(3) if wp.is_shard(2) else xp
              for xp, wp in zip(x_pl, w_pl)]
    # each side replicated where the other is split meets a different
    # part there on each rank: its gradient is partial over that dim
    x_grad = [Partial() if wp.is_shard(2) else xp
              for xp, wp in zip(x_pl, w_pl)]
    w_grad = [Partial() if xp.is_shard() else wp
              for xp, wp in zip(x_pl, w_pl)]

    def local(xl, wl):
        return (xl @ wl.reshape(d, -1)).view(
            xl.shape[0], xl.shape[1], wl.shape[1], wl.shape[2])

    return sctx.local_call(local, (x, w), (x_pl, w_pl), out_pl, mesh,
                           grad_placements=[x_grad, w_grad])


def head_out_proj(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """"bshk,hkd->bsd": the attention's output ``o`` (B, S, h, k) by ``w``
    (h, k, d). A weight laid out over k (``head_proj``'s case) runs as a
    row-parallel product on each rank's slice of k, its output a partial
    sum over that axis, reduced where the caller lays it out."""
    B, S, h, k = o.shape
    if not (sctx.is_dtensor(w) and any(
            p.is_shard(1) for p in w.placements)):
        return o.reshape(B, S, -1) @ w.reshape(-1, w.shape[-1])
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = w.device_mesh
    o_pl = [Shard(3) if wp.is_shard(1)
            else (p if p.is_shard(0) or p.is_shard(1) else Replicate())
            for p, wp in zip(sctx.as_dtensor(o, mesh).placements,
                             w.placements)]
    w_pl = [Shard(1) if wp.is_shard(1) else Replicate()
            for wp in w.placements]
    out_pl = [Partial() if wp.is_shard(1) else op
              for op, wp in zip(o_pl, w_pl)]
    w_grad = [Partial() if op.is_shard() and not wp.is_shard() else wp
              for op, wp in zip(o_pl, w_pl)]

    def local(ol, wl):
        return ol.reshape(ol.shape[0], ol.shape[1], -1) @ wl.reshape(
            -1, wl.shape[-1])

    return sctx.local_call(local, (o, w), (o_pl, w_pl), out_pl, mesh,
                           grad_placements=[None, w_grad])


def quantize_kv(t: torch.Tensor):
    """(B, S, H, D) → (int8 values, (B, S, H) bf16 scales): each (token,
    head) row scaled by amax/127 in fp32 (1 where the row is all zeros),
    rounded half to even and clipped to ±127."""
    tf = t.to(torch.float32)
    amax = torch.amax(torch.abs(tf), dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.to(torch.float32)
            * scale.to(torch.float32)[..., None]).to(dtype)


class GQAAttention(nn.Module):
    """Grouped-query attention, causal or bidirectional, the reference's
    ``gqa_attention``. Positions by ``cfg.rope_type``: "rope" rotates q and
    k by ``positions``, "mrope" by the three streams of ``positions3``, and
    any other type ("none", "sinusoidal") leaves them, as the reference
    does. Without a cache, ``attn_impl="pallas"`` goes through the fused
    flash-attention op (``ops.flash_attention``, the CUDA kernel on the
    card), "auto" and "xla" through the plain ``sdpa``. With a cache (bf16,
    or int8 with bf16 scales under ``kv_quant``), the new keys and values
    are written into it and every ``attn_impl`` reads it through the plain
    ``sdpa``, as the reference's cache branches do."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.cfg = cfg
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        self.wq = new_param((d, h, hd), dtype, device, "fanin",
                            axes=("embed", "heads", "head_dim"))
        self.wk = new_param((d, kv, hd), dtype, device, "fanin",
                            axes=("embed", "kv_heads", "head_dim"))
        self.wv = new_param((d, kv, hd), dtype, device, "fanin",
                            axes=("embed", "kv_heads", "head_dim"))
        self.wo = new_param((h, hd, d), dtype, device, "fanin",
                            axes=("heads", "head_dim", "embed"))
        if cfg.qkv_bias:
            self.bq = new_param((h, hd), dtype, device, "zeros",
                                axes=("heads", "head_dim"))
            self.bk = new_param((kv, hd), dtype, device, "zeros",
                                axes=("kv_heads", "head_dim"))
            self.bv = new_param((kv, hd), dtype, device, "zeros",
                                axes=("kv_heads", "head_dim"))

    def qkv(self, x: torch.Tensor, positions: Optional[torch.Tensor],
            compute_dtype=torch.bfloat16, positions3=None):
        """The attention's inputs: q (B, S, H, hd), k and v (B, S, KV, hd),
        biased and rotated, in the compute dtype."""
        cfg = self.cfg
        B, S, d = x.shape
        xc = x.to(compute_dtype)

        def proj(w):                       # "bsd,dhk->bshk"
            return head_proj(xc, w.to(compute_dtype))

        q, k, v = proj(self.wq), proj(self.wk), proj(self.wv)
        if cfg.qkv_bias:
            q = q + self.bq.to(compute_dtype)
            k = k + self.bk.to(compute_dtype)
            v = v + self.bv.to(compute_dtype)
        if cfg.rope_type == "rope":
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        elif cfg.rope_type == "mrope":
            q = apply_mrope(q, positions3, cfg.rope_theta, cfg.mrope_sections)
            k = apply_mrope(k, positions3, cfg.rope_theta, cfg.mrope_sections)
        return q, k, v

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor], *,
                compute_dtype=torch.bfloat16, impl: str = "auto",
                cache_kv=None, cache_index: int = 0, causal: bool = True,
                positions3: Optional[torch.Tensor] = None):
        """x (B, S, d) → (out (B, S, d) in x's type, new_kv). ``positions``
        (B, S) rotate under "rope", ``positions3`` (3, B, S) under "mrope".
        ``impl`` picks the fused op's implementation ("auto" | "cuda" |
        "ref", as ``kernels.ops``). ``cache_kv``: this layer's cache
        entries, (k, v) of shape (B, max_seq, KV, hd), or ((k_q, k_s), (v_q,
        v_s)) under ``kv_quant``; the S new positions are written into them
        in place at ``[cache_index : cache_index + S]`` (a host int), keys
        from there on are masked, and new_kv is the updated entries (None
        without a cache)."""
        cfg = self.cfg
        B, S, d = x.shape
        q, k, v = self.qkv(x, positions, compute_dtype, positions3)
        chunk = cfg.attn_chunk if S > cfg.attn_chunk else 0
        new_kv = None
        if cache_kv is not None:
            end = cache_index + S
            if cfg.kv_quant:
                (ckq, cks), (cvq, cvs) = cache_kv
                for cq, cs, t in ((ckq, cks, k), (cvq, cvs, v)):
                    tq, ts = quantize_kv(t)
                    sctx.cache_write(cq, tq, cache_index)
                    sctx.cache_write(cs, ts, cache_index)
                ck = dequantize_kv(ckq, cks, compute_dtype)
                cv = dequantize_kv(cvq, cvs, compute_dtype)
            else:
                ck, cv = cache_kv
                sctx.cache_write(ck, k.to(ck.dtype), cache_index)
                sctx.cache_write(cv, v.to(cv.dtype), cache_index)
            new_kv = cache_kv
            k, v = ck.to(compute_dtype), cv.to(compute_dtype)

        def attend(q, k, v):
            if cache_kv is not None:
                return sdpa(q, k, v, causal=causal, q_offset=cache_index,
                            kv_valid_len=cache_index + S, chunk=chunk)
            if cfg.attn_impl == "pallas":
                # the fused kernel reads the KV heads unrepeated: query
                # head h reads KV head h // G, as the reference's
                # jnp.repeat arranges
                return ops.flash_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=causal, q_offset=0, impl=impl).transpose(1, 2)
            return sdpa(q, k, v, causal=causal, q_offset=0, chunk=chunk)

        out = (attend(q, k, v) if not sctx.is_dtensor(q)
               else sctx.heads_local(attend, q, k, v))
        proj_out = head_out_proj(out.to(compute_dtype),
                                 self.wo.to(compute_dtype))
        return proj_out.to(x.dtype), new_kv


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """The reference's ``mlp``: swiglu (``wi_gate``, ``wi_up``, ``wo``), or
    gelu (tanh approximation) / sq_relu (``wi``, ``wo``), ``d_ff`` wide
    (default ``cfg.d_ff``), as ``mlp_specs(cfg, dtype, d_ff=...)``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device,
                 d_ff: Optional[int] = None):
        super().__init__()
        if cfg.mlp_act not in ("swiglu", "gelu", "sq_relu"):
            raise ValueError(f"unknown mlp_act {cfg.mlp_act!r}")
        self.act = cfg.mlp_act
        d, f = cfg.d_model, d_ff if d_ff is not None else cfg.d_ff
        if self.act == "swiglu":
            self.wi_gate = new_param((d, f), dtype, device, "fanin",
                                     axes=("embed", "mlp"))
            self.wi_up = new_param((d, f), dtype, device, "fanin",
                                   axes=("embed", "mlp"))
        else:
            self.wi = new_param((d, f), dtype, device, "fanin",
                                axes=("embed", "mlp"))
        self.wo = new_param((f, d), dtype, device, "fanin",
                            axes=("mlp", "embed"))

    def forward(self, x: torch.Tensor, compute_dtype=torch.bfloat16):
        xc = x.to(compute_dtype)
        if self.act == "swiglu":
            g = xc @ self.wi_gate.to(compute_dtype)
            u = xc @ self.wi_up.to(compute_dtype)
            h = F.silu(g.to(torch.float32)).to(compute_dtype) * u
        else:
            h = xc @ self.wi.to(compute_dtype)
            if self.act == "sq_relu":
                h = torch.square(torch.relu(h.to(torch.float32))).to(compute_dtype)
            else:
                h = F.gelu(h.to(torch.float32), approximate="tanh").to(compute_dtype)
        return (h @ self.wo.to(compute_dtype)).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def _sharded_lookup(tok, tokens):
    """tok[tokens] for a table laid out on a mesh: the table split over the
    vocabulary as the rules split it (gathered along its other dims), each
    rank looks up the tokens in its rows and zeros the rest, and the
    partial sums over the vocabulary's ranks are the rows (one nonzero
    term each). Returns a DTensor, rows laid out as the batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    rules, mesh = sctx.current()
    want = placements(rules.pspec(("vocab", None), tuple(tok.shape)), mesh)
    ids_pl = placements(rules.pspec(("batch",) + (None,) * (tokens.dim() - 1),
                                    tuple(tokens.shape)), mesh)
    vdim = next((i for i, p in enumerate(want) if p == Shard(0)), None)
    out_pl = [Partial() if i == vdim else p for i, p in enumerate(ids_pl)]

    def lookup(table, ids):
        if vdim is None:
            return table[ids]
        v0 = mesh.get_local_rank(vdim) * table.shape[0]
        mine = (ids >= v0) & (ids < v0 + table.shape[0])
        rows = table[torch.where(mine, ids - v0, 0)]
        return rows * mine[..., None].to(rows.dtype)

    # each data shard looks up its own tokens: a partial gradient there
    grad_pl = [Partial() if p == Replicate() and i != Replicate() else p
               for p, i in zip(want, ids_pl)]
    return sctx.local_call(lookup, (tok, tokens), (want, ids_pl), out_pl,
                           mesh, grad_placements=[grad_pl, None])


class Embed(nn.Module):
    """Token embedding ``tok`` (V, d) and, unless tied, the LM head ``head``
    (d, V)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.tok = new_param((cfg.vocab_size, cfg.d_model), dtype, device,
                             "embed", axes=("vocab", "embed"))
        if not cfg.tie_embeddings:
            self.head = new_param((cfg.d_model, cfg.vocab_size), dtype, device,
                                  "fanin", axes=("embed", "vocab"))

    def embed(self, tokens: torch.Tensor, compute_dtype=torch.bfloat16):
        if sctx.is_dtensor(self.tok):
            return _sharded_lookup(self.tok, tokens).to(compute_dtype)
        return self.tok[tokens].to(compute_dtype)

    def lm_head(self, x: torch.Tensor, compute_dtype=torch.bfloat16):
        w = self.head if hasattr(self, "head") else self.tok.T
        return x.to(compute_dtype) @ w.to(compute_dtype)
