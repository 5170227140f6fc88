"""Mixture-of-Experts LMs, dbrx-132b (GQA, 16 experts top-4) and
deepseek-v3-671b (MLA, one shared and 256 routed experts top-8, a
multi-token-prediction head): the port of ``repro/models/moe.py``.

The MoE FFN keeps the reference's sort-based capacity dispatch: router
top-k → a stable sort of the (token, choice) pairs by expert → a fixed
(E, capacity, d) buffer (pairs past an expert's capacity are dropped) →
batched expert matmuls → the weighted combine. Over a mesh the layer
runs the reference's expert parallelism (``ep``: two all-to-alls over the
``model`` axis, ``MoE.sharded``), or without ``ep`` the one-device
dispatch over the whole batch.

Three choices keep the port's routing and sums those of the reference on
the CPU and on the card alike:
- the top k comes from a stable descending sort of the scores' total
  order, so tied scores (common among 256 bf16 router logits) go to the
  lower expert id, as ``jax.lax.top_k`` breaks them (``torch.topk``
  promises no order);
- the dispatch buffer is gathered, each kept slot from its one token;
- the combine gathers each token's k weighted outputs and adds them in
  ascending expert id, the order in which the reference's scatter-add
  meets them, rounding to the compute type after each add. No atomics:
  two calls on one input give the same bits.

MLA (DeepSeek-V2/V3) factors queries, keys and values through low-rank
projections; the cache holds the compressed ``c_kv`` (B, S, kv_lora_rank)
and the shared RoPE key ``k_rope`` (B, S, 1, qk_rope_dim). Prefill and the
cache-free forward expand K and V and go through the plain ``sdpa``, as
the reference does; decode takes the absorbed form, which never expands
them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.sharding import context as sctx
from repro_torch.sharding.context import shard_act
from repro_torch.models.common import CacheSpec

# ---------------------------------------------------------------------------
# MoE FFN
# ---------------------------------------------------------------------------


def capacity(n_tokens: int, k: int, E: int, factor: float = 1.25,
             floor: int = 4) -> int:
    """Slots an expert: ceil(n_tokens·k/E·factor), at least ``floor`` (the
    reference's ``_capacity``, the same expression so ``ceil`` sees the
    same float)."""
    cap = int(math.ceil(n_tokens * k / E * factor))
    return max(cap, floor)


def dispatch_indices(expert_ids: torch.Tensor, E: int, cap: int):
    """expert_ids (N,) → (dest slot in the (E·cap) buffer, E·cap where the
    pair is dropped; the stable sort order by expert; the keep mask), as
    the reference's ``_dispatch_indices``: a pair keeps its place in its
    expert's segment of the sorted order, and the pairs from ``cap`` on are
    dropped."""
    N = expert_ids.shape[0]
    order = torch.sort(expert_ids, stable=True).indices
    sorted_e = expert_ids[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(E, dtype=sorted_e.dtype,
                               device=sorted_e.device))
    pos = torch.arange(N, device=order.device) - seg_start[sorted_e]
    keep = pos < cap
    dest = torch.where(keep, sorted_e * cap + pos, E * cap)
    return dest, order, keep


def expert_weights(cfg: ModelConfig, logits: torch.Tensor,
                   top_i: torch.Tensor) -> torch.Tensor:
    """The combine weights of the experts ``top_i`` (T, k) from the fp32
    router logits (T, E): sigmoid scores normalised over the k
    (deepseek-v3), or a softmax over the k logits."""
    if cfg.router_type == "sigmoid":
        w = torch.gather(torch.sigmoid(logits), -1, top_i)
        return w / (torch.sum(w, -1, keepdim=True) + 1e-9)
    return torch.softmax(torch.gather(logits, -1, top_i), dim=-1)


def total_order(x: torch.Tensor) -> torch.Tensor:
    """fp32 → int32 keys in IEEE total order (−0 below +0, NaN above +∞),
    the order ``jax.lax.top_k`` ranks by."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def route(cfg: ModelConfig, logits: torch.Tensor):
    """(top_w, top_i), each (T, k): the k best experts of each token by
    score (the sigmoid of the fp32 logits, or the logits), in
    ``jax.lax.top_k``'s order: a stable descending sort of the scores'
    total-order keys, so ties go to the lower expert id and +0 ranks above
    −0. Then their weights."""
    scores = (torch.sigmoid(logits) if cfg.router_type == "sigmoid"
              else logits)
    top_i = torch.sort(total_order(scores), dim=-1, descending=True,
                       stable=True).indices[:, :cfg.n_experts_active]
    return expert_weights(cfg, logits, top_i), top_i


def switch_aux(logits: torch.Tensor, top_i: torch.Tensor) -> torch.Tensor:
    """The Switch load-balance loss E·Σ_e f_e·P_e: f_e the share of tokens
    whose first choice is e, P_e the mean router probability of e."""
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    frac = torch.mean(F.one_hot(top_i[:, 0], E).to(torch.float32), dim=0)
    return E * torch.sum(frac * torch.mean(probs, dim=0))


class MoE(nn.Module):
    """One MoE FFN (the reference's ``moe_specs`` and ``moe_apply`` on one
    device): ``router`` (d, E), the experts ``wi_gate``/``wi_up`` (E, d, f)
    and ``wo`` (E, f, d), and deepseek's ``shared`` expert, a swiglu MLP
    ``moe_d_ff · n_shared_experts`` wide, added after. The experts draw one
    at a time (``cm.init_leaf``)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.cfg = cfg
        d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.router = cm.new_param((d, E), dtype, device, "normal",
                                   scale=0.006, axes=("embed", None))
        self.wi_gate = cm.new_param((E, d, f), dtype, device, "fanin",
                                    by_slice=True,
                                    axes=("experts", "embed", "expert_mlp"))
        self.wi_up = cm.new_param((E, d, f), dtype, device, "fanin",
                                  by_slice=True,
                                  axes=("experts", "embed", "expert_mlp"))
        self.wo = cm.new_param((E, f, d), dtype, device, "fanin",
                               by_slice=True,
                               axes=("experts", "expert_mlp", "embed"))
        if cfg.n_shared_experts > 0:
            self.shared = cm.MLP(cfg, dtype, device,
                                 d_ff=cfg.moe_d_ff * cfg.n_shared_experts)

    def router_logits(self, x2d: torch.Tensor, compute_dtype,
                      router=None) -> torch.Tensor:
        """(T, E) fp32: the router's product in the compute type, cast up
        (``router``: the weight to use, default the layer's)."""
        router = self.router if router is None else router
        return (x2d.to(compute_dtype)
                @ router.to(compute_dtype)).to(torch.float32)

    def expert_ffn(self, buf: torch.Tensor, compute_dtype) -> torch.Tensor:
        """buf (E, C, d) → (E, C, d) through each expert's swiglu, the
        activation in fp32 and cast back."""
        g = torch.bmm(buf, self.wi_gate.to(compute_dtype))
        u = torch.bmm(buf, self.wi_up.to(compute_dtype))
        h = F.silu(g.to(torch.float32)).to(compute_dtype) * u
        return torch.bmm(h, self.wo.to(compute_dtype))

    def local(self, x2d: torch.Tensor, compute_dtype, ffn=None):
        """x2d (T, d) in the compute type → (out (T, d), aux fp32), the
        reference's ``_moe_local`` without ``ep``. A stream longer than
        ``moe_seq_chunk`` that it divides is dispatched a chunk at a time,
        the aux the mean of the chunks'; under autograd each chunk is
        recomputed in the backward, as the reference checkpoints its chunk
        body (``cm.remat``). The top-k ids carry no gradient (a sort's
        indices); the router's weights carry one through the combine
        weights and the aux."""
        cfg = self.cfg
        T, d = x2d.shape
        chunk = cfg.moe_seq_chunk
        if chunk and T > chunk and T % chunk == 0:
            outs, auxs = zip(*(cm.remat("full", self.local, xc, compute_dtype,
                                        ffn)
                               for xc in x2d.split(chunk)))
            return torch.cat(outs), torch.mean(torch.stack(auxs))
        E, k = cfg.n_experts, cfg.n_experts_active
        logits = self.router_logits(x2d, compute_dtype,
                                    None if ffn is None else ffn.router)
        top_w, top_i = route(cfg, logits)
        aux = switch_aux(logits, top_i)

        cap = capacity(T, k, E, factor=cfg.moe_capacity_factor)
        dest, order, keep = dispatch_indices(top_i.reshape(-1), E, cap)
        # each kept slot gathers its token; empty slots and the drop sink
        # (slot E·cap) read the zero row T
        zero = x2d.new_zeros((1, d))
        slot_tok = torch.full((E * cap + 1,), T, dtype=order.dtype,
                              device=x2d.device)
        slot_tok[dest] = torch.where(keep, order // k, T)
        buf = torch.cat([x2d, zero])[slot_tok[:-1]].view(E, cap, d)
        out_buf = (self.expert_ffn(buf, compute_dtype) if ffn is None
                   else ffn(buf))
        flat_out = torch.cat([out_buf.reshape(E * cap, d),
                              zero.to(compute_dtype)])

        # the combine: each token's k outputs in ascending expert id
        w = (keep * top_w.reshape(-1)[order]).to(flat_out.dtype)
        sorted_pos = torch.empty_like(order)
        sorted_pos[order] = torch.arange(order.shape[0], device=order.device)
        by_expert = torch.argsort(top_i, dim=-1, stable=True)
        pos = torch.gather(sorted_pos.view(T, k), 1, by_expert)
        out = None
        for r in range(k):
            p = pos[:, r]
            y = flat_out[dest[p]] * w[p, None]
            out = y if out is None else out + y
        return out.to(x2d.dtype), aux

    def forward(self, x: torch.Tensor, compute_dtype=torch.bfloat16):
        """x (B, S, d) → (out (B, S, d), aux scalar fp32). Laid out on a
        mesh (x a DTensor), ``sharded``."""
        B, S, d = x.shape
        if sctx.is_dtensor(x):
            out, aux = self.sharded(x, compute_dtype)
        else:
            out, aux = self.local(x.reshape(B * S, d), compute_dtype)
            out = out.reshape(B, S, d)
        if self.cfg.n_shared_experts > 0:
            out = out + self.shared(x, compute_dtype)
        return out, aux


    def sharded(self, x, compute_dtype):
        """The MoE FFN of DTensor x (B, S, d) under the installed rules.

        With experts on ``model`` (``ep``), the reference's ``shard_map``
        program: each rank routes its data shard's tokens (replicated over
        ``model``) with capacity from its own token count, the (E, cap, d)
        buffer goes to the experts' owners in one all-to-all over
        ``model`` (each rank holding E/m experts), their outputs come back
        in a second, and the combine is the one-device one. Every
        ``model`` rank sends its identical buffer, so an owner sees each
        slot m times: the experts' gradient is taken from one copy
        (scaled by 1/m on the way back). The aux is the mean over the data
        shards. Without ``ep`` the layer runs as on one device over the
        whole batch, its tokens and experts gathered, so capacity and drops
        are the one-device ones."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        from repro_torch.dist import all_to_all
        from repro_torch.sharding.spec import placements
        cfg = self.cfg
        rules, mesh = sctx.current()
        B, S, d = x.shape
        E = cfg.n_experts
        ep = "model" in mesh.mesh_dim_names and \
            rules.mesh_axes("experts") == "model"
        full = [Replicate()] * mesh.ndim
        weights = (self.router, self.wi_gate, self.wi_up, self.wo)
        if not ep:
            def whole(xl, router, wg, wu, wo):
                out, aux = self.local(xl.reshape(B * S, d), compute_dtype,
                                      _Experts(router, wg, wu, wo,
                                               compute_dtype))
                return out.reshape(B, S, d), aux
            return sctx.local_call(whole, (x,) + weights, [full] * 5,
                                   (full, full), mesh)
        mdim = mesh.mesh_dim_names.index("model")
        m = mesh.mesh.shape[mdim]
        if E % m:
            raise ValueError(f"{E} experts do not split over model = {m}")
        group = mesh.get_group(mdim)
        x_pl = placements(rules.pspec(("batch", None, None), tuple(x.shape)),
                          mesh)
        ex_pl = [Shard(0) if i == mdim else Replicate()
                 for i in range(mesh.ndim)]
        # gradients of what each data shard computes from its own tokens
        part = [Replicate() if (i == mdim or x_pl[i] == Replicate())
                else Partial() for i in range(mesh.ndim)]
        ex_grad = [Shard(0) if i == mdim else part[i]
                   for i in range(mesh.ndim)]

        def ep_body(xl, router, wg, wu, wo):
            Bl = xl.shape[0]
            wg, wu, wo = (_GradScale.apply(w, 1.0 / m) for w in (wg, wu, wo))
            local_ffn = _Experts(router, wg, wu, wo, compute_dtype)

            def exchange(buf):
                e_loc, cap = E // m, buf.shape[1]
                b = all_to_all(buf.reshape(m, e_loc, cap, d), group)
                b = b.transpose(0, 1).reshape(e_loc, m * cap, d)
                ob = local_ffn(b)
                ob = ob.reshape(e_loc, m, cap, d).transpose(0, 1)
                return all_to_all(ob, group).reshape(E, cap, d)

            exchange.router = router
            out, aux = self.local(xl.reshape(Bl * S, d), compute_dtype,
                                  exchange)
            return out.reshape(Bl, S, d), aux

        aux_pl = [Partial("avg") if p == Partial() else Replicate()
                  for p in part]
        return sctx.local_call(
            ep_body, (x,) + weights, [x_pl, full, ex_pl, ex_pl, ex_pl],
            (x_pl, aux_pl), mesh,
            grad_placements=[None, part, ex_grad, ex_grad, ex_grad])


class _Experts:
    """The expert FFN over given weights (local shards, or gathered), the
    router beside it for ``MoE.local``."""

    def __init__(self, router, wg, wu, wo, compute_dtype):
        self.router, self.wg, self.wu, self.wo = router, wg, wu, wo
        self.cd = compute_dtype

    def __call__(self, buf):
        cd = self.cd
        g = torch.bmm(buf, self.wg.to(cd))
        u = torch.bmm(buf, self.wu.to(cd))
        h = F.silu(g.to(torch.float32)).to(cd) * u
        return torch.bmm(h, self.wo.to(cd))


class _GradScale(torch.autograd.Function):
    """The identity, its gradient times ``s``."""

    @staticmethod
    def forward(ctx, x, s: float):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


# ---------------------------------------------------------------------------
# MLA attention (deepseek-v3)
# ---------------------------------------------------------------------------


class MLAttention(nn.Module):
    """Multi-head latent attention, the reference's ``mla_specs`` and
    ``mla_attention``: ``wq_a`` (d, q_lora_rank) → ``q_norm`` → ``wq_b``
    (q_lora_rank, H, nope + rope); ``wkv_a`` (d, kv_lora_rank + rope) →
    ``kv_norm`` on the latent c_kv; ``wk_b`` (kv_lora_rank, H, nope) and
    ``wv_b`` (kv_lora_rank, H, v) expand it; ``wo`` (H, v, d)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.cfg = cfg
        d, H = cfg.d_model, cfg.n_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        p = cm.new_param
        self.wq_a = p((d, qr), dtype, device, "fanin",
                      axes=("embed", "qk_rank"))
        self.q_norm = cm.norm_param(qr, device)
        self.wq_b = p((qr, H, nd + rd), dtype, device, "fanin",
                      axes=("qk_rank", "heads", "head_dim"))
        self.wkv_a = p((d, kvr + rd), dtype, device, "fanin",
                       axes=("embed", "kv_rank"))
        self.kv_norm = cm.norm_param(kvr, device)
        self.wk_b = p((kvr, H, nd), dtype, device, "fanin",
                      axes=("kv_rank", "heads", "head_dim"))
        self.wv_b = p((kvr, H, vd), dtype, device, "fanin",
                      axes=("kv_rank", "heads", "head_dim"))
        self.wo = p((H, vd, d), dtype, device, "fanin",
                    axes=("heads", "head_dim", "embed"))

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                compute_dtype=torch.bfloat16, cache=None,
                cache_index: int = 0, absorbed: bool = False):
        """x (B, S, d) → (out (B, S, d) in x's type, the cache entries or
        None). ``cache``: this layer's (c_kv (B, max_seq, kvr), k_rope (B,
        max_seq, 1, rd)), the S new positions written in place from
        ``cache_index`` (a host int) and keys from ``cache_index + S`` on
        masked. ``absorbed``: the decode form, W_uk folded into the query
        and W_uv applied after the context, so K and V stay latent."""
        cfg = self.cfg
        B, S, d = x.shape
        H = cfg.n_heads
        nd, rd, kvr = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
        xc = x.to(compute_dtype)

        q_lat = cm.rmsnorm(xc @ self.wq_a.to(compute_dtype), self.q_norm,
                           cfg.norm_eps)
        q = (q_lat @ self.wq_b.to(compute_dtype).reshape(
            q_lat.shape[-1], -1)).view(B, S, H, nd + rd)
        q_nope = q[..., :nd]
        q_rope = cm.apply_rope(q[..., nd:], positions, cfg.rope_theta)

        kv_a = xc @ self.wkv_a.to(compute_dtype)
        c_kv = cm.rmsnorm(kv_a[..., :kvr], self.kv_norm, cfg.norm_eps)
        k_rope = cm.apply_rope(kv_a[..., None, kvr:], positions,
                               cfg.rope_theta)            # (B, S, 1, rd)

        valid = None
        if cache is not None:
            cc, cr = cache
            end = cache_index + S
            cc[:, cache_index:end] = c_kv.to(cc.dtype)
            cr[:, cache_index:end] = k_rope.to(cr.dtype)
            c_all, r_all = cc.to(compute_dtype), cr.to(compute_dtype)
            valid = end
        else:
            c_all, r_all = c_kv, k_rope
        Sk = c_all.shape[1]

        if absorbed:
            # score = q_nopeᵀ (W_uk c) + q_ropeᵀ k_rope: W_uk folded into q
            q_abs = torch.einsum("bshn,rhn->bshr", q_nope,
                                 self.wk_b.to(compute_dtype))
            s_nope = torch.einsum("bshr,btr->bhst", q_abs.to(torch.float32),
                                  c_all.to(torch.float32))
            s_rope = torch.einsum("bshr,btr->bhst", q_rope.to(torch.float32),
                                  r_all[:, :, 0].to(torch.float32))
            scores = (s_nope + s_rope) * (1.0 / math.sqrt(nd + rd))
            mask = cm._mask(S, torch.arange(Sk, device=x.device),
                            causal=True, q_offset=cache_index,
                            kv_valid_len=valid)
            scores = torch.where(mask, scores, -1e30)
            probs = torch.softmax(scores, dim=-1).to(compute_dtype)
            ctx = torch.einsum("bhst,btr->bshr", probs, c_all)
            out_h = torch.einsum("bshr,rhv->bshv", ctx,
                                 self.wv_b.to(compute_dtype))
        else:
            k_nope = torch.einsum("btr,rhn->bthn", c_all,
                                  self.wk_b.to(compute_dtype))
            v = torch.einsum("btr,rhv->bthv", c_all,
                             self.wv_b.to(compute_dtype))
            k = torch.cat([k_nope, r_all.expand(B, Sk, H, rd)], dim=-1)
            # sdpa scales by 1/√(nope + rope), which is MLA's scale
            out_h = cm.sdpa(torch.cat([q_nope, q_rope], dim=-1), k, v,
                            causal=True, q_offset=cache_index,
                            kv_valid_len=valid,
                            chunk=cfg.attn_chunk if S > cfg.attn_chunk else 0)
        out = out_h.to(compute_dtype).reshape(B, S, -1) @ \
            self.wo.to(compute_dtype).reshape(-1, d)
        return out.to(x.dtype), cache


# ---------------------------------------------------------------------------
# The MoE LM (dbrx / deepseek-v3)
# ---------------------------------------------------------------------------


class MoEBlock(nn.Module):
    """One pre-norm block of the MoE LM: ``ln1`` → attention (MLA under
    ``use_mla``, else the port's ``GQAAttention``) → residual, ``ln2`` →
    ``moe`` (an MoE FFN) or ``mlp`` (a dense one, ``d_ff`` wide: the
    first dense layers, and the MTP block) → residual."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device, *,
                 moe: bool, d_ff: Optional[int] = None):
        super().__init__()
        self.eps = cfg.norm_eps
        self.use_mla = cfg.use_mla
        self.ln1 = cm.norm_param(cfg.d_model, device)
        self.attn = (MLAttention(cfg, dtype, device) if cfg.use_mla
                     else cm.GQAAttention(cfg, dtype, device))
        self.ln2 = cm.norm_param(cfg.d_model, device)
        if moe:
            self.moe = MoE(cfg, dtype, device)
        else:
            self.mlp = cm.MLP(cfg, dtype, device, d_ff=d_ff)

    def forward(self, x, positions, compute_dtype, impl: str, cache_kv=None,
                cache_index: int = 0, absorbed: bool = False):
        """(the block's output, its MoE aux or None for a dense block);
        ``cache_kv`` (this layer's cache entries) is written in place.
        ``impl`` goes to ``GQAAttention``'s fused op, ``absorbed`` to
        MLA."""
        h = cm.rmsnorm(x, self.ln1, self.eps)
        if self.use_mla:
            a, _ = self.attn(h, positions, compute_dtype=compute_dtype,
                             cache=cache_kv, cache_index=cache_index,
                             absorbed=absorbed)
        else:
            a, _ = self.attn(h, positions, compute_dtype=compute_dtype,
                             impl=impl, cache_kv=cache_kv,
                             cache_index=cache_index)
        x = x + shard_act(a)
        h = cm.rmsnorm(x, self.ln2, self.eps)
        if hasattr(self, "moe"):
            out, aux = self.moe(h, compute_dtype)
            return x + shard_act(out), aux
        return x + shard_act(self.mlp(h, compute_dtype)), None


class MTP(nn.Module):
    """deepseek-v3's multi-token-prediction head: ``proj`` (2d, d) over
    [``ln``(h_t), h_{t+1}], then one dense block (``layer``, its MLP
    ``moe_d_ff · 4`` wide) and the shared LM head."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        d = cfg.d_model
        self.proj = cm.new_param((2 * d, d), dtype, device, "fanin",
                                 axes=("embed", None))
        self.ln = cm.norm_param(d, device)
        self.layer = MoEBlock(cfg, dtype, device, moe=False,
                              d_ff=cfg.moe_d_ff * 4 if cfg.moe_d_ff
                              else cfg.d_ff)


class MoELM(nn.Module):
    """The MoE LM (the reference's ``MoELM``): ``embed``, the first
    ``first_dense_layers`` blocks with a dense MLP (``dense_layers``),
    then the MoE blocks (``layers``), ``final_norm``, and under
    ``mtp_depth`` the ``mtp`` head. Parameters keep the reference's tree,
    layouts and init rules (the router N(0, 0.006²)), drawn on ``device``
    from ``rng``; the norm weights are fp32. The KV cache spans all
    ``n_layers`` layers, dense first: MLA's (c_kv, k_rope) or GQA's (k, v),
    written in place, its ``index`` a host int."""

    stacked = ("dense_layers", "layers")

    def __init__(self, cfg: ModelConfig, *, param_dtype=torch.float32,
                 device=None, rng=0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = cm.Embed(cfg, param_dtype, device)
        self.dense_layers = nn.ModuleList(
            MoEBlock(cfg, param_dtype, device, moe=False)
            for _ in range(cfg.first_dense_layers))
        self.layers = nn.ModuleList(
            MoEBlock(cfg, param_dtype, device, moe=True)
            for _ in range(cfg.n_layers - cfg.first_dense_layers))
        self.final_norm = cm.norm_param(cfg.d_model, device)
        if cfg.mtp_depth > 0:
            self.mtp = MTP(cfg, param_dtype, device)
        cm.draw_params(self, rng, device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def forward(self, batch: dict, *, remat: str = "full",
                compute_dtype=torch.bfloat16, impl: str = "auto",
                cache: Optional[dict] = None, cache_index: int = 0,
                absorbed: bool = False, return_aux: bool = False):
        """batch: {"tokens": (B, S), optional "positions": (B, S)}.
        Returns (logits, new_cache), as ``DenseLM``'s, or with
        ``return_aux`` (logits, new_cache, {"aux_loss": the MoE blocks'
        summed aux (fp32), "mtp_logits": the MTP head's logits, None with a
        cache or without the head}). ``absorbed``: MLA's decode form.
        ``impl`` goes to the fused attention op (GQA, cache-free).
        ``remat`` wraps each MoE block without a cache, as the reference's
        ``_remat`` wraps its MoE body; the dense blocks and the MTP head
        run unwrapped, as there."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = shard_act(self.embed.embed(tokens, compute_dtype))
        positions: Optional[torch.Tensor] = batch.get("positions")
        if positions is None:
            positions = (torch.arange(S, device=tokens.device)
                         + cache_index)[None].expand(B, S)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        n_dense = len(self.dense_layers)
        for i, block in enumerate(list(self.dense_layers) + list(self.layers)):
            mode = remat if cache is None and i >= n_dense else "none"
            x, aux = cm.remat(mode, block, x, positions, compute_dtype, impl,
                              cache_kv=self._layer_cache(cache, i),
                              cache_index=cache_index, absorbed=absorbed)
            if aux is not None:
                aux_total = aux_total + aux
        new_cache = None
        if cache is not None:
            new_cache = dict(cache, index=cache["index"] + S)
        x = cm.rmsnorm(x, self.final_norm, cfg.norm_eps)
        logits = self.embed.lm_head(x, compute_dtype)
        if not return_aux:
            return logits, new_cache
        mtp_logits = None
        if cfg.mtp_depth > 0 and cache is None:
            mtp_logits = self._mtp(x, positions, compute_dtype, impl)
        return logits, new_cache, {"aux_loss": aux_total,
                                   "mtp_logits": mtp_logits}

    def _mtp(self, x, positions, compute_dtype, impl: str):
        """The MTP head's logits from the trunk's final hidden states x (B,
        S, d): position t combines ``ln``(x_t) with x_{t+1} (zeros at the
        end). The reference's comment says the embedding of token t+1; its
        code, and so the port, takes the trunk's state (ROADMAP.md
        Queue 3 item 10)."""
        mp = self.mtp
        nxt = torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)
        h = torch.cat([cm.rmsnorm(x, mp.ln, self.cfg.norm_eps), nxt], dim=-1)
        h = h.to(compute_dtype) @ mp.proj.to(compute_dtype)
        h, _ = mp.layer(h, positions, compute_dtype, impl)
        return self.embed.lm_head(h, compute_dtype)

    def _layer_cache(self, cache: Optional[dict], i: int):
        """Layer i's views of the stacked cache (None without one)."""
        if cache is None:
            return None
        kv = cache["kv"]
        if self.cfg.use_mla:
            return kv["c_kv"][i], kv["k_rope"][i]
        return kv["k"][i], kv["v"][i]

    # -- serving ------------------------------------------------------------

    def input_specs(self, shape) -> dict:
        """The inputs of a ``ShapeConfig`` as ``meta`` tensors, the
        reference's ``input_specs``."""
        return cm.token_input_specs(shape)

    def cache_specs(self, batch_size: int, max_seq: int,
                    dtype=torch.bfloat16) -> dict:
        """The cache's leaves as ``CacheSpec``s, the reference's layout:
        ``kv`` holds MLA's c_kv (n_layers, B, max_seq, kv_lora_rank) and
        k_rope (n_layers, B, max_seq, 1, qk_rope_dim), or GQA's k and v
        (n_layers, B, max_seq, KV, head_dim); ``index`` the filled
        length."""
        cfg = self.cfg
        L = cfg.n_layers
        if cfg.use_mla:
            kv = {"c_kv": CacheSpec(
                      (L, batch_size, max_seq, cfg.kv_lora_rank), dtype,
                      "zeros", axes=("layers", "batch", "kv_len", "kv_rank")),
                  "k_rope": CacheSpec(
                      (L, batch_size, max_seq, 1, cfg.qk_rope_dim), dtype,
                      "zeros",
                      axes=("layers", "batch", "kv_len", None, "head_dim"))}
        else:
            shape = (L, batch_size, max_seq, cfg.n_kv_heads, cfg.head_dim_)
            kv = {"k": CacheSpec(shape, dtype, "zeros", axes=cm.KV_AXES),
                  "v": CacheSpec(shape, dtype, "zeros", axes=cm.KV_AXES)}
        return {"kv": kv, "index": CacheSpec((), torch.int32, "zeros")}

    def decode_step(self, cache: dict, tokens: torch.Tensor, *,
                    compute_dtype=torch.bfloat16):
        """tokens (B, 1) at position ``cache["index"]``; MLA in its
        absorbed form. Returns (logits, new_cache)."""
        B = tokens.shape[0]
        index = cache["index"]
        positions = torch.full((B, 1), index, dtype=torch.int64,
                               device=tokens.device)
        return self({"tokens": tokens, "positions": positions}, remat="none",
                    compute_dtype=compute_dtype, cache=cache,
                    cache_index=index, absorbed=self.cfg.use_mla)

    def prefill(self, batch: dict, cache: dict, *, remat: str = "none",
                compute_dtype=torch.bfloat16):
        """The prompt written into the cache from position 0 (MLA
        expanded). Returns (logits, new_cache)."""
        return self(batch, remat=remat, compute_dtype=compute_dtype,
                    cache=cache, cache_index=0)
