"""SSM-family blocks and the xLSTM model: the port of
``repro/models/ssm.py``.

* Mamba2 (SSD) block: the chunk-parallel scan (a quadratic term inside each
  chunk of 256 positions, the state carried from chunk to chunk), and the
  O(1)-state recurrence for a one-token decode step. Zamba2
  (``models/hybrid.py``) stacks it.
* xLSTM: the mLSTM block (matrix memory, exponential gates, a stabiliser
  state) and the sLSTM block (scalar memory with a per-head recurrence),
  and the xlstm-350m model that interleaves them.

The recurrences step position by position in a Python loop, as the
reference's ``lax.scan`` does. Under autograd each chunk of SCAN_CHUNK
positions (and each SSD chunk) is recomputed in the backward, as the
reference's ``jax.checkpoint`` on its chunk bodies does, so a backward
keeps one state a chunk and one chunk's intermediates. What the reference
rounds, the port rounds in the same place: each mLSTM and sLSTM step's
output is stored in bf16 whatever the compute dtype, and every ``m``
stabiliser starts at −1e30. ``ssd_scan`` falls back to one chunk when the
length is not a multiple of the chunk, as the reference does: a (B, S, S,
H) fp32 mask then, so keep long prompts at multiples of 256.

With a cache, each block reads its state from the cache's views and writes
the new state back into them in place; the cache keeps the reference's
stacked layout, so ``load_jax_cache`` carries a reference cache across.
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

# the stabilisers' start, the reference's
M_INIT = -1e30
# positions a recomputed chunk of the mLSTM and sLSTM recurrences, the
# reference's ``chunked_scan`` chunk (a length it does not divide runs as
# one chunk)
SCAN_CHUNK = 256

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None, axis: str = "mlp"):
    """Depthwise causal convolution. x (B, S, C), w (k, C); ``state`` (B,
    k−1, C) holds the previous inputs (zeros without one). Returns (y, new
    state): y[t] = Σᵢ w[i]·x[t − (k−1) + i], summed in x's type from i = 0
    up, as the reference's Python ``sum``. Laid out on a mesh, each rank
    convolves its batch rows and channels (logical axis ``axis``)."""
    if sctx.is_dtensor(x):
        ax = ("batch", None, axis)
        return sctx.by_axes(causal_conv1d, (x, w, state),
                            (ax, ("conv", axis), ax), (ax, ax))
    k = w.shape[0]
    S = x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = w[0] * xp[:, 0:S]
    for i in range(1, k):
        y = y + w[i] * xp[:, i:i + S]
    return y, (xp[:, -(k - 1):] if k > 1 else None)


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """−softplus(−x), the reference's form of log σ(x)."""
    return -F.softplus(-x)


def _write_state(views: Optional[dict], new: dict) -> None:
    """Copy a block's new state into its cache views, in place."""
    if views is not None:
        for name, t in new.items():
            views[name].copy_(t)


def layer_views(tree: Optional[dict], i: int) -> Optional[dict]:
    """Layer i's views of a stacked state dict (None without a cache)."""
    if tree is None:
        return None
    return {name: t[i] for name, t in tree.items()}


# ---------------------------------------------------------------------------
# Mamba2 / SSD
# ---------------------------------------------------------------------------


def _ssd_chunk(x, dt, a, Bm, Cm, h0):
    """One SSD chunk. x (B, Q, H, p), dt and a (B, Q, H), Bm and Cm (B, Q,
    s), h0 (B, H, p, s) → (y (B, Q, H, p) fp32, h_new)."""
    l = torch.cumsum(a, dim=1)                                  # (B, Q, H)
    dtx = (x * dt[..., None]).to(torch.float32)
    diff = l[:, :, None, :] - l[:, None, :, :]                  # (B, Qi, Qj, H)
    Q = x.shape[1]
    ar = torch.arange(Q, device=x.device)
    causal = (ar[:, None] >= ar[None, :])[None, :, :, None]
    M = torch.where(causal, torch.exp(torch.where(causal, diff, -math.inf)),
                    0.0)
    Cf, Bf = Cm.to(torch.float32), Bm.to(torch.float32)
    CB = torch.einsum("bis,bjs->bij", Cf, Bf)
    W = M * CB[:, :, :, None]
    y_intra = torch.einsum("bijh,bjhp->bihp", W, dtx)
    y_inter = torch.einsum("bis,bhps->bihp", Cf, h0) * torch.exp(l)[..., None]
    decay_to_end = torch.exp(l[:, -1:, :] - l)                  # (B, Q, H)
    h_new = h0 * torch.exp(l[:, -1])[:, :, None, None] + torch.einsum(
        "bjhp,bjs->bhps", dtx * decay_to_end[..., None], Bf)
    return y_intra + y_inter, h_new


def ssd_scan(x, dt, A_log, Bm, Cm, h0, chunk: int = 256):
    """Chunk-parallel SSD. x (B, S, H, p); dt (B, S, H) fp32; Bm and Cm
    (B, S, s); h0 (B, H, p, s) fp32. Returns (y (B, S, H, p) fp32,
    h_final). S not a multiple of ``chunk`` runs as one chunk."""
    S = x.shape[1]
    if S % chunk != 0:
        chunk = S
    a = (-torch.exp(A_log.to(torch.float32)))[None, None, :] * dt
    h, ys = h0, []
    for s in range(0, S, chunk):
        sl = slice(s, s + chunk)
        y, h = cm.remat("full", _ssd_chunk, x[:, sl], dt[:, sl], a[:, sl],
                        Bm[:, sl], Cm[:, sl], h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


class Mamba2(nn.Module):
    """The reference's ``mamba2_block`` and its ``mamba2_specs``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        din = cfg.ssm_expand * D
        H = din // cfg.ssm_head_dim
        ds, k = cfg.ssm_state, cfg.ssm_conv
        p = cm.new_param
        self.wz = p((D, din), dtype, device, "fanin", axes=("embed", "mlp"))
        self.wx = p((D, din), dtype, device, "fanin", axes=("embed", "mlp"))
        self.wB = p((D, ds), dtype, device, "fanin",
                    axes=("embed", "ssm_state"))
        self.wC = p((D, ds), dtype, device, "fanin",
                    axes=("embed", "ssm_state"))
        self.wdt = p((D, H), dtype, device, "fanin",
                     axes=("embed", "ssm_heads"))
        self.conv_x = p((k, din), dtype, device, "fanin",
                        axes=("conv", "mlp"))
        self.conv_B = p((k, ds), dtype, device, "fanin",
                        axes=("conv", "ssm_state"))
        self.conv_C = p((k, ds), dtype, device, "fanin",
                        axes=("conv", "ssm_state"))
        self.A_log = p((H,), torch.float32, device, "scalar", 0.0,
                       axes=("ssm_heads",))
        self.D_skip = p((H,), torch.float32, device, "ones",
                        axes=("ssm_heads",))
        self.dt_bias = p((H,), torch.float32, device, "zeros",
                         axes=("ssm_heads",))
        self.gnorm = cm.norm_param(din, device)
        self.wo = p((din, D), dtype, device, "fanin", axes=("mlp", "embed"))

    def forward(self, x: torch.Tensor, state: Optional[dict] = None,
                compute_dtype=torch.bfloat16):
        """x (B, S, D) → (y (B, S, D) in x's type, new state). ``state``:
        None (zeros) or views of conv_x, conv_B, conv_C and h, written in
        place. One position takes the recurrent update, more the SSD
        scan."""
        cfg = self.cfg
        B, S, D = x.shape
        din = cfg.ssm_expand * D
        hd = cfg.ssm_head_dim
        H = din // hd
        cd = compute_dtype
        xc = x.to(cd)
        z = xc @ self.wz.to(cd)
        u = xc @ self.wx.to(cd)
        Bm = xc @ self.wB.to(cd)
        Cm = xc @ self.wC.to(cd)
        dt = xc @ self.wdt.to(cd)
        dt = F.softplus(dt.to(torch.float32) + self.dt_bias)

        st = state or {}
        u, cs_x = causal_conv1d(u, self.conv_x.to(cd), st.get("conv_x"))
        Bm, cs_B = causal_conv1d(Bm, self.conv_B.to(cd), st.get("conv_B"),
                                 "ssm_state")
        Cm, cs_C = causal_conv1d(Cm, self.conv_C.to(cd), st.get("conv_C"),
                                 "ssm_state")
        u = F.silu(u.to(torch.float32)).to(cd)
        Bm = F.silu(Bm.to(torch.float32)).to(cd)
        Cm = F.silu(Cm.to(torch.float32)).to(cd)

        uh = u.reshape(B, S, H, hd)
        h0 = st.get("h")
        if h0 is None:
            h0 = torch.zeros((B, H, hd, cfg.ssm_state), dtype=torch.float32,
                             device=x.device)
        if S == 1:                                   # decode: recurrent
            a = -torch.exp(self.A_log.to(torch.float32)) * dt[:, 0]   # (B, H)
            h_final = h0 * torch.exp(a)[:, :, None, None] + torch.einsum(
                "bhp,bn,bh->bhpn", uh[:, 0].to(torch.float32),
                Bm[:, 0].to(torch.float32), dt[:, 0])
            y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].to(torch.float32),
                             h_final)[:, None]
        else:
            y, h_final = sctx.by_axes(
                ssd_scan, (uh, dt, self.A_log, Bm, Cm, h0),
                (("batch", None, "ssm_heads", None),
                 ("batch", None, "ssm_heads"), ("ssm_heads",),
                 ("batch", None, None), ("batch", None, None),
                 ("batch", "ssm_heads", None, None)),
                (("batch", None, "ssm_heads", None),
                 ("batch", "ssm_heads", None, None)))
        y = y + uh.to(torch.float32) * self.D_skip[None, None, :, None]
        y = y.reshape(B, S, din).to(cd)
        y = cm.rmsnorm(y * F.silu(z.to(torch.float32)).to(cd), self.gnorm,
                       cfg.norm_eps)
        out = y @ self.wo.to(cd)
        new_state = {"conv_x": cs_x, "conv_B": cs_B, "conv_C": cs_C,
                     "h": h_final}
        _write_state(state, new_state)
        return out.to(x.dtype), new_state


def mamba2_state_specs(cfg: ModelConfig, n_layers: int, batch: int,
                       dtype=torch.bfloat16) -> dict:
    """The reference's ``mamba2_state_specs``: the conv inputs in ``dtype``
    and the SSD state h in fp32, stacked over ``n_layers``."""
    din = cfg.ssm_expand * cfg.d_model
    H = din // cfg.ssm_head_dim
    k, L = cfg.ssm_conv, n_layers
    return {
        "conv_x": CacheSpec((L, batch, k - 1, din), dtype, "zeros",
                            axes=("layers", "batch", "conv", "mlp")),
        "conv_B": CacheSpec((L, batch, k - 1, cfg.ssm_state), dtype, "zeros",
                            axes=("layers", "batch", "conv", "ssm_state")),
        "conv_C": CacheSpec((L, batch, k - 1, cfg.ssm_state), dtype, "zeros",
                            axes=("layers", "batch", "conv", "ssm_state")),
        "h": CacheSpec((L, batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                       torch.float32, "zeros",
                       axes=("layers", "batch", "ssm_heads", "head_dim",
                             "ssm_state")),
    }


# ---------------------------------------------------------------------------
# xLSTM: mLSTM block
# ---------------------------------------------------------------------------


def _chunks(S: int):
    """The position slices of the recomputed chunks of an S-long scan."""
    chunk = SCAN_CHUNK if S % SCAN_CHUNK == 0 else S
    return [slice(s, s + chunk) for s in range(0, S, chunk)]


#: None, or ``hook(fn, seqs, state, consts, n_chunks)`` run in place of
#: ``_scan_chunks``' loop over more than one chunk (the dry run installs
#: one while it counts: ``launch/dryrun.py`` ``_scan_first_chunk``)
SCAN_HOOK = None


def _scan_chunks(fn, seqs: tuple, state: tuple, consts: tuple = ()):
    """``fn(*chunks of seqs, *consts, *state) -> (*state, out)`` over the
    ``_chunks`` of the positions (dim 1) in order, each under
    ``cm.remat("full")``: (state, the outs concatenated along dim 1)."""
    slices = _chunks(seqs[0].shape[1])
    if SCAN_HOOK is not None and len(slices) > 1:
        return SCAN_HOOK(fn, seqs, state, consts, len(slices))
    outs = []
    for sl in slices:
        *state, out = cm.remat("full", fn, *(x[:, sl] for x in seqs),
                               *consts, *state)
        outs.append(out)
    return tuple(state), torch.cat(outs, dim=1)


def mlstm_scan(q, k, v, it, ft, C, n, m):
    """The reference's ``_mlstm_step`` over every position. q, k, v (B, S,
    H, dk); it and ft (B, S, H) fp32; the state C (B, H, dk, dk), n (B, H,
    dk), m (B, H) fp32. Returns ((C, n, m), hs (B, S, H, dk) bf16), a
    chunk of SCAN_CHUNK positions at a time (``cm.remat``)."""
    dk = q.shape[-1]
    ks = k.to(torch.float32) / math.sqrt(dk)
    return _scan_chunks(_mlstm_steps, (q.to(torch.float32), ks,
                                       v.to(torch.float32), it, ft),
                        (C, n, m))


def _mlstm_steps(qf, ks, vf, it, ft, C, n, m):
    """``mlstm_scan``'s positions of one chunk: (C, n, m, hs)."""
    hs = []
    for t in range(qf.shape[1]):
        i_t, f_t = it[:, t], ft[:, t]
        m_new = torch.maximum(f_t + m, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(f_t + m - m_new)
        k_t = ks[:, t]
        C = f_p[..., None, None] * C + i_p[..., None, None] * (
            k_t[..., :, None] * vf[:, t][..., None, :])
        n = f_p[..., None] * n + i_p[..., None] * k_t
        q_t = qf[:, t]
        num = torch.einsum("bhk,bhkv->bhv", q_t, C)
        den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", q_t, n)),
                          min=1.0)
        hs.append((num / den[..., None]).to(torch.bfloat16))
        m = m_new
    return C, n, m, torch.stack(hs, dim=1)


class MLSTMBlock(nn.Module):
    """The reference's ``mlstm_block`` and its ``mlstm_specs``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        din, H, k = 2 * D, cfg.n_heads, cfg.ssm_conv
        p = cm.new_param
        self.ln = cm.norm_param(D, device)
        self.wu = p((D, din), dtype, device, "fanin", axes=("embed", "mlp"))
        self.wzg = p((D, din), dtype, device, "fanin", axes=("embed", "mlp"))
        self.conv = p((k, din), dtype, device, "fanin", axes=("conv", "mlp"))
        self.wq = p((din, din), dtype, device, "fanin", axes=("mlp", None))
        self.wk = p((din, din), dtype, device, "fanin", axes=("mlp", None))
        self.wv = p((din, din), dtype, device, "fanin", axes=("mlp", None))
        self.wi = p((din, H), dtype, device, "fanin",
                    axes=("mlp", "ssm_heads"))
        self.wf = p((din, H), dtype, device, "fanin",
                    axes=("mlp", "ssm_heads"))
        self.bi = p((H,), torch.float32, device, "zeros", axes=("ssm_heads",))
        self.bf = p((H,), torch.float32, device, "scalar", 3.0,
                    axes=("ssm_heads",))
        self.gnorm = cm.norm_param(din, device)
        self.wo = p((din, D), dtype, device, "fanin", axes=("mlp", "embed"))

    def forward(self, x: torch.Tensor, state: Optional[dict] = None,
                compute_dtype=torch.bfloat16):
        """x (B, S, D) → (x + the block's output, new state). ``state``:
        None or views of conv, C, n and m, written in place."""
        cfg = self.cfg
        B, S, D = x.shape
        din, H = 2 * D, cfg.n_heads
        dk = din // H
        cd = compute_dtype
        xn = cm.rmsnorm(x, self.ln, cfg.norm_eps).to(cd)
        u = xn @ self.wu.to(cd)
        zg = xn @ self.wzg.to(cd)
        st = state or {}
        uc, conv_state = causal_conv1d(u, self.conv.to(cd), st.get("conv"))
        uc = F.silu(uc.to(torch.float32)).to(cd)
        q = (uc @ self.wq.to(cd)).reshape(B, S, H, dk)
        k = (uc @ self.wk.to(cd)).reshape(B, S, H, dk)
        v = (u @ self.wv.to(cd)).reshape(B, S, H, dk)
        # over a mesh the gate products' partial sums (their contraction
        # is split) are reduced into the heads' layout before the biases,
        # which are split over the heads
        bsh = ("batch", None, "ssm_heads")
        it = shard_act((uc @ self.wi.to(cd)).to(torch.float32), bsh) + self.bi
        ft = _log_sigmoid(shard_act(
            (uc @ self.wf.to(cd)).to(torch.float32), bsh) + self.bf)
        f32 = dict(dtype=torch.float32, device=x.device)
        C0 = st.get("C", torch.zeros((B, H, dk, dk), **f32))
        n0 = st.get("n", torch.zeros((B, H, dk), **f32))
        m0 = st.get("m", torch.full((B, H), M_INIT, **f32))
        bsh, bh = ("batch", None, "ssm_heads"), ("batch", "ssm_heads")
        (Cf, nf, mf), hs = sctx.by_axes(
            mlstm_scan, (q, k, v, it, ft, C0, n0, m0),
            (bsh + (None,),) * 3 + (bsh, bsh, bh + (None, None),
                                    bh + (None,), bh),
            ((bh + (None, None), bh + (None,), bh), bsh + (None,)))
        h = sctx.reshape(hs, B, S, din).to(cd)
        h = cm.rmsnorm(h, self.gnorm, cfg.norm_eps)
        h = h * F.silu(zg.to(torch.float32)).to(cd)
        out = h @ self.wo.to(cd)
        new_state = {"conv": conv_state, "C": Cf, "n": nf, "m": mf}
        _write_state(state, new_state)
        return x + shard_act(out.to(x.dtype)), new_state


# ---------------------------------------------------------------------------
# xLSTM: sLSTM block
# ---------------------------------------------------------------------------


def slstm_up_width(d_model: int) -> int:
    """The sLSTM block's up-projection: 4/3 of d_model rounded up to 128."""
    return max(((int(d_model * 4 / 3) + 127) // 128) * 128, 16)


def slstm_scan(wx, rg, c, n, h, m):
    """The reference's ``_slstm_step`` over every position. wx (B, S, 4D)
    fp32, the projected input; rg (H, dh, 4dh) fp32, the recurrent weights;
    the state c, n, h, m (B, H, dh) fp32. Returns ((c, n, h, m), hs (B, S,
    H, dh) bf16), a chunk of SCAN_CHUNK positions at a time
    (``cm.remat``)."""
    B, S = wx.shape[:2]
    H, dh = rg.shape[0], rg.shape[1]
    g_in = wx.reshape(B, S, H, 4 * dh)
    return _scan_chunks(_slstm_steps, (g_in,), (c, n, h, m), (rg,))


def _slstm_steps(g_in, rg, c, n, h, m):
    """``slstm_scan``'s positions of one chunk: (c, n, h, m, hs)."""
    hs = []
    for t in range(g_in.shape[1]):
        g = g_in[:, t] + torch.einsum("bhd,hdk->bhk", h, rg)
        zt, it, ft, ot = torch.chunk(g, 4, dim=-1)
        z = torch.tanh(zt)
        o = torch.sigmoid(ot)
        logf = _log_sigmoid(ft)
        m_new = torch.maximum(logf + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(logf + m - m_new)
        c = f_p * c + i_p * z
        n = f_p * n + i_p
        h = o * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h.to(torch.bfloat16))
    return c, n, h, m, torch.stack(hs, dim=1)


class SLSTMBlock(nn.Module):
    """The reference's ``slstm_block`` and its ``slstm_specs``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.cfg = cfg
        D, H = cfg.d_model, cfg.n_heads
        dh = D // H
        f_up = slstm_up_width(D)
        p = cm.new_param
        self.ln = cm.norm_param(D, device)
        self.wg = p((D, 4 * D), dtype, device, "fanin", axes=("embed", "mlp"))
        self.rg = p((H, dh, 4 * dh), dtype, device, "fanin",
                    axes=("ssm_heads", "head_dim", None))
        self.bg = p((4 * D,), torch.float32, device, "zeros", axes=("mlp",))
        self.gnorm = cm.norm_param(D, device)
        self.up = p((D, f_up), dtype, device, "fanin", axes=("embed", "mlp"))
        self.down = p((f_up, D), dtype, device, "fanin",
                      axes=("mlp", "embed"))

    def forward(self, x: torch.Tensor, state: Optional[dict] = None,
                compute_dtype=torch.bfloat16):
        """x (B, S, D) → (x + the block's output, new state). ``state``:
        None or views of c, n, h and m, written in place."""
        cfg = self.cfg
        B, S, D = x.shape
        H = cfg.n_heads
        dh = D // H
        cd = compute_dtype
        xn = cm.rmsnorm(x, self.ln, cfg.norm_eps).to(cd)
        wx = (xn @ self.wg.to(cd)).to(torch.float32) + self.bg
        st = state or {}
        f32 = dict(dtype=torch.float32, device=x.device)
        c0 = st.get("c", torch.zeros((B, H, dh), **f32))
        n0 = st.get("n", torch.zeros((B, H, dh), **f32))
        h0 = st.get("h", torch.zeros((B, H, dh), **f32))
        m0 = st.get("m", torch.full((B, H, dh), M_INIT, **f32))
        bhd = ("batch", "ssm_heads", None)
        (cf, nf, hf, mf), hs = sctx.by_axes(
            slstm_scan, (sctx.reshape(wx, B, S, H, 4 * dh),
                         self.rg.to(torch.float32), c0, n0, h0, m0),
            (("batch", None, "ssm_heads", None), ("ssm_heads", None, None))
            + (bhd,) * 4,
            ((bhd,) * 4, ("batch", None, "ssm_heads", None)))
        h = sctx.reshape(hs, B, S, D).to(cd)
        h = cm.rmsnorm(h, self.gnorm, cfg.norm_eps)
        up = F.gelu((h @ self.up.to(cd)).to(torch.float32),
                    approximate="tanh").to(cd)
        out = up @ self.down.to(cd)
        new_state = {"c": cf, "n": nf, "h": hf, "m": mf}
        _write_state(state, new_state)
        return x + shard_act(out.to(x.dtype)), new_state


# ---------------------------------------------------------------------------
# xLSTM model (alternating mLSTM / sLSTM stacks)
# ---------------------------------------------------------------------------


class XLSTM(nn.Module):
    """xlstm-350m: ``n_layers`` blocks in groups of ``m_per_group`` mLSTM
    blocks and one sLSTM block (every ``slstm_every``-th block). Parameters
    keep the reference's tree (``mlstm.<i>.wq``, ``slstm.<j>.rg``, …; the
    reference stacks each kind), drawn on ``device`` from ``rng`` as
    ``DenseLM``'s; norms and the gate biases are fp32.

    The cache holds ``m_state`` (the mLSTM states, stacked over all mLSTM
    blocks in order) and ``s_state`` (the sLSTM states, one a group), as the
    reference's concatenation and stacking lay them out, and ``index``, a
    host int. It has no length: ``cache_specs`` ignores ``max_seq``."""

    stacked = ("mlstm", "slstm")

    def __init__(self, cfg: ModelConfig, *, param_dtype=torch.float32,
                 device=None, rng=0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        se = cfg.slstm_every or 0
        self.n_slstm = cfg.n_layers // se if se else 0
        self.n_mlstm = cfg.n_layers - self.n_slstm
        self.groups = max(self.n_slstm, 1)
        if self.n_mlstm % self.groups:
            raise ValueError(f"{self.n_mlstm} mLSTM blocks do not split into "
                             f"{self.groups} groups")
        self.m_per_group = self.n_mlstm // self.groups
        self.embed = cm.Embed(cfg, param_dtype, device)
        self.mlstm = nn.ModuleList(MLSTMBlock(cfg, param_dtype, device)
                                   for _ in range(self.n_mlstm))
        self.slstm = nn.ModuleList(SLSTMBlock(cfg, param_dtype, device)
                                   for _ in range(self.n_slstm))
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
        """The reference's layout: the mLSTM states (conv inputs, C, n in
        fp32, m starting at −1e30) and the sLSTM states (c, n, h, and m at
        −1e30), each stacked over its blocks."""
        cfg = self.cfg
        din, H = 2 * cfg.d_model, cfg.n_heads
        dk, dh = din // H, cfg.d_model // H
        L, B, f32 = self.n_mlstm, batch_size, torch.float32
        spec = {"m_state": {
            "conv": CacheSpec((L, B, cfg.ssm_conv - 1, din), f32, "zeros",
                              axes=("layers", "batch", "conv", "mlp")),
            "C": CacheSpec((L, B, H, dk, dk), f32, "zeros",
                           axes=("layers", "batch", "ssm_heads", "head_dim",
                                 None)),
            "n": CacheSpec((L, B, H, dk), f32, "zeros",
                           axes=("layers", "batch", "ssm_heads", "head_dim")),
            "m": CacheSpec((L, B, H), f32, "scalar", M_INIT,
                           ("layers", "batch", "ssm_heads"))},
            "index": CacheSpec((), torch.int32, "zeros")}
        if self.n_slstm:
            shape = (self.n_slstm, B, H, dh)
            ax = ("layers", "batch", "ssm_heads", "head_dim")
            spec["s_state"] = {
                "c": CacheSpec(shape, f32, "zeros", axes=ax),
                "n": CacheSpec(shape, f32, "zeros", axes=ax),
                "h": CacheSpec(shape, f32, "zeros", axes=ax),
                "m": CacheSpec(shape, f32, "scalar", M_INIT, ax)}
        return spec

    def forward(self, batch: dict, *, remat: str = "full",
                compute_dtype=torch.bfloat16, impl: str = "auto",
                cache: Optional[dict] = None, cache_index: int = 0):
        """batch: {"tokens": (B, S)}. Returns (logits (B, S, V), new_cache):
        None without a cache; with one, its states written in place and
        ``index`` advanced by S. ``remat`` and ``impl`` are accepted for a
        common signature and do nothing here: the reference wraps no
        xLSTM block in ``_remat`` (its scans recompute by chunk, as
        ``mlstm_scan`` and ``slstm_scan`` do), and there is no
        attention."""
        tokens = batch["tokens"]
        x = shard_act(self.embed.embed(tokens, compute_dtype))
        m_tree = cache["m_state"] if cache is not None else None
        s_tree = cache.get("s_state") if cache is not None else None
        for gi in range(self.groups):
            for j in range(self.m_per_group):
                li = gi * self.m_per_group + j
                x, _ = self.mlstm[li](x, layer_views(m_tree, li),
                                      compute_dtype)
            if self.n_slstm:
                x, _ = self.slstm[gi](x, layer_views(s_tree, gi),
                                      compute_dtype)
        x = cm.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        logits = self.embed.lm_head(x, compute_dtype)
        new_cache = None
        if cache is not None:
            new_cache = dict(cache, index=cache["index"] + tokens.shape[1])
        return logits, new_cache

    def decode_step(self, cache: dict, tokens: torch.Tensor, *,
                    compute_dtype=torch.bfloat16):
        """tokens (B, 1) after the cached state. Returns (logits,
        new_cache)."""
        return self(
            {"tokens": tokens}, remat="none", compute_dtype=compute_dtype,
            cache=cache, cache_index=cache["index"])

    def prefill(self, batch: dict, cache: dict, *, remat: str = "none",
                compute_dtype=torch.bfloat16):
        return self(batch, remat=remat, compute_dtype=compute_dtype,
                    cache=cache, cache_index=0)
