"""Plain PyTorch versions of the ported kernels: what the CPU runs, and what
the CUDA kernels are held against on the card."""
from __future__ import annotations

import math
from typing import Optional

import torch


def fwht_ref(x: torch.Tensor) -> torch.Tensor:
    """Normalized fast Walsh–Hadamard transform along the last axis,
    Sylvester (natural) order. x (..., d), d a power of two; computed in
    fp32 and cast back to the input type."""
    d = x.shape[-1]
    assert d & (d - 1) == 0, f"d={d} not a power of two"
    orig_shape = x.shape
    y = x.to(torch.float32).reshape(-1, d)
    r = y.shape[0]
    blocks = 1
    while blocks < d:
        y = y.reshape(r, blocks, 2, d // (2 * blocks))
        a = y[:, :, 0, :]
        b = y[:, :, 1, :]
        y = torch.cat([a + b, a - b], dim=-1)
        blocks *= 2
    return (y.reshape(orig_shape) / math.sqrt(d)).to(x.dtype)


def _butterfly(t: torch.Tensor, dim: int, bit: int) -> torch.Tensor:
    """(a, b) → (a + b, a − b) over bit ``bit`` of axis ``dim``."""
    t = t.movedim(dim, -1)
    shape = t.shape
    t = t.reshape(*shape[:-1], shape[-1] >> (bit + 1), 2, 1 << bit)
    t = torch.stack([t[..., 0, :] + t[..., 1, :],
                     t[..., 0, :] - t[..., 1, :]], dim=-2)
    return t.reshape(shape).movedim(-1, dim)


def _layout_order(layout, n: int) -> list:
    """Axes of a (blocks, 2, …, 2) tile (axis 1 + n − 1 − b holds bit b)
    in the order warp, lane, register bits, most significant first."""
    bits = (*layout.warp[::-1], *layout.lane[::-1], *layout.reg[::-1])
    if sorted(bits) != list(range(n)):
        raise ValueError(f"layout {layout} does not cover the {n} tile bits "
                         "once each")
    return [0] + [1 + n - 1 - b for b in bits]


def _to_threads(tile: torch.Tensor, layout, n: int) -> torch.Tensor:
    """A (blocks, 2**n) tile → (blocks, warps, 32, E) registers."""
    blocks = tile.shape[0]
    t = tile.reshape(blocks, *([2] * n)).permute(_layout_order(layout, n))
    return t.reshape(blocks, -1, 32, 1 << len(layout.reg))


def _to_tile(regs: torch.Tensor, layout, n: int) -> torch.Tensor:
    """Inverse of ``_to_threads``."""
    blocks = regs.shape[0]
    order = _layout_order(layout, n)
    t = regs.reshape(blocks, *([2] * n)).permute(
        [order.index(a) for a in range(n + 1)])
    return t.reshape(blocks, 1 << n)


def _stage(regs: torch.Tensor, layout, bit: int) -> torch.Tensor:
    if bit in layout.reg:
        return _butterfly(regs, 3, layout.reg.index(bit))
    return _butterfly(regs, 2, layout.lane.index(bit))


def fwht_staged(x: torch.Tensor, plan) -> torch.Tensor:
    """``fwht_ref`` computed as ``csrc/fwht.cu`` computes it under ``plan``
    (``kernels/fwht_plan.py``): rows padded with zeros to whole blocks (the
    masked ones), each tile spread over (warps, lanes, registers) by the
    load layout, the register stages, the lane stages (the shuffles), then
    (wide) each value written to its shared-memory slot and read back into
    the store layout, the last register stages, and the tile gathered from
    the store layout. Same stages in the same order, so on the same values
    it is the kernel's arithmetic."""
    d = x.shape[-1]
    if plan.d != d:
        raise ValueError(f"plan for d={plan.d}, input d={d}")
    y = x.to(torch.float32).reshape(-1, d)
    rows = y.shape[0]
    per = plan.rows_per_block
    blocks = -(-rows // per)
    n = plan.tile_log
    tile = torch.nn.functional.pad(y, (0, 0, 0, blocks * per - rows))
    regs = _to_threads(tile.reshape(blocks, 1 << n), plan.load, n)
    for bit in plan.reg_stages_load + plan.lane_stages:
        regs = _stage(regs, plan.load, bit)
    if plan.wide:
        slot = torch.tensor([plan.smem_addr(i) for i in range(1 << n)],
                            device=y.device)
        smem = torch.full((blocks, 1 << n), float("nan"), device=y.device)
        smem[:, slot] = _to_tile(regs, plan.load, n)
        regs = _to_threads(smem[:, slot], plan.store, n)
        for bit in plan.reg_stages_store:
            regs = _stage(regs, plan.store, bit)
    out = _to_tile(regs, plan.store, n).reshape(blocks * per, d)[:rows]
    return (out / math.sqrt(d)).to(x.dtype).reshape(x.shape)


def block_pull_multi_ref(x: torch.Tensor, qs: torch.Tensor,
                         arm_idx: torch.Tensor, blk_idx: torch.Tensor,
                         block: int, metric: str = "l2") -> torch.Tensor:
    """Cross-query batched pull: the mean over ``block`` coordinates of
    ``(x[arm, blk·block:+block] − qs[q, same])²`` (or ``|·|`` for ℓ1).
    x (n, d_pad); qs (Q, d_pad); arm_idx (Q, B); blk_idx (Q, B, P).
    Returns (Q, B, P) fp32. A negative arm id marks a lane the caller
    discards: its pulls are 0."""
    n, d_pad = x.shape
    Q = qs.shape[0]
    nb = d_pad // block
    xb = x.reshape(n, nb, block)
    qb = qs.reshape(Q, nb, block)
    blk = blk_idx.long()
    skip = arm_idx < 0
    arm = torch.where(skip, 0, arm_idx).long()
    rows = xb[arm[:, :, None], blk]                              # (Q, B, P, block)
    qrows = qb[torch.arange(Q, device=qs.device)[:, None, None], blk]
    diff = rows.to(torch.float32) - qrows.to(torch.float32)
    if metric == "l1":
        v = torch.sum(torch.abs(diff), dim=-1)
    else:
        v = torch.sum(diff * diff, dim=-1)
    return torch.where(skip[..., None], 0.0, v / block).to(torch.float32)


def block_pull_ref(x: torch.Tensor, q: torch.Tensor, arm_idx: torch.Tensor,
                   blk_idx: torch.Tensor, block: int,
                   metric: str = "l2") -> torch.Tensor:
    """The single-query pull (the paper's Monte-Carlo pull, block form):
    x (n, d_pad); q (d_pad,); arm_idx (B,); blk_idx (B, P). Returns (B, P)
    fp32 per-block mean coordinate-wise distances."""
    return block_pull_multi_ref(x, q[None], arm_idx[None], blk_idx[None],
                                block, metric)[0]


def fused_epoch_pull_ref(x: torch.Tensor, qs: torch.Tensor,
                         arm_idx: torch.Tensor, blk_idx: torch.Tensor,
                         block: int, metric: str = "l2") -> torch.Tensor:
    """Round-fused epoch pull: T block pulls per (query, arm), reduced to
    Welford batch statistics. arm_idx (Q, B); blk_idx (Q, B, T). Returns
    (Q, B, 2) fp32: (mean, M2) of each arm's T pulled values. A negative
    arm id marks a lane the caller discards: its result is (0, 0)."""
    vals = block_pull_multi_ref(x, qs, arm_idx, blk_idx, block, metric)
    mean = torch.mean(vals, dim=-1)
    m2 = torch.sum(torch.square(vals - mean[..., None]), dim=-1)
    return torch.stack([mean, m2], dim=-1)


def pairwise_dist_ref(qs: torch.Tensor, x: torch.Tensor, metric: str = "l2",
                      chunk: int = 2048) -> torch.Tensor:
    """Exact distances. qs (Q, d), x (n, d) → (Q, n) fp32 SUM-form
    distances (ℓ2² or ℓ1), accumulated in fp32 over d-chunks. ℓ2 takes the
    reference's ‖q‖² + ‖x‖² − 2 q·xᵀ form per chunk, so that it matches the
    JAX package on the CPU (on the card, run it with TF32 off)."""
    Q, d = qs.shape
    n = x.shape[0]
    out = torch.zeros((Q, n), dtype=torch.float32, device=qs.device)
    for start in range(0, d, chunk):
        qc = qs[:, start:start + chunk].to(torch.float32)
        xc = x[:, start:start + chunk].to(torch.float32)
        if metric == "l1":
            out = out + torch.sum(torch.abs(qc[:, None, :] - xc[None, :, :]),
                                  dim=-1)
        else:
            out = out + (torch.sum(qc * qc, -1)[:, None]
                         + torch.sum(xc * xc, -1)[None, :] - 2.0 * qc @ xc.T)
    return out


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """fp32 → TF32 (10 mantissa bits) rounded to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``: on the int32 view, add half of the 13
    dropped bits' unit and clear them. Finite inputs."""
    i = a.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncate(a: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an fp32 operand of a TF32 product: its
    13 low mantissa bits cleared."""
    i = a.to(torch.float32).contiguous().view(torch.int32)
    return (i & -0x2000).view(torch.float32)


def pairwise_l2_split_tf32(qs: torch.Tensor, x: torch.Tensor,
                           flag_ratio: Optional[float] = None,
                           slice_cols: int = 32) -> tuple:
    """A plain replay of the tensor-core ℓ2 kernel's arithmetic
    (``csrc/pairwise_dist_sm90.cu``), for the tests: (Q, n) fp32 values and
    the (Q, n) mask of the pairs it repaired.

    Each operand splits as a_hi = tf32_round(a), a_lo = a − a_hi (exact),
    and the products read a_lo as TF32 (``tf32_truncate``). Each
    ``slice_cols``-wide slice of the cross term sums q_hi·x_lo + q_lo·x_hi
    + q_hi·x_hi into a fresh fp32 sum (the products of two TF32 values are
    exact in fp32), added to a master sum; then ‖q‖² + ‖x‖² − 2·master.
    With ``flag_ratio`` (the kernel's ``flag_ratio(d)``), every entry at
    most flag_ratio·(‖q‖² + ‖x‖²) is recomputed as Σ(q − x)² in fp32, as the
    repair pass does; without it nothing is repaired. What it does not
    replay is the tensor cores' truncating accumulation inside a slice:
    here that sum rounds to nearest."""
    qs = qs.to(torch.float32)
    x = x.to(torch.float32)
    (Q, d), n = qs.shape, x.shape[0]
    qh, xh = tf32_round(qs), tf32_round(x)
    ql, xl = tf32_truncate(qs - qh), tf32_truncate(x - xh)
    master = torch.zeros((Q, n), dtype=torch.float32, device=qs.device)
    for s in range(0, d, slice_cols):
        c = slice(s, s + slice_cols)
        master += (qh[:, c] @ xl[:, c].T + ql[:, c] @ xh[:, c].T
                   + qh[:, c] @ xh[:, c].T)
    scale = torch.sum(qs * qs, -1)[:, None] + torch.sum(x * x, -1)[None, :]
    out = scale - 2.0 * master
    if flag_ratio is None:
        return out, torch.zeros_like(out, dtype=torch.bool)
    flagged = out <= flag_ratio * scale
    qi, ri = torch.nonzero(flagged, as_tuple=True)
    out[qi, ri] = torch.sum(torch.square(qs[qi] - x[ri]), -1)
    return out, flagged


def _flash_probs(q: torch.Tensor, k: torch.Tensor, causal: bool,
                 q_offset: int) -> tuple:
    """The fp32 probabilities p = exp(s − max s), (B, KV, G, Sq, Sk), and
    their row sums l, (B, KV, G, Sq, 1), of ``flash_attention_ref``."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads over {KV} KV heads")
    qg = q.to(torch.float32).reshape(B, KV, H // KV, Sq, D)
    kf = k.to(torch.float32)
    # in place from here on: at (1, 40, 4096, 4096) the scores take 2.7 GB
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf).mul_(1.0 / math.sqrt(D))
    if causal:
        q_pos = torch.arange(Sq, device=q.device) + q_offset
        k_pos = torch.arange(Sk, device=q.device)
        s.masked_fill_(k_pos[None, :] > q_pos[:, None], -1e30)
    p = s.sub_(torch.amax(s, dim=-1, keepdim=True)).exp_()
    return p, torch.sum(p, dim=-1, keepdim=True)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0,
                        p_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Attention as the fused flash-attention kernel computes it, in one
    pass. q (B, H, Sq, D); k (B, KV, Sk, D) and v (B, KV, Sk, Dv) with
    H % KV == 0, query head h reading KV head h // (H / KV) (KV = H is the
    reference's wrapper, which repeats the KV heads). Scores in fp32 times
    1/√D; the causal mask keeps keys at ``k_pos ≤ q_pos + q_offset`` and
    gives the rest −1e30 (not −inf); fp32 softmax with the probabilities
    kept in fp32 for the product with v (``p_dtype=torch.bfloat16`` rounds
    them to bf16 there, as the tensor-core kernel does; the normaliser
    always sums the fp32 values); the normaliser floored at 1e-30.
    Returns (B, H, Sq, Dv) in q's type."""
    B, H, Sq, _ = q.shape
    p, l = _flash_probs(q, k, causal, q_offset)
    if p_dtype != torch.float32:
        p.copy_(p.to(p_dtype))
    acc = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, Sq, v.shape[-1]).to(q.dtype)


def flash_attention_tc_bounds(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              q_offset: int = 0) -> list:
    """What a bf16 output of the tensor-core flash kernel is held to, as
    [(name, want, limit)]: |got − want| ≤ limit elementwise for each.

    * "p_bf16": the plain version with p rounded to bf16, the kernel's
      contract. The two round the same p, but the kernel rounds it relative
      to the running max and rescales by exp(m_t − m) afterwards, so where
      a key tile came before the row's max the two roundings differ:
      got − want = Σⱼ δⱼpⱼvⱼ / l with |δⱼ| ≤ 2·2⁻⁸ and δⱼ independent, of
      mean 0. With R = √(Σⱼ pⱼ²vⱼ²) / l (per output), Cauchy–Schwarz bounds
      it by 2·2⁻⁸·√n·R over n keys: by 6·2⁻⁸·R outright for rows of up to
      9 keys. Over more keys its standard deviation is at most
      2⁻⁸·√(2/3)·R, so 6·2⁻⁸·R is over 7 deviations. Limit: 6·2⁻⁸·R +
      8e-3·|want| (one bf16 ulp of the output, which both round) +
      1e-4·max|v| (fp32 rounding of scores that spread over hundreds).
    * "p_fp32": the plain version itself. Rounding p to bf16 moves an output
      by at most 2⁻⁸·max|v| (|Σⱼ(p̂ⱼ − pⱼ)vⱼ| / l ≤ 2⁻⁸·Σⱼ pⱼ|vⱼ| / l).
      Limit: (2⁻⁸ + 1e-4)·max|v| + 8e-3·|want|.

    The rounding spread R is taken one batch element at a time (the
    scores of (1, 40, 4096, 4096) take 2.7 GB)."""
    B, H, Sq, _ = q.shape
    vmax = float(v.abs().max())
    spread = []
    for b in range(B):
        p, l = _flash_probs(q[b:b + 1], k[b:b + 1], causal, q_offset)
        spread.append(torch.einsum("bkgqs,bksd->bkgqd", p.square_(),
                                   v[b:b + 1].to(torch.float32).square())
                      .sqrt_() / torch.clamp(l, min=1e-30))
        del p
    spread = torch.cat(spread).reshape(B, H, Sq, v.shape[-1])
    out = []
    for name, p_dtype, atol in (
            ("p_bf16", torch.bfloat16, 1e-4 * vmax + 6 * 2.0 ** -8 * spread),
            ("p_fp32", torch.float32, (2.0 ** -8 + 1e-4) * vmax)):
        want = flash_attention_ref(q, k, v, causal, q_offset, p_dtype)
        out.append((name, want, 8e-3 * want.to(torch.float32).abs() + atol))
    return out
