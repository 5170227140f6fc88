"""Losses: the port of ``repro/train/loss.py``. Cross entropy is computed
in fp32 with a stable logsumexp, a chunk of _ROWS token rows at a time, in
the forward and (under autograd) in the backward, which recomputes each
chunk's softmax from the logits instead of keeping its fp32 copy."""
from __future__ import annotations

import torch

# the MoE family's loss weights, the reference's defaults: the
# load-balance aux and the MTP head's cross entropy
AUX_WEIGHT = 0.01
MTP_WEIGHT = 0.3
# token rows per logsumexp pass: the fp32 copy of (4, 4096, 152,064) bf16
# logits would take 10 GB at once, 2,048 rows take 1.2 GB
_ROWS = 2048


class _TokenNLL(torch.autograd.Function):
    """Per-row negative log-likelihood of (N, V) logits, a chunk of _ROWS
    rows at a time: lse − logit[label], the label's term 0 where
    ``in_range`` is false. The backward recomputes each chunk's softmax
    from the saved logits and the (N,) fp32 logsumexps, so no (N, V) fp32
    tensor outlives its chunk; its gradient, (softmax − one-hot)·g, is
    cast to the logits' type as the reference's cast transposes."""

    @staticmethod
    def forward(ctx, lf, idx, in_range):
        nll = torch.empty(idx.shape, dtype=torch.float32, device=lf.device)
        lse = torch.empty_like(nll)
        for s in range(0, lf.shape[0], _ROWS):
            rows = lf[s:s + _ROWS].to(torch.float32)
            ll = torch.gather(rows, 1, idx[s:s + _ROWS, None])[:, 0]
            lse[s:s + _ROWS] = torch.logsumexp(rows, dim=-1)
            nll[s:s + _ROWS] = (lse[s:s + _ROWS]
                                - torch.where(in_range[s:s + _ROWS], ll, 0.0))
        ctx.save_for_backward(lf, idx, in_range, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        lf, idx, in_range, lse = ctx.saved_tensors
        grad = torch.empty_like(lf)
        hot = in_range.to(torch.float32)
        for s in range(0, lf.shape[0], _ROWS):
            sl = slice(s, s + _ROWS)
            # one fp32 (rows, V) tensor, updated in place
            p = lf[sl].to(torch.float32, copy=True)
            p.sub_(lse[sl, None]).exp_()
            rows = torch.arange(p.shape[0], device=p.device)
            p[rows, idx[sl]] -= hot[sl]
            grad[sl] = p.mul_(g[sl, None])
        return grad, None, None


class _ShardedNLL(torch.autograd.Function):
    """``_TokenNLL`` over a vocabulary split across the ranks of ``group``:
    lf (N, V/m) holds this rank's columns, from ``v0`` on. The row's max
    and its sum of exponentials are reduced over the group (the max, then
    the sum), the label's logit taken by the rank that holds it and summed
    over the group; the backward's softmax is local. Every rank of the
    group returns the same (N,) values."""

    @staticmethod
    def forward(ctx, lf, idx, in_range, v0: int, group):
        import torch.distributed as dist
        rows = lf.to(torch.float32)
        m = torch.amax(rows, dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        se = torch.sum(torch.exp(rows - m[:, None]), dim=-1)
        dist.all_reduce(se, group=group)
        lse = m + torch.log(se)
        mine = in_range & (idx >= v0) & (idx < v0 + lf.shape[-1])
        loc = torch.where(mine, idx - v0, 0)
        ll = torch.where(mine, torch.gather(rows, 1, loc[:, None])[:, 0], 0.0)
        dist.all_reduce(ll, group=group)
        ctx.save_for_backward(lf, loc, mine, lse)
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        lf, loc, mine, lse = ctx.saved_tensors
        p = lf.to(torch.float32, copy=True)
        p.sub_(lse[:, None]).exp_()
        rows = torch.arange(p.shape[0], device=p.device)
        p[rows, loc] -= mine.to(torch.float32)
        return p.mul_(g[:, None]).to(lf.dtype), None, None, None, None


def _sharded_nll(logits, in_range, idx):
    """(B, S) nll of DTensor logits (B, S, V): the rows laid out as the
    rules lay out the batch, the vocabulary over the axis ``vocab`` maps
    to where it divides (``_ShardedNLL``), or whole (``_TokenNLL``)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding import context as sctx
    from repro_torch.sharding.spec import placements
    rules, mesh = sctx.current()
    want = placements(rules.pspec(("batch", None, "vocab"),
                                  tuple(logits.shape)), mesh)
    rows_pl = [Shard(0) if p == Shard(0) else Replicate() for p in want]
    vocab_dims = [i for i, p in enumerate(want) if p == Shard(2)]

    def local_nll(lf, ix, ok):
        B, S, Vl = lf.shape
        lf, ix, ok = lf.reshape(-1, Vl), ix.reshape(-1), ok.reshape(-1)
        if not vocab_dims:
            return _TokenNLL.apply(lf, ix, ok).reshape(B, S)
        dim = vocab_dims[0]
        v0 = mesh.get_local_rank(dim) * Vl
        return _ShardedNLL.apply(lf, ix, ok, v0,
                                 mesh.get_group(dim)).reshape(B, S)

    return sctx.local_call(local_nll, (logits, idx, in_range),
                           (want, rows_pl, rows_pl), rows_pl, mesh)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -100):
    """logits (B, S, V) any float type; labels (B, S) int. Returns (mean loss
    fp32, n_valid).

    The reference picks the label's logit with a one-hot contraction, which
    stays sharded with vocab-sharded logits; here one gather does it. The
    value is the same: the one-hot sum adds exact zeros. A label outside
    [0, V) picks 0, as its all-zero one-hot row does, and so takes no
    one-hot term in the gradient either. Logits laid out on a mesh
    (DTensors, under ``activation_sharding``) with the vocabulary split
    take the logsumexp as a cross-rank max and sum (``_ShardedNLL``)."""
    V = logits.shape[-1]
    mask = (labels != ignore_index).to(torch.float32)
    n = torch.clamp(torch.sum(mask), min=1.0)
    in_range = (labels >= 0) & (labels < V)
    idx = torch.where(in_range, labels, 0).to(torch.int64)
    from repro_torch.sharding import context as sctx
    if sctx.is_dtensor(logits):
        nll = _sharded_nll(logits, in_range, idx)
    else:
        nll = _TokenNLL.apply(logits.reshape(-1, V), idx.reshape(-1),
                              in_range.reshape(-1)).reshape(labels.shape)
    return torch.sum(nll * mask) / n, n


def lm_loss(model, batch: dict, *, remat: str = "full",
            compute_dtype=torch.bfloat16, impl: str = "auto"):
    """Next-token loss: (loss, metrics). ``labels`` in the batch are already
    aligned (labels[t] is the target of logits[t]); the batch holds what
    the family's forward reads (tokens; embeds and positions3 for the VLM;
    frames and decoder tokens for whisper, whose labels have the decoder's
    length). The reference's (model, params, batch) becomes (model,
    batch): the port's model holds its parameters. ``impl`` goes to the
    model's fused attention op. The MoE family adds its load-balance aux,
    averaged over the MoE layers, at AUX_WEIGHT (metric "aux"), and the
    MTP head's cross entropy against the labels shifted by one more
    position at MTP_WEIGHT (metric "mtp_ce")."""
    cfg = model.cfg
    if cfg.family != "moe":
        logits, _ = model(batch, remat=remat, compute_dtype=compute_dtype,
                          impl=impl)
        loss, n = cross_entropy(logits, batch["labels"])
        return loss, {"ce": loss, "tokens": n, "loss": loss}
    logits, _, extra = model(batch, remat=remat, compute_dtype=compute_dtype,
                             impl=impl, return_aux=True)
    labels = batch["labels"]
    ce, n = cross_entropy(logits, labels)
    aux = extra["aux_loss"] / max(cfg.n_layers - cfg.first_dense_layers, 1)
    loss = ce + AUX_WEIGHT * aux
    metrics = {"ce": ce, "tokens": n, "aux": aux}
    if extra["mtp_logits"] is not None:
        # MTP predicts token t+2 at position t
        mtp_labels = torch.cat([labels[:, 1:],
                                torch.full_like(labels[:, :1], -100)], dim=1)
        mtp_ce, _ = cross_entropy(extra["mtp_logits"], mtp_labels)
        loss = loss + MTP_WEIGHT * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics
