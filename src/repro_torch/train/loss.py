"""Losses, forward only: the port of ``repro/train/loss.py``. Cross entropy
is computed in fp32 with a stable logsumexp."""
from __future__ import annotations

import torch

# the MoE family's loss weights, the reference's defaults: the
# load-balance aux and the MTP head's cross entropy
AUX_WEIGHT = 0.01
MTP_WEIGHT = 0.3
# token rows per logsumexp pass: the fp32 copy of (4, 4096, 152,064) bf16
# logits would take 10 GB at once, 2,048 rows take 1.2 GB
_ROWS = 2048


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -100):
    """logits (B, S, V) any float type; labels (B, S) int. Returns (mean loss
    fp32, n_valid).

    The reference picks the label's logit with a one-hot contraction, which
    stays sharded with vocab-sharded logits; here one gather does it. The
    value is the same: the one-hot sum adds exact zeros. A label outside
    [0, V) picks 0, as its all-zero one-hot row does."""
    V = logits.shape[-1]
    lf = logits.reshape(-1, V)
    lab = labels.reshape(-1)
    in_range = (lab >= 0) & (lab < V)
    idx = torch.where(in_range, lab, 0).to(torch.int64)
    nll = torch.empty(lab.shape, dtype=torch.float32, device=logits.device)
    for s in range(0, lf.shape[0], _ROWS):
        rows = lf[s:s + _ROWS].to(torch.float32)
        ll = torch.gather(rows, 1, idx[s:s + _ROWS, None])[:, 0]
        nll[s:s + _ROWS] = (torch.logsumexp(rows, dim=-1)
                            - torch.where(in_range[s:s + _ROWS], ll, 0.0))
    mask = (labels != ignore_index).to(torch.float32)
    n = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(nll.reshape(labels.shape) * mask) / n, n


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
