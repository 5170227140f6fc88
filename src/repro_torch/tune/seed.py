"""Cost-model pre-pass: prune the candidate grid before racing it
(DESIGN.md §9.3).

Racing a candidate costs real wall time; the grid is ~100 wide on the
card. This pass scores each fused candidate by an analytic model of one
``fused_epoch_pull`` launch at its (Q, B, T) shape — bytes and operations
from the shape alone, priced at the card's peaks (``repro_torch.hardware``,
the numbers ``chip_smoke.py`` takes its bounds against), plus a fixed cost
a launch — and ranks candidates by *achievable time per useful pulled
element*:

    e = (max(bytes / HBM rate, flops / fp32 rate) + LAUNCH_S) / (Q·B·T·block)

Low e = the launch amortizes its fixed cost over more useful coordinate
reads. Candidates worse than ``prune_ratio ×`` the best e are discarded;
the survivors (capped at ``max_candidates``) go to the measurement racer.
The identity candidate (the store's current config) is never pruned — the
racer must always be able to conclude "the defaults were already best",
and a model mis-prediction must never force a regression. ``rounds``
candidates (another driver) pass unscored.

The reference lowers the kernel through XLA and reads its cost analysis;
the model here counts what that analysis would: the pulled corpus blocks,
the matching query blocks, the block and arm ids, the (Q, B, 2) output,
and 3 flops a pulled element (difference, square or absolute value, sum).
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.hardware import FP32_FLOPS, HBM_BYTES_PER_S
from repro_torch.tune.candidates import TunedConfig

PROXY_Q = 8             # query rows of the modelled launch

#: fixed cost of one kernel launch, seconds: the host time of a short pull
#: call, 0.0155 ms by CUDA events against 0.0017 ms on the device for
#: ``block_pull`` (B 32, P 2) on an NVIDIA H100 80GB HBM3 at a 700.00 W
#: power limit (PERF.md, kernel table, row 5), which no launch of the
#: pull wrappers can hide
LAUNCH_S = 13.8e-6

#: flops of one pulled element: a difference, a square (or absolute
#: value) and a sum
FLOPS_PER_ELEMENT = 3.0

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def launch_work(Q: int, B: int, T: int, block: int,
                itemsize: int = 4) -> Tuple[float, float]:
    """(flops, bytes) of one ``fused_epoch_pull`` launch at (Q, B, T): each
    pulled corpus block and its query block read once, the int32 block
    and arm ids read once, the (Q, B, 2) fp32 output written once, 3
    flops a pulled element. The dry run prices the ``bmo-nn`` cells'
    launches with the same arithmetic."""
    elems = float(Q * B * T * block)
    nbytes = (2.0 * elems * itemsize + 4.0 * Q * B * T + 4.0 * Q * B
              + 8.0 * Q * B)
    return FLOPS_PER_ELEMENT * elems, nbytes


def launch_seconds(Q: int, B: int, T: int, block: int,
                   itemsize: int = 4) -> float:
    """Modelled seconds of one ``fused_epoch_pull`` launch at (Q, B, T):
    ``launch_work``'s bytes over the memory rate or its flops over the
    fp32 rate, whichever is longer, plus ``LAUNCH_S``."""
    flops, nbytes = launch_work(Q, B, T, block, itemsize)
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) + LAUNCH_S


def model_efficiency(cand: TunedConfig, *, Q: int, n: int, d_pad: int,
                     block: int, metric: str, dtype: str) -> float:
    """Modelled seconds per useful pulled element under the candidate
    (the reference's signature; ``d_pad`` and ``metric`` do not move a
    launch's cost in this model)."""
    T = cand.epoch_rounds * cand.pulls_per_round
    B = min(cand.batch_arms, n)
    useful = float(Q * B * T * block)
    return launch_seconds(Q, B, T, block,
                          _ITEMSIZE.get(dtype, 4)) / max(useful, 1.0)


def seed_candidates(store, cands: List[TunedConfig], *,
                    Q: int = PROXY_Q, max_candidates: int = 8,
                    prune_ratio: float = 3.0,
                    ) -> Tuple[List[TunedConfig], List[dict]]:
    """Model-score ``cands`` for ``store``; returns (survivors, report).

    Survivors are ordered best-model-score-first with the identity
    candidate (index 0 of ``cands``) always retained, at most
    ``max_candidates`` of them. Candidates the model cannot score (sparse
    stores, ``rounds`` candidates) pass through unpruned — the measurement
    racer is the ground truth.
    """
    if store.kind == "sparse":
        return list(cands), [{"cand": c.to_dict(), "e": None}
                             for c in cands]
    dtype = str(getattr(store, "shards", [store])[0].x.dtype).replace(
        "torch.", "")
    scored: List[Tuple[float, TunedConfig]] = []
    report = []
    for c in cands:
        if c.mode == "rounds":      # different driver — model not comparable
            scored.append((0.0, c))
            report.append({"cand": c.to_dict(), "e": None})
            continue
        e = model_efficiency(c, Q=Q, n=store.n_live, d_pad=store.d_pad,
                             block=store.block, metric=store.cfg.metric,
                             dtype=dtype)
        scored.append((e, c))
        report.append({"cand": c.to_dict(), "e": e})
    floor_e = min((e for e, _ in scored if e > 0.0), default=0.0)
    keep: List[TunedConfig] = []
    for i, (e, c) in enumerate(scored):
        if i == 0 or e == 0.0 or e <= prune_ratio * floor_e:
            keep.append(c)
    # best model score first; identity stays in regardless of rank
    order = {id(c): e for e, c in scored}
    ranked = sorted(keep[1:], key=lambda c: order[id(c)])
    survivors = [keep[0]] + ranked[: max(max_candidates - 1, 0)]
    return survivors, report
