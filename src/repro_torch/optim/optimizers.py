"""Optimizers, the reference's formulas (``repro/optim/optimizers.py``) on
name → tensor dicts: AdamW, Adafactor and SGD, each an ``Optimizer`` with
the reference's contract, ``init(params) -> state`` and ``update(grads,
state, params, step, lr) -> (params, state)``. They are not
``torch.optim.AdamW`` or ``torch.optim.Adafactor``, whose update orders
and algorithms differ from the reference's.

``update`` works in fp32 and in place, under ``torch.no_grad()``: the
parameters (fp32 or bf16) and the fp32 state are overwritten, and the same
dicts are returned. It goes through a leaf a slice along its first axis at
a time (at most SLICE_ELEMS elements), so the fp32 temporaries of
dbrx-132b's (16, 6,144, 10,752) bf16 experts take one expert's 264 MB
each, not 4.2 GB. Adafactor's leaves are the reference's stacked ones and
its update clip spans a whole leaf, so it takes three passes over one
(``adafactor``).

``step`` and ``lr`` may be ints, floats or 0-dim tensors; the step-derived
constants are computed on the host in fp32, as the reference computes
them on the device.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.sharding.context import is_dtensor

# elements a slice of a leaf, at most (a whole leaf when it is smaller)
SLICE_ELEMS = 1 << 25


class Optimizer(NamedTuple):
    init: Callable    # params -> opt_state
    update: Callable  # (grads, opt_state, params, step, lr) -> (params, opt_state)


def _f32(x) -> np.float32:
    """A host fp32 scalar of an int, a float or a 0-dim tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to(torch.float32).cpu().item()
    return np.float32(x)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (a view: writes reach the DTensor);
    a plain tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def row_slices(t: torch.Tensor):
    """Slices along t's first axis covering it, each at most SLICE_ELEMS
    elements (at least one row); the whole tensor for a vector or one that
    fits, and for a DTensor, whose slices along a sharded dim would gather
    it (each rank's shard is a part of the leaf already)."""
    max_elems = SLICE_ELEMS
    if t.dim() < 2 or t.numel() <= max_elems or is_dtensor(t):
        return [...]
    per = max(1, max_elems // max(t[0].numel(), 1))
    return [slice(s, s + per) for s in range(0, t.shape[0], per)]


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    """Adam with decoupled weight decay: fp32 ``m`` and ``v`` a parameter
    (3× the parameters' memory at fp32), bias-corrected, the decay added
    to the normalised step."""

    def init(params: Dict[str, torch.Tensor]) -> dict:
        # zeros_like: a DTensor parameter's state is a DTensor of its layout
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": {n: zeros(p) for n, p in params.items()},
                "v": {n: zeros(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step, lr):
        t = _f32(step) + np.float32(1.0)
        c1 = float(np.float32(1.0) - np.float32(b1) ** t)
        c2 = float(np.float32(1.0) - np.float32(b2) ** t)
        lr = float(_f32(lr))
        for name, p in params.items():
            # elementwise: each rank updates its own shards
            p, g, m, v = (local(t) for t in (p, grads[name], state["m"][name],
                                             state["v"][name]))
            for sl in row_slices(p):
                gs = g[sl].to(torch.float32)
                ms, vs = m[sl], v[sl]
                ms.mul_(b1).add_(gs * (1 - b1))
                vs.mul_(b2).add_(gs * gs * (1 - b2))
                delta = (ms / c1).div_((vs / c2).sqrt_().add_(eps))
                pf = p[sl].to(torch.float32)
                delta.add_(pf * weight_decay)
                p[sl] = pf.sub_(delta.mul_(lr))
        return params, state

    return Optimizer(init, update)


def stack_groups(params: Dict[str, torch.Tensor], stacked=()) -> dict:
    """The reference's leaves over the port's parameters: a name under a
    stacked module list (``stacked``, a model's ``stacked``: ``layers.3.
    attn.wq``) joins its siblings of every layer, in layer order, under
    the reference's path (``layers.attn.wq``), the leaf the reference
    stacks along a leading axis; any other name is a leaf of its own.
    Returns {leaf name: [parameter names]}."""
    groups: dict = {}
    index: dict = {}
    for name in params:
        head, _, rest = name.partition(".")
        layer, _, sub = rest.partition(".")
        if head in stacked and layer.isdigit() and sub:
            key = f"{head}.{sub}"
            groups.setdefault(key, []).append(name)
            index[name] = int(layer)
        else:
            groups[name] = [name]
    for key, names in groups.items():
        if names[0] in index:
            names.sort(key=index.__getitem__)
            if [index[n] for n in names] != list(range(len(names))):
                raise ValueError(f"{key}: layers {[index[n] for n in names]}")
    return groups


def _leaf_shape(params, names, stacked: bool) -> tuple:
    shape = tuple(params[names[0]].shape)
    return (len(names),) + shape if stacked else shape


def adafactor(eps: float = 1e-30, clip_rms: float = 1.0,
              decay_pow: float = 0.8, weight_decay: float = 0.0, *,
              stacked=()) -> Optimizer:
    """Factored second moments (Shazeer & Stern 2018): a leaf of rank ≥ 2
    keeps its row means ``r`` (its shape without the last axis) and its
    column means ``c`` (without the second-to-last) of g² + eps, a vector
    its full ``v``. β1 = 0, β2 = 1 − t^−decay_pow, the update clipped by
    its RMS over the leaf.

    The leaves are the reference's (``stack_groups``): the reference
    stacks the layers of a module list along a leading axis, so a norm
    weight (d,) is a (L, d) leaf there, factored across the layers (its
    ``c`` shared by them), and every stacked leaf's RMS clip spans all its
    layers. The state is keyed by the reference's leaf names with its
    shapes. A leaf goes a piece at a time: a layer, or a slice of a
    layer's matrices along its first axis, or rows of a matrix (whose
    column means gather over the rows first), each at most SLICE_ELEMS
    elements where the layout allows: a pass for r and c, one for the RMS
    and one for the update."""

    def init(params: Dict[str, torch.Tensor]) -> dict:
        state = {}
        for key, names in stack_groups(params, stacked).items():
            shape = _leaf_shape(params, names, key != names[0])
            z = dict(dtype=torch.float32, device=params[names[0]].device)
            if len(shape) >= 2:
                state[key] = {"r": torch.zeros(shape[:-1], **z),
                              "c": torch.zeros(shape[:-2] + shape[-1:], **z)}
            else:
                state[key] = {"v": torch.zeros(shape, **z)}
        return state

    def pieces(ps, gs, s, is_stack: bool):
        """(p, g, r, c) views covering a factored leaf; c is None where
        the leaf is a matrix (rank 2), whose c spans all its rows."""
        r, c = s["r"], s["c"]
        if not is_stack:
            ps, gs, r, c = [ps[0]], [gs[0]], [r], [c]
            rank = ps[0].dim()
            if rank == 2:                    # row blocks of a matrix
                return [(ps[0][sl], gs[0][sl], r[0][sl], None)
                        for sl in row_slices(ps[0])]
        elif ps[0].dim() == 1:               # stacked vectors: one row each
            return [(p[None], g[None], r[i:i + 1], None)
                    for i, (p, g) in enumerate(zip(ps, gs))]
        out = []
        for p, g, ri, ci in zip(ps, gs, r, c):
            parts = row_slices(p) if p.dim() >= 3 else [...]
            out += [(p[sl], g[sl], ri[sl], ci[sl]) for sl in parts]
        return out

    def g2_of(g):
        g = g.to(torch.float32)
        return g * g + eps

    def scaled(g, r, c, rc):
        """u = g / √v, v = (r / max(rc, eps)) ⊗ c, one piece."""
        v = (r / torch.clamp(rc, min=eps))[..., None] * c[..., None, :]
        return g.to(torch.float32) * torch.rsqrt(torch.clamp(v, min=eps))

    def apply(p, u, lr):
        """p ← p − lr·(u [+ wd·p]) in fp32, cast to p's type."""
        pf = p.to(torch.float32)
        if weight_decay:
            u = u + weight_decay * pf
        p.copy_(pf - lr * u)

    def clip_div(sumsq: torch.Tensor, n: int) -> torch.Tensor:
        rms = torch.sqrt(sumsq / n + eps)
        return torch.clamp(rms / clip_rms, min=1.0)

    def vector(s, g, p, beta2, omb2, lr):
        s["v"].copy_(beta2 * s["v"] + omb2 * g2_of(g))
        u = g.to(torch.float32) * torch.rsqrt(torch.clamp(s["v"], min=eps))
        apply(p, u / clip_div(torch.sum(u * u), u.numel()), lr)

    def factored(s, parts, n, beta2, omb2, lr):
        matrix = parts[0][3] is None
        col_sum = torch.zeros_like(s["c"]) if matrix else None
        rows = 0
        for _, g, r, c in parts:                  # pass 1: r and c
            g2 = g2_of(g)
            r.copy_(beta2 * r + omb2 * torch.mean(g2, dim=-1))
            if matrix:
                col_sum = col_sum + torch.sum(g2, dim=0)
                rows += g2.shape[0]
            else:
                c.copy_(beta2 * c + omb2 * torch.mean(g2, dim=-2))
        if matrix:
            s["c"].copy_(beta2 * s["c"] + omb2 * (col_sum / rows))
            rc = torch.mean(s["r"], dim=-1, keepdim=True)

        def u_of(g, r, c):
            if matrix:
                return scaled(g, r, s["c"], rc)
            return scaled(g, r, c, torch.mean(r, dim=-1, keepdim=True))

        sumsq = torch.zeros((), dtype=torch.float32, device=s["r"].device)
        for _, g, r, c in parts:                  # pass 2: the leaf's RMS
            u = u_of(g, r, c)
            sumsq = sumsq + torch.sum(u * u)
        div = clip_div(sumsq, n)
        for p, g, r, c in parts:                  # pass 3: the update
            apply(p, u_of(g, r, c) / div, lr)

    @torch.no_grad()
    def update(grads, state, params, step, lr):
        if any(is_dtensor(p) for p in params.values()):
            # laid out on a mesh: the same passes in DTensor ops, whose
            # means and sums over a sharded dim reduce across its ranks
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                return _update(grads, state, params, step, lr)
        return _update(grads, state, params, step, lr)

    def _update(grads, state, params, step, lr):
        t = _f32(step) + np.float32(1.0)
        beta2 = np.float32(1.0) - t ** np.float32(-decay_pow)
        omb2 = float(np.float32(1.0) - beta2)
        beta2, lr = float(beta2), float(_f32(lr))
        for key, names in stack_groups(params, stacked).items():
            ps = [params[n] for n in names]
            gs = [grads[n] for n in names]
            is_stack = key != names[0]
            if "v" in state[key]:
                vector(state[key], gs[0], ps[0], beta2, omb2, lr)
            else:
                factored(state[key], pieces(ps, gs, state[key], is_stack),
                         sum(p.numel() for p in ps), beta2, omb2, lr)
        return params, state

    return Optimizer(init, update)


def sgd() -> Optimizer:
    """p ← p − lr·g in fp32; no state."""

    def init(params):
        return {}

    @torch.no_grad()
    def update(grads, state, params, step, lr):
        lr = float(_f32(lr))
        for name, p in params.items():
            p, g = local(p), local(grads[name])
            for sl in row_slices(p):
                p[sl] = (p[sl].to(torch.float32)
                         - lr * g[sl].to(torch.float32))
        return params, state

    return Optimizer(init, update)


def make_optimizer(name: str, train_cfg=None, *, stacked=()) -> Optimizer:
    """The reference's ``make_optimizer``: AdamW with the config's decay and
    moments, Adafactor without decay (over the reference's leaves:
    ``stacked`` names the model's stacked module lists), or SGD."""
    wd = getattr(train_cfg, "weight_decay", 0.1) if train_cfg else 0.1
    b1 = getattr(train_cfg, "b1", 0.9) if train_cfg else 0.9
    b2 = getattr(train_cfg, "b2", 0.95) if train_cfg else 0.95
    if name == "adamw":
        return adamw(b1=b1, b2=b2, weight_decay=wd)
    if name == "adafactor":
        return adafactor(weight_decay=0.0, stacked=stacked)
    if name == "sgd":
        return sgd()
    raise ValueError(name)
