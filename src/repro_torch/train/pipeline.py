"""GPipe pipeline parallelism over a mesh ``stage`` axis: the port of
``repro/train/pipeline.py``.

Layers are split into n_stages contiguous groups (``split_stages``); each
rank of the ``stage`` axis holds one group and microbatches stream through
the stages. Stage s receives microbatch μ from stage s−1 (stage 0 takes it
from the input), applies its group and sends the result on; the last
stage's outputs are broadcast over the axis, so every rank returns them,
as the reference's final ``psum`` replicates them.

The schedule is one ``torch.autograd.Function``: its forward runs the
microbatches in order, keeping each one's local graph, and its backward
walks them in reverse, receiving each output's gradient from stage s+1,
back-propagating through the group and sending the input's gradient to
stage s−1 (``torch.distributed.send``/``recv`` are not differentiable).
The reference computes every tick of the bubble on every stage; the port
computes only the ticks that carry a microbatch. The output is replicated,
so its gradient is taken from the last stage's copy, once, as the
reference's single program takes it.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist



def _recv(t: torch.Tensor, src: int, group) -> torch.Tensor:
    dist.recv(t, src, group=group)
    return t


def split_stages(stacked_params, n_stages: int):
    """(L, ...) stacked layer params (a tensor or a dict of them) →
    (n_stages, L / n_stages, ...)."""
    if isinstance(stacked_params, dict):
        return {k: split_stages(v, n_stages)
                for k, v in stacked_params.items()}
    L = stacked_params.shape[0]
    if L % n_stages:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    return stacked_params.reshape((n_stages, L // n_stages)
                                  + tuple(stacked_params.shape[1:]))


def _flat(tree):
    if isinstance(tree, dict):
        keys = sorted(tree)
        return [t for k in keys for t in _flat(tree[k])]
    return [tree]


def _unflat(tree, leaves):
    if isinstance(tree, dict):
        return {k: _unflat(tree[k], leaves) for k in sorted(tree)}
    return leaves.pop(0)


class _GPipe(torch.autograd.Function):

    @staticmethod
    def forward(ctx, stage_fn, like, group, s, S, x_micro, *params):
        ranks = dist.get_process_group_ranks(group)
        prev = ranks[s - 1] if s > 0 else None
        nxt = ranks[s + 1] if s < S - 1 else None
        ins, outs = [], []
        out_all = torch.empty_like(x_micro)
        for mu in range(x_micro.shape[0]):
            x_in = (x_micro[mu].clone() if prev is None else
                    _recv(torch.empty_like(x_micro[mu]), prev, group))
            x_in.requires_grad_(True)
            local = [p.detach().requires_grad_(p.requires_grad)
                     for p in params]
            with torch.enable_grad():
                y = stage_fn(_unflat(like, list(local)), x_in)
            if nxt is not None:
                dist.send(y.detach(), nxt, group=group)
            else:
                out_all[mu] = y.detach()
            ins.append((x_in, local))
            outs.append(y)
        dist.broadcast(out_all, ranks[S - 1], group=group)
        ctx.state = (ins, outs, prev, nxt, group, ranks[S - 1])
        return out_all

    @staticmethod
    def backward(ctx, g_out):
        ins, outs, prev, nxt, group, last = ctx.state
        # the output is replicated: its gradient is the last stage's copy
        g_out = g_out.contiguous()
        dist.broadcast(g_out, last, group=group)
        n_params = len(ins[0][1])
        p_grads = [None] * n_params
        g_x = torch.zeros((len(ins),) + tuple(ins[0][0].shape),
                          dtype=ins[0][0].dtype, device=ins[0][0].device)
        for mu in reversed(range(len(ins))):
            x_in, local = ins[mu]
            g_y = (g_out[mu] if nxt is None else
                   _recv(torch.empty_like(outs[mu]), nxt, group))
            wrt = [x_in] + [p for p in local if p.requires_grad]
            got = torch.autograd.grad(outs[mu], wrt, g_y, allow_unused=True)
            gx, rest = got[0], list(got[1:])
            if prev is not None:
                dist.send(gx if gx is not None else torch.zeros_like(x_in),
                          prev, group=group)
            elif gx is not None:
                g_x[mu] = gx
            for i, p in enumerate(local):
                if not p.requires_grad:
                    continue
                g = rest.pop(0)
                if g is not None:
                    p_grads[i] = g if p_grads[i] is None else p_grads[i] + g
        ctx.state = None
        # the input is replicated too: stage 0's gradient, on every rank
        dist.broadcast(g_x, dist.get_process_group_ranks(group)[0],
                       group=group)
        return (None, None, None, None, None, g_x, *p_grads)


def pipeline_apply(stage_fn: Callable, stage_params, x_micro, mesh,
                   axis: str = "stage"):
    """stage_fn(params_for_stage, x) -> x of the same shape;
    ``stage_params``: a tensor or dict of tensors with leading dim
    n_stages, each rank using its stage's slice; x_micro: (n_micro, mb,
    ...) microbatches, the same on every rank. Returns the (n_micro, mb,
    ...) outputs after all stages, on every rank. Differentiable in
    ``x_micro`` and ``stage_params`` (a rank's gradient lands in its own
    stage's slice)."""
    dim = mesh.mesh_dim_names.index(axis)
    S = mesh.mesh.shape[dim]
    s = mesh.get_local_rank(dim)
    group = mesh.get_group(dim)
    mine = ({k: v[s] for k, v in stage_params.items()}
            if isinstance(stage_params, dict) else stage_params[s])
    like = {k: None for k in mine} if isinstance(mine, dict) else None
    return _GPipe.apply(stage_fn, like, group, s, S, x_micro, *_flat(mine))
