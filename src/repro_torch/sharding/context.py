"""The ambient activation layout: the port of ``repro/sharding/context.py``.

Model code is written against logical activation axes. The step builders
install (rules, mesh) here, and the models call ``shard_act`` where the
reference does (the embedding's output) to pin the residual stream's
layout (batch over the data axes, sequence over ``model`` under sequence
parallelism), and on each block's output before its residual add, so
the row-parallel products' outputs are reduce-scattered into that layout
by an explicit redistribution (its backward gathers the gradient back:
PyTorch 2.11's DTensor cannot flatten a sequence-split gradient inside a
product's backward). Inside the context the parameters are DTensors and plain
tensors made by the model (positions, masks, constants) count as
replicated (``implicit_replication``). Outside a context every call here
is a no-op, so a one-device run is unchanged.

``local_call`` is the bridge to code that takes plain tensors, the
hand-written kernels' wrappers and the integer dispatch of the MoE: it
lays each DTensor argument out as asked, hands the local shards to the
function and wraps its outputs with their declared placements; autograd
flows through both conversions.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

# the installed (rules, mesh): process-wide, not thread-local, since
# autograd runs a CUDA backward (and remat's recomputation in it) on a
# thread of its own; a rank process installs one at a time
_CTX: list = [None]


def current() -> Optional[tuple]:
    """The installed (rules, mesh), or None."""
    return _CTX[0]


@contextlib.contextmanager
def activation_sharding(rules, mesh):
    """Install (rules, mesh) for the block; plain tensors meeting DTensors
    inside it count as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = _CTX[0]
    _CTX[0] = (rules, mesh)
    try:
        with implicit_replication():
            yield
    finally:
        _CTX[0] = prev


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_act(x, axes=("batch", "seq", "act_embed")):
    """``x`` laid out by the rules' spec of ``axes`` (padded with None to
    its rank) inside a context; ``x`` itself outside one. A plain tensor
    inside a context is taken as replicated first."""
    ctx = current()
    if ctx is None:
        return x
    from repro_torch.sharding.spec import placements
    rules, mesh = ctx
    axes = tuple(axes[: x.dim()]) + (None,) * max(0, x.dim() - len(axes))
    want = placements(rules.pspec(axes, tuple(x.shape)), mesh)
    return to_placements(x, mesh, want)


def to_placements(x, mesh, want):
    """``x`` (a DTensor, or a plain tensor replicated on every rank) as a
    DTensor with placements ``want``."""
    x = as_dtensor(x, mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(mesh, want)


def as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor taken as
    replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def reshape(x, *shape):
    """``x.reshape(shape)``, its gradient reshaped back the same way: a
    DTensor split over a dim that the reshape splits unevenly for the mesh
    (4 heads out of a dim split 16 ways) is first gathered over the mesh
    dims that split it at or after the first dim the reshape changes,
    where DTensor cannot carry the layout. A plain tensor is reshaped as
    it is."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    return _Reshape.apply(x, shape)


def _carried_reshape(x, shape):
    try:
        return x.reshape(*shape)
    except RuntimeError as e:
        # PyTorch 2.13: "Cannot unflatten unevenly sharded tensor ...
        # Please redistribute"; 2.11: "Attempted to split the sharded
        # dimension ... without redistribution"
        if "redistribut" not in str(e):
            raise
    from torch.distributed.tensor import Replicate
    first = next((i for i, (a, b) in enumerate(zip(x.shape, shape))
                  if a != b), min(x.dim(), len(shape)))
    want = [Replicate() if p.is_shard() and p.dim >= first else p
            for p in x.placements]
    return x.redistribute(x.device_mesh, want).reshape(*shape)


class _Reshape(torch.autograd.Function):
    """``reshape``'s forward and backward: each side through
    ``_carried_reshape``."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return _carried_reshape(x, tuple(shape))

    @staticmethod
    def backward(ctx, g):
        return _carried_reshape(g, ctx.shape), None


def whole_sequence(x):
    """A DTensor of rank ≥ 3 split along dim 1 (the sequence), gathered
    along it; anything else as it is."""
    from torch.distributed.tensor import Replicate, Shard
    if x.dim() < 3 or Shard(1) not in tuple(x.placements):
        return x
    want = [Replicate() if p == Shard(1) else p for p in x.placements]
    return x.redistribute(x.device_mesh, want)


def replicated(x):
    """The full tensor of a DTensor, as a plain tensor on every rank
    (differentiable: its gradient is sliced back); a plain tensor as it
    is."""
    if not is_dtensor(x):
        return x
    return x.full_tensor()


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: a shard's gradient
    from a kernel or a transpose goes back through DTensor's view ops,
    which take contiguous local tensors."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_call(fn, args, in_placements, out_placements, mesh,
               grad_placements=None):
    """``fn`` on the local shards of ``args`` laid out as ``in_placements``
    (one list a DTensor argument; None for a non-tensor or a plain tensor,
    passed as it is), its outputs (a tensor or a tuple of them; None
    passes a non-tensor through) wrapped as DTensors with
    ``out_placements``. Gradients flow through both conversions; an
    argument replicated over a mesh dim whose ranks compute from
    different data has a partial gradient there, which its entry of
    ``grad_placements`` declares (``Partial()``; None: the layout it came
    in)."""
    from torch.distributed.tensor import DTensor
    local = []
    grad_placements = grad_placements or [None] * len(args)
    for a, pl, gpl in zip(args, in_placements, grad_placements):
        if pl is not None and isinstance(a, torch.Tensor):
            loc = to_placements(a, mesh, pl).to_local(grad_placements=gpl)
            local.append(_ContiguousGrad.apply(loc) if loc.requires_grad
                         else loc)
        else:
            local.append(a)
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    pls = (out_placements,) if single else out_placements
    wrapped = tuple(
        DTensor.from_local(o, mesh, pl, run_check=False)
        if pl is not None and isinstance(o, torch.Tensor) else o
        for o, pl in zip(outs, pls))
    return wrapped[0] if single else wrapped


def heads_local(fn, q, k, v):
    """``fn(q, k, v)`` of attention, q (B, Sq, H, D) and k, v (B, Sk, KV,
    D) laid out on the installed mesh, run on each rank's heads: the batch
    over the data axes and the heads over the axis ``kv_heads`` maps to,
    where the KV heads divide it (query head h reads KV head h // G, so a
    rank's H/m query heads read its KV/m heads), else the heads whole. The
    output (B, Sq, H, Dv) keeps that layout. Attention is independent per
    batch row and head, so nothing crosses ranks inside ``fn``."""
    from repro_torch.sharding.spec import placements
    rules, mesh = current()
    pl = placements(rules.pspec(("batch", None, "kv_heads", None),
                                tuple(k.shape)), mesh)
    return local_call(fn, (q, k, v), (pl, pl, pl), pl, mesh)


def cache_write(c, new, start: int) -> None:
    """``c[:, start:start + S] = new`` in place, S = new.shape[1]: on a
    plain cache leaf a slice assignment; on a DTensor leaf each rank
    writes the part of the new positions its shard holds, ``new`` laid
    out as ``c`` along every other dim (a cache sharded along its length,
    ``kv_len``, keeps a contiguous range of positions a rank)."""
    if not is_dtensor(c):
        c[:, start:start + new.shape[1]] = new
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = c.device_mesh
    pl = [Replicate() if p == Shard(1) else p for p in c.placements]
    loc_new = to_placements(new, mesh, pl).to_local()
    loc = c.to_local()
    p0 = 0
    for dim, p in enumerate(c.placements):
        if p == Shard(1):
            p0 = p0 * mesh.mesh.shape[dim] + mesh.get_local_rank(dim)
    p0 *= loc.shape[1]
    lo, hi = max(start, p0), min(start + new.shape[1], p0 + loc.shape[1])
    if lo < hi:
        loc[:, lo - p0:hi - p0] = loc_new[:, lo - start:hi - start]


def by_axes(fn, args, in_axes, out_axes):
    """``fn(*args)``, each DTensor argument laid out by the installed rules'
    spec of its logical axes (``in_axes``, a tuple a tensor argument, None
    for others) and the outputs wrapped by the same mapping of theirs
    (``out_axes``, matching ``fn``'s output structure: a tuple of axes, or
    a tuple of those); a logical axis the inputs shard is sharded the same
    way in the outputs. Run as it is when no argument is a DTensor. For
    the scans of the SSM family: per batch row and head, nothing crosses
    ranks inside ``fn``."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from repro_torch.sharding.spec import PSpec, placements
    rules, mesh = current()
    decided: dict = {}
    in_pl = []
    for a, ax in zip(args, in_axes):
        if ax is None or not isinstance(a, torch.Tensor):
            in_pl.append(None)
            continue
        spec = rules.pspec(ax, tuple(a.shape))
        for name, entry in zip(ax, spec):
            if entry is not None:
                decided.setdefault(name, entry)
        in_pl.append(placements(spec, mesh))
    flat_axes = _flatten_axes(out_axes)
    out_pl = tuple(placements(PSpec(*[decided.get(n) for n in ax]), mesh)
                   for ax in flat_axes)
    # an argument replicated over a mesh dim that shards a logical axis it
    # lacks (a weight over the batch's data shards, Mamba2's B and C over
    # the heads' ranks) meets a different part there on each rank: its
    # gradient is partial over that dim
    from torch.distributed.tensor import Partial, Replicate
    names = list(mesh.mesh_dim_names)
    split_by = [set() for _ in names]
    for logical, entry in decided.items():
        for a in ((entry,) if isinstance(entry, str) else entry):
            split_by[names.index(a)].add(logical)
    grad_pl = [None if p is None else
               [Partial() if q == Replicate() and split_by[j] - set(ax)
                else q for j, q in enumerate(p)]
               for p, ax in zip(in_pl, in_axes)]
    outs = local_call(lambda *loc: tuple(_flatten_out(fn(*loc))), args,
                      in_pl, out_pl, mesh, grad_placements=grad_pl)
    return _unflatten_out(out_axes, list(outs))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _flatten_axes(tree):
    if _is_axes(tree):
        return [tree]
    return [a for sub in tree for a in _flatten_axes(sub)]


def _flatten_out(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for sub in out for t in _flatten_out(sub)]


def _unflatten_out(tree, leaves):
    if _is_axes(tree):
        return leaves.pop(0)
    return tuple(_unflatten_out(sub, leaves) for sub in tree)
