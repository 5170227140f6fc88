"""Logical-axis sharding rules: the port of ``repro/sharding/spec.py``.

Every parameter and cache leaf declares its logical axes (``"embed"``,
``"mlp"``, ``"heads"``, ``"batch"``, …: ``models.common.new_param`` and
``CacheSpec``). A :class:`Rules` table maps each logical name to mesh axes
(``"data"``, ``"model"``, ``("pod", "data")``) or to None (replicated);
the parallelism plans (DP, FSDP, TP, SP, EP) are different tables over the
same names, so a plan never touches model code. The rules are the only
source of layouts: ``param_pspecs`` and ``cache_pspecs`` give each leaf's
:class:`PSpec` (the reference's ``PartitionSpec``: one entry a tensor dim,
a mesh axis name, a tuple of them, or None), and ``placements`` turns a
spec into the DTensor placements of a ``DeviceMesh``.

The port's parameters are unstacked (``layers.0.attn.wq``), so their axes
are the reference's without the leading ``"layers"`` of a stacked leaf;
that entry maps to None under every plan, so the specs are otherwise the
reference's. The init rule per path is ``models.common.init_leaf``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]


class PSpec(tuple):
    """A partition spec: one entry a tensor dim (a mesh axis name, a tuple
    of names, or None), trailing Nones dropped, as the reference's
    ``PartitionSpec``. A tuple, so ``tuple(P(...))`` of the reference
    compares equal."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Rules:
    """Logical-axis name → mesh axes.

    With ``axis_sizes`` (mesh axis name → size) set, ``pspec`` drops any
    mapping whose mesh extent does not divide the tensor dim (greedily,
    trailing axes first): 40 heads on a 16-wide model axis, MQA's one KV
    head, a batch of 1 stay replicated there. A mesh axis serves one dim
    of a tensor at most."""

    table: Mapping[str, MeshAxes]
    axis_sizes: Optional[Mapping[str, int]] = None

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.table.get(logical, None)

    def _extent(self, ms: Tuple[str, ...]) -> int:
        if not self.axis_sizes:
            return 1
        e = 1
        for a in ms:
            e *= int(self.axis_sizes.get(a, 1))
        return e

    def pspec(self, axes: Sequence[Optional[str]],
              shape: Optional[Sequence[int]] = None) -> PSpec:
        used: set = set()
        out = []
        for i, ax in enumerate(axes):
            m = self.mesh_axes(ax)
            if m is None:
                out.append(None)
                continue
            ms = (m,) if isinstance(m, str) else tuple(m)
            ms = tuple(a for a in ms if a not in used)
            if shape is not None and self.axis_sizes and ms:
                while ms and shape[i] % self._extent(ms) != 0:
                    ms = ms[:-1]
            used.update(ms)
            if not ms:
                out.append(None)
            elif len(ms) == 1:
                out.append(ms[0])
            else:
                out.append(ms)
        while out and out[-1] is None:
            out.pop()
        return PSpec(*out)


def make_rules(*, fsdp: bool = False, tp: bool = True, sp: bool = False,
               ep: bool = False, multi_pod: bool = False,
               axis_sizes: Optional[Mapping[str, int]] = None,
               kv_len_shard: bool = False) -> Rules:
    """The rule table of a parallelism plan, the reference's: DP and FSDP
    on ``("pod", "data")`` where a pod axis exists, else ``"data"``; TP,
    SP and EP on ``"model"``. ``head_dim`` maps to the TP axis too, the
    backup where heads do not divide it (per-tensor dedup drops it where
    heads took the axis)."""
    dp: MeshAxes = ("pod", "data") if multi_pod else "data"
    t: MeshAxes = "model" if tp else None
    table = {
        # activations
        "batch": dp,
        "seq": "model" if sp else None,
        "act_embed": None,
        "kv_len": "model" if kv_len_shard else None,
        # params
        "layers": None,
        "embed": dp if fsdp else None,
        "mlp": t,
        "vocab": t,
        "heads": t,
        "kv_heads": t,
        "head_dim": t,
        "qk_rank": t,
        "kv_rank": None,
        "experts": "model" if ep else None,
        "expert_mlp": None if ep else t,
        "ssm_state": None,
        "ssm_heads": t,
        "conv": None,
        "frame": None,
    }
    return Rules(table=table, axis_sizes=axis_sizes)


def rules_for(plan, mesh=None, *, axis_sizes=None) -> Rules:
    """``make_rules`` of ``plan`` over ``mesh`` (a ``DeviceMesh`` whose dim
    names are the mesh axes; a ``pod`` axis makes it multi-pod) or over
    ``axis_sizes`` alone; the divisibility fallback reads the sizes."""
    if mesh is not None:
        axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return make_rules(fsdp=plan.fsdp, tp=plan.tp, sp=plan.sp, ep=plan.ep,
                      multi_pod=bool(axis_sizes) and "pod" in axis_sizes,
                      axis_sizes=axis_sizes,
                      kv_len_shard=plan.kv_len_shard)


def logical_to_pspec(axes_tree, rules: Rules):
    """A dict (nested or flat) of logical-axes tuples → the same of
    PSpecs, without the divisibility check (no shapes)."""
    if isinstance(axes_tree, dict):
        return {k: logical_to_pspec(v, rules) for k, v in axes_tree.items()}
    return rules.pspec(axes_tree)


def param_pspecs(model, rules: Rules) -> dict:
    """{parameter name: PSpec} of a port model (one on ``meta`` will do:
    only shapes and axes are read)."""
    return {n: rules.pspec(p.axes, p.shape)
            for n, p in model.named_parameters()}


def cache_pspecs(model, batch_size: int, max_seq: int, rules: Rules,
                 dtype=None) -> dict:
    """The PSpecs of ``model.cache_specs(batch_size, max_seq)``, nested as
    the specs are; ``index`` (a host int in the port) gets PSpec()."""
    import torch
    specs = model.cache_specs(batch_size, max_seq,
                              dtype if dtype is not None else torch.bfloat16)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else rules.pspec(v.axes, v.shape) for k, v in tree.items()}

    return walk(specs)


def placements(spec: Sequence, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(i)`` where tensor dim i names that axis, else ``Replicate()``.
    A dim mapped to several axes (``("pod", "data")``) is sharded over
    each, major to minor in mesh order, as the reference lays it out; an
    order against the mesh's raises, as does an axis the mesh lacks. An
    axis one rank wide stays ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names mesh axis {a!r}; "
                                 f"the mesh has {names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec entry {axes} runs against the mesh "
                             f"order {names}")
        for j in idx:
            # a one-wide axis splits nothing: replicated, as in the
            # reference, and DTensor then reshapes the dim freely
            if mesh.mesh.shape[j] > 1:
                out[j] = Shard(i)
    return out
