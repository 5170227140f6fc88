"""Counting a step's work as it runs: the port's counterpart of
``repro/roofline/hlo.py``, which re-derives the work from compiled HLO
text. The port compiles no graph, so :class:`CountMode`, a
``TorchDispatchMode``, sees every aten op the step dispatches (on ``meta``
tensors in the dry run, so nothing is allocated) and counts with
``hlo.py``'s conventions:

* flops: matrix products and attention by ``torch.utils.flop_counter``'s
  formulas (2·M·N·K for a product); one flop an output element for an
  elementwise op (the ``pointwise`` tag, less comparisons, selects and
  casts, as HloCostAnalysis counts); ``max(in/2, out)`` elements for a
  reduction; a softmax as its max, subtract, exp, sum and divide.
* bytes: the bytes of each op's tensor inputs plus its outputs. Views move
  nothing and are skipped. PyTorch runs eagerly, op by op, so nothing is
  fused: this is an upper bound on what XLA's count of the same step
  after fusion would be.
* collective bytes: the output bytes of each collective (the functional
  collectives DTensor issues and the process-group calls the models make
  themselves), an all-reduce twice, by kind (``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``).
* peak: the largest live set of the tensors the counted ops made, tracked
  by weak references, since ``meta`` has no allocator; the dry run adds
  the step's arguments.

Under a DTensor the mode declines the op (``NotImplemented``), DTensor
runs its sharding rule and dispatches the local ops on each rank's shard,
and the mode counts those: the counts are one rank's program. Ops whose
tensors all live on the CPU (the host scalars of a schedule) are not
counted: they run on the host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# op name (the overload packet's, without its namespace) → collective kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "c10d_functional",
                          "_dtensor")

# pointwise-tagged ops HloCostAnalysis does not count as arithmetic:
# comparisons, selects, logic, casts and copies
_NOT_ARITHMETIC = {
    "eq", "ne", "lt", "le", "gt", "ge", "where", "logical_and",
    "logical_or", "logical_not", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_not", "bitwise_xor", "isnan", "isinf", "isfinite", "copy",
    "copy_", "_to_copy", "clone", "fill", "fill_", "masked_fill",
    "masked_fill_", "lift_fresh", "_conj", "view_as_real",
}
# flops an element for the fused softmax ops (max, subtract, exp, sum,
# divide as XLA lowers them)
_PER_ELEMENT = {"_softmax": 4, "_log_softmax": 4,
                "_softmax_backward_data": 3, "_log_softmax_backward_data": 3}
# ops that move no bytes: allocation without a write, waits, metadata
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "wait_tensor", "_wrap_tensor_autograd",
             "detach", "alias",
             "lift_fresh", "_local_scalar_dense", "set_", "resize_",
             "_has_compatible_shallow_copy_type", "sym_size", "sym_stride",
             "sym_numel", "sym_storage_offset", "is_same_size"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


@dataclasses.dataclass
class Counts:
    """What a :class:`CountMode` counted: flops, bytes, collective bytes by
    kind and their op count, the largest live set of intermediates, and
    the ops it saw."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    coll_bytes_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    coll_ops: int = 0
    peak_live_bytes: float = 0.0
    ops: int = 0
    #: op name → [calls, flops, bytes], for a breakdown
    by_op: Dict[str, list] = dataclasses.field(default_factory=dict)

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.coll_bytes_by_kind.values()))


class CountMode(TorchDispatchMode):
    """Counts the flops, bytes, collectives and live bytes of the ops run
    inside it (module docstring); ``scaled(n)`` multiplies what is counted
    inside it by n (a microbatch's work by the accumulation count)."""

    def __init__(self):
        super().__init__()
        self.counts = Counts()
        self._scale = 1.0
        self._live = 0
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry

    @contextlib.contextmanager
    def scaled(self, n: float):
        prev, self._scale = self._scale, self._scale * float(n)
        try:
            yield self
        finally:
            self._scale = prev

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run its rule; its local ops come back here
            return NotImplemented
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    # -- the conventions ------------------------------------------------------

    def _count(self, func, args, kwargs, out) -> None:
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if all(t.device.type == "cpu" for t in ins + outs):
            return
        c, s = self.counts, self._scale
        c.ops += 1
        flops0, bytes0 = c.flops, c.bytes_accessed
        packet = func._overloadpacket
        ns, _, name = str(packet).rpartition(".")
        kind = _COLLECTIVES.get(name) if ns in _COLLECTIVE_NAMESPACES else None
        out_elems = sum(t.numel() for t in outs)
        # -- flops --
        if packet in self._flop_registry:
            c.flops += s * float(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
        elif name in _PER_ELEMENT:
            c.flops += s * _PER_ELEMENT[name] * out_elems
        elif torch.Tag.reduction in func.tags:
            in_elems = ins[0].numel() if ins else 0
            c.flops += s * max(in_elems // 2, out_elems)
        elif (torch.Tag.pointwise in func.tags
              and name not in _NOT_ARITHMETIC):
            c.flops += s * out_elems
        # -- collectives --
        if kind is not None:
            b = sum(_nbytes(t) for t in outs) if outs else sum(
                _nbytes(t) for t in ins)
            if kind == "all-reduce":
                b *= 2
            c.coll_bytes_by_kind[kind] += s * b
            c.coll_ops += 1
        # -- bytes --
        if not (func.is_view or name in _NO_BYTES):
            c.bytes_accessed += s * (sum(_nbytes(t) for t in ins)
                                     + sum(_nbytes(t) for t in outs))
        row = c.by_op.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += c.flops - flops0
        row[2] += c.bytes_accessed - bytes0
        if func.is_view or name in _NO_BYTES:
            return
        # -- live set: each new tensor until it is freed --
        if func._schema.is_mutable or kind is not None:
            return
        seen = {id(t) for t in ins}
        for t in outs:
            if id(t) in seen:
                continue
            n = _nbytes(t)
            self._live += n
            weakref.finalize(t, self._free, n)
        if self._live > c.peak_live_bytes:
            c.peak_live_bytes = float(self._live)

    def _free(self, n: int) -> None:
        self._live -= n


def active_count_mode():
    """The innermost ``CountMode`` on the dispatch mode stack, or None."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CountMode):
            return mode
    return None


@contextlib.contextmanager
def repeated(n: int):
    """What runs inside counted ``n`` times by the active ``CountMode`` (a
    block that stands for ``n`` identical ones); nothing without one."""
    mode = active_count_mode()
    if mode is None:
        yield
        return
    with mode.scaled(n):
        yield
