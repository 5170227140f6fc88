"""pow2-width over the port: batch and frontier widths stay on the pow2
chain (DESIGN.md §12.5), the part of the reference's ``recompile-hazard``
rule that carries over.

The reference's contract is that one warm race pre-compiles every (Q, W,
T) specialization a request can reach: frontier widths shrink down a pow2
chain, race batches are pow2-padded, and adaptive R is pow2-quantized, so
the set of shapes is log-sized. The port compiles no graphs, but the same
chain keeps its set of launch shapes log-sized: the pull kernels'
schedules (``kernels/pull_schedule.py``), the tuner's per-shape
measurements and the allocator's cached blocks all key on widths. So a
``len(...)`` fed straight into a ``torch.zeros``-style shape inside the
frontier, plane and session files is flagged — bucket it through
``next_pow2``/``bucket_width`` first.

The reference's other two checks, a ``jax.jit`` inside a per-call
function and unhashable static arguments, have no counterpart: the port
jits nothing.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.engine import (FileContext, Finding, Rule,
                                         call_name, dotted_name)

#: files whose batch/shape construction must stay on the pow2 chain
POW2_FILES = ("index/frontier.py", "serve/plane.py", "index/anytime.py")

#: shape-taking constructors checked by the pow2 discipline
_SHAPE_CTORS = ("zeros", "ones", "full", "empty")

#: helpers that launder a length onto the pow2 chain
_POW2_HELPERS = ("next_pow2", "pow2_floor", "bucket_width", "floor_width")


def _contains_len(node: ast.AST) -> bool:
    names = [call_name(sub) for sub in ast.walk(node)
             if isinstance(sub, ast.Call)]
    if any(n.rsplit(".", 1)[-1] in _POW2_HELPERS for n in names):
        return False  # laundered through the pow2 chain
    return any(n == "len" for n in names)


class Pow2WidthRule(Rule):
    name = "pow2-width"
    doc = ("batch shapes in the frontier, plane and session files stay on "
           "the pow2 chain")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if not any(ctx.rel.endswith(p) for p in POW2_FILES):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SHAPE_CTORS \
                    and dotted_name(node.func).startswith("torch.") \
                    and node.args and _contains_len(node.args[0]):
                yield ctx.finding(
                    self.name, node.args[0],
                    "len(...) fed directly into a tensor shape — one "
                    "launch shape per distinct length; bucket through "
                    "next_pow2/bucket_width so the set of widths stays on "
                    "the pow2 chain")
