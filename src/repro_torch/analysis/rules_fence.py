"""epoch-fence over the port: store swaps happen only under the fence
(DESIGN.md §12.3), the reference's rule on ``src/repro_torch/api/handle.py``
and every other file that holds a ``_store``.

``Index.epoch`` is the system-wide invalidation fence: the query LRU,
replica fan-out, in-flight plane race groups, δ-audit staleness checks
and tuned-sidecar validity ALL key on it. The contract (DESIGN.md §6.3)
is that the immutable store referenced by ``Index._store`` is replaced
only by ``Index._swap`` — which bumps the epoch in the same breath — so
nothing can observe a new store under an old epoch (or vice versa).

This rule flags:
  * any assignment to a ``._store`` attribute outside ``__init__`` /
    ``_swap``-named fenced helpers (pre-publication construction in
    ``__init__`` is safe by definition: no one else holds the handle);
  * a ``_swap``-style helper that assigns ``_store`` but never bumps
    ``_epoch`` — a fence that doesn't fence.

Deliberate exceptions (e.g. re-deriving device placement on a
just-loaded, not-yet-published handle) carry an inline
``# repro-lint: allow[epoch-fence]`` with the justification in the
comment — making every un-fenced site a reviewed, greppable decision.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.engine import FileContext, Finding, Rule

#: function names allowed to assign ``._store`` without the fence
FENCED_FUNCTIONS = ("__init__", "_swap")


def _targets(node: ast.AST):
    if isinstance(node, ast.Assign):
        return node.targets
    if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        return [node.target]
    return []


def _assigns_attr(node: ast.AST, attr: str) -> bool:
    return any(isinstance(t, ast.Attribute) and t.attr == attr
               for t in _targets(node))


class EpochFenceRule(Rule):
    name = "epoch-fence"
    doc = ("Index._store is swapped only by __init__/_swap-style fenced "
           "helpers, and every fenced helper bumps the epoch")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if _assigns_attr(node, "_store"):
                fn = ctx.enclosing_function(node)
                fname = fn.name if fn is not None else "<module>"
                if not (fname in FENCED_FUNCTIONS
                        or fname.startswith("_swap")):
                    yield ctx.finding(
                        self.name, node,
                        f"store swap outside the epoch fence (in "
                        f"{fname!r}) — go through Index._swap so the "
                        f"epoch bump invalidates caches/replicas/groups "
                        f"atomically")
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name.startswith("_swap")):
                assigns = bumps = False
                for sub in ast.walk(node):
                    if _assigns_attr(sub, "_store"):
                        assigns = True
                    if _assigns_attr(sub, "_epoch"):
                        bumps = True
                if assigns and not bumps:
                    yield ctx.finding(
                        self.name, node,
                        f"fenced helper {node.name!r} swaps _store but "
                        f"never bumps _epoch — stale caches and replicas "
                        f"will serve the old store's answers")
