"""delta-ledger over the port: the δ union-bound accounting must be
enumerable (DESIGN.md §12.2), the reference's rule on ``src/repro_torch``.

The paper's exactness guarantee (top-k exact with prob ≥ 1−δ) survives
composition only because every *split* of the configured δ flows through
the accounting helpers in the port's ``core/confidence.py`` — ``delta_prime``
(Lemma 1: δ′ = δ/(n·MP) per CI) and ``shard_delta`` (δ/S per shard, so
the S shard-local contracts union-bound back to the global δ). A raw
``cfg.delta / something`` anywhere else, or a numeric-literal failure
probability handed straight to a CI radius, is an unauditable leak in
the proof: LeJeune et al. (arXiv:1902.09465) is the cautionary tale of
an approximate contract that silently degrades when the accounting
slips.

This rule flags:
  * arithmetic (``/`` or ``*``) on a ``.delta`` attribute outside the
    ledger home module — route it through a helper instead;
  * numeric-literal ``delta=`` arguments at accounting/CI call sites
    (``delta_prime``, ``shard_delta``, ``hoeffding_*``) — the δ must
    come from config, never be re-derived inline;
  * ``log(2/<literal>)``-style inlined confidence terms.

and COLLECTS every helper call site into ``self.ledger`` — the
machine-generated δ-split table DESIGN.md §12.2 renders, and the thing
``tests/test_torch_lint.py`` pins so a new split site must register
here.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from repro_torch.analysis.engine import FileContext, Finding, Rule, call_name

#: the accounting helpers — the ONLY sanctioned δ-split sites
ACCOUNTING_HELPERS = ("delta_prime", "shard_delta")

#: module that owns the helpers; raw δ arithmetic is legal only here
LEDGER_HOME = "src/repro_torch/core/confidence.py"


def _is_delta_attr(node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "delta"


def _is_number(node: ast.AST) -> bool:
    return (isinstance(node, ast.Constant)
            and isinstance(node.value, (int, float))
            and not isinstance(node.value, bool))


class DeltaLedgerRule(Rule):
    name = "delta-ledger"
    doc = ("every split of the config δ flows through core.confidence "
           "accounting helpers; no literal failure probabilities at CI "
           "call sites")

    def reset(self) -> None:
        self.ledger: List[dict] = []

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        in_home = ctx.rel.endswith("core/confidence.py")
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.BinOp) and isinstance(
                    node.op, (ast.Div, ast.Mult)):
                if _is_delta_attr(node.left) or _is_delta_attr(node.right):
                    if in_home:
                        continue  # the helper bodies themselves
                    yield ctx.finding(
                        self.name, node,
                        "raw arithmetic on a .delta attribute — split the "
                        "failure budget through core.confidence.delta_prime/"
                        "shard_delta so the ledger can enumerate it")
            elif isinstance(node, ast.Call):
                cname = call_name(node)
                leaf = cname.rsplit(".", 1)[-1]
                if leaf in ACCOUNTING_HELPERS:
                    chain = ctx.function_chain(node)
                    self.ledger.append({
                        "helper": leaf, "path": ctx.rel,
                        "line": node.lineno,
                        "function": chain[0] if chain else "<module>",
                    })
                if leaf in ACCOUNTING_HELPERS or leaf.startswith("hoeffding"):
                    literal = None
                    if node.args and _is_number(node.args[0]):
                        literal = node.args[0]
                    for kw in node.keywords:
                        if kw.arg == "delta" and _is_number(kw.value):
                            literal = kw.value
                    if literal is not None:
                        yield ctx.finding(
                            self.name, literal,
                            f"numeric-literal failure probability "
                            f"({literal.value!r}) at CI call site "
                            f"{leaf}() — take δ from the config so the "
                            f"union bound stays auditable")
                elif leaf == "log":
                    # log(2/0.05)-style inlined confidence term
                    for arg in node.args:
                        if (isinstance(arg, ast.BinOp)
                                and isinstance(arg.op, ast.Div)
                                and _is_number(arg.left)
                                and _is_number(arg.right)):
                            yield ctx.finding(
                                self.name, arg,
                                "inlined log(c/δ) confidence term with a "
                                "literal δ — derive the log term from "
                                "delta_prime(cfg.delta, ...)")
