"""host-sync over the port: no silent device→host transfers on the
per-epoch hot paths (DESIGN.md §12.4), the reference's rule in PyTorch's
idiom.

A ``.item()``, ``.cpu()``, ``.tolist()`` or ``.numpy()`` of a CUDA tensor
(or a ``float()`` of one, or a ``torch.cuda.synchronize()``) blocks the
Python thread on the device stream. On the serving hot paths — one call
per *epoch*, potentially thousands per second — a hidden sync serializes
the launch pipeline and caps qps at the launch latency. The discipline
(DESIGN.md §8): tensors cross to the host at ONE deliberate boundary per
epoch, ``repro_torch.utils.hostsync.host_fetch`` (one packed ``.cpu()``
for a tuple of tensors), and everything downstream works on host-resident
numpy.

Statically, "is this value on the card?" is undecidable — so the rule
inverts the burden: inside the configured hot functions, every
sync-shaped call must carry an explicit boundary annotation
(``# host-sync: <why>`` on the call's line) or go through the sanctioned
``host_fetch``. ``np.asarray`` of a tensor is not sync-shaped here: on a
CUDA tensor it raises rather than syncs.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, Set

from repro_torch.analysis.engine import FileContext, Finding, Rule, dotted_name

#: per-file hot functions — one entry per per-epoch serving loop
HOT_FUNCTIONS: Dict[str, Set[str]] = {
    "src/repro_torch/index/anytime.py": {
        "step", "_step_impl", "_refresh", "_ingest", "_record_epoch",
        "_epoch_extra", "snapshot", "retire", "done", "exhausted",
        "_to_host", "_merge_shard_partials",
    },
    "src/repro_torch/serve/plane.py": {
        "step", "_harvest", "_ingest", "_trace_ticket_epoch",
        "_terminal_reason", "_row_result", "_build_result",
        "_launch_group",
    },
    "src/repro_torch/index/batched_race.py": {
        "fused_race_topk",
    },
}

#: the sanctioned explicit boundary — calls through it pass
SANCTIONED = ("host_fetch",)

#: tensor methods that copy to the host or wait for the device
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")

_ANNOTATION = "# host-sync:"


def _sync_shape(node: ast.Call) -> str:
    """'' when the call is not sync-shaped, else a short label."""
    fn = node.func
    if isinstance(fn, ast.Name) and fn.id == "float":
        if node.args and not isinstance(node.args[0], ast.Constant):
            return "float()"
        return ""
    if dotted_name(fn) in ("torch.cuda.synchronize", "cuda.synchronize"):
        return "torch.cuda.synchronize()"
    if isinstance(fn, ast.Attribute) and fn.attr in _SYNC_METHODS \
            and not node.args:
        return f".{fn.attr}()"
    return ""


class HostSyncRule(Rule):
    name = "host-sync"
    doc = ("device->host syncs on per-epoch hot paths go through "
           "host_fetch or carry an explicit '# host-sync:' boundary "
           "annotation")

    def __init__(self, hot: Dict[str, Set[str]] = HOT_FUNCTIONS):
        self.hot = hot

    def _hot_set(self, rel: str):
        for path, fns in self.hot.items():
            # match on the repo path or any suffix of it (the engine may
            # be handed paths relative to src/ or to the repo root)
            if rel == path or path.endswith("/" + rel) \
                    or rel.endswith("/" + path.split("src/", 1)[-1]):
                return fns
        return None

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        fns = self._hot_set(ctx.rel)
        if fns is None:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            label = _sync_shape(node)
            if not label:
                continue
            chain = ctx.function_chain(node)
            if not chain or not any(f in fns for f in chain):
                continue
            if any(f in SANCTIONED for f in chain):
                continue  # inside the sanctioned boundary helper itself
            # float(np.sum(host_fetch(x)))-style wrappers: the value
            # already crossed at the sanctioned boundary
            inner = [node.func.value] if isinstance(
                node.func, ast.Attribute) else []
            if any(isinstance(sub, ast.Call)
                   and dotted_name(sub.func).rsplit(".", 1)[-1]
                   in SANCTIONED
                   for a in list(node.args) + inner for sub in ast.walk(a)):
                continue
            line = ctx.lines[node.lineno - 1] if \
                node.lineno <= len(ctx.lines) else ""
            if _ANNOTATION in line:
                continue
            # multi-line calls: annotation may sit on the statement head
            # line or on a comment line directly above it
            stmt = node
            while hasattr(stmt, "parent") and not isinstance(
                    stmt, ast.stmt):
                stmt = stmt.parent  # type: ignore[attr-defined]
            if isinstance(stmt, ast.stmt) and stmt.lineno <= len(ctx.lines):
                head = ctx.lines[stmt.lineno - 1]
                above = ctx.lines[stmt.lineno - 2] \
                    if stmt.lineno >= 2 else ""
                if _ANNOTATION in head or (
                        above.lstrip().startswith("#")
                        and _ANNOTATION in above):
                    continue
            yield ctx.finding(
                self.name, node,
                f"{label} inside hot function {chain[0]!r} — a silent "
                f"device sync here serializes the epoch pipeline; route "
                f"through repro_torch.utils.hostsync.host_fetch or "
                f"annotate the line with '# host-sync: <why this is "
                f"host-side>'")
