"""The rule engine: per-file AST visitor pipeline, inline suppressions,
and the ratchet baseline — the port's own copy of
``repro/analysis/engine.py``, pure stdlib like it (DESIGN.md §12.1).

Life of a lint run:

  1. every target file is parsed ONCE into a ``FileContext`` (source,
     lines, AST with parent links, suppression table);
  2. each registered rule's ``check(ctx)`` yields ``Finding``s for that
     file; after all files, ``finalize()`` yields cross-file findings
     (e.g. metric name/type conflicts);
  3. findings carrying an inline ``# repro-lint: allow[rule]`` on their
     line (or on a standalone comment line directly above) are dropped
     as *suppressed* — the annotation is the reviewed, greppable record
     of a deliberate exception;
  4. the remainder is matched against the committed ratchet baseline:
     per-fingerprint counts frozen at adoption time. Findings beyond the
     baseline count are NEW (CI fails); findings within it are
     *baselined* (pre-existing debt, visible but not fatal); baseline
     entries no longer observed are *stale* (a warning nudging a
     ``--baseline-update`` shrink — the ratchet only tightens).

Fingerprints deliberately exclude line numbers (``rule|path|snippet``)
so unrelated edits that shift a frozen finding down the file do not
resurrect it as new.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

BASELINE_VERSION = 1
REPORT_VERSION = 1

_ALLOW_RE = re.compile(r"#\s*repro-lint:\s*allow\[([A-Za-z0-9_,\-\s*]+)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one site."""

    rule: str
    path: str          # repo-relative posix path
    line: int          # 1-indexed
    col: int
    message: str
    snippet: str = ""  # stripped source line (fingerprint component)

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}|{self.path}|{self.snippet}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "snippet": self.snippet}

    def render(self, status: str = "") -> str:
        tag = f" [{status}]" if status else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.rule}: "
                f"{self.message}{tag}")


class FileContext:
    """One parsed file: source, line table, AST with ``.parent`` links,
    and the per-line suppression table."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child.parent = node  # type: ignore[attr-defined]
        self.allow: Dict[int, set] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _ALLOW_RE.search(text)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self.allow[i] = rules
                # a standalone comment line suppresses the next line too
                if text.lstrip().startswith("#"):
                    self.allow.setdefault(i + 1, set()).update(rules)

    # -- shared AST helpers (every rule needs these) -------------------------

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def suppressed(self, finding: Finding) -> bool:
        rules = self.allow.get(finding.line)
        return bool(rules and (finding.rule in rules or "*" in rules))

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = getattr(node, "parent", None)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = getattr(cur, "parent", None)
        return None

    def function_chain(self, node: ast.AST) -> List[str]:
        """Names of every enclosing def, innermost first."""
        out = []
        cur = self.enclosing_function(node)
        while cur is not None:
            out.append(cur.name)
            cur = self.enclosing_function(cur)
        return out

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(rule=rule, path=self.rel, line=line,
                       col=getattr(node, "col_offset", 0), message=message,
                       snippet=self.line_text(line))


def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for nested Attribute/Name chains, '' when not a plain
    dotted reference (calls/subscripts in the chain collapse to '')."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(call: ast.Call) -> str:
    return dotted_name(call.func)


def has_decorator(fn: ast.AST, *names: str) -> bool:
    for dec in getattr(fn, "decorator_list", ()):
        target = dec.func if isinstance(dec, ast.Call) else dec
        dname = dotted_name(target)
        if any(dname == n or dname.endswith("." + n) for n in names):
            return True
        # functools.partial(jax.jit, ...) style decorators: look inside
        if isinstance(dec, ast.Call):
            for arg in dec.args:
                aname = dotted_name(arg)
                if any(aname == n or aname.endswith("." + n) for n in names):
                    return True
    return False


class Rule:
    """Base rule: per-file ``check`` plus an optional cross-file
    ``finalize`` pass that runs after every file has been checked."""

    name = ""
    doc = ""           # one-line: the invariant this rule guards

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        return ()

    def finalize(self) -> Iterable[Finding]:
        return ()

    def reset(self) -> None:
        """Called once per engine run before any file is checked."""


@dataclasses.dataclass
class LintReport:
    findings: List[Finding]                  # post-suppression, all
    new: List[Finding]
    baselined: List[Finding]
    suppressed: int
    stale: List[str]                         # baseline fps no longer seen
    ledger: List[dict]                       # δ-split sites (rules_delta)
    errors: List[str]                        # unparseable files

    @property
    def ok(self) -> bool:
        return not self.new and not self.errors

    def statuses(self) -> List[str]:
        """Per-finding status, parallel to ``findings`` — replays the
        baseline budget exactly as ``apply_baseline`` consumed it (first
        occurrences of a fingerprint are the baselined ones)."""
        budget: Dict[str, int] = {}
        for f in self.baselined:
            budget[f.fingerprint] = budget.get(f.fingerprint, 0) + 1
        out = []
        for f in self.findings:
            if budget.get(f.fingerprint, 0) > 0:
                budget[f.fingerprint] -= 1
                out.append("baselined")
            else:
                out.append("new")
        return out

    def to_dict(self) -> dict:
        out = [dict(f.to_dict(), status=s)
               for f, s in zip(self.findings, self.statuses())]
        return {
            "version": REPORT_VERSION,
            "ok": self.ok,
            "counts": {"total": len(self.findings), "new": len(self.new),
                       "baselined": len(self.baselined),
                       "suppressed": self.suppressed,
                       "stale": len(self.stale)},
            "findings": out,
            "stale": list(self.stale),
            "ledger": list(self.ledger),
            "errors": list(self.errors),
        }


class LintEngine:
    """Run a rule catalog over a file set and ratchet against a baseline."""

    def __init__(self, rules: Sequence[Rule], root: str = "."):
        names = [r.name for r in rules]
        dup = {n for n in names if names.count(n) > 1}
        if dup:
            raise ValueError(f"duplicate rule names: {sorted(dup)}")
        self.rules = list(rules)
        self.root = root

    def run(self, files: Iterable[Tuple[str, str]],
            baseline: Optional[Dict[str, int]] = None) -> LintReport:
        """``files`` yields (abs_path, repo_relative_path) pairs."""
        for rule in self.rules:
            rule.reset()
        findings: List[Finding] = []
        suppressed = 0
        errors: List[str] = []
        for path, rel in files:
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    source = fh.read()
                ctx = FileContext(path, rel, source)
            except (OSError, SyntaxError, ValueError) as e:
                errors.append(f"{rel}: {e}")
                continue
            for rule in self.rules:
                for f in rule.check(ctx):
                    if ctx.suppressed(f):
                        suppressed += 1
                    else:
                        findings.append(f)
        for rule in self.rules:
            findings.extend(rule.finalize())
        ledger: List[dict] = []
        for rule in self.rules:
            ledger.extend(getattr(rule, "ledger", ()))
        new, baselined, stale = apply_baseline(findings, baseline or {})
        return LintReport(findings=findings, new=new, baselined=baselined,
                          suppressed=suppressed, stale=stale, ledger=ledger,
                          errors=errors)


def apply_baseline(findings: List[Finding], baseline: Dict[str, int],
                   ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Split findings into (new, baselined) against per-fingerprint
    budget counts; return stale baseline fingerprints as the third
    element. Within one fingerprint the earliest occurrences (file
    order) consume the budget — which ones are 'old' is unknowable
    without line numbers, and any assignment keeps the invariant that
    #new = max(0, observed - budget)."""
    budget = dict(baseline)
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        if budget.get(f.fingerprint, 0) > 0:
            budget[f.fingerprint] -= 1
            old.append(f)
        else:
            new.append(f)
    seen = {f.fingerprint for f in findings}
    stale = sorted(fp for fp, n in baseline.items()
                   if n > 0 and fp not in seen)
    return new, old, stale


def baseline_from(findings: List[Finding]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.fingerprint] = counts.get(f.fingerprint, 0) + 1
    return counts


def load_baseline(path: str) -> Dict[str, int]:
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path}: version {doc.get('version')!r} != "
            f"{BASELINE_VERSION} — regenerate with --baseline-update")
    counts = doc.get("findings", {})
    if not isinstance(counts, dict) or not all(
            isinstance(v, int) and v > 0 for v in counts.values()):
        raise ValueError(f"baseline {path}: malformed findings table")
    return dict(counts)


def save_baseline(path: str, counts: Dict[str, int]) -> None:
    doc = {"version": BASELINE_VERSION,
           "findings": {k: counts[k] for k in sorted(counts)}}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=False)
        fh.write("\n")
