#!/usr/bin/env python
"""torch_lint — run the port's invariant rule catalog (DESIGN.md §12) over
``src/repro_torch``: the counterpart of ``tools/repro_lint.py``.

Usage:
    python tools/torch_lint.py [paths...]         # default: src/repro_torch
    python tools/torch_lint.py --json report.json # machine-readable report
    python tools/torch_lint.py --ledger           # print the δ-split table
    python tools/torch_lint.py --ptxas-log build  # price the CUDA kernels
    python tools/torch_lint.py --ptxas-log build --launches launches.json
    python tools/torch_lint.py --baseline-update  # refreeze the ratchet

``--ptxas-log DIR`` hands the Hopper rule the ``ptxas -v`` logs in DIR
(``<stem>[-<hash>].log``, as ``kernels/_build.py`` keeps them beside each
library in ``build/``); without it the CUDA kernels are not priced and
their frozen baseline entries are set aside, so refreeze the baseline
with ``--ptxas-log`` to keep them. ``--launches FILE`` adds the card's
records of the kernels' launches at the path's shapes (a JSON list of
``rules_hopper.parse_trace`` records, as ``chip_smoke.py`` writes them):
each launch is held to the budgets, and prices the instantiation it ran.

Exit codes: 0 clean (new findings == 0), 1 new findings, 2 usage /
unparseable-file errors. Pre-existing findings frozen in the committed
baseline (tools/torch_lint_baseline.json) report as [baselined] and do not
fail the run — the ratchet only stops NEW debt.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "src"))

from repro_torch.analysis import (LintEngine, baseline_from,  # noqa: E402
                                  default_rules, load_baseline,
                                  save_baseline)
from repro_torch.analysis.rules_hopper import read_logs  # noqa: E402

DEFAULT_BASELINE = os.path.join(_REPO, "tools", "torch_lint_baseline.json")


def iter_files(paths):
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            yield p, os.path.relpath(p, _REPO).replace(os.sep, "/")
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", ".git"))
            for fname in sorted(filenames):
                if fname.endswith(".py"):
                    full = os.path.join(dirpath, fname)
                    yield full, os.path.relpath(
                        full, _REPO).replace(os.sep, "/")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    default=[os.path.join(_REPO, "src", "repro_torch")])
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="ratchet baseline JSON (default: %(default)s)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding as new")
    ap.add_argument("--baseline-update", action="store_true",
                    help="refreeze the baseline from this run's findings")
    ap.add_argument("--json", metavar="FILE",
                    help="write the machine-readable report ('-' = stdout)")
    ap.add_argument("--ledger", action="store_true",
                    help="print the delta-split ledger table")
    ap.add_argument("--ptxas-log", metavar="DIR",
                    help="price the CUDA kernels from the ptxas -v logs "
                         "in DIR")
    ap.add_argument("--launches", metavar="FILE",
                    help="with --ptxas-log, price the kernels' launches "
                         "recorded in FILE (JSON)")
    args = ap.parse_args(argv)

    baseline = {}
    if not args.no_baseline and not args.baseline_update \
            and os.path.exists(args.baseline):
        try:
            baseline = load_baseline(args.baseline)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    logs = {}
    if args.ptxas_log:
        if not os.path.isdir(args.ptxas_log):
            print(f"error: --ptxas-log {args.ptxas_log}: not a directory",
                  file=sys.stderr)
            return 2
        logs = read_logs(args.ptxas_log)
    else:
        # nothing to price: the kernels' frozen findings cannot be seen,
        # so they are neither matched nor reported stale
        baseline = {fp: n for fp, n in baseline.items()
                    if not fp.startswith("hopper-budget|")}

    launches = []
    if args.launches:
        try:
            with open(args.launches, "r", encoding="utf-8") as fh:
                launches = json.load(fh)
        except (OSError, ValueError) as e:
            print(f"error: --launches {args.launches}: {e}", file=sys.stderr)
            return 2
        if not isinstance(launches, list):
            print(f"error: --launches {args.launches}: not a JSON list",
                  file=sys.stderr)
            return 2

    engine = LintEngine(default_rules(logs, root=_REPO, launches=launches),
                        root=_REPO)
    report = engine.run(iter_files(args.paths), baseline)

    if args.baseline_update:
        save_baseline(args.baseline, baseline_from(report.findings))
        print(f"baseline refrozen: {len(report.findings)} finding(s) -> "
              f"{args.baseline}")
        return 0

    if args.json:
        doc = json.dumps(report.to_dict(), indent=1)
        if args.json == "-":
            print(doc)
        else:
            with open(args.json, "w", encoding="utf-8") as fh:
                fh.write(doc + "\n")

    for f, status in zip(report.findings, report.statuses()):
        print(f.render(status))
    for fp in report.stale:
        print(f"warning: stale baseline entry (fixed? shrink with "
              f"--baseline-update): {fp}")
    for err in report.errors:
        print(f"error: {err}", file=sys.stderr)

    if args.ledger:
        print("\ndelta-split ledger (sanctioned split sites):")
        for row in report.ledger:
            print(f"  {row['helper']:12s} {row['path']}:{row['line']} "
                  f"in {row['function']}")

    c = report.to_dict()["counts"]
    print(f"\n{c['total']} finding(s): {c['new']} new, "
          f"{c['baselined']} baselined, {c['suppressed']} suppressed, "
          f"{c['stale']} stale baseline entr(y/ies)")
    if report.errors:
        return 2
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
