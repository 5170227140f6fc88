"""Replay δ-audit flight-recorder bundles against a saved index through
the PyTorch port (``src/repro_torch``; DESIGN.md §10.5).

A δ-audit mismatch writes a bundle directory (``bundle.json`` +
``arrays.npz``) holding the query batch, the served ids/values, the exact
ground truth at audit time, the QuerySpec, and the ticket's trace events.
Bundles of either package share the layout. This CLI loads the index with
the port, re-runs its exact oracle and reports whether the recorded
mismatch reproduces:

    PYTHONPATH=src python tools/torch_replay_audit.py \\
        --index-dir saved_index bundles/audit-0000-p1.t7

The index loads onto the GPU unless ``--device cpu`` is given. Exit code 0
when every bundle's verdict matches expectations (reproduced on the same
store epoch, or explained by an epoch change), 1 when a recorded mismatch
silently vanished or a clean row went bad — either means the store or the
oracle moved under us.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def replay_one(index, path: str, verbose: bool = False) -> dict:
    """Replay one bundle against a loaded ``repro_torch.api.Index``; prints
    and returns the report with its verdict."""
    from repro_torch.obs.audit import load_bundle, replay_bundle
    doc, _arrays = load_bundle(path)
    report = replay_bundle(index, path)
    report["bundle"] = path
    report["trace_id"] = doc.get("trace_id")
    report["tenant"] = doc.get("tenant")
    verdict = ("REPRODUCED" if report["reproduced"]
               else ("EPOCH-CHANGED" if not report["epoch_match"]
                     else "NOT-REPRODUCED"))
    report["verdict"] = verdict
    print(f"{path}: {verdict} — recorded mismatch rows "
          f"{report['mismatch_rows_recorded']}, now "
          f"{report['mismatch_rows_now']} "
          f"(store epoch {report['store_epoch_recorded']} -> "
          f"{report['store_epoch_now']})")
    if verbose:
        print(json.dumps({k: v for k, v in report.items()
                          if k not in ("bundle",)}, indent=1, default=str))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="re-run δ-audit flight-recorder bundles against a "
                    "saved index, through the PyTorch port")
    ap.add_argument("bundles", nargs="+",
                    help="bundle directories (each holds bundle.json + "
                         "arrays.npz)")
    ap.add_argument("--index-dir", required=True,
                    help="Index.save directory to replay against")
    ap.add_argument("--device", default=None,
                    help="device to load the index onto (default: the "
                         "GPU; 'cpu' runs the port's plain versions)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the per-bundle replay reports here")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.api import Index
    index = Index.load(args.index_dir, device=args.device)
    reports = [replay_one(index, b, verbose=args.verbose)
               for b in args.bundles]
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"index_dir": args.index_dir,
                       "reports": reports}, f, indent=1, default=str)
    # a replay "fails" when the verdict is surprising: the epoch matched
    # but the mismatch came out different than recorded
    bad = [r for r in reports
           if r["epoch_match"] and not r["reproduced"]]
    if bad:
        print(f"{len(bad)}/{len(reports)} bundle(s) did NOT reproduce on "
              "a matching store epoch", file=sys.stderr)
        return 1
    print(f"{len(reports)} bundle(s) replayed, all consistent")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    sys.exit(main())
