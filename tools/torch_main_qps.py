#!/usr/bin/env python3
"""Queries a second of the port's blocking fused driver, on one NVIDIA GPU.

    python3 tools/torch_main_qps.py [--src DIR] [--seed S] [--queries Q]
                                    [--reps R] [--out FILE]

Builds the ``bmo-nn-dense`` index at full size (n = 100,000, d = 12,288,
rotated; corpus and queries drawn on the card from ``--seed`` as
``chip_smoke.py`` draws them) and runs ``Index.query`` of the Q queries
(default 1,024) R + 1 times with the query cache bypassed: the first
query is cold, as ``chip_smoke.py``'s main path times it; the R after it
are warm. For each: the QPS by the host's clock (the result is host
arrays, so the query is synced), and the fused driver's epochs (its
``fused_epoch_pull`` launches less the init). ``--src`` picks the source
tree to import (default: this checkout's ``src``), so the same script
times another commit unpacked elsewhere; run two trees alternately in one
call (A, B, B, A) to compare them on one card. Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", help="also append the JSON object to this file")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch
    if not torch.cuda.is_available():
        print("torch_main_qps: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.api import Index
    from repro_torch.configs.bmo_nn import DENSE
    from repro_torch.data.synthetic import make_knn_benchmark_data
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_race import fused_epoch_pull_cuda

    _build.build_all()      # every kernel built before the first query
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    corpus, queries = make_knn_benchmark_data(
        "dense", DENSE.n_points, DENSE.dim, args.queries, seed=args.seed,
        device="cuda")
    idx = Index.build(corpus, DENSE.bmo, args.seed)
    torch.cuda.synchronize()
    qps, epochs = [], []
    for _ in range(args.reps + 1):
        launches = fused_epoch_pull_cuda.launches
        t = time.perf_counter()
        idx.query(queries, args.seed, cache="bypass")
        qps.append(args.queries / (time.perf_counter() - t))
        epochs.append(fused_epoch_pull_cuda.launches - launches - 1)
    out = {"src": os.path.dirname(os.path.abspath(repro_torch.__file__)),
           "device": smi.strip().splitlines()[0], "queries": args.queries,
           "qps_cold": qps[0], "qps_warm": qps[1:],
           "qps_warm_median": statistics.median(qps[1:]),
           "epochs": epochs}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
