#!/usr/bin/env python3
"""Host-driven race rounds a second of the port's one-query race, on one NVIDIA GPU.

    python3 tools/torch_race_round_ms.py [--src DIR] [--box paper|kmeans]
                                         [--seed S] [--queries Q] [--out FILE]

Times ``repro_torch.core.bmo_nn.knn``, one ``ucb.race_topk`` a query, the
loop whose every round the host drives (a pull, the bookkeeping, one sync):

* ``paper``: the ``bmo-nn-dense`` workload (n = 100,000, d = 12,288,
  rotated in the call, block 128, B = 32, P = 2, k 5), corpus and queries
  drawn on the card from ``--seed`` as ``chip_smoke.py`` draws them, Q
  queries (default 4);
* ``kmeans``: one assignment step of Fig. 5's BMO k-means
  (``benchmarks/fig5_kmeans.py``): the first 32 of Q points (default 64)
  of ``clustered_dense(Q, 8192, n_clusters=32, noise=0.1, seed=31)`` as
  the arms, every point a query, k 1, block 64, B 8, P 1, one init pull.

One warm-up query first (its rounds not counted), then the timed call,
synced. Prints one JSON object: the seconds, the rounds summed over the
queries and the ms a round. ``--src`` picks the source tree to import
(default: this checkout's ``src``), so the same script times another
commit unpacked elsewhere; run two trees alternately in one call (A, B, B,
A) to compare them on one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--box", choices=("paper", "kmeans"), default="paper")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int)
    ap.add_argument("--out", help="also append the JSON object to this file")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch
    if not torch.cuda.is_available():
        print("torch_race_round_ms: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.configs.base import BMOConfig
    from repro_torch.configs.bmo_nn import DENSE
    from repro_torch.core.bmo_nn import knn
    from repro_torch.data.synthetic import (clustered_dense,
                                            make_knn_benchmark_data)
    from repro_torch.kernels import _build

    _build.build_all()      # every kernel built before the first race
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    if args.box == "paper":
        Q = args.queries or 4
        corpus, queries = make_knn_benchmark_data(
            "dense", DENSE.n_points, DENSE.dim, Q + 1, seed=args.seed,
            device="cuda")
        cfg = DENSE.bmo
    else:
        Q = args.queries or 64
        queries = clustered_dense(Q + 1, 8192, n_clusters=32, noise=0.1,
                                  seed=31, device="cuda")
        corpus = queries[:32].clone()
        cfg = BMOConfig(k=1, delta=0.01, block=64, batch_arms=8,
                        pulls_per_round=1, init_pulls=1, metric="l2")
    knn(corpus, queries[Q:], cfg, args.seed)           # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = knn(corpus, queries[:Q], cfg, args.seed)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    rounds = int(res.rounds.sum())
    out = {"src": os.path.dirname(os.path.abspath(repro_torch.__file__)),
           "device": smi.strip().splitlines()[0], "box": args.box,
           "queries": Q, "seconds": seconds, "rounds": rounds,
           "ms_per_round": seconds * 1e3 / rounds}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
