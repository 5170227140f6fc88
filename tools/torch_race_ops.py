#!/usr/bin/env python3
"""ATen ops a round of the port's one-query race, counted on the CPU.

    python3 tools/torch_race_ops.py [--src DIR] [--by-op]

Runs ``repro_torch.core.bmo_nn.knn`` (one ``ucb.race_topk`` a query) of 2
queries against 2,000 rows of 512 dimensions (normal draws from numpy's
seed 0; k 5, block 16, B 32, P 2, unrotated, ℓ2) on the CPU, once to warm
up and once under a ``TorchDispatchMode`` that counts every ATen op. The
round's host cost on a GPU is roughly its op count times a launch, so the
count compares two trees' per-round bookkeeping without a card. Prints
one JSON object: the rounds, the ops a round and, with ``--by-op``, the
count a round of each op. ``--src`` picks the source tree to import
(default: this checkout's ``src``).
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--by-op", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    from torch.utils._python_dispatch import TorchDispatchMode

    import repro_torch
    from repro_torch.configs.base import BMOConfig
    from repro_torch.core.bmo_nn import knn

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    r = np.random.default_rng(0)
    x = r.standard_normal((2000, 512)).astype(np.float32)
    q = r.standard_normal((2, 512)).astype(np.float32)
    cfg = BMOConfig(k=5, delta=0.01, block=16, batch_arms=32, metric="l2",
                    rotate=False)
    knn(x, q, cfg, 0, device="cpu")
    count = Count()
    with count:
        res = knn(x, q, cfg, 0, device="cpu")
    rounds = int(res.rounds.sum())
    out = {"src": os.path.dirname(os.path.abspath(repro_torch.__file__)),
           "rounds": rounds,
           "ops_per_round": sum(count.ops.values()) / rounds}
    if args.by_op:
        out["by_op"] = {k: v / rounds for k, v in count.ops.most_common()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
