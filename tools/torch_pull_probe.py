#!/usr/bin/env python3
"""The two pull kernels at the main path's shapes, on one NVIDIA GPU.

    python3 tools/torch_pull_probe.py [--src DIR] [--out FILE]

At the ``bmo-nn-dense`` workload's index shapes (capacity 131,072 rows,
d_pad 16,384, block 128, 1,024 queries, random fp32 data from a seed):

* ``fused_epoch_pull``'s wide init (every arm of every query, T = 2, the
  arm vector expanded to (Q, B)) and one epoch (B = 32 random arms a query,
  T = 128) at n_buf 2, 4 and 8;
* ``block_pull_multi``'s wide init (P = 2, expanded arms) and one round
  (B = 32, P = 2).

Each is checked against its plain version on the first 16 queries (rtol
2e-4 / atol 1e-5), then timed: ms by CUDA events over back-to-back calls
and device ms under torch.profiler. The inits also over a quarter of the
queries (whose rows stay in L2 whatever order the blocks take them in).
Also the card's L2 read rate, as ``chip_smoke.py`` measures it
(``csrc/l2_read.cu``).
``--src`` picks the source tree to import (default: this checkout's
``src``), so the same script measures another commit unpacked elsewhere.
Prints one JSON object per row.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_pull_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.block_pull import block_pull_multi_cuda
    from repro_torch.kernels.fused_race import fused_epoch_pull_cuda

    _build.build_all()
    rows = [{"src": os.path.abspath(args.src),
             "device": torch.cuda.get_device_name(0),
             "l2_read": cs.l2_read_rates()
             if "l2_read" in _build.build_log else None}]
    for stem in ("fused_epoch_pull", "block_pull"):
        log = _build.build_log[stem]["log"] or ""
        rows.append({"ptxas": stem, "lines": [
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "Compiling" in line]})
    print(json.dumps(rows[0]), flush=True)

    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    Q, cap, d_pad, block, Qs = 1024, 131072, 16384, 128, 16
    nb = d_pad // block
    x = torch.randn((cap, d_pad), generator=g, device="cuda")
    qs = torch.randn((Q, d_pad), generator=g, device="cuda")
    expanded = torch.arange(cap, dtype=torch.int32,
                            device="cuda")[None].expand(Q, cap)
    random32 = torch.randint(0, cap, (Q, 32), generator=g, device="cuda",
                             dtype=torch.int32)

    def row(kernel, case, run, plain, arm, blk, symbol, reps, **extra):
        got = run()[:Qs]
        out = {"kernel": kernel, "case": case, **extra,
               **cs.compare(f"{kernel} {case}", got, plain(), rtol=2e-4,
                            atol=1e-5)}
        del got
        out["ms"] = cs.cuda_ms(run, reps=reps, warmup=1)
        out["device_ms"] = cs.device_ms(run, symbol, reps=min(reps, 5))
        out["bound_ms"] = cs.pull_bound(x, arm, blk, block,
                                        out_floats=extra.get("P", 2))[0]
        rows.append(out)
        print(json.dumps(out), flush=True)

    blk = torch.randint(0, nb, (Q, cap, 2), generator=g, device="cuda",
                        dtype=torch.int32)
    row("fused_epoch_pull", "init",
        lambda: fused_epoch_pull_cuda(x, qs, expanded, blk, block=block),
        lambda: ref.fused_epoch_pull_ref(x, qs[:Qs], expanded[:Qs], blk[:Qs],
                                         block),
        expanded, blk, "fused_epoch_pull", 3)
    row("block_pull_multi", "init",
        lambda: block_pull_multi_cuda(x, qs, expanded, blk, block=block),
        lambda: ref.block_pull_multi_ref(x, qs[:Qs], expanded[:Qs], blk[:Qs],
                                         block),
        expanded, blk, "block_pull", 3, P=2)
    # the same inits over a quarter of the queries (16 MB of query rows, which
    # stay in L2 whatever order the blocks in flight take them in)
    Qq = Q // 4
    row("fused_epoch_pull", "init_quarter_queries",
        lambda: fused_epoch_pull_cuda(x, qs[:Qq], expanded[:Qq], blk[:Qq],
                                      block=block),
        lambda: ref.fused_epoch_pull_ref(x, qs[:Qs], expanded[:Qs], blk[:Qs],
                                         block),
        expanded[:Qq], blk[:Qq], "fused_epoch_pull", 3, queries=Qq)
    row("block_pull_multi", "init_quarter_queries",
        lambda: block_pull_multi_cuda(x, qs[:Qq], expanded[:Qq], blk[:Qq],
                                      block=block),
        lambda: ref.block_pull_multi_ref(x, qs[:Qs], expanded[:Qs], blk[:Qs],
                                         block),
        expanded[:Qq], blk[:Qq], "block_pull", 3, queries=Qq, P=2)
    del blk
    blk = torch.randint(0, nb, (Q, 32, 128), generator=g, device="cuda",
                        dtype=torch.int32)
    for n_buf in (2, 4, 8):
        row("fused_epoch_pull", "epoch",
            lambda: fused_epoch_pull_cuda(x, qs, random32, blk, block=block,
                                          n_buf=n_buf),
            lambda: ref.fused_epoch_pull_ref(x, qs[:Qs], random32[:Qs],
                                             blk[:Qs], block),
            random32, blk, "fused_epoch_pull", 20, n_buf=n_buf)
    blk = torch.randint(0, nb, (Q, 32, 2), generator=g, device="cuda",
                        dtype=torch.int32)
    row("block_pull_multi", "round",
        lambda: block_pull_multi_cuda(x, qs, random32, blk, block=block),
        lambda: ref.block_pull_multi_ref(x, qs[:Qs], random32[:Qs], blk[:Qs],
                                         block),
        random32, blk, "block_pull", 50, P=2)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
