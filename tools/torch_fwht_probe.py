#!/usr/bin/env python3
"""The fwht kernel at the main path's shapes and across d, on one NVIDIA GPU.

    python3 tools/torch_fwht_probe.py [--src DIR] [--out FILE]

* The ``bmo-nn-dense`` workload's shapes (d_pad 16,384): a query batch of
  1,024 rows and the corpus at build, 100,000 rows, in fp32 and bf16; each
  checked against ``ref.fwht_ref`` (on its first 2,048 rows; 1e-5 fp32,
  5e-2 bf16), then timed: ms by CUDA events over back-to-back calls and
  device ms under torch.profiler, beside the bound (each value read and
  written once at 3.35 TB/s).
* Every d the kernel takes, 2 to 32,768, at 2**24 values a call (64 MB of
  fp32), both types: device ms and its share of the bound.
* ptxas's registers and spills for each fwht kernel, and (where the tree
  has it) the plan the kernel reports at d = 16,384.

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
        print("torch_fwht_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import fwht as kfwht

    _build.build_all()
    head = {"src": os.path.abspath(args.src),
            "device": torch.cuda.get_device_name(0),
            "ptxas": {name: info for name, info
                      in cs.ptxas_functions("fwht").items()}}
    if hasattr(kfwht, "kernel_plan"):
        head["plan_16384"] = {str(dt).replace("torch.", ""):
                              kfwht.kernel_plan(16384, dt)
                              for dt in (torch.float32, torch.bfloat16)}
    rows = [head]
    cs.emit(head)
    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)

    def timed(x, what: dict, check: bool) -> dict:
        run = lambda: kfwht.fwht_cuda(x)
        row = dict(what)
        if check:
            tol = 1e-5 if x.dtype == torch.float32 else 5e-2
            row.update(cs.compare(f"fwht {what}", run()[:2048],
                                  ref.fwht_ref(x[:2048]), rtol=tol, atol=tol))
            row["ms"] = cs.cuda_ms(run, reps=10)
        row["device_ms"] = cs.device_ms(run, "fwht_kernel")
        row["bound_ms"], row["bound_by"] = cs.fwht_bound(x)
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
        rows.append(row)
        cs.emit(row)
        return row

    for n in (1024, 100_000):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((n, 16384), generator=g, device="cuda").to(dtype)
            timed(x, {"case": "queries" if n == 1024 else "build",
                      "rows": n, "d": 16384,
                      "dtype": str(dtype).replace("torch.", "")}, True)
            del x
    torch.cuda.empty_cache()
    for log_d in range(1, 16):
        d = 1 << log_d
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(((1 << 24) // d, d), generator=g,
                            device="cuda").to(dtype)
            timed(x, {"case": "sweep", "rows": x.shape[0], "d": d,
                      "dtype": str(dtype).replace("torch.", "")}, False)
            del x
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
