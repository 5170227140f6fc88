#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--queries Q] [--out FILE.json]

Run from the root of a checkout. In order it:

1. prints the card's name and power limit (``nvidia-smi``) and builds the
   port's CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``
   (into ``build/``), timing the build;
2. kernel phase: calls each kernel's wrapper at the main path's shapes and
   holds the result against its plain PyTorch version on the same inputs
   (fp32 at rtol 2e-4 / atol 1e-5 for the pull statistics, 1e-5 for the
   fp32 transform, 5e-2 for bf16), timing kernel and plain version with
   CUDA events, beside the least time the card could take (bytes over
   3.35 TB/s, operations over 67 TFLOP/s fp32);
3. checks the whole path on a small input on the card against a brute
   force;
4. main-path phase: ``Index.build`` → ``Index.query`` of the repo's
   ``bmo-nn-dense`` workload at its published size (n = 100,000,
   d = 12,288, rotated, k = 5, δ = 0.01, block 128, 1,024 queries) on a
   corpus made on the card from ``--seed``, with the kernels' launch
   counters set to 0 just before and read just after; recall against a
   float64 brute force, which must reach 0.99 (the δ = 0.01 guarantee);
5. a second, traced query for the device-time breakdown.

``--out`` also writes every detail (build logs, all rows) to a JSON file.
The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Any mismatch, a recall under 0.99, or a
kernel that the main path never launched raises, and the script exits
non-zero; so it does without a GPU or without the rest of the repository.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM (data sheet): device memory rate and fp32 rate outside the
# tensor cores, the peaks the bounds are taken against
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls (CUDA
    events), after ``warmup`` calls. Each result is dropped before the next
    call, so the caching allocator reuses its memory."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(what: str, got, want, *, rtol: float, atol: float) -> dict:
    import torch
    got = got.to(torch.float32)
    want = want.to(torch.float32)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (got - want).abs()
    out = {"max_abs_err": float(err.max()),
           "max_rel_err": float((err / (want.abs() + atol)).max())}
    if not bool((err <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version beyond rtol={rtol}, atol={atol}: {out}")
    return out


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pull_bound(x, arm, blk, block: int) -> tuple:
    """Least time for one fused_epoch_pull: each distinct corpus block and
    query block it needs read once, the indices read once, the output
    written once; 3 flops per pulled element."""
    import torch
    Q, B, T = blk.shape
    nb = x.shape[1] // block
    seen = torch.zeros(x.shape[0] * nb, dtype=torch.bool, device=x.device)
    seen[(arm.long()[:, :, None] * nb + blk.long()).reshape(-1)] = True
    qseen = torch.zeros(Q * nb, dtype=torch.bool, device=x.device)
    qseen[(torch.arange(Q, device=x.device)[:, None, None] * nb
           + blk.long()).reshape(-1)] = True
    nbytes = ((int(seen.sum()) + int(qseen.sum())) * block * 4
              + arm.numel() * 4 + blk.numel() * 4 + Q * B * 2 * 4)
    return bound_ms(nbytes, 3.0 * Q * B * T * block)


def fwht_bound(x) -> tuple:
    rows, d = x.numel() // x.shape[-1], x.shape[-1]
    return bound_ms(2.0 * x.numel() * x.element_size(),
                    rows * d * (math.log2(d) + 1.0))


def kernel_phase(seed: int, Q: int, n_build: int) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_race import fused_epoch_pull_cuda
    from repro_torch.kernels.fwht import fwht_cuda

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    cap, d_pad, block, B, T = 131072, 16384, 128, 32, 128
    nb = d_pad // block
    x = torch.randn((cap, d_pad), generator=g, device="cuda")
    qs = torch.randn((Q, d_pad), generator=g, device="cuda")
    results = {"fused_epoch_pull": [], "fwht": []}

    # --- fused_epoch_pull: one epoch (B = batch_arms, T = R_cap·P) ----------
    arm = torch.randint(0, cap, (Q, B), generator=g, device="cuda",
                        dtype=torch.int32)
    blk = torch.randint(0, nb, (Q, B, T), generator=g, device="cuda",
                        dtype=torch.int32)
    for metric in ("l2", "l1"):
        run = lambda: fused_epoch_pull_cuda(x, qs, arm, blk, block=block,
                                            metric=metric)
        plain = lambda: ref.fused_epoch_pull_ref(x, qs, arm, blk, block,
                                                 metric)
        row = {"kernel": "fused_epoch_pull", "case": "epoch", "metric": metric,
               "shape": {"Q": Q, "B": B, "T": T, "block": block,
                         "d_pad": d_pad, "n": cap}}
        row.update(compare(f"fused_epoch_pull epoch {metric}", run(), plain(),
                           rtol=2e-4, atol=1e-5))
        row["ms"] = cuda_ms(run, reps=20)
        row["plain_ms"] = cuda_ms(plain, reps=3, warmup=1)
        row["bound_ms"], row["bound_by"] = pull_bound(x, arm, blk, block)
        row["library_ms"] = None
        results["fused_epoch_pull"].append(row)
        emit(row)

    # --- fused_epoch_pull: the wide init (every arm of every query) ---------
    T0, Qs = 2, 16
    arm = torch.arange(cap, dtype=torch.int32, device="cuda")[None].expand(Q, cap)
    blk = torch.randint(0, nb, (Q, cap, T0), generator=g, device="cuda",
                        dtype=torch.int32)
    run = lambda: fused_epoch_pull_cuda(x, qs, arm, blk, block=block)
    plain = lambda: ref.fused_epoch_pull_ref(x, qs[:Qs], arm[:Qs], blk[:Qs],
                                             block)
    row = {"kernel": "fused_epoch_pull", "case": "init", "metric": "l2",
           "shape": {"Q": Q, "B": cap, "T": T0, "block": block,
                     "d_pad": d_pad, "n": cap},
           "plain_checked_on_queries": Qs}
    row.update(compare("fused_epoch_pull init", run()[:Qs], plain(),
                       rtol=2e-4, atol=1e-5))
    row["ms"] = cuda_ms(run, reps=3, warmup=1)
    row["plain_ms_first_queries"] = cuda_ms(plain, reps=2, warmup=1)
    row["bound_ms"], row["bound_by"] = pull_bound(x, arm, blk, block)
    row["library_ms"] = None
    results["fused_epoch_pull"].append(row)
    emit(row)
    del x, arm, blk
    torch.cuda.empty_cache()

    # --- fwht: each query batch, and the corpus at build ---------------------
    hadamard = None
    for rows in (Q, n_build):
        for dtype in (torch.float32, torch.bfloat16):
            xin = torch.randn((rows, d_pad), generator=g, device="cuda").to(dtype)
            tol = 1e-5 if dtype == torch.float32 else 5e-2
            run = lambda: fwht_cuda(xin)
            plain = lambda: ref.fwht_ref(xin)
            row = {"kernel": "fwht", "case": "queries" if rows == Q else "build",
                   "dtype": str(dtype).replace("torch.", ""),
                   "shape": {"rows": rows, "d": d_pad}}
            row.update(compare(f"fwht {rows}x{d_pad} {dtype}", run(), plain(),
                               rtol=tol, atol=tol))
            row["ms"] = cuda_ms(run, reps=10)
            row["plain_ms"] = cuda_ms(plain, reps=2, warmup=1)
            row["bound_ms"], row["bound_by"] = fwht_bound(xin)
            row["library_ms"] = None
            if rows == Q and dtype == torch.float32:
                # yardstick only: one dense matmul against H/√d, full fp32
                if hadamard is None:
                    hadamard = torch.ones((1, 1), device="cuda")
                    while hadamard.shape[0] < d_pad:
                        hadamard = torch.cat([torch.cat([hadamard, hadamard], 1),
                                              torch.cat([hadamard, -hadamard], 1)])
                    hadamard /= math.sqrt(d_pad)
                row["library_ms"] = cuda_ms(lambda: xin @ hadamard, reps=5)
                row["library_call"] = "torch.matmul(x, H/sqrt(d)), fp32, TF32 off"
            results["fwht"].append(row)
            emit(row)
            del xin
    del hadamard
    torch.cuda.empty_cache()
    return results


def small_input_phase() -> dict:
    """The whole path on a small input on the card: the exact top-k of a
    brute force (the CPU tests' datasets and config)."""
    import numpy as np
    from repro_torch.api import Index
    from repro_torch.configs.base import BMOConfig
    from repro_torch.data.synthetic import make_knn_benchmark_data

    corpus, queries = make_knn_benchmark_data("dense", 500, 1024, 5, seed=21)
    dist = ((queries[:, None, :].astype(np.float64)
             - corpus[None].astype(np.float64)) ** 2).sum(-1)
    truth = [set(r) for r in np.argsort(dist, 1, kind="stable")[:, :3].tolist()]
    out = {}
    for rotate in (False, True):
        cfg = BMOConfig(k=3, delta=0.01, block=64, batch_arms=16,
                        pulls_per_round=2, metric="l2", rotate=rotate)
        res = Index.build(corpus, cfg, device="cuda").query(queries)
        got = [set(r) for r in res.indices.tolist()]
        if got != truth:
            raise AssertionError(f"small input, rotate={rotate}: top-k "
                                 f"{got} != brute force {truth}")
        out["rotated" if rotate else "dense"] = "exact top-k"
    return out


def brute_force_topk(corpus, queries, k: int, chunk: int = 128):
    """Exact top-k by float64 squared distance, in query chunks."""
    import torch
    x = corpus.to(torch.float64)
    x2 = (x * x).sum(1)
    out = []
    for s in range(0, queries.shape[0], chunk):
        q = queries[s:s + chunk].to(torch.float64)
        dist = (q * q).sum(1)[:, None] + x2[None] - 2.0 * (q @ x.T)
        out.append(torch.topk(dist, k, dim=1, largest=False).indices)
    return torch.cat(out).cpu().numpy()


def main_path_phase(seed: int, Q: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.api import Index
    from repro_torch.configs.bmo_nn import DENSE
    from repro_torch.data.synthetic import make_knn_benchmark_data
    from repro_torch.kernels.fused_race import fused_epoch_pull_cuda
    from repro_torch.kernels.fwht import fwht_cuda

    cfg, n, d = DENSE.bmo, DENSE.n_points, DENSE.dim
    t = time.perf_counter()
    corpus, queries = make_knn_benchmark_data("dense", n, d, Q, seed=seed,
                                              device="cuda")
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    fused_epoch_pull_cuda.launches = 0
    fwht_cuda.launches = 0
    t = time.perf_counter()
    idx = Index.build(corpus, cfg, seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    res = idx.query(queries, seed)          # returns host arrays: synced
    query_s = time.perf_counter() - t
    launches = {"fused_epoch_pull": fused_epoch_pull_cuda.launches,
                "fwht": fwht_cuda.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the main path never launched {name}")

    k = cfg.k
    if res.indices.shape != (Q, k) or not np.isfinite(res.values).all():
        raise AssertionError("main path: malformed result")
    if not ((res.indices >= 0) & (res.indices < n)).all():
        raise AssertionError("main path: a returned slot is not a corpus row")
    truth = brute_force_topk(corpus, queries, k)
    hits = [len(set(a) & set(b)) for a, b in zip(res.indices.tolist(),
                                                 truth.tolist())]
    recall = float(np.mean(hits)) / k
    out = {
        "phase": "main_path", "workload": DENSE.name, "n": n, "d": d,
        "queries": Q, "k": k, "delta": cfg.delta, "block": cfg.block,
        "batch_arms": cfg.batch_arms, "rotate": cfg.rotate, "seed": seed,
        "data_s": data_s, "build_s": build_s, "query_s": query_s,
        "qps": Q / query_s, "epochs": launches["fused_epoch_pull"] - 1,
        "recall": recall, "queries_below_full_recall": int(
            sum(h < k for h in hits)),
        "coord_ops_share_of_nd": float(np.mean(res.coord_ops)) / (n * d),
        "rounds_mean": float(np.mean(res.rounds)),
        "n_exact_mean": float(np.mean(res.n_exact)),
        "launches": launches, "peak_memory_gb": peak_gb,
        "ground_truth": "float64 brute force on the card; "
                        "allow_tf32 False for matmul and cuDNN",
    }
    if recall < 0.99:
        raise AssertionError(f"main path recall {recall} < 0.99: {out}")
    out["traced"] = traced_query(idx, queries, seed)
    return out


def traced_query(idx, queries, seed: int) -> dict:
    """One more query under torch.profiler: device time by kernel and the
    device's idle share of the query's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        idx.query(queries, seed)
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = []
    for ev in prof.key_averages():
        # kernel rows only: an operator's row repeats its kernels' time
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append({"name": ev.key[:90], "device_ms": dev_us / 1e3,
                         "calls": ev.count})
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    ours = [r for r in rows
            if "fused_epoch_pull_kernel" in r["name"] or "fwht_kernel" in r["name"]]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            "port_kernels": ours, "top": rows[:15]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=1024,
                    help="main-path query batch (the workload's is 1024)")
    ap.add_argument("--out", help="write every detail to this JSON file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "allow_tf32_matmul": False,
          "allow_tf32_cudnn": False})
    if args.queries != 1024:
        emit({"cut": f"main-path queries {args.queries} instead of 1024"})

    t = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "per_source_s": {k: v["seconds"] for k, v in _build.build_log.items()}})

    report = {"nvidia_smi": smi.strip(),
              "build_log": {k: v["log"] for k, v in _build.build_log.items()}}
    report["kernels"] = kernel_phase(args.seed, args.queries, 100_000)
    report["small_input"] = small_input_phase()
    emit({"phase": "small_input", **report["small_input"]})
    report["main_path"] = main_path_phase(args.seed, args.queries)
    emit({k: v for k, v in report["main_path"].items() if k != "traced"})
    emit({"phase": "traced_query", **report["main_path"]["traced"]})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)

    launches = report["main_path"]["launches"]
    summary = []
    for name, src, replaces in (
            ("fused_epoch_pull", "src/repro_torch/csrc/fused_epoch_pull.cu",
             "src/repro/kernels/fused_race.py:89"),
            ("fwht", "src/repro_torch/csrc/fwht.cu",
             "src/repro/kernels/fwht.py:30")):
        row = report["kernels"][name][0]   # the main path's per-query shape
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
