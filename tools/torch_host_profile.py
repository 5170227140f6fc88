#!/usr/bin/env python3
"""Host cost per call of the port's shortest kernel calls, on one NVIDIA GPU.

    python3 tools/torch_host_profile.py [--src DIR] [--calls N] [--out FILE]

Makes the calls that the paper path (``repro_torch.core.bmo_nn``) makes in
every round, at the ``bmo-nn-dense`` workload's shapes (n = 100,000,
d_pad = 16,384, block 128, B = 32 arms, P = 2 pulls):

* ``block_pull_cuda`` of one query with int64 arm ids (as ``smallest_k``
  gives them) and int32 block ids (as the block sampler gives them);
* ``pairwise_dist_cuda`` of one query against the 32 rows just gathered
  (the exact evaluation).

For each, N back-to-back calls (default 1,000), each result dropped before
the next: ms per call by CUDA events; the CUDA kernels per call and their
device time under torch.profiler; and cProfile of the calls, the functions
where the host's time goes, in µs per call. For a tree whose wrappers call
through ``kernels/_build.py:launch``, also the parts of a ``block_pull``
call by the host's clock (20,000 calls each): the ctypes call alone (a
launch of nothing), the ctypes call and the launch, the output's
allocation, and the whole wrapper. ``--src`` picks the source tree to
import (default: this checkout's ``src``), so the same script profiles
another commit unpacked elsewhere. Prints one JSON object per call kind.
"""
from __future__ import annotations

import argparse
import cProfile
import gc
import json
import os
import pstats
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profile_calls(name: str, fn, calls: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(200):           # brings the host's clock up
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    gc.disable()                   # as timeit does
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    gc.enable()
    ms = start.elapsed_time(end) / calls

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            if us > 0:
                kernels[ev.key[:80]] = {"per_call": ev.count / calls,
                                        "device_us_per_call": us / calls}

    pr = cProfile.Profile()
    pr.enable()
    for _ in range(calls):
        fn()
    pr.disable()
    torch.cuda.synchronize()
    st = pstats.Stats(pr)
    host_us = st.total_tt / calls * 1e6
    top = []
    for (path, line, func), (cc, nc, tt, ct, _) in sorted(
            st.stats.items(), key=lambda kv: -kv[1][2])[:15]:
        where = func if path == "~" else \
            f"{os.path.basename(path)}:{line}({func})"
        top.append({"function": where, "calls_per_call": nc / calls,
                    "self_us_per_call": tt / calls * 1e6,
                    "cumulative_us_per_call": ct / calls * 1e6})
    return {"call": name, "calls": calls, "ms_per_call_events": ms,
            "host_us_per_call_cprofile": host_us,
            "cuda_kernels_per_call": sum(k["per_call"]
                                         for k in kernels.values()),
            "kernels": kernels, "top_by_self_time": top}


def host_us(fn, calls: int = 20_000) -> float:
    """µs of the host's clock per call of ``fn``, GC off, after a warm-up."""
    import time
    import torch
    for _ in range(500):
        fn()
    torch.cuda.synchronize()
    gc.disable()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    gc.enable()
    torch.cuda.synchronize()
    return us


def block_pull_parts(x, q, arm, blk, block: int) -> dict:
    """The parts of one ``block_pull_cuda`` call, by the host's clock."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_pull import _ENTRY, block_pull_cuda
    fn = _ENTRY.fn or _ENTRY.resolve()
    out = torch.empty(blk.shape, device=x.device)
    B, P = blk.shape
    ptrs = [x.data_ptr(), q.data_ptr(), arm.data_ptr(), blk.data_ptr(),
            out.data_ptr(), x.shape[0], x.shape[1], 1, B, P]
    # block, metric, dtype and id types; a tree with the rows schedule also
    # takes the arm stride (after P) and the schedule (0: pair)
    if len(_ENTRY.argtypes) == 17:
        args = ptrs + [block, 0, 0, 1, 0]
    else:
        args = ptrs + [0, block, 0, 0, 1, 0, 0]
    args.append(_build._raw_stream(x.get_device()))
    nothing = list(args)
    nothing[7] = 0                       # Q = 0: returns before launching
    return {"call": "block_pull_cuda parts (host clock, µs a call)",
            "ctypes_call_launching_nothing_us": host_us(lambda: fn(*nothing)),
            "ctypes_call_and_launch_us": host_us(lambda: fn(*args)),
            "output_allocation_us": host_us(
                lambda: x.new_empty((B, P), dtype=torch.float32)),
            "wrapper_us": host_us(
                lambda: block_pull_cuda(x, q, arm, blk, block=block))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_host_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels.block_pull import block_pull_cuda
    from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    n, d_pad, block, B, P = 100_000, 16_384, 128, 32, 2
    x = torch.randn((n, d_pad), generator=g, device="cuda")
    q = torch.randn((d_pad,), generator=g, device="cuda")
    arm = torch.randint(0, n, (B,), generator=g, device="cuda")     # int64
    blk = torch.randint(0, d_pad // block, (B, P), generator=g,
                        device="cuda", dtype=torch.int32)
    rows = x[arm]
    results = [
        profile_calls("block_pull_cuda(x, q, arm int64 (32,), blk int32 "
                      "(32, 2), block=128)",
                      lambda: block_pull_cuda(x, q, arm, blk, block=block),
                      args.calls),
        profile_calls("pairwise_dist_cuda(q[None], rows (32, 16384))",
                      lambda: pairwise_dist_cuda(q[None], rows), args.calls)]
    from repro_torch.kernels import _build
    if hasattr(_build, "launch"):
        results.append(block_pull_parts(x, q, arm, blk, block))
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    for r in results:
        r.update({"src": os.path.abspath(args.src), "device": smi,
                  "torch": torch.__version__})
        print(json.dumps(r), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
