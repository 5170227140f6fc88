"""The port's invariant lint engine (``repro_torch.analysis``) held to the
reference's: every scenario of ``tests/test_analysis.py`` is a case here,
written in the port's idiom (``.item()`` and ``.cpu()`` where the
reference syncs through ``device_get``/``np.asarray``, a pow2 tensor width
where it has a jit static argument, a ``ptxas -v`` record where it has a
Pallas ``BlockSpec``), run against the port's rules. The engine's
suppression and ratchet semantics, the CLI's exit codes and JSON report,
and the δ-split ledger over the real port tree are pinned the same way.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis import (LintEngine, apply_baseline, baseline_from,
                                  default_rules, load_baseline,
                                  save_baseline)
from repro_torch.analysis.engine import Finding
from repro_torch.analysis.rules_delta import DeltaLedgerRule
from repro_torch.analysis.rules_fence import EpochFenceRule
from repro_torch.analysis.rules_hopper import (HopperBudgetRule, kernel_name,
                                               launch_key, parse_ptxas,
                                               parse_trace, read_logs,
                                               template_args)
from repro_torch.analysis.rules_hostsync import HostSyncRule
from repro_torch.analysis.rules_metrics import MetricsConformanceRule
from repro_torch.analysis.rules_recompile import Pow2WidthRule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANE = "src/repro_torch/serve/plane.py"
HANDLE = "src/repro_torch/api/handle.py"
FOO = "src/repro_torch/index/foo.py"
OBS = "src/repro_torch/obs/foo.py"
FRONTIER = "src/repro_torch/index/frontier.py"


def run_snippet(tmp_path, rules, source, rel=PLANE, baseline=None,
                name="snippet.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(source))
    return LintEngine(rules).run([(str(p), rel)], baseline or {})


def rule_names(report):
    return [f.rule for f in report.findings]


def names_are(*names):
    def check(rep):
        assert rule_names(rep) == list(names), [f.render() for f in
                                                rep.findings]
    return check


def clean(rep):
    assert rep.findings == [], [f.render() for f in rep.findings]


def message_has(*words):
    def check(rep):
        assert rep.findings, "expected a finding"
        text = " ".join(f.message for f in rep.findings)
        assert all(w in text for w in words), text
    return check


def all_of(*checks):
    def check(rep):
        for c in checks:
            c(rep)
    return check


# (scenario of tests/test_analysis.py, rule, port source, path, check)
SCENARIOS = [
    # -- delta-ledger --------------------------------------------------------
    ("raw_delta_arithmetic_flagged", DeltaLedgerRule, """
        def f(cfg, S):
            return cfg.delta / S
        """, FOO, all_of(names_are("delta-ledger"), message_has("ledger"))),
    ("literal_delta_at_ci_call_site_flagged", DeltaLedgerRule, """
        def f(n, mp):
            a = delta_prime(0.05, n, mp)
            b = shard_delta(delta=0.1, shards=4)
            return a + b
        """, FOO, all_of(names_are("delta-ledger", "delta-ledger"),
                         message_has("0.05"))),
    ("inlined_log_confidence_term_flagged", DeltaLedgerRule, """
        import math
        def f():
            return math.log(2.0 / 0.05)
        """, FOO, names_are("delta-ledger")),
    ("ledger_home_may_do_raw_arithmetic", DeltaLedgerRule, """
        def delta_prime(delta, n, mp):
            return delta / (n * mp)

        def shard_delta(cfg, S):
            return cfg.delta / S
        """, "src/repro_torch/core/confidence.py", clean),
    ("welford_local_delta_not_flagged", DeltaLedgerRule, """
        def welford(mean, b_mean, count):
            delta = b_mean - mean
            return mean + delta * count
        """, "src/repro_torch/kernels/ref.py", clean),
    # -- epoch-fence ---------------------------------------------------------
    ("unfenced_store_swap_flagged", EpochFenceRule, """
        class Index:
            def retune(self, new):
                self._store = new
        """, HANDLE, all_of(names_are("epoch-fence"),
                            message_has("'retune'"))),
    ("init_and_swap_are_fenced", EpochFenceRule, """
        class Index:
            def __init__(self, store):
                self._store = store
                self._epoch = 0

            def _swap(self, new):
                self._store = new
                self._epoch += 1
        """, HANDLE, clean),
    ("swap_without_epoch_bump_flagged", EpochFenceRule, """
        class Index:
            def _swap_quiet(self, new):
                self._store = new
        """, HANDLE, all_of(names_are("epoch-fence"),
                            message_has("never bumps _epoch"))),
    # -- host-sync -----------------------------------------------------------
    ("sync_in_hot_function_flagged", HostSyncRule, """
        class Plane:
            def _harvest(self, snap):
                return snap.done.cpu().numpy()
        """, PLANE, names_are("host-sync", "host-sync")),
    ("item_in_hot_function_flagged", HostSyncRule, """
        class Plane:
            def _harvest(self, snap):
                return snap.worst.item(), snap.ids.tolist()
        """, PLANE, names_are("host-sync", "host-sync")),
    ("annotation_and_helper_pass", HostSyncRule, """
        import numpy as np
        class Plane:
            def _harvest(self, snap, dev):
                a = snap.done.cpu()  # host-sync: numpy snapshot
                b = host_fetch(dev)
                c = float(np.sum(host_fetch(dev)))
                d = host_fetch(dev).tolist()
                return a, b, c, d
        """, PLANE, clean),
    ("annotation_on_line_above_statement", HostSyncRule, """
        import torch
        class Plane:
            def _harvest(self, snap):
                # host-sync: post-boundary value
                worst = float(torch.where(snap.ok, snap.ci,
                                          0.0).max())
                return worst
        """, PLANE, clean),
    ("cold_functions_unconstrained", HostSyncRule, """
        def build(x):
            return x.cpu().numpy().item()
        """, PLANE, clean),
    ("non_hot_file_unconstrained", HostSyncRule, """
        class Plane:
            def _harvest(self, snap):
                return snap.done.cpu().numpy()
        """, HANDLE, clean),
    ("synchronize_in_hot_function_flagged", HostSyncRule, """
        import torch
        def fused_race_topk(x):
            torch.cuda.synchronize()
            return x
        """, "src/repro_torch/index/batched_race.py",
     names_are("host-sync")),
    # -- pow2-width (the reference's recompile-hazard scenarios) -------------
    ("per_call_jit_flagged", Pow2WidthRule, """
        import torch
        def serve(rows):
            return torch.zeros((len(rows), 4))
        """, FRONTIER, names_are("pow2-width")),
    ("module_level_init_and_cached_factory_pass", Pow2WidthRule, """
        import functools
        import torch

        G = torch.zeros((next_pow2(len(ROWS)), 4))

        class Box:
            def __init__(self, rows):
                self.buf = torch.zeros((bucket_width(len(rows)), 4))

        @functools.lru_cache(maxsize=None)
        def make(w):
            return torch.empty((w, 4))
        """, FRONTIER, clean),
    ("unhashable_static_default_flagged", Pow2WidthRule, """
        import torch
        def pack(rows, width=None):
            return torch.full((len(rows),), -1, dtype=torch.int32)
        """, "src/repro_torch/serve/plane.py",
     all_of(names_are("pow2-width"), message_has("pow2"))),
    ("partial_jit_decorator_static_default_flagged", Pow2WidthRule, """
        import torch
        def survivors(ids):
            return torch.ones((1, len(ids)), dtype=torch.bool)
        """, "src/repro_torch/index/anytime.py", names_are("pow2-width")),
    ("len_shape_in_pow2_file_flagged", Pow2WidthRule, """
        import torch
        def pack(rows):
            return torch.zeros((len(rows), 4))
        """, FRONTIER, all_of(names_are("pow2-width"), message_has("pow2"))),
    ("pow2_laundered_len_passes", Pow2WidthRule, """
        import torch
        def pack(rows):
            return torch.zeros((next_pow2(len(rows)), 4))
        """, FRONTIER, clean),
    ("len_shape_outside_pow2_files_unconstrained", Pow2WidthRule, """
        import torch
        def pack(rows):
            return torch.zeros((len(rows), 4))
        """, "src/repro_torch/launch/train.py", clean),
    # -- metrics-conformance -------------------------------------------------
    ("name_and_suffix_rules", MetricsConformanceRule, """
        def wire(reg):
            reg.counter("plane_submitted_total", "no prefix")
            reg.counter("repro_plane_submitted", "counter, no _total")
            reg.gauge("repro_queue_total", "gauge with _total")
            reg.histogram("repro_Plane_ms", "uppercase")
        """, OBS, all_of(names_are(*["metrics-conformance"] * 4),
                         message_has("_total", "repro_"))),
    ("label_vocabulary", MetricsConformanceRule, """
        def wire(reg, lbl):
            reg.counter("repro_x_total", "ok", kind="a", plane="p0")
            reg.counter("repro_y_total", "bad", namepsace="oops")
            reg.histogram("repro_z_ms", "ok", buckets=(1, 2), **lbl)
        """, OBS, all_of(names_are("metrics-conformance"),
                         message_has("namepsace"))),
    ("dynamic_name_flagged", MetricsConformanceRule, """
        def wire(reg, which):
            reg.counter(f"repro_{which}_total", "dynamic")
        """, OBS, all_of(names_are("metrics-conformance"),
                         message_has("dynamic"))),
    ("non_registry_receivers_ignored", MetricsConformanceRule, """
        def f(db):
            db.counter("whatever")      # not a metrics registry
        """, OBS, clean),
]


@pytest.mark.parametrize("scenario,rule,source,rel,check", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_rule_scenario(tmp_path, scenario, rule, source, rel, check):
    check(run_snippet(tmp_path, [rule()], source, rel=rel))


def test_helper_call_clean_and_ledgered(tmp_path):
    rep = run_snippet(tmp_path, [DeltaLedgerRule()], """
        def f(cfg, n, mp):
            return delta_prime(cfg.delta, n, mp)
        """, rel=FOO)
    assert rep.findings == []
    assert rep.ledger == [{"helper": "delta_prime", "path": FOO,
                           "line": 3, "function": "f"}]


@pytest.mark.parametrize("how", ["inline", "standalone", "wildcard"])
def test_allow_comment_suppresses(tmp_path, how):
    """The reference's test_allow_comment_suppresses,
    test_standalone_allow_comment_suppresses_next_line and
    test_wildcard_allow."""
    body = {"inline": ["self._store = new  # repro-lint: allow[epoch-fence]"],
            "standalone": ["# repro-lint: allow[epoch-fence]",
                           "self._store = new"],
            "wildcard": ["self._store = new  # repro-lint: allow[*]"]}[how]
    source = "class Index:\n    def _load(self, new):\n" + "".join(
        f"        {line}\n" for line in body)
    rep = run_snippet(tmp_path, [EpochFenceRule()], source, rel=HANDLE)
    assert rep.findings == [] and rep.suppressed == 1


def test_cross_file_kind_conflict(tmp_path):
    a = tmp_path / "a.py"
    a.write_text("def f(reg):\n    reg.gauge('repro_thing')\n")
    b = tmp_path / "b.py"
    b.write_text("def g(reg):\n    reg.histogram('repro_thing')\n")
    rep = LintEngine([MetricsConformanceRule()]).run(
        [(str(a), "src/repro_torch/a.py"), (str(b), "src/repro_torch/b.py")],
        {})
    conflicts = [f for f in rep.findings if "conflicting" in f.message]
    assert len(conflicts) == 1
    assert "src/repro_torch/a.py" in conflicts[0].message
    assert "src/repro_torch/b.py" in conflicts[0].message


# -- hopper-budget (the reference's pallas-budget scenarios) -----------------

def ptxas(name: str, regs: int, smem: int = 0, spill: int = 0) -> str:
    return (f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\nptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} "
            f"bytes spill loads\nptxas info    : Used {regs} registers, "
            f"used 1 barriers, {smem} bytes smem, 400 bytes cmem[0]\n")


# a kernel source with launch bounds and the ways of sizing dynamic shared
# memory: none, a constant, a runtime value, a template's struct member and
# a struct's sizeof; and a block size from a runtime value
KERNEL_SRC = """
#include <cuda_runtime.h>
#include <cstdint>
namespace tile {
constexpr int kThreads = 256;
}
constexpr int kTile = 64;
constexpr int kSmem = kTile * kTile * (int)sizeof(float) + 1024;

template <int TILE> struct Tile {
  static constexpr int kFloats = TILE * TILE;
  static constexpr int kBytes = kFloats * (int)sizeof(float);
};

struct alignas(128) Ring {
  float a[2][kTile * kTile];
  uint64_t bar[2];
};

__global__ void __launch_bounds__(tile::kThreads)
plain_kernel(const float* x, float* y) { y[0] = x[0]; }

__global__ void __launch_bounds__(2 * tile::kThreads, 1)
tiled_kernel(const float* x, float* y) {
  extern __shared__ float smem[];
  y[0] = smem[0];
}

__global__ void __launch_bounds__(tile::kThreads)
ragged_kernel(const float* x, float* y, int d) {
  extern __shared__ float smem[];
  y[0] = smem[d];
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
planned_kernel(const float* x, float* y) { y[0] = x[0]; }

__global__ void
free_kernel(const float* x, float* y) { y[0] = x[0]; }

template <typename T, int TILE>
__global__ void __launch_bounds__(TILE <= 64 ? 256 : 128)
staged_kernel(const T* x, T* y) {
  extern __shared__ float smem[];
  y[0] = x[0] + smem[0];
}

__global__ void __launch_bounds__(tile::kThreads)
ring_kernel(const float* x, float* y) {
  extern __shared__ float smem[];
  y[0] = smem[0];
}

template <typename T, int TILE>
int launch_staged(const T* x, T* y, cudaStream_t s) {
  using P = Tile<TILE>;
  staged_kernel<T, TILE><<<1, 256, P::kBytes, s>>>(x, y);
  return 0;
}

int launch(const float* x, float* y, int d, cudaStream_t s) {
  plain_kernel<<<1, tile::kThreads, 0, s>>>(x, y);
  cudaFuncSetAttribute(tiled_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  tiled_kernel<<<1, 2 * tile::kThreads, kSmem, s>>>(x, y);
  const size_t smem = (size_t)d * sizeof(float);
  auto kernel = ragged_kernel;
  kernel<<<1, tile::kThreads, smem, s>>>(x, y, d);
  free_kernel<<<1, d, 0, s>>>(x, y);
  ring_kernel<<<1, tile::kThreads, sizeof(Ring), s>>>(x, y);
  return 0;
}
"""


def hopper_findings(tmp_path, log: str, launches=None, baseline=None):
    csrc = tmp_path / "src" / "repro_torch" / "csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    (csrc / "k.cu").write_text(KERNEL_SRC)
    rule = HopperBudgetRule({"k": log}, root=str(tmp_path),
                            launches=launches)
    report = LintEngine([rule]).run([], baseline or {})
    return report.findings if baseline is None else report


HOPPER_CASES = [
    # (case, ptxas text, expected fingerprints' budgets); the reference's
    # pallas-budget scenario each stands for in a comment
    # test_within_budget_passes
    ("within_budget", ptxas("_Z12plain_kernelPKfPf", 40)
     + ptxas("_Z12tiled_kernelPKfPf", 128, smem=1024), []),
    # test_over_budget_flagged, for each of the SM's three budgets
    ("over_registers", ptxas("_Z12plain_kernelPKfPf", 300),
     ["registers", "register file"]),
    ("over_register_file", ptxas("_Z12tiled_kernelPKfPf", 255),
     ["register file"]),
    ("over_shared_memory", ptxas("_Z12tiled_kernelPKfPf", 64,
                                 smem=232_448 - 17_408 + 1),
     ["shared memory"]),
    # test_lane_misalignment_flagged: the hardware's other waste, a spill
    ("spill", ptxas("_Z12plain_kernelPKfPf", 64, spill=120), ["spills"]),
    # test_unpriceable_symbolic_dim_flagged
    ("unpriceable_dynamic_shared_memory", ptxas("_Z13ragged_kernelPKfPfi",
                                                32),
     ["dynamic shared memory unpriced"]),
    # test_strided_ds_needs_divisibility_guard: a launch shape the source
    # does not pin down (a block size from a runtime value)
    ("unpriceable_threads", ptxas("_Z11free_kernelPKfPf", 32),
     ["threads unpriced"]),
    # sizes the source fixes through an instantiation's template arguments,
    # a struct template's members, an alias and a struct's sizeof
    ("template_threads_priced", ptxas("_Z14planned_kernelILi128EEvPKfPf", 32),
     []),
    ("template_threads_over_register_file",
     ptxas("_Z14planned_kernelILi1024EEvPKfPf", 128), ["register file"]),
    ("template_shared_memory_priced",
     ptxas("_Z13staged_kernelIfLi64EEvPKT_PS0_", 64), []),
    ("template_shared_memory_over",
     ptxas("_Z13staged_kernelIfLi256EEvPKT_PS0_", 64), ["shared memory"]),
    ("struct_sizeof_priced", ptxas("_Z11ring_kernelPKfPf", 64, smem=1024),
     []),
]


@pytest.mark.parametrize("case,log,budgets", HOPPER_CASES,
                         ids=[c[0] for c in HOPPER_CASES])
def test_hopper_budget(tmp_path, case, log, budgets):
    found = hopper_findings(tmp_path, log)
    assert [f.snippet.split(": ", 1)[1] for f in found] == budgets, \
        [f.render() for f in found]
    for f in found:
        assert f.rule == "hopper-budget"
        assert f.path == "src/repro_torch/csrc/k.cu"
        # the line of the kernel's __global__ declaration
        assert "__global__" in KERNEL_SRC.splitlines()[f.line - 1]


def launch(name: str, smem: int, regs: int = 32, threads: int = 256):
    """A launch record as ``parse_trace`` reads it from the card's trace."""
    return {"kernel": f"void (anonymous namespace)::{name}(float const*, "
                      f"float*, int)", "registers": regs,
            "threads": threads, "smem_bytes": smem}


RAGGED = ptxas("_Z13ragged_kernelPKfPfi", 32)
LAUNCH_CASES = [
    # the runtime size a launch on the path took prices the kernel
    ("priced_at_launch", [launch("ragged_kernel", 64 * 1024)], []),
    # over the block's shared memory at the path's shapes
    ("shared_memory_over_at_launch", [launch("ragged_kernel", 64 * 1024),
                                      launch("ragged_kernel", 240_000)],
     ["shared memory"]),
    ("register_file_over_at_launch",
     [launch("ragged_kernel", 4096, regs=128, threads=1024)],
     ["register file"]),
    # a launch prices only the instantiation it ran, not another kernel
    ("another_kernel_launched_still_unpriced",
     [launch("planned_kernel<64>", 0)], ["dynamic shared memory unpriced"]),
]


@pytest.mark.parametrize("case,launches,budgets", LAUNCH_CASES,
                         ids=[c[0] for c in LAUNCH_CASES])
def test_hopper_budget_at_launch(tmp_path, case, launches, budgets):
    found = hopper_findings(tmp_path, RAGGED, launches)
    assert [f.snippet.split(": ", 1)[1] for f in found] == budgets, \
        [f.render() for f in found]
    for f in found:
        assert f.path == "src/repro_torch/csrc/k.cu"
        assert "__global__" in KERNEL_SRC.splitlines()[f.line - 1]
        if f.snippet.endswith("shared memory"):
            assert "240000 bytes" in f.message


def test_hopper_over_budget_is_new_where_baselined_unpriced(tmp_path):
    """A kernel the baseline holds as unpriced still fails when a launch
    on the path takes more than a block's shared memory: the finding's
    fingerprint names the budget, its message the bytes."""
    unpriced = hopper_findings(tmp_path, RAGGED)
    baseline = baseline_from(unpriced)
    rep = hopper_findings(tmp_path, RAGGED, [launch("ragged_kernel",
                                                    300_000)], baseline)
    assert [(f.snippet, st) for f, st in zip(rep.findings,
                                             rep.statuses())] == [
        ("ragged_kernel: shared memory", "new")]
    assert not rep.ok and "300000 bytes" in rep.findings[0].message


def test_hopper_launch_records_match_instantiations():
    """A trace's kernel launches as the card records them, their demangled
    names matched to the mangled ptxas records' template arguments."""
    trace = {"traceEvents": [
        {"cat": "kernel", "name": "void (anonymous namespace)::"
         "fwht_kernel_wide<float, 12>(float const*, float*, float)",
         "args": {"registers per thread": 96, "shared memory": 16384,
                  "block": [64, 1, 1]}},
        {"cat": "cpu_op", "name": "aten::add", "args": {}},
        {"cat": "kernel", "name": "sm80_xmma_gemm", "args": {}}]}
    assert parse_trace(trace) == [{
        "kernel": trace["traceEvents"][0]["name"], "registers": 96,
        "threads": 64, "smem_bytes": 16384}]
    mangled = ("_ZN39_GLOBAL__N__6e6e5c6d_7_fwht_cu_d6834afb16fwht_kernel_"
               "wideIfLi12EEEvPKT_PS1_f")
    assert kernel_name(mangled) == "fwht_kernel_wide"
    assert template_args(mangled) == ("float", "12")
    assert launch_key(trace["traceEvents"][0]["name"]) == (
        "fwht_kernel_wide", ("float", "12"))
    rows = ("_ZN46_GLOBAL__N__0e6fe2e4_13_block_pull_cu_f723fd4022block_pull"
            "_rows_kernelI13__nv_bfloat16Li128ELb1ElEEvPKT_S4_PKiPKT2_Pflllll")
    assert template_args(rows) == ("__nv_bfloat16", "128", "true", "long")
    assert launch_key("void (anonymous namespace)::block_pull_rows_kernel<"
                      "__nv_bfloat16, 128, true, long>(__nv_bfloat16 const*)"
                      ) == ("block_pull_rows_kernel",
                            ("__nv_bfloat16", "128", "true", "long"))
    assert template_args("_Z12plain_kernelPKfPf") == ()
    assert launch_key("l2_read_kernel(uint4 const*)") == ("l2_read_kernel", ())


def test_hopper_parse_names_and_logs(tmp_path):
    """ptxas records parsed as ``chip_smoke.py`` reads them; mangled names
    to the kernel's own; a build directory's logs by stem, the newest."""
    rec = parse_ptxas(ptxas("_Z16fwht_kernel_wideIfLi10EEvPKT_PS0_f", 40,
                            smem=16, spill=8))
    assert rec == {"_Z16fwht_kernel_wideIfLi10EEvPKT_PS0_f": {
        "registers": 40, "smem_static_bytes": 16, "stack_bytes": 0,
        "spill_store_bytes": 8, "spill_load_bytes": 8}}
    assert kernel_name("_Z16fwht_kernel_wideIfLi10EEvPKT_PS0_f") == \
        "fwht_kernel_wide"
    assert kernel_name("_ZN4pull9copy_rowsEPKfPf") == "copy_rows"
    assert kernel_name("l2_read_kernel") == "l2_read_kernel"
    (tmp_path / "fwht-0123456789abcdef.log").write_text("old")
    os.utime(tmp_path / "fwht-0123456789abcdef.log", (1, 1))
    (tmp_path / "fwht-fedcba9876543210.log").write_text("new")
    (tmp_path / "block_pull.log").write_text("bp")
    assert read_logs(str(tmp_path)) == {"fwht": "new", "block_pull": "bp"}


def test_real_kernels_are_found_and_priced():
    """Every ``__global__`` kernel of ``csrc/*.cu`` is found by the rule's
    source reader, and the kernels whose sizes are plain constants price:
    the pair pull's 256 threads, the tensor-core kernels' launch bounds."""
    from repro_torch.analysis.rules_hopper import _Source
    import re
    csrc = os.path.join(REPO, "src", "repro_torch", "csrc")
    for fname in sorted(os.listdir(csrc)):
        if not fname.endswith(".cu"):
            continue
        src = _Source(REPO, fname[:-3])
        for name in re.findall(r"__global__[^(]*(?:\([^)]*\)[^(]*)?\s(\w+)\s*"
                               r"\(", src.text):
            line, bounds, _ = src.declaration(name)
            assert line > 1 and "__global__" in src.lines[line - 1], name
    bp = _Source(REPO, "block_pull")
    assert bp.value(bp.declaration("block_pull_kernel")[1]) == 256
    fa = _Source(REPO, "flash_attn_sm90")
    assert fa.value(fa.declaration("flash_attn_sm90_kernel")[1]) == 384


@pytest.mark.parametrize("stem,kernel,env,threads,dynamic", [
    # Smem<DMAX>::BYTES: 96 KB at head width 128, 192 KB at 256
    ("flash_attn", "flash_attn_kernel",
     {"T": "float", "CAUSAL": 0, "DMAX": 128}, 256, 98_304),
    ("flash_attn", "flash_attn_kernel",
     {"T": "__nv_bfloat16", "CAUSAL": 1, "DMAX": 256}, 256, 196_608),
    # sizeof(Smem) + 1024 of the tensor-core kernels' structs
    ("flash_attn_sm90", "flash_attn_sm90_kernel", {"CAUSAL": 0}, 384,
     165_888),
    ("pairwise_dist_sm90", "pairwise_l2_tc_kernel", {}, 288, 198_656),
    # Plan<T, LOG_D>'s threads and row: d = 32,768 in fp32 and bf16
    ("fwht", "fwht_kernel_wide", {"T": "float", "LOG_D": 15}, 512, 131_072),
    ("fwht", "fwht_kernel_wide", {"T": "__nv_bfloat16", "LOG_D": 15}, 256,
     131_072),
    ("fwht", "fwht_kernel_narrow", {"T": "float", "LOG_D": 4}, 128, 0),
    # a row of the runtime width d_pad: priced only by a launch
    ("block_pull", "block_pull_rows_kernel",
     {"T": "float", "BLOCK": 128, "L1": 0, "IB": "int"}, 256, None),
    ("fused_epoch_pull", "fused_epoch_pull_pair_kernel",
     {"BLOCK": 128, "L1": 0, "STAGE_Q": 1}, 512, None),
])
def test_real_kernels_price_from_templates_and_structs(stem, kernel, env,
                                                       threads, dynamic):
    """The real kernels' thread counts and dynamic shared memory as the
    rule evaluates them from their sources at an instantiation's template
    arguments; the sizes set from a runtime value stay unpriced."""
    from repro_torch.analysis.rules_hopper import _Source
    src = _Source(REPO, stem)
    _, bounds, has_dynamic = src.declaration(kernel)
    assert src.value(bounds, env) == threads
    sizes = {src.value(cfg[2], env, local) for cfg, local in
             src.launches(kernel)} if has_dynamic else {0}
    assert sizes == {dynamic}


# -- engine: suppression + ratchet semantics ---------------------------------

def test_ratchet_new_vs_baselined_vs_stale(tmp_path):
    src = """
        class Index:
            def a(self, new):
                self._store = new
            def b(self, new):
                self._store = new
        """
    rep0 = run_snippet(tmp_path, [EpochFenceRule()], src, rel=HANDLE)
    assert len(rep0.new) == 2 and rep0.ok is False
    base = baseline_from(rep0.findings)
    base[f"epoch-fence|{HANDLE}|gone"] = 1  # stale entry
    rep1 = run_snippet(tmp_path, [EpochFenceRule()], src, rel=HANDLE,
                       baseline=base)
    assert rep1.ok and rep1.new == [] and len(rep1.baselined) == 2
    assert rep1.stale == [f"epoch-fence|{HANDLE}|gone"]
    rep2 = run_snippet(tmp_path, [EpochFenceRule()], src + """
            def c(self, new):
                self._store = new
        """, rel=HANDLE, baseline=base)
    assert len(rep2.new) == 1 and rep2.ok is False


def test_fingerprints_survive_line_shifts(tmp_path):
    src = """
        class Index:
            def a(self, new):
                self._store = new
        """
    rep0 = run_snippet(tmp_path, [EpochFenceRule()], src, rel=HANDLE)
    base = baseline_from(rep0.findings)
    p = tmp_path / "shifted.py"
    p.write_text("\n\n\n# pushed down\n" + textwrap.dedent(src))
    rep1 = LintEngine([EpochFenceRule()]).run([(str(p), HANDLE)], base)
    assert rep1.ok and len(rep1.baselined) == 1


def test_unparseable_file_is_an_error_not_a_crash(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def f(:\n")
    rep = LintEngine(default_rules()).run(
        [(str(p), "src/repro_torch/broken.py")], {})
    assert rep.errors and not rep.ok


def test_duplicate_rule_names_rejected():
    with pytest.raises(ValueError, match="duplicate"):
        LintEngine([EpochFenceRule(), EpochFenceRule()])


def test_baseline_round_trip_and_version_gate(tmp_path):
    path = str(tmp_path / "base.json")
    save_baseline(path, {"b|p|s": 2, "a|p|s": 1})
    assert load_baseline(path) == {"a|p|s": 1, "b|p|s": 2}
    doc = json.load(open(path))
    doc["version"] = 99
    json.dump(doc, open(path, "w"))
    with pytest.raises(ValueError, match="version"):
        load_baseline(path)


def test_apply_baseline_counts():
    f = lambda: Finding("r", "p", 1, 0, "m", "snip")  # noqa: E731
    new, old, stale = apply_baseline([f(), f(), f()], {"r|p|snip": 2})
    assert (len(new), len(old), stale) == (1, 2, [])


def test_engine_is_the_reference_engine():
    """The port keeps its own copy of the engine (it imports nothing of
    the reference); the copy is the reference's below its docstring."""
    def body(path):
        text = open(path).read()
        return text[text.index('"""', 3) + 3:]
    assert body(os.path.join(REPO, "src", "repro_torch", "analysis",
                             "engine.py")) == body(
        os.path.join(REPO, "src", "repro", "analysis", "engine.py"))


# -- CLI ---------------------------------------------------------------------

def run_cli(*args):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_lint.py"),
         *args], capture_output=True, text=True, cwd=REPO)


def test_port_is_clean_against_its_baseline():
    r = run_cli()
    assert r.returncode == 0, r.stdout + r.stderr
    assert " 0 new," in r.stdout


def test_json_report_schema(tmp_path):
    out = str(tmp_path / "report.json")
    r = run_cli("--json", out)
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.load(open(out))
    assert doc["version"] == 1
    assert set(doc["counts"]) == {"total", "new", "baselined",
                                  "suppressed", "stale"}
    assert doc["ok"] is True and doc["counts"]["new"] == 0
    for f in doc["findings"]:
        assert set(f) == {"rule", "path", "line", "col", "message",
                          "snippet", "status"}
        assert f["status"] in ("new", "baselined")
    assert isinstance(doc["ledger"], list) and doc["ledger"]
    assert doc["errors"] == []


BAD = "class I:\n    def f(self, new):\n        self._store = new\n"


@pytest.mark.parametrize("case", ["new_finding_exits_1",
                                  "baseline_update_then_clean",
                                  "syntax_error_exits_2",
                                  "bad_ptxas_dir_exits_2",
                                  "ptxas_log_new_finding_exits_1",
                                  "bad_launches_file_exits_2",
                                  "launch_over_budget_exits_1"])
def test_cli_exit_codes(tmp_path, case):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD)
    if case == "new_finding_exits_1":
        r = run_cli("--no-baseline", str(bad))
        assert r.returncode == 1 and "epoch-fence" in r.stdout
    elif case == "baseline_update_then_clean":
        base = str(tmp_path / "base.json")
        r = run_cli("--baseline", base, "--baseline-update", str(bad))
        assert r.returncode == 0, r.stdout + r.stderr
        r = run_cli("--baseline", base, str(bad))
        assert r.returncode == 0 and "[baselined]" in r.stdout
    elif case == "syntax_error_exits_2":
        bad.write_text("def f(:\n")
        r = run_cli("--no-baseline", str(bad))
        assert r.returncode == 2 and "error" in r.stderr.lower()
    elif case == "bad_ptxas_dir_exits_2":
        r = run_cli("--ptxas-log", str(tmp_path / "missing"))
        assert r.returncode == 2 and "not a directory" in r.stderr
    elif case == "bad_launches_file_exits_2":
        (tmp_path / "launches.json").write_text("{not json")
        r = run_cli("--ptxas-log", str(tmp_path), "--launches",
                    str(tmp_path / "launches.json"))
        assert r.returncode == 2 and "--launches" in r.stderr
    elif case == "launch_over_budget_exits_1":
        logs = tmp_path / "logs"
        logs.mkdir()
        (logs / "fused_epoch_pull.log").write_text(ptxas(
            "_ZN12_GLOBAL__N_128fused_epoch_pull_rows_kernelILi128ELb0EEEvPKfS2"
            "_PKiS4_Pflllll", 64, smem=128))
        (tmp_path / "launches.json").write_text(json.dumps([{
            "kernel": "void (anonymous namespace)::fused_epoch_pull_rows_"
                      "kernel<128, false>(float const*)", "registers": 64,
            "threads": 256, "smem_bytes": 233_000}]))
        r = run_cli("--ptxas-log", str(logs), "--launches",
                    str(tmp_path / "launches.json"))
        assert r.returncode == 1, r.stdout + r.stderr
        assert "[new]" in r.stdout and "233000 bytes" in r.stdout
    else:
        logs = tmp_path / "logs"
        logs.mkdir()
        (logs / "pairwise_dist-0123456789abcdef.log").write_text(
            ptxas("_Z14pairwise_tiledILb0EEvPKfS1_Pfllll", 300, spill=64))
        r = run_cli("--ptxas-log", str(logs))
        assert r.returncode == 1, r.stdout + r.stderr
        assert "hopper-budget" in r.stdout and "spill" in r.stdout


# -- the δ-split ledger over the port's tree ---------------------------------

def test_ledger_enumerates_every_split_site():
    """The δ-split table over the REAL port tree: one entry per sanctioned
    accounting-helper call site, the reference's sites at their port
    homes (the sharded fused race plans its δ′ in ``fused_plan``), and no
    raw δ arithmetic outside the ledger home."""
    src = os.path.join(REPO, "src", "repro_torch")
    files = []
    for dirpath, dirnames, filenames in os.walk(src):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                p = os.path.join(dirpath, fn)
                files.append((p, os.path.relpath(p, REPO)))
    rep = LintEngine([DeltaLedgerRule()]).run(files, {})
    sites = {(row["helper"], row["path"], row["function"])
             for row in rep.ledger}
    assert sites == {
        ("delta_prime", "src/repro_torch/core/ucb.py", "make_rounds_race"),
        ("delta_prime", "src/repro_torch/index/anytime.py", "__init__"),
        ("delta_prime", "src/repro_torch/index/batched_race.py",
         "fused_race_topk"),
        ("delta_prime", "src/repro_torch/index/sharded.py", "fused_plan"),
        ("shard_delta", "src/repro_torch/index/sharded.py", "_shard_delta"),
        ("shard_delta", "src/repro_torch/core/distributed.py",
         "distributed_knn"),
    }
    assert rep.findings == []
