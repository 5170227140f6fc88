"""The port's dry run and roofline (``repro_torch.launch.dryrun``,
``repro_torch.roofline``) held to the reference's.

The reference side runs once, in one subprocess with 8 forced host
devices (its ``launch/dryrun.py`` sets ``XLA_FLAGS`` at import, so it is
never imported here): ``SHAPES`` and the skips, every arch × shape's
``input_specs``, ``_active_params`` and ``model_flops_estimate``,
``roofline/hlo.py``'s counts of a matmul, an elementwise op, a reduction,
an all-gather and an all-reduce, and the qwen2.5-14b SMOKE cell of
``train_4k`` on a 4 × 2 mesh (``make_production_mesh`` patched, as
``tests/test_distributed.py`` does). The port's side runs here, on
PyTorch's ``fake`` process group, on ``meta``: nothing is allocated.

The SMOKE cell's counted terms are held to the reference's within
measured bands, not equal: the port counts its eager ops where the
reference counts XLA's HLO, and DTensor chooses its collectives where
GSPMD chooses the reference's (Queue 3 item 13 in ROADMAP.md). Measured
on torch 2.13 and jax 0.9 on the CPU:

* On 8 × 1 (no model axis) the two count the same work: the port's flops
  are 0.986 of the reference's, and its bytes 1.32 times, unfused and so
  at least the reference's.
* On 4 × 2 the reference's eight per-device programs count 1.94 times the
  flops of its own 8 × 1 cell: most of its work runs on both model ranks,
  where DTensor splits the heads over them. So there the port's flops are
  0.509 of the reference's and its bytes 0.676.
* On 4 × 2 the port's all-gathers move 0.497 of the reference's bytes and
  its all-reduces 1.99 times (DTensor reduces a tensor that is partial
  over both axes with one all-reduce an axis); the port reduce-scatters
  1.61e9 bytes where the reference issues no reduce-scatter and 5.67e8
  bytes of collective-permutes. All its collectives move 0.664 of the
  reference's bytes.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.configs.registry import SKIPS, shape_skip_reason
from repro_torch.launch import dryrun as D
from repro_torch.models import build_model
from repro_torch.roofline import (HW, CountMode, RooflineTerms,
                                  analyze_counts, model_flops_estimate)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: port / reference of the SMOKE cell's terms on 4 × 2, each held within a
#: band about its measured value (module docstring)
SMOKE_FLOPS_RATIO = (0.45, 0.57)      # measured 0.509
SMOKE_BYTES_RATIO = (0.60, 0.75)      # 0.676
SMOKE_COLL_RATIO = {"all-gather": (0.45, 0.55),    # 0.497
                    "all-reduce": (1.80, 2.20),    # 1.99
                    "total": (0.60, 0.73)}         # 0.664
#: the kinds each side issues in that cell
SMOKE_PORT_KINDS = {"all-gather", "all-reduce", "reduce-scatter"}
SMOKE_REF_KINDS = {"all-gather", "all-reduce", "collective-permute"}
#: the same on 8 × 1, where both count the same work
DATA_FLOPS_RATIO = (0.97, 1.00)       # 0.986
DATA_BYTES_RATIO = (1.00, 1.45)       # 1.32: unfused, so at least XLA's

REFERENCE = textwrap.dedent("""
    import repro
    import json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.configs import SHAPES, get_arch, list_archs
    from repro.configs.registry import SKIPS
    from repro.models import build_model
    import repro.launch.dryrun as D
    import repro.launch.mesh as M
    from repro.roofline.analysis import model_flops_estimate
    from repro.roofline.hlo import analyze_hlo
    out = {"shapes": {k: [v.name, v.seq_len, v.global_batch, v.kind]
                      for k, v in SHAPES.items()}, "skips": SKIPS,
           "specs": {}, "active": {}, "model_flops": {}}
    for a in list_archs():
        e = get_arch(a)
        model = build_model(e.config)
        out["specs"][a] = {s: {k: [list(v.shape), str(v.dtype)] for k, v in
                               model.input_specs(SHAPES[s]).items()}
                           for s in SHAPES}
        out["active"][a] = D._active_params(model, e.plan)
        out["model_flops"][a] = {s: model_flops_estimate(
            e.config, SHAPES[s], out["active"][a]) for s in SHAPES}

    def cost(f, *args):
        c = analyze_hlo(jax.jit(f).lower(*args).compile().as_text())
        return {"flops": c.flops, "bytes": c.bytes_accessed,
                "coll": c.coll_bytes_by_kind}

    S = jax.ShapeDtypeStruct
    a, b = S((64, 128), jnp.float32), S((128, 32), jnp.float32)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    gather = jax.shard_map(
        lambda x: jax.lax.all_gather(x, "model", axis=1, tiled=True),
        mesh=mesh, in_specs=P("data", "model"), out_specs=P("data", None),
        check_vma=False)
    reduce = jax.shard_map(lambda x: jax.lax.psum(x, "model"), mesh=mesh,
                           in_specs=P("data", None),
                           out_specs=P("data", None), check_vma=False)
    out["ops"] = {"matmul": cost(lambda x, y: x @ y, a, b),
                  "add": cost(lambda x, y: x + y, a, a),
                  "sum": cost(lambda x: jnp.sum(x, axis=1), a),
                  "all_gather": cost(gather, S((16, 32), jnp.float32)),
                  "all_reduce": cost(reduce, S((16, 16), jnp.float32))}

    kinds = {}
    analyze_compiled = D.analyze_compiled

    def by_kind(compiled, **kw):
        kinds.update({k: v * kw["chips"] for k, v in analyze_hlo(
            compiled.as_text()).coll_bytes_by_kind.items()})
        return analyze_compiled(compiled, **kw)
    D.analyze_compiled = by_kind
    import repro.configs.qwen2_5_14b as Q
    Q.CONFIG = get_arch("qwen2.5-14b").smoke
    for key, shape in (("smoke", (4, 2)), ("smoke_8x1", (8, 1))):
        def small(multi_pod=False, shape=shape):
            return jax.make_mesh(shape, ("data", "model"),
                                 axis_types=(jax.sharding.AxisType.Auto,) * 2)
        M.make_production_mesh = small
        D.make_production_mesh = small
        kinds.clear()
        out[key] = D.run_cell("qwen2.5-14b", "train_4k", "single",
                              overrides={"plan.grad_accum": 2})
        out[key]["coll_bytes_by_kind"] = dict(kinds)
    print("JSON" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", REFERENCE],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0 and "JSON" in out.stdout, out.stderr[-3000:]
    return json.loads(out.stdout[out.stdout.index("JSON") + 4:])


def small_mesh(multi_pod=False, shape=(4, 2)):
    """A 4 × 2 (or 2 × 2 × 2) mesh over ranks 0–7 of the open fake group,
    standing in for the production mesh."""
    from torch.distributed.device_mesh import DeviceMesh
    if multi_pod:
        return DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                          mesh_dim_names=("pod", "data", "model"))
    return DeviceMesh("cpu", torch.arange(8).reshape(*shape),
                      mesh_dim_names=("data", "model"))


def within(got: float, want: float, band) -> bool:
    return band[0] <= got / want <= band[1]


def group_closed() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized()


# -- shapes, specs, active parameters, model flops ---------------------------

def test_shapes_and_skips_match_reference(ref):
    assert {k: [v.name, v.seq_len, v.global_batch, v.kind]
            for k, v in SHAPES.items()} == ref["shapes"]
    assert SKIPS == ref["skips"]
    for a in list_archs():
        for s in SHAPES:
            assert shape_skip_reason(a, s) == ref["skips"].get(s, {}).get(a)


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_reference(ref, arch):
    model = build_model(get_arch(arch).config, device="meta")
    for s in SHAPES:
        specs = model.input_specs(SHAPES[s])
        assert all(v.device.type == "meta" for v in specs.values())
        got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
               for k, v in specs.items()}
        assert got == ref["specs"][arch][s], (arch, s)
    assert D.input_specs(arch, "train_4k").keys() == \
        ref["specs"][arch]["train_4k"].keys()


@pytest.mark.parametrize("arch", list_archs())
def test_active_params_and_model_flops_match_reference(ref, arch):
    entry = get_arch(arch)
    model = build_model(entry.config, device="meta")
    n = D._active_params(model, entry.plan)
    assert n == ref["active"][arch]
    for s in SHAPES:
        assert model_flops_estimate(entry.config, SHAPES[s], n) == \
            ref["model_flops"][arch][s], (arch, s)


def test_roofline_terms_keys_and_formulas(monkeypatch):
    """The reference's ``RooflineTerms`` with the port's rates gives the
    port's dict, key for key and value for value; the rates are the
    H100's."""
    import repro.roofline.analysis as ref_analysis
    from repro_torch import hardware
    assert (HW.peak_flops, HW.hbm_bw, HW.ici_bw, HW.ici_links) == (
        989e12, 3.35e12, 50e9, 1)
    assert hardware.NVLINK_BYTES_PER_S == 450e9
    monkeypatch.setattr(ref_analysis, "HW", ref_analysis.Hardware(
        peak_flops=HW.peak_flops, hbm_bw=HW.hbm_bw, ici_bw=HW.ici_bw,
        ici_links=HW.ici_links))
    for flops, nbytes, coll in ((3e15, 1e13, 2e11), (1e12, 5e14, 1e9),
                                (1e12, 1e12, 9e13)):
        kw = dict(arch="a", shape="s", mesh="m", chips=256, hlo_flops=flops,
                  hlo_bytes=nbytes, coll_bytes=coll, coll_ops=7,
                  model_flops=2e15, peak_memory_per_chip=1e9)
        assert RooflineTerms(**kw).to_dict() == \
            ref_analysis.RooflineTerms(**kw).to_dict()


# -- the counting mode against hlo.py, op by op ------------------------------

def counted(fn, *args) -> "CountMode":
    with CountMode() as mode:
        fn(*args)
    return mode.counts


@pytest.mark.parametrize("op", ["matmul", "add", "sum"])
def test_count_mode_matches_hlo_cost(ref, op):
    a = torch.empty(64, 128, device="meta")
    b = torch.empty(128, 32, device="meta")
    c = {"matmul": lambda: counted(torch.matmul, a, b),
         "add": lambda: counted(torch.add, a, a),
         "sum": lambda: counted(lambda x: x.sum(dim=1), a)}[op]()
    want = ref["ops"][op]
    if op == "sum":
        # XLA's reduce adds its init value to the operands; within 4%
        assert c.flops == 64 * 128 // 2
        assert abs(c.flops - want["flops"]) <= 0.04 * want["flops"]
    else:
        assert c.flops == want["flops"]
        assert c.bytes_accessed == want["bytes"]


@pytest.mark.parametrize("op", ["all_gather", "all_reduce"])
def test_count_mode_collectives_match_hlo_cost(ref, op):
    """An all-gather and an all-reduce issued by DTensor on a fake 2 × 2
    mesh count the bytes ``hlo.py`` counts for the reference's
    ``shard_map`` collective of the same local shapes (an all-reduce
    twice)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    with D.fake_world(4):
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        if op == "all_gather":
            x = distribute_tensor(torch.empty(16, 32, device="meta"), mesh,
                                  [Shard(0), Shard(1)], src_data_rank=None)
            c = counted(lambda: x.redistribute(mesh, [Shard(0),
                                                      Replicate()]))
            kind = "all-gather"
        else:
            x = DTensor.from_local(torch.empty(8, 16, device="meta"), mesh,
                                   [Shard(0), Partial()], run_check=False)
            c = counted(lambda: x.redistribute(mesh, [Shard(0),
                                                      Replicate()]))
            kind = "all-reduce"
    assert group_closed()
    want = ref["ops"][op]["coll"]
    assert c.coll_bytes_by_kind[kind] == want[kind] > 0
    assert c.coll_bytes == sum(want.values())


def test_count_mode_scales_and_tracks_live_bytes():
    a = torch.empty(256, 256, device="meta")
    with CountMode() as mode:
        with mode.scaled(4):
            y = a @ a
        z = y + 1
        del y, z
    c = mode.counts
    assert c.flops == 4 * 2 * 256 ** 3 + 256 * 256
    # y and z alive together, then freed
    assert c.peak_live_bytes == 2 * 256 * 256 * 4
    assert mode._live == 0
    assert c.by_op["mm"][0] == 1 and c.by_op["add"][0] == 1


def test_analyze_counts_is_one_rank_times_chips():
    from repro_torch.roofline.count import Counts
    c = Counts(flops=2.0, bytes_accessed=3.0, coll_ops=5,
               peak_live_bytes=7.0)
    c.coll_bytes_by_kind["all-reduce"] = 4.0
    t = analyze_counts(c, arch="a", shape="s", mesh_name="single", chips=8,
                       model_flops=1.0, arg_bytes=10.0)
    assert (t.hlo_flops, t.hlo_bytes, t.coll_bytes, t.coll_ops,
            t.peak_memory_per_chip) == (16.0, 24.0, 32.0, 5, 17.0)


# -- meshes and cells ----------------------------------------------------------

def test_production_meshes_over_the_fake_group():
    from repro_torch.launch.mesh import make_production_mesh
    for kind, shape, names in (("single", (16, 16), ("data", "model")),
                               ("multi", (2, 16, 16),
                                ("pod", "data", "model"))):
        with D.fake_world(D.WORLD[kind]):
            mesh = make_production_mesh(multi_pod=kind == "multi")
            assert tuple(mesh.mesh.shape) == shape
            assert mesh.mesh_dim_names == names
        assert group_closed()


def test_smoke_cell_matches_reference(ref, monkeypatch):
    """qwen2.5-14b's SMOKE config × ``train_4k`` on a 4 × 2 mesh at grad
    accumulation 2: ``ok`` in both, the reference's record keys, the same
    model flops and active parameters, and the counted flops, bytes and
    collectives by kind within their measured bands (module docstring)."""
    import repro_torch.configs.qwen2_5_14b as Q
    monkeypatch.setattr(D, "make_production_mesh", small_mesh)
    monkeypatch.setattr(Q, "CONFIG", Q.SMOKE)
    rec = D.run_cell("qwen2.5-14b", "train_4k", "single",
                     overrides={"plan.grad_accum": 2})
    want = ref["smoke"]
    assert rec["status"] == want["status"] == "ok"
    assert set(want) <= set(rec)
    assert rec["chips"] == want["chips"] == 8
    assert rec["model_flops"] == want["model_flops"]
    assert rec["n_params_active"] == want["n_params_active"]
    assert rec["grad_accum"] == 2
    ratio = rec["hlo_flops"] / want["hlo_flops"]
    assert SMOKE_FLOPS_RATIO[0] <= ratio <= SMOKE_FLOPS_RATIO[1], ratio
    assert within(rec["hlo_bytes"], want["hlo_bytes"], SMOKE_BYTES_RATIO), \
        (rec["hlo_bytes"], want["hlo_bytes"])
    got, ref_kinds = rec["coll_bytes_by_kind"], want["coll_bytes_by_kind"]
    assert sum(ref_kinds.values()) == want["coll_bytes"]
    assert {k for k, v in got.items() if v} == SMOKE_PORT_KINDS, got
    assert {k for k, v in ref_kinds.items() if v} == SMOKE_REF_KINDS
    for kind in ("all-gather", "all-reduce"):
        assert within(got[kind], ref_kinds[kind], SMOKE_COLL_RATIO[kind]), \
            (kind, got[kind], ref_kinds[kind])
    assert within(rec["coll_bytes"], want["coll_bytes"],
                  SMOKE_COLL_RATIO["total"]), (got, ref_kinds)
    assert rec["coll_ops"] > 0
    assert rec["fits_hbm"] and rec["peak_memory_per_chip"] > 0
    assert group_closed()


def test_smoke_cell_without_a_model_axis_counts_the_reference_work(
        ref, monkeypatch):
    """The same cell on 8 × 1, where both sides split the work alike: the
    flops within 3% under the reference's, and the bytes at least the
    reference's (the port's count is unfused) and at most 1.45 times."""
    import repro_torch.configs.qwen2_5_14b as Q
    monkeypatch.setattr(D, "make_production_mesh",
                        lambda multi_pod=False: small_mesh(shape=(8, 1)))
    monkeypatch.setattr(Q, "CONFIG", Q.SMOKE)
    rec = D.run_cell("qwen2.5-14b", "train_4k", "single",
                     overrides={"plan.grad_accum": 2})
    want = ref["smoke_8x1"]
    assert rec["status"] == want["status"] == "ok"
    assert rec["model_flops"] == want["model_flops"]
    assert within(rec["hlo_flops"], want["hlo_flops"], DATA_FLOPS_RATIO), \
        (rec["hlo_flops"], want["hlo_flops"])
    assert within(rec["hlo_bytes"], want["hlo_bytes"], DATA_BYTES_RATIO), \
        (rec["hlo_bytes"], want["hlo_bytes"])
    assert group_closed()


BMO_KEYS = {"arch", "shape", "mesh", "chips", "hlo_flops", "hlo_bytes",
            "coll_bytes", "coll_ops", "model_flops", "peak_memory_per_chip",
            "t_compute", "t_memory", "t_collective", "bottleneck",
            "useful_flops_ratio", "roofline_fraction", "variant", "status",
            "lower_s", "compile_s", "overrides", "fits_hbm"}


def test_bmo_cell_is_priced_from_its_launches():
    """A ``bmo-nn`` cell: the reference's record keys, its model flops
    (3·Q·n·init·block), the launches priced by the tuner's arithmetic, one
    all-reduce a round over ``model`` and the merge's collectives."""
    from repro_torch.tune.seed import launch_work
    rec = D.run_bmo_cell("knn_100k_12k", "single")
    assert rec["status"] == "ok" and BMO_KEYS <= set(rec)
    n, d, Q = D.KNN_SHAPES["knn_100k_12k"]
    assert rec["model_flops"] == 3.0 * Q * n * 2 * 128
    n_loc, d_m = n // 16, d // 16
    flops = sum(launch_work(Q, *w)[0] for w in
                [(n_loc, 2, 128)] + [(32, 2, 128)] * 64 + [(5, 1, d_m)])
    assert rec["hlo_flops"] == flops * 256
    assert rec["coll_ops"] == 64 + 1 + 2
    assert rec["coll_bytes_by_kind"]["all-reduce"] == 256 * 2 * 4 * (
        64 * Q * 32 * 2 + Q * 5)
    assert group_closed()


def test_cli_writes_records_and_fails_a_broken_cell(tmp_path):
    out = str(tmp_path / "cells.jsonl")
    D.main(["--arch", "bmo-nn", "--shape", "knn_100k_12k", "--mesh",
            "multi", "--out", out])
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "no-such-arch", "--shape", "train_4k",
                "--out", out])
    assert e.value.code == 1
    recs = [json.loads(line) for line in open(out)]
    assert recs[0]["status"] == "ok" and recs[0]["chips"] == 512
    assert BMO_KEYS <= set(recs[0])
    assert recs[1]["status"] == "error" and "KeyError" in recs[1]["error"]
    assert group_closed()


def test_a_failing_cell_leaves_no_group_open(monkeypatch):
    """A cell that fails inside the fake world destroys its group, so the
    next cell (or test) can open its own."""
    def broken(multi_pod=False):
        raise RuntimeError("mesh refused")
    monkeypatch.setattr(D, "make_production_mesh", broken)
    with pytest.raises(RuntimeError, match="mesh refused"):
        D.run_cell("qwen2.5-14b", "decode_32k", "single")
    assert group_closed()
    rec = D.run_cell("qwen2.5-14b", "long_500k", "single")
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]


# -- the layouts the production meshes needed --------------------------------

def head_products_rank(rank, world):
    """Rank body: ``head_proj`` → tanh → ``head_out_proj`` with 3 heads
    on a 2 × 2 mesh (the heads do not divide the model axis, so the
    weights are split over head_dim, as the rules lay out qwen2.5-14b's 40
    heads on 16), x over data, the weights' embed dims over data (fsdp);
    returns the output's and the gradients' largest gaps from the same
    products unsharded, in fp64."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import head_out_proj, head_proj
    from repro_torch.sharding import context as sctx
    from repro_torch.sharding.spec import make_rules
    mesh = make_mesh((2, 2), ("data", "model"))
    g = torch.Generator().manual_seed(0)
    x, w, wo = (torch.randn(*s, generator=g, dtype=torch.float64)
                for s in ((4, 6, 8), (8, 3, 4), (3, 4, 8)))
    plain = [t.clone().requires_grad_(True) for t in (x, w, wo)]
    want = head_out_proj(torch.tanh(head_proj(plain[0], plain[1])), plain[2])
    want.square().sum().backward()
    placed = [distribute_tensor(t, mesh, pl, src_data_rank=None)
              .requires_grad_(True) for t, pl in
              ((x, [Shard(0), Replicate()]), (w, [Shard(0), Shard(2)]),
               (wo, [Shard(2), Shard(1)]))]
    rules = make_rules(fsdp=True, tp=True, axis_sizes={"data": 2, "model": 2})
    with sctx.activation_sharding(rules, mesh):
        h = head_proj(placed[0], placed[1])
        # the batch stays split over data, k over model: no rank computes
        # another's rows
        assert tuple(h.placements) == (Shard(0), Shard(3))
        out = head_out_proj(torch.tanh(h), placed[2])
        out.square().sum().backward()
    assert tuple(placed[1].grad.placements) == (Shard(0), Shard(2))
    return [float((out.full_tensor() - want).abs().max().detach())] + [
        float((p.grad.full_tensor() - q.grad).abs().max())
        for p, q in zip(placed, plain)]


def test_head_dim_split_attention_products_match_one_rank():
    """The column- and row-parallel attention products that a model axis
    the heads do not divide takes (``models/common.py`` ``head_proj``,
    ``head_out_proj``): on four gloo ranks, the output and every gradient
    equal the unsharded products' to fp64 rounding."""
    from repro_torch.dist import spawn
    gaps = spawn(head_products_rank, 4, device="cpu", timeout=240)
    assert max(gaps) < 1e-12, gaps


def test_reshape_gathers_only_a_split_the_mesh_cannot_carry():
    """``sharding.context.reshape``: a dim split 16 ways reshaped into 4 ×
    1,024 (xlstm-350m's sLSTM gates on the production mesh) is gathered
    over that mesh dim first; a split it can carry stays split; a plain
    tensor is reshaped as it is."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.sharding.context import reshape
    with D.fake_world(256):
        mesh = DeviceMesh("cpu", torch.arange(256).reshape(16, 16),
                          mesh_dim_names=("data", "model"))
        x = distribute_tensor(torch.empty(16, 2, 4096, device="meta"), mesh,
                              [Shard(0), Shard(2)], src_data_rank=None)
        y = reshape(x, 16, 2, 4, 1024)
        assert tuple(y.shape) == (16, 2, 4, 1024)
        assert tuple(y.placements) == (Shard(0), Replicate())
        z = reshape(x, 16, 2, 32, 128)
        assert tuple(z.placements) == (Shard(0), Shard(2))
    assert group_closed()
    assert reshape(torch.zeros(2, 8), 2, 2, 4).shape == (2, 2, 4)


def scan_counts(monkeypatch, full: bool, grad: bool):
    """Counts of xlstm-350m SMOKE over 2 × 32 tokens on ``meta`` in scan
    chunks of 8: a train step, or a forward without a graph; ``full`` runs
    every chunk, as on a device (no scan hook)."""
    import dataclasses
    import repro_torch.models.ssm as ssm
    monkeypatch.setattr(ssm, "SCAN_CHUNK", 8)
    if full:
        monkeypatch.setattr(D, "_scan_first_chunk", None)
    entry = get_arch("xlstm-350m")
    if grad:
        plan = dataclasses.replace(entry.plan, fsdp=False, tp=False,
                                   grad_accum=1)
        rec = D.price_train_step(entry.smoke, plan, 2, 32)
        return rec["hlo_flops"], rec["hlo_bytes"]
    model = build_model(entry.smoke, device="meta")
    batch = {"tokens": torch.empty(2, 32, dtype=torch.int64, device="meta")}
    with torch.no_grad(), D.counting(CountMode()) as mode:
        model(batch, compute_dtype=torch.bfloat16)
    assert ssm.SCAN_HOOK is None
    return mode.counts.flops, mode.counts.bytes_accessed


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "train"])
def test_scan_counted_from_its_first_chunk(monkeypatch, grad):
    """While the dry run counts, the xLSTM scans run their first chunk and
    count it once for each chunk (``launch/dryrun.py``
    ``_scan_first_chunk``, the hook ``counting`` installs as
    ``models/ssm.py`` ``SCAN_HOOK``; under autograd ``_RepeatedChunk``
    scales its recomputation and gradients too), which takes the dry
    run's 32,768-long scans from hours to minutes. The flops stay within
    1% and the bytes within 2% of every chunk run: a train step's are 0.4%
    and 1.7% under at these 8-step chunks (the chunks' input slices' own
    backward, once instead of each chunk), 0.16% and 0.7% at the models'
    256 (2 × 1,024 tokens)."""
    got = scan_counts(monkeypatch, False, grad)
    want = scan_counts(monkeypatch, True, grad)
    assert abs(got[0] - want[0]) <= 0.01 * want[0], (got, want)
    assert abs(got[1] - want[1]) <= 0.02 * want[1], (got, want)
