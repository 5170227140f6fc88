"""The port's logical-axis sharding rules held against the reference's:
the reference's ``tests/test_sharding.py`` cases on the port's ``Rules``,
and, for every architecture's full config under its published plan (and
the plan with ``ep`` flipped, and with ``kv_len_shard``) on the
production meshes (16 × 16, 2 × 16 × 16) and two small ones (2 × 2,
1 × 2), the parameter, train-state (AdamW, SGD, Adafactor's stacked
``r``/``c``), batch and cache specs, leaf by leaf. Pure logic: the
reference's specs are its ``ParamSpec`` trees and the port's models are
built on ``meta``; nothing is allocated. The port's parameters are
unstacked, so a stacked reference leaf's spec is compared without its
leading ``"layers"`` entry (which every plan maps to None); the reference's
``PartitionSpec`` becomes a tuple.
"""
import dataclasses
import functools

import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.runtime.elastic import best_mesh_shape as jax_best_mesh_shape
from repro.serve.steps import cache_pspecs as jax_cache_pspecs
from repro.sharding.spec import make_rules as jax_make_rules
from repro.sharding.spec import param_pspecs as jax_param_pspecs
from repro.train.steps import batch_pspecs as jax_batch_pspecs
from repro.train.steps import state_pspecs as jax_state_pspecs
from repro_torch.configs import get_arch
from repro_torch.configs.registry import list_archs
from repro_torch.models import build_model
from repro_torch.models import common as cm
from repro_torch.runtime.elastic import best_mesh_shape
from repro_torch.sharding.spec import (PSpec, Rules, cache_pspecs,
                                       logical_to_pspec, make_rules,
                                       param_pspecs)
from repro_torch.train.steps import (DTYPES, abstract_train_state,
                                     batch_pspecs, state_pspecs)

AX = {"data": 16, "model": 16}
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "1x2": {"data": 1, "model": 2}}


def t(spec) -> tuple:
    """A reference PartitionSpec (or the port's PSpec) as a plain tuple."""
    return tuple(spec)


# ---------------------------------------------------------------------------
# the reference's rule cases
# ---------------------------------------------------------------------------

CASES = {
    # (rules kwargs, axes, shape, the reference's expected spec)
    "tp_fsdp": (dict(fsdp=True, tp=True, axis_sizes=AX), ("embed", "mlp"),
                (4096, 16384), P("data", "model")),
    "heads_fall_back_to_head_dim": (dict(tp=True, axis_sizes=AX),
                                    ("embed", "heads", "head_dim"),
                                    (5120, 40, 128), P(None, None, "model")),
    "heads_take_model_dedup_head_dim": (dict(tp=True, axis_sizes=AX),
                                        ("embed", "heads", "head_dim"),
                                        (4096, 32, 128), P(None, "model")),
    "mqa_kv_head": (dict(tp=True, axis_sizes=AX),
                    ("embed", "kv_heads", "head_dim"), (6144, 1, 128),
                    P(None, None, "model")),
    "batch_one_replicated": (dict(tp=True, axis_sizes=AX), ("batch", "seq"),
                             (1, 524288), P()),
    "multi_pod_batch": (dict(tp=True, multi_pod=True,
                             axis_sizes={"pod": 2, "data": 16, "model": 16}),
                        ("batch", None, None), (256, 4096, 1024),
                        P(("pod", "data"))),
    "multi_pod_partial_divisibility": (
        dict(tp=True, multi_pod=True,
             axis_sizes={"pod": 2, "data": 16, "model": 16}),
        ("batch",), (16,), P("pod")),
    "no_axis_reused": (dict(fsdp=True, tp=True, axis_sizes=AX),
                       ("embed", "mlp", "vocab"), (4096, 16384, 32000),
                       None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_cases_match_reference(case):
    """Each case of the reference's ``tests/test_sharding.py``: the port's
    spec is the reference's, and no mesh axis serves two dims."""
    kw, axes, shape, expected = CASES[case]
    ours = make_rules(**kw).pspec(axes, shape)
    theirs = jax_make_rules(**kw).pspec(axes, shape)
    assert t(ours) == t(theirs)
    if expected is not None:
        assert t(ours) == t(expected)
    used = [a for e in ours if e is not None
            for a in ((e,) if isinstance(e, str) else e)]
    assert len(used) == len(set(used))


def test_param_pspecs_of_a_module_and_logical_to_pspec():
    """The reference's ``param_pspecs`` tree case, on a module's declared
    axes; ``logical_to_pspec`` over a nested dict without shapes."""
    r = make_rules(fsdp=False, tp=True, axis_sizes=AX)
    mod = torch.nn.Module()
    mod.w = cm.new_param((64, 128), torch.float32, "meta", "fanin",
                         axes=("embed", "mlp"))
    mod.ln = cm.norm_param(64, "meta")
    specs = param_pspecs(mod, r)
    assert specs == {"w": PSpec(None, "model"), "ln": PSpec()}
    assert logical_to_pspec({"a": ("batch", "embed"), "b": {"c": ("mlp",)}},
                            make_rules(fsdp=True)) == {
        "a": PSpec("data"), "b": {"c": PSpec("model")}}
    with pytest.raises(ValueError, match="rank"):
        cm.new_param((4, 4), torch.float32, "meta", "zeros", axes=("mlp",))


@settings(max_examples=50, deadline=None)
@given(
    st.lists(st.sampled_from(["embed", "mlp", "heads", "kv_heads", "head_dim",
                              "vocab", None]), min_size=1, max_size=4),
    st.lists(st.integers(1, 512), min_size=1, max_size=4),
    st.booleans(), st.booleans(),
)
def test_pspec_always_divisible_and_equal_to_reference(axes, dims, fsdp, tp):
    """The reference's property: every mesh extent divides its dim; and the
    port's spec is the reference's."""
    n = min(len(axes), len(dims))
    axes, dims = tuple(axes[:n]), tuple(dims[:n])
    ps = make_rules(fsdp=fsdp, tp=tp, axis_sizes=AX).pspec(axes, dims)
    assert t(ps) == t(jax_make_rules(fsdp=fsdp, tp=tp,
                                     axis_sizes=AX).pspec(axes, dims))
    for i, entry in enumerate(ps):
        if entry is None:
            continue
        extent = 1
        for nm in ((entry,) if isinstance(entry, str) else entry):
            extent *= AX[nm]
        assert dims[i] % extent == 0


# ---------------------------------------------------------------------------
# every architecture's trees
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def ref_model(arch: str):
    return jax_build_model(jax_get_arch(arch).config)


@functools.lru_cache(maxsize=None)
def port_model(arch: str, param_dtype: str):
    return build_model(get_arch(arch).config,
                       param_dtype=DTYPES[param_dtype], device="meta")


def flat(tree, prefix=""):
    """{dotted path: leaf} of a nested dict whose leaves are specs."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unstacked(model, ref_flat: dict) -> dict:
    """The reference's flat param specs on the port's names: a stacked
    leaf (``layers.attn.wq``) gives each layer's (``layers.3.attn.wq``)
    its spec without the leading ``"layers"`` entry."""
    stacked = {name: len(getattr(model, name)) for name in model.stacked}
    out = {}
    for path, spec in ref_flat.items():
        head, _, rest = path.partition(".")
        if head in stacked and rest:
            assert spec[0] is None if len(spec) else True, (path, spec)
            for i in range(stacked[head]):
                out[f"{head}.{i}.{rest}"] = tuple(spec)[1:]
        else:
            out[path] = tuple(spec)
    return out


def plans_of(arch: str):
    """The published plan, the plan with ``ep`` flipped, and with
    ``kv_len_shard``."""
    plan = get_arch(arch).plan
    return {"published": plan,
            "ep_flipped": dataclasses.replace(plan, ep=not plan.ep),
            "kv_len_shard": dataclasses.replace(plan, kv_len_shard=True)}


def rules_pair(plan, sizes: dict):
    kw = dict(fsdp=plan.fsdp, tp=plan.tp, sp=plan.sp, ep=plan.ep,
              multi_pod="pod" in sizes, axis_sizes=sizes,
              kv_len_shard=plan.kv_len_shard)
    return make_rules(**kw), jax_make_rules(**kw)


def jax_plan(plan, **kw):
    from repro.configs.base import ParallelPlan as JaxPlan
    return JaxPlan(**dict(dataclasses.asdict(plan), **kw))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_every_plan_lays_out_every_leaf_as_the_reference(arch, mesh):
    """Parameters, AdamW's m and v, SGD's empty state, Adafactor's stacked
    r/c or v, the batch of every shape and the cache at decode_32k, under
    the published plan, with ep flipped and with kv_len_shard."""
    sizes = MESHES[mesh]
    ref = ref_model(arch)
    for pname, plan in plans_of(arch).items():
        ours, theirs = rules_pair(plan, sizes)
        model = port_model(arch, plan.param_dtype)
        jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[
            plan.param_dtype]
        want = unstacked(model, flat(jax_param_pspecs(
            ref.param_specs(dtype=jdt), theirs)))
        got = {n: tuple(s) for n, s in param_pspecs(model, ours).items()}
        assert got == want, (pname, sorted(
            n for n in want if got.get(n) != want[n])[:5])
        for opt in ("adamw", "sgd", "adafactor"):
            p = dataclasses.replace(plan, optimizer=opt)
            js = jax_state_pspecs(ref, jax_plan(p), theirs)
            ps = state_pspecs(model, p, ours)
            assert {n: tuple(s) for n, s in ps["params"].items()} == want
            assert tuple(ps["step"]) == tuple(js["step"])
            if opt == "adamw":
                for k in ("m", "v"):
                    assert {n: tuple(s) for n, s in ps["opt"][k].items()} \
                        == want, (pname, k)
            elif opt == "sgd":
                assert ps["opt"] == {} and js["opt"] == {}
            else:
                # Adafactor's leaves are the reference's stacked ones
                jflat = {k: tuple(v) for k, v in flat(js["opt"]).items()}
                pflat = {k: tuple(v) for k, v in flat(ps["opt"]).items()}
                assert pflat == jflat, (pname, sorted(
                    k for k in jflat if pflat.get(k) != jflat[k])[:5])
        for shape in SHAPES.values():
            specs = ref.input_specs(shape)
            got = batch_pspecs({k: v.shape for k, v in specs.items()}, ours)
            assert {k: tuple(v) for k, v in got.items()} == {
                k: tuple(v) for k, v in jax_batch_pspecs(specs,
                                                         theirs).items()}
        B, S = SHAPES["decode_32k"].global_batch, SHAPES["decode_32k"].seq_len
        jc = flat(jax_cache_pspecs(ref, B, S, theirs))
        pc = flat(cache_pspecs(model, B, S, ours))
        assert {k: tuple(v) for k, v in pc.items()} == {
            k: tuple(v) for k, v in jc.items()}, pname


def test_abstract_train_state_allocates_nothing():
    """The state on ``meta``: the published plan's leaves, shapes and
    types (AdamW's m and v fp32 mirrors; Adafactor's stacked r and c)."""
    st_ = abstract_train_state(get_arch("qwen2.5-14b").config,
                               get_arch("qwen2.5-14b").plan, None)
    wq = st_["params"]["layers.0.attn.wq"]
    assert wq.device.type == "meta" and tuple(wq.shape) == (5120, 40, 128)
    assert st_["opt"]["m"]["layers.47.mlp.wo"].dtype == torch.float32
    plan = get_arch("dbrx-132b").plan
    st_ = abstract_train_state(get_arch("dbrx-132b").config, plan, None)
    r = st_["opt"]["layers.moe.wi_gate"]["r"]
    assert r.device.type == "meta" and tuple(r.shape) == (40, 16, 6144)
    assert st_["params"]["embed.tok"].dtype == torch.bfloat16


def test_best_mesh_shape_matches_reference():
    for n in range(1, 513):
        for prefer in range(1, 17):
            assert best_mesh_shape(n, prefer) == jax_best_mesh_shape(n,
                                                                     prefer)


@pytest.fixture
def fake_meshes():
    """Meshes of 2 × 2 and 2 × 2 × 2 ranks in this process over PyTorch's
    ``fake`` process group (no collective runs)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
    try:
        yield {"2x2x2": DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                                   mesh_dim_names=("pod", "data", "model")),
               "2x2": DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                                 mesh_dim_names=("data", "model")),
               "1x2": DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                                 mesh_dim_names=("data", "model"))}
    finally:
        dist.destroy_process_group()


def test_placements_and_to_named(fake_meshes):
    """A spec's DTensor placements: a dim over ("pod", "data") is split over
    both, major to minor; a one-wide axis stays replicated; an axis the
    mesh lacks or an order against the mesh's raises. ``to_named`` maps a
    whole state's specs."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding.spec import placements
    from repro_torch.train.steps import to_named
    m3, m2, m12 = (fake_meshes[k] for k in ("2x2x2", "2x2", "1x2"))
    assert placements(PSpec(("pod", "data"), None, "model"), m3) == [
        Shard(0), Shard(0), Shard(2)]
    assert placements(PSpec(None, "model"), m2) == [Replicate(), Shard(1)]
    assert placements(PSpec("data", "model"), m12) == [Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="names mesh axis"):
        placements(PSpec("pod"), m2)
    with pytest.raises(ValueError, match="against the mesh order"):
        placements(PSpec(("data", "pod")), m3)
    entry = get_arch("qwen2.5-14b")
    model = port_model("qwen2.5-14b", "float32")
    rules = make_rules(fsdp=True, tp=True, sp=True,
                       axis_sizes={"data": 2, "model": 2})
    named = to_named(state_pspecs(model, entry.plan, rules), m2)
    assert named["params"]["layers.0.attn.wq"] == [Shard(0), Shard(1)]
    assert named["opt"]["m"]["embed.tok"] == [Shard(1), Shard(0)]
    assert named["step"] == [Replicate(), Replicate()]
