"""The port's single-device training path held against the JAX package:
the schedule, the three optimizers, the int8 compression and the norm
clip, the loss's gradient, qwen2.5-14b's SMOKE train step at grad
accumulation 1 and 2 with AdamW and Adafactor, remat, the step-keyed
loader, the Supervisor (restarts, in-place restores, a checkpoint the
reference wrote), the training CLI, and serving after a step.

Parameters are drawn in numpy by the reference's init rules in its tree
and inputs come from numpy, carried across with
``load_jax_train_state``; the reference's steps are compiled with XLA's
excess precision off (``as_written``), once each (``ref_step``).
Tolerances:

* optimizer updates, schedules, norms: fp32 at rtol 1e-5, atol 1e-7 (the same fp32
  formulas, sums in another order);
* the loss gradient: fp32 at rtol 1e-5 / atol 1e-7, bf16 at one bf16 ulp;
* the SMOKE train step in fp32 compute: loss at rtol 1e-6, grad_norm at
  rtol 2e-5 (fp32 gradients differ in the 5th digit: sums in another
  order through two layers and a 256-way softmax), every parameter and
  optimizer leaf at rtol 1e-4 of the leaf's largest entry. AdamW's state
  is carried with v = 0.01 everywhere, so its step is linear in the
  gradient: from v = 0 its first step is lr·g/|g|, which flips sign on
  gradients near 0 whichever side computes them;
* the bf16-compute step in aggregate: the update's relative L2 error
  below 5e-2;
* the integers (int8 payloads, int16 sums, loader batches) and the port's
  own restarts: bit for bit.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.data.loader import ShardedLoader as JaxLoader
from repro.models import build_model as jax_build_model
from repro.optim import adafactor as jax_adafactor
from repro.optim import adamw as jax_adamw
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.optim import compress as jcompress
from repro.optim import schedules as jschedules
from repro.runtime.supervisor import Supervisor as JaxSupervisor
from repro.train.loss import cross_entropy as jax_cross_entropy
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.checkpoint import CheckpointManager, load_arrays
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.configs.base import ParallelPlan
from repro_torch.data.loader import ShardedLoader
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.models import common as cm
from repro_torch.models.convert import load_jax_train_state
from repro_torch.optim import adafactor, adamw, make_optimizer, sgd
from repro_torch.optim import compress, optimizers
from repro_torch.optim.schedules import constant, warmup_cosine
from repro_torch.runtime import (FailureInjector, StragglerWatchdog,
                                 Supervisor)
from repro_torch.train import loss as tloss
from repro_torch.train.steps import init_train_state, make_train_step

from test_torch_families import batch_of, close, np32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QWEN = get_arch("qwen2.5-14b").smoke
XLSTM = get_arch("xlstm-350m").smoke
F32 = dict(rtol=1e-5, atol=1e-7)
LEAF = 1e-4                 # × a leaf's largest entry (``leaf_close``)
TCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def plan_of(arch: str, **kw) -> dict:
    """The arch's published plan on one device, as the training CLI runs
    it, with ``kw`` replaced; a dict both packages' plans take."""
    plan = dataclasses.replace(jax_get_arch(arch).plan, fsdp=False, tp=False,
                               sp=False, ep=False, **kw)
    return dataclasses.asdict(plan)


def as_written(fn, *args):
    """``fn(*args)``'s compiled form with XLA's excess precision off (see
    ``tests/test_torch_lm.py``)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def ref_model(arch: str):
    cfg = get_arch(arch).smoke
    return jax_build_model(JaxModelConfig(**dataclasses.asdict(cfg)))


def ref_state(arch: str, plan: dict, v_floor: float = 0.01, step: int = 1):
    """The reference's state at ``step`` (``_ref_state``, made once a
    plan), with AdamW's v set to ``v_floor`` (see the module
    docstring)."""
    st = dict(_ref_state(arch, tuple(plan.items()), v_floor))
    st["step"] = np.asarray(step, np.int32)
    return st


@functools.lru_cache(maxsize=None)
def _ref_state(arch: str, plan_items: tuple, v_floor: float):
    """The reference's state tree for the plan (its ``init_train_state``'s
    structure), the parameters drawn in numpy by its init rules from seed
    0 (an eager or compiled draw through the reference's ``init_params``
    takes seconds an arch), the optimizer's state zeros."""
    from repro.configs.base import ParallelPlan as JaxPlan
    from repro.sharding.spec import _is_spec
    plan = JaxPlan(**dict(plan_items))
    r = np.random.default_rng(0)

    def draw(spec):
        if spec.init in ("zeros", "ones", "scalar"):
            value = {"zeros": 0.0, "ones": 1.0}.get(spec.init, spec.scale)
            return np.full(spec.shape, value or 0.0, np.float32)
        if spec.init == "fanin":
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = (spec.scale or 1.0) / np.sqrt(max(fan_in, 1))
        else:
            std = spec.scale or 0.02
        return (r.normal(size=spec.shape) * std).astype(np.float32)

    params = jax.tree_util.tree_map(
        draw, ref_model(arch).param_specs(dtype=jnp.float32),
        is_leaf=_is_spec)
    opt = jax.eval_shape(lambda p: jax_make_optimizer(
        plan.optimizer, JaxTrainConfig(**TCFG)).init(p), params)
    opt = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), opt)
    if "v" in opt and "m" in opt:
        opt["v"] = jax.tree_util.tree_map(
            lambda v: np.full_like(v, v_floor), opt["v"])
    return {"params": params, "opt": opt}


_STEPS = {}


def ref_step(arch: str, plan_items: tuple, batch_shapes: tuple):
    """The reference's train step for (arch, plan), compiled once per batch
    layout."""
    key = (arch, plan_items, batch_shapes)
    if key not in _STEPS:
        from repro.configs.base import ParallelPlan as JaxPlan
        plan = JaxPlan(**dict(plan_items))
        fn, _ = jax_make_train_step(ref_model(arch), plan,
                                    JaxTrainConfig(**TCFG), mesh())
        st = ref_state(arch, dict(plan_items))
        batch = {k: jax.ShapeDtypeStruct(s, jnp.int32 if d == "i" else
                                         jnp.float32)
                 for k, s, d in batch_shapes}
        _STEPS[key] = as_written(fn, st, batch)
    return _STEPS[key]


def shapes_of(batch: dict) -> tuple:
    return tuple((k, v.shape, "i" if v.dtype.kind == "i" else "f")
                 for k, v in sorted(batch.items()))


def port_step(arch: str, plan: dict, state):
    """(model, state, step fn) on the CPU with the reference state carried
    across."""
    model = build_model(get_arch(arch).smoke, device="cpu")
    st = load_jax_train_state(model, state)
    fn = make_train_step(model, ParallelPlan(**plan), TrainConfig(**TCFG))
    return model, st, fn


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# leaves whose gradient is zero but for rounding: a key bias adds the same
# q·b to every score of a row, which the softmax cancels
NOISE = ("attn.bk",)


def assert_states_close(arch: str, got: dict, want_ref: dict, tol=LEAF,
                        lr: float = TCFG["lr"]):
    """Every parameter and optimizer leaf of the port's state against the
    reference's, carried into a second model; the step equal. A NOISE
    leaf's gradient is rounding on both sides, which Adafactor scales up
    to a step of about lr: its parameters are held within 2·lr of the
    reference's, its optimizer state only to be finite."""
    want = load_jax_train_state(build_model(get_arch(arch).smoke,
                                            device="cpu"), want_ref)
    assert int(got["step"]) == int(want["step"])
    noisy = lambda name: any(name.endswith(n) for n in NOISE)
    for name, p in got["params"].items():
        if noisy(name):
            close(p, want["params"][name], dict(rtol=0.0, atol=2 * lr), name)
        else:
            leaf_close(p, want["params"][name], tol, name)
    flat = lambda opt: {f"{k}/{n}": t for k, sub in opt.items()
                        for n, t in sub.items()}
    g, w = flat(got["opt"]), flat(want["opt"])
    assert set(g) == set(w)
    for name in g:
        if noisy(name.rsplit("/", 1)[0]) or noisy(name.split("/")[-1]):
            assert torch.isfinite(g[name]).all(), name
        else:
            leaf_close(g[name], w[name], tol, name)


def leaf_close(got, want, rel: float, what: str = ""):
    """|got − want| ≤ rel · max|want| elementwise (a leaf of zeros: equal)."""
    got, want = np32(got), np32(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0.0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


# ---------------------------------------------------------------------------
# configs and schedules
# ---------------------------------------------------------------------------

def test_train_config_fields_match_reference():
    assert ({(f.name, f.default) for f in dataclasses.fields(TrainConfig)}
            == {(f.name, f.default)
                for f in dataclasses.fields(JaxTrainConfig)})


@pytest.mark.parametrize("lr,warmup,total", [(3e-4, 100, 1000),
                                             (1.0, 10, 100), (1e-3, 0, 7)])
def test_warmup_cosine_matches_reference(lr, warmup, total):
    """Steps 0 … total + 3, fp32 values bit for bit but for an ulp of the
    cosine."""
    ours, theirs = warmup_cosine(lr, warmup, total), jax_warmup_cosine(
        lr, warmup, total)
    steps = np.arange(total + 4)
    got = np.array([float(ours(int(s))) for s in steps], np.float32)
    want = np.array([float(theirs(int(s))) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert float(ours(torch.tensor(3))) == got[3]
    np.testing.assert_array_equal(float(constant(0.5)(9)),
                                  float(jschedules.constant(0.5)(9)))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _leaves(r, dtype=np.float32):
    """A vector, a matrix and a stacked 3-D leaf."""
    return {"b": r.normal(size=(24,)).astype(dtype),
            "w": r.normal(size=(40, 24)).astype(dtype),
            "x": r.normal(size=(3, 8, 16)).astype(dtype)}


def _run_updates(make_port, make_ref, n: int = 3, lr: float = 0.05,
                 stacked: bool = False):
    """n updates of both optimizers on the same params, grads and state;
    after each, every param and state leaf compared. ``stacked``: the port
    holds layers "layers.<i>.b|w" that the reference stacks as one leaf."""
    r = np.random.default_rng(0)
    params = _leaves(r)
    if stacked:
        ref_params = {"layers": {"b": np.stack([params["b"]] * 2),
                                 "w": np.stack([params["w"], params["w"] * 2])},
                      "x": params["x"]}
        port = {"layers.0.b": params["b"], "layers.1.b": params["b"],
                "layers.0.w": params["w"], "layers.1.w": params["w"] * 2,
                "x": params["x"]}
    else:
        ref_params, port = params, dict(params)
    port = {k: torch.tensor(v) for k, v in port.items()}
    jopt, topt = make_ref(), make_port()
    jstate, tstate = jopt.init(ref_params), topt.init(port)
    jupdate = jax.jit(jopt.update)
    for i in range(n):
        grads = jax.tree_util.tree_map(
            lambda p: r.normal(size=p.shape).astype(np.float32) * (i + 1),
            ref_params)
        if stacked:
            tgrads = {"layers.0.b": grads["layers"]["b"][0],
                      "layers.1.b": grads["layers"]["b"][1],
                      "layers.0.w": grads["layers"]["w"][0],
                      "layers.1.w": grads["layers"]["w"][1], "x": grads["x"]}
        else:
            tgrads = grads
        tgrads = {k: torch.tensor(np.asarray(v)) for k, v in tgrads.items()}
        ref_params, jstate = jupdate(grads, jstate, ref_params,
                                     jnp.asarray(i), lr)
        port, tstate = topt.update(tgrads, tstate, port, i, lr)
        ref_params = host(ref_params)
        flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref_params)[0])
        for path, want in flat_ref.items():
            keys = [p.key for p in path]
            if keys[0] == "layers":
                for layer in range(want.shape[0]):
                    close(port[f"layers.{layer}.{keys[1]}"], want[layer], F32,
                          str(keys))
            else:
                close(port[".".join(keys)], want, F32, str(keys))
        yield host(jstate), tstate


@pytest.mark.parametrize("case", ["adamw", "sgd", "adafactor",
                                  "adafactor-sliced", "adafactor-stacked"])
def test_optimizer_updates_match_reference(case, monkeypatch):
    """Three updates of each optimizer on a vector, a matrix and a stacked
    3-D leaf. "sliced": the port's pieces at 64 elements (the 3-D leaf a
    matrix at a time, the matrix 2 rows at a time); "stacked": two layers
    the reference stacks, the norm-like vectors factored across them."""
    if case == "adamw":
        port, ref = lambda: adamw(weight_decay=0.1), lambda: jax_adamw(
            weight_decay=0.1)
    elif case == "sgd":
        port, ref = sgd, lambda: jax_make_optimizer("sgd")
    else:
        if case == "adafactor-sliced":
            monkeypatch.setattr(optimizers, "SLICE_ELEMS", 64)
        kw = {}
        if case == "adafactor-stacked":
            kw["stacked"] = ("layers",)
        port = lambda: adafactor(weight_decay=0.05, **kw)
        ref = lambda: jax_adafactor(weight_decay=0.05)
    for jstate, tstate in _run_updates(port, ref,
                                       stacked=case == "adafactor-stacked"):
        if case == "adamw":
            for k in ("m", "v"):
                for name, want in jstate[k].items():
                    close(tstate[k][name], want, F32, f"{k}/{name}")
        elif case.startswith("adafactor"):
            flat = {".".join(p.key for p in path): leaf for path, leaf in
                    jax.tree_util.tree_flatten_with_path(jstate)[0]}
            got = {f"{n}.{k}": t for n, s in tstate.items()
                   for k, t in s.items()}
            assert set(got) == set(flat)
            for name, want in flat.items():
                close(got[name], want, F32, name)


def test_adafactor_sliced_equals_whole_on_a_bf16_stack(monkeypatch):
    """A bf16 (4, 32, 48) stack through one piece and through a matrix at a
    time: the same bits (the pieces' sums are the leaf's)."""
    r = np.random.default_rng(1)
    p0 = torch.tensor(r.normal(size=(4, 32, 48)), dtype=torch.bfloat16)
    g = torch.tensor(r.normal(size=(4, 32, 48)), dtype=torch.bfloat16)
    outs = []
    for slice_elems in (1 << 25, 32 * 48):
        monkeypatch.setattr(optimizers, "SLICE_ELEMS", slice_elems)
        opt = adafactor()
        params = {"x": p0.clone()}
        st = opt.init(params)
        for i in range(2):
            opt.update({"x": g}, st, params, i, 0.01)
        outs.append((params["x"], st["x"]["r"], st["x"]["c"]))
    for a, b in zip(*outs):
        close(a, b, dict(rtol=1e-6, atol=0.0))
    assert outs[0][0].dtype == torch.bfloat16


def test_adamw_converges_quadratic():
    """The reference's test, on the port."""
    opt = adamw(weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for i in range(200):
        opt.update({"w": 2 * params["w"]}, state, params, i, 0.1)
    assert float(params["w"].abs().max()) < 1e-2


def test_adafactor_converges_quadratic():
    opt = adafactor()
    params = {"w": torch.ones((4, 3)) * 3.0}
    state = opt.init(params)
    for i in range(300):
        opt.update({"w": 2 * params["w"]}, state, params, i, 0.05)
    assert float(params["w"].abs().max()) < 0.05


def test_adafactor_state_is_factored():
    opt = adafactor(stacked=("layers",))
    params = {"w": torch.zeros((8, 16)), "b": torch.zeros((16,)),
              "layers.0.ln": torch.zeros(16), "layers.1.ln": torch.zeros(16),
              "layers.0.x": torch.zeros(4, 5, 6),
              "layers.1.x": torch.zeros(4, 5, 6)}
    st = opt.init(params)
    assert st["w"]["r"].shape == (8,) and st["w"]["c"].shape == (16,)
    assert st["b"]["v"].shape == (16,)
    assert st["layers.ln"]["r"].shape == (2,)
    assert st["layers.ln"]["c"].shape == (16,)
    assert st["layers.x"]["r"].shape == (2, 4, 5)
    assert st["layers.x"]["c"].shape == (2, 4, 6)
    assert sorted(jax_make_optimizer("adamw").init(
        {"w": jnp.zeros(3)})) == sorted(make_optimizer("adamw").init(
            {"w": torch.zeros(3)}))
    with pytest.raises(ValueError):
        make_optimizer("lion")


# ---------------------------------------------------------------------------
# compression and clipping
# ---------------------------------------------------------------------------

def test_quantize_payload_is_bit_for_bit():
    """The int8 payload and the scale equal the reference's, including an
    all-zero leaf (scale 1) and exact .5 quotients (half to even); the
    reference's error bound holds."""
    r = np.random.default_rng(2)
    cases = [r.normal(size=(100,)).astype(np.float32) * 7,
             np.zeros(5, np.float32),
             np.array([127.0, 0.5, 1.5, -2.5, 63.5], np.float32)]
    for g in cases:
        jq, js = jcompress._quantize(jnp.asarray(g))
        tq, ts = compress._quantize(torch.from_numpy(g))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        err = np.abs(g - tq.numpy().astype(np.float32) * float(ts))
        assert err.max() <= float(ts) / 2 + 1e-6


COMPRESSED = r'''
import os, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.optim import compress
S = 8
r = np.random.default_rng(3)
shapes = {"a": (64,), "w": (16, 12)}
recorded = []
real_psum = jax.lax.psum
def psum(x, axis_name):
    out = real_psum(x, axis_name)
    if getattr(x, "dtype", None) == jnp.int16:
        jax.debug.callback(lambda i, q, t: recorded.append((int(i), np.asarray(q), np.asarray(t))),
                           jax.lax.axis_index(axis_name), x, out, ordered=False)
    return out
jax.lax.psum = psum
mesh = jax.make_mesh((S,), ("data",))
def step(g, e):
    g = jax.tree_util.tree_map(lambda t: t[0], g)
    e = jax.tree_util.tree_map(lambda t: t[0], e)
    mean, ne = compress.compressed_psum(g, "data", e)
    return (jax.tree_util.tree_map(lambda t: t[None], mean),
            jax.tree_util.tree_map(lambda t: t[None], ne))
f = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(P("data"), P("data")),
                          out_specs=(P("data"), P("data"))))
out = {}
err = {k: np.zeros((S,) + s, np.float32) for k, s in shapes.items()}
for it in range(2):
    g = {k: (r.normal(size=(S,) + s) * (k == "a" and 5 or 1)).astype(np.float32)
         for k, s in shapes.items()}
    recorded.clear()
    mean, new_e = f(g, err)
    jax.effects_barrier()
    for k in shapes:
        out[f"g{it}_{k}"] = g[k]
        out[f"e{it}_{k}"] = err[k]
        out[f"mean{it}_{k}"] = np.asarray(mean[k])
        out[f"ne{it}_{k}"] = np.asarray(new_e[k])
    for i, q, t in recorded:
        key = "a" if q.shape == shapes["a"] else "w"
        out[f"q{it}_{key}_{i}"] = q
        out[f"t{it}_{key}_{i}"] = t
    err = {k: np.asarray(v) for k, v in new_e.items()}
np.savez(sys.argv[1], **out)
print("OK")
'''


def test_compressed_mean_matches_compressed_psum(tmp_path):
    """S = 8 ranks: the reference's ``compressed_psum`` under a shard_map
    over 8 host devices (one subprocess; its int16 payloads and sums
    recorded at its psum) against the port's ``compressed_mean`` over a
    leading rank axis, two steps with the error carried: each rank's
    int8 payload and the int16 sum bit for bit, the mean at fp32 (rtol
    1e-6), the new error within four ulps of the largest quantized
    value."""
    out = str(tmp_path / "compressed.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", COMPRESSED, out],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert run.returncode == 0 and "OK" in run.stdout, run.stderr[-3000:]
    ref = dict(np.load(out))
    tol = dict(rtol=1e-6, atol=1e-7)
    for it in range(2):
        # the second step starts from the reference's carried error
        g = {k: torch.from_numpy(ref[f"g{it}_{k}"]) for k in ("a", "w")}
        err = {k: torch.from_numpy(ref[f"e{it}_{k}"]) for k in g}
        mean, new_e = compress.compressed_mean(g, err)
        for k in g:
            q, total, _, _, _ = compress.compress_leaf(g[k], err[k])
            assert q.dtype == torch.int8 and total.dtype == torch.int16
            for rank in range(8):
                np.testing.assert_array_equal(
                    q[rank].numpy().astype(np.int16),
                    ref[f"q{it}_{k}_{rank}"])
                np.testing.assert_array_equal(total.numpy(),
                                              ref[f"t{it}_{k}_{rank}"])
                close(mean[k], ref[f"mean{it}_{k}"][rank], tol)
            # g − q·scale: the reference may fuse it, so allow four ulps of
            # the largest q·scale
            ulp = float(np.spacing(np.float32(np.abs(g[k].numpy()
                                                     + err[k].numpy()).max())))
            close(new_e[k], ref[f"ne{it}_{k}"], dict(rtol=0.0, atol=4 * ulp))
    assert set(compress.init_error({"a": torch.ones(3)})) == {"a"}


def test_global_norm_and_clip_match_reference():
    """fp32 and bf16 leaves: the norm at fp32, the clipped leaves in their
    own types; the reference's own clip test, on the port."""
    r = np.random.default_rng(4)
    leaves = {"a": r.normal(size=(30, 7)).astype(np.float32),
              "b": r.normal(size=(11,)).astype(np.float32) * 3}
    bf = torch.tensor(r.normal(size=(5, 6)), dtype=torch.bfloat16)
    ref = dict(leaves, c=jnp.asarray(np32(bf)).astype(jnp.bfloat16))
    for max_norm in (1.0, 1e3):
        port = {k: torch.tensor(v) for k, v in leaves.items()}
        port["c"] = bf.clone()
        jclip, jnorm = jcompress.clip_by_global_norm(ref, max_norm)
        tclip, tnorm = compress.clip_by_global_norm(port, max_norm)
        close(tnorm, jnorm, F32)
        close(compress.global_norm(port), jcompress.global_norm(jclip), F32)
        for k in ref:
            assert tclip[k].dtype == (torch.bfloat16 if k == "c"
                                      else torch.float32)
            close(tclip[k], jclip[k], dict(rtol=1e-5, atol=1e-7)
                  if k != "c" else dict(rtol=2.0 ** -8, atol=0.0), k)
    g = {"a": torch.tensor([3.0, 4.0])}
    clipped, norm = compress.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert float(compress.global_norm(clipped)) == pytest.approx(1.0,
                                                                 rel=1e-5)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_gradient_matches_jax_grad(dtype, monkeypatch):
    """The chunked cross entropy's value and gradient against ``jax.grad``
    of the reference's, with ignore_index rows and labels outside [0, V)
    (which count, and take no one-hot term), over chunks of 3 rows."""
    monkeypatch.setattr(tloss, "_ROWS", 3)
    r = np.random.default_rng(5)
    logits = (r.normal(size=(2, 5, 11)) * 3).astype(np.float32)
    labels = r.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, 1], labels[1, 2], labels[1, 4] = -100, 15, -3
    jx = jnp.asarray(logits).astype(jnp.bfloat16 if dtype == "bfloat16"
                                    else jnp.float32)
    jloss, jn = jax_cross_entropy(jx, jnp.asarray(labels))
    jg = jax.grad(lambda x: jax_cross_entropy(x, jnp.asarray(labels))[0])(jx)
    tx = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    tl, tn = tloss.cross_entropy(tx, torch.from_numpy(labels))
    tl.backward()
    assert float(tn) == float(jn) == 9
    close(tl.detach(), jloss, dict(rtol=1e-6, atol=0.0))
    assert tx.grad.dtype == tx.dtype
    tol = (dict(rtol=1e-5, atol=1e-7) if dtype == "float32"
           else dict(rtol=2.0 ** -8, atol=1e-7))
    close(tx.grad, jg, tol)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("ga", [1, 2])
def test_train_step_matches_reference(optimizer, ga):
    """qwen2.5-14b SMOKE in fp32 compute at grad accumulation 1 and 2: the
    metrics (loss, ce, tokens, grad_norm, lr) and every parameter and
    optimizer leaf after the step."""
    plan = plan_of("qwen2.5-14b", optimizer=optimizer, grad_accum=ga,
                   param_dtype="float32", compute_dtype="float32")
    batch = batch_of(QWEN, b=4, s=16)
    st = ref_state("qwen2.5-14b", plan)
    jst, jmet = ref_step("qwen2.5-14b", tuple(plan.items()),
                         shapes_of(batch))(st, batch)
    _, tst, fn = port_step("qwen2.5-14b", plan, st)
    tst, tmet = fn(tst, to_torch(batch))
    assert set(tmet) == set(jmet)
    for key in ("loss", "ce", "tokens", "lr"):
        close(tmet[key], jmet[key], dict(rtol=1e-6, atol=0.0), key)
    close(tmet["grad_norm"], jmet["grad_norm"], dict(rtol=2e-5, atol=0.0))
    assert_states_close("qwen2.5-14b", tst, host(jst))


def test_train_step_bf16_compute_in_aggregate():
    """bf16 compute, fp32 parameters, AdamW at grad accumulation 2: the
    loss at 1e-2 and the parameters' update (new − old) at 5e-2 relative
    L2 over the model."""
    plan = plan_of("qwen2.5-14b", grad_accum=2, param_dtype="float32",
                   compute_dtype="bfloat16")
    batch = batch_of(QWEN, b=4, s=16)
    st = ref_state("qwen2.5-14b", plan)
    jst, jmet = ref_step("qwen2.5-14b", tuple(plan.items()),
                         shapes_of(batch))(st, batch)
    model, tst, fn = port_step("qwen2.5-14b", plan, st)
    before = {n: p.detach().clone() for n, p in tst["params"].items()}
    tst, tmet = fn(tst, to_torch(batch))
    close(tmet["loss"], jmet["loss"], dict(rtol=1e-2, atol=0.0))
    want = load_jax_train_state(build_model(QWEN, device="cpu"), host(jst))
    num = den = 0.0
    for n, p in tst["params"].items():
        d_got = np32(p) - np32(before[n])
        d_want = np32(want["params"][n]) - np32(before[n])
        num += float(np.sum((d_got - d_want) ** 2))
        den += float(np.sum(d_want ** 2))
    assert (num / den) ** 0.5 < 5e-2


@pytest.fixture
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for one test: the CPU's
    embedding backward (``index_put_`` with accumulate) otherwise adds
    repeated tokens' rows in a varying order from a few thousand tokens
    on."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "dbrx-132b", "zamba2-2.7b",
                                  "whisper-base"])
def test_gradients_are_the_same_bits_under_every_remat(arch, deterministic,
                                                       monkeypatch):
    """``lm_loss``'s gradients with remat "none", "full" and "dots" on the
    CPU, bit for bit; dbrx with its MoE token chunks at 16 (each
    recomputed); the online softmax taken from 16 keys on, over KV chunks
    of 8 (each recomputed)."""
    monkeypatch.setattr(cm, "FLASH_THRESHOLD", 16)
    monkeypatch.setattr(cm, "KV_CHUNK", 8)
    cfg = get_arch(arch).smoke
    if cfg.family == "moe":
        cfg = cfg.scaled(moe_seq_chunk=16)
    model = build_model(cfg, device="cpu", rng=1)
    batch = to_torch(batch_of(cfg, s=64))
    grads = {}
    for mode in ("none", "full", "dots"):
        with cm.grads_on(model):
            loss, _ = tloss.lm_loss(model, batch, remat=mode,
                                    compute_dtype=torch.float32)
            loss.backward()
        grads[mode] = {n: p.grad for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
    for mode in ("full", "dots"):
        for n, g in grads["none"].items():
            if g is None:
                assert grads[mode][n] is None
                continue
            assert torch.equal(g, grads[mode][n]), (mode, n)
    assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError, match="remat"):
        cm.remat("some", lambda x: x, torch.ones(1))


def test_loader_matches_reference_bit_for_bit():
    ours = ShardedLoader(256, 4, 32, seed=7, device="cpu")
    theirs = JaxLoader(256, 4, 32, seed=7)
    for step in (0, 1, 13):
        got, want = ours.get(step), theirs.get(step)
        assert set(got) == set(want)
        for k in got:
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_init_train_state_and_plans(tmp_path):
    """init_train_state draws in place from the seed (the same seed, the
    same bits), zeroes the optimizer, checks the param type; a sharded
    plan over a one-rank mesh steps as one device does."""
    model = build_model(QWEN, device="cpu")
    plan = ParallelPlan(**plan_of("qwen2.5-14b"))
    a = init_train_state(model, plan, TrainConfig(), 3)
    first = {n: p.clone() for n, p in a["params"].items()}
    b = init_train_state(model, plan, TrainConfig(), 3)
    assert all(torch.equal(first[n], p) for n, p in b["params"].items())
    assert all(p is b["params"][n] for n, p in model.named_parameters())
    assert int(b["step"]) == 0 and b["step"].dtype == torch.int32
    assert float(sum(t.abs().sum() for t in b["opt"]["m"].values())) == 0
    with pytest.raises(ValueError, match="param_dtype"):
        init_train_state(model, dataclasses.replace(
            plan, param_dtype="bfloat16"), TrainConfig(), 0)
    # the sharded plans (once refused) run over a one-rank mesh: the same
    # state as the one-device step, the leaves laid out by the rules
    from test_torch_plan_ranks import one_rank_group
    tcfg = TrainConfig(**TCFG)
    batch = to_torch(batch_of(QWEN, b=2, s=8))
    fp32 = dataclasses.replace(plan, compute_dtype="float32", grad_accum=1)
    st = init_train_state(model, fp32, tcfg, 3)
    st, met = make_train_step(model, fp32, tcfg)(st, batch)
    with one_rank_group(str(tmp_path)) as mesh:
        for kw in (dict(tp=True), dict(fsdp=True), dict(ep=True)):
            sharded = dataclasses.replace(fp32, **kw)
            m2 = build_model(QWEN, device="meta")
            s2 = init_train_state(m2, sharded, tcfg, 3, mesh=mesh)
            s2, met2 = make_train_step(m2, sharded, tcfg, mesh)(s2, batch)
            assert float(met2["loss"]) == float(met["loss"]), kw
            for n, p in s2["params"].items():
                torch.testing.assert_close(p.full_tensor(), st["params"][n],
                                           rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the Supervisor
# ---------------------------------------------------------------------------

def _supervised(tmp_path, tag, arch="xlstm-350m", fail_at=None,
                update_hook=None, steps=8):
    """The reference's supervisor test setup on the port: the arch's SMOKE
    at fp32 params, grad accumulation 1, lr 1e-3 with 2 warm-up steps,
    batches of 4 × 32 from seed 7 (the xLSTM's 4 × 16: its cells step a
    position at a time), a checkpoint every 3 steps."""
    cfg = get_arch(arch).smoke
    plan = ParallelPlan(**plan_of(arch, grad_accum=1, param_dtype="float32"))
    tcfg = TrainConfig(total_steps=steps, lr=1e-3, warmup_steps=2)
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, plan, tcfg)
    if update_hook is not None:
        step = update_hook(step)
    loader = ShardedLoader(cfg.vocab_size, 4,
                           16 if cfg.family == "ssm" else 32, seed=7,
                           device="cpu")
    ckpt = CheckpointManager(str(tmp_path / tag), keep=3, async_save=False)
    return Supervisor(
        ckpt=ckpt, train_step=step, loader=loader.get,
        init_state=lambda: init_train_state(model, plan, tcfg, 0),
        ckpt_every=3,
        injector=FailureInjector([fail_at]) if fail_at is not None else None)


def _same_bits(a: dict, b: dict):
    assert int(a["step"]) == int(b["step"])
    fa = {f"p/{n}": t for n, t in a["params"].items()}
    fb = {f"p/{n}": t for n, t in b["params"].items()}
    for tree, out in ((a["opt"], fa), (b["opt"], fb)):
        for k, sub in tree.items():
            for n, t in (sub.items() if isinstance(sub, dict) else []):
                out[f"o/{k}/{n}"] = t
    assert set(fa) == set(fb)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "xlstm-350m"])
def test_restart_equals_uninterrupted(tmp_path, arch):
    """The reference's scenario: a failure at step 5 (after the checkpoint
    of step 2) restores in place and replays 3 … 7; the final state is the
    uninterrupted run's, bit for bit."""
    clean = _supervised(tmp_path, "clean", arch).run(8)
    clean = {k: (v if k == "step" else _copy(v)) for k, v in clean.items()}
    faulty = _supervised(tmp_path, "faulty", arch, fail_at=5).run(8)
    _same_bits(clean, faulty)
    assert int(faulty["step"]) == 8


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.detach().clone()


def test_failure_partway_through_an_update_gives_the_same_bits(tmp_path):
    """A failure raised at step 4 after the optimizer has updated half the
    parameters in place: the restart writes the step-2 checkpoint back
    into every leaf, and the run ends on the uninterrupted run's bits."""
    clean = _copy(_supervised(tmp_path, "clean", "qwen2.5-14b").run(8))
    fired = []

    def hook(step):
        def wrapped(state, batch):
            if int(state["step"]) == 4 and not fired:
                fired.append(True)
                params = state["params"]
                names = list(params)[: len(params) // 2]
                with torch.no_grad():
                    for n in names:
                        params[n].add_(1.0)
                        for sub in state["opt"].values():
                            if n in sub:
                                sub[n].mul_(3.0)
                raise RuntimeError("failed partway through an update")
            return step(state, batch)
        return wrapped

    faulty = _supervised(tmp_path, "faulty", "qwen2.5-14b",
                         update_hook=hook).run(8)
    assert fired
    _same_bits(clean, faulty)


def test_restart_without_a_checkpoint_redraws(tmp_path):
    """A failure before the first checkpoint: the state is made afresh
    (parameters re-drawn in place), and the run still ends on the clean
    bits."""
    clean = _copy(_supervised(tmp_path, "clean", "qwen2.5-14b").run(4))
    faulty = _supervised(tmp_path, "faulty", "qwen2.5-14b", fail_at=1).run(4)
    _same_bits(clean, faulty)


def test_too_many_failures_raise(tmp_path):
    sup = _supervised(tmp_path, "fatal", "qwen2.5-14b")
    sup.max_failures = 1
    sup.injector = FailureInjector([2, 3, 4])
    with pytest.raises(RuntimeError, match="injected"):
        sup.run(8)


def test_watchdog_flags_a_slow_step_on_a_held_clock():
    now = [0.0]
    seen = []
    wd = StragglerWatchdog(window=50, p95_factor=2.0, clock=lambda: now[0],
                           on_straggle=lambda *a: seen.append(a))
    for step in range(15):
        wd.start()
        now[0] += 0.05 if step == 12 else 0.001
        wd.stop(step)
    assert [s for s, _, _ in wd.flagged] == [12] == [s for s, _, _ in seen]


def test_eight_steps_track_the_reference():
    """8 steps of qwen2.5-14b SMOKE (AdamW, fp32, grad accumulation 1) from
    the same parameters over the loader's batches: the port's losses
    against the reference's at rtol 1e-4, the final parameters at 1e-3 of
    each leaf's largest entry (8 updates of lr ≤ 1e-3 compound the
    gradients' fifth-digit differences)."""
    plan = plan_of("qwen2.5-14b", grad_accum=1, param_dtype="float32",
                   compute_dtype="float32")
    st = ref_state("qwen2.5-14b", plan, step=0)
    loader = JaxLoader(QWEN.vocab_size, 4, 16, seed=7)
    fn = ref_step("qwen2.5-14b", tuple(plan.items()),
                  shapes_of(host(loader.get(0))))
    _, tst, tfn = port_step("qwen2.5-14b", plan, st)
    tloader = ShardedLoader(QWEN.vocab_size, 4, 16, seed=7, device="cpu")
    for step in range(8):
        st, jmet = fn(st, loader.get(step))
        tst, tmet = tfn(tst, tloader.get(step))
        close(tmet["loss"], jmet["loss"], dict(rtol=1e-4, atol=0.0))
    assert_states_close("qwen2.5-14b", tst, host(st), 1e-3)


def test_port_resumes_a_checkpoint_the_reference_wrote(tmp_path):
    """The reference's Supervisor runs 6 steps with a checkpoint every 3;
    the port loads its step-2 directory (``load_jax_train_state``) and runs
    steps 3 … 5 through its own Supervisor over the same loader: the
    final state is the reference's own continuation, at 1e-4 of each
    leaf's largest entry."""
    plan = plan_of("qwen2.5-14b", grad_accum=1, param_dtype="float32",
                   compute_dtype="float32")
    st0 = ref_state("qwen2.5-14b", plan, step=0)
    loader = JaxLoader(QWEN.vocab_size, 4, 16, seed=7)
    fn = ref_step("qwen2.5-14b", tuple(plan.items()),
                  shapes_of(host(loader.get(0))))
    jckpt = JaxCheckpointManager(str(tmp_path / "ref"), keep=3,
                                 async_save=False)
    final = JaxSupervisor(ckpt=jckpt, train_step=fn, loader=loader.get,
                          init_state=lambda: jax.tree_util.tree_map(
                              jnp.asarray, st0), ckpt_every=3).run(6)
    model = build_model(QWEN, device="cpu")
    resumed = load_jax_train_state(model, str(tmp_path / "ref" /
                                              "step_00000002"))
    assert int(resumed["step"]) == 3
    tplan = ParallelPlan(**plan)
    tckpt = CheckpointManager(str(tmp_path / "port"), keep=3,
                              async_save=False)
    tckpt.save(2, resumed)
    tloader = ShardedLoader(QWEN.vocab_size, 4, 16, seed=7, device="cpu")
    state = Supervisor(
        ckpt=tckpt, train_step=make_train_step(model, tplan,
                                               TrainConfig(**TCFG)),
        loader=tloader.get, init_state=lambda: resumed, ckpt_every=3).run(6)
    assert_states_close("qwen2.5-14b", state, host(final))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_trains_and_restarts_to_the_same_bits(tmp_path):
    """``--smoke --device cpu`` twice: uninterrupted, and with a failure at
    step 4 after the step-2 checkpoint; the final checkpoints hold the
    same bits, and main returns the last metrics."""
    args = ["--arch", "qwen2.5-14b", "--smoke", "--device", "cpu",
            "--steps", "6", "--batch", "2", "--seq", "16", "--ckpt-every",
            "3", "--log-every", "100"]
    a = train_cli.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    b = train_cli.main(args + ["--ckpt-dir", str(tmp_path / "b"),
                               "--fail-at", "4"])
    assert a["step"] == b["step"] == 6
    assert {"loss", "ce", "grad_norm", "lr", "tokens"} <= set(a)
    assert a["loss"] == b["loss"] and np.isfinite(a["loss"])
    fa = load_arrays(str(tmp_path / "a" / "step_00000005"))
    fb = load_arrays(str(tmp_path / "b" / "step_00000005"))
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_cli_refusals(tmp_path):
    """``--data 2`` (once refused, as ``--model 2`` was) spawns two ranks
    and trains the reference CLI's plan, checkpointing every step;
    ``--fail-at`` over the mesh (once refused too) restarts every rank
    from the checkpoint before the failure and ends on the uninterrupted
    run's bits; without a GPU the default device raises."""
    base = ["--arch", "qwen2.5-14b", "--smoke", "--steps", "3", "--batch",
            "2", "--seq", "8"]
    mesh = base + ["--device", "cpu", "--data", "2", "--ckpt-every", "1"]
    a = train_cli.main(mesh + ["--ckpt-dir", str(tmp_path / "a")])
    b = train_cli.main(mesh + ["--ckpt-dir", str(tmp_path / "b"),
                               "--fail-at", "2"])
    assert a["step"] == b["step"] == 3 and np.isfinite(a["loss"])
    assert a["loss"] == b["loss"]
    fa = load_arrays(str(tmp_path / "a" / "step_00000002"))
    fb = load_arrays(str(tmp_path / "b" / "step_00000002"))
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    base += ["--ckpt-dir", str(tmp_path / "c")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(base)


# ---------------------------------------------------------------------------
# serving after training
# ---------------------------------------------------------------------------

def test_serving_after_a_train_step_records_no_graph(monkeypatch):
    """qwen2.5-14b SMOKE: a train step on the "auto" model leaves no
    gradient on and no ``.grad``; its forward after the step, outside
    ``no_grad``, records no graph. The trained parameters loaded into the
    same config with attn_impl "pallas" serve through the fused op once a
    layer, record no graph either, and give the "auto" model's logits
    (fp32, both plain online softmaxes on the CPU: rtol 1e-5, atol 1e-5)."""
    calls = []
    real = ops.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", counted)
    model = build_model(QWEN, device="cpu")
    plan = ParallelPlan(**plan_of("qwen2.5-14b", grad_accum=2,
                                  param_dtype="float32"))
    tcfg = TrainConfig(**TCFG)
    state = init_train_state(model, plan, tcfg, 0)
    state, metrics = make_train_step(model, plan, tcfg)(
        state, to_torch(batch_of(QWEN, b=2, s=16)))
    assert calls == [] and np.isfinite(float(metrics["loss"]))
    assert all(not p.requires_grad and p.grad is None
               for p in model.parameters())
    tokens = to_torch({"tokens": batch_of(QWEN)["tokens"]})
    logits, _ = model(tokens, compute_dtype=torch.float32)
    assert not logits.requires_grad and logits.grad_fn is None
    assert calls == []
    fused = build_model(QWEN.scaled(attn_impl="pallas"), device="cpu")
    fused.load_state_dict(model.state_dict())
    fused_logits, _ = fused(tokens, compute_dtype=torch.float32)
    assert not fused_logits.requires_grad and fused_logits.grad_fn is None
    assert len(calls) == QWEN.n_layers
    np.testing.assert_allclose(fused_logits.numpy(), logits.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_train_step_refuses_the_fused_attention():
    """attn_impl "pallas" has no backward (the reference's ``jax.grad``
    fails on ``flash_attention_pallas``): ``make_train_step`` raises."""
    cfg = QWEN.scaled(attn_impl="pallas")
    model = build_model(cfg, device="cpu")
    plan = ParallelPlan(**plan_of("qwen2.5-14b", param_dtype="float32"))
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(model, plan, TrainConfig(**TCFG))
