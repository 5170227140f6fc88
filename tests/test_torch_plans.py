"""The port's multi-device plans on real gloo ranks on the CPU, at SMOKE
size, held against the JAX package: the sharded train step (fsdp + tp + sp
on a 2 × 2 mesh, grad accumulation 2) against the reference's
single-device step; tp serving (1 × 2) against the one-rank port; dbrx's
expert parallelism (2 × 2) against the reference's EP program (routing and
kept masks exactly, outputs at fp32); the GPipe schedule over 4 stages
against the reference's ``pipeline_apply``; ``compressed_psum`` over 8
ranks against ``compressed_mean`` bit for bit; xlstm-350m's checkpoint
written at 4 ranks and resumed at 2, bit for bit; the training CLI at
``--data 2 --model 2``; a mesh larger than the world.

Each group of ranks is spawned once for the module (``groups``), its rank
bodies in ``tests/test_torch_plan_ranks.py`` (no JAX there), and the JAX
side runs once in a subprocess with 4 forced host devices, beside the
ranks. The group of two and the group of eight join a
``repro_torch.dist.StagedGroup``, the group the ranks use on the card,
and the group of four plain gloo. Tolerances:
* the train step in fp32 compute: the reference's single-device limits of
  ``tests/test_torch_train.py`` (loss rtol 1e-6, grad_norm rtol 2e-5,
  every leaf at 1e-4 of its largest entry);
* tp serving in fp32 compute and an fp32 cache: logits at rtol 1e-5 /
  atol 1e-5 of the one-rank port (the heads' partial sums add in another
  order);
* EP: integer decisions equal; outputs at 1e-5 (fp32, the combine's sums
  in another order);
* the pipeline: outputs at 1e-5, gradients at 1e-4 / 1e-5, the
  reference's own limits;
* compressed_psum, the elastic restore: bit for bit;
* the CLI in bf16 compute: the loss at rtol 1e-2 of one rank's after 3
  steps (5e-4 measured; a SMOKE model's bf16 gradients differ from fp32
  ones by tens of percent, so bf16 sums in another order move the loss
  more than fp32 ones).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import test_torch_plan_ranks as ranks
from repro_torch.configs import get_arch
from repro_torch.dist import spawn
from repro_torch.launch import train as train_cli
from repro_torch.models import moe

from test_torch_train import (QWEN, assert_states_close, batch_of,
                              close, host, plan_of, ref_state, ref_step,
                              shapes_of)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_PLAN = plan_of("qwen2.5-14b", grad_accum=2, param_dtype="float32",
                     compute_dtype="float32")
SHARDED_PLAN = dict(TRAIN_PLAN, fsdp=True, tp=True, sp=True)
L, D, N_MICRO, MB = 8, 16, 6, 4


def ep_inputs():
    cfg = get_arch("dbrx-132b").smoke
    r = np.random.default_rng(11)
    layer = moe.MoE(cfg, torch.float32, "meta")
    weights = {n: (r.normal(size=tuple(p.shape)) * (0.006 if n == "router"
                                                    else 0.1)
                   ).astype(np.float32)
               for n, p in layer.named_parameters()}
    x = r.normal(size=(4, 16, cfg.d_model)).astype(np.float32)
    return weights, x


def pipe_inputs():
    r = np.random.default_rng(5)
    return ((r.normal(size=(L, D, D)) * 0.2).astype(np.float32),
            r.normal(size=(N_MICRO, MB, D)).astype(np.float32))


REF_PROG = """
import sys
import jax, jax.numpy as jnp, numpy as np
import repro
from repro.configs import get_arch
from repro.models.moe import _capacity, _dispatch_indices, moe_apply
from repro.train.pipeline import pipeline_apply, split_stages
d = np.load(sys.argv[1])
out = {}
cfg = get_arch("dbrx-132b").smoke
p = {k[2:]: jnp.asarray(d[k]) for k in d.files if k.startswith("w_")}
x = jnp.asarray(d["x"])
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
o, _ = moe_apply(cfg, p, x, mesh=mesh, ep=True, dp_spec="data",
                 compute_dtype=jnp.float32)
out["ep_out"] = np.asarray(o)
E, k = cfg.n_experts, cfg.n_experts_active
for i in range(2):   # each data shard's decisions, as the shard_map body
    x2d = x[2 * i:2 * i + 2].reshape(-1, cfg.d_model)
    logits = (x2d @ p["router"]).astype(jnp.float32)
    _, top_i = jax.lax.top_k(logits, k)
    cap = _capacity(x2d.shape[0], k, E,
                    factor=getattr(cfg, "moe_capacity_factor", 1.25))
    _, _, keep = _dispatch_indices(top_i.reshape(-1), E, cap)
    out[f"ids_{i}"] = np.asarray(top_i.reshape(-1))
    out[f"keep_{i}"] = np.asarray(keep)
    out[f"cap_{i}"] = np.asarray(cap)
smesh = jax.make_mesh((4,), ("stage",),
                      axis_types=(jax.sharding.AxisType.Auto,))
W, xm = jnp.asarray(d["W"]), jnp.asarray(d["xm"])
def stage_fn(w_group, x):
    def body(x, w):
        return jnp.tanh(x @ w), None
    x, _ = jax.lax.scan(body, x, w_group)
    return x
loss = lambda W: jnp.sum(pipeline_apply(stage_fn, split_stages(W, 4), xm,
                                        smesh) ** 2)
out["pipe_out"] = np.asarray(pipeline_apply(stage_fn, split_stages(W, 4),
                                            xm, smesh))
out["pipe_grad"] = np.asarray(jax.grad(loss)(W))
np.savez(sys.argv[2], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Every group run once: the JAX subprocess beside the port's ranks."""
    tmp = tmp_path_factory.mktemp("plans")
    weights, x = ep_inputs()
    W, xm = pipe_inputs()
    np.savez(tmp / "in.npz", x=x, W=W, xm=xm,
             **{f"w_{k}": v for k, v in weights.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_PROG),
         str(tmp / "in.npz"), str(tmp / "ref.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    batch = batch_of(QWEN, b=4, s=16)
    st = ref_state("qwen2.5-14b", TRAIN_PLAN)
    ckpt = str(tmp / "xlstm_ckpt")
    serve_tokens = np.random.default_rng(2).integers(
        0, QWEN.vocab_size, (2, 12)).astype(np.int64)
    try:
        out = {"four": spawn(ranks.four, 4, (
            (st, SHARDED_PLAN, batch), (weights, x), (W, xm), ckpt),
            device="cpu", timeout=240)}
        # the two and eight groups run on ``StagedGroup``, the card's
        # group, on host tensors here
        out["two"] = spawn(ranks.two, 2, (
            ("qwen2.5-14b", serve_tokens, 8, "float32"), ckpt),
            device="cpu", timeout=240, staged=True)
        g = np.random.default_rng(3).normal(size=(8, 4096)).astype(np.float32)
        e = (np.random.default_rng(4).normal(size=(8, 4096)) * 1e-2
             ).astype(np.float32)
        out["eight"] = spawn(ranks.compressed, 8, (g, e), device="cpu",
                             timeout=240, staged=True)
        stdout, stderr = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "OK" in stdout, stderr[-3000:]
    with np.load(tmp / "ref.npz") as f:
        out["ref"] = {k: f[k] for k in f.files}
    out["serve_tokens"] = serve_tokens
    out["batch"], out["state"] = batch, st
    return out


def test_sharded_train_step_matches_reference_single_device(groups):
    """fsdp + tp + sp on 2 × 2 at grad accumulation 2, AdamW, fp32 compute:
    the metrics and every parameter and optimizer leaf against the
    reference's single-device step from the same state."""
    jst, jmet = ref_step("qwen2.5-14b", tuple(TRAIN_PLAN.items()),
                         shapes_of(groups["batch"]))(groups["state"],
                                                     groups["batch"])
    tst, tmet = groups["four"]["train"]
    for key in ("loss", "ce", "tokens", "lr"):
        close(torch.tensor(tmet[key]), jmet[key], dict(rtol=1e-6, atol=0.0),
              key)
    close(torch.tensor(tmet["grad_norm"]), jmet["grad_norm"],
          dict(rtol=2e-5, atol=0.0))
    assert_states_close("qwen2.5-14b", tst, host(jst))


def test_tp_serving_matches_one_rank(groups, monkeypatch):
    """Prefill of 8 tokens and 3 teacher-forced decode steps under tp on
    1 × 2, fp32 compute, against the one-rank port's logits."""
    import repro_torch.serve.steps as steps
    monkeypatch.setattr(steps, "COMPUTE_DTYPE", torch.float32)
    want = ranks.serve_logits("qwen2.5-14b", groups["serve_tokens"], 8)
    got = groups["two"]["serve"]
    assert got.shape == want.shape == (2, 5, QWEN.vocab_size)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_expert_parallel_matches_reference_ep(groups):
    """dbrx-132b SMOKE's MoE layer under ep on 2 × 2: each rank's routing
    and kept mask (its data shard's tokens, capacity from their count)
    equal the reference's EP program's; the output matches its."""
    ref = groups["ref"]
    out, seen = groups["four"]["ep"]
    assert len(seen) == 4
    for rank, calls in enumerate(seen):
        data = rank // 2
        assert len(calls) == 1
        ids, keep, cap = calls[0]
        assert cap == int(ref[f"cap_{data}"])
        np.testing.assert_array_equal(ids, ref[f"ids_{data}"])
        np.testing.assert_array_equal(keep, ref[f"keep_{data}"])
    np.testing.assert_allclose(out.numpy(), ref["ep_out"], rtol=1e-5,
                               atol=1e-5)


def test_pipeline_matches_reference(groups):
    """4 stages, 6 microbatches: outputs and the gradient of sum(y²)
    against the reference's ``pipeline_apply`` and ``jax.grad``."""
    ref = groups["ref"]
    y, g = groups["four"]["pipeline"]
    np.testing.assert_allclose(y.numpy(), ref["pipe_out"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(g.numpy(), ref["pipe_grad"], rtol=1e-4,
                               atol=1e-5)


def test_compressed_psum_is_compressed_mean_bit_for_bit(groups):
    assert groups["eight"] == [(True, True)] * 8


def test_elastic_restore_from_four_ranks_at_two(groups):
    """xlstm-350m: 2 steps on 2 × 2, a checkpoint, resumed on 1 × 2 (every
    leaf restored bit for bit after the relayout) and 2 more steps."""
    shape4, got4, losses4, final4 = groups["four"]["xlstm"]
    shape2, got2, losses2, _ = groups["two"]["xlstm"]
    assert shape4 == (2, 2) and shape2 == (1, 2) and got4 is None
    assert int(got2["step"]) == int(final4["step"]) == 2

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    a, b = dict(leaves(final4)), dict(leaves(got2))
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert len(losses2) == 2 and all(np.isfinite(losses2))


def test_mesh_larger_than_the_world_raises(groups):
    assert "takes 4 ranks; the process group has 2" in groups["two"][
        "too_large"]


def test_train_cli_over_a_mesh_matches_one_rank(tmp_path):
    """``--data 2 --model 2 --smoke --device cpu``: four spawned ranks under
    the reference CLI's plan (tp over the model axis, the batch split over
    the data axis) give the one-rank run's loss after 3 steps."""
    common = ["--arch", "qwen2.5-14b", "--smoke", "--device", "cpu",
              "--steps", "3", "--batch", "4", "--seq", "16"]
    one = train_cli.main(common + ["--ckpt-dir", str(tmp_path / "one")])
    mesh = train_cli.main(common + ["--ckpt-dir", str(tmp_path / "mesh"),
                                    "--data", "2", "--model", "2"])
    assert mesh["step"] == one["step"] == 3
    assert abs(mesh["loss"] - one["loss"]) <= 1e-2 * abs(one["loss"])
    assert os.path.isdir(tmp_path / "mesh" / "step_00000002")
