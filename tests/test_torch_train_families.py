"""One train step of every model family besides the dense LM, the port's
against the JAX package's, at each arch's SMOKE size: deepseek-v3-671b
(MLA, the shared expert, the sigmoid router, ``aux`` and ``mtp_ce`` in the
gradient), dbrx-132b, zamba2-2.7b, xlstm-350m, qwen2-vl-2b (on
``embeds`` and ``positions3``) and whisper-base (on ``frames``).

Each runs its published plan on one device (the MoE archs Adafactor, the
others AdamW) at fp32 parameters and fp32 compute, grad accumulation 1,
from the reference's state carried across (``test_torch_train``'s helpers:
AdamW's v at 0.01, so its step is linear in the gradient). Held: every
metric at rtol 1e-6 (grad_norm at GRAD_NORM_RTOL), then every parameter
and optimizer leaf after the step at ``LEAF_REL`` of the leaf's largest
entry. zamba2's gradients differ from the reference's at 2e-4 relative
(the SSD's exponentials of cumulative sums amplify rounding), so its
leaves are held at 2e-3; whisper-base's at 8e-5 (a bidirectional encoder
and cross-attention ahead of the decoder), held at 5e-4. The xLSTM is held in aggregate (ROADMAP.md
Queue 3 item 4): its update's relative L2 error over the model below
1e-3. The MoE archs' top-k expert ids are first held equal on both sides
on the step's batch, each token's k-th score above its (k+1)-th by more
than 1e-6, so the gradients compared flow through the same experts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models import moe

from test_torch_families import batch_of, close, np32
from test_torch_train import (assert_states_close, host, plan_of, port_step,
                              ref_model, ref_state, ref_step, shapes_of,
                              to_torch)

ARCHS = ["deepseek-v3-671b", "dbrx-132b", "zamba2-2.7b", "xlstm-350m",
         "qwen2-vl-2b", "whisper-base"]
LEAF_REL = {"zamba2-2.7b": 2e-3, "whisper-base": 5e-4}
GRAD_NORM_RTOL = {"zamba2-2.7b": 5e-4, "xlstm-350m": 1e-3,
                  "whisper-base": 2e-4}


def assert_same_routing(arch: str, plan: dict, batch: dict, monkeypatch):
    """The reference's top-k ids (recorded through ``jax.lax.top_k`` in an
    fp32 forward from the step's fp32 parameters) against the port's
    (through ``moe.route``) on the step's batch, layer by layer."""
    cfg = get_arch(arch).smoke
    k = cfg.n_experts_active
    want, real_top_k = [], jax.lax.top_k

    def top_k(x, kk):
        w, i = real_top_k(x, kk)
        jax.debug.callback(lambda a: want.append(np.asarray(a)), i,
                           ordered=True)
        return w, i

    monkeypatch.setattr(jax.lax, "top_k", top_k)
    params = ref_state(arch, plan)["params"]
    inputs = {k_: v for k_, v in batch.items() if k_ != "labels"}
    jax.jit(lambda p, b: ref_model(arch).apply(
        p, b, remat="none", compute_dtype=jnp.float32))(params, inputs)
    jax.effects_barrier()
    monkeypatch.setattr(jax.lax, "top_k", real_top_k)
    got, gaps, real_route = [], [], moe.route

    def route(c, logits):
        w, i = real_route(c, logits)
        scores = torch.sigmoid(logits) if c.router_type == "sigmoid" \
            else logits
        top = torch.sort(scores, dim=-1, descending=True).values
        gaps.append(float((top[:, k - 1] - top[:, k]).min()))
        got.append(i.numpy())
        return w, i

    monkeypatch.setattr(moe, "route", route)
    model, _, _ = port_step(arch, plan, ref_state(arch, plan))
    with torch.no_grad():
        model(to_torch(inputs), compute_dtype=torch.float32)
    monkeypatch.setattr(moe, "route", real_route)
    assert len(got) == len(want) == cfg.n_layers - cfg.first_dense_layers
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert min(gaps) > 1e-6, gaps


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, monkeypatch):
    cfg = get_arch(arch).smoke
    plan = plan_of(arch, grad_accum=1, param_dtype="float32",
                   compute_dtype="float32")
    batch = batch_of(cfg)
    if cfg.family == "moe":
        assert_same_routing(arch, plan, batch, monkeypatch)
    st = ref_state(arch, plan)
    jst, jmet = ref_step(arch, tuple(plan.items()), shapes_of(batch))(
        st, batch)
    model, tst, fn = port_step(arch, plan, st)
    before = {n: p.detach().clone() for n, p in tst["params"].items()}
    tst, tmet = fn(tst, to_torch(batch))
    assert set(tmet) == set(jmet)
    if cfg.family == "moe":
        assert {"aux", "mtp_ce"} & set(tmet)
    for key in tmet:
        rtol = GRAD_NORM_RTOL.get(arch, 2e-5) if key == "grad_norm" else \
            (1e-4 if arch == "xlstm-350m" else 1e-6)
        close(tmet[key], jmet[key], dict(rtol=rtol, atol=0.0), key)
    if arch != "xlstm-350m":
        assert_states_close(arch, tst, host(jst), LEAF_REL.get(arch, 1e-4))
        return
    # the xLSTM in aggregate: the update over the whole model
    from repro_torch.models import build_model
    from repro_torch.models.convert import load_jax_train_state
    want = load_jax_train_state(build_model(cfg, device="cpu"), host(jst))
    num = den = 0.0
    for n, p in tst["params"].items():
        d_got = np32(p) - np32(before[n])
        d_want = np32(want["params"][n]) - np32(before[n])
        num += float(np.sum((d_got - d_want) ** 2))
        den += float(np.sum(d_want ** 2))
    assert (num / den) ** 0.5 < 1e-3
    assert int(tst["step"]) == int(want["step"])
