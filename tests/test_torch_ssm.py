"""The port's SSM family held against the JAX package: the mLSTM and sLSTM
recurrences, the SSD scan (chunked and as one chunk), the Mamba2 block with
its one-token recurrence, and the two models built on them, xlstm-350m and
zamba2-2.7b (Mamba2 with a shared attention block), at their ``SMOKE``
sizes: forward, ``lm_loss``, prefill and decode from a carried cache with
every cache leaf, ``init_cache`` and the parameter carry-over. Helpers and
tolerances are ``tests/test_torch_families.py``'s.

The xLSTM's tolerance is another, with its reason: the reference rounds
every mLSTM and sLSTM step's output to bf16 whatever the compute dtype
(``_mlstm_step``, ``_slstm_step``), so an fp32 sum taken in another order
can move a step's output by one bf16 ulp (2⁻⁸ relative). Inside a block
such a flip stays one ulp (the recurrent state is fp32 and never rounded):
the scans' bf16 outputs are held to one ulp and their fp32 states to 1e-5.
Across blocks a flip is the next block's input perturbation and flips
more, so a whole model's outputs and states are held in aggregate: in fp32
the relative L2 error at most 2e-3 and at most 1% of the elements beyond
one ulp (4e-3) relative and absolute; in bf16 the relative L2 error at
most 1e-2 and at most 1% beyond bf16's 3e-2. Measured on these inputs:
relative L2 errors of 3e-4 to 1.1e-3 in fp32 and 1.5e-3 to 5.6e-3 in bf16,
at most 0.3% of the elements beyond."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import ssm as jssm
from repro_torch.configs import get_arch
from repro_torch.models import build_model, ssm
from repro_torch.serve import ServeEngine, init_cache

from test_torch_families import (BF16, FP32, as_written, batch_of,
                                 check_forward, check_init_cache, check_loss,
                                 check_params_round_trip, check_serving, close,
                                 np32, pair)

BF16_ULP = dict(rtol=2.0 ** -8, atol=2.0 ** -8)
XLSTM_FP32 = dict(rtol=4e-3, atol=4e-3, l2=2e-3, share=1e-2)
XLSTM_BF16 = dict(BF16, l2=1e-2, share=1e-2)
ARCHS = ["xlstm-350m", "zamba2-2.7b"]
XLSTM = get_arch("xlstm-350m").smoke
ZAMBA = get_arch("zamba2-2.7b").smoke


def jcfg(cfg):
    return JaxModelConfig(**dataclasses.asdict(cfg))


def fp32_tol(cfg):
    return XLSTM_FP32 if cfg.family == "ssm" else FP32


# ---------------------------------------------------------------------------
# the recurrences
# ---------------------------------------------------------------------------

def _mlstm_inputs(r, B=2, S=40, H=2, dk=16):
    q, k, v = (r.normal(size=(B, S, H, dk)).astype(np.float32)
               for _ in range(3))
    it = r.normal(size=(B, S, H)).astype(np.float32) * 3
    ft = -np.abs(r.normal(size=(B, S, H))).astype(np.float32)
    state = (np.zeros((B, H, dk, dk), np.float32),
             np.zeros((B, H, dk), np.float32),
             np.full((B, H), -1e30, np.float32))
    return (q, k, v, it, ft), state


@pytest.mark.parametrize("chunk", [8, 256])
def test_mlstm_scan_matches_reference(chunk):
    """Over 40 positions (chunks of 8, and one chunk as the fallback),
    from the −1e30 stabiliser and from a carried state."""
    r = np.random.default_rng(0)
    xs, state = _mlstm_inputs(r)
    tm = lambda t: jnp.swapaxes(jnp.asarray(t), 0, 1)
    for _ in range(2):
        (jC, jn, jm), jh = jax.jit(
            lambda s, x: jssm.chunked_scan(jssm._mlstm_step, s,
                                           tuple(map(tm, x)), chunk)
        )(tuple(map(jnp.asarray, state)), xs)
        (C, n, m), h = ssm.mlstm_scan(
            *(torch.from_numpy(t) for t in xs + state))
        assert h.dtype == torch.bfloat16
        np.testing.assert_allclose(np32(h), np32(jnp.swapaxes(jh, 0, 1)),
                                   **BF16_ULP)
        for got, want in ((C, jC), (n, jn), (m, jm)):
            np.testing.assert_allclose(np32(got), np32(want), rtol=1e-5,
                                       atol=1e-5)
        state = tuple(np.asarray(t) for t in (jC, jn, jm))


def test_slstm_scan_matches_reference():
    import functools
    r = np.random.default_rng(1)
    B, S, H, dh = 2, 40, 2, 16
    wx = r.normal(size=(B, S, 4 * H * dh)).astype(np.float32)
    rg = (r.normal(size=(H, dh, 4 * dh)) / 4).astype(np.float32)
    zeros = np.zeros((B, H, dh), np.float32)
    state = (zeros, zeros, zeros, np.full((B, H, dh), -1e30, np.float32))
    step = functools.partial(jssm._slstm_step, rg=jnp.asarray(rg), H=H, dh=dh)
    (jc, jn, jh, jm), jhs = jax.jit(
        lambda s, x: jssm.chunked_scan(step, s, jnp.swapaxes(x, 0, 1), 8)
    )(tuple(map(jnp.asarray, state)), jnp.asarray(wx))
    (c, n, h, m), hs = ssm.slstm_scan(torch.from_numpy(wx),
                                      torch.from_numpy(rg),
                                      *(torch.from_numpy(t) for t in state))
    assert hs.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(hs), np32(jnp.swapaxes(jhs, 0, 1)),
                               **BF16_ULP)
    for got, want in ((c, jc), (n, jn), (h, jh), (m, jm)):
        np.testing.assert_allclose(np32(got), np32(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("S", [512, 300])
def test_ssd_scan_matches_reference(S):
    """512 positions: two chunks of 256, the state carried between them;
    300: not a multiple of 256, so one chunk, as the reference falls
    back."""
    r = np.random.default_rng(2)
    B, H, p, s = 2, 4, 8, 16
    x = r.normal(size=(B, S, H, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.normal(size=(B, S, H)))).astype(np.float32) / 4
    A_log = r.normal(size=(H,)).astype(np.float32) / 2
    Bm, Cm = (r.normal(size=(B, S, s)).astype(np.float32) for _ in range(2))
    h0 = r.normal(size=(B, H, p, s)).astype(np.float32)
    args = (x, dt, A_log, Bm, Cm, h0)
    jy, jh = as_written(jssm.ssd_scan, *map(jnp.asarray, args))
    y, h = ssm.ssd_scan(*map(torch.from_numpy, args))
    np.testing.assert_allclose(np32(y), np32(jy), **FP32)
    np.testing.assert_allclose(np32(h), np32(jh), **FP32)


def test_causal_conv1d_matches_reference():
    r = np.random.default_rng(3)
    x = r.normal(size=(2, 9, 6)).astype(np.float32)
    w = r.normal(size=(4, 6)).astype(np.float32)
    st = r.normal(size=(2, 3, 6)).astype(np.float32)
    for state in (None, st):
        jy, js = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w), None,
                                    None if state is None
                                    else jnp.asarray(state))
        y, s = ssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                 None if state is None
                                 else torch.from_numpy(state))
        np.testing.assert_allclose(np32(y), np32(jy), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(np32(s), np32(js))


@pytest.mark.parametrize("S", [1, 5])
def test_mamba2_block_matches_reference_from_a_state(S):
    """One position takes the recurrent update, five the SSD scan; both
    from a nonzero state, which is written into the views in place."""
    cfg = ZAMBA
    _, params, tm = pair(cfg)
    lp = jax.tree_util.tree_map(lambda a: a[1], params["layers"])["mamba"]
    r = np.random.default_rng(4)
    x = r.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    din = cfg.ssm_expand * cfg.d_model
    H = din // cfg.ssm_head_dim
    state = {"conv_x": r.normal(size=(2, 3, din)),
             "conv_B": r.normal(size=(2, 3, cfg.ssm_state)),
             "conv_C": r.normal(size=(2, 3, cfg.ssm_state)),
             "h": r.normal(size=(2, H, cfg.ssm_head_dim, cfg.ssm_state))}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    jy, jst = as_written(
        lambda p, x, s: jssm.mamba2_block(jcfg(cfg), p, x, state=s,
                                          compute_dtype=jnp.float32),
        lp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()})
    views = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    with torch.no_grad():
        y, _ = tm.layers[1].mamba(torch.from_numpy(x), views, torch.float32)
    np.testing.assert_allclose(np32(y), np32(jy), **FP32)
    for name in state:
        np.testing.assert_allclose(np32(views[name]), np32(jst[name]),
                                   err_msg=name, **FP32)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_forward_matches_reference(dtype):
    check_forward(XLSTM, dtype,
                  XLSTM_FP32 if dtype == "float32" else XLSTM_BF16)


def test_xlstm_without_slstm_matches_reference():
    """slstm_every=0: one group of mLSTM blocks and no sLSTM stack."""
    check_forward(XLSTM.scaled(slstm_every=0), "float32", XLSTM_FP32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["pallas", "auto"])
def test_zamba2_forward_matches_reference(attn_impl, dtype):
    """The shared block's attention through the fused op ("pallas": the
    reference's kernel in interpret mode) and through ``sdpa``."""
    check_forward(ZAMBA.scaled(attn_impl=attn_impl), dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_reference(arch):
    cfg = get_arch(arch).smoke
    check_loss(cfg, dict(rtol=1e-4) if cfg.family == "ssm" else None)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """A prompt of 24 positions (the SSD as one chunk), then 8 decode steps
    (zamba2's Mamba2 layers by the recurrence, the shared block against its
    own KV slice a group), logits and every state."""
    cfg = get_arch(arch).smoke
    cache = check_serving(cfg, 24, fp32_tol(cfg))
    assert cache["index"] == 32


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    """Including the mLSTM and sLSTM stabilisers' −1e30."""
    check_init_cache(get_arch(arch).smoke)


def test_xlstm_cache_layout_is_the_references():
    """m_state stacks every mLSTM block in order (the reference concatenates
    its groups), s_state one sLSTM block a group (the reference stacks
    them); neither has a length."""
    tm = build_model(XLSTM, device="cpu")
    specs = tm.cache_specs(3, 1000)
    assert specs["m_state"]["C"].shape == (tm.n_mlstm, 3, 2, 64, 64)
    assert specs["s_state"]["h"].shape == (tm.n_slstm, 3, 2, 32)
    assert (tm.n_mlstm, tm.n_slstm, tm.groups) == (2, 2, 2)
    assert specs == tm.cache_specs(3, 7)
    cache = init_cache(tm, 3, 1)
    assert bool((cache["m_state"]["m"] == -1e30).all())
    assert bool((cache["s_state"]["m"] == -1e30).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_load_jax_params_round_trips(arch):
    check_params_round_trip(get_arch(arch).smoke)


def test_load_jax_params_refuses_a_mismatched_xlstm():
    from repro_torch.models.convert import load_jax_params
    _, params, _ = pair(XLSTM)
    with pytest.raises(ValueError, match="stacked layers"):
        load_jax_params(build_model(XLSTM.scaled(n_layers=6), device="cpu"),
                        params)
    with pytest.raises(KeyError, match="not in the reference tree"):
        load_jax_params(build_model(XLSTM, device="cpu"),
                        {k: v for k, v in params.items() if k != "slstm"})


def test_load_jax_cache_refuses_a_mismatched_state():
    from repro.serve.steps import init_cache as jax_init_cache
    from repro.models import build_model as jax_build_model
    from repro_torch.models.convert import load_jax_cache
    jm = jax_build_model(jcfg(XLSTM))
    tm = build_model(XLSTM, device="cpu")
    good = jax.tree_util.tree_map(np.asarray, jax_init_cache(jm, 2, 8))
    m_state = dict(good["m_state"])
    del m_state["n"]
    with pytest.raises(KeyError, match="m_state"):
        load_jax_cache(tm, dict(good, m_state=m_state))
    s_state = dict(good["s_state"], c=good["s_state"]["c"][:, :1])
    with pytest.raises(ValueError, match="s_state.c"):
        load_jax_cache(tm, dict(good, s_state=s_state))
    # bf16 is taken into an fp32 spec only where the reference returns the
    # compute type (the mLSTM conv states), not in the sLSTM states
    as_bf16 = np.asarray(jnp.asarray(good["s_state"]["c"], jnp.bfloat16))
    with pytest.raises(ValueError, match="s_state.c: reference type"):
        load_jax_cache(tm, dict(good, s_state=dict(good["s_state"],
                                                   c=as_bf16)))
    conv = np.asarray(jnp.asarray(good["m_state"]["conv"], jnp.bfloat16))
    carried = load_jax_cache(tm, dict(good, m_state=dict(good["m_state"],
                                                         conv=conv)))
    assert carried["m_state"]["conv"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_cache_free_forward(arch):
    """Each decode step's logits equal the cache-free forward's at that
    position (fp32), after a prefill of 12 positions."""
    cfg = get_arch(arch).smoke
    tm = build_model(cfg, device="cpu", rng=0)
    toks = torch.from_numpy(batch_of(cfg, seed=6)["tokens"][:, :20])
    with torch.no_grad():
        full, _ = tm({"tokens": toks}, compute_dtype=torch.float32)
        cache = init_cache(tm, 2, 24, dtype=torch.float32)
        logits, cache = tm.prefill({"tokens": toks[:, :12]}, cache,
                                   compute_dtype=torch.float32)
        close(logits, full[:, :12], fp32_tol(cfg), "prefill")
        for t in range(12, 20):
            logits, cache = tm.decode_step(cache, toks[:, t:t + 1],
                                           compute_dtype=torch.float32)
            close(logits[:, 0], full[:, t], fp32_tol(cfg), f"step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generates_the_greedy_tokens(arch):
    """``ServeEngine.generate`` in bf16: each token is the argmax of the
    cache-free forward over the sequence so far, wherever that forward's
    top two logits are more than 0.05 apart."""
    cfg = get_arch(arch).smoke
    tm = build_model(cfg, param_dtype=torch.bfloat16, device="cpu", rng=0)
    prompts = batch_of(cfg, seed=7)["tokens"][:, :8]
    engine = ServeEngine(tm, batch_size=2, max_seq=16, device="cpu")
    out, ops = engine.generate(prompts, 4)
    assert out.shape == (2, 4) and ops == 0.0
    seq = torch.from_numpy(prompts.astype(np.int64))
    with torch.no_grad():
        for t in range(4):
            logits, _ = tm({"tokens": seq})
            last = logits[:, -1].float()
            top2 = torch.topk(last, 2).values
            sure = (top2[:, 0] - top2[:, 1]) > 0.05
            want = torch.argmax(last, -1)
            got = torch.from_numpy(out[:, t]).long()
            assert bool((got[sure] == want[sure]).all()), t
            seq = torch.cat([seq, got[:, None]], 1)
