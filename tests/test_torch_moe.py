"""The port's MoE family held against the JAX package: the capacity rule,
the sort-based dispatch and the router's top-k bit for bit (ties
included), a sliced MoE layer, MLA in its expanded and absorbed forms, and
the two models built on them, deepseek-v3-671b (MLA, a shared expert, a
sigmoid router, MTP) and dbrx-132b (GQA, softmax router), at their
``SMOKE`` sizes: forward, ``lm_loss`` with its aux and MTP terms, prefill
and decode from a carried cache, ``init_cache`` and the carry-over of
parameters and caches. Helpers and tolerances are
``tests/test_torch_families.py``'s.

dbrx's SMOKE config drops tokens (capacity factor 1.25 at 4 experts top-2)
and deepseek's is dropless (factor E/k = 4): every comparison routes the
same token set on both sides, so both drop the same pairs. In bf16 one
router flip (a near-tie of two bf16 logits rounded another way) moves a
whole token, so the bf16 forwards are held in aggregate: at most 2% of the
logits beyond bf16's 3e-2, and the relative L2 error at most 3e-2."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import moe as jmoe
from repro.sharding.spec import init_params
from repro_torch.configs import get_arch
from repro_torch.configs.base import ParallelPlan
from repro_torch.models import build_model, moe
from repro_torch.serve import init_cache, make_decode_step, make_prefill_step

from test_torch_families import (BF16, FP32, DTYPES, as_written, batch_of,
                                 check_init_cache, check_loss,
                                 check_params_round_trip, check_serving,
                                 close, np32, pair, to_jax, to_torch)

ARCHS = ["deepseek-v3-671b", "dbrx-132b"]
DEEPSEEK = get_arch("deepseek-v3-671b").smoke
DBRX = get_arch("dbrx-132b").smoke
MOE_BF16 = dict(BF16, l2=3e-2, share=2e-2)


def jcfg(cfg):
    return JaxModelConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def cached_pair(arch: str, attn_impl: str = "auto"):
    """``pair`` once per (arch, attn_impl) for the whole module."""
    return pair(get_arch(arch).smoke.scaled(attn_impl=attn_impl))


@torch.no_grad()
def carry(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """A reference parameter subtree copied into ``module``'s parameters of
    the same paths (every one filled)."""
    named = dict(module.named_parameters())

    def walk(sub, prefix=""):
        for key, leaf in sub.items():
            if isinstance(leaf, dict):
                yield from walk(leaf, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", leaf

    leaves = dict(walk(tree))
    assert set(leaves) == set(named)
    for name, leaf in leaves.items():
        named[name].copy_(torch.from_numpy(np.array(leaf, np.float32)))
    return module


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    from repro.configs import get_arch as jax_get_arch
    ours, theirs = get_arch(arch), jax_get_arch(arch)
    for field in ("config", "plan", "smoke"):
        assert (dataclasses.asdict(getattr(ours, field))
                == dataclasses.asdict(getattr(theirs, field)))


# ---------------------------------------------------------------------------
# dispatch and routing, bit for bit
# ---------------------------------------------------------------------------

def test_capacity_matches_reference():
    grid = [(T, k, E, f) for T in (1, 2, 7, 32, 100, 4096)
            for k, E in ((1, 4), (2, 4), (4, 16), (8, 256))
            for f in (1.0, 1.25, 2.0, E / k)]
    for T, k, E, f in grid:
        assert moe.capacity(T, k, E, factor=f) == jmoe._capacity(
            T, k, E, factor=f), (T, k, E, f)
    # the floor, and the floor's own argument
    assert moe.capacity(1, 1, 256) == jmoe._capacity(1, 1, 256) == 4
    assert moe.capacity(3, 1, 8, floor=1) == jmoe._capacity(3, 1, 8,
                                                            floor=1) == 1
    # dropless at E/k: every expert holds all the tokens
    assert moe.capacity(4096, 8, 256, factor=256 / 8) == 4096


@settings(max_examples=25, deadline=None)
@given(st.sampled_from([1, 6, 31, 96]), st.sampled_from([1, 3, 8, 16]),
       st.sampled_from([1, 2, 5, 12]),
       st.sampled_from(["random", "equal", "skewed"]), st.integers(0, 999))
def test_dispatch_indices_match_reference(N, E, cap, kind, seed):
    """``order``, ``dest`` and ``keep`` equal the reference's: random ids,
    all ids equal, and ids skewed onto two experts (over-full ones). A few
    sizes each, so the reference's ops compile once a size."""
    r = np.random.default_rng(seed)
    if kind == "equal":
        ids = np.full(N, r.integers(0, E))
    elif kind == "skewed":
        ids = r.choice([0, E - 1], size=N, p=[0.8, 0.2])
    else:
        ids = r.integers(0, E, N)
    ids = ids.astype(np.int32)
    want = [np.asarray(a) for a in jmoe._dispatch_indices(jnp.asarray(ids),
                                                          E, cap)]
    got = [np.asarray(a) for a in moe.dispatch_indices(
        torch.from_numpy(ids.astype(np.int64)), E, cap)]
    for name, g, w in zip(("dest", "order", "keep"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def _reference_route(cfg, logits):
    """The reference's router lines (``_moe_local``: top-k of the sigmoid
    scores normalised, or a softmax over the top-k logits)."""
    k = cfg.n_experts_active
    if cfg.router_type == "sigmoid":
        top_w, top_i = jax.lax.top_k(jax.nn.sigmoid(logits), k)
        top_w = top_w / (jnp.sum(top_w, -1, keepdims=True) + 1e-9)
    else:
        top_w, top_i = jax.lax.top_k(logits, k)
        top_w = jax.nn.softmax(top_w, axis=-1)
    return np.asarray(top_w), np.asarray(top_i)


@pytest.mark.parametrize("router", ["sigmoid", "softmax"])
def test_router_topk_breaks_ties_as_reference(router):
    """bf16-valued logits over 256 experts with ties planted across the
    k-th place, all-equal rows, and ±0: the same ids and weights as
    ``jax.lax.top_k``."""
    cfg = get_arch("deepseek-v3-671b").config.scaled(router_type=router)
    r = np.random.default_rng(3)
    logits = r.normal(size=(64, 256)).astype(np.float32) * 0.5
    logits = np32(torch.from_numpy(logits).to(torch.bfloat16))
    for row in range(0, 48, 3):
        ids = np.argsort(-logits[row], kind="stable")
        logits[row, ids[5:12]] = logits[row, ids[7]]   # a tie at the k-th
    logits[50] = 0.25
    logits[51, ::2] = 0.0
    logits[51, 1::2] = -0.0
    logits[52, 200:] = logits[52].max()                # ties above the k
    logits[53, :4] = [np.nan, np.inf, -np.inf, np.nan]
    want_w, want_i = _reference_route(cfg, jnp.asarray(logits))
    got_w, got_i = moe.route(cfg, torch.from_numpy(logits))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=1e-6, atol=0)


def test_switch_aux_matches_reference():
    r = np.random.default_rng(4)
    logits = r.normal(size=(40, 16)).astype(np.float32)
    top_i = np.argsort(-logits, axis=-1, kind="stable")[:, :4]
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    frac = jnp.mean(jax.nn.one_hot(top_i[:, 0], 16, dtype=jnp.float32), 0)
    want = float(16 * jnp.sum(frac * jnp.mean(probs, axis=0)))
    got = float(moe.switch_aux(torch.from_numpy(logits),
                               torch.from_numpy(top_i)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# one MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,chunk", [("dbrx-132b", 8),
                                        ("deepseek-v3-671b", 8),
                                        ("dbrx-132b", 12)])
def test_moe_layer_matches_reference(arch, chunk):
    """``MoE.local`` against ``_moe_local`` on 32 tokens in fp32: sliced
    into chunks of 8 (each chunk routed, dropped and combined on its own,
    the aux their mean), and at chunk 12, which does not divide 32 and so
    dispatches the 32 at once; then ``MoE`` (the shared expert added)
    against ``moe_apply``."""
    cfg = get_arch(arch).smoke.scaled(moe_seq_chunk=chunk)
    params = jax.tree_util.tree_map(np.asarray, init_params(
        jmoe.moe_specs(jcfg(cfg), jnp.float32), jax.random.PRNGKey(1)))
    layer = carry(moe.MoE(cfg, torch.float32, "cpu"), params)
    x = np.random.default_rng(5).normal(size=(2, 16, cfg.d_model)).astype(
        np.float32)
    want, want_aux = jax.jit(lambda p, t: jmoe._moe_local(
        jcfg(cfg), p, t, ep_axis=None, compute_dtype=jnp.float32))(
            params, jnp.asarray(x.reshape(32, -1)))
    with torch.no_grad():
        got, aux = layer.local(torch.from_numpy(x.reshape(32, -1)),
                               torch.float32)
        full, full_aux = layer(torch.from_numpy(x), torch.float32)
    close(got, want, FP32, "moe_local")
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    want, want_aux = jax.jit(lambda p, t: jmoe.moe_apply(
        jcfg(cfg), p, t, compute_dtype=jnp.float32))(params, jnp.asarray(x))
    close(full, want, FP32, "moe_apply")
    np.testing.assert_allclose(float(full_aux), float(want_aux), rtol=1e-5)


def test_moe_layer_is_deterministic_and_drops_as_reference():
    """At factor 1.25 some pairs drop; two calls give the same bits, and
    the dropped pairs are the reference's (the outputs agree)."""
    cfg = DBRX.scaled(moe_seq_chunk=0)
    params = jax.tree_util.tree_map(np.asarray, init_params(
        jmoe.moe_specs(jcfg(cfg), jnp.float32), jax.random.PRNGKey(2)))
    layer = carry(moe.MoE(cfg, torch.float32, "cpu"), params)
    # tokens leaning toward expert 0, which overflows its 40 slots
    lean = params["router"][:, 0] / np.linalg.norm(params["router"][:, 0])
    x = torch.from_numpy((np.random.default_rng(6).normal(
        size=(64, cfg.d_model)) + 40.0 * lean).astype(np.float32))
    with torch.no_grad():
        logits = layer.router_logits(x, torch.float32)
        _, top_i = moe.route(cfg, logits)
        cap = moe.capacity(64, cfg.n_experts_active, cfg.n_experts)
        _, _, keep = moe.dispatch_indices(top_i.reshape(-1), cfg.n_experts,
                                          cap)
        a, b = layer.local(x, torch.float32), layer.local(x, torch.float32)
    assert int((~keep).sum()) > 0
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    want, _ = jax.jit(lambda p, t: jmoe._moe_local(
        jcfg(cfg), p, t, ep_axis=None, compute_dtype=jnp.float32))(
            params, jnp.asarray(x.numpy()))
    close(a[0], want, FP32, "moe_local with drops")


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla():
    """deepseek's SMOKE MLA: reference parameters, the port's module with
    them, and an input (2, 12, d) with its positions."""
    cfg = DEEPSEEK
    params = jax.tree_util.tree_map(np.asarray, init_params(
        jmoe.mla_specs(jcfg(cfg), jnp.float32), jax.random.PRNGKey(0)))
    module = carry(moe.MLAttention(cfg, torch.float32, "cpu"), params)
    x = np.random.default_rng(7).normal(size=(2, 12, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12)).astype(np.int32)
    return cfg, params, module, x, pos


def test_mla_absorbed_matches_expanded(mla):
    """The reference's own check (``tests/test_models.py``), on the port."""
    cfg, _, module, x, pos = mla
    with torch.no_grad():
        e, _ = module(torch.from_numpy(x), torch.from_numpy(pos),
                      compute_dtype=torch.float32, absorbed=False)
        a, _ = module(torch.from_numpy(x), torch.from_numpy(pos),
                      compute_dtype=torch.float32, absorbed=True)
    np.testing.assert_allclose(np32(a), np32(e), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("absorbed", [False, True])
def test_mla_matches_reference(mla, absorbed):
    cfg, params, module, x, pos = mla
    want, _ = jax.jit(lambda p, t, q: jmoe.mla_attention(
        jcfg(cfg), p, t, q, absorbed=absorbed, compute_dtype=jnp.float32))(
            params, jnp.asarray(x), jnp.asarray(pos))
    with torch.no_grad():
        got, _ = module(torch.from_numpy(x), torch.from_numpy(pos),
                        compute_dtype=torch.float32, absorbed=absorbed)
    close(got, want, FP32, f"mla absorbed={absorbed}")


def test_mla_absorbed_decode_from_a_cache_matches_reference(mla):
    """Eight prompt positions written into an fp32 cache, then two steps
    in the absorbed form: outputs and both cache leaves."""
    cfg, params, module, x, pos = mla
    B, L = 2, 16
    jc = (jnp.zeros((B, L, cfg.kv_lora_rank)),
          jnp.zeros((B, L, 1, cfg.qk_rope_dim)))
    tc = tuple(torch.zeros(c.shape) for c in jc)
    for start, stop in ((0, 8), (8, 9), (9, 10)):
        absorbed = start > 0
        want, jc = jax.jit(lambda p, t, q, c: jmoe.mla_attention(
            jcfg(cfg), p, t, q, cache=c, cache_index=start,
            compute_dtype=jnp.float32, absorbed=absorbed))(
                params, jnp.asarray(x[:, start:stop]),
                jnp.asarray(pos[:, start:stop]), jc)
        with torch.no_grad():
            got, tc = module(torch.from_numpy(x[:, start:stop]),
                             torch.from_numpy(pos[:, start:stop]),
                             compute_dtype=torch.float32, cache=tc,
                             cache_index=start, absorbed=absorbed)
        close(got, want, FP32, f"mla at {start}")
    for g, w in zip(tc, jc):
        close(g, w, FP32, "mla cache", scale=True)


# ---------------------------------------------------------------------------
# the two models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,attn_impl", [("deepseek-v3-671b", "auto"),
                                            ("dbrx-132b", "pallas"),
                                            ("dbrx-132b", "auto")])
def test_forward_matches_reference(arch, attn_impl, dtype):
    """The cache-free forward's logits. "pallas": dbrx's attention through
    the reference's Pallas kernel in interpret mode against the port's
    fused op (its plain version on the CPU); MLA takes the plain ``sdpa``
    under either ``attn_impl``, so deepseek runs "auto" alone. fp32
    elementwise, bf16 in aggregate (module docstring)."""
    jdt, tdt, _ = DTYPES[dtype]
    jm, params, tm = cached_pair(arch, attn_impl)
    batch = {"tokens": batch_of(tm.cfg)["tokens"]}
    jl, _ = as_written(lambda p, b: jm.apply(p, b, remat="none",
                                             compute_dtype=jdt),
                       params, to_jax(batch))
    with torch.no_grad():
        tl, cache = tm(to_torch(batch), compute_dtype=tdt)
    assert cache is None and tl.dtype == tdt
    close(tl, jl, FP32 if dtype == "float32" else MOE_BF16, "logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_reference(arch):
    """ce, aux (over the MoE layers), mtp_ce (deepseek) and the total at
    1e-5 relative in fp32."""
    check_loss(get_arch(arch).smoke, models=cached_pair(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """A prompt of 28, then 4 steps from the carried cache (deepseek's
    absorbed), logits and every cache leaf."""
    check_serving(get_arch(arch).smoke, 28, models=cached_pair(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    check_init_cache(get_arch(arch).smoke)


@pytest.mark.parametrize("arch", ARCHS)
def test_load_jax_params_round_trips(arch):
    check_params_round_trip(get_arch(arch).smoke, models=cached_pair(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_topk_ids_match_reference(arch, monkeypatch):
    """Each MoE layer's top-k expert ids in an fp32 forward, the
    reference's (recorded through ``jax.lax.top_k``) against the port's
    (through ``moe.route``), equal at this seed; each token's gap between
    its k-th and (k+1)-th score is above 1e-6, so a later flip reads as a
    near-tie, not as a fault."""
    jm, params, tm = cached_pair(arch)
    cfg = tm.cfg
    k = cfg.n_experts_active
    batch = {"tokens": batch_of(cfg)["tokens"]}
    want = []
    real_top_k = jax.lax.top_k

    def top_k(x, kk):
        w, i = real_top_k(x, kk)
        jax.debug.callback(lambda a: want.append(np.asarray(a)), i,
                           ordered=True)
        return w, i

    monkeypatch.setattr(jax.lax, "top_k", top_k)
    jax.jit(lambda p, b: jm.apply(p, b, remat="none",
                                  compute_dtype=jnp.float32))(
        params, to_jax(batch))
    jax.effects_barrier()
    monkeypatch.setattr(jax.lax, "top_k", real_top_k)
    got, gaps = [], []
    real_route = moe.route

    def route(c, logits):
        w, i = real_route(c, logits)
        scores = torch.sigmoid(logits) if c.router_type == "sigmoid" \
            else logits
        top = torch.sort(scores, dim=-1, descending=True).values
        gaps.append(float((top[:, k - 1] - top[:, k]).min()))
        got.append(i.numpy())
        return w, i

    monkeypatch.setattr(moe, "route", route)
    with torch.no_grad():
        tm(to_torch(batch), compute_dtype=torch.float32)
    assert len(got) == len(want) == cfg.n_layers - cfg.first_dense_layers
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert min(gaps) > 1e-6, gaps


def test_ep_plan_raises(tmp_path):
    """Expert parallelism (once refused) runs: under ``ep=True`` over a
    one-rank mesh the steps give the one-device logits (the two-rank
    all-to-alls: tests/test_torch_plans.py); a mesh larger than the world
    raises."""
    from test_torch_plan_ranks import one_rank_group
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.steps import place_model
    tm = build_model(DBRX, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, DBRX.vocab_size, (2, 6)))
    want, _ = make_prefill_step(tm)({"tokens": toks}, init_cache(tm, 2, 8))
    plan = ParallelPlan(tp=False, ep=True)
    with one_rank_group(str(tmp_path)) as mesh:
        sm = place_model(build_model(DBRX, device="cpu"), plan, mesh)
        got, cache = make_prefill_step(sm, plan, mesh)(
            {"tokens": toks}, init_cache(sm, 2, 8, mesh=mesh, plan=plan))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        nxt, _, _ = make_decode_step(sm, plan, mesh)(cache, toks[:, -1:])
        assert nxt.shape == (2, 1)
        with pytest.raises(ValueError, match="takes 2 ranks"):
            make_host_mesh(2, 1)


def test_moe_experts_draw_one_slice_at_a_time():
    """The experts are drawn a slice along the first axis at a time, each
    slice at the fan-in rule's std (1/√d for wi_*, 1/√f for wo); the
    router at 0.006."""
    cfg = DEEPSEEK.scaled(d_model=256, moe_d_ff=128, n_experts=16)
    tm = build_model(cfg, device="cpu", rng=3)
    layer = tm.layers[0].moe
    assert layer.wi_gate.by_slice and not layer.router.by_slice
    for w, fan_in in ((layer.wi_gate, 256), (layer.wi_up, 256),
                      (layer.wo, 128)):
        std = w.std(dim=(1, 2))
        assert torch.allclose(std, torch.full_like(std, fan_in ** -0.5),
                              rtol=0.05)
        assert not torch.equal(w[0], w[1])
    assert abs(float(layer.router.std()) - 0.006) < 0.0006
