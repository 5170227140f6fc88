"""The port's serving stack held against the JAX package on the CPU: the
attention's KV-cache branches (``sdpa`` with ``kv_valid_len``, the int8
cache's ``quantize_kv`` / ``dequantize_kv``), ``DenseLM``'s cache layout,
``prefill`` and ``decode_step``, ``load_jax_cache``, ``lm_batch``, the
kNN-LM ``ServeEngine`` (``_knn_logits``, ``generate`` with and without the
hook, ``index_append``) and the serving CLI.

Everything runs at qwen2.5-14b's smoke config (2 layers, d 64, V 256) with
the reference's parameters (``init_params`` from ``PRNGKey(0)``) carried
across by ``load_jax_params``. Tolerances: fp32 compute at rtol/atol 1e-4
(sums in another order), fp32 ``sdpa`` at 1e-5; quantization bit for bit;
bf16 logits at 3e-2, the reference's own bf16 tolerance. The bf16 engines
(the reference compiled with XLA's excess precision off, so its casts round
where its code puts them) must pick the same greedy tokens at every step
whose top two log-probabilities stand further apart than the two packages'
logits differ there; past a closer step the two may part, and the
comparison stops there. The retrieval replays
the reference's draws (``test_torch_replay.replay_sampler``), one key a
decode step as the reference's ``generate`` splits them."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Index as JaxIndex
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import BMOConfig as JaxBMOConfig
from repro.data import synthetic as jsynthetic
from repro.launch import serve as jax_serve_cli
from repro.models import build_model as jax_build_model
from repro.models import common as jcm
from repro.serve.engine import KNNLMConfig as JaxKNNLMConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.steps import init_cache as jax_init_cache
from repro.sharding.spec import init_params
from repro_torch.api import Index
from repro_torch.configs import get_arch
from repro_torch.configs.base import BMOConfig
from repro_torch.data.synthetic import lm_batch
from repro_torch.index.store import IndexStore
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.models import common as cm
from repro_torch.models.convert import load_jax_cache, load_jax_params
from repro_torch.serve import (KNNLMConfig, ServeEngine, init_cache,
                               make_decode_step, make_prefill_step)
from repro_torch.serve.engine import step_seeds

from test_torch_replay import carry, replay_sampler

FP32 = dict(rtol=1e-4, atol=1e-4)
SDPA = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
BF16_MARGIN = 0.06          # twice the bf16 logit tolerance
SMOKE = get_arch("qwen2.5-14b").smoke


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _jnp32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _models(cfg=SMOKE):
    """The reference model with its parameters from PRNGKey(0), and the
    port's model on the CPU holding the same parameters."""
    from repro.configs.base import ModelConfig as JaxModelConfig
    jm = jax_build_model(JaxModelConfig(**dataclasses.asdict(cfg)))
    params = jax.tree_util.tree_map(
        np.asarray, init_params(jm.param_specs(), jax.random.PRNGKey(0)))
    tm = load_jax_params(build_model(cfg, device="cpu"), params)
    return jm, params, tm


# ---------------------------------------------------------------------------
# attention: sdpa with a cache, KV quantization, the cache branches
# ---------------------------------------------------------------------------

def _bf16_rows(shape, seed):
    """bf16 (B, S, H, D) values with an all-zero row and a row of ±amax
    ties (round half to even at ±0.5 after scaling)."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 3
    x[0, 1, 0] = 0.0
    x[-1, -1, -1] = np.linspace(-127, 127, shape[-1]) / 2.0
    return torch.from_numpy(x).to(torch.bfloat16)


def test_quantize_kv_is_the_reference_bit_for_bit():
    t = _bf16_rows((2, 5, 3, 16), 0)
    q, s = cm.quantize_kv(t)
    jq, js = jcm.quantize_kv(jnp.asarray(_np(t), jnp.bfloat16))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(s), _jnp32(js))
    assert float(s[0, 1, 0]) == 1.0 and not q[0, 1, 0].any()
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        got = cm.dequantize_kv(q, s, dtype)
        want = jcm.dequantize_kv(jq, js, jdtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(_np(got), _jnp32(want))


@pytest.mark.parametrize("Sk,Sq,q_offset,valid", [
    (40, 3, 20, 23),          # a decode-like step: the direct branch
    (40, 40, 0, None),        # causal only
    (3072, 16, 2000, 2016),   # Sk > 2048 and Sq > 8: the flash branch
    (3072, 16, 0, 1500),      # flash, a cache longer than the prompt
])
def test_sdpa_with_kv_valid_len_matches_reference(Sk, Sq, q_offset, valid):
    r = np.random.default_rng(Sk + Sq)
    q = r.normal(size=(2, Sq, 4, 8)).astype(np.float32)
    k = r.normal(size=(2, Sk, 2, 8)).astype(np.float32)
    v = r.normal(size=(2, Sk, 2, 8)).astype(np.float32)
    got = cm.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v), causal=True, q_offset=q_offset,
                  kv_valid_len=valid)
    want = jcm.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True, q_offset=q_offset, kv_valid_len=valid)
    np.testing.assert_allclose(_np(got), np.asarray(want), **SDPA)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_attention_cache_branches_match_reference(kv_quant):
    """One layer's attention over a cache holding 5 earlier positions:
    the output and every cache entry after the write of 3 more."""
    cfg = SMOKE.scaled(kv_quant=kv_quant)
    jm, params, tm = _models(cfg)
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                               params["layers"]["attn"])
    B, S, idx, T = 2, 3, 5, 12
    r = np.random.default_rng(1)
    x = r.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S) + idx, (B, S))
    prior = r.normal(size=(B, T, cfg.n_kv_heads, cfg.head_dim_))
    if kv_quant:
        kq, ks = jcm.quantize_kv(jnp.asarray(prior, jnp.bfloat16))
        jkv = ((kq, ks), (kq, ks))
        tkv = tuple((torch.from_numpy(np.array(kq)),
                     torch.from_numpy(np.array(_jnp32(ks))).to(
                         torch.bfloat16))
                    for _ in range(2))
    else:
        jkv = (jnp.asarray(prior, jnp.float32),) * 2
        tkv = tuple(torch.from_numpy(prior.astype(np.float32))
                    for _ in range(2))
    jout, jnew = jcm.gqa_attention(cfg, p, jnp.asarray(x), jnp.asarray(pos),
                                   cache_kv=jkv, cache_index=idx,
                                   compute_dtype=jnp.float32)
    out, new = tm.layers[0].attn(torch.from_numpy(x),
                                 torch.from_numpy(pos.copy()),
                                 compute_dtype=torch.float32, cache_kv=tkv,
                                 cache_index=idx)
    np.testing.assert_allclose(_np(out), np.asarray(jout), **FP32)
    got = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(_np, new, is_leaf=torch.is_tensor))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(_jnp32, jnew))
    assert len(got) == len(want) == (4 if kv_quant else 2)
    for g, w in zip(got, want):
        if kv_quant and g.ndim == 4:        # int8 values: a rounding step
            assert np.abs(g - w).max() <= 1 and (g == w).mean() > 0.99
        else:
            np.testing.assert_allclose(g, w, **FP32)
    # the write went in place, into the tensors passed in
    assert new[0] is tkv[0]


# ---------------------------------------------------------------------------
# the model's cache: layout, carry-over, prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", [False, True])
def test_cache_specs_and_init_match_reference(kv_quant):
    cfg = SMOKE.scaled(kv_quant=kv_quant)
    jm = jax_build_model(jax_get_arch("qwen2.5-14b").smoke.scaled(
        kv_quant=kv_quant))
    tm = build_model(cfg, device="cpu")
    want = jm.cache_specs(3, 20)
    got = tm.cache_specs(3, 20)
    assert set(got) == set(want)
    for name, spec in got.items():
        assert tuple(spec.shape) == tuple(want[name].shape), name
        assert str(spec.dtype).split(".")[-1] == jnp.dtype(
            want[name].dtype).name, name
        assert spec.init == want[name].init, name
    cache = init_cache(tm, 3, 20)
    jcache = jax_init_cache(jm, 3, 20)
    carried = load_jax_cache(tm, jax.tree_util.tree_map(np.asarray, jcache))
    assert cache["index"] == carried["index"] == 0
    for name in got:
        if name != "index":
            assert torch.equal(cache[name], carried[name]), name


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_and_decode_match_reference_from_a_carried_cache(kv_quant):
    """fp32 compute on an fp32 cache (int8 under ``kv_quant``): the
    reference's prefill, then its cache carried into the port and three
    decode steps on both; logits, hidden states and every cache entry."""
    cfg = SMOKE.scaled(kv_quant=kv_quant)
    jm, params, tm = _models(cfg)
    r = np.random.default_rng(2)
    toks = r.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    jcache = jax_init_cache(jm, 2, 16, dtype=jnp.float32)
    jl, jcache = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :7])},
                            jcache, compute_dtype=jnp.float32)
    cache = load_jax_cache(tm, jax.tree_util.tree_map(np.asarray, jcache))
    assert cache["index"] == 7
    # the port's own prefill from a carried empty cache agrees too
    empty = load_jax_cache(tm, jax.tree_util.tree_map(
        np.asarray, jax_init_cache(jm, 2, 16, dtype=jnp.float32)))
    tl, _ = tm.prefill({"tokens": torch.from_numpy(toks[:, :7])}, empty,
                       compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **FP32)
    for t in range(7, 10):
        step = toks[:, t:t + 1]
        jl, jcache, jh = jm.decode_step(params, jcache, jnp.asarray(step),
                                        compute_dtype=jnp.float32,
                                        return_hidden=True)
        tl, cache, th = tm.decode_step(cache, torch.from_numpy(step),
                                       compute_dtype=torch.float32,
                                       return_hidden=True)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **FP32)
        np.testing.assert_allclose(_np(th), np.asarray(jh), **FP32)
        assert cache["index"] == int(jcache["index"]) == t + 1
    for name, leaf in jcache.items():
        if name == "index":
            continue
        g, w = _np(cache[name]), _jnp32(leaf)
        if name.endswith("_q"):
            assert np.abs(g - w).max() <= 1 and (g == w).mean() > 0.99
        else:
            np.testing.assert_allclose(g, w, **FP32)


def test_load_jax_cache_rejects_a_mismatched_cache():
    jm, _, tm = _models()
    good = jax.tree_util.tree_map(np.asarray, jax_init_cache(jm, 2, 8))
    with pytest.raises(KeyError, match="leaves"):
        load_jax_cache(tm, dict(good, extra=good["k"]))
    with pytest.raises(ValueError, match="shape"):
        load_jax_cache(tm, dict(good, v=good["v"][:1]))


def test_decode_matches_cache_free_forward_at_every_position():
    """The reference's ``test_generate_matches_stepwise_forward`` on the
    port: each decode step's logits equal the cache-free forward's at that
    position (fp32), and the bf16 engine's greedy tokens are the greedy
    recompute's."""
    tm = build_model(SMOKE, device="cpu", rng=0)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, SMOKE.vocab_size, (2, 12)))
    full, _ = tm({"tokens": toks}, compute_dtype=torch.float32)
    cache = init_cache(tm, 2, 16, dtype=torch.float32)
    logits, cache = tm.prefill({"tokens": toks[:, :6]}, cache,
                               compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(logits), _np(full[:, :6]), **FP32)
    for t in range(6, 12):
        logits, cache = tm.decode_step(cache, toks[:, t:t + 1],
                                       compute_dtype=torch.float32)
        np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, t]),
                                   **FP32)

    engine = ServeEngine(tm, batch_size=2, max_seq=32, device="cpu")
    prompts = toks[:, :6].numpy().astype(np.int32)
    out, ops = engine.generate(prompts, 5)
    assert out.shape == (2, 5) and out.dtype == np.int32 and ops == 0.0
    seq = torch.from_numpy(prompts.astype(np.int64))
    for t in range(5):
        logits, _ = tm({"tokens": seq})
        last = logits[:, -1].float()
        top2 = torch.topk(last, 2).values
        if float((top2[:, 0] - top2[:, 1]).min()) <= BF16_MARGIN:
            break
        nxt = torch.argmax(last, -1)
        np.testing.assert_array_equal(nxt.numpy(), out[:, t])
        seq = torch.cat([seq, nxt[:, None]], 1)
    assert t >= 2, "the greedy recompute met a near tie at once"


@pytest.mark.parametrize("batch,seq,seed,step,shard,n_shards", [
    (4, 32, 0, 0, 0, 1), (2, 100, 3, 16, 1, 4), (8, 1024, 0, 16, 0, 1)])
def test_lm_batch_is_the_reference(batch, seq, seed, step, shard, n_shards):
    kw = dict(seed=seed, step=step, shard=shard, n_shards=n_shards)
    got = lm_batch(152064, batch, seq, **kw)
    want = jsynthetic.lm_batch(152064, batch, seq, **kw)
    for key in ("tokens", "labels"):
        assert got[key].dtype == want[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])


def test_steps_match_the_reference_steps_in_bf16(tmp_path):
    """``make_prefill_step`` / ``make_decode_step`` (bf16) against the
    model's own calls, and under the published plan over a one-rank mesh
    (tests/test_torch_plans.py runs them over two ranks)."""
    _, _, tm = _models()
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, SMOKE.vocab_size, (2, 6)))
    prefill, decode = make_prefill_step(tm), make_decode_step(tm)
    logits, cache = prefill({"tokens": toks}, init_cache(tm, 2, 12))
    assert logits.shape == (2, 1, SMOKE.vocab_size)
    assert logits.dtype == torch.bfloat16 and cache["index"] == 6
    nxt, logits2, cache = decode(cache, toks[:, -1:])
    assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
    assert torch.equal(nxt[:, 0], torch.argmax(logits2[:, -1].float(), -1)
                       .to(torch.int32))
    assert cache["index"] == 7
    # the published plan (fsdp + tp + sp) over a one-rank mesh: the steps
    # run, their model and cache laid out by the rules, to the same values
    from test_torch_plan_ranks import one_rank_group
    from repro_torch.serve.steps import place_model
    plan = get_arch("qwen2.5-14b").plan
    with one_rank_group(str(tmp_path)) as mesh:
        sm = build_model(SMOKE, device="cpu")
        sm.load_state_dict(tm.state_dict())
        place_model(sm, plan, mesh)
        p2, d2 = (make_prefill_step(sm, plan, mesh),
                  make_decode_step(sm, plan, mesh))
        l2, c2 = p2({"tokens": toks}, init_cache(sm, 2, 12, mesh=mesh,
                                                 plan=plan))
        n2, l3, c2 = d2(c2, toks[:, -1:])
        assert torch.equal(l2, logits) and torch.equal(n2, nxt)
        assert torch.equal(l3, logits2) and c2["index"] == 7


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _as_written(jitted):
    """A jitted step compiled per argument shapes with XLA's excess
    precision off (see ``test_torch_lm._as_written``)."""
    compiled = {}

    def call(*args):
        key = str(jax.tree_util.tree_map(
            lambda a: (jnp.shape(a), jnp.result_type(a)), args))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return compiled[key](*args)
    return call


def _datastore(n=128, dup_token=None):
    r = np.random.default_rng(0)
    keys = r.normal(size=(n, SMOKE.d_model)).astype(np.float32)
    ids = r.integers(0, SMOKE.vocab_size, n).astype(np.int32)
    if dup_token is not None:
        ids[:n // 2] = dup_token            # many neighbours vote one token
    return keys, ids


def _engines(knn=True, index_append=False, batch=2, max_seq=32, ids=None):
    """The reference engine (steps compiled as written) and the port's on
    the same parameters and, with the hook, the same store and payload;
    the port's retrieval replays the reference's per-step keys."""
    entry = jax_get_arch("qwen2.5-14b")
    jm = jax_build_model(entry.smoke)
    plan = dataclasses.replace(entry.plan, fsdp=False, tp=False, sp=False,
                               ep=False, param_dtype="float32")
    params = init_params(jm.param_specs(), jax.random.PRNGKey(0))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jknn = tknn = datastore = None
    if knn:
        keys, default_ids = _datastore()
        ids = default_ids if ids is None else ids
        datastore = (jnp.asarray(keys), jnp.asarray(ids))
        bmo = dict(k=4, delta=0.1, block=16, batch_arms=8, metric="l2")
        jknn = JaxKNNLMConfig(lam=0.3, bmo=JaxBMOConfig(**bmo))
        tknn = KNNLMConfig(lam=0.3, bmo=BMOConfig(**bmo))
    jeng = JaxServeEngine(jm, params, plan, mesh, batch_size=batch,
                          max_seq=max_seq, knn_lm=jknn, datastore=datastore,
                          index_append=index_append)
    jeng.prefill_step = _as_written(jeng.prefill_step)
    jeng.decode_step = _as_written(jeng.decode_step)
    tm = load_jax_params(build_model(SMOKE, device="cpu"),
                         jax.tree_util.tree_map(np.asarray, params))
    store = (IndexStore.from_arrays(*carry(jeng.index.store), device="cpu")
             if knn else None)
    teng = ServeEngine(tm, batch_size=batch, max_seq=max_seq, knn_lm=tknn,
                       index=store, datastore=knn and (None, ids),
                       index_append=index_append, device="cpu")
    if knn:
        race, keys = teng.index.race, _step_keys(jax.random.PRNGKey(0), 64)

        def replayed(queries, rng=None, **kw):
            return race(queries, None, block_sampler=replay_sampler(
                next(keys)), **kw)
        teng.index.race = replayed
    return jeng, teng


def _step_keys(rng, n):
    """The reference ``generate``'s per-step keys: split, keep the sub."""
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        yield sub


def _recorded(jeng, teng):
    """Record, step by step, both engines' logits (the prefill's last
    position, then each decode step's) and the top-two gap of the port's
    log-probabilities (the prefill's logits, then each decode step's mix)."""
    rec = {"jax": [], "torch": [], "gap": []}

    def gap(x):
        top2 = torch.topk(x.float(), 2).values
        rec["gap"].append(float((top2[:, 0] - top2[:, 1]).min()))

    def wrap(eng, name, at):
        fn = getattr(eng, name)

        def inner(*args):
            out = fn(*args)
            logits = out[at][:, -1]
            rec["jax" if eng is jeng else "torch"].append(
                _jnp32(logits) if eng is jeng else _np(logits))
            if eng is teng and name == "prefill_step":
                gap(logits)
            return out
        setattr(eng, name, inner)

    for eng in (jeng, teng):
        wrap(eng, "prefill_step", 0)
        wrap(eng, "decode_step", 0)
    mix = teng._mix

    def mix_rec(logits, hidden, seeds):
        out, ops = mix(logits, hidden, seeds)
        gap(out)
        return out, ops
    teng._mix = mix_rec
    return rec


def _agreeing_steps(got, want, rec):
    """The steps compared: each step's logits within the bf16 tolerance of
    the reference's, and its token the reference's, up to the first step
    whose top-two gap is within twice the two packages' widest logit gap
    there (the log-probabilities move by at most twice a logit's change,
    so only such a near tie may part them)."""
    n = 0
    for t, (a, b, g) in enumerate(zip(rec["torch"], rec["jax"], rec["gap"])):
        np.testing.assert_allclose(a, b, **BF16)
        if g <= 4 * float(np.abs(a - b).max()) + 1e-6:
            break
        np.testing.assert_array_equal(got[:, t], want[:, t])
        n += 1
    return n


@pytest.mark.parametrize("knn", [False, True])
def test_generate_matches_reference_engine(knn):
    jeng, teng = _engines(knn=knn)
    rec = _recorded(jeng, teng)
    prompts = np.random.default_rng(4).integers(
        0, SMOKE.vocab_size, (2, 8)).astype(np.int32)
    want, jops = jeng.generate(prompts, 6)
    got, ops = teng.generate(prompts, 6)
    assert got.shape == want.shape == (2, 6) and got.dtype == np.int32
    assert _agreeing_steps(got, want, rec) >= 4
    if knn:
        assert ops > 0 and ops == pytest.approx(jops, rel=1e-6)
        st, jst = teng.stats, jeng.stats
        assert (st.races, st.raced_queries, st.near_hits) == (
            jst.races, jst.raced_queries, jst.near_hits) == (5, 10,
                                                            st.near_hits)
    else:
        assert ops == jops == 0.0 and teng.plane is None


def test_index_append_grows_the_index_as_the_reference_does():
    """After ``generate`` with ``index_append``: the same live slots, the
    generated tokens as their payload, and the decode steps' hidden states
    as their rows (bf16 states, at the bf16 tolerance)."""
    jeng, teng = _engines(index_append=True)
    rec = _recorded(jeng, teng)
    prompts = np.random.default_rng(5).integers(
        0, SMOKE.vocab_size, (2, 8)).astype(np.int32)
    want, _ = jeng.generate(prompts, 6)
    got, _ = teng.generate(prompts, 6)
    steps = _agreeing_steps(got, want, rec)
    assert steps == 6, "a near tie parted the two engines"
    jstore, store = jeng.index.store, teng.index.store
    alive = np.asarray(jstore.alive)
    np.testing.assert_array_equal(store.alive.numpy(), alive)
    assert teng.index.n_live == 128 + 2 * 5
    np.testing.assert_array_equal(teng.index.payload, jeng.index.payload)
    new = np.nonzero(alive)[0][128:]
    np.testing.assert_array_equal(np.sort(teng.index.payload[new]),
                                  np.sort(got[:, 1:].reshape(-1)))
    np.testing.assert_allclose(store.x.numpy()[alive],
                               np.asarray(jstore.x)[alive], **BF16)


def test_knn_logits_vote_matches_reference_with_repeated_tokens():
    """One retrieval result through both engines' votes: weights
    softmax(−values/T), neighbours that share a next token add up, log(p +
    1e-9); held at 1e-6."""
    _, ids = _datastore(dup_token=7)
    jeng, teng = _engines(ids=ids)
    res = type("Result", (), dict(
        indices=np.array([[0, 1, 2, 100], [3, 64, 65, 5]], np.int64),
        values=np.array([[0.5, 0.7, 0.9, 1.1], [1.0, 1.0, 2.0, 3.5]],
                        np.float32),
        coord_ops=np.array([10.0, 20.0], np.float32)))
    for eng in (jeng, teng):
        eng.plane.query = lambda *a, **kw: res
    hidden = np.zeros((2, SMOKE.d_model), np.float32)
    want, jops = jeng._knn_logits(jnp.asarray(hidden), jax.random.PRNGKey(0))
    got, ops = teng._knn_logits(torch.from_numpy(hidden), 0)
    assert ops == jops == 30.0
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # three neighbours of row 0 vote token 7 together
    w = np.exp(-res.values[0]) / np.exp(-res.values[0]).sum()
    assert float(got[0, 7]) == pytest.approx(np.log(w[:3].sum() + 1e-9),
                                             rel=1e-6)


def test_engine_takes_an_index_or_a_plane_and_votes_zero_without_payload():
    """``index=`` takes a built ``Index`` (a payload-less one gets the
    explicit zero payload, as the reference's engine attaches it) or a raw
    store; ``plane=`` is used as given instead of a private plane."""
    from repro_torch.serve import RequestPlane
    keys, ids = _datastore()
    tm = build_model(SMOKE, device="cpu")
    knn = KNNLMConfig(bmo=BMOConfig(k=4, block=16, batch_arms=8))
    idx = Index.build(keys, knn.bmo, 0, device="cpu")
    eng = ServeEngine(tm, batch_size=2, max_seq=16, knn_lm=knn, index=idx,
                      device="cpu")
    assert eng.index is idx and eng.plane.index is idx
    np.testing.assert_array_equal(idx.payload, np.zeros(128, np.int32))
    plane = RequestPlane(Index.open(idx.store, payload=ids))
    eng = ServeEngine(tm, batch_size=2, max_seq=16, knn_lm=knn,
                      index=idx.store, datastore=(None, ids), plane=plane,
                      device="cpu")
    assert eng.plane is plane and eng.index is not idx
    np.testing.assert_array_equal(eng.index.payload, ids)
    out, ops = eng.generate(np.zeros((2, 4), np.int32), 3)
    assert out.shape == (2, 3) and ops > 0
    assert plane.stats.plane_submitted == 2


def test_step_seeds_are_fixed_per_step():
    a, b = step_seeds(3), step_seeds(3)
    got = [next(a) for _ in range(4)]
    assert got == [next(b) for _ in range(4)] and len(set(got)) == 4
    assert all(0 <= s < 2 ** 31 for s in got)
    assert next(step_seeds(None)) == next(step_seeds(0))
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    s1, s2 = step_seeds(g1), step_seeds(g2)
    assert [next(s1) for _ in range(3)] == [next(s2) for _ in range(3)]


def test_engine_raises_without_a_gpu_and_for_what_is_not_ported(monkeypatch,
                                                                tmp_path):
    tm = build_model(SMOKE, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(tm, batch_size=1, max_seq=8)
    # a sharded retrieval index (once refused as Queue 1 item 7) serves
    keys, ids = _datastore(64)
    sharded = ServeEngine(tm, batch_size=1, max_seq=8, device="cpu",
                          knn_lm=KNNLMConfig(index_shards=2,
                                             bmo=BMOConfig(k=4, block=64)),
                          datastore=(keys, ids))
    assert sharded.index.n_shards == 2
    out, ops = sharded.generate(np.ones((1, 3), np.int32), 2)
    assert out.shape == (1, 2) and ops > 0
    # a fleet's shared plane (once refused as Queue 1 item 8) serves the
    # decode loop's retrieval under plane_namespace
    from repro_torch.fleet import Fleet, FleetConfig
    fleet = Fleet(str(tmp_path / "fleet"), FleetConfig(max_resident=1),
                  device="cpu")
    cfg = KNNLMConfig(bmo=BMOConfig(k=4, block=64))
    fleet.create("ds", keys, cfg.bmo, 7, payload=ids)
    fleet.create("other", keys + 1.0, cfg.bmo, 8)      # evicts "ds"
    on_fleet = ServeEngine(tm, batch_size=1, max_seq=8, device="cpu",
                           knn_lm=cfg, index=fleet.get("ds"),
                           plane=fleet.serve(), plane_namespace="ds")
    out, ops = on_fleet.generate(np.ones((1, 3), np.int32), 2)
    assert out.shape == (1, 2) and ops > 0
    assert on_fleet.plane.stats.fleet_reloads == 1
    # the published plan over a one-rank mesh (once refused as Queue 1
    # item 9) serves the tokens of the one-device engine
    from test_torch_plan_ranks import one_rank_group
    from repro_torch.serve.steps import place_model
    prompts = np.arange(6, dtype=np.int32).reshape(2, 3)
    want, _ = ServeEngine(tm, batch_size=2, max_seq=8,
                          device="cpu").generate(prompts, 3)
    plan = get_arch("qwen2.5-14b").plan
    with one_rank_group(str(tmp_path / "group")) as mesh:
        sm = build_model(SMOKE, device="cpu")
        sm.load_state_dict(tm.state_dict())
        place_model(sm, plan, mesh)
        got, _ = ServeEngine(sm, plan, batch_size=2, max_seq=8,
                             device="cpu", mesh=mesh).generate(prompts, 3)
    np.testing.assert_array_equal(got, want)
    eng = ServeEngine(tm, batch_size=2, max_seq=16, device="cpu")
    with pytest.raises(ValueError, match="slots"):
        eng.generate(np.zeros((3, 4), np.int32), 2)


def test_engine_on_a_fleet_plane_pins_no_namespace(tmp_path):
    """Behind a fleet's plane the engine keeps no handle of its own: its
    ``index`` is the router's live one, so the fleet can evict the
    namespace (nothing of the engine holds the old handle) and the next
    decode step reloads it."""
    import gc
    import weakref
    from repro_torch.fleet import Fleet, FleetConfig
    tm = build_model(SMOKE, device="cpu")
    keys, ids = _datastore(64)
    fleet = Fleet(str(tmp_path / "fleet"), FleetConfig(max_resident=2),
                  device="cpu")
    cfg = KNNLMConfig(bmo=BMOConfig(k=4, block=64))
    fleet.create("ds", keys, cfg.bmo, 7, payload=ids)
    plane = fleet.serve()
    eng = ServeEngine(tm, batch_size=1, max_seq=8, device="cpu", knn_lm=cfg,
                      plane=plane, plane_namespace="ds")
    assert eng.index is fleet.peek("ds") and eng._index is None
    out, ops = eng.generate(np.ones((1, 3), np.int32), 2)
    assert out.shape == (1, 2) and ops > 0
    old = weakref.ref(fleet.peek("ds"))
    assert fleet.evict("ds")
    gc.collect()
    assert old() is None
    out, ops = eng.generate(np.ones((1, 3), np.int32), 2)
    assert ops > 0 and fleet.reload_count == 1
    np.testing.assert_array_equal(eng.index.payload, ids)
    with pytest.raises(ValueError, match="comes from the fleet"):
        ServeEngine(tm, batch_size=1, max_seq=8, device="cpu", knn_lm=cfg,
                    datastore=(keys, ids), plane=plane, plane_namespace="ds")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = ["--arch", "qwen2.5-14b", "--smoke", "--device", "cpu", "--batch", "2",
       "--prompt-len", "8", "--new-tokens", "4", "--knn-lm",
       "--datastore-size", "256"]


def test_cli_builds_then_loads_its_index_and_serves(tmp_path):
    """Two launches on one ``--index-dir``: the first builds, saves and
    tunes the index, the second loads it with its payload and tuning and
    serves the same tokens; every dump is written and the audit flushes."""
    d = str(tmp_path / "idx")
    extra = ["--index-dir", d, "--index-append", "--tune", "--audit-rate",
             "1.0", "--audit-dir", str(tmp_path / "audit"), "--slo",
             "--autoscale", "--autoscale-apply"]
    runs = []
    for i in range(2):
        dumps = ["--health-dump", str(tmp_path / f"health{i}.json"),
                 "--metrics-dump", str(tmp_path / f"metrics{i}.json"),
                 "--trace", str(tmp_path / f"trace{i}.json")]
        runs.append(serve_cli.main(CLI + extra + dumps))
        for name in ("health", "metrics", "trace"):
            with open(tmp_path / f"{name}{i}.json") as f:
                assert json.load(f)
    assert {"payload.npy", "tuned.json"} <= set(os.listdir(d))
    np.testing.assert_array_equal(runs[0]["tokens"], runs[1]["tokens"])
    for run in runs:
        assert run["tokens"].shape == (2, 4) and run["retrieval_ops"] > 0
        assert run["audit"]["mismatch_rows"] == 0
        assert run["stats"]["races"] == 3
    saved = Index.load(d, device="cpu")
    assert saved.tuned is not None
    ds = np.random.default_rng(0)          # the CLI's datastore draws
    ds.normal(size=(256, SMOKE.d_model))
    np.testing.assert_array_equal(
        saved.payload[:256], ds.integers(0, SMOKE.vocab_size, 256))


def test_cli_serves_an_index_dir_written_by_the_reference(tmp_path):
    d = str(tmp_path / "idx")
    jax_serve_cli.main(["--arch", "qwen2.5-14b", "--smoke", "--batch", "1",
                        "--prompt-len", "4", "--new-tokens", "1",
                        "--knn-lm", "--datastore-size", "256",
                        "--index-dir", d])
    want = JaxIndex.load(d)
    run = serve_cli.main(CLI + ["--index-dir", d])
    assert run["tokens"].shape == (2, 4) and run["retrieval_ops"] > 0
    got = Index.load(d, device="cpu")
    np.testing.assert_array_equal(got.payload, np.asarray(want.payload))
    np.testing.assert_array_equal(got.store.x.numpy(),
                                  np.asarray(want.store.x))


@pytest.mark.parametrize("flags,item", [
    (["--index-shards", "2"], "item 7"), (["--fleet-root"], "item 8"),
    (["--data", "2"], "item 9"), (["--model", "2"], "item 9")])
def test_cli_flags_not_ported_raise(flags, item, tmp_path):
    if item == "item 8":
        # ported since this case was a refusal pin: the first launch
        # creates the fleet's 'default' namespace, the second recovers it
        root = str(tmp_path / "fleet")
        runs = [serve_cli.main(CLI + flags + [root, "--max-resident", "2"])
                for _ in range(2)]
        np.testing.assert_array_equal(runs[0]["tokens"], runs[1]["tokens"])
        for run in runs:
            assert run["retrieval_ops"] > 0
            assert run["fleet"]["namespaces"] == 1
            assert run["fleet"]["max_resident"] == 2
        assert run["fleet"]["resident"] == 1
        assert run["stats"]["fleet_namespaces_resident"] == 1
        return
    if item == "item 7":
        # ported since this case was a refusal pin: two index shards serve
        run = serve_cli.main(CLI + flags)
        assert run["tokens"].shape == (2, 4) and run["retrieval_ops"] > 0
        assert len(run["stats"]["shard_coord_ops"]) == 2
        return
    # ported since these cases were refusal pins: two spawned ranks serve
    # the reference CLI's plan over a (2, 1) or (1, 2) mesh, the retrieval on
    # each rank, the tokens of one rank
    one = serve_cli.main(CLI)
    run = serve_cli.main(CLI + flags)
    assert run["retrieval_ops"] > 0
    np.testing.assert_array_equal(run["tokens"], one["tokens"])


def test_cli_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in CLI if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(argv)
