"""The port's dense LM held against the JAX package: config records, the
parameter carry-over, the cache-free forward (logits and final hidden
state) and ``lm_loss`` with ``attn_impl`` "pallas" (the reference's Pallas
kernel in interpret mode against the port's fused op, its plain version on
the CPU) and "auto" (the plain ``sdpa``, including its online-softmax and
q-chunked branches), the MLP flavours, and the port's own initialisation.

Inputs and parameters are made once, by the reference (``init_params`` from
``PRNGKey(0)`` and numpy-seeded tokens), and carried across with
``load_jax_params``, so both packages compute the same model. The init rule
makes attention nearly one-hot (score spreads in the tens), which exercises
the online softmax's rescaling underflow. Tolerances: fp32 compute at
atol/rtol 1e-4 (sums in another order); bf16 compute at 3e-2, the
reference's own bf16 flash-kernel tolerance."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs as jax_list_archs
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import ParallelPlan as JaxParallelPlan
from repro.models import build_model as jax_build_model
from repro.sharding.spec import init_params
from repro.train.loss import lm_loss as jax_lm_loss
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import ModelConfig, ParallelPlan
from repro_torch.models import build_model
from repro_torch.models.convert import load_jax_params
from repro_torch.models.transformer import DenseLM
from repro_torch.train.loss import lm_loss

FP32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, FP32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _pair(cfg, seed: int = 0):
    """The reference model with its parameters from PRNGKey(seed), and the
    port's model on the CPU with the same parameters carried across."""
    jm = jax_build_model(JaxModelConfig(**dataclasses.asdict(cfg)))
    params = init_params(jm.param_specs(), jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = load_jax_params(build_model(cfg, device="cpu"), params)
    return jm, params, tm


def _as_written(fn, *args):
    """``fn(*args)`` compiled with XLA's excess precision off, so that every
    bf16 cast of the reference rounds where its code puts it. With it on
    (the CPU default), XLA keeps fused bf16 intermediates in fp32, and the
    bf16 SMOKE logits leave the bf16 tolerance against the same model
    rounded as written."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*args)


def _forward_pair(cfg, tokens, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    jm, params, tm = _pair(cfg)
    jl, _, jh = _as_written(
        lambda p, t: jm.apply(p, {"tokens": t}, remat="none",
                              compute_dtype=jdt, return_hidden=True),
        params, jnp.asarray(tokens))
    tl, cache, th = tm({"tokens": torch.from_numpy(tokens)},
                       compute_dtype=tdt, return_hidden=True)
    assert cache is None and tl.dtype == tdt
    return (np.asarray(jl.astype(jnp.float32)), np.asarray(jh.astype(jnp.float32)),
            _np(tl), _np(th))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ours,theirs", [(ModelConfig, JaxModelConfig),
                                         (ParallelPlan, JaxParallelPlan)])
def test_model_config_fields_match_reference(ours, theirs):
    assert ({(f.name, f.default) for f in dataclasses.fields(ours)}
            == {(f.name, f.default) for f in dataclasses.fields(theirs)})


def test_qwen_configs_equal_reference():
    ours, theirs = get_arch("qwen2.5-14b"), jax_get_arch("qwen2.5-14b")
    for field in ("config", "plan", "smoke"):
        assert (dataclasses.asdict(getattr(ours, field))
                == dataclasses.asdict(getattr(theirs, field)))
    assert ours.config.head_dim_ == theirs.config.head_dim_ == 128
    assert list_archs() == jax_list_archs()


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_load_jax_params_round_trips():
    cfg = get_arch("qwen2.5-14b").smoke
    _, params, tm = _pair(cfg)
    named = dict(tm.named_parameters())
    seen = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        if keys[0] == "layers":
            for i in range(cfg.n_layers):
                name = ".".join(["layers", str(i)] + keys[1:])
                np.testing.assert_array_equal(_np(named[name]), leaf[i])
                seen += 1
        else:
            np.testing.assert_array_equal(_np(named[".".join(keys)]), leaf)
            seen += 1
    assert seen == len(named)


def test_load_jax_params_refuses_a_mismatched_tree():
    cfg = get_arch("qwen2.5-14b").smoke
    _, params, _ = _pair(cfg)
    tm = build_model(cfg.scaled(n_layers=3), device="cpu")
    with pytest.raises(ValueError, match="stacked layers"):
        load_jax_params(tm, params)


def test_own_init_follows_reference_rule():
    """fan-in is shape[-2] for every tensor of rank ≥ 2 (wq (d, h, hd) draws
    with std 1/√h), the embedding N(0, 0.02), norms ones, biases zeros; in
    the parameter type, with the norms fp32."""
    cfg = get_arch("qwen2.5-14b").smoke.scaled(d_model=256, d_ff=512,
                                               vocab_size=1024, n_layers=1)
    tm = DenseLM(cfg, param_dtype=torch.bfloat16, device="cpu", rng=3)
    want_std = {"wq": 1 / math.sqrt(cfg.n_heads),
                "wk": 1 / math.sqrt(cfg.n_kv_heads),
                "wv": 1 / math.sqrt(cfg.n_kv_heads),
                "wo": 1 / math.sqrt(cfg.head_dim_),
                "wi_gate": 1 / math.sqrt(cfg.d_model),
                "wi_up": 1 / math.sqrt(cfg.d_model),
                "head": 1 / math.sqrt(cfg.d_model)}
    for name, p in tm.named_parameters():
        leaf = name.split(".")[-1]
        if leaf in ("ln1", "ln2", "final_norm"):
            assert p.dtype == torch.float32 and bool((p == 1).all()), name
            continue
        assert p.dtype == torch.bfloat16, name
        if leaf in ("bq", "bk", "bv"):
            assert bool((p == 0).all()), name
            continue
        x = _np(p).ravel().astype(np.float64)
        want = 0.02 if name == "embed.tok" else \
            1 / math.sqrt(cfg.d_ff) if name.endswith("mlp.wo") else want_std[leaf]
        # sampling error of a std over N draws is std/√(2N); allow 6 of them
        # beside the bf16 rounding
        assert abs(x.std() / want - 1) < 6 / math.sqrt(2 * x.size) + 4e-3, name
        assert abs(x.mean()) < 6 * want / math.sqrt(x.size), name


def test_own_init_is_seeded():
    cfg = get_arch("qwen2.5-14b").smoke
    a, b, c = (DenseLM(cfg, device="cpu", rng=s) for s in (5, 5, 6))
    wa, wb, wc = (m.layers[1].attn.wq for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["pallas", "auto"])
def test_forward_matches_reference(rng, attn_impl, dtype):
    """qwen2.5-14b SMOKE with head_dim 32, as the reference's own flash
    test: logits and the final hidden state (``return_hidden``)."""
    cfg = get_arch("qwen2.5-14b").smoke.scaled(attn_impl=attn_impl,
                                               head_dim=32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int32)
    jl, jh, tl, th = _forward_pair(cfg, tokens, dtype)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(tl, jl, **tol)
    np.testing.assert_allclose(th, jh, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [0, 1024])
def test_long_sdpa_matches_reference(rng, dtype, chunk):
    """3,072 keys, over the 2,048 threshold: the online softmax over KV
    chunks of 1,024, alone and under q-chunks of 1,024 with their own
    causal offsets, on identical inputs (score spreads near 20)."""
    from repro.models.common import sdpa as jax_sdpa
    from repro_torch.models.common import sdpa
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = (rng.normal(size=(1, 3072, h, 16)).astype(np.float32) * s
               for h, s in ((4, 3.0), (2, 3.0), (2, 1.0)))
    want = _as_written(lambda a, b, c: jax_sdpa(a, b, c, causal=True,
                                                chunk=chunk),
                       *(jnp.asarray(t).astype(jdt) for t in (q, k, v)))
    got = sdpa(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)),
               causal=True, chunk=chunk)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)),
                               **(dict(rtol=1e-5, atol=1e-5)
                                  if dtype == "float32" else tol))


def test_long_sequence_forward_matches_reference(rng):
    """The model over 3,072 tokens, through the same long-sequence branches.
    Tolerance 1e-3, not 1e-4: attention this long at the reference's init
    is nearly one-hot with many near-ties, so the fp32 roundings of q and k
    in either package move some logits by more than 1e-4, about as far as
    the reference lies from the same model run in float64."""
    cfg = get_arch("qwen2.5-14b").smoke.scaled(n_layers=1, n_heads=2,
                                               n_kv_heads=1, d_model=32,
                                               head_dim=16)
    tokens = rng.integers(0, cfg.vocab_size, (1, 3072)).astype(np.int32)
    jl, jh, tl, th = _forward_pair(cfg, tokens, "float32")
    np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(th, jh, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("act", ["gelu", "sq_relu"])
def test_mlp_flavours_match_reference(rng, act):
    cfg = get_arch("qwen2.5-14b").smoke.scaled(mlp_act=act)
    tokens = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    jl, jh, tl, th = _forward_pair(cfg, tokens, "float32")
    np.testing.assert_allclose(tl, jl, **FP32)
    np.testing.assert_allclose(th, jh, **FP32)


@pytest.mark.parametrize("attn_impl", ["pallas", "auto"])
def test_lm_loss_matches_reference(rng, attn_impl):
    cfg = get_arch("qwen2.5-14b").smoke.scaled(attn_impl=attn_impl,
                                               head_dim=32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((2, 1), -100, np.int32)],
                            axis=1)
    jm, params, tm = _pair(cfg)
    jloss, jmet = _as_written(
        lambda p, b: jax_lm_loss(jm, p, b, remat="none",
                                 compute_dtype=jnp.float32),
        params, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    tloss, tmet = lm_loss(tm, {"tokens": torch.from_numpy(tokens),
                               "labels": torch.from_numpy(labels)},
                          compute_dtype=torch.float32)
    assert set(tmet) == set(jmet)
    for key in tmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5)
    assert float(tmet["tokens"]) == 2 * 127
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_cross_entropy_matches_reference(rng):
    from repro.train.loss import cross_entropy as jax_ce
    from repro_torch.train.loss import cross_entropy
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    labels[0, 1] = -100
    labels[2, 4] = -100
    jl, jn = jax_ce(jnp.asarray(logits), jnp.asarray(labels))
    tl, tn = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(tn) == float(jn) == 13


def test_forward_at_reference_init_amplifies_rounding_in_depth(monkeypatch):
    """Why a whole forward cannot be held to a tight tolerance at depth,
    and the card's smoke run holds each layer's attention instead: at the
    reference's init every attention row is nearly one-hot and dominates
    the residual stream, so a relative change of 1e-6 in the attention
    outputs flips near-tied picks and grows by orders of magnitude in a
    dozen layers (qwen2.5-14b's head widths, fp32, deterministic)."""
    from repro_torch.kernels import ref
    cfg = get_arch("qwen2.5-14b").config.scaled(
        n_layers=12, d_model=640, n_heads=5, n_kv_heads=1, d_ff=1280,
        vocab_size=1024, attn_impl="pallas")
    model = build_model(cfg, device="cpu", rng=0)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512),
                           generator=torch.Generator().manual_seed(1))
    streams = []
    for layer in model.layers:
        layer.register_forward_hook(lambda m, a, out: streams.append(out))
    plain = ref.flash_attention_ref

    def nudged(q, k, v, causal=True, q_offset=0):
        o = plain(q, k, v, causal, q_offset)
        noise = torch.randn(o.shape, generator=torch.Generator().manual_seed(7))
        return o * (1 + 1e-6 * noise)

    with torch.inference_mode():
        model({"tokens": tokens}, compute_dtype=torch.float32)
        monkeypatch.setattr(ref, "flash_attention_ref", nudged)
        model({"tokens": tokens}, compute_dtype=torch.float32)
    n = cfg.n_layers
    gaps = [float((a - b).norm() / b.norm())
            for a, b in zip(streams[n:], streams[:n])]
    assert gaps[1] < 1e-3
    assert gaps[-1] > 0.1


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------

def test_entry_points_run_on_cpu_and_raise_without_gpu(monkeypatch):
    cfg = get_arch("qwen2.5-14b").smoke
    tm = build_model(cfg, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    loss, _ = lm_loss(tm, {"tokens": tokens, "labels": tokens})
    assert torch.isfinite(loss)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DenseLM(cfg)
