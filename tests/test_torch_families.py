"""The port's model families beyond the dense LM held against the JAX
package: qwen2-vl-2b (the VLM, M-RoPE over embeddings), whisper-base (the
encoder-decoder), and the three dense architectures granite-34b (MQA),
nemotron-4-340b (squared ReLU) and llama3-405b, each at its ``SMOKE``
size; the registry, the configs, and the serving CLI for every family.
``tests/test_torch_ssm.py`` does the same for xlstm-350m and zamba2-2.7b
with this file's helpers.

Parameters come from the reference (``init_params`` from ``PRNGKey(0)``)
and inputs from numpy, carried across with ``load_jax_params``; the
reference is compiled with XLA's excess precision off (``as_written``), so
its bf16 casts round where its code puts them. Tolerances, as
``tests/test_torch_lm.py``: fp32 compute at rtol/atol 1e-4 (sums in
another order), bf16 compute at 3e-2 (the reference's own bf16 flash-kernel
tolerance); ``lm_loss`` at 1e-5 relative in fp32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs as jax_list_archs
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.registry import SKIPS as JAX_SKIPS
from repro.models import build_model as jax_build_model
from repro.serve.steps import init_cache as jax_init_cache
from repro.sharding.spec import init_params
from repro.train.loss import lm_loss as jax_lm_loss
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.registry import SKIPS, shape_skip_reason
from repro_torch.models import build_model
from repro_torch.models.convert import load_jax_cache, load_jax_params
from repro_torch.serve import init_cache
from repro_torch.train.loss import lm_loss

FP32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, FP32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}
DENSE_ARCHS = ["granite-34b", "nemotron-4-340b", "llama3-405b"]
ARCHS = ["qwen2-vl-2b", "whisper-base"] + DENSE_ARCHS
# a cut of the batch: 2 sequences of 32 positions (whisper: 32 frames and
# a decoder of 32 // dec_seq_div = 4 tokens)
B, S = 2, 32


def np32(t) -> np.ndarray:
    """A port tensor or a reference array as fp32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def close(got, want, tol: dict, what: str = "", scale: bool = False):
    """``got`` against ``want`` elementwise at ``tol``'s rtol and atol (with
    ``scale``, atol times max(1, max|want|): a cache leaf's rounding is
    relative to its largest entries, from which its sums are made). A tol
    with "l2" and "share" lets at most that share of the elements exceed
    the elementwise bound and holds the relative L2 error to "l2" (the
    xLSTM's bf16 rounding flips; ``tests/test_torch_ssm.py``)."""
    got, want = np32(got), np32(want)
    assert got.shape == want.shape, what
    atol = tol["atol"] * (max(1.0, float(np.abs(want).max())) if scale
                          else 1.0)
    if "l2" not in tol:
        np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=atol,
                                   err_msg=what)
        return
    err = np.abs(got - want)
    beyond = float((err > atol + tol["rtol"] * np.abs(want)).mean())
    l2 = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    assert beyond <= tol["share"] and l2 <= tol["l2"], (what, beyond, l2)


def as_written(fn, *args):
    """``fn(*args)`` compiled with XLA's excess precision off (see
    ``tests/test_torch_lm.py``)."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*args)


def pair(cfg, seed: int = 0):
    """The reference model, its parameters from PRNGKey(seed) as numpy,
    and the port's model on the CPU with them carried across."""
    jm = jax_build_model(JaxModelConfig(**dataclasses.asdict(cfg)))
    params = jax.tree_util.tree_map(
        np.asarray, init_params(jm.param_specs(), jax.random.PRNGKey(seed)))
    return jm, params, load_jax_params(build_model(cfg, device="cpu"), params)


def batch_of(cfg, seed: int = 0, b: int = B, s: int = S) -> dict:
    """A numpy batch the family's forward reads, with aligned labels: token
    ids; embeddings (bf16-representable) and three distinct M-RoPE streams
    for the VLM; frames and s // dec_seq_div decoder tokens for whisper."""
    r = np.random.default_rng(seed)
    if cfg.family == "vlm":
        t = np.arange(s)
        pos3 = np.stack([np.broadcast_to(p, (b, s)) for p in
                         (t // 8, t % 8 + t // 8, (t * 3) % 11)])
        embeds = r.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        return {"embeds": np32(torch.from_numpy(embeds).to(torch.bfloat16)),
                "positions3": pos3.astype(np.int32),
                "labels": r.integers(0, cfg.vocab_size, (b, s)).astype(
                    np.int32)}
    if cfg.family == "audio":
        sd = max(s // cfg.dec_seq_div, 4)
        tokens = r.integers(0, cfg.vocab_size, (b, sd + 1)).astype(np.int32)
        return {"frames": r.normal(size=(b, s, cfg.d_model)).astype(
                    np.float32),
                "tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    tokens = r.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def inputs(batch: dict) -> dict:
    return {k: v for k, v in batch.items() if k != "labels"}


def check_forward(cfg, dtype: str, tol=None):
    """The cache-free forward's logits, the reference's and the port's."""
    jdt, tdt, dtol = DTYPES[dtype]
    jm, params, tm = pair(cfg)
    batch = inputs(batch_of(cfg))
    jl, _ = as_written(lambda p, b: jm.apply(p, b, remat="none",
                                             compute_dtype=jdt),
                       params, to_jax(batch))
    with torch.no_grad():
        tl, cache = tm(to_torch(batch), compute_dtype=tdt)
    assert cache is None and tl.dtype == tdt
    close(tl, jl, tol or dtol, "logits")


def check_loss(cfg, tol=None, models=None):
    """``lm_loss``'s metrics, the reference's and the port's; ``models``:
    ``pair(cfg)``'s triple, made here when not given."""
    jm, params, tm = models or pair(cfg)
    batch = batch_of(cfg)
    jloss, jmet = as_written(
        lambda p, b: jax_lm_loss(jm, p, b, remat="none",
                                 compute_dtype=jnp.float32),
        params, to_jax(batch))
    with torch.no_grad():
        tloss, tmet = lm_loss(tm, to_torch(batch), compute_dtype=torch.float32)
    assert set(tmet) == set(jmet)
    for key in tmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   **(tol or dict(rtol=1e-5)))
    assert float(tmet["tokens"]) == batch["labels"].size


def _leaf_pairs(port: dict, ref: dict, path=""):
    for name, leaf in ref.items():
        if name == "index":
            continue
        if isinstance(leaf, dict):
            yield from _leaf_pairs(port[name], leaf, f"{path}{name}.")
        else:
            yield f"{path}{name}", port[name], leaf


def assert_caches_close(port: dict, ref: dict, tol):
    assert port["index"] == int(ref["index"])
    n = 0
    for name, got, want in _leaf_pairs(port, ref):
        close(got, want, tol, name, scale=True)
        n += 1
    assert n > 0


def _prompt(cfg, batch: dict, n: int) -> dict:
    """The first n decoder positions of a batch (the frames whole)."""
    out = dict(batch)
    key = "embeds" if cfg.family == "vlm" else "tokens"
    out[key] = batch[key][:, :n]
    if "positions3" in batch:
        out["positions3"] = batch["positions3"][:, :, :n]
    return inputs(out)


def _step(cfg, batch: dict, t: int):
    """The reference's and the port's decode input at position t: the VLM
    takes {"embeds"}, the rest the token ids."""
    if cfg.family == "vlm":
        e = batch["embeds"][:, t:t + 1]
        return {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    tok = np.ascontiguousarray(batch["tokens"][:, t:t + 1])
    return jnp.asarray(tok), torch.from_numpy(tok)


def check_serving(cfg, n_prompt: int, tol=FP32, models=None):
    """fp32 compute on an fp32 cache: the reference's prefill, its cache
    carried into the port and the remaining positions decoded one at a time
    by both; the port's own prefill from a carried empty cache; the logits
    and every cache leaf (``models``: as ``check_loss``'s). Returns the
    carried and the port's final caches."""
    jm, params, tm = models or pair(cfg)
    batch = batch_of(cfg)
    length = batch["labels"].shape[1]
    max_seq = S if cfg.family == "audio" else length + 4
    empty = jax.tree_util.tree_map(
        np.asarray, jax_init_cache(jm, B, max_seq, dtype=jnp.float32))
    prompt = _prompt(cfg, batch, n_prompt)
    jl, jcache = jm.prefill(params, to_jax(prompt), empty,
                            compute_dtype=jnp.float32)
    with torch.no_grad():
        tl, own = tm.prefill(to_torch(prompt), load_jax_cache(tm, empty),
                             compute_dtype=torch.float32)
    close(tl, jl, tol, "prefill logits")
    assert_caches_close(own, jcache, tol)
    cache = load_jax_cache(tm, jax.tree_util.tree_map(np.asarray, jcache))
    for t in range(n_prompt, length):
        jstep, tstep = _step(cfg, batch, t)
        jl, jcache = jm.decode_step(params, jcache, jstep,
                                    compute_dtype=jnp.float32)
        with torch.no_grad():
            tl, cache = tm.decode_step(cache, tstep,
                                       compute_dtype=torch.float32)
        close(tl, jl, tol, f"decode logits at {t}")
    assert_caches_close(cache, jcache, tol)
    return cache


def check_init_cache(cfg, max_seq: int = 20):
    """``cache_specs`` and ``init_cache`` against the reference's: shapes,
    types, init rules and the values they start at (the stabilisers'
    −1e30), and a carried reference cache equal to the port's own."""
    jm = jax_build_model(JaxModelConfig(**dataclasses.asdict(cfg)))
    tm = build_model(cfg, device="cpu")
    want = jm.cache_specs(3, max_seq)
    got = tm.cache_specs(3, max_seq)

    def walk(g, w, path=""):
        assert set(g) == set(w), path
        for name in w:
            if isinstance(w[name], dict):
                walk(g[name], w[name], f"{path}{name}.")
                continue
            spec, ref = g[name], w[name]
            assert tuple(spec.shape) == tuple(ref.shape), path + name
            assert str(spec.dtype).split(".")[-1] == jnp.dtype(
                ref.dtype).name, path + name
            assert spec.init == ref.init, path + name
            if ref.init == "scalar":
                assert spec.scale == ref.scale, path + name

    walk(got, want)
    ours = init_cache(tm, 3, max_seq)
    theirs = jax.tree_util.tree_map(np.asarray, jax_init_cache(jm, 3, max_seq))
    assert_caches_close(ours, theirs, dict(rtol=0, atol=0))
    carried = load_jax_cache(tm, theirs)
    for name, a, b in _leaf_pairs(ours, carried):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def check_params_round_trip(cfg, models=None):
    """Every reference leaf lands in the parameter of its path (stacked
    leaves unstacked into their module lists), every parameter is filled."""
    _, params, tm = models or pair(cfg)
    named = dict(tm.named_parameters())
    stacked = tm.stacked
    seen = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        if keys[0] in stacked:
            for i in range(leaf.shape[0]):
                name = ".".join([keys[0], str(i)] + keys[1:])
                np.testing.assert_array_equal(np32(named[name]), leaf[i])
                seen += 1
        else:
            np.testing.assert_array_equal(np32(named[".".join(keys)]), leaf)
            seen += 1
    assert seen == len(named)


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------

def test_list_archs_is_the_reference():
    assert list_archs() == jax_list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    ours, theirs = get_arch(arch), jax_get_arch(arch)
    for field in ("config", "plan", "smoke"):
        assert (dataclasses.asdict(getattr(ours, field))
                == dataclasses.asdict(getattr(theirs, field)))


def test_shape_skips_equal_reference():
    from repro.configs.registry import shape_skip_reason as jax_skip
    assert SKIPS == JAX_SKIPS
    for arch in jax_list_archs():
        for shape in ("long_500k", "train_4k"):
            assert shape_skip_reason(arch, shape) == jax_skip(arch, shape)


def test_nemotron_heads_are_192_wide():
    assert get_arch("nemotron-4-340b").config.head_dim_ == 192


# ---------------------------------------------------------------------------
# forward, loss, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["pallas", "auto"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, attn_impl, dtype):
    """"pallas": the reference's Pallas kernel in interpret mode against the
    port's fused op (its plain version on the CPU), bidirectional in
    whisper's encoder. SMOKE keeps every head 16 wide, nemotron's too:
    ``test_flash_plain_version_at_head_dim_192_matches_reference`` holds
    the fused op at D 192."""
    check_forward(get_arch(arch).smoke.scaled(attn_impl=attn_impl), dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_reference(arch):
    check_loss(get_arch(arch).smoke)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Whisper: 32 frames, a prompt of 2 decoder tokens and 2 decode steps
    against the cross keys and values; the rest: a prompt of 24 and 8
    steps (the VLM's through embeddings)."""
    cfg = get_arch(arch).smoke
    check_serving(cfg, 2 if cfg.family == "audio" else 24)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    check_init_cache(get_arch(arch).smoke)


@pytest.mark.parametrize("arch", ARCHS)
def test_load_jax_params_round_trips(arch):
    check_params_round_trip(get_arch(arch).smoke)


def test_whisper_cache_has_two_lengths():
    """The decoder's self-attention cache holds max(S_enc // 8, 8)
    positions, the cross keys S_enc; prefill replaces the cross keys by the
    encoder's and a decode step attends to them."""
    cfg = get_arch("whisper-base").smoke
    tm = build_model(cfg, device="cpu")
    specs = tm.cache_specs(2, 100)
    assert specs["k"].shape[2] == 12 and specs["cross_k"].shape[2] == 100
    assert tm.cache_specs(2, 40)["k"].shape[2] == 8
    cache = check_serving(cfg, 2)
    assert cache["cross_k"].shape == (cfg.dec_layers, B, S, cfg.n_kv_heads,
                                      cfg.head_dim_)


def test_load_jax_cache_refuses_a_mismatched_cache():
    cfg = get_arch("whisper-base").smoke
    jm = jax_build_model(JaxModelConfig(**dataclasses.asdict(cfg)))
    tm = build_model(cfg, device="cpu")
    good = jax.tree_util.tree_map(np.asarray, jax_init_cache(jm, 2, 64))
    with pytest.raises(KeyError, match="leaves"):
        load_jax_cache(tm, {k: v for k, v in good.items() if k != "cross_v"})
    with pytest.raises(ValueError, match="shape"):
        load_jax_cache(tm, dict(good, k=good["k"][:, :, :4]))
    with pytest.raises(ValueError, match="type"):
        load_jax_cache(tm, dict(good, v=good["v"].astype(np.float16)))


def test_load_jax_params_refuses_a_mismatched_tree():
    cfg = get_arch("whisper-base").smoke
    _, params, _ = pair(cfg)
    tm = build_model(cfg.scaled(dec_layers=3), device="cpu")
    with pytest.raises(ValueError, match="stacked layers"):
        load_jax_params(tm, params)
    tm = build_model(cfg, device="cpu")
    with pytest.raises(KeyError, match="no parameter"):
        load_jax_params(tm, dict(params, extra=params["dec_pos"]))


def test_vlm_decode_takes_embeds_or_token_ids():
    """The reference's token fallback: a (B, 1) id array is embedded through
    the table, and gives the logits of its embedding row."""
    cfg = get_arch("qwen2-vl-2b").smoke
    tm = build_model(cfg, device="cpu", rng=0)
    batch = to_torch(batch_of(cfg))
    ids = torch.tensor([[3], [7]])
    out = []
    with torch.no_grad():
        for step in (ids, {"embeds": tm.embed.tok[ids]}):
            cache = init_cache(tm, B, S, dtype=torch.float32)
            _, cache = tm.prefill(inputs({"embeds": batch["embeds"][:, :8]}),
                                  cache, compute_dtype=torch.float32)
            logits, cache = tm.decode_step(cache, step,
                                           compute_dtype=torch.float32)
            out.append(logits)
            assert cache["index"] == 9
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)


def test_mrope_matches_reference():
    from repro.models.common import apply_mrope as jax_mrope
    from repro_torch.models.common import apply_mrope
    r = np.random.default_rng(4)
    x = r.normal(size=(2, 16, 3, 32)).astype(np.float32) * 3
    pos3 = r.integers(0, 4096, (3, 2, 16)).astype(np.int32)
    for theta, sections in ((1e6, (4, 6, 6)), (1e4, (16, 0, 0))):
        want = jax_mrope(jnp.asarray(x), jnp.asarray(pos3), theta, sections)
        got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), theta,
                          sections)
        np.testing.assert_allclose(np32(got), np32(want), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="sum"):
        apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e4,
                    (4, 4, 4))


def test_sinusoidal_embedding_equals_reference():
    from repro.models.common import sinusoidal_embedding as jax_sin
    from repro_torch.models.common import sinusoidal_embedding
    for s, d in ((1500, 512), (7, 64)):
        np.testing.assert_array_equal(sinusoidal_embedding(s, d),
                                      jax_sin(s, d))


def test_flash_plain_version_at_head_dim_192_matches_reference():
    """nemotron-4-340b's head width through the fused op's plain version,
    against the reference's Pallas kernel in interpret mode (causal, GQA
    96 → 8 heads cut to 12 → 1)."""
    from repro.kernels.flash_attn import flash_attention_pallas
    from repro_torch.kernels import ops
    r = np.random.default_rng(5)
    q = r.normal(size=(1, 12, 128, 192)).astype(np.float32)
    k, v = (r.normal(size=(1, 1, 128, 192)).astype(np.float32)
            for _ in range(2))
    want = flash_attention_pallas(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), 12, axis=1),
        jnp.repeat(jnp.asarray(v), 12, axis=1), causal=True, interpret=True)
    got = ops.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                              causal=True)
    np.testing.assert_allclose(np32(got), np32(want), rtol=3e-5, atol=3e-5)


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-2.7b", "granite-34b",
                                  "deepseek-v3-671b", "dbrx-132b"])
def test_cli_serves_token_families(arch):
    from repro_torch.launch import serve
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--new-tokens",
                      "3"])
    tokens = out["tokens"]
    assert tokens.shape == (2, 3) and tokens.dtype == np.int32
    assert ((0 <= tokens) & (tokens < get_arch(arch).smoke.vocab_size)).all()


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-base"])
def test_cli_refuses_embedding_and_frame_families(arch, monkeypatch):
    """A clear ValueError before any model is built (the reference's CLI
    fails with a KeyError inside ``generate``)."""
    from repro_torch.launch import serve

    def no_build(*a, **kw):
        raise AssertionError("the model was built")

    monkeypatch.setattr(serve, "build_model", no_build)
    with pytest.raises(ValueError, match="token prompts"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])


def test_knn_lm_hook_stays_dense_only():
    from repro_torch.launch import serve
    for arch in ("xlstm-350m", "dbrx-132b"):
        with pytest.raises(ValueError, match="DenseLM"):
            serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--knn-lm"])
    from repro_torch.serve import KNNLMConfig, ServeEngine
    tm = build_model(get_arch("zamba2-2.7b").smoke, device="cpu")
    with pytest.raises(ValueError, match="DenseLM"):
        ServeEngine(tm, batch_size=1, max_seq=8, knn_lm=KNNLMConfig(),
                    device="cpu")
    whisper = build_model(get_arch("whisper-base").smoke, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        ServeEngine(whisper, batch_size=1, max_seq=8, device="cpu")
