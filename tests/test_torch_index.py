"""The port's k-NN query path as a whole, held against the JAX package on
the CPU.

* Carrying state across: a store built by ``repro.index.build_index`` loads
  into the port through ``IndexStore.from_arrays`` and computes what the
  reference computes; the port's own ``build_index`` reproduces the
  reference's layout and priors.
* Decisions: with the reference's block draws replayed through the port's
  ``block_sampler``, the epoch-fused race makes identical decisions — top-k
  ids, rounds, exact evaluations, accepted and surviving sets — with
  frontier compaction on and off. Values and coordinate-ops at fp32
  tolerance (rtol 2e-4 / atol 1e-5: sums taken in another order).
* Own draws: ``Index.build`` → ``Index.query`` on the port's generator
  returns the exact top-k sets of a numpy brute force.
  (The per-round driver's replayed races are in ``test_torch_rounds.py``.)
* Where the port departs from the reference on purpose (d_pad ≠ d: the
  race compares exact evaluations on the pulls' ρ/d_pad scale; ROADMAP.md
  Queue 3), it returns the exact top-k on an input where the reference
  does not.
"""
import ast
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import BMOConfig as JaxBMOConfig
from repro.data import synthetic as jsynthetic
from repro.index.batched_race import fused_race_topk as jax_fused_race_topk
from repro.index.batched_race import index_knn as jax_index_knn
from repro.index.builder import build_index as jax_build_index
from repro.index.store import IndexStore as JaxIndexStore
from repro_torch.api import Index
from repro_torch.configs.base import BMOConfig
from repro_torch.data import synthetic
from repro_torch.index import builder
from repro_torch.index.batched_race import fused_race_topk, index_knn
from repro_torch.index.store import IndexStore

from test_torch_replay import CASES, FP32, replay_sampler
from test_torch_replay import brute_force as _brute_force
from test_torch_replay import carry as _carry
from test_torch_replay import case_data as _data
from test_torch_replay import cfg_kw as _cfg_kw
from test_torch_replay import sets as _sets

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# carrying state across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rotate", [False, True], ids=["dense", "rotated"])
def test_from_arrays_carries_reference_store(rotate):
    corpus, queries = jsynthetic.make_knn_benchmark_data("dense", 60, 200, 3,
                                                         seed=4)
    jstore = jax_build_index(corpus, JaxBMOConfig(**_cfg_kw(rotate)),
                             jax.random.PRNGKey(3))
    store = IndexStore.from_arrays(*_carry(jstore), device="cpu")
    assert store.meta() == jstore.meta()
    assert store.kind == ("rotated" if rotate else "dense")
    for name, arr in jstore.arrays().items():
        np.testing.assert_array_equal(store.arrays()[name].numpy(),
                                      np.asarray(arr))
    assert store.n_live == jstore.n_live and store.capacity == jstore.capacity
    np.testing.assert_allclose(store.prepare_queries(queries).numpy(),
                               np.asarray(jstore.prepare_queries(queries)),
                               **FP32)


@pytest.mark.parametrize("rotate", [False, True], ids=["dense", "rotated"])
def test_build_index_matches_reference(monkeypatch, rotate):
    corpus, _ = jsynthetic.make_knn_benchmark_data("dense", 90, 300, 1,
                                                   seed=6)
    jstore = jax_build_index(corpus, JaxBMOConfig(**_cfg_kw(rotate)),
                             jax.random.PRNGKey(8))
    if rotate:   # the reference's signs, in place of the port's own draw
        monkeypatch.setattr(builder, "_rademacher",
                            lambda dp, g, dev: torch.from_numpy(
                                np.array(jstore.signs)))
    store = builder.build_index(corpus, BMOConfig(**_cfg_kw(rotate)),
                                device="cpu")
    assert store.meta() == jstore.meta()
    np.testing.assert_array_equal(store.alive.numpy(),
                                  np.asarray(jstore.alive))
    np.testing.assert_allclose(store.x.numpy(), np.asarray(jstore.x), **FP32)
    np.testing.assert_allclose(store.prior_var.numpy(),
                               np.asarray(jstore.prior_var), **FP32)


def test_rotated_build_draws_signs_from_the_generator():
    corpus = np.random.default_rng(0).normal(size=(10, 100)).astype(
        np.float32)
    cfg = BMOConfig(**_cfg_kw(True))
    a = builder.build_index(corpus, cfg, 5, device="cpu")
    b = builder.build_index(corpus, cfg, 5, device="cpu")
    c = builder.build_index(corpus, cfg, 6, device="cpu")
    assert a.signs.shape == (128,) and set(a.signs.tolist()) == {-1.0, 1.0}
    assert torch.equal(a.signs, b.signs) and not torch.equal(a.signs, c.signs)


def test_from_arrays_carries_a_sparse_reference_store():
    """A sparse store built by the reference (40 rows in 64 slots, one
    tombstone) comes across whole: the padded-CSR arrays bit for bit, the
    metadata unchanged, its width and live count."""
    from repro.index.mutable import delete as jax_delete
    cfg = JaxBMOConfig(k=3, delta=0.01, batch_arms=16, metric="l1", block=1,
                       pulls_per_round=8, init_pulls=16, sparse=True)
    jstore = jax_delete(jax_build_index(
        jsynthetic.clustered_sparse(40, 128, seed=3), cfg,
        jax.random.PRNGKey(0), capacity=64), [7])
    store = IndexStore.from_arrays(*_carry(jstore), device="cpu")
    assert store.kind == "sparse" and store.meta() == jstore.meta()
    assert (store.capacity, store.n_live, store.m, store.d) == \
        (64, 39, jstore.m, 128)
    assert sorted(store.arrays()) == sorted(jstore.arrays())
    for name, arr in store.arrays().items():
        np.testing.assert_array_equal(arr.numpy(),
                                      np.asarray(jstore.arrays()[name]))
    assert store.indices.dtype == torch.int32 and store.nnz.dtype == \
        torch.int32
    with pytest.raises(ValueError, match="triplet"):
        store.prepare_queries(np.zeros((1, 128), np.float32))


# ---------------------------------------------------------------------------
# decisions with the reference's draws replayed
# ---------------------------------------------------------------------------

def _race_both(jstore, store, queries, compaction, cfg_over=None):
    jcfg = jstore.cfg if cfg_over is None else dataclasses.replace(
        jstore.cfg, **cfg_over)
    cfg = store.cfg if cfg_over is None else dataclasses.replace(
        store.cfg, **cfg_over)
    key = jax.random.PRNGKey(5)
    want = jax_fused_race_topk(
        jstore.x, jstore.prepare_queries(queries), jstore.alive,
        jstore.prior_var, key, cfg=jcfg, block=jstore.block, d=jstore.d,
        impl="auto", eliminate=True, prior_weight=jstore.prior_weight,
        compaction=compaction, _return_state=True)
    got = fused_race_topk(
        store.x, store.prepare_queries(queries), store.alive,
        store.prior_var, cfg=cfg, block=store.block, d=store.d, impl="auto",
        eliminate=True, prior_weight=store.prior_weight,
        compaction=compaction, block_sampler=replay_sampler(key),
        _return_state=True)
    return want, got


def _assert_same_race(want, got):
    (jres, jst), (res, st) = want, got
    np.testing.assert_array_equal(res.indices.numpy(), np.asarray(jres.indices))
    np.testing.assert_array_equal(res.rounds.numpy(), np.asarray(jres.rounds))
    np.testing.assert_array_equal(res.n_exact.numpy(),
                                  np.asarray(jres.n_exact))
    np.testing.assert_allclose(res.values.numpy(), np.asarray(jres.values),
                               **FP32)
    np.testing.assert_allclose(res.coord_ops.numpy(),
                               np.asarray(jres.coord_ops), **FP32)
    assert st.width == jst.width

    def id_sets(ids, mask):
        ids, mask = np.asarray(ids), np.asarray(mask)
        return [set(ids[q][mask[q]].tolist()) for q in range(ids.shape[0])]

    for ours, theirs in (
            (st.accepted & st.valid, jst.accepted & jst.valid),
            (st.valid & ~st.rejected & ~st.accepted,
             jst.valid & ~jst.rejected & ~jst.accepted)):
        assert id_sets(st.ids, ours) == id_sets(jst.ids, theirs)


@pytest.mark.parametrize("compaction", [True, False], ids=["compact", "full"])
@pytest.mark.parametrize("case", list(CASES))
def test_replayed_race_makes_the_reference_decisions(case, compaction):
    corpus, queries, rotate = _data(case)
    jstore = jax_build_index(corpus, JaxBMOConfig(**_cfg_kw(rotate)),
                             jax.random.PRNGKey(0))
    store = IndexStore.from_arrays(*_carry(jstore), device="cpu")
    _assert_same_race(*_race_both(jstore, store, queries, compaction))


def test_fused_init_pulls_no_padding_rows(monkeypatch):
    """At capacity > n (3,000 rows pad to 4,096) the wide init gives the
    pull arm id −1 for every padding row, so it reads none of them, while
    the (Q, n, T0) draw keeps the reference's shape. The replayed race
    still makes the reference's decisions, and its state is bit for bit
    the one of an init that pulls the padding rows too."""
    from repro_torch.index import batched_race
    corpus, queries = jsynthetic.make_knn_benchmark_data("dense", 3000, 256,
                                                         4, seed=3)
    jstore = jax_build_index(corpus, JaxBMOConfig(**_cfg_kw(False)),
                             jax.random.PRNGKey(0))
    store = IndexStore.from_arrays(*_carry(jstore), device="cpu")
    assert (store.n_live, store.capacity) == (3000, 4096)
    pull = batched_race.kops.fused_epoch_pull
    seen = []

    def spy(x, qs, arm_idx, blk_idx, **kw):
        if not seen:                                 # the init's launch
            seen.append((arm_idx.clone(), tuple(blk_idx.shape),
                         arm_idx.stride()))
        return pull(x, qs, arm_idx, blk_idx, **kw)

    monkeypatch.setattr(batched_race.kops, "fused_epoch_pull", spy)
    want, got = _race_both(jstore, store, queries, True)
    _assert_same_race(want, got)
    arm, blk_shape, stride = seen[0]
    Q, cap = arm.shape
    assert blk_shape[:2] == (Q, cap) and stride[0] == 0
    assert (arm[:, 3000:] == -1).all()
    assert torch.equal(arm[:, :3000],
                       torch.arange(3000, dtype=arm.dtype).expand(Q, 3000))

    def padded(x, qs, arm_idx, blk_idx, **kw):      # every row pulled
        if blk_idx.shape[1] == cap:                  # the init's launch
            arm_idx = torch.arange(arm_idx.shape[1], dtype=arm_idx.dtype
                                   )[None].expand_as(arm_idx)
        return pull(x, qs, arm_idx, blk_idx, **kw)

    monkeypatch.setattr(batched_race.kops, "fused_epoch_pull", padded)
    _, again = _race_both(jstore, store, queries, True)
    (res, st), (res2, st2) = got, again
    for a, b in ((res.indices, res2.indices), (res.values, res2.values),
                 (res.rounds, res2.rounds), (res.coord_ops, res2.coord_ops),
                 (st.mean, st2.mean), (st.m2, st2.m2), (st.count, st2.count),
                 (st.accepted, st2.accepted), (st.ids, st2.ids)):
        assert torch.equal(a, b)


def test_replayed_race_with_tombstones_and_k_override():
    """Dead slots carried across through ``alive`` are never returned, and
    a k override races the same in both packages."""
    corpus, queries, _ = _data("n300-dense")
    jstore = jax_build_index(corpus, JaxBMOConfig(**_cfg_kw(False)),
                             jax.random.PRNGKey(0))
    truth = _brute_force(corpus, queries, 3)
    alive = np.asarray(jstore.alive).copy()
    kill = sorted(truth[0])[:2] + [7, 11]
    alive[kill] = False
    arrays, meta = _carry(jstore, alive=alive)
    jstore = JaxIndexStore.from_arrays(arrays, meta)
    store = IndexStore.from_arrays(arrays, meta, device="cpu")
    want, got = _race_both(jstore, store, queries, True, dict(k=2))
    _assert_same_race(want, got)
    assert got[0].indices.shape == (4, 2)
    for row in _sets(got[0].indices):
        assert not row & set(kill)


def test_exact_evaluation_is_on_the_pulls_scale(rng):
    """Pulls are block means over the d_pad-wide row, so an exact
    evaluation that the race compares with them is the mean over all
    blocks: ρ/d_pad, not ρ/d. Here d = 200 pads to d_pad = 256."""
    from repro_torch.index.batched_race import _dense_exact_theta
    from repro_torch.kernels import ref
    store = builder.build_index(rng.normal(size=(8, 200)).astype(np.float32),
                                BMOConfig(**_cfg_kw(True)), device="cpu")
    qs = store.prepare_queries(rng.normal(size=(3, 200)).astype(np.float32))
    nb = store.n_blocks
    sel = torch.tensor([[0, 5], [7, 2], [3, 3]])
    every_block = torch.arange(nb).expand(3, 2, nb)
    stats = ref.fused_epoch_pull_ref(store.x, qs, sel, every_block,
                                     store.block)
    torch.testing.assert_close(
        _dense_exact_theta(store.x, qs, sel, "l2", store.d_pad),
        stats[..., 0], rtol=2e-4, atol=1e-5)


def test_replayed_race_is_exact_where_the_reference_loses_recall():
    """With d_pad ≠ d (1100 → 2048) the reference's race returns the wrong
    top-k for queries 2, 6 and 7 of this input (ROADMAP.md Queue 3). The
    port, on the reference's own draws, returns the exact top-k, with the
    values θ = ρ/d."""
    corpus, queries = jsynthetic.make_knn_benchmark_data("dense", 3000,
                                                         1100, 8, seed=0)
    cfg = JaxBMOConfig(k=5, delta=0.01, block=128, batch_arms=32,
                       metric="l2", rotate=True)
    jstore = jax_build_index(corpus, cfg, jax.random.PRNGKey(0))
    store = IndexStore.from_arrays(*_carry(jstore), device="cpu")
    assert (store.d, store.d_pad) == (1100, 2048)
    c, q = corpus.astype(np.float64), queries.astype(np.float64)
    dist = (q * q).sum(1)[:, None] + (c * c).sum(1)[None] - 2.0 * q @ c.T
    truth = [set(r) for r in np.argsort(dist, 1, kind="stable")[:, :5].tolist()]

    want = jax_index_knn(jstore, queries, jax.random.PRNGKey(1))
    missed = [i for i, row in enumerate(_sets(want.indices)) if row != truth[i]]
    assert missed == [2, 6, 7]

    res = index_knn(store, queries,
                    block_sampler=replay_sampler(jax.random.PRNGKey(1)))
    assert _sets(res.indices) == truth
    theta = np.take_along_axis(dist, res.indices.numpy().astype(np.int64),
                               1) / store.d
    np.testing.assert_allclose(res.values.numpy(), theta, rtol=2e-4)


# ---------------------------------------------------------------------------
# the handle, on the port's own draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_index_query_finds_the_exact_neighbours(case):
    corpus, queries, rotate = _data(case)
    idx = Index.build(corpus, BMOConfig(**_cfg_kw(rotate)), device="cpu")
    res = idx.query(queries)
    assert res.indices.shape == (len(queries), 3)
    assert _sets(res.indices) == _brute_force(corpus, queries, 3)
    assert (np.diff(res.values, axis=1) >= 0).all()
    assert (res.coord_ops > 0).all() and (res.rounds > 0).all()


def test_index_query_spec_overrides():
    corpus, queries, _ = _data("n300-dense")
    idx = Index.build(corpus, BMOConfig(**_cfg_kw(False)), device="cpu")
    res = idx.query(queries, k=5, delta=0.05, mode="fused", impl="ref")
    assert res.indices.shape == (4, 5)
    assert _sets(res.indices) == _brute_force(corpus, queries, 5)
    res = idx.query(queries, k=5, delta=0.05, mode="rounds", impl="ref")
    assert _sets(res.indices) == _brute_force(corpus, queries, 5)
    with pytest.raises(ValueError, match="CUDA"):
        idx.query(queries, impl="cuda")


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    """On a machine without CUDA the entry points raise instead of quietly
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    corpus = np.zeros((4, 64), np.float32)
    cfg = BMOConfig(**_cfg_kw(False))
    with pytest.raises(RuntimeError, match="CUDA"):
        Index.build(corpus, cfg)
    jstore = jax_build_index(corpus, JaxBMOConfig(**_cfg_kw(False)),
                             jax.random.PRNGKey(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        IndexStore.from_arrays(*_carry(jstore))


# ---------------------------------------------------------------------------
# data and package guards
# ---------------------------------------------------------------------------

def test_synthetic_numpy_path_is_the_reference():
    want = jsynthetic.make_knn_benchmark_data("dense", 50, 96, 4, seed=3)
    got = synthetic.make_knn_benchmark_data("dense", 50, 96, 4, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_synthetic_device_path_is_seeded():
    a = synthetic.make_knn_benchmark_data("dense", 40, 32, 3, seed=1,
                                          device="cpu")
    b = synthetic.make_knn_benchmark_data("dense", 40, 32, 3, seed=1,
                                          device="cpu")
    c = synthetic.make_knn_benchmark_data("dense", 40, 32, 3, seed=2,
                                          device="cpu")
    assert a[0].shape == (40, 32) and a[1].shape == (3, 32)
    assert a[0].dtype == torch.float32 and a[1].dtype == torch.float32
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in files}
    tools = sorted((ROOT / "tools").glob("torch_*.py"))
    assert {"torch_replay_audit.py", "torch_main_qps.py"} <= {
        p.name for p in tools}
    files += [ROOT / "chip_smoke.py", *tools]
    assert {"core/oracle.py", "core/bmo_nn.py", "core/ucb.py",
            "core/datasets.py", "index/batched_race.py",
            "kernels/block_pull.py", "kernels/pairwise_dist.py",
            "checkpoint/manager.py", "checkpoint/msgpack_lite.py",
            "index/mutable.py", "api/handle.py", "index/anytime.py",
            "api/stream.py", "api/cache.py", "api/spec.py", "serve/plane.py",
            "serve/scale.py", "obs/__init__.py", "obs/registry.py",
            "obs/trace.py", "obs/profile.py", "utils/hostsync.py",
            "tune/__init__.py", "tune/signature.py", "tune/candidates.py",
            "tune/sidecar.py", "tune/seed.py", "tune/racer.py",
            "tune/autotune.py", "obs/audit.py", "obs/slo.py",
            "obs/export.py", "obs/health.py", "hardware.py",
            "serve/engine.py", "serve/steps.py", "launch/serve.py",
            "utils/logging.py", "data/synthetic.py",
            "models/convert.py", "fleet/__init__.py", "fleet/core.py",
            "fleet/manifest.py", "fleet/placement.py"} <= names
    for path in files:
        bad = set(_imported_roots(path)) & {"jax", "jaxlib", "repro",
                                            "msgpack"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
