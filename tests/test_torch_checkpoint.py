"""The port's index files, held against the JAX package on the CPU.

* The codec: ``checkpoint.msgpack_lite`` writes the bytes that
  ``msgpack.packb`` writes, for both packages' index metadata, at every
  format boundary and on random nested values (hypothesis), reads what
  ``msgpack.packb`` writes, and refuses any other type with ``TypeError``.
* The directory: ``staged_dir`` publishes all or nothing.
* Both directions: an index directory saved by ``repro.api.Index.save``
  (dense or rotated, with a payload) loads through
  ``repro_torch.api.Index.load`` with its arrays, metadata and payload bit
  for bit, and one saved by the port loads through the reference's
  ``Index.load`` the same way. On the reference's replayed draws, both
  packages' races over the loaded stores make the same decisions: top-k
  ids, rounds and exact evaluations exact, values at fp32 tolerance
  (rtol 2e-4 / atol 1e-5); d = 100 pads to d_pad = 128, so both race with
  d = d_pad (``test_torch_mutable.assert_same_race_on_the_pulls_scale``).
* ``restore`` and ``CheckpointManager``: a nested state with a bf16 leaf
  round trips under the reference's ``/``-joined keys; step directories
  written by either package's manager restore in the other; keep-last-N,
  the async save's host snapshot, an empty directory, a missing key, and a
  save killed mid-publish that keeps the previous step.
"""
import dataclasses
import math
import os

import jax
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.api import Index as JaxIndex
from repro.configs.base import BMOConfig as JaxBMOConfig
from repro.data import synthetic as jsynthetic
from repro.index.builder import build_index as jax_build_index
from repro_torch.api import Index
from repro_torch.checkpoint import manager, msgpack_lite
from repro_torch.configs.base import BMOConfig
from repro_torch.index.store import IndexStore

from test_torch_mutable import assert_same_race_on_the_pulls_scale
from test_torch_replay import carry, cfg_kw

# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_over", [{}, dict(sigma=0.25, epsilon=0.1),
                                      dict(metric="l1", max_rounds=7)],
                         ids=["defaults", "sigma", "l1"])
@pytest.mark.parametrize("rotate", [False, True], ids=["dense", "rotated"])
def test_packb_is_msgpack_on_both_packages_meta(rotate, cfg_over):
    corpus, _ = jsynthetic.make_knn_benchmark_data("dense", 40, 100, 1,
                                                   seed=2)
    kw = dict(cfg_kw(rotate), **cfg_over)
    if kw["metric"] == "l1":
        kw["rotate"] = False
    jstore = jax_build_index(corpus, JaxBMOConfig(**kw),
                             jax.random.PRNGKey(0))
    store = IndexStore.from_arrays(*carry(jstore), device="cpu")
    for meta in (jstore.meta(), store.meta()):
        assert msgpack_lite.packb(meta) == msgpack.packb(meta)
        assert msgpack_lite.unpackb(msgpack.packb(meta)) == meta
        assert msgpack.unpackb(msgpack_lite.packb(meta)) == meta


EDGES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
    2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
    -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.0, -0.0, 1.5, 1e300, -2.5e-310,
    math.inf, -math.inf, math.nan, "", "é", "a" * 31, "a" * 32, "a" * 255,
    "a" * 256, "a" * 65535, "a" * 65536, "ü" * 16, [], list(range(15)),
    list(range(16)), list(range(65535)), list(range(65536)), (1, "two"),
    {}, {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {str(i): None for i in range(65536)}, {"a": [{"b": (1.0, None)}]},
]


@pytest.mark.parametrize("value", EDGES,
                         ids=[f"{type(v).__name__}{i}"
                              for i, v in enumerate(EDGES)])
def test_packb_is_msgpack_at_every_format_edge(value):
    packed = msgpack_lite.packb(value)
    assert packed == msgpack.packb(value)
    assert msgpack_lite.packb(msgpack_lite.unpackb(packed)) == packed
    assert msgpack_lite.packb(msgpack.unpackb(packed)) == packed


_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
            | st.floats(allow_nan=False) | st.text())
_values = st.recursive(
    _scalars, lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text(max_size=40), inner, max_size=20),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_values)
def test_codec_round_trips_both_ways(value):
    ours = msgpack_lite.packb(value)
    assert ours == msgpack.packb(value)
    assert msgpack.unpackb(ours) == value
    assert msgpack_lite.unpackb(msgpack.packb(value)) == value


def test_tuples_pack_as_arrays_and_read_back_as_lists():
    value = {"shape": (3, 4), "nested": ((1,), [2, (3,)])}
    assert msgpack_lite.packb(value) == msgpack.packb(value)
    assert msgpack_lite.unpackb(msgpack_lite.packb(value)) == \
        {"shape": [3, 4], "nested": [[1], [2, [3]]]}


def test_unpackb_reads_msgpacks_float32():
    assert msgpack_lite.unpackb(msgpack.packb(1.5, use_single_float=True)) \
        == 1.5


@pytest.mark.parametrize("bad", [
    b"bytes", bytearray(b"x"), {1, 2}, 1 + 2j, object(), np.int64(3),
    np.bool_(True), np.zeros(2), {1: "int key"}, [b"nested"],
    {"a": {"b": {None: 1}}}])
def test_packb_refuses_other_types(bad):
    with pytest.raises(TypeError):
        msgpack_lite.packb(bad)


@pytest.mark.parametrize("big", [2 ** 64, -2 ** 63 - 1])
def test_packb_refuses_integers_msgpack_cannot_hold(big):
    with pytest.raises(OverflowError):
        msgpack.packb(big)
    with pytest.raises(OverflowError):
        msgpack_lite.packb(big)


@pytest.mark.parametrize("data", [
    msgpack.packb([1, 2]) + b"\x00", msgpack.packb("abc")[:-1], b"\xc4\x01x",
    b"\xc1", msgpack.packb({1: 2})], ids=["extra", "truncated", "bin",
                                          "never-used", "int-key"])
def test_unpackb_refuses_malformed_data(data):
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(data)


# ---------------------------------------------------------------------------
# the directory
# ---------------------------------------------------------------------------

def test_staged_dir_publishes_all_or_nothing(tmp_path):
    path = str(tmp_path / "ckpt")
    with manager.staged_dir(path) as tmp:
        with open(os.path.join(tmp, "a"), "w") as f:
            f.write("first")
    assert os.listdir(path) == ["a"]
    with pytest.raises(RuntimeError, match="mid-write"):
        with manager.staged_dir(path) as tmp:
            with open(os.path.join(tmp, "b"), "w") as f:
                f.write("second")
            raise RuntimeError("mid-write")
    assert os.listdir(path) == ["a"]
    with open(os.path.join(path, "a")) as f:
        assert f.read() == "first"
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]     # no tmp sibling left


def test_save_writes_the_reference_layout(tmp_path):
    from repro.checkpoint import manager as jmanager
    path = str(tmp_path / "ckpt")
    arrays = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
              "b": torch.tensor([0.5, -1.0]),
              "c": np.array([True, False])}
    manager.save(path, arrays, meta={"k": [1, "x"]},
                 extra=lambda tmp: open(os.path.join(tmp, "side"), "w").close())
    assert sorted(os.listdir(path)) == ["arrays.npz", "meta.msgpack", "side"]
    for got in (manager.load_arrays(path), jmanager.load_arrays(path)):
        np.testing.assert_array_equal(got["a"], arrays["a"].numpy())
        assert got["b"].dtype == np.float32
        np.testing.assert_array_equal(got["b"], [0.5, -1.0])
        np.testing.assert_array_equal(got["c"], arrays["c"])
    assert manager.read_meta(path) == jmanager.read_meta(path) == \
        {"k": [1, "x"]}


def test_cpu_load_does_not_alias_its_input():
    corpus, _ = jsynthetic.make_knn_benchmark_data("dense", 30, 64, 1, seed=1)
    jstore = jax_build_index(corpus, JaxBMOConfig(**cfg_kw(False)),
                             jax.random.PRNGKey(0))
    ro, meta = carry(jstore)
    arrays = {k: np.array(v) for k, v in ro.items()}        # writable
    keep = {k: v.copy() for k, v in arrays.items()}
    store = IndexStore.from_arrays(arrays, meta, device="cpu")
    for name, a in store.arrays().items():
        assert not np.shares_memory(a.numpy(), arrays[name])
    arrays["x"][:] = 7.0
    arrays["alive"][:] = False
    np.testing.assert_array_equal(store.x.numpy(), keep["x"])
    np.testing.assert_array_equal(store.alive.numpy(), keep["alive"])
    # a read-only view (as np.asarray gives of a JAX array) loads too
    assert not ro["x"].flags.writeable
    again = IndexStore.from_arrays(ro, meta, device="cpu")
    np.testing.assert_array_equal(again.x.numpy(), keep["x"])


# ---------------------------------------------------------------------------
# both directions
# ---------------------------------------------------------------------------

def _small(rotate):
    corpus, queries = jsynthetic.make_knn_benchmark_data("dense", 300, 100,
                                                         4, seed=5)
    return corpus, queries, cfg_kw(rotate)


def _assert_same_index(jidx, idx):
    """Arrays, metadata and payload of the two handles, bit for bit."""
    assert idx.store.meta() == jidx.store.meta()
    mine, theirs = idx.store.arrays(), jidx.store.arrays()
    assert sorted(mine) == sorted(theirs)
    for name, arr in theirs.items():
        want = np.asarray(arr)
        got = mine[name].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert idx.payload.dtype == jidx.payload.dtype
    np.testing.assert_array_equal(idx.payload, jidx.payload)


@pytest.mark.parametrize("rotate", [False, True], ids=["dense", "rotated"])
def test_the_port_loads_what_the_reference_saved(tmp_path, rotate):
    corpus, queries, kw = _small(rotate)
    jidx = JaxIndex.build(corpus, JaxBMOConfig(**kw), jax.random.PRNGKey(0),
                          payload=np.arange(300, dtype=np.int32) * 3)
    jidx.delete([4, 9, 250])
    path = str(tmp_path / "jax-index")
    jidx.save(path)
    idx = Index.load(path, device="cpu")
    _assert_same_index(jidx, idx)
    assert (idx.capacity, idx.n_live, idx.kind) == (512, 297, jidx.kind)
    assert_same_race_on_the_pulls_scale(jidx.store, idx.store, queries)


@pytest.mark.parametrize("rotate", [False, True], ids=["dense", "rotated"])
def test_the_reference_loads_what_the_port_saved(tmp_path, rotate):
    corpus, queries, kw = _small(rotate)
    idx = Index.build(corpus, BMOConfig(**kw), 3, device="cpu",
                      payload=np.arange(300, dtype=np.int64) - 5)
    idx.delete([0, 299])
    idx.insert(queries[:2] + 1e-3, payload=[-1, -2])
    path = str(tmp_path / "port-index")
    idx.save(path)
    jidx = JaxIndex.load(path)
    _assert_same_index(jidx, idx)
    assert jidx.n_live == idx.n_live == 300
    assert_same_race_on_the_pulls_scale(jidx.store, idx.store, queries)
    # and the reference's directory reader agrees on both files
    from repro.checkpoint import manager as jmanager
    assert jmanager.read_meta(path) == manager.read_meta(path) == \
        idx.store.meta()
    assert dataclasses.asdict(idx.cfg) == dataclasses.asdict(jidx.cfg)


# ---------------------------------------------------------------------------
# restore and the keep-last-N manager
# ---------------------------------------------------------------------------

def _state(seed=0):
    """A nested training state: fp32, a bf16 leaf, ints, a 0-d step."""
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 8, generator=g),
                       "b": torch.randn(8, generator=g).to(torch.bfloat16)},
            "opt": {"m": [torch.ones(4, 8), torch.arange(8)]},
            "step": torch.tensor(17, dtype=torch.int32)}


def _like(state):
    """``(shape, dtype)`` specs of a state's leaves."""
    if isinstance(state, dict):
        return {k: _like(v) for k, v in state.items()}
    if isinstance(state, list):
        return [_like(v) for v in state]
    return (tuple(state.shape), state.dtype)


def _assert_same(got, want):
    flat_g, flat_w = manager._flatten(got), manager._flatten(want)
    assert flat_g.keys() == flat_w.keys()
    for key, w in flat_w.items():
        assert flat_g[key].dtype == w.dtype, key
        assert torch.equal(flat_g[key], w), key


def _jax_state(seed=0):
    k = jax.random.PRNGKey(seed)
    return {"params": {"w": jax.random.normal(k, (4, 8)),
                       "b": jax.numpy.arange(8, dtype=jax.numpy.bfloat16)},
            "opt": {"m": [jax.numpy.ones((4, 8)),
                          jax.numpy.arange(8, dtype=jax.numpy.int32)]},
            "step": jax.numpy.asarray(17, jax.numpy.int32)}


def test_bf16_round_trip_and_the_reference_keys(tmp_path):
    """bf16 is stored upcast to fp32 under the reference's ``/``-joined
    keys and comes back as bf16, bit for bit; a template of tensors or of
    specs gives the same state."""
    st = _state()
    path = str(tmp_path / "ck")
    manager.save(path, st, meta={"step": 17})
    arrays = manager.load_arrays(path)
    assert sorted(arrays) == ["opt/m/0", "opt/m/1", "params/b", "params/w",
                              "step"]
    assert arrays["params/b"].dtype == np.float32
    _assert_same(manager.restore(path, st), st)
    _assert_same(manager.restore(path, _like(st), device="cpu"), st)
    assert manager.read_meta(path)["step"] == 17


def test_restore_missing_key_or_shape_raises_and_needs_a_device(
        tmp_path, monkeypatch):
    st = _state()
    path = str(tmp_path / "ck")
    manager.save(path, st)
    with pytest.raises(KeyError, match="extra"):
        manager.restore(path, {**st, "extra": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        manager.restore(path, {"step": torch.zeros(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        manager.restore(path, _like(st))    # specs: the GPU by default


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_step_dirs_written_by_either_package_restore_in_the_other(
        tmp_path, writer):
    from repro.checkpoint import CheckpointManager as JaxCheckpointManager
    want = _jax_state()
    if writer == "reference":
        jm = JaxCheckpointManager(str(tmp_path), keep=2, async_save=False)
        for step in (1, 2):
            jm.save(step, want, meta={"who": "jax"})
        got, meta = manager.CheckpointManager(
            str(tmp_path), keep=2).restore_latest(
                _like(jax.tree_util.tree_map(
                    lambda a: torch.zeros(a.shape, dtype={
                        "float32": torch.float32, "int32": torch.int32,
                        "bfloat16": torch.bfloat16}[str(a.dtype)]), want)),
                device="cpu")
        assert meta == {"who": "jax", "step": 2}
        for key, w in manager._flatten(jax.device_get(want)).items():
            g = manager._flatten(got)[key]
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))
        assert got["params"]["b"].dtype == torch.bfloat16
        return
    st = {"params": {"w": torch.tensor(np.asarray(want["params"]["w"])),
                     "b": torch.arange(8).to(torch.bfloat16)},
          "opt": {"m": [torch.ones(4, 8), torch.arange(8, dtype=torch.int32)]},
          "step": torch.tensor(17, dtype=torch.int32)}
    pm = manager.CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2):
        pm.save(step, st, meta={"who": "torch"})
    pm.wait()
    jm = JaxCheckpointManager(str(tmp_path), keep=2)
    back, meta = jm.restore_latest(jax.eval_shape(lambda: want))
    assert meta == {"who": "torch", "step": 2}
    assert back["params"]["b"].dtype == jax.numpy.bfloat16
    for key, w in manager._flatten(st).items():
        np.testing.assert_array_equal(
            np.asarray(manager._flatten(back)[key], np.float32),
            w.float().numpy())


def test_manager_keep_last_n_async_and_empty(tmp_path):
    """Keep-last-N over four async saves; the state is snapshotted before
    ``save`` returns (an in-place update after it is not in the step); an
    empty directory restores (None, None); no tmp sibling is left."""
    empty = manager.CheckpointManager(str(tmp_path / "empty"), keep=3)
    assert empty.restore_latest(_like(_state()), device="cpu") == (None,
                                                                   None)
    assert empty.latest_step() is None
    mgr = manager.CheckpointManager(str(tmp_path / "ck"), keep=2,
                                    async_save=True)
    st = _state()
    for step in (10, 20, 30, 40):
        mgr.save(step, st)
        st["params"]["w"].add_(1.0)         # after save returned
    mgr.wait()
    assert mgr.all_steps() == [30, 40] and mgr.latest_step() == 40
    back, meta = mgr.restore_latest(_state(), device="cpu")
    assert meta["step"] == 40
    want = _state()["params"]["w"]
    for _ in range(3):                      # the updates before step 40
        want.add_(1.0)
    np.testing.assert_array_equal(back["params"]["w"].numpy(), want.numpy())
    assert not [p for p in os.listdir(tmp_path / "ck") if ".tmp" in p]
    with pytest.raises(ValueError, match="keep"):
        manager.CheckpointManager(str(tmp_path / "x"), keep=0)


def test_killed_save_keeps_the_previous_step(tmp_path, monkeypatch):
    """A save killed mid-publish (the arrays file fails to write) raises
    from ``wait`` and leaves the previous step whole and the latest one."""
    mgr = manager.CheckpointManager(str(tmp_path), keep=3, async_save=True)
    st = _state()
    mgr.save(1, st)
    mgr.wait()
    real = np.savez

    def boom(file, **arrays):
        real(file, **arrays)
        raise OSError("killed mid-publish")

    monkeypatch.setattr(manager.np, "savez", boom)
    mgr.save(2, _state(seed=1))
    with pytest.raises(OSError, match="mid-publish"):
        mgr.wait()
    monkeypatch.undo()
    assert mgr.all_steps() == [1]
    assert not [p for p in os.listdir(tmp_path) if ".tmp" in p]
    back, meta = mgr.restore_latest(st, device="cpu")
    assert meta["step"] == 1
    _assert_same(back, st)
