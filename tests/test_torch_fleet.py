"""The port's namespace fleet (``repro_torch.fleet``) on the CPU: each
scenario of the reference's ``tests/test_fleet.py`` run on the port (the
two-sharded-namespaces case in process, its shards on a repeated ``cpu``
device), and the port held to the JAX package: the placement planner and
the fleet pressure policy on the same inputs, fleet roots written by either
package opened by the other, and one step-by-step replay of namespaced
tickets through both packages' fleet planes with evictions and reloads
mid-stream, on the reference's draws.

Sizes are the reference's (n ≤ 320, d = 128, so d_pad = d on both sides).
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.api import ServeStats as JaxServeStats
from repro.configs.base import BMOConfig as JaxBMOConfig
from repro.data import synthetic as jsynthetic
from repro.fleet import Fleet as JaxFleet
from repro.fleet import FleetConfig as JaxFleetConfig
from repro.fleet import device_load as jax_device_load
from repro.fleet import plan_placement as jax_plan_placement
from repro.serve.scale import FleetPressurePolicy as JaxFleetPressurePolicy
from repro_torch.api import Index, ServeStats
from repro_torch.configs.base import BMOConfig
from repro_torch.fleet import (Fleet, FleetConfig, device_load,
                               load_manifest, plan_placement)
from repro_torch.obs.audit import exact_topk
from repro_torch.serve.plane import PlaneConfig, RequestPlane
from repro_torch.serve.scale import (FleetPressurePolicy, ScaleDecision,
                                     apply_fleet)
from repro_torch.tune import TunedConfig

from test_torch_plane import _replayed, _view

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _cfg(**kw):
    base = dict(k=4, delta=0.01, block=64, batch_arms=16, pulls_per_round=2,
                metric="l2")
    base.update(kw)
    return BMOConfig(**base)


def _corpus(n=160, d=128, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _fleet(tmp_path, max_resident=2, **kw):
    return Fleet(str(tmp_path / "fleet"),
                 FleetConfig(max_resident=max_resident, **kw), device=CPU)


# ---------------------------------------------------------------------------
# lifecycle + LRU residency
# ---------------------------------------------------------------------------


def test_lifecycle_and_lru_residency(tmp_path):
    root = str(tmp_path / "fleet")
    fleet = _fleet(tmp_path)
    for i, name in enumerate(("a", "b", "c")):
        fleet.create(name, _corpus(seed=i), _cfg(), i)
    assert fleet.namespaces == ["a", "b", "c"]
    assert fleet.resident_count == 2 and fleet.evicted_count == 1
    assert fleet.resident == ["b", "c"] and fleet.peek("a") is None
    assert os.path.isdir(os.path.join(root, "ns", "a"))   # durable from birth

    idx = fleet.get("a")                    # reload on touch
    assert idx.n_live == 160 and fleet.reload_count == 1
    assert idx.device.type == "cpu"
    assert fleet.resident_count == 2 and "a" in fleet.resident

    with pytest.raises(ValueError, match="already exists"):
        fleet.create("a", _corpus(), _cfg())
    with pytest.raises(ValueError, match="bad namespace name"):
        fleet.create("no/slashes", _corpus(), _cfg())
    with pytest.raises(KeyError):
        fleet.get("nope")

    assert apply_fleet(fleet, ScaleDecision("evict_namespace", target="a"))
    assert fleet.peek("a") is None
    assert not fleet.evict("a")             # already cold: refused
    with pytest.raises(ValueError, match="n_devices"):
        apply_fleet(fleet, ScaleDecision("rebalance"))   # the CPU: say how many
    assert apply_fleet(fleet, ScaleDecision("rebalance"), n_devices=1)

    fleet.drop("b")
    assert "b" not in fleet and len(fleet) == 2
    assert not os.path.exists(os.path.join(root, "ns", "b"))


def test_open_recovers_manifest_with_sidecars(tmp_path):
    root = str(tmp_path / "fleet")
    ids = np.arange(160, dtype=np.int32)
    fleet = Fleet(root, FleetConfig(max_resident=4), device=CPU)
    fleet.create("a", _corpus(seed=1), _cfg(), 0, payload=ids)
    fleet.create("b", _corpus(seed=2), _cfg(), 1, max_queue=3)
    t = TunedConfig(epoch_rounds=4, pulls_per_round=1, batch_arms=16)
    fleet.get("a")._apply_tuned(t)          # dirties the epoch
    assert fleet.flush() >= 1               # checkpoints the dirty namespace

    fl2 = Fleet.open(root, device=CPU)
    assert fl2.namespaces == ["a", "b"]
    assert fl2.resident_count == 0          # nothing materialized yet
    assert fl2.namespace_max_queue("b") == 3
    assert fl2.namespace_max_queue("a") is None
    a2 = fl2.get("a")
    assert a2.tuned == t                    # the tuned sidecar rode the reload
    np.testing.assert_array_equal(a2.payload, fleet.get("a").payload)

    doc = load_manifest(root)
    assert doc["version"] == 1 and sorted(doc["namespaces"]) == ["a", "b"]
    with pytest.raises(FileNotFoundError):
        Fleet.open(str(tmp_path / "not_a_fleet"), device=CPU)


# ---------------------------------------------------------------------------
# shared plane: cache isolation, bit-identical reload, fairness, guard
# ---------------------------------------------------------------------------


def test_namespace_cache_isolation_on_shared_plane(tmp_path):
    """Two namespaces given identical query vectors never exchange cached
    rows; a namespace dropped and created again starts cold."""
    ca, cb = _corpus(seed=1), _corpus(seed=2)
    fleet = _fleet(tmp_path, max_resident=4)
    fleet.create("a", ca, _cfg(), 0)
    fleet.create("b", cb, _cfg(), 0)
    plane = fleet.serve()
    q = ca[:2]

    ra = plane.query(q, rng=5, namespace="a")
    rb = plane.query(q, rng=5, namespace="b")
    assert not np.array_equal(ra.values, rb.values)
    ref = Index.build(cb, _cfg(), 0, device=CPU).query(q, 5)
    assert rb.indices.tolist() == ref.indices.tolist()

    hits0 = fleet._cache.hits               # an exact repeat in a namespace
    ra2 = plane.query(q, rng=9, namespace="a")
    assert fleet._cache.hits >= hits0 + q.shape[0]
    assert ra2.indices.tolist() == ra.indices.tolist()

    fleet.drop("a")
    fleet.create("a", cb, _cfg(), 0)
    hits1 = fleet._cache.hits
    r3 = plane.query(q, rng=5, namespace="a")
    assert fleet._cache.hits == hits1       # cold, as required
    assert r3.indices.tolist() == ref.indices.tolist()


def test_evict_reload_bit_identical_topk(tmp_path):
    c = _corpus(seed=3)
    fleet = _fleet(tmp_path)
    fleet.create("x", c, _cfg(), 0,
                 payload=np.arange(c.shape[0], dtype=np.int32))
    plane = fleet.serve()
    q = c[:3] + 0.01

    before = plane.query(q, rng=7, namespace="x", cache="bypass")
    assert fleet.evict("x") and fleet.peek("x") is None
    after = plane.query(q, rng=7, namespace="x", cache="bypass")
    assert fleet.reload_count == 1 and fleet.eviction_count >= 1
    np.testing.assert_array_equal(before.indices, after.indices)
    np.testing.assert_array_equal(before.values, after.values)
    np.testing.assert_array_equal(
        fleet.get("x").payload[before.indices],
        fleet.get("x").payload[after.indices])

    st = plane.stats
    assert st.fleet_namespaces_resident == 1
    assert st.fleet_namespaces_evicted == 0
    assert st.fleet_reloads == 1
    assert st.ns_queue_depth == {}          # drained
    ns_series = {(m.name, dict(m.labels)["namespace"]): m.value
                 for m in plane.obs.registry.collect()
                 if m.name.startswith("repro_plane_ns_")
                 and dict(m.labels)["plane"] == plane.plane_id}
    assert ns_series == {("repro_plane_ns_submitted_total", "x"): 2,
                         ("repro_plane_ns_completed_total", "x"): 2,
                         ("repro_plane_ns_queue_depth", "x"): 0}


def test_eviction_guard_refuses_inflight_namespace(tmp_path):
    c = _corpus(seed=4)
    fleet = _fleet(tmp_path)
    fleet.create("x", c, _cfg(), 0)
    plane = fleet.serve()
    t = plane.submit(c[:2], rng=1, namespace="x", cache="bypass")
    assert plane.namespace_load() == {"x": 1}
    assert fleet.evict("x") is False        # a ticket in flight: refused
    with pytest.raises(RuntimeError, match="in-flight"):
        fleet.drop("x")
    plane.drain()
    assert t.result.terminal
    assert fleet.evict("x") is True         # quiesced: allowed


def test_hot_namespace_cannot_starve_cold(tmp_path):
    """Admission round-robins over (tenant, namespace) queues: a cold
    namespace's one ticket rides the next race group while a hot namespace
    floods the plane, and its reload is transparent."""
    ca, cb = _corpus(seed=1), _corpus(seed=2)
    fleet = _fleet(tmp_path)
    fleet.create("hot", ca, _cfg(), 0)
    fleet.create("cold", cb, _cfg(), 1)
    plane = fleet.serve(PlaneConfig(max_group_queries=8,
                                    max_active_groups=2))
    assert fleet.evict("cold")

    heavy = [plane.submit(ca[:4] + i, tenant="t", namespace="hot", rng=i,
                          cache="bypass")
             for i in range(6)]
    cold = plane.submit(cb[:4], tenant="t", namespace="cold", rng=99,
                        cache="bypass")
    assert fleet.peek("cold") is not None   # reloaded at submit
    plane.step()
    assert cold.admitted_at is not None
    assert heavy[0].admitted_at is not None
    assert all(t.admitted_at is None for t in heavy[1:])
    plane.drain()
    assert cold.finished_at <= min(t.finished_at for t in heavy[1:])
    assert cold.result.reason == "certified"
    assert all(t.result.reason == "certified" for t in heavy)


def test_router_plane_requires_namespace(tmp_path):
    fleet = _fleet(tmp_path)
    fleet.create("x", _corpus(), _cfg(), 0)
    plane = fleet.serve()
    with pytest.raises(ValueError):
        plane.submit(_corpus()[:2], rng=0)              # no namespace
    with pytest.raises(KeyError):
        plane.submit(_corpus()[:2], rng=0, namespace="ghost")
    with pytest.raises(ValueError):
        RequestPlane()                      # neither index nor router


def test_fleet_plane_default_namespace_enables_audit(tmp_path):
    """``fleet.serve(default=ns)`` binds that namespace's handle as the
    plane's default index and hands the auditor the router: every
    namespace's certified traffic is δ-audited against its own ground
    truth, keyed by namespace. The bound handle stays resident."""
    fleet = _fleet(tmp_path)
    fleet.create("a", _corpus(seed=1), _cfg(), 0)
    fleet.create("b", _corpus(seed=2), _cfg(), 1)
    plane = fleet.serve(PlaneConfig(audit_rate=1.0), default="a")
    assert plane.auditor is not None and plane.index is fleet.peek("a")
    q = _corpus(seed=3)[:2]
    ra = plane.query(q, rng=5, namespace="a", cache="bypass")
    r0 = plane.query(q, rng=5, cache="bypass")
    assert r0.indices.tolist() == ra.indices.tolist()  # routed to 'a'
    plane.query(q, rng=6, namespace="b", cache="bypass")
    plane.audit_flush()
    a = plane.auditor.summary()
    assert a["sampled_rows"] == 3 * q.shape[0]
    assert a["mismatch_rows"] == 0
    assert plane.auditor.skipped["namespaced"] == 0
    by_ns = {k["namespace"]: k for k in a["keys"]}
    assert by_ns[""]["sampled"] == q.shape[0]
    assert by_ns["a"]["sampled"] == q.shape[0]
    assert by_ns["b"]["sampled"] == q.shape[0]
    assert not fleet.evict("a")             # pinned by the plane
    assert fleet.evict("b")


def test_fleet_router_only_plane_audits_namespaces(tmp_path):
    """A router-only plane audits too: namespaced tickets resolve their
    index through the fleet when the oracle runs, and a namespace dropped
    before that counts as unroutable."""
    fleet = _fleet(tmp_path)
    fleet.create("a", _corpus(seed=1), _cfg(), 0)
    fleet.create("b", _corpus(seed=2), _cfg(), 1)
    plane = fleet.serve(PlaneConfig(audit_rate=1.0))
    assert plane.auditor is not None and plane.index is None
    q = _corpus(seed=3)[:2]
    plane.query(q, rng=5, namespace="a", cache="bypass")
    plane.query(q, rng=6, namespace="b", cache="bypass")
    fleet.drop("b")
    plane.audit_flush()
    a = plane.auditor.summary()
    assert a["sampled_rows"] == q.shape[0]
    assert a["mismatch_rows"] == 0
    assert a["skipped"]["unroutable"] == 1
    assert [k["namespace"] for k in a["keys"]] == ["a"]


def test_swap_on_a_fleet_handle_fences_only_its_namespace(tmp_path):
    """A mutation of one namespace clears its own cached rows and no other
    namespace's: the shared cache keeps the rest warm."""
    ca, cb = _corpus(seed=1), _corpus(seed=2)
    fleet = _fleet(tmp_path)
    a = fleet.create("a", ca, _cfg(), 0)
    fleet.create("b", cb, _cfg(), 1)
    plane = fleet.serve()
    q = ca[:2]
    plane.query(q, rng=5, namespace="a")
    rb = plane.query(q, rng=5, namespace="b")
    cache = fleet._cache
    assert len(cache) == 4
    a.insert(ca[:1] + 3.0)                  # the epoch fence of 'a'
    assert len(cache) == 2
    hits = cache.hits
    assert plane.query(q, rng=9, namespace="b").indices.tolist() \
        == rb.indices.tolist()
    assert cache.hits == hits + 2           # 'b' stayed warm
    plane.query(q, rng=9, namespace="a")
    assert cache.hits == hits + 2           # 'a' raced again


# ---------------------------------------------------------------------------
# placement + pressure policy
# ---------------------------------------------------------------------------


def test_placement_plan_deterministic_and_balanced():
    fp = {"big": (2, 1000), "s1": (1, 10), "s2": (1, 10)}
    plan = plan_placement(fp, 4)
    assert plan == plan_placement(fp, 4)
    assert plan["big"] == 0
    assert plan["s1"] != plan["big"] or plan["s1"] >= 2
    load = device_load(fp, plan, 4)
    assert load.max() == pytest.approx(500.0)
    assert plan_placement({"span": (8, 100)}, 4)["span"] == 0
    with pytest.raises(ValueError):
        plan_placement(fp, 0)


@pytest.mark.parametrize("seed", range(4))
def test_placement_is_the_references_plan(seed):
    r = np.random.default_rng(seed)
    fp = {f"ns{i}": (int(r.integers(1, 5)), int(r.integers(0, 40)))
          for i in range(int(r.integers(1, 24)))}
    for n_devices in (1, 2, 3, 4, 8):
        plan = plan_placement(fp, n_devices)
        assert plan == jax_plan_placement(fp, n_devices)
        np.testing.assert_array_equal(
            device_load(fp, plan, n_devices),
            jax_device_load(fp, plan, n_devices))


def test_fleet_pressure_policy_recommends_and_cools_down():
    pol = FleetPressurePolicy(high_queue=4, sustain=2, cooldown=1, skew=0.9)
    st = ServeStats(ns_queue_depth={"a": 5, "b": 1},
                    fleet_namespaces_resident=2)
    assert pol.recommend(st).action == "none"
    d = pol.recommend(st)
    assert d.action == "evict_namespace" and d.target == "b"
    assert pol.recommend(st).reason == "cooldown"

    skewed = FleetPressurePolicy(high_queue=4, sustain=1, skew=0.5)
    d2 = skewed.recommend(ServeStats(ns_queue_depth={"a": 9, "b": 1}))
    assert d2.action == "rebalance" and d2.target == "a"
    idle = FleetPressurePolicy(sustain=1)
    assert idle.recommend(ServeStats()).action == "none"


def test_pressure_policy_makes_the_references_decisions():
    r = np.random.default_rng(0)
    kw = dict(high_queue=3, skew=0.6, sustain=2, cooldown=2)
    pol, jpol = FleetPressurePolicy(**kw), JaxFleetPressurePolicy(**kw)
    for _ in range(60):
        depth = (None if r.random() < 0.15 else
                 {f"n{j}": int(r.integers(0, 7))
                  for j in range(int(r.integers(1, 5)))})
        fields = dict(ns_queue_depth=depth,
                      fleet_namespaces_resident=int(r.integers(0, 9)))
        got = pol.recommend(ServeStats(**fields))
        want = jpol.recommend(JaxServeStats(**fields))
        assert (got.action, got.value, got.reason, got.target) == \
            (want.action, want.value, want.reason, want.target)


# ---------------------------------------------------------------------------
# crash-safe checkpoint publish
# ---------------------------------------------------------------------------


def test_crash_mid_save_preserves_previous_checkpoint(tmp_path, monkeypatch):
    """Kill the save after the arrays are written, before the payload
    sidecar lands: the destination keeps the whole previous checkpoint,
    with no tmp residue."""
    c = _corpus(seed=5)
    ids = np.arange(c.shape[0], dtype=np.int32)
    idx = Index.build(c, _cfg(), 0, payload=ids, device=CPU)
    path = str(tmp_path / "idx")
    idx.save(path)
    q = c[:2]
    want = Index.load(path, device=CPU).query(q, 3)
    n_before = idx.n_live

    idx.insert(c[:8] + 5.0, payload=ids[:8])
    real_save = np.save

    def boom(file, arr, *a, **kw):
        if str(file).endswith("payload.npy"):
            raise OSError("disk died mid-write")
        return real_save(file, arr, *a, **kw)

    monkeypatch.setattr("repro_torch.api.handle.np.save", boom)
    with pytest.raises(OSError, match="mid-write"):
        idx.save(path)
    monkeypatch.undo()

    assert not [p for p in os.listdir(tmp_path) if ".tmp-" in p]
    again = Index.load(path, device=CPU)
    assert again.n_live == n_before
    got = again.query(q, 3)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(again.payload[:ids.shape[0]], ids)

    os.makedirs(path + ".tmp-99999")        # a dead writer's residue
    with open(os.path.join(path + ".tmp-99999", "junk"), "w") as f:
        f.write("partial")
    idx.save(path)
    assert Index.load(path, device=CPU).n_live == n_before + 8


def test_two_sharded_namespaces_on_one_device_set(tmp_path, monkeypatch):
    """The reference's mesh case in process: two S = 2 namespaces planned
    into disjoint windows of 4 devices (on the CPU the offset is recorded,
    the shards repeat the device), a sharded evict → reload bit-identical
    with its window re-applied, and a sharded save killed after one shard
    keeping the previous checkpoint."""
    import repro_torch.checkpoint.manager as mgr
    cfg = _cfg()
    r = np.random.default_rng(0)
    A = r.normal(size=(256, 128)).astype(np.float32)
    B = r.normal(size=(320, 128)).astype(np.float32)
    root = str(tmp_path / "fleet")
    fleet = Fleet(root, FleetConfig(max_resident=2), device=CPU)
    fleet.create("a", A, cfg, 1, shards=2)
    fleet.create("b", B, cfg, 2, shards=2)

    plan = fleet.rebalance(4)
    assert sorted(plan.values()) == [0, 2], plan
    offs = {n: fleet.get(n).store.device_offset for n in ("a", "b")}
    assert offs == plan
    assert all(d.type == "cpu" for d in fleet.get("a").store.devices)

    plane = fleet.serve()
    qa = A[:3] + 0.01
    ra = plane.query(qa, rng=5, namespace="a", cache="bypass")
    rb = plane.query(B[:3] + 0.01, rng=6, namespace="b", cache="bypass")
    assert ra.reason == "certified" and rb.reason == "certified"
    ref = Index.build(A, cfg, 1, shards=2, device=CPU).query(qa, 5)
    assert ra.indices.tolist() == ref.indices.tolist()

    assert fleet.evict("a")
    ra2 = plane.query(qa, rng=5, namespace="a", cache="bypass")
    assert ra2.indices.tolist() == ra.indices.tolist()
    np.testing.assert_array_equal(ra2.values, ra.values)
    assert fleet.get("a").store.device_offset == plan["a"]

    idx = fleet.get("b")
    idx.insert(B[:4] + 9.0)
    calls = {"n": 0}
    real = mgr.save

    def boom(p, state, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("killed mid-save")
        return real(p, state, **kw)

    monkeypatch.setattr(mgr, "save", boom)
    with pytest.raises(OSError, match="mid-save"):
        idx.save(os.path.join(root, "ns", "b"))
    monkeypatch.undo()
    assert not [p for p in os.listdir(os.path.join(root, "ns"))
                if ".tmp-" in p]
    old = Index.load(os.path.join(root, "ns", "b"), device=CPU)
    assert old.n_live == 320

    st = plane.stats
    assert st.fleet_namespaces_resident == 2 and st.fleet_reloads >= 1


# ---------------------------------------------------------------------------
# fleet roots across packages
# ---------------------------------------------------------------------------

# The reference's half runs in one subprocess on a CPU inflated to 2
# devices (its sharded namespace needs them): it writes its own fleet root
# and opens the port's, and reports each namespace's record, exact top-k,
# payload and tuning.
REFERENCE = r"""
import json, sys
import numpy as np, jax
from repro.configs.base import BMOConfig
from repro.fleet import Fleet, FleetConfig, load_manifest
from repro.obs.audit import exact_topk
from repro.tune import TunedConfig

jroot, proot, out = sys.argv[1:4]
cfg = BMOConfig(k=4, delta=0.01, block=64, batch_arms=16, pulls_per_round=2,
                metric="l2")
r = np.random.default_rng(11)
a, b, s = (r.normal(size=(n, 128)).astype(np.float32)
           for n in (160, 192, 256))
fleet = Fleet(jroot, FleetConfig(max_resident=1))
fleet.create("a", a, cfg, jax.random.PRNGKey(0),
             payload=np.arange(160, dtype=np.int32) * 3)
fleet.get("a")._apply_tuned(TunedConfig(epoch_rounds=4, pulls_per_round=1,
                                        batch_arms=16))
fleet.create("b", b, cfg, jax.random.PRNGKey(1), max_queue=3)
fleet.create("s", s, cfg, jax.random.PRNGKey(2), shards=2)
fleet.flush()
q = r.normal(size=(3, 128)).astype(np.float32)
np.save(out + "/q.npy", q)

def report(root):
    fl = Fleet.open(root, FleetConfig(max_resident=1))
    rep = {"manifest": load_manifest(root)["namespaces"]}
    for name in fl.namespaces:
        idx = fl.get(name)
        ids, _ = exact_topk(idx.store, q, 4)
        rep[name] = {
            "topk": np.asarray(ids).tolist(), "n_live": int(idx.n_live),
            "shards": int(idx.n_shards),
            "payload": (None if idx.payload is None
                        else np.asarray(idx.payload).tolist()),
            "tuned": None if idx.tuned is None else idx.tuned.to_dict()}
    return rep

with open(out + "/ref.json", "w") as f:
    json.dump({"jroot": report(jroot), "proot": report(proot)}, f)
"""


@pytest.fixture(scope="module")
def cross_roots(tmp_path_factory):
    """(the reference's root, the port's root, the subprocess's report,
    the queries): the port writes its root first, then the reference's
    half runs."""
    base = tmp_path_factory.mktemp("fleets")
    jroot, proot, out = (str(base / n) for n in ("jax", "torch", "out"))
    os.makedirs(out)
    r = np.random.default_rng(12)
    a, b, s = (r.normal(size=(n, 128)).astype(np.float32)
               for n in (160, 192, 256))
    fleet = Fleet(proot, FleetConfig(max_resident=1), device=CPU)
    fleet.create("a", a, _cfg(), 0,
                 payload=np.arange(160, dtype=np.int32) * 3)
    fleet.get("a")._apply_tuned(TunedConfig(epoch_rounds=4,
                                            pulls_per_round=1, batch_arms=16))
    fleet.create("b", b, _cfg(), 1, max_queue=3)
    fleet.create("s", s, _cfg(), 2, shards=2)
    fleet.flush()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    run = subprocess.run([sys.executable, "-c", REFERENCE, jroot, proot, out],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(os.path.join(out, "ref.json")) as f:
        rep = json.load(f)
    return jroot, proot, rep, np.load(os.path.join(out, "q.npy"))


def _port_report(root, q):
    fl = Fleet.open(root, FleetConfig(max_resident=1), device=CPU)
    rep = {"manifest": load_manifest(root)["namespaces"]}
    for name in fl.namespaces:
        idx = fl.get(name)
        rep[name] = {
            "topk": exact_topk(idx.store, q, 4)[0].tolist(),
            "n_live": int(idx.n_live), "shards": int(idx.n_shards),
            "payload": None if idx.payload is None else idx.payload.tolist(),
            "tuned": None if idx.tuned is None else idx.tuned.to_dict()}
    assert fl.resident_count == 1 and fl.reload_count == 3
    return rep


@pytest.mark.parametrize("writer", ["jroot", "proot"])
def test_fleet_root_written_by_either_package_opens_in_the_other(
        cross_roots, writer):
    """The reference's root opened by the port, and the port's by the
    reference: the same manifest records, and each namespace (a payload and
    a tuned sidecar, a ``max_queue`` override, a sharded one at S = 2) with
    the same live rows, shards, payload, tuning and exact top-k."""
    jroot, proot, ref, q = cross_roots
    got = _port_report(jroot if writer == "jroot" else proot, q)
    want = ref[writer]
    assert got == want
    recs = got["manifest"]
    assert recs["b"]["max_queue"] == 3 and recs["a"]["max_queue"] is None
    assert (recs["s"]["shards"], recs["s"]["kind"]) == (2, "dense")
    assert got["a"]["tuned"]["epoch_rounds"] == 4
    assert got["a"]["payload"][:3] == [0, 3, 6]


# ---------------------------------------------------------------------------
# step-by-step parity with the reference's fleet plane
# ---------------------------------------------------------------------------


def test_fleet_plane_makes_the_reference_decisions_at_every_step(tmp_path):
    """One fleet root written by the reference, opened by each package at
    ``max_resident=2`` over three namespaces: the same namespaced
    submissions through both fleet planes, on the reference's draws (the
    port's reloaded handles replay them, hooked in through ``_adopt``).
    After every ``step()`` each ticket has the same status, reason, epochs
    and certified prefix, and both fleets hold the same resident set, with
    the same evictions and reloads."""
    jcfg = JaxBMOConfig(k=4, delta=0.01, block=64, batch_arms=16,
                        pulls_per_round=2, metric="l2")
    data = [jsynthetic.make_knn_benchmark_data("dense", 160, 128, 4,
                                               seed=20 + i)
            for i in range(3)]
    jroot = str(tmp_path / "jax")
    built = JaxFleet(jroot, JaxFleetConfig(max_resident=3))
    for i, name in enumerate("abc"):
        built.create(name, data[i][0], jcfg, jax.random.PRNGKey(i))
    built.flush()
    proot = str(tmp_path / "torch")
    shutil.copytree(jroot, proot)

    jfleet = JaxFleet.open(jroot, JaxFleetConfig(max_resident=2))
    fleet = Fleet.open(proot, FleetConfig(max_resident=2), device=CPU)
    adopt = fleet._adopt
    fleet._adopt = lambda st, index: adopt(st, _replayed(index))
    planes = (jfleet.serve(), fleet.serve())
    q = {name: data[i][1] for i, name in enumerate("abc")}
    # every group races 2 rows: one compiled shape on the reference's side
    waves = [
        [dict(ns="a", rows=slice(0, 2), rng=3, tenant="x"),
         dict(ns="b", rows=slice(0, 2), rng=4, tenant="x",
              budget={"epochs": 2})],
        [dict(ns="c", rows=slice(0, 2), rng=5, tenant="y"),
         dict(ns="a", rows=slice(2, 4), rng=6, tenant="x", cache="bypass")],
        [dict(ns="b", rows=slice(2, 4), rng=7, tenant="y"),
         dict(ns="a", rows=slice(0, 2), rng=8, tenant="y"),   # exact repeat
         dict(ns="c", rows="near", rng=9, tenant="x")],       # near repeat
    ]
    tickets = ([], [])
    for wave in waves:
        for sub in wave:
            sub = dict(sub)
            ns, rows = sub.pop("ns"), sub.pop("rows")
            rows_q = (q[ns][:2] + np.float32(1e-3) if rows == "near"
                      else q[ns][rows])
            seed = sub.pop("rng")
            budget = sub.pop("budget", None)
            from repro.api import EffortBudget as JaxEffortBudget
            from repro_torch.api import EffortBudget
            tickets[0].append(planes[0].submit(
                rows_q, rng=jax.random.PRNGKey(seed), namespace=ns, **sub,
                budget=budget and JaxEffortBudget(**budget)))
            tickets[1].append(planes[1].submit(
                rows_q, rng=seed, namespace=ns, **sub,
                budget=budget and EffortBudget(**budget)))
            assert fleet.resident == jfleet.resident
        steps = 0
        while planes[0].active or planes[1].active:
            assert (planes[0].step() > 0) == (planes[1].step() > 0)
            steps += 1
            for jt, t in zip(*tickets):
                want, got = _view(jt, planes[0]), _view(t, planes[1])
                assert got[:4] == want[:4], (steps, t.id)
                for (wi, wv), (gi, gv) in zip(want[4], got[4]):
                    assert gi == wi, (steps, t.id)
                    np.testing.assert_allclose(gv, wv, rtol=2e-4, atol=1e-5)
        assert fleet.enforce_residency() == jfleet.enforce_residency()
        assert fleet.resident == jfleet.resident
    assert (fleet.reload_count, fleet.eviction_count) == \
        (jfleet.reload_count, jfleet.eviction_count)
    assert fleet.eviction_count >= 2 and fleet.reload_count >= 4
    reasons = [t.result.reason for t in tickets[1]]
    assert reasons == [t.result.reason for t in tickets[0]]
    assert "budget" in reasons
    assert float(np.sum(tickets[1][5].result.coord_ops)) == 0.0  # cached
    st, jst = planes[1].stats, planes[0].stats
    assert (st.fleet_namespaces_resident, st.fleet_reloads) == \
        (jst.fleet_namespaces_resident, jst.fleet_reloads)
    assert json.dumps(st.ns_queue_depth) == json.dumps(jst.ns_queue_depth)
