"""Serving CLI: batched greedy generation on one device, with the optional
BMO-NN kNN-LM retrieval hook (the paper's technique in the serving path),
the port of ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
      --smoke --device cpu --batch 4 --prompt-len 16 --new-tokens 32 --knn-lm

Serves the token families (``serve.engine.TOKEN_FAMILIES``: dense, moe,
ssm, hybrid), the MoE family on one device with its expert parallelism
cleared, as the reference's CLI clears it (``--arch deepseek-v3-671b`` or
``dbrx-132b``, at ``--smoke`` or cut in depth where the card holds it);
``--arch qwen2-vl-2b`` and ``--arch whisper-base`` raise a ``ValueError``
before the model is built, since the engine feeds token prompts and they
read embeddings and frames (the reference's CLI fails on them with a
``KeyError``). The kNN-LM hook needs the dense family.
Runs on the GPU unless ``--device cpu`` is given, and fails without one.
The model's weights are drawn at random in bf16 on the device from seed 0.
Retrieval is served from a persistent ``repro_torch.api.Index``:
``--index-dir`` loads a saved index when the directory exists (the
next-token payload rides its sidecar) and builds and saves one when it does
not; a directory written by the JAX package's CLI loads too.
``--index-append`` grows the datastore during decode; ``--tune`` races the
index's serving knobs after build or load and saves the winner beside it.
``--index-shards S`` builds a sharded index with its S shards on the
serving device. ``--fleet-root DIR`` serves retrieval from a namespace
fleet (``repro_torch.fleet``): the index is the fleet's ``default``
namespace, created on the first launch and recovered from ``fleet.json``
afterwards, the engine shares the fleet's request plane, and the fleet is
flushed on exit; ``--max-resident`` is its residency budget.
``--data`` or ``--model`` above 1 serves the reference CLI's plan (tp
over the model axis when ``--model`` is above 1) over a (data, model)
mesh of ranks (``ServeEngine(mesh=)``): under ``torchrun``
each process is a rank, otherwise the CLI spawns data × model rank
processes on ``--device`` (on one card they share it); every rank runs
the same generation and rank 0's result comes back. The retrieval index
stays on each rank's device, unsharded.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import BMOConfig
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve.engine import (KNNLMConfig, ServeEngine,
                                      TOKEN_FAMILIES)
from repro_torch.serve.plane import PlaneConfig
from repro_torch.utils import get_logger

log = get_logger("repro_torch.serve")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the GPU; "
                         "'cpu' runs the plain PyTorch path)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=None)
    ap.add_argument("--knn-lm", action="store_true")
    ap.add_argument("--index-dir", default=None,
                    help="load the retrieval index from this directory if "
                         "it exists, else build it there once")
    ap.add_argument("--index-append", action="store_true",
                    help="insert each decode step's (hidden, token) pairs "
                         "back into the index")
    ap.add_argument("--index-shards", type=int, default=0,
                    help=">1: a sharded index, its shards on the serving "
                         "device")
    ap.add_argument("--tune", action="store_true",
                    help="autotune the retrieval index after build/load "
                         "(repro_torch.tune) and serve the winner; with "
                         "--index-dir its tuned.json sidecar is saved next "
                         "to the checkpoint so later launches serve it "
                         "without racing again")
    ap.add_argument("--fleet-root", default=None, metavar="DIR",
                    help="serve retrieval from a namespace fleet rooted "
                         "here: the index is the fleet's 'default' "
                         "namespace (created on the first launch, "
                         "recovered from the manifest afterwards) and the "
                         "engine shares the fleet's request plane; "
                         "overrides --index-dir")
    ap.add_argument("--max-resident", type=int, default=8,
                    help="with --fleet-root: the LRU residency budget "
                         "(namespaces beyond it are checkpointed and "
                         "evicted, and reload on their next touch)")
    ap.add_argument("--datastore-size", type=int, default=2048)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--autoscale", action="store_true",
                    help="consult a ScalePolicy on the request-plane "
                         "telemetry after serving and log its "
                         "recommendation")
    ap.add_argument("--autoscale-apply", action="store_true",
                    help="apply the add_replicas recommendation to the "
                         "live handle and the recall guard's decision "
                         "(reshard stays advisory)")
    ap.add_argument("--audit-rate", type=float, default=0.0,
                    help="shadow δ-audit: re-answer this fraction of "
                         "certified tickets exactly, off the critical path, "
                         "and compare against the served ids")
    ap.add_argument("--audit-dir", default=None, metavar="DIR",
                    help="write a replayable flight-recorder bundle here "
                         "for every audited mismatch (replay with "
                         "tools/torch_replay_audit.py)")
    ap.add_argument("--slo", action="store_true",
                    help="evaluate burn-rate SLOs (recall vs δ, shed rate) "
                         "over the plane's telemetry after serving; a "
                         "burning recall SLO engages the recall guard when "
                         "--autoscale-apply is set, else it is logged")
    ap.add_argument("--health-dump", default=None, metavar="PATH",
                    help="write the combined health snapshot (stats, audit, "
                         "SLO state) here on exit as JSON")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="write the obs metrics registry here on exit "
                         "(.json: JSON snapshot, else Prometheus text)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the raw trace-event dump here on exit")
    return ap.parse_args(argv)


def open_index(args, knn_cfg: KNNLMConfig, keys, next_ids, device):
    """The retrieval index: loaded from ``--index-dir`` when it exists
    (the payload attached when it holds none), else built from ``keys``
    and saved there."""
    from repro_torch.api import Index
    policies = dict(cache=knn_cfg.cache_policy(),
                    compaction=knn_cfg.compaction_policy())
    if args.index_dir and os.path.exists(args.index_dir):
        index = Index.load(args.index_dir, device=device, **policies)
        if index.payload is None:
            index.attach_payload(next_ids)
        log.info("loaded index from %s (%d live slots, %d shard(s))",
                 args.index_dir, index.n_live, index.n_shards)
    else:
        index = Index.build(keys, knn_cfg.bmo, 7,
                            shards=max(args.index_shards, 1),
                            payload=next_ids, device=device, **policies)
        if args.index_dir:
            index.save(args.index_dir)
            log.info("built + saved index to %s (%d shard(s))",
                     args.index_dir, index.n_shards)
    return index


def maybe_tune(args, index) -> None:
    """Under ``--tune``, race the index's serving knobs unless it carries
    a tuning; with ``--index-dir`` the winner's sidecar is saved there (a
    fleet's namespace keeps it through ``Fleet.flush``)."""
    if args.tune and index.tuned is None:
        t0 = time.time()
        report = index.tune(rng=13)
        log.info("autotuned in %.1fs: %s (winner %.2f ms vs default "
                 "%.2f ms over %d raced candidates)",
                 time.time() - t0, report["config"],
                 report.get("winner_median_ms", float("nan")),
                 report.get("default_median_ms", float("nan")),
                 report.get("raced", 0))
        if args.index_dir and not args.fleet_root:
            from repro_torch.tune import save_tuned, signature_of
            save_tuned(args.index_dir, signature_of(index.store),
                       index.tuned,
                       measured={"epoch_ms": index.tuned.epoch_ms,
                                 "round_ms": index.tuned.round_ms})
            log.info("tuned.json sidecar -> %s", args.index_dir)
    elif args.tune:
        log.info("index loaded with a tuned sidecar — serving it without "
                 "re-racing (%s)", index.tuned.to_dict())


def open_fleet(args, knn_cfg: KNNLMConfig, keys, next_ids, device):
    """The fleet at ``--fleet-root`` and its ``default`` namespace: created
    from ``keys`` on the first launch, recovered from the manifest after.
    Returns (fleet, the namespace's handle, the fleet's plane, which binds
    it as its default index so the δ-audit covers its traffic)."""
    from repro_torch.fleet import Fleet, FleetConfig
    fleet = Fleet(args.fleet_root, FleetConfig(max_resident=args.max_resident),
                  device=device)
    if "default" in fleet:
        index = fleet.get("default")
        log.info("fleet %s: recovered namespace 'default' (%d live slots, "
                 "%d shard(s); %d namespace(s) total, %d resident)",
                 args.fleet_root, index.n_live, index.n_shards, len(fleet),
                 fleet.resident_count)
    else:
        index = fleet.create("default", keys, knn_cfg.bmo, 7,
                             shards=max(args.index_shards, 1),
                             payload=next_ids)
        log.info("fleet %s: created namespace 'default' (%d shard(s))",
                 args.fleet_root, index.n_shards)
    return fleet, index, fleet.serve(knn_cfg.plane, default="default")


def report_after_serving(args, engine: ServeEngine) -> dict:
    """The δ-audit's flush, the engine's stats, the autoscale and SLO
    verdicts, logged; returns the audit summary (None without one)."""
    audit = None
    plane = engine.plane
    if args.audit_rate > 0.0 and plane is not None and plane.auditor:
        done = plane.audit_flush()      # the oracle runs after serving
        audit = plane.auditor.summary()
        log.info("δ-audit: %d ticket(s) flushed — %d/%d audited rows "
                 "mismatched, err_upper=%.4g (%s), %d bundle(s)",
                 done, audit["mismatch_rows"], audit["sampled_rows"],
                 audit["err_upper"], audit["method"], len(audit["bundles"]))
        for b in audit["bundles"]:
            log.warning("flight-recorder bundle: %s", b)
    st = engine.stats
    log.info("engine stats: %s", st.as_dict())
    if args.autoscale:
        from repro_torch.serve.scale import QueueDepthPolicy
        decision = QueueDepthPolicy(sustain=1).recommend(st)
        log.info("autoscale recommendation: %s value=%d (%s)",
                 decision.action, decision.value,
                 decision.reason or "no signal")
        if args.autoscale_apply and decision.action == "add_replicas":
            engine.index.add_replicas(decision.value)
            log.info("applied: read fan-out now %d replicas",
                     engine.stats.replicas)
    if args.slo and plane is not None:
        from repro_torch.obs import (AlertSink, SLOEngine, default_slos,
                                     plane_sources)
        from repro_torch.serve.scale import RecallGuardPolicy, apply_guard
        sink = AlertSink()
        slo = SLOEngine(default_slos(float(engine.index.cfg.delta)),
                        sink=sink, obs=plane.obs)
        slo.observe(plane_sources(plane, plane.auditor))
        for s in slo.state()["slos"]:
            burning = any(r["active"] for r in s["rules"])
            log.info("SLO %s: bad_frac=%.4g budget=%g %s", s["name"],
                     s["bad_frac"], s["budget"],
                     "BURNING" if burning else "ok")
        decision = RecallGuardPolicy(sink).recommend(engine.stats)
        log.info("recall guard: %s (%s)", decision.action,
                 decision.reason or "no signal")
        if args.autoscale_apply and apply_guard(engine.index, decision):
            log.info("applied: serving_fallback=%s retune_requested=%s",
                     engine.index.serving_fallback,
                     engine.index.retune_requested)
    return audit


def main(argv=None) -> dict:
    """Serve once; returns the generated tokens, the retrieval's coordinate
    ops, the seconds ``generate`` took, the audit summary, the engine's
    stats and, with ``--fleet-root``, the fleet's stats."""
    args = parse_args(argv)
    world = args.data * args.model
    if world > 1:
        from repro_torch.dist import CLI_TIMEOUT_S, init_rank, spawn
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if int(os.environ["WORLD_SIZE"]) != world:
                raise ValueError(f"--data {args.data} --model {args.model} "
                                 f"takes {world} ranks; torchrun started "
                                 f"{os.environ['WORLD_SIZE']}")
            init_rank(int(os.environ["RANK"]), world, None,
                      args.device or "cuda")
            return serve_rank(int(os.environ["RANK"]), world, args)
        return spawn(serve_rank, world, (args,), device=args.device or "cuda",
                     timeout=CLI_TIMEOUT_S)
    return serve(args, resolve_device(args.device))


def serve_rank(rank: int, world: int, args) -> dict:
    """One rank of ``--data`` × ``--model``: ``serve`` over the mesh."""
    from repro_torch.dist import rank_device
    from repro_torch.launch.mesh import make_host_mesh
    return serve(args, rank_device(), make_host_mesh(args.data, args.model))


def serve(args, device, mesh=None) -> dict:
    """The CLI's serving run on ``device``, over ``mesh`` when given. As
    the reference's CLI, the plan is the arch's with fsdp, sp and ep
    cleared and tp on when ``--model`` is above 1."""
    entry = get_arch(args.arch)
    cfg = entry.smoke if args.smoke else entry.config
    if cfg.family not in TOKEN_FAMILIES:
        raise ValueError(f"--arch {args.arch}: the {cfg.family!r} family "
                         "reads embeddings or frames, and the serving CLI "
                         f"feeds token prompts (it serves {TOKEN_FAMILIES})")
    if args.knn_lm and cfg.family != "dense":
        raise ValueError("the kNN-LM hook needs a hidden-state-exposing "
                         "DenseLM")
    plan = dataclasses.replace(entry.plan, fsdp=False, sp=False, ep=False,
                               tp=args.model > 1)
    model = build_model(cfg, param_dtype=torch.bfloat16, device=device,
                        rng=0)
    if mesh is not None:
        from repro_torch.serve.steps import place_model
        place_model(model, plan, mesh)
    max_seq = args.max_seq or (args.prompt_len + args.new_tokens + 8)

    knn_cfg = index = fleet = fleet_plane = None
    if args.knn_lm:
        ds_rng = np.random.default_rng(0)
        keys = ds_rng.normal(size=(args.datastore_size, cfg.d_model)
                             ).astype(np.float32)
        next_ids = ds_rng.integers(0, cfg.vocab_size, args.datastore_size
                                   ).astype(np.int32)
        knn_cfg = KNNLMConfig(
            lam=0.2, index_shards=args.index_shards,
            bmo=BMOConfig(k=8, delta=0.05, block=min(64, cfg.d_model),
                          batch_arms=16),
            plane=PlaneConfig(audit_rate=args.audit_rate,
                              audit_dir=args.audit_dir))
        if args.fleet_root:
            fleet, index, fleet_plane = open_fleet(args, knn_cfg, keys,
                                                   next_ids, device)
        else:
            index = open_index(args, knn_cfg, keys, next_ids, device)
        maybe_tune(args, index)

    engine = ServeEngine(model, plan, batch_size=args.batch, max_seq=max_seq,
                         knn_lm=knn_cfg, index=index,
                         index_append=args.index_append, plane=fleet_plane,
                         plane_namespace="default" if fleet_plane else None,
                         device=device, mesh=mesh)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.time()
    out, retrieval_ops = engine.generate(prompts, args.new_tokens)
    dt = time.time() - t0
    log.info("generated %s tokens in %.2fs (%.1f tok/s)%s",
             out.shape, dt, out.size / dt,
             f"; retrieval coord-ops={retrieval_ops:.0f}" if args.knn_lm
             else "")
    audit = report_after_serving(args, engine) if args.knn_lm else None
    fleet_stats = None
    if fleet is not None:
        fleet.flush()           # the manifest and dirty checkpoints
        fleet_stats = fleet.stats()
        log.info("fleet stats: %s", fleet_stats)
    if args.health_dump:
        from repro_torch.obs import dump_health
        dump_health(args.health_dump, plane=engine.plane, index=engine.index)
        log.info("health snapshot -> %s", args.health_dump)
    if args.metrics_dump or args.trace:
        from repro_torch.obs import dump_events, dump_metrics, get_obs
        obs = get_obs()
        if args.metrics_dump:
            dump_metrics(args.metrics_dump, obs)
            log.info("metrics dumped to %s", args.metrics_dump)
        if args.trace:
            dump_events(args.trace, obs)
            log.info("trace dumped to %s (%d events, %d dropped)",
                     args.trace, obs.events.total, obs.events.drops)
    print(out[:, :16])
    return {"tokens": out, "retrieval_ops": retrieval_ops, "seconds": dt,
            "audit": audit, "stats": engine.stats.as_dict(),
            "fleet": fleet_stats}


if __name__ == "__main__":
    main()
