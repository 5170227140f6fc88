#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--queries Q] [--rounds-queries Q]
                          [--sparse-queries Q] [--kmeans-points N]
                          [--out FILE.json]

Run from the root of a checkout. In order it:

1. prints the card's name and power limit (``nvidia-smi``) and builds the
   port's CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``
   (into ``build/``, one ``nvcc`` per source, all at once), timing the build;
2. kernel phase: calls each kernel's wrapper at the shapes its path gives
   it and holds the result against its plain PyTorch version on the same
   inputs, timing kernel, plain version and (where one exists) the one
   PyTorch call that computes the same function, with CUDA events over
   back-to-back calls, and the kernel alone with torch.profiler, beside
   the least time the card could take (bytes over 3.35 TB/s, operations
   over 67 TFLOP/s fp32, or 989 TFLOP/s on the bf16 tensor cores for
   bf16 attention, or 495 TFLOP/s TF32 for the split-TF32 ℓ2 distances;
   the difference form of pairwise distances at 2 issue slots a term,
   33.5e12 slots/s). Host µs per call (CUDA events minus device time) for
   the short calls of the paper path. Tolerances: pull statistics and
   pulls at rtol 2e-4 / atol 1e-5; the fp32 transform at 1e-5, bf16 at
   5e-2; pairwise ℓ1 at rtol 1e-4 / atol 1e-3, ℓ2 at |got − want| ≤
   1e-4·|want| + 1e-6·(‖q‖² + ‖x‖²) (the plain version's norm expansion
   cancels), and ℓ2 on the tensor cores also at 1e-4 relative of a float64
   brute force (its contract), with the unrepaired form's error under
   gamma(d)·(‖q‖² + ‖x‖²) on adversarial inputs (x against itself,
   near-duplicates, a common offset of 100); flash attention in bf16 on the tensor cores within both
   bounds of ``ref.flash_attention_tc_bounds`` (p rounds to bf16 for the
   product with v: against the plain version with p in bf16 at one bf16
   ulp plus 6·2⁻⁸ times each output's rounding spread, and against the
   one with p in fp32 at one ulp plus (2⁻⁸ + 1e-4)·max|v|), its max and
   RMS errors at most twice the library call's, and in fp32 at 3e-5. The
   tensor-core kernel's SASS must hold HGMMA. The transform's rows also
   carry its achieved bytes/s and share of the bound, its plan as the
   kernel reports it (blocks an SM by the occupancy calculator), and
   ptxas's registers and spills (a spill fails the run).
   The two pull kernels are checked and timed on each of their schedules
   (``kernels/pull_schedule.py``): an epoch or a round (the pair
   schedule), the wide init with its arms one expanded vector (the rows
   schedule, as the drivers pass them) and with a general (Q, n) arm
   tensor (the pair schedule). Their rows also carry an L2 floor: the
   bytes their schedule sends through L2 at the card's L2 read rate,
   measured with ``csrc/l2_read.cu`` at buffers of 8 to 32 MB (five sets
   each, all printed; the floor takes the fastest size's median).
   Where the plain version cannot hold the full shape, it is checked on
   the first queries or rows, as each row says;
3. checks the fused path on a small input on the card against a brute
   force;
4. on the repo's ``bmo-nn-dense`` workload at its published size
   (n = 100,000, d = 12,288, k = 5, δ = 0.01, block 128, 1,024 queries;
   corpus made on the card from ``--seed``; ground truth a float64 brute
   force on the card), one phase per path, each with the launch counters of
   its kernels set to 0 just before and read just after:
   * main path: ``Index.build`` → ``Index.query`` (the fused driver, rotated
     box), recall ≥ 0.99, the (Q, B, T) shapes of its pull launches, then
     a second, traced query for the device-time breakdown, with the pull's
     init launch apart from its epochs, and a second, traced build (device
     time by kernel, the five largest);
   * oracle: ``core.oracle.exact_knn`` of all queries, whose top-k sets
     must equal the brute force's (a disagreement passes only when a float64
     distance gap under 1e-4 relative, an fp32 near-tie, explains it); every
     launch on the tensor-core variant, its flagged pairs counted, and the
     unrepaired form's error on the clustered corpus under gamma(d);
   * rounds: ``Index.query(mode="rounds")`` on the same index, the per-round
     driver (``--rounds-queries`` of the queries; the default 128 is a cut:
     1,024 takes over 150 s), recall ≥ 0.99;
   * tune: ``Index.tune()`` over a second handle on the same store with
     the reference's defaults (8 synthetic queries, 2 halving levels, 1
     rep): the grid (R, P, B, frontier floor, the fused pull's 2 or 4
     buffers, the driver), the analytic cost model's score of each raced
     survivor beside its measured median and their Spearman rank
     correlation, the winner against the identity, the measured epoch and
     round costs; all queries under the tuned config (recall ≥ 0.99) and
     under the defaults, QPS of each (reported, not claimed); the tuned
     query's first epoch launch (its arms and blocks, the winner's B, T
     and buffers) held against the plain pull; the tuned index saved and loaded (``tuned.json`` applied, reason "ok", the same
     config), and the sidecar beside an index of another scale bucket
     (reason "signature", the build-time config served);
   * plane: the request plane (``serve.RequestPlane``, default
     ``PlaneConfig``) over a second handle on the same store: every query
     in 128 tickets of 8 rows over 4 tenants, a quarter with a 2,000 ms
     ``Deadline``, a quarter with ``EffortBudget(epochs=8)``, half raced to
     certification (one scheduler step traced); 128 exact repeats of
     certified rows, served at submit at zero cost with the same answers;
     64 near repeats (1e-3 relative noise) with seeded priors and with the
     cache bypassed; the mutation fence (64 rows, two epochs, 512 inserted
     near-copies, drained under ``on_mutation="complete"`` and
     ``"readmit"``, each held to the truth of its store epoch). Certified
     tickets at recall ≥ 0.99; every partial's certified prefix equal to
     the truth's prefix at ≥ 0.99 of its positions, with CI 0; no ticket
     shed by a launch failure; one host sync (``host_fetch``) per session
     epoch; rows/s, latency percentiles, exits by reason, epochs per
     ticket, coord ops per certified row against ``Index.query``'s. The
     shadow δ-audit samples every certified ticket (``audit_rate=1.0``;
     the µs of each ``offer`` on the serving path) and re-answers them
     after the pass on the exact oracle (``pairwise_dist``, the oracle's
     ms an item; rows audited, mismatches, the Wilson bound); after the
     phase, the oracle on one audited ticket held to the float64 brute
     force and its ``pairwise_dist`` launch at the audit's shape to the
     plain version. Then, on a handle with the tune phase's winner: the
     same tickets with the deadline tickets spread over all four tenants,
     raced with the tuned round cost and with ``use_tuned=False`` (exits
     by reason, epochs per ticket, certified positions); two tickets
     corrupted below the plane (a duplicated served id; a far live id in
     place of the k-th, which only the θ comparison can catch), each
     caught by the audit, written as a bundle and reproduced by
     ``tools/torch_replay_audit.py``'s ``replay_one``; the recall SLO on a
     held clock firing, the recall guard's fallback → retune chain, and
     ``tune(force=True)`` lifting both;
   * mutation: the main path's index through the handle's mutable
     surface: ``save`` with a payload (each slot's origin) into a
     ``tempfile.mkdtemp()`` directory, ``Index.load`` (every
     array bit for bit on the card, its query equal to the main path's
     bit for bit), ``insert`` of 4,096 rows (512 near-copies of the first
     queries; one ``fwht`` launch), ``delete`` of 40,000 slots (the copies
     of the first 128 queries, the true top-k of queries 512–1,023,
     random others), ``query``, ``maybe_compact`` (to capacity 65,536;
     its old→new map against the payload and the rows) and ``query``
     again; each query with recall ≥ 0.99 against a float64 brute force
     over the live slots, no dead slot returned, every kept copy found
     first, no deleted copy returned; times of each step, bytes written,
     both QPS;
   * sharded: the same corpus as a sharded index (``Index.build(shards=
     4)``, all four shards on the one card, views of one (4, stride,
     d_pad) tensor): all queries (recall 1.0, QPS, per-shard coord ops and
     rounds, ``balance``), the rounds driver on ``--rounds-queries``
     queries, 512 inserts and 4,096 deletes through global ids,
     ``maybe_compact`` and all queries; ``live_reshard`` to 2 shards, its
     store bit for bit against a save at 4 and a load at 2, and all
     queries; ``add_replicas(2)`` with two batches round-robin; an
     ``EffortBudget`` session (stopped by its budget with some positions
     certified) and a ``Deadline`` session through the request plane,
     their certified prefixes in the truth, every id live and none
     repeated; ``Index.tune()``; a δ-audit of 64 rows (0 mismatches); each
     recall 1.0 against a float64 brute force over the live rows, no dead
     slot; each step's seconds and the peak memory;
   * distributed: ``core.distributed.distributed_knn`` on a 2 × 2 (data ×
     model) grid of the card over ``--rounds-queries`` queries, recall
     1.0; then ``block_pull_multi`` at one cell's operands (its column part
     of its data row, a round's and the wide init's arms) against the
     plain version;
   * paper: ``core.bmo_nn.knn`` (Algorithm 2, one race per query) of the
     first ``PAPER_QUERIES`` queries at full n and d, recall ≥ 0.99;
   * fleet, once the main corpus is freed: 64 tenant namespaces of 16,384
     × 4,096 rows (``repro_torch.fleet``) under an LRU budget of 8
     resident, evicted to checkpoints and reloaded on touch, FLEET_REQUESTS
     requests of 4 rows through the shared request plane, the crash-safe
     save, the keep-last-N ``CheckpointManager`` and the recovery from
     ``fleet.json``
     (see ``fleet_phase``);
5. sparse: the ``bmo-nn-sparse`` workload (§IV-A: n = 100,000, d = 28,672,
   7% nonzero, ℓ1, k = 5, block 1, 1,024 queries that copy corpus rows),
   drawn on the card as CSR from ``--seed``: ``Index.build``;
   ``exact_knn_sparse`` of every query (``pairwise_dist`` ℓ1 on the CUDA
   cores over densified chunks of 8,192 rows), its sets equal to a float64
   ``torch.cdist(p=1)`` brute force's (near-ties under 1e-4 relative
   pass); the index saved and loaded, every array bit for bit. At full
   size the races run capped at 1 + 200 rounds (run to certification they
   would take some 880,000): ``Index.query`` of ``--sparse-queries`` queries
   and ``knn`` of one, each timed at 1 and at 201 rounds and traced at 1
   and at 17 (a round's ms, device ms, kernels and idle share); then an
   insert of 512 rows that widens the rows (the inserted rows held bit for
   bit), deletes, a capped query, ``maybe_compact`` (the kept rows held bit
   for bit) and a capped query, no dead slot returned; 64 queries through
   the request plane under ``EffortBudget(epochs=2)``, their certified
   prefixes held to the float64 truth. Races run to certification over the
   first 768 rows check recall, not the cell's throughput: 8 plane tickets
   raced to certification; ``Index.query`` of ``--sparse-queries`` copies of its rows
   (the per-round driver, with its coord-op gain over the sparsity-aware
   exact count), ``knn`` of one of them, and that index saved, loaded (its
   query equal to the first), grown and widened by 512 inserted rows,
   deleted from, queried, compacted and queried; recall ≥ 0.99 each time
   against a float64 brute force over the live rows, no dead slot;
6. kmeans: BMO k-means at Fig. 5's configuration (``benchmarks/
   fig5_kmeans.py``: 8,192 dimensions, 32 clusters, 2 iterations, the
   points ``--kmeans-points``, a cut from 3,000), its coord-op gain over
   exact Lloyd and its assignment accuracy (≥ 0.99) against the exact
   assignment; then ``block_pull`` at the path's operands (the final
   centroids as the arms, one point, a round's and the init's arms) and
   ``pairwise_dist`` at the assignment oracle's and a race's exact
   evaluation's shapes, each against the plain version;
7. lm_forward: the dense LM's cache-free forward, ``lm_loss`` of
   qwen2.5-14b at full width and depth (bf16, random weights from
   ``--seed``) over 4 sequences of 4,096 tokens, through
   ``flash_attention``'s tensor-core kernel once per layer, with a traced
   forward split by call site (attention, MLP, norms, loss); then every
   layer's attention held against the plain version on its own inputs,
   and the whole forward of one sequence through the kernel and through
   the plain version (see ``lm_forward_phase`` for what is held and why);
8. serve: the same model served through ``serve.ServeEngine`` at full width
   and depth: a 262,144-row datastore of its own final hidden states (16
   cache-free forwards of 4 × 4,096 tokens through ``flash_attention``),
   8 prompts of 1,024 tokens, SERVE_KNN_TOKENS greedy tokens with the kNN-LM
   hook and appends (every step's retrieval on ``fused_epoch_pull`` held to a
   float64 brute force over the live rows, its vote to a plain recompute,
   the appended rows and payload), 16 tokens without the hook against the
   cache-free forward layer by layer and whole, and with the int8 cache;
   ``fused_epoch_pull`` at the path's epoch shapes against its plain
   version (see ``serve_phase``);
9. serve_cli: ``python -m repro_torch.launch.serve`` at full width, called
   through ``main`` (see ``serve_cli_phase``), then at ``--smoke`` with
   ``--index-shards 2`` (``serve_cli_sharded``) and twice with
   ``--fleet-root`` (``serve_cli_fleet``: create, then recover);
10. families: every other architecture the port serves, in bf16 with
   random weights (``FAMILY_RUNS``): xlstm-350m, zamba2-2.7b, qwen2-vl-2b
   and whisper-base at their published configs, granite-34b,
   nemotron-4-340b, llama3-405b, deepseek-v3-671b and dbrx-132b at full
   width cut to 4 layers; ``lm_loss``, a prefill and greedy decode steps,
   each cache-path layer held to its cache-free run on the cache run's own
   inputs, the MoE layers' routing and determinism, and the CLI at
   ``--arch xlstm-350m`` and ``--arch zamba2-2.7b`` at full width and the
   two MoE archs at ``--smoke`` (see ``families_phase``).

11. train: the training path (``repro_torch.train``) on the card at full
   width cut to 4 layers (``TRAIN_RUNS``): qwen2.5-14b on its published
   plan (AdamW, fp32 parameters, bf16 compute, remat full, grad
   accumulation 8) for 3 steps of 8 × 4,096 tokens from ``ShardedLoader``,
   and dbrx-132b (Adafactor, bf16 parameters, capacity factor 1.25) for 2;
   s a step split into the backward passes and the update, tokens/s, peak
   memory, loss, grad_norm and lr each step (and dbrx's dropped slots and
   aux); grad accumulation 4 against 1 on one 4 × 1,024 batch, unclipped;
   one SMOKE step on the card against the same step on the CPU; the
   training CLI at ``--smoke`` twice in a process of its own under
   deterministic algorithms, uninterrupted and with ``--fail-at`` after a
   checkpoint, the final states bit for bit (see ``train_phase``).
12. plans: the multi-device plans with their ranks as processes on
   ``cuda:0`` (``repro_torch.dist.spawn``; the group a
   ``repro_torch.dist.StagedGroup``, every collective through pinned host
   memory), each against one rank on the card: four ranks take a
   qwen2.5-14b step under fsdp + tp + sp on 2 × 2 in fp32 and one in bf16
   (1 layer, 4 × 1,024 tokens; against one rank's step in the same type:
   the loss, the gradients' norm and, in fp32, AdamW's m on sampled
   entries, each gradient limit below a control's reading, the parameters
   bit for bit), ``compressed_psum`` of 64 M elements bit-equal
   to ``compressed_mean``, and an xlstm-350m checkpoint; then two ranks
   serve qwen2.5-14b under tp on 1 × 2 (4 layers, 4 × 512 prompts, 16
   decode steps; every layer held teacher-forced at 1e-2), run its
   cache-free forward through ``flash_attention``'s tensor-core kernel on
   each rank's heads, dbrx-132b's MoE layer under ep (routing and kept
   masks equal, outputs at 1e-3), 2 pipeline stages against sequential, and
   resume the checkpoint bit for bit; the collective probe (through the
   ranks' group, and through gloo's and NCCL's own groups on CUDA
   tensors) and the staged bytes are printed (see ``plans_phase``).
13. dryrun: the dry run and the roofline (``repro_torch.launch.dryrun``)
   in a process of its own, host-only and on one thread, started right
   after the build and joined after the plans phase, so it runs beside the
   card phases: qwen2.5-14b × train_4k on the 16 × 16 mesh, dbrx-132b ×
   decode_32k on 2 × 16 × 16 (EP), xlstm-350m × long_500k and bmo-nn ×
   knn_100k_12k (``DRYRUN_CELLS``), each over PyTorch's fake process group
   with every tensor on ``meta``, and every record must end ``ok``; the
   train phase's own qwen2.5-14b step priced at one chip, printed beside
   its measured s a step; ``hardware.HBM_BYTES`` held equal to the card's
   ``total_memory`` (see ``dryrun_finish``).
14. lint: ``tools/torch_lint.py`` over ``src/repro_torch`` against
   ``tools/torch_lint_baseline.json`` with this run's ``ptxas -v`` record
   of every built kernel and the card's record of every launch the kernel
   phase's torch.profiler traces held (registers, threads, static plus
   dynamic shared memory at the path's shapes) for the Hopper rule, 0 new
   findings, the counts printed by rule and by status; it runs right
   after the kernel phase (see ``lint_phase``).

``--out`` also writes every detail (build logs, all rows) to a JSON file.
The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Any mismatch, a recall under 0.99, or a
kernel that its path never launched raises, and the script exits
non-zero; so it does without a GPU or without the rest of the repository.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
sys.path.insert(0, os.path.join(ROOT, "src"))
try:
    # NVIDIA H100 SXM (data sheet): the peaks the bounds are taken against,
    # the same the port's tuner scores its candidates with
    from repro_torch.hardware import (BF16_TC_FLOPS, FP32_FLOPS,
                                      HBM_BYTES_PER_S, TF32_TC_FLOPS)
except ImportError:
    sys.exit("chip_smoke: run from a checkout of the repository "
             "(src/repro_torch is missing)")
# fp32 instructions a second on the CUDA cores (an FFMA counts 2 flops of
# the 67 TFLOP/s, a subtraction takes a whole slot)
FP32_SLOTS = FP32_FLOPS / 2
# the LM phase: qwen2.5-14b at full width and depth over the repo's train_4k
# sequence length
LM_ARCH = "qwen2.5-14b"
LM_BATCH = 4
LM_SEQ = 4096
# queries of the paper phase: one host-driven race each, a few seconds
# apiece (4 of them, to keep the whole script well inside its time limit)
PAPER_QUERIES = 2
# the mutation phase on the main path's index: rows inserted (the first
# TWINS near-copies of the first queries), of which the twins of the first
# TWINS_DELETED queries are deleted again among MUTATION_DELETES slots
MUTATION_ROWS = 4096
TWINS = 512
TWINS_DELETED = 128
MUTATION_DELETES = 40_000
# the sparse phase (bmo-nn-sparse, d = 28,672): the sparse oracle's corpus
# rows a pairwise_dist call. At the full 100,000 rows the races run capped:
# the per-round race takes 8.7–8.9 rounds a corpus row a query (at 768 and
# 1,024 rows), some 880,000 a race there, so SPARSE_CAPPED_ROUNDS rounds measure what a round
# costs (SPARSE_TRACED_ROUNDS of them traced) and the store's mutations run
# at full size; recall is held on races run to certification over the first
# SPARSE_RACE_ROWS rows, a check of the path and not the cell's throughput
# (512, 16 a cluster of 32 on average, the fewest that keeps a query's
# cluster above k rows: at 256 rows, 8 a cluster, a query whose cluster
# holds fewer than k rows races hundreds of near-equal rows to exact and
# takes 7× the rounds; the rounds grow with the rows, so 768 took half as
# long again). The paper step's queries; the mutation steps' inserted rows
# (their deletes then leave 64 under half the capacity live, so that it
# compacts) and the queries whose true top-k is among the deletes
SPARSE_D = 28_672
SPARSE_ORACLE_CHUNK = 8192
SPARSE_CAPPED_ROUNDS = 200
SPARSE_TRACED_ROUNDS = 16
SPARSE_RACE_ROWS = 512
SPARSE_PAPER_QUERIES = 1
SPARSE_INSERTS = 512
SPARSE_TOP_DELETED = 16       # queries whose true top-k is among the deletes
# the plane phase (bmo-nn-dense at full width): tickets of PLANE_ROWS rows,
# round-robin over PLANE_TENANTS tenants; a quarter with a deadline, a
# quarter with an effort budget, half raced to certification
PLANE_ROWS = 8
PLANE_TENANTS = 4
PLANE_DEADLINE_MS = 2000.0
PLANE_BUDGET_EPOCHS = 8
PLANE_REPEATS = 128
PLANE_NEAR = 64
PLANE_NOISE = 1e-3
PLANE_FENCE_ROWS = 64
PLANE_FENCE_INSERTS = 512
PLANE_SPARSE_CUT_QUERIES = 8
PLANE_SPARSE_FULL_QUERIES = 64
PLANE_SPARSE_FULL_EPOCHS = 2
# rows of the store over which the audit's pairwise_dist launch is held to
# its plain version and to float64, at full d_pad
AUDIT_CHECK_ROWS = 16384
# the serve phase (qwen2.5-14b at full width and depth): a datastore of the
# model's final hidden states over SERVE_DS_STEPS batches of SERVE_DS_BATCH
# × SERVE_DS_SEQ tokens (262,144 rows), SERVE_BATCH requests of
# SERVE_PROMPT-token prompts, SERVE_KNN_TOKENS greedy tokens with the
# kNN-LM hook and appends, SERVE_CHECK_TOKENS without it and with the int8
# cache; the CLI's retrieval config; the float64 truth's rows a chunk
SERVE_DS_BATCH = 4
SERVE_DS_SEQ = 4096
SERVE_DS_STEPS = 16
SERVE_BATCH = 8
SERVE_PROMPT = 1024
SERVE_KNN_TOKENS = 8
SERVE_CHECK_TOKENS = 16
SERVE_CLI_TOKENS = 2
SERVE_BMO = dict(k=8, delta=0.05, block=64, batch_arms=16)
SERVE_TRUTH_CHUNK = 32768
# the kNN run's serving config (a TunedConfig): every row of this datastore
# ends in an exact evaluation, so each selected arm is pulled over all of
# its d/block = 80 blocks in one epoch (R 40 × P 2) and 2,048 arms race an
# epoch; the CLI's own config raced for SERVE_CLI_CAP_S seconds, reported
SERVE_TUNED = dict(epoch_rounds=40, pulls_per_round=2, batch_arms=2048)
SERVE_CLI_CAP_S = 10.0
SERVE_CLI_SHARDS = 2
# the teacher-forced forward's top-two logit margin above which the cache
# path's greedy token must be the forward's: four bf16 ulps of a logit
# below 16
SERVE_TOKEN_MARGIN = 0.25
# a cache-path layer against its teacher-forced cache-free run (relative
# L2; ``teacher_forced``), in the serve and families phases
TEACHER_FORCED_L2 = 1e-2
# the sharded phase (bmo-nn-dense as a sharded index): SHARDS shards, all
# on the one card; the rows inserted (near-copies of the first queries, a
# quarter of them deleted again) and the global ids deleted; the shard
# count live_reshard goes to; the sessions' rows, effort budget and
# deadline; the queries raced under the tuned config; the audited rows
SHARDS = 4
SHARD_INSERTS = 512
SHARD_DELETES = 4096
RESHARD_TO = 2
SHARD_SESSION_ROWS = 64
SHARD_BUDGET_EPOCHS = 12
SHARD_DEADLINE_MS = 2000.0
SHARD_TUNED_QUERIES = 256
SHARD_AUDIT_ROWS = 64
# queries on which a path's wide-init pull is held against its plain
# version (the plain version gathers a (Q, n, P, block) tensor)
REPLAY_INIT_QUERIES = 2
# the kmeans phase (Fig. 5: benchmarks/fig5_kmeans.py): dimension,
# clusters (= k) and Lloyd iterations; its points are --kmeans-points
# the fleet phase: tools/bench_fleet.py's structure (64 namespaces, 8
# resident, 4-query requests, two hot namespaces taking 70%) at 16,384 ×
# 4,096 fp32 rows a namespace
FLEET_NAMESPACES = 64
FLEET_ROWS = 16384
FLEET_DIM = 4096
FLEET_POOL = 16               # queries drawn with each namespace
FLEET_REQUEST_ROWS = 4
FLEET_REQUESTS = 96
FLEET_HOT = 2                 # the most recently created namespaces
FLEET_HOT_SHARE = 0.7
FLEET_MAX_RESIDENT = 8
FLEET_SHARDS = 2
FLEET_SHARDED = (62, 63)
FLEET_CLIENTS = 8             # closed loop: requests in flight
FLEET_CKPT_STEPS = 3
FLEET_PLAN_DEVICES = 4        # the rebalance's plan: a four-card host's
KMEANS_D = 8192
KMEANS_K = 32
KMEANS_ITERS = 2
KMEANS_FIG5_POINTS = 3000


def emit(obj) -> None:
    """One JSON line; a phase's line also gets ``at_s``, the seconds since
    the script started, so that a run cut at its time limit shows how far
    it got and what each phase cost."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls (CUDA
    events), after ``warmup`` calls. Each result is dropped before the next
    call, so the caching allocator reuses its memory. Python's garbage
    collector is off while the calls run, as ``timeit`` has it: a collection
    over this process's objects would land in the window of a host-bound
    call."""
    import gc
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    enabled = gc.isenabled()
    gc.disable()
    try:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        if enabled:
            gc.enable()
    return start.elapsed_time(end) / reps


# device_ms calls whose traces held none of the kernel they were asked
# for, each timed with CUDA events instead (reported as "profiler_misses")
PROFILER_MISSES = []
# what the card recorded of each distinct kernel launch device_ms traced
# (registers, threads, static + dynamic shared memory:
# rules_hopper.parse_trace), which the lint phase prices, and the seconds
# the recording took
LAUNCHES: dict = {}
LAUNCH_RECORD_S = [0.0]


def record_launches(prof) -> None:
    """Adds the kernel launches of a finished torch.profiler trace to
    LAUNCHES."""
    from repro_torch.analysis.rules_hopper import parse_trace
    t = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            for row in parse_trace(json.load(fh)):
                LAUNCHES[tuple(sorted(row.items()))] = row
    finally:
        os.remove(path)
        LAUNCH_RECORD_S[0] += time.perf_counter() - t


def device_ms(fn, symbol: str, reps: int = 5, expect: bool = True) -> float:
    """Mean device time per call of the CUDA kernels whose name contains
    ``symbol``, over ``reps`` calls under torch.profiler. Where a call's
    host work (the wrapper in Python, the launch) outlasts its kernel,
    ``cuda_ms`` measures the host and this measures the kernel.

    The profiler now and then delivers a trace without the kernels that
    ran. Where ``fn`` is ``expect``-ed to launch ``symbol``, a trace with
    none of it is taken twice more, and then the calls are timed with CUDA
    events (host gaps included), recorded in PROFILER_MISSES. A kernel that
    may launch no time (``expect=False``) reads 0 then."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3 if expect else 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
                 for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and symbol in ev.key)
        if us > 0:
            record_launches(prof)
        if us > 0 or not expect:
            return us / reps / 1e3
    ms = cuda_ms(fn, reps=reps, warmup=0)
    PROFILER_MISSES.append({"symbol": symbol, "traces": 3,
                            "cuda_event_ms": ms})
    print(f"device_ms: 3 traces held no {symbol!r} kernel; timed with CUDA "
          f"events instead ({ms} ms)", file=sys.stderr, flush=True)
    return ms


def kernels_per_call(fn, reps: int = 20) -> float:
    """CUDA kernels launched per call of ``fn`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(ev, "is_user_annotation", False)) / reps


def compare(what: str, got, want, *, rtol: float, atol: float,
            allowance=None) -> dict:
    """Max errors of ``got`` against ``want``; raises beyond
    atol + rtol·|want| (+ ``allowance``, a per-element tensor)."""
    import torch
    got = got.to(torch.float32)
    want = want.to(torch.float32)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (got - want).abs()
    # (an exact zero against a zero is no relative error, not 0/0)
    rel = torch.where(err == 0, 0.0, err / (want.abs() + atol))
    out = {"max_abs_err": float(err.max()), "max_rel_err": float(rel.max())}
    limit = atol + rtol * want.abs()
    if allowance is not None:
        limit = limit + allowance
    if not bool((err <= limit).all()):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version beyond rtol={rtol}, atol={atol}: {out}")
    return out


def bound_ms(nbytes: float, flops: float, peak: float = FP32_FLOPS) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pull_bound(x, arm, blk, block: int, out_floats: int = 2) -> tuple:
    """Least time for one pull launch (fused_epoch_pull, block_pull_multi):
    each distinct corpus block and query block it needs read once (a
    negative arm reads nothing), the indices read once, the output
    (``out_floats`` fp32 per (q, arm)) written once; 3 flops per pulled
    element."""
    import torch
    Q, B, T = blk.shape
    nb = x.shape[1] // block
    live = (arm >= 0)[:, :, None].expand(Q, B, T)
    seen = torch.zeros(x.shape[0] * nb, dtype=torch.bool, device=x.device)
    seen[(arm.long()[:, :, None] * nb + blk.long())[live]] = True
    qseen = torch.zeros(Q * nb, dtype=torch.bool, device=x.device)
    qseen[(torch.arange(Q, device=x.device)[:, None, None] * nb
           + blk.long())[live]] = True
    item = x.element_size()
    nbytes = ((int(seen.sum()) + int(qseen.sum())) * block * item
              + arm.numel() * 4 + blk.numel() * 4 + Q * B * out_floats * 4)
    return bound_ms(nbytes, 3.0 * int(live.sum()) * block)


#: buffer sizes the L2 read rate is measured at: from inside one of the
#: H100's two 25 MB L2 partitions to past it
L2_BUFFERS_MB = (8, 16, 24, 32)
#: bytes one launch of the L2 read reads, whatever the buffer: some 1 ms,
#: so a launch's fixed cost does not lower the rate (at 20 reads of the
#: buffer a launch, the rate rose with the buffer's size, 6.0 to 7.3 TB/s)
L2_BYTES_A_LAUNCH = 8 * 2 ** 30


def l2_read_rates(sets: int = 5) -> dict:
    """Bytes a second the card reads out of its L2: ``csrc/l2_read.cu``
    reading one buffer over and over, ``L2_BYTES_A_LAUNCH`` a launch
    (16-byte loads past L1, four blocks of 512 threads an SM), for each
    size in ``L2_BUFFERS_MB``: ``sets`` sets of 10 launches, each timed by
    CUDA events after a warm-up. Returns every set's rate by size and, as
    ``rate``, the largest of the sizes' medians: a floor is priced at the
    fastest rate the card showed."""
    import ctypes
    import statistics
    import torch
    from repro_torch.kernels import _build
    entry = _build.Entry("l2_read", "l2_read",
                         [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 512, dtype=torch.int32, device="cuda")
    by_mb = {}
    for mb in L2_BUFFERS_MB:
        buf = torch.randn(mb * 2 ** 20 // 4, device="cuda")
        reps = L2_BYTES_A_LAUNCH // (mb * 2 ** 20)
        run = lambda: _build.launch(entry, buf.get_device(), "l2_read",
                                    buf.data_ptr(), buf.numel() // 4, reps,
                                    blocks, out.data_ptr())
        by_mb[mb] = [buf.numel() * 4 * reps / (cuda_ms(run, reps=10,
                                                       warmup=3) / 1e3)
                     for _ in range(sets)]
        del buf
    return {"rate": max(map(statistics.median, by_mb.values())),
            "by_buffer_mb": by_mb}


def pull_l2_floor(x, arm, blk, block: int, schedule: str, kernel: str,
                  rate: float, out_floats: int = 2) -> float:
    """Least time for the bytes a pull launch's schedule moves between L2
    and the SMs, at the card's L2 read rate ``rate`` (``l2_read_rates``),
    for the arms that read (0 ≤ arm < n): rows, each query slice the pulls
    need and each arm's row once; fused_epoch_pull's pair schedule, each
    pair's distinct corpus blocks and each query row once, its block ids
    twice (marked, then folded); block_pull_multi's pair schedule, both
    slices of every pull. Ids and outputs once besides."""
    import torch
    Q, B, T = blk.shape
    item = x.element_size()
    reads = (arm >= 0) & (arm < x.shape[0])
    pulls = int(reads.sum()) * T
    ids = arm.numel() * 4 + blk.numel() * 4
    nbytes = ids + Q * B * out_floats * 4
    if schedule == "rows":
        nbytes += pulls * block * item + int(reads[0].sum()) * x.shape[1] * item
    elif kernel == "fused_epoch_pull":
        srt = torch.sort(blk, dim=-1).values
        distinct = 1 + (srt[..., 1:] != srt[..., :-1]).sum(-1)
        nbytes += int(distinct[reads].sum()) * block * item \
            + Q * x.shape[1] * item + blk.numel() * 4
        del srt, distinct
    else:
        nbytes += 2 * pulls * block * item
    return nbytes / rate * 1e3


def pairwise_bound(Q: int, n: int, d: int, variant: str) -> dict:
    """Least time for pairwise_dist: both operands read once, the (Q, n)
    output written once. Operations: on the tensor cores (split TF32),
    three TF32 products of 2 flops per (q, r, j) term at 495 TFLOP/s; on
    the CUDA cores (the difference form, ℓ2 or ℓ1), 2 issue slots per term
    (subtract, then square-and-add or abs-and-add) at 33.5e12 slots/s."""
    nbytes = 4.0 * (Q * d + n * d + Q * n)
    tc = bound_ms(nbytes, 6.0 * Q * n * d, TF32_TC_FLOPS)
    cc = bound_ms(nbytes, 2.0 * Q * n * d, FP32_SLOTS)
    t, by = tc if variant == "tensor_cores" else cc
    return {"bound_ms": t, "bound_by": by, "bound_ms_tensor_cores": tc[0],
            "bound_ms_cuda_cores_difference_form": cc[0]}


def fwht_bound(x) -> tuple:
    rows, d = x.numel() // x.shape[-1], x.shape[-1]
    return bound_ms(2.0 * x.numel() * x.element_size(),
                    rows * d * (math.log2(d) + 1.0))


def flash_bound(q, k, v, causal: bool, q_offset: int = 0) -> dict:
    """Least time for one attention call: q, k, v read once and the output
    written once; 2·D + 2·Dv flops per (query, key) pair that the mask
    keeps (the softmax's few flops per pair are not counted). The bound is
    taken at the peak for the inputs' type (the bf16 tensor cores for bf16,
    the fp32 rate for fp32), and at the fp32 CUDA-core rate beside it."""
    import torch
    B, H, Sq, D = q.shape
    Sk, Dv = k.shape[2], v.shape[-1]
    if causal:
        keys = torch.clamp(torch.arange(Sq) + q_offset + 1, 0, Sk)
        pairs = int(keys.sum())
    else:
        pairs = Sq * Sk
    flops = B * H * pairs * (2.0 * D + 2.0 * Dv)
    nbytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                 + B * H * Sq * Dv)
    peak = BF16_TC_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    t, by = bound_ms(nbytes, flops, peak)
    return {"bound_ms": t, "bound_by": by, "bound_flops": flops,
            "bound_bytes": nbytes,
            "bound_peak": "bf16 tensor cores, 989 TFLOP/s"
            if peak == BF16_TC_FLOPS else "fp32, 67 TFLOP/s",
            "bound_ms_fp32_cuda_cores": bound_ms(nbytes, flops)[0],
            "bound_ms_bf16_tensor_cores": bound_ms(nbytes, flops,
                                                   BF16_TC_FLOPS)[0]}


def tc_check(what: str, got, bounds) -> dict:
    """Holds a bf16 output of the tensor-core flash kernel to each bound of
    ``ref.flash_attention_tc_bounds`` (given as ``bounds``, where each is
    derived); raises beyond either. Returns the max errors against both
    plain versions and the largest share of each limit taken."""
    import torch
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    out = {}
    for name, want, limit in bounds:
        err = (got.float() - want.float()).abs()
        out[f"max_abs_err_{name}"] = float(err.max())
        out[f"share_of_limit_{name}"] = float((err / limit).max())
        if out[f"share_of_limit_{name}"] > 1.0:
            raise AssertionError(f"{what}: kernel beyond its bound against "
                                 f"the plain version ({name}): {out}")
    out["max_abs_err"] = out["max_abs_err_p_fp32"]
    return out


def errors_against(got, want) -> tuple:
    """(max, RMS) of |got − want| in fp32."""
    err = got.float() - want.float()
    return float(err.abs().max()), float(err.pow(2).mean().sqrt())


def sass_check(stem: str) -> dict:
    """What the built library holds: its tensor-core instructions (HGMMA) in
    the SASS, and what ptxas said about spills, setmaxnreg and wgmma
    serialisation (None where the library was built by an earlier run that
    kept no log)."""
    from repro_torch.kernels import _build
    log = _build.build_log.get(stem, {}).get("log")
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(stem))],
                          check=True, capture_output=True, text=True,
                          timeout=120).stdout
    out = {"hgmma_in_sass": sass.count("HGMMA"),
           "local_memory_in_sass": sass.count("LDL") + sass.count("STL"),
           "ptxas_spill_lines": None, "ptxas_setmaxnreg_ignored": None,
           "ptxas_wgmma_serialized": None}
    if log is not None:
        out.update({
            "ptxas_spill_lines": [
                line.strip() for line in log.splitlines() if "spill" in line
                and "0 bytes spill stores, 0 bytes spill loads" not in line],
            "ptxas_setmaxnreg_ignored": "setmaxnreg ignored" in log,
            "ptxas_wgmma_serialized": "serialized" in log})
    if out["hgmma_in_sass"] == 0:
        raise AssertionError(f"{stem}: no HGMMA in the built SASS")
    return out


def ptxas_functions(stem: str) -> dict:
    """What ptxas said (``-v``) about each kernel of ``csrc/<stem>.cu``:
    {mangled name: registers, static shared bytes, stack, spill stores and
    loads}, parsed as the lint's Hopper rule parses it; empty where the
    library was built by an earlier run that kept no log."""
    from repro_torch.analysis.rules_hopper import parse_ptxas
    from repro_torch.kernels import _build
    return parse_ptxas(_build.build_log.get(stem, {}).get("log") or "")


def fwht_kernel_report(d: int, dtype) -> dict:
    """The fwht kernel that (d, dtype) launches: its plan as the kernel
    reports it (E, threads, rows a block, dynamic shared bytes, blocks an
    SM by the occupancy calculator) and ptxas's registers and spills for
    its instantiation (``fwht_kernel_{wide,narrow}<type, log2 d>``)."""
    import torch
    from repro_torch.kernels.fwht import kernel_plan
    plan = kernel_plan(d, dtype)
    marker = ("If" if dtype == torch.float32 else "I13__nv_bfloat16") + \
        f"Li{d.bit_length() - 1}E"
    found = {name: info for name, info in ptxas_functions("fwht").items()
             if "fwht_kernel" in name and marker in name}
    out = {"plan": plan, "ptxas": found or None}
    if any(info.get("spill_store_bytes") or info.get("spill_load_bytes")
           for info in found.values()):
        raise AssertionError(f"fwht d={d} {dtype}: ptxas spills: {found}")
    return out


# flash_attention at the families phase's shapes, bf16 (D 128 on the
# tensor-core kernel, the others on the CUDA-core one): (case, (B, H, KV,
# S, D), causal)
FAMILY_FLASH_CASES = (
    ("zamba2_shared_block", (4, 32, 32, 4096, 80), True),
    ("whisper_encoder", (8, 8, 8, 1500, 64), False),
    ("nemotron_layer_d192", (1, 96, 8, 4096, 192), True),
    ("dbrx_layer", (1, 48, 8, 4096, 128), True))


def flash_rows(g) -> list:
    """flash_attention at one layer of the LM path (qwen2.5-14b's 40 query
    and 8 KV heads of 128 over 4 × 4,096 tokens, bf16, causal: the
    tensor-core kernel), at a GQA case of the reference kernel test's grid
    in fp32 (the CUDA-core kernel), and at the families phase's bf16 shapes
    (``FAMILY_FLASH_CASES``: zamba2's shared block at D 80, whisper's
    bidirectional encoder at D 64, nemotron-4-340b's D 192 on the wide
    instantiation, all on the CUDA-core kernel; dbrx-132b's layer, 48
    query heads over 8 KV heads of 128, on the tensor cores). Tolerances:
    bf16 on the tensor cores
    as ``tc_check``, and the kernel's max and RMS errors against the plain
    version at most twice those of the library call's on the same inputs;
    fp32 at 3e-5 as the reference test; bf16 on the CUDA cores within one
    bf16 ulp (rtol 8e-3, atol 1e-4: both round the same fp32 values, as
    the card tests hold it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attn import flash_attention_cuda, variant

    rows = []
    cases = [("lm_layer", (LM_BATCH, 40, 8, LM_SEQ, 128), torch.bfloat16,
              True),
             ("reference_grid", (2, 4, 2, 128, 32), torch.float32, True)]
    cases += [(case, shape, torch.bfloat16, causal)
              for case, shape, causal in FAMILY_FLASH_CASES]
    for case, (B, H, KV, S, D), dtype, causal in cases:
        q = torch.randn((B, H, S, D), generator=g, device="cuda").to(dtype)
        k = torch.randn((B, KV, S, D), generator=g, device="cuda").to(dtype)
        v = torch.randn((B, KV, S, D), generator=g, device="cuda").to(dtype)
        run = lambda: flash_attention_cuda(q, k, v, causal=causal)
        plain = lambda: ref.flash_attention_ref(q, k, v, causal, 0)
        library = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)
        big = case == "lm_layer"
        tc = variant(dtype, D, D) == "tensor_cores"
        row = {"kernel": "flash_attention", "case": case,
               "variant": variant(dtype, D, D),
               "dtype": str(dtype).replace("torch.", ""), "causal": causal,
               "shape": {"B": B, "H": H, "KV": KV, "Sq": S, "Sk": S, "D": D}}
        got = run()
        if tc:
            bounds = ref.flash_attention_tc_bounds(q, k, v, True, 0)
            row.update(tc_check(f"flash_attention {case}", got, bounds))
            row["tolerance"] = "ref.flash_attention_tc_bounds"
            want = bounds[-1][1]               # the plain version, p in fp32
            del bounds
            # yardstick only: the library call's own error on the same inputs
            mine = errors_against(got, want)
            lib = errors_against(library(), want)
            row.update({"kernel_max_err": mine[0], "kernel_rms_err": mine[1],
                        "library_max_err": lib[0], "library_rms_err": lib[1]})
            if mine[0] > 2 * lib[0] or mine[1] > 2 * lib[1]:
                raise AssertionError(f"flash_attention {case}: errors (max, "
                                     f"RMS) {mine} beyond twice the library "
                                     f"call's {lib}")
        else:
            want = plain()
            tol = ({"rtol": 3e-5, "atol": 3e-5} if dtype == torch.float32
                   else {"rtol": 8e-3, "atol": 1e-4})
            row.update(compare(f"flash_attention {case}", got, want, **tol))
            row["tolerance"] = tol
        del got, want
        small = case == "reference_grid"
        row["ms"] = cuda_ms(run, reps=50 if small else 20 if big else 10)
        row["device_ms"] = device_ms(run, "flash_attn",
                                     reps=20 if small else 5)
        if big:
            row["sass"] = sass_check("flash_attn_sm90")
        row["plain_ms"] = cuda_ms(plain, reps=2, warmup=1)
        row.update(flash_bound(q, k, v, causal=causal))
        # yardstick only: the one PyTorch call computing the same function,
        # and the same call on K/V repeated to H heads (its flash backend)
        row["library_ms"] = cuda_ms(library, reps=20, warmup=1)
        row["library_call"] = ("torch.nn.functional.scaled_dot_product_"
                               f"attention(q, k, v, is_causal={causal}, "
                               "enable_gqa=True)")
        kr, vr = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
        row["library_ms_kv_repeated"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                   is_causal=causal),
            reps=20, warmup=1)
        rows.append(row)
        emit(row)
        del q, k, v, kr, vr
        torch.cuda.empty_cache()
    return rows


def float64_l2(qs, x):
    """Squared ℓ2 distances in float64 (the expanded form, whose float64
    rounding is some 1e-16 of ‖q‖² + ‖x‖²), and that scale."""
    import torch
    q64, x64 = qs.double(), x.double()
    scale = (q64 * q64).sum(1)[:, None] + (x64 * x64).sum(1)[None]
    return (scale - 2.0 * (q64 @ x64.T)).clamp_min_(0.0), scale


def pairwise_gamma_rows(g) -> list:
    """The tensor-core ℓ2 kernel's unrepaired error, |got − exact| over
    ‖q‖² + ‖x‖², on inputs made to cancel, at the oracle's d = 12,288 and
    at d = 128: x against itself, near-duplicates (noise 1e-3), a common
    offset of 100. Raises if it reaches gamma(d), the bound its flagging
    assumes; then holds the repaired output to the float64 brute force at
    rtol 1e-5 / atol 1e-4, with exactly 0.0 on the diagonal of x against
    itself."""
    import torch
    from repro_torch.kernels.pairwise_dist import (flagged_pairs, gamma,
                                                   pairwise_dist_cuda,
                                                   reset_flagged)
    rows = []
    for d in (12_288, 128):
        x = torch.randn((512, d), generator=g, device="cuda")
        noise = 1e-3 * torch.randn(x.shape, generator=g, device="cuda")
        for case, qs, xx in (("x_vs_x", x, x), ("near_duplicates", x + noise, x),
                             ("offset_100", x[:64] + 100.0, x + 100.0)):
            exact, scale = float64_l2(qs, xx)
            raw = pairwise_dist_cuda(qs, xx, repair=False)
            err = float(((raw.double() - exact).abs() / scale).max())
            reset_flagged()
            got = pairwise_dist_cuda(qs, xx)
            row = {"kernel": "pairwise_dist", "case": f"gamma_{case}", "d": d,
                   "shape": {"Q": qs.shape[0], "n": xx.shape[0], "d": d},
                   "unrepaired_err_over_scale": err, "gamma": gamma(d),
                   "flagged_pairs": flagged_pairs(),
                   **compare(f"pairwise_dist {case} d={d}", got.double(),
                             exact, rtol=1e-5, atol=1e-4)}
            if err >= gamma(d):
                raise AssertionError(f"pairwise_dist {case} d={d}: unrepaired "
                                     f"error {err} of the scale reaches "
                                     f"gamma {gamma(d)}")
            if qs is xx and float(torch.diagonal(got).abs().max()) != 0.0:
                raise AssertionError(f"pairwise_dist {case} d={d}: diagonal "
                                     "not exactly 0")
            rows.append(row)
            emit(row)
    return rows


def kernel_phase(seed: int, Q: int, n_build: int) -> dict:
    """Each kernel against its plain version at the shapes its path gives
    it."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_pull import (block_pull_cuda,
                                                block_pull_multi_cuda)
    from repro_torch.kernels.fused_race import fused_epoch_pull_cuda
    from repro_torch.kernels.fwht import fwht_cuda
    from repro_torch.kernels.pairwise_dist import (flagged_pairs,
                                                   pairwise_dist_cuda,
                                                   reset_flagged)
    from repro_torch.kernels.pairwise_dist import variant as pairwise_variant

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    cap, d_pad, block, B, T = 131072, 16384, 128, 32, 128
    nb = d_pad // block
    x = torch.randn((cap, d_pad), generator=g, device="cuda")
    qs = torch.randn((Q, d_pad), generator=g, device="cuda")
    results = {"fused_epoch_pull": [], "fwht": []}

    # --- the two pull kernels, each schedule: an epoch or a round (random
    # arms a query: the pair schedule), and the wide init with every query's
    # arms one expanded vector (the rows schedule, as the drivers pass it)
    # and as a general (Q, n) tensor (the pair schedule) -------------------
    l2 = l2_read_rates()
    rate = l2["rate"]
    results["l2_read_bytes_per_s"] = rate
    results["l2_read_bytes_per_s_by_buffer_mb"] = l2["by_buffer_mb"]
    emit({"l2_read_bytes_per_s": rate,
          "l2_read_bytes_per_s_by_buffer_mb": l2["by_buffer_mb"],
          "how": f"csrc/l2_read.cu: each buffer read over and over, "
                 f"{L2_BYTES_A_LAUNCH} bytes a launch, 5 sets of 10 "
                 f"launches; the rate is the largest size's median"})
    P, T0, Qs = 2, 2, 16
    results["block_pull_multi"] = []
    expanded = torch.arange(cap, dtype=torch.int32, device="cuda")[None].expand(
        Q, cap)
    for kernel, case, Bc, Tc in (
            ("fused_epoch_pull", "epoch", B, T),
            ("fused_epoch_pull", "init", cap, T0),
            ("fused_epoch_pull", "init_general_arms", cap, T0),
            ("block_pull_multi", "round", B, P),
            ("block_pull_multi", "init", cap, P),
            ("block_pull_multi", "init_general_arms", cap, P)):
        if case in ("epoch", "round"):
            arm = torch.randint(0, cap, (Q, Bc), generator=g, device="cuda",
                                dtype=torch.int32)
        elif case == "init":
            arm = expanded
        else:
            arm = expanded.contiguous()
        blk = torch.randint(0, nb, (Q, Bc, Tc), generator=g, device="cuda",
                            dtype=torch.int32)
        wide = Bc == cap
        sub = Qs if wide else Q      # the plain version's share of queries
        if kernel == "fused_epoch_pull":
            wrapper, symbol, out_floats = fused_epoch_pull_cuda, kernel, 2
            plain_fn = ref.fused_epoch_pull_ref
        else:
            wrapper, symbol, out_floats = block_pull_multi_cuda, "block_pull", Tc
            plain_fn = ref.block_pull_multi_ref
        metrics = ("l2", "l1") if case == "epoch" else ("l2",)
        for metric in metrics:
            run = lambda: wrapper(x, qs, arm, blk, block=block, metric=metric)
            plain = lambda: plain_fn(x, qs[:sub], arm[:sub], blk[:sub], block,
                                     metric)
            before = (wrapper.launches_rows, wrapper.launches_pair)
            got = run()
            schedule = "rows" if wrapper.launches_rows > before[0] else "pair"
            row = {"kernel": kernel, "case": case, "metric": metric,
                   "schedule": schedule,
                   "shape": {"Q": Q, "B": Bc,
                             ("T" if kernel == "fused_epoch_pull" else "P"): Tc,
                             "block": block, "d_pad": d_pad, "n": cap},
                   "arms": {"epoch": "random", "round": "random",
                            "init": "one vector expanded to (Q, n)"}.get(
                                case, "a contiguous (Q, n) tensor")}
            if wide:
                row["plain_checked_on_queries"] = sub
            row.update(compare(f"{kernel} {case} {metric}", got[:sub], plain(),
                               rtol=2e-4, atol=1e-5))
            del got
            # a round's call is host-bound: warmed up as block_pull's round
            row["ms"] = cuda_ms(run, reps=3 if wide else 200 if case == "round"
                                else 20, warmup=1 if wide else 50)
            row["device_ms"] = device_ms(run, symbol, reps=2 if wide else 20)
            row["plain_ms" if sub == Q else "plain_ms_first_queries"] = \
                cuda_ms(plain, reps=2 if wide else 3, warmup=1)
            row["bound_ms"], row["bound_by"] = pull_bound(
                x, arm, blk, block, out_floats=out_floats)
            row["l2_floor_ms"] = pull_l2_floor(x, arm, blk, block, schedule,
                                               kernel, rate, out_floats)
            row["library_ms"] = None
            results[kernel].append(row)
            emit(row)
        del arm, blk
        torch.cuda.empty_cache()
    del expanded
    torch.cuda.empty_cache()

    # --- block_pull: one query's round (the paper path) and its wide init
    # over the 100,000 rows of the paper path's corpus -----------------------
    results["block_pull"] = []
    for case, Bc in (("round", B), ("init", n_build)):
        # int64 arm ids, int32 block ids: what the paper path passes
        if case == "round":
            arm = torch.randint(0, n_build, (Bc,), generator=g, device="cuda")
        else:
            arm = torch.arange(n_build, device="cuda")
        blk = torch.randint(0, nb, (Bc, P), generator=g, device="cuda",
                            dtype=torch.int32)
        q0 = qs[0]                  # the paper path holds its query as is
        run = lambda: block_pull_cuda(x, q0, arm, blk, block=block)
        plain = lambda: ref.block_pull_ref(x, q0, arm, blk, block)
        row = {"kernel": "block_pull", "case": case, "metric": "l2",
               "shape": {"B": Bc, "P": P, "block": block, "d_pad": d_pad,
                         "n": n_build},
               "id_types": {"arm": "int64", "blk": "int32"}}
        row.update(compare(f"block_pull {case}", run(), plain(), rtol=2e-4,
                           atol=1e-5))
        # a round's call is host-bound: 200 calls bring the host's clock up
        # (this row follows device-bound ones), many average its jitter
        row["ms"] = cuda_ms(run, reps=1000, warmup=200) if case == "round" \
            else cuda_ms(run, reps=50)
        row["device_ms"] = device_ms(run, "block_pull_kernel", reps=20)
        row["host_us_per_call"] = (row["ms"] - row["device_ms"]) * 1e3
        row["cuda_kernels_per_call"] = kernels_per_call(run)
        row["plain_ms"] = cuda_ms(plain, reps=5, warmup=1)
        row["bound_ms"], row["bound_by"] = pull_bound(x, arm[None], blk[None],
                                                      block, out_floats=P)
        row["library_ms"] = None
        results["block_pull"].append(row)
        emit(row)
    del x, arm, blk
    torch.cuda.empty_cache()

    # --- fwht: each query batch, and the corpus at build ---------------------
    hadamard = None
    for rows in (Q, n_build):
        for dtype in (torch.float32, torch.bfloat16):
            xin = torch.randn((rows, d_pad), generator=g, device="cuda").to(dtype)
            tol = 1e-5 if dtype == torch.float32 else 5e-2
            run = lambda: fwht_cuda(xin)
            plain = lambda: ref.fwht_ref(xin)
            row = {"kernel": "fwht", "case": "queries" if rows == Q else "build",
                   "dtype": str(dtype).replace("torch.", ""),
                   "shape": {"rows": rows, "d": d_pad}}
            row.update(compare(f"fwht {rows}x{d_pad} {dtype}", run(), plain(),
                               rtol=tol, atol=tol))
            row["ms"] = cuda_ms(run, reps=10)
            row["device_ms"] = device_ms(run, "fwht_kernel")
            row["plain_ms"] = cuda_ms(plain, reps=2, warmup=1)
            row["bound_ms"], row["bound_by"] = fwht_bound(xin)
            nbytes = 2.0 * xin.numel() * xin.element_size()
            row["achieved_bytes_per_s"] = nbytes / (row["device_ms"] * 1e-3)
            row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
            row["compiled"] = fwht_kernel_report(d_pad, dtype)
            row["library_ms"] = None
            if rows == Q and dtype == torch.float32:
                # yardstick only: one dense matmul against H/√d, full fp32
                if hadamard is None:
                    hadamard = torch.ones((1, 1), device="cuda")
                    while hadamard.shape[0] < d_pad:
                        hadamard = torch.cat([torch.cat([hadamard, hadamard], 1),
                                              torch.cat([hadamard, -hadamard], 1)])
                    hadamard /= math.sqrt(d_pad)
                row["library_ms"] = cuda_ms(lambda: xin @ hadamard, reps=5)
                row["library_call"] = "torch.matmul(x, H/sqrt(d)), fp32, TF32 off"
            results["fwht"].append(row)
            emit(row)
            del xin
    del hadamard
    torch.cuda.empty_cache()

    # --- pairwise_dist: one oracle batch (256 queries against the corpus at
    # d = 12,288: the tensor cores), the paper path's exact evaluation (one
    # query against the B rows just selected, at d_pad = 16,384: the CUDA
    # cores), and one chunk of the sparse oracle (every query against
    # SPARSE_ORACLE_CHUNK densified rows at d = 28,672, 7% nonzero: ℓ1 on
    # the CUDA cores) -----------------------------------------------------
    results["pairwise_dist"] = []
    X = torch.randn((n_build, 12_288), generator=g, device="cuda")
    Qo = torch.randn((256, 12_288), generator=g, device="cuda")
    Xe = torch.randn((B, d_pad), generator=g, device="cuda")
    qe = torch.randn((1, d_pad), generator=g, device="cuda")

    def sparse_like(rows):
        x = torch.rand((rows, SPARSE_D), generator=g, device="cuda")
        return torch.where(x < 0.07, x * 30.0, 0.0)     # 7% nonzero
    Xs, Qs_ = sparse_like(SPARSE_ORACLE_CHUNK), sparse_like(Q)
    for case, qq, xx in (("oracle", Qo, X), ("exact_eval", qe, Xe),
                         ("sparse_oracle", Qs_, Xs)):
        for metric in ("l1",) if case == "sparse_oracle" else ("l2", "l1"):
            # ℓ1's plain version holds (Q, n, 2048) at once: at an oracle's
            # shape it is checked on the first 8 queries × 8,192 rows
            sub = (8, 8192) if case != "exact_eval" and metric == "l1" else \
                tuple(qq.shape[:1]) + tuple(xx.shape[:1])
            run = lambda: pairwise_dist_cuda(qq, xx, metric=metric)
            plain = lambda: ref.pairwise_dist_ref(qq[:sub[0]], xx[:sub[1]],
                                                  metric)
            Q_, n_, d_ = qq.shape[0], xx.shape[0], xx.shape[1]
            which = pairwise_variant(metric, Q_, d_)
            row = {"kernel": "pairwise_dist", "case": case, "metric": metric,
                   "variant": which, "shape": {"Q": Q_, "n": n_, "d": d_}}
            allowance = None
            if metric == "l2":
                allowance = 1e-6 * ((qq[:sub[0]] ** 2).sum(1)[:, None]
                                    + (xx[:sub[1]] ** 2).sum(1)[None])
            if sub != (Q_, n_):
                row["plain_checked_on"] = {"queries": sub[0], "rows": sub[1]}
            reset_flagged()
            launches = pairwise_dist_cuda.launches_tc
            got = run()
            if which == "tensor_cores":
                row["flagged_pairs"] = flagged_pairs()
                if pairwise_dist_cuda.launches_tc != launches + 1:
                    raise AssertionError(f"pairwise_dist {case}: not on the "
                                         "tensor cores")
                # the kernel's contract: 1e-4 of the exact value, relatively
                row["max_rel_err_float64"] = compare(
                    f"pairwise_dist {case} {metric} against float64",
                    got.double(), float64_l2(qq, xx)[0], rtol=1e-4,
                    atol=0.0)["max_rel_err"]
            row.update(compare(f"pairwise_dist {case} {metric}",
                               got[:sub[0], :sub[1]], plain(), rtol=1e-4,
                               atol=1e-3 if metric == "l1" else 0.0,
                               allowance=allowance))
            del got
            # the exact evaluation is host-bound: warmed up as block_pull's
            # round
            reps = 1000 if case == "exact_eval" else 5
            row["ms"] = cuda_ms(run, reps=reps,
                                warmup=200 if case == "exact_eval" else 2)
            row["device_ms"] = device_ms(run, "pairwise_", reps=min(reps, 20))
            if which == "tensor_cores":
                row["repair_ms"] = device_ms(run, "pairwise_repair_flagged",
                                             reps=5, expect=False)
                row["sass"] = sass_check("pairwise_dist_sm90")
            if case == "exact_eval":
                row["host_us_per_call"] = (row["ms"] - row["device_ms"]) * 1e3
                row["cuda_kernels_per_call"] = kernels_per_call(run)
            row["plain_ms" if sub == (Q_, n_) else "plain_ms_subset"] = \
                cuda_ms(plain, reps=3, warmup=1)
            row.update(pairwise_bound(Q_, n_, d_, which))
            # yardstick only: the one PyTorch call computing the same
            # function (fp32, TF32 off)
            if metric == "l2":
                lib = lambda: ((qq * qq).sum(1)[:, None] + (xx * xx).sum(1)[None]
                               - 2.0 * torch.matmul(qq, xx.T))
                row["library_call"] = "‖q‖²+‖x‖²−2·torch.matmul(q, xᵀ), fp32"
            else:
                lib = lambda: torch.cdist(qq, xx, p=1)
                row["library_call"] = "torch.cdist(q, x, p=1)"
            row["library_ms"] = cuda_ms(lib, reps=20 if case == "exact_eval"
                                        else 2, warmup=1)
            results["pairwise_dist"].append(row)
            emit(row)
    del X, Qo, Xe, qe, Xs, Qs_
    torch.cuda.empty_cache()
    results["pairwise_gamma"] = pairwise_gamma_rows(g)
    torch.cuda.empty_cache()
    results["flash_attention"] = flash_rows(g)
    return results


def small_input_phase() -> dict:
    """The whole path on a small input on the card: the exact top-k of a
    brute force (the CPU tests' datasets and config)."""
    import numpy as np
    from repro_torch.api import Index
    from repro_torch.configs.base import BMOConfig
    from repro_torch.data.synthetic import make_knn_benchmark_data

    corpus, queries = make_knn_benchmark_data("dense", 500, 1024, 5, seed=21)
    dist = ((queries[:, None, :].astype(np.float64)
             - corpus[None].astype(np.float64)) ** 2).sum(-1)
    truth = [set(r) for r in np.argsort(dist, 1, kind="stable")[:, :3].tolist()]
    out = {}
    for rotate in (False, True):
        cfg = BMOConfig(k=3, delta=0.01, block=64, batch_arms=16,
                        pulls_per_round=2, metric="l2", rotate=rotate)
        res = Index.build(corpus, cfg, device="cuda").query(queries)
        got = [set(r) for r in res.indices.tolist()]
        if got != truth:
            raise AssertionError(f"small input, rotate={rotate}: top-k "
                                 f"{got} != brute force {truth}")
        out["rotated" if rotate else "dense"] = "exact top-k"
    return out


def brute_force_topk(corpus, queries, k: int, rows=None,
                     chunk: int = 16384):
    """Exact top-k by float64 squared distance over the corpus rows
    ``rows`` (a tensor of row ids, default all; the result indexes it), in
    chunks of ``chunk`` rows, so no float64 copy of the whole corpus is
    made. ``corpus`` is a tensor or a tuple of tensors read as their
    concatenation."""
    import torch
    parts = corpus if isinstance(corpus, tuple) else (corpus,)
    n = sum(p.shape[0] for p in parts) if rows is None else rows.shape[0]
    q = queries.to(torch.float64)
    q2 = (q * q).sum(1)[:, None]
    best_d = best_i = None
    for s in range(0, n, chunk):
        ids = torch.arange(s, min(s + chunk, n), device=q.device)
        x = take_rows(parts, ids if rows is None else rows[ids]).to(
            torch.float64)
        dist = q2 + (x * x).sum(1)[None] - 2.0 * (q @ x.T)
        del x
        cand = ids[None].expand(q.shape[0], -1)
        if best_d is not None:
            dist = torch.cat([best_d, dist], 1)
            cand = torch.cat([best_i, cand], 1)
        best_d, pos = torch.topk(dist, min(k, dist.shape[1]), dim=1,
                                 largest=False)
        best_i = torch.gather(cand, 1, pos)
    return best_i.cpu().numpy()


def take_rows(parts, ids):
    """Rows ``ids`` of the concatenation of the tensors ``parts``."""
    import torch
    if len(parts) == 1:
        return parts[0][ids]
    out = torch.empty((ids.shape[0], parts[0].shape[1]),
                      dtype=parts[0].dtype, device=parts[0].device)
    start = 0
    for p in parts:
        mine = (ids >= start) & (ids < start + p.shape[0])
        out[mine] = p[ids[mine] - start]
        start += p.shape[0]
    return out


def recall_of(what: str, indices, values, truth, n: int, k: int) -> dict:
    """Recall of the (Q, k) top-k sets ``indices`` (numpy) against the
    brute force's; raises on a malformed result or a recall under 0.99."""
    import numpy as np
    if indices.shape != (len(truth), k) or not np.isfinite(values).all():
        raise AssertionError(f"{what}: malformed result")
    if not ((indices >= 0) & (indices < n)).all():
        raise AssertionError(f"{what}: a returned slot is not a corpus row")
    hits = [len(set(a) & set(b)) for a, b in zip(indices.tolist(),
                                                 truth.tolist())]
    out = {"recall": float(np.mean(hits)) / k,
           "queries_below_full_recall": int(sum(h < k for h in hits))}
    if out["recall"] < 0.99:
        raise AssertionError(f"{what}: recall {out['recall']} < 0.99")
    return out


def counted(path: str, wrappers: dict, run):
    """Run one path with its kernels' launch counters (each wrapper's total
    and, for flash_attention, each variant's) set to 0 just before and read
    just after; raises if a kernel of the path never launched.
    Returns (run's result, {kernel: launches})."""
    for w in wrappers.values():
        for attr in [a for a in vars(w) if a.startswith("launches")]:
            setattr(w, attr, 0)
    result = run()
    launches = {name: w.launches for name, w in wrappers.items()}
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the {path} path never launched {name}")
    return result, launches


def main_path_phase(corpus, queries, truth, seed: int) -> tuple:
    """``Index.build`` → ``Index.query`` on the fused driver. Returns the
    report, the index, which the rounds and mutation phases take again, and
    the query's result."""
    import numpy as np
    import torch
    from repro_torch.api import Index
    from repro_torch.configs.bmo_nn import DENSE
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.fused_race import fused_epoch_pull_cuda
    from repro_torch.kernels.fwht import fwht_cuda

    cfg, n, d = DENSE.bmo, DENSE.n_points, DENSE.dim
    Q = queries.shape[0]
    torch.cuda.reset_peak_memory_stats()
    times = {}

    shapes = collections.Counter()    # (Q, B, T) of each pull launch
    pull = kops.fused_epoch_pull

    def recorded(x, qs, arm_idx, blk_idx, **kw):
        shapes[tuple(blk_idx.shape)] += 1
        return pull(x, qs, arm_idx, blk_idx, **kw)

    def run():
        t = time.perf_counter()
        idx = Index.build(corpus, cfg, seed)
        torch.cuda.synchronize()
        times["build_s"] = time.perf_counter() - t
        kops.fused_epoch_pull = recorded
        try:
            t = time.perf_counter()
            res = idx.query(queries, seed)      # returns host arrays: synced
            times["query_s"] = time.perf_counter() - t
        finally:
            kops.fused_epoch_pull = pull
        return idx, res

    (idx, res), launches = counted(
        "main", {"fused_epoch_pull": fused_epoch_pull_cuda, "fwht": fwht_cuda},
        run)
    by_schedule = {"rows": fused_epoch_pull_cuda.launches_rows,
                   "pair": fused_epoch_pull_cuda.launches_pair}
    out = {
        "phase": "main_path", "workload": DENSE.name, "n": n, "d": d,
        "queries": Q, "k": cfg.k, "delta": cfg.delta, "block": cfg.block,
        "batch_arms": cfg.batch_arms, "rotate": cfg.rotate, "seed": seed,
        **times, "qps": Q / times["query_s"],
        "epochs": launches["fused_epoch_pull"] - 1,
        **recall_of("main path", res.indices, res.values, truth, n, cfg.k),
        "coord_ops_share_of_nd": float(np.mean(res.coord_ops)) / (n * d),
        "rounds_mean": float(np.mean(res.rounds)),
        "n_exact_mean": float(np.mean(res.n_exact)),
        "launches": launches,
        "fused_epoch_pull_by_schedule": by_schedule,
        "fused_epoch_pull_shapes_QBT": [
            {"Q": q, "B": b, "T": t_, "launches": c}
            for (q, b, t_), c in sorted(shapes.items())],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    out["traced"] = traced_query(idx, queries, seed)
    out["traced_build"] = traced_build(corpus, cfg, seed)
    return out, idx, res


def oracle_phase(corpus, queries, truth) -> dict:
    """``core.oracle.exact_knn`` of every query against the float64 brute
    force. A set that differs passes only when the float64 distances of
    the swapped rows lie within 1e-4 of each other, relatively (a near-tie
    at the precision of an fp32 sum of d = 12,288 terms); the values must
    be the float64 θ to 1e-4."""
    import numpy as np
    import torch
    from repro_torch.configs.bmo_nn import DENSE
    from repro_torch.core.oracle import exact_knn
    from repro_torch.kernels.pairwise_dist import (flagged_pairs, gamma,
                                                   pairwise_dist_cuda,
                                                   reset_flagged)
    from repro_torch.kernels.pairwise_dist import \
        flag_ratio as pairwise_flag_ratio

    k, (n, d) = DENSE.bmo.k, corpus.shape
    Q = queries.shape[0]
    reset_flagged()
    t = time.perf_counter()

    def run():
        ex = exact_knn(corpus, queries, k)
        torch.cuda.synchronize()
        return ex

    ex, launches = counted("oracle", {"pairwise_dist": pairwise_dist_cuda},
                           run)
    oracle_s = time.perf_counter() - t
    flagged = flagged_pairs()
    launches_tc = pairwise_dist_cuda.launches_tc
    if launches_tc != launches["pairwise_dist"]:
        raise AssertionError(f"oracle: {launches_tc} of "
                             f"{launches['pairwise_dist']} pairwise_dist "
                             "launches on the tensor cores")
    # one batch again: device time of the call and of its repair pass, and
    # the unrepaired form's error on the clustered corpus
    batch = lambda: pairwise_dist_cuda(queries[:256], corpus)
    batch_ms = device_ms(batch, "pairwise_", reps=3)
    repair_ms = device_ms(batch, "pairwise_repair_flagged", reps=3,
                          expect=False)
    raw = pairwise_dist_cuda(queries[:256], corpus, repair=False)
    exact, scale = float64_l2(queries[:256], corpus)
    unrepaired = float(((raw.double() - exact).abs() / scale).max())
    near = float((exact / scale < pairwise_flag_ratio(d)).double().mean())
    del raw, exact, scale
    torch.cuda.empty_cache()
    if unrepaired >= gamma(d):
        raise AssertionError(f"oracle: unrepaired error {unrepaired} of the "
                             f"scale reaches gamma {gamma(d)}")
    got = ex.indices.cpu().numpy()
    rows = corpus[ex.indices.reshape(-1)].to(torch.float64).reshape(Q, k, d)
    theta = ((rows - queries.to(torch.float64)[:, None]) ** 2).sum(-1) / d
    value_rel_err = float(((ex.values.to(torch.float64) - theta).abs()
                           / theta).max())
    disagreements = []
    for i in np.nonzero([set(a) != set(b) for a, b in zip(got.tolist(),
                                                         truth.tolist())])[0]:
        extra = sorted(set(got[i].tolist()) - set(truth[i].tolist()))
        missing = sorted(set(truth[i].tolist()) - set(got[i].tolist()))
        ids = torch.tensor(extra + missing, device=corpus.device)
        dist = ((corpus[ids].to(torch.float64)
                 - queries[i].to(torch.float64)) ** 2).sum(1).tolist()
        far, near = max(dist[:len(extra)]), min(dist[len(extra):])
        disagreements.append({"query": int(i), "extra": extra,
                              "missing": missing,
                              "rel_gap": abs(far - near) / near})
    out = {"phase": "oracle", "queries": Q, "k": k, "oracle_s": oracle_s,
           "set_disagreements": disagreements,
           "max_value_rel_err": value_rel_err, "launches": launches,
           "launches_tensor_cores": launches_tc,
           "flagged_pairs": flagged,
           "pairwise_device_ms_first_batch": batch_ms,
           "repair_device_ms_first_batch": repair_ms,
           "flagged_share_first_batch_float64": near,
           "unrepaired_err_over_scale_first_batch": unrepaired,
           "gamma": gamma(d)}
    if any(x["rel_gap"] > 1e-4 for x in disagreements) or value_rel_err > 1e-4:
        raise AssertionError(f"oracle disagrees with the brute force: {out}")
    return out


def rounds_phase(idx, queries, truth, seed: int) -> dict:
    """``Index.query(mode="rounds")``: the per-round driver on the main
    path's index."""
    import numpy as np
    import torch
    from repro_torch.configs.bmo_nn import DENSE
    from repro_torch.kernels.block_pull import block_pull_multi_cuda
    from repro_torch.kernels.fwht import fwht_cuda

    n, d, k = DENSE.n_points, DENSE.dim, DENSE.bmo.k
    Q = queries.shape[0]
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res, launches = counted(
        "rounds", {"block_pull_multi": block_pull_multi_cuda,
                   "fwht": fwht_cuda},
        lambda: idx.query(queries, seed, mode="rounds", cache="bypass"))
    query_s = time.perf_counter() - t
    return {"phase": "rounds", "queries": Q, "query_s": query_s,
            "qps": Q / query_s,
            **recall_of("rounds", res.indices, res.values, truth, n, k),
            "rounds_run": launches["block_pull_multi"] - 1,
            "rounds_mean": float(np.mean(res.rounds)),
            "coord_ops_share_of_nd": float(np.mean(res.coord_ops)) / (n * d),
            "n_exact_mean": float(np.mean(res.n_exact)),
            "launches": launches,
            "block_pull_multi_by_schedule": {
                "rows": block_pull_multi_cuda.launches_rows,
                "pair": block_pull_multi_cuda.launches_pair},
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def spearman(a, b) -> float:
    """Spearman's rank correlation of two equal-length sequences, tied
    values taking their average rank (the cost model scores candidates
    that differ only in the frontier floor or the buffer count alike)."""
    import numpy as np

    def ranks(v):
        v = np.asarray(v, np.float64)
        order = np.argsort(v, kind="stable")
        r = np.empty(len(v))
        r[order] = np.arange(len(v), dtype=np.float64)
        for x in np.unique(v):
            r[v == x] = r[v == x].mean()
        return r
    if len(a) < 2:
        return float("nan")
    ra, rb = ranks(a), ranks(b)
    if ra.std() == 0 or rb.std() == 0:
        return float("nan")
    return float(np.corrcoef(ra, rb)[0, 1])


def tune_phase(idx, corpus, queries, truth, seed: int) -> dict:
    """``Index.tune()`` on a second handle over the main path's store, with
    the reference's defaults (8 synthetic queries, 2 halving levels, 1 rep):
    the grid, the cost model's scores against the measured medians of the
    raced survivors, the winner against the identity. Then all queries
    under the tuned config (recall ≥ 0.99: tuning never changes what is
    certified) and under the defaults (``use_tuned=False``); the tuned
    query's first epoch (or round) launch replayed on its own inputs
    against the plain pull (rtol 2e-4, atol 1e-5, as in the kernel
    phase); the tuned index saved and loaded (``tuned.json`` applied,
    reason ``ok``), and the sidecar beside an index of another scale
    bucket (reason ``signature``, the build-time config served)."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.api import Index
    from repro_torch.configs.bmo_nn import DENSE
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_pull import block_pull_multi_cuda
    from repro_torch.kernels.fused_race import fused_epoch_pull_cuda
    from repro_torch.kernels.fwht import fwht_cuda
    from repro_torch.tune import TUNED_FILE, cache_clear, load_tuned

    (n, d), k = corpus.shape, DENSE.bmo.k
    Q = queries.shape[0]
    out = {"phase": "tune", "workload": DENSE.name, "queries": Q,
           "tune_queries": 8, "levels": 2, "reps": 1}
    tidx = Index.open(idx.store)
    # the pull of the tuned mode's epoch or round: the op the driver calls,
    # its kernel's wrapper and its plain version
    pulls = {"fused": ("fused_epoch_pull", fused_epoch_pull_cuda,
                       ref.fused_epoch_pull_ref),
             "rounds": ("block_pull_multi", block_pull_multi_cuda,
                        ref.block_pull_multi_ref)}
    epoch = {}          # the tuned query's first such launch, its inputs

    def keeping(pull):
        def kept(x, qs, arm_idx, blk_idx, **kw):
            if not epoch and blk_idx.shape[1] == tidx.cfg.batch_arms:
                epoch.update(qs=qs.clone(), arm=arm_idx.clone(),
                             blk=blk_idx.clone(),
                             kw={a: b for a, b in kw.items() if a != "impl"})
            return pull(x, qs, arm_idx, blk_idx, **kw)
        return kept

    def qps_of(**kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = tidx.query(queries, seed, cache="bypass", **kw)
        return res, Q / (time.perf_counter() - t)

    def run():
        cache_clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        report = tidx.tune(rng=seed)
        torch.cuda.synchronize()
        out["tune_s"] = time.perf_counter() - t
        op = pulls[tidx.tuned.mode][0]
        pull = getattr(kops, op)
        setattr(kops, op, keeping(pull))
        try:
            res, out["qps_tuned"] = qps_of()
        finally:
            setattr(kops, op, pull)
        out["tuned"] = recall_of("tune, tuned config", res.indices,
                                 res.values, truth, n, k)
        res, out["qps_defaults"] = qps_of(use_tuned=False)
        out["defaults"] = recall_of("tune, defaults", res.indices,
                                    res.values, truth, n, k)
        return report

    t0 = time.perf_counter()
    report, launches = counted(
        "tune", {"fused_epoch_pull": fused_epoch_pull_cuda, "fwht": fwht_cuda,
                 "block_pull_multi": block_pull_multi_cuda}, run)
    if report["cached"]:
        raise AssertionError("tune: the race was served from the cache")
    score = {json.dumps(m["cand"], sort_keys=True): m["e"]
             for m in report["model"]}
    raced = [{"cand": m["cand"],
              "model_s_per_element": score[json.dumps(m["cand"],
                                                      sort_keys=True)],
              "median_ms": m["median_ms"], "wall_ms": m["wall_ms"],
              "epoch_ms": m["epoch_ms"], "round_ms": m["round_ms"]}
             for m in report["measurements"]]
    scored = [r for r in raced if r["model_s_per_element"] is not None]
    out.update({
        "grid_size": report["grid_size"], "raced": report["raced"],
        "survivors": raced,
        "spearman_model_vs_measured": spearman(
            [r["model_s_per_element"] for r in scored],
            [r["median_ms"] for r in scored]),
        "spearman_n": len(scored),
        "winner": report["config"],
        "winner_median_ms": report["winner_median_ms"],
        "identity_median_ms": report["default_median_ms"],
        "epoch_ms": report["config"]["epoch_ms"],
        "round_ms": report["config"]["round_ms"],
        "launches": launches,
        "fused_epoch_pull_by_schedule": {
            "rows": fused_epoch_pull_cuda.launches_rows,
            "pair": fused_epoch_pull_cuda.launches_pair}})

    # --- the kernel at the tuned shape: the tuned query's first epoch (or
    # round), its arms and blocks as launched, against the plain pull -------
    name, wrapper, plain = pulls[tidx.tuned.mode]
    if not epoch or epoch["kw"].get("n_buf", tidx.cfg.kernel_buffers) \
            != tidx.cfg.kernel_buffers:
        raise AssertionError(f"tune: no {name} launch of the tuned query at "
                             f"B {tidx.cfg.batch_arms}, n_buf "
                             f"{tidx.cfg.kernel_buffers}")
    x, kw = tidx.store.x, epoch["kw"]
    before = wrapper.launches_pair
    got = wrapper(x, epoch["qs"], epoch["arm"], epoch["blk"], **kw)
    Qe, Be, Te = epoch["blk"].shape
    out["tuned_shape_kernel"] = {
        "kernel": name,
        "shape": {"Q": Qe, "B": Be, "T" if name == "fused_epoch_pull"
                  else "P": Te, "block": kw["block"], "d_pad": x.shape[1],
                  "n": x.shape[0]},
        "n_buf": kw.get("n_buf"), "metric": kw["metric"],
        "schedule": "pair" if wrapper.launches_pair > before else "rows",
        **compare(f"{name} at the tuned shape", got,
                  plain(x, epoch["qs"], epoch["arm"], epoch["blk"],
                        kw["block"], kw["metric"]),
                  rtol=2e-4, atol=1e-5)}
    del got
    epoch.clear()
    torch.cuda.empty_cache()

    # --- the sidecar: saved, loaded and applied; rejected beside a store
    # of another scale bucket -------------------------------------------
    need = sum(a.numel() * a.element_size()
               for a in tidx.store.arrays().values())
    tmp = save_dir(need)
    try:
        path = os.path.join(tmp, "index")
        t = time.perf_counter()
        tidx.save(path)
        out["save_s"] = time.perf_counter() - t
        cache_clear()
        t = time.perf_counter()
        loaded = Index.load(path, device=corpus.device)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t
        _, why = load_tuned(path, loaded.store)
        out["sidecar_reload"] = {"reason": why,
                                 "applied": loaded.tuned == tidx.tuned,
                                 "config_equal": loaded.cfg == tidx.cfg}
        if not (why == "ok" and loaded.tuned == tidx.tuned
                and loaded.cfg == tidx.cfg):
            raise AssertionError(f"tune: sidecar not applied on load: "
                                 f"{out['sidecar_reload']}")
        del loaded
        small_path = os.path.join(tmp, "small")
        Index.build(corpus[:4096], DENSE.bmo, seed).save(small_path)
        shutil.copy(os.path.join(path, TUNED_FILE),
                    os.path.join(small_path, TUNED_FILE))
        small = Index.load(small_path, device=corpus.device)
        _, why = load_tuned(small_path, small.store)
        out["sidecar_drifted"] = {"reason": why,
                                  "applied": small.tuned is not None,
                                  "serves_build_config":
                                      small.cfg == DENSE.bmo}
        if why != "signature" or small.tuned is not None \
                or small.cfg != DENSE.bmo:
            raise AssertionError(f"tune: a drifted sidecar was applied: "
                                 f"{out['sidecar_drifted']}")
        del small
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del tidx
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


class EpochSyncs:
    """Counts ``host_fetch`` calls inside every ``RaceSession.step()`` that
    advanced an epoch, while active: the sessions' one host sync an epoch,
    as ``utils/hostsync.py`` counts it."""

    def __init__(self):
        self.per_epoch = collections.Counter()    # (kind, syncs) -> epochs

    @contextlib.contextmanager
    def watching(self):
        from repro_torch.index import anytime
        from repro_torch.utils import hostsync
        step = anytime.RaceSession.step
        counts = self.per_epoch

        def counted_step(sess):
            before, epochs = hostsync.syncs(), sess.epochs
            out = step(sess)
            if sess.epochs != epochs:
                counts[(sess.kind, hostsync.syncs() - before)] += \
                    sess.epochs - epochs
            return out
        anytime.RaceSession.step = counted_step
        try:
            yield self
        finally:
            anytime.RaceSession.step = step

    def report(self) -> dict:
        return {f"{kind}_epochs_with_{n}_syncs": c
                for (kind, n), c in sorted(self.per_epoch.items())}


def ticket_report(tickets) -> dict:
    """Exits by reason, latency percentiles and epochs per ticket."""
    import numpy as np
    from repro_torch.api.stream import percentile
    lat = [t.latency_ms for t in tickets]
    ep = [t.epochs for t in tickets]
    return {"tickets": len(tickets),
            "exits": dict(collections.Counter(t.reason for t in tickets)),
            "latency_ms_p50": percentile(lat, 50),
            "latency_ms_p95": percentile(lat, 95),
            "latency_ms_p99": percentile(lat, 99),
            "epochs_per_ticket_mean": float(np.mean(ep)),
            "epochs_per_ticket_max": int(np.max(ep)),
            "never_raced": int(sum(e == 0 for e in ep))}


def plane_checks(what: str, pairs, truth_of, n: int, k: int) -> dict:
    """Hold terminal tickets to the truth: no ``rejected:`` shed; the
    certified tickets' top-k sets at recall ≥ 0.99; on every partial
    (deadline, budget) the certified prefix position by position against
    the truth's, at ≥ 0.99 of the certified positions, with CI 0.
    ``pairs`` is [(ticket, its rows)]; ``truth_of(rows)`` the (rows, k)
    true ids in ascending distance."""
    import numpy as np
    bad = [t.reason for t, _ in pairs if not t.terminal
           or t.reason.startswith("rejected")]
    if bad:
        raise AssertionError(f"plane {what}: tickets not terminal or shed "
                             f"by a launch failure: {bad[:4]}")
    out = {}
    cert = [(t, r) for t, r in pairs if t.reason == "certified"]
    if cert:
        idx = np.concatenate([t.result.indices for t, _ in cert])
        vals = np.concatenate([t.result.values for t, _ in cert])
        rows = np.concatenate([r for _, r in cert])
        out["certified"] = recall_of(f"plane {what}, certified", idx, vals,
                                     truth_of(rows), n, k)
        out["certified"]["rows"] = int(len(rows))
        if not all((t.result.certified_count == k).all() for t, _ in cert):
            raise AssertionError(f"plane {what}: a certified ticket with an "
                                 "uncertified position")
    part = [(t, r) for t, r in pairs if t.reason in ("deadline", "budget")]
    positions = agree = ci_nonzero = 0
    for t, rows in part:
        res, truth = t.result, truth_of(rows)
        for j in range(len(rows)):
            cc = int(res.certified_count[j])
            positions += cc
            agree += int((res.indices[j, :cc] == truth[j, :cc]).sum())
            ci_nonzero += int((res.ci_radii[j, :cc] != 0).sum())
    out["partial"] = {"tickets": len(part), "certified_positions": positions,
                      "agree_with_truth": agree,
                      "share": agree / positions if positions else None}
    if ci_nonzero or (positions and agree / positions < 0.99):
        raise AssertionError(f"plane {what}: a certified prefix disagrees "
                             f"with the truth or has CI ≠ 0: {out}")
    return out


def mixed_tickets(plane, qh, seed: int, tenant_of, **extra) -> list:
    """Every query row in tickets of PLANE_ROWS rows: ticket i has a
    Deadline when i % 4 == 1, an EffortBudget when i % 4 == 3, and races
    to certification otherwise; ``tenant_of(i)`` names its tenant. Returns
    [(ticket, its rows)]."""
    import numpy as np
    from repro_torch.api import Deadline, EffortBudget
    pairs = []
    for i in range(qh.shape[0] // PLANE_ROWS):
        rows = np.arange(i * PLANE_ROWS, (i + 1) * PLANE_ROWS)
        kw = ({"deadline": Deadline(ms=PLANE_DEADLINE_MS)} if i % 4 == 1
              else {"budget": EffortBudget(epochs=PLANE_BUDGET_EPOCHS)}
              if i % 4 == 3 else {})
        pairs.append((plane.submit(qh[rows], rng=seed + i,
                                   tenant=tenant_of(i), **kw, **extra),
                      rows))
    return pairs


def by_spec(pairs) -> dict:
    """``ticket_report`` of each kind of ticket ``mixed_tickets`` makes."""
    return {name: ticket_report([t for j, (t, _) in enumerate(pairs)
                                 if j % 4 in m])
            for name, m in (("deadline", (1,)), ("budget", (3,)),
                            ("certify", (0, 2)))}


def audit_report(plane, flush_s: float) -> dict:
    """The plane's δ-audit so far: rows audited, mismatches, the Wilson
    bound, the oracle's ms an item (its ``repro_audit_ms`` histogram)."""
    aud = plane.auditor
    h = aud._h_ms
    return {"sampled_tickets": aud.sampled_tickets,
            "rows_audited": aud.sampled_rows,
            "mismatch_rows": aud.mismatch_rows,
            "err_upper_wilson_95": aud.err_upper(),
            "skipped": dict(aud.skipped), "pending": aud.pending,
            "oracle_items": h.count,
            "oracle_ms_per_item": h.sum / h.count if h.count else None,
            "flush_s": flush_s}


def timed_offers(plane) -> list:
    """Wrap the plane's ``auditor.offer`` so each call's µs is kept (the
    serving path's share of the audit). Returns the list it fills."""
    spent, offer = [], plane.auditor.offer

    def timed(**kw):
        t = time.perf_counter()
        try:
            return offer(**kw)
        finally:
            spent.append((time.perf_counter() - t) * 1e6)
    plane.auditor.offer = timed
    return spent


def audit_oracle_check(store, corpus, qh, truth, rows, served,
                       k: int) -> dict:
    """The plane's δ-audit oracle on one audited ticket, after the plane's
    run (these launches are not counted): ``exact_topk`` of its rows at
    the audit's shape (one tensor-core ``pairwise_dist`` of the ticket's
    prepared queries against the whole capacity at d_pad), held three
    ways. Its θ against the float64 brute force of the same ids in the
    original space; the θ of its top-k, sorted, against those of the
    brute force's top-k (so its ids are the exact top-k up to near-ties);
    and that launch against the plain ``pairwise_dist`` and against
    float64 over the first AUDIT_CHECK_ROWS rows at full d_pad. Then
    ``check_topk`` of the served ids passes them, with the same exact
    ids. ℓ2 tolerance as in the kernel phase: 1e-4 relatively, plus 1e-6
    of ‖q‖² + ‖x‖² against the plain version (fp32 sums of 16,384
    terms)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda
    from repro_torch.kernels.pairwise_dist import variant as pairwise_variant
    from repro_torch.obs.audit import check_topk, exact_topk

    q = qh[rows]
    d = store.d
    t = time.perf_counter()
    ids, vals = exact_topk(store, q, k)
    out = {"rows": len(rows), "exact_topk_ms": (time.perf_counter() - t) * 1e3}
    if not ((ids >= 0) & (ids < corpus.shape[0])).all():
        raise AssertionError("audit oracle: an id that is not a live row")

    def theta64(id_rows):
        qt = torch.from_numpy(q).cuda().double()
        x = corpus[torch.from_numpy(id_rows).cuda()].double()
        diff = ((x - qt[:, None]) ** 2).sum(-1) / d
        scale = ((x * x).sum(-1) + (qt * qt).sum(-1)[:, None]) / d
        return diff, scale
    got64, scale = theta64(ids)
    out["theta_vs_float64"] = compare(
        "audit oracle θ against float64", torch.from_numpy(vals).cuda(),
        got64, rtol=1e-4, atol=0.0, allowance=1e-6 * scale)
    want64, scale_t = theta64(np.ascontiguousarray(truth[rows]))
    out["topk_theta_vs_truth"] = compare(
        "audit oracle top-k θ against the float64 top-k",
        torch.sort(got64, 1).values, torch.sort(want64, 1).values,
        rtol=1e-4, atol=0.0, allowance=1e-6 * scale_t)
    out["ids_equal_to_truth_share"] = float(np.mean(
        [len(set(a) & set(b)) / k for a, b in zip(ids.tolist(),
                                                  truth[rows].tolist())]))

    qs = store.prepare_queries(q)
    x = store.x
    launches = pairwise_dist_cuda.launches_tc
    full = pairwise_dist_cuda(qs, x, metric="l2")
    which = pairwise_variant("l2", qs.shape[0], x.shape[1])
    if which != "tensor_cores" or pairwise_dist_cuda.launches_tc != launches + 1:
        raise AssertionError("audit oracle: pairwise_dist not on the tensor "
                             "cores at the audit's shape")
    sub = slice(0, AUDIT_CHECK_ROWS)
    got = full[:, sub]
    del full
    want64, scale64 = float64_l2(qs, x[sub])
    out["pairwise_dist"] = {
        "variant": which,
        "shape": {"Q": int(qs.shape[0]), "n": int(x.shape[0]),
                  "d": int(x.shape[1])},
        "plain_checked_on_rows": AUDIT_CHECK_ROWS,
        **compare("pairwise_dist at the audit's shape", got,
                  ref.pairwise_dist_ref(qs, x[sub], "l2"), rtol=1e-4,
                  atol=0.0, allowance=1e-6 * scale64),
        "max_rel_err_float64": compare(
            "pairwise_dist at the audit's shape against float64",
            got.double(), want64, rtol=1e-4, atol=0.0)["max_rel_err"],
        "ms": cuda_ms(lambda: pairwise_dist_cuda(qs, x, metric="l2"),
                      reps=5)}
    del got, want64, scale64
    chk = check_topk(store, q, served, k)
    if chk.mismatches or not np.array_equal(chk.exact_ids, ids):
        raise AssertionError(f"audit oracle: check_topk flags "
                             f"{chk.mismatches} served rows or disagrees "
                             "with exact_topk")
    out["check_topk_mismatches"] = chk.mismatches
    torch.cuda.empty_cache()
    return out


def plane_phase(idx, corpus, queries, truth, main_res, seed: int) -> dict:
    """The request plane over a second handle on the main path's store
    (``Index.open``, so its inserts leave the main index as it is), with
    ``PlaneConfig``'s defaults (max_queue 64, max_group_queries 64,
    max_active_groups 4) and the shadow δ-audit on every ticket
    (``audit_rate=1.0``; the oracle runs only in ``audit_flush``). Passes:
    mixed tickets (every query, in tickets of PLANE_ROWS rows round-robin
    over PLANE_TENANTS tenants: a quarter with a Deadline (tenant t1's), a
    quarter with an EffortBudget (t3's), half raced to certification; one
    scheduler step traced), then the audit of its certified tickets; exact
    repeats (rows of certified tickets, served at submit); near repeats
    (PLANE_NOISE relative noise, seeded priors, against the same rows with
    the cache bypassed); the mutation fence (PLANE_FENCE_ROWS rows, two
    epochs, an insert of PLANE_FENCE_INSERTS near-copies, drained once
    under ``on_mutation="complete"`` and once under ``"readmit"``). Then,
    on a handle with the tune phase's winner (``Index.tune()``, served
    from the in-process cache): the same mixed tickets with the deadline
    tickets spread over all tenants, raced with the tuned ``round_ms``
    and with ``use_tuned=False``; two injected failures (a duplicated
    served id; a far live id, caught by θ alone) caught, bundled and
    reproduced by ``tools/torch_replay_audit.py``'s ``replay_one``; the
    recall SLO on a held clock and the recall guard's fallback → retune
    chain, lifted by ``tune(force=True)``. Every ticket is held by
    ``plane_checks``; every session epoch makes one host sync. After the
    counted run, ``audit_oracle_check`` on one audited ticket."""
    import dataclasses
    import importlib.util
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.api import Index
    from repro_torch.api.cache import QueryCache
    from repro_torch.configs.bmo_nn import DENSE
    from repro_torch.kernels.fused_race import fused_epoch_pull_cuda
    from repro_torch.kernels.fwht import fwht_cuda
    from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda
    from repro_torch.obs import (ObsContext, SLOEngine, default_slos,
                                 plane_sources)
    from repro_torch.obs.health import health_snapshot
    from repro_torch.serve import (PlaneConfig, RecallGuardPolicy,
                                   RequestPlane, apply_guard)

    (n, d), k = corpus.shape, DENSE.bmo.k
    Q = queries.shape[0]
    qh = queries.cpu().numpy()
    syncs = EpochSyncs()
    out = {"phase": "plane", "workload": DENSE.name, "queries": Q,
           "rows_per_ticket": PLANE_ROWS, "tenants": PLANE_TENANTS,
           "deadline_ms": PLANE_DEADLINE_MS,
           "budget_epochs": PLANE_BUDGET_EPOCHS,
           "config": dataclasses.asdict(PlaneConfig(audit_rate=1.0))}
    by_truth = lambda rows: truth[rows]
    audited = {}        # one audited ticket: its rows and served ids

    def run():
        pidx = Index.open(idx.store, payload=np.arange(n))
        plane = RequestPlane(pidx, PlaneConfig(audit_rate=1.0))
        offer_us = timed_offers(plane)
        # --- mixed tickets ------------------------------------------------
        pairs = mixed_tickets(plane, qh, seed,
                              lambda i: f"t{i % PLANE_TENANTS}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = 0
        while plane.active:
            if steps == 8:      # four groups racing: trace one step
                wall, rows_ = profiled(plane.step)
                busy = sum(r["device_ms"] for r in rows_)
                out["traced_step"] = {
                    "wall_ms": wall, "device_busy_ms": busy,
                    "device_idle_share": max(0.0, 1.0 - busy / wall),
                    "groups": len(plane._groups), "top": rows_[:8]}
            else:
                plane.step()
            steps += 1
        wall = time.perf_counter() - t0
        tickets = [t for t, _ in pairs]
        cert_rows = np.concatenate([r for t, r in pairs
                                    if t.reason == "certified"])
        cert_ops = np.concatenate([t.result.coord_ops for t, _ in pairs
                                   if t.reason == "certified"])
        out["mixed"] = {
            "wall_s": wall, "rows_per_s": Q / wall, "steps": steps,
            **ticket_report(tickets), "by_spec": by_spec(pairs),
            **plane_checks("mixed", pairs, by_truth, n, k),
            "coord_ops_per_certified_row": float(np.mean(cert_ops)),
            "index_query_coord_ops_same_rows": float(
                np.mean(main_res.coord_ops[cert_rows])),
            "stats": {f: getattr(plane.stats, f) for f in (
                "races", "raced_queries", "cache_hits", "cache_misses",
                "near_hits", "plane_epochs", "plane_shed",
                "plane_deadline_exits", "plane_budget_exits")}}
        # --- the δ-audit of the certified tickets, off the serving path --
        if plane.auditor._h_ms.count:
            raise AssertionError("plane: the audit oracle ran while serving")
        t0 = time.perf_counter()
        plane.audit_flush()
        out["audit"] = {**audit_report(plane, time.perf_counter() - t0),
                        "offers": len(offer_us),
                        "offer_us_mean": float(np.mean(offer_us)),
                        "offer_us_max": float(np.max(offer_us))}
        if out["audit"]["rows_audited"] != len(cert_rows):
            raise AssertionError(f"plane audit: {out['audit']['rows_audited']}"
                                 f" rows audited of {len(cert_rows)} "
                                 "certified")
        ticket, rows = next((t, r) for t, r in pairs
                            if t.reason == "certified")
        audited.update(rows=rows, served=ticket.result.indices.copy())

        # --- exact repeats: rows of certified tickets still in the LRU ----
        cached = [r for r in cert_rows.tolist()
                  if QueryCache.key(qh[r]) in pidx._cache._od]
        rep = np.array(cached[:PLANE_REPEATS])
        if len(rep) < PLANE_REPEATS:
            raise AssertionError(f"plane repeats: only {len(rep)} certified "
                                 "rows left in the query cache")
        before = pidx.stats.cache_hits
        t0 = time.perf_counter()
        rpairs = [(plane.submit(qh[rep[s:s + PLANE_ROWS]], rng=seed),
                   rep[s:s + PLANE_ROWS])
                  for s in range(0, len(rep), PLANE_ROWS)]
        rep_s = time.perf_counter() - t0
        first = {int(r): t.result.indices[j] for t, rows in pairs
                 if t.reason == "certified" for j, r in enumerate(rows)}
        same = all(np.array_equal(t.result.indices[j], first[int(r)])
                   for t, rows in rpairs for j, r in enumerate(rows))
        ops = float(sum(np.sum(t.result.coord_ops) for t, _ in rpairs))
        if not (all(t.terminal and t.reason == "certified"
                    and t.epochs == 0 for t, _ in rpairs)
                and ops == 0.0 and same):
            raise AssertionError("plane repeats: not served at submit at "
                                 "zero cost with the first answers")
        out["repeats"] = {"rows": len(rep), "submit_s": rep_s,
                          "cache_hits": pidx.stats.cache_hits - before,
                          "coord_ops": ops, "same_answers": same}

        # --- near repeats: seeded priors against the cache bypassed -------
        near_rows = rep[:PLANE_NEAR]
        g = np.random.default_rng(seed)
        base = qh[near_rows]
        noisy = (base + PLANE_NOISE * np.abs(base).mean(1, keepdims=True)
                 * g.standard_normal(base.shape)).astype(np.float32)
        near_truth = brute_force_topk(
            corpus, torch.from_numpy(noisy).cuda(), k)
        by_near = lambda rows: near_truth[rows]
        near_out = {}
        for mode in ("use", "bypass"):
            hits0 = pidx.stats.near_hits
            npairs = [(plane.submit(noisy[s:s + PLANE_ROWS], rng=seed,
                                    cache=mode),
                       np.arange(s, s + PLANE_ROWS))
                      for s in range(0, PLANE_NEAR, PLANE_ROWS)]
            plane.drain()
            near_out[mode] = {
                "near_hits": pidx.stats.near_hits - hits0,
                "coord_ops_per_row": float(np.mean(np.concatenate(
                    [t.result.coord_ops for t, _ in npairs]))),
                **ticket_report([t for t, _ in npairs]),
                **plane_checks(f"near repeats, cache={mode}", npairs,
                               by_near, n, k)}
        out["near"] = near_out
        t0 = time.perf_counter()
        plane.audit_flush()
        out["audit_all"] = audit_report(plane, time.perf_counter() - t0)
        del plane, pidx
        torch.cuda.empty_cache()

        # --- mutation fence ----------------------------------------------
        fence_rows = np.arange(PLANE_FENCE_ROWS)
        copies = (np.repeat(qh[fence_rows], PLANE_FENCE_INSERTS
                            // PLANE_FENCE_ROWS, 0)
                  + PLANE_NOISE * g.standard_normal(
                      (PLANE_FENCE_INSERTS, d)).astype(np.float32))
        rows_of_all = torch.cat([corpus, torch.from_numpy(copies).cuda()])
        fence = {}
        for policy in ("complete", "readmit"):
            fidx = Index.open(idx.store, payload=np.arange(n))
            epoch0 = fidx.epoch
            plane = RequestPlane(fidx, PlaneConfig(on_mutation=policy))
            fpairs = [(plane.submit(qh[fence_rows[s:s + PLANE_ROWS]],
                                    rng=seed, cache="bypass"),
                       fence_rows[s:s + PLANE_ROWS])
                      for s in range(0, PLANE_FENCE_ROWS, PLANE_ROWS)]
            plane.step()
            plane.step()
            fidx.insert(copies, payload=n + np.arange(len(copies)))
            plane.drain()
            live = live_truth(fidx, rows_of_all, queries[fence_rows], k)
            want_epoch = epoch0 if policy == "complete" else fidx.epoch
            truth_now = (truth[fence_rows] if policy == "complete" else live)
            if any(t.result.epoch != want_epoch for t, _ in fpairs):
                raise AssertionError(f"plane fence {policy}: a result carries "
                                     "the wrong store epoch")
            fence[policy] = {
                "store_epoch": want_epoch,
                "readmitted": plane.stats.plane_readmitted,
                "new_copies_first": int(sum(
                    (fidx.payload[t.result.indices[:, 0]] >= n).sum()
                    for t, _ in fpairs)),
                **ticket_report([t for t, _ in fpairs]),
                **plane_checks(f"fence {policy}", fpairs,
                               lambda rows: truth_now[rows], fidx.capacity,
                               k)}
            del plane, fidx
            torch.cuda.empty_cache()
        out["fence"] = fence

        # --- the tuned handle: the tune phase's winner, from the cache ----
        tpidx = Index.open(idx.store, payload=np.arange(n))
        got = tpidx.tune(rng=seed)
        if not got["cached"]:
            raise AssertionError("plane: the tune phase's winner was not "
                                 "served from the in-process cache")
        out["tuned"] = {"config": got["config"], "store_epoch": tpidx.epoch}

        # --- the deadline tickets spread over every tenant, raced with the
        # tuned round cost and without the tuning -------------------------
        spread = {}
        for name, extra in (("tuned", {}), ("untuned",
                                            {"use_tuned": False})):
            plane = RequestPlane(tpidx)
            spairs = mixed_tickets(
                plane, qh, seed, lambda i: f"t{(i + i // 4) % PLANE_TENANTS}",
                cache="bypass", **extra)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plane.drain()
            wall = time.perf_counter() - t0
            dl = [(t, r) for j, (t, r) in enumerate(spairs) if j % 4 == 1]
            spread[name] = {
                "wall_s": wall, "rows_per_s": Q / wall,
                "deadline_tenants": sorted({t.tenant for t, _ in dl}),
                "by_spec": by_spec(spairs),
                "deadline_certified_positions": int(sum(
                    int(t.result.certified_count.sum()) for t, _ in dl)),
                **plane_checks(f"spread deadlines, {name}", spairs,
                               by_truth, n, k)}
            del plane
        out["deadline_spread"] = spread

        # --- an injected failure: caught, bundled, replayed ---------------
        tmp = tempfile.mkdtemp(prefix="chip_smoke_audit_")
        try:
            obs = ObsContext("audit", enabled=True)
            plane = RequestPlane(tpidx, PlaneConfig(
                audit_rate=1.0, audit_dir=os.path.join(tmp, "bundles")),
                obs=obs)
            clock = {"t": 0.0}
            eng = SLOEngine(default_slos(DENSE.bmo.delta), obs=obs,
                            clock=lambda: clock["t"])
            good = plane.submit(qh[:PLANE_ROWS], rng=seed, cache="bypass")
            plane.drain()
            plane.audit_flush()
            eng.observe(plane_sources(plane))
            real_build = plane._build_result

            def corrupting(corrupt):
                def corrupted(entry, terminal, reason):
                    res = real_build(entry, terminal, reason)
                    if terminal and reason == "certified":
                        corrupt(res.indices[0])
                        plane._build_result = real_build  # one ticket only
                    return res
                return corrupted

            def duplicate(ids):     # caught by the duplicate rule alone
                ids[0] = ids[1]

            # the row farthest from the second ticket's first query among
            # the first 1,024: a live id far outside its true top-k
            far_id = int(torch.argmax(((corpus[:1024].double() - queries[
                2 * PLANE_ROWS].double()) ** 2).sum(1)))

            def far(ids):           # no duplicate: only the θ comparison
                ids[k - 1] = far_id     # can catch it
                swapped.append(ids.copy())
            swapped = []
            bads = []
            for i, corrupt in enumerate((duplicate, far)):
                plane._build_result = corrupting(corrupt)
                rows = np.arange((i + 1) * PLANE_ROWS, (i + 2) * PLANE_ROWS)
                bads.append(plane.submit(qh[rows], rng=seed + 1 + i,
                                         cache="bypass"))
                plane.drain()
            plane.audit_flush()
            summ = plane.auditor.summary()
            if (summ["mismatch_rows"] != 2 or len(summ["bundles"]) != 2
                    or len(np.unique(swapped[0])) != k):
                raise AssertionError(f"plane: the injected failures were not "
                                     f"each caught once: {summ}")
            spec = importlib.util.spec_from_file_location(
                "torch_replay_audit",
                os.path.join(ROOT, "tools", "torch_replay_audit.py"))
            tool = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(tool)
            reps = [tool.replay_one(tpidx, b) for b in summ["bundles"]]
            if not (all(r["reproduced"] and r["epoch_match"] for r in reps)
                    and {r["trace_id"] for r in reps}
                    == {b.trace_id for b in bads}
                    and good.trace_id not in {r["trace_id"] for r in reps}):
                raise AssertionError(f"plane: the bundles did not replay: "
                                     f"{reps}")
            # the recall SLO on the held clock, then the guard's chain
            clock["t"] = 1.0
            fired = eng.observe(plane_sources(plane))
            guard = RecallGuardPolicy(eng.sink)
            chain = []
            for _ in range(3):
                decision = guard.recommend(tpidx.stats)
                chain.append(decision.action)
                apply_guard(tpidx, decision)
            flags = (tpidx.serving_fallback, tpidx.retune_requested)
            health_ok = health_snapshot(plane=plane, slo=eng)["ok"]
            t0 = time.perf_counter()
            tpidx.tune(rng=seed, force=True, levels=1, max_candidates=1)
            retune_s = time.perf_counter() - t0
            lifted = (tpidx.serving_fallback, tpidx.retune_requested)
            if (chain != ["fallback_untuned", "retune", "none"]
                    or flags != (True, True) or lifted != (False, False)
                    or not fired):
                raise AssertionError(f"plane: SLO/guard chain {chain}, "
                                     f"flags {flags} -> {lifted}")
            out["injected"] = {
                "failures": ["a duplicated served id",
                             "a live id outside the true top-k"],
                "rows_audited": summ["sampled_rows"],
                "mismatch_rows": summ["mismatch_rows"],
                "contract": summ["keys"][0]["contract"],
                "replay": [{key: rep[key] for key in (
                    "verdict", "reproduced", "epoch_match",
                    "mismatch_rows_recorded", "mismatch_rows_now")}
                    for rep in reps],
                "slo_fired": [(a.slo, a.rule, a.severity, a.burn_long)
                              for a in fired],
                "guard_chain": chain, "health_ok_while_burning": health_ok,
                "retune_s": retune_s, "flags_after_retune": list(lifted)}
            del plane
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        del tpidx
        torch.cuda.empty_cache()
        return out

    t0 = time.perf_counter()
    with syncs.watching():
        _, launches = counted("plane", {"fused_epoch_pull":
                                        fused_epoch_pull_cuda,
                                        "fwht": fwht_cuda,
                                        "pairwise_dist": pairwise_dist_cuda},
                              run)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = launches
    out["fused_epoch_pull_by_schedule"] = {
        "rows": fused_epoch_pull_cuda.launches_rows,
        "pair": fused_epoch_pull_cuda.launches_pair}
    out["audit_oracle"] = audit_oracle_check(idx.store, corpus, qh, truth,
                                             audited["rows"],
                                             audited["served"], k)
    out["host_syncs"] = syncs.report()
    bad = {key: c for key, c in syncs.per_epoch.items() if key[1] != 1}
    if bad:
        raise AssertionError(f"plane: session epochs with other than one "
                             f"host sync: {bad}")
    return out


def live_truth(idx, rows_of, queries, k: int):
    """Exact top-k slots of ``idx``'s live slots, by a float64 brute force
    over the rows they hold in the original space: slot s holds row
    ``rows_of[idx.payload[s]]`` (``rows_of`` a tensor, or a tuple of
    tensors read as their concatenation)."""
    import numpy as np
    import torch
    parts = rows_of if isinstance(rows_of, tuple) else (rows_of,)
    live = np.nonzero(idx.store.alive.cpu().numpy())[0]
    origin = torch.from_numpy(idx.payload[live]).to(parts[0].device)
    return live[brute_force_topk(parts, queries, k, rows=origin)]


def mutation_checks(what: str, idx, res, rows_of, queries, n: int) -> dict:
    """A query over the mutated index: recall against ``live_truth``, no
    dead slot returned, queries TWINS_DELETED…TWINS−1 find their twin (the
    inserted row n + i) first, and queries 0…TWINS_DELETED−1 never see
    their deleted twin."""
    import numpy as np
    k = idx.k
    truth = live_truth(idx, rows_of, queries, k)
    out = recall_of(what, res.indices, res.values, truth, idx.capacity, k)
    alive = idx.store.alive.cpu().numpy()
    origin = idx.payload[res.indices]                      # (Q, k)
    out["dead_slot_hits"] = int((~alive[res.indices]).sum())
    kept = np.arange(TWINS_DELETED, TWINS)
    out["twins_found_first"] = int((origin[kept, 0] == n + kept).sum())
    gone = np.arange(TWINS_DELETED)
    out["deleted_twins_returned"] = int(
        (origin[gone] == (n + gone)[:, None]).any(1).sum())
    if (out["dead_slot_hits"] or out["deleted_twins_returned"]
            or out["twins_found_first"] != len(kept)):
        raise AssertionError(f"{what}: {out}")
    return out


def save_dir(need: int, copies: int = 2) -> str:
    """A fresh ``tempfile.mkdtemp()`` directory on a file system with room
    for ``need`` bytes ``copies`` times: the default temporary directory,
    else one in the checkout's ``build/``."""
    import shutil
    import tempfile
    for parent in (None, os.path.join(ROOT, "build")):
        if parent is not None:
            os.makedirs(parent, exist_ok=True)
        path = tempfile.mkdtemp(prefix="chip_smoke_index_", dir=parent)
        if shutil.disk_usage(path).free >= copies * need:
            return path
        os.rmdir(path)
    raise RuntimeError(f"no file system with {copies * need} bytes free for "
                       "an index's files")


def mutation_phase(idx, main_res, corpus, queries, truth, seed: int) -> dict:
    """The main path's index through the handle's mutable surface, as a
    user calls it: ``save`` (with a payload: each slot's origin, the corpus
    row or n + j for inserted row j) → ``Index.load`` (every array bit for
    bit, the query equal to the main path's) → ``insert`` of MUTATION_ROWS
    rows (TWINS near-copies of the first queries, then fresh rows) →
    ``delete`` of MUTATION_DELETES slots (the twins of the first
    TWINS_DELETED queries, the true top-k of the queries from TWINS on,
    random other live slots) → ``query`` → ``maybe_compact`` → ``query``."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.api import Index
    from repro_torch.configs.bmo_nn import DENSE
    from repro_torch.core.datasets import next_pow2
    from repro_torch.data.synthetic import make_knn_benchmark_data
    from repro_torch.kernels.fused_race import fused_epoch_pull_cuda
    from repro_torch.kernels.fwht import fwht_cuda

    (n, d), Q = corpus.shape, queries.shape[0]
    times, out = {}, {"phase": "mutation", "workload": DENSE.name,
                      "queries": Q, "seed": seed}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        return result

    origin = np.full(idx.capacity, -1, np.int64)
    origin[:n] = np.arange(n)
    idx.attach_payload(origin)
    dev = corpus.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    twins = queries[:TWINS] + 1e-3 * torch.randn((TWINS, d), generator=g,
                                                 device=dev)
    fresh, _ = make_knn_benchmark_data("dense", MUTATION_ROWS - TWINS, d, 0,
                                       seed=seed + 1, device=dev)
    inserted = torch.cat([twins, fresh])
    rows_of = torch.cat([corpus, inserted])       # payload value → its row
    del twins, fresh
    need = sum(a.numel() * a.element_size()
               for a in idx.store.arrays().values()) + origin.nbytes
    tmp = save_dir(need)
    out["save_dir_free_bytes_before"] = shutil.disk_usage(tmp).free
    torch.cuda.reset_peak_memory_stats()

    def mutation_query(what, loaded, traced=False):
        """The timed query of the mutated index, its checks, what its race
        cost (epochs: pull launches after the init; rounds; exact
        evaluations; coordinates read against the live slots' n·d), and,
        if ``traced``, the same query once more under the profiler."""
        before = fused_epoch_pull_cuda.launches
        res = timed(f"query_{what}_s", lambda: loaded.query(queries, seed))
        return {**mutation_checks(f"mutation, {what}", loaded, res, rows_of,
                                  queries, n),
                "epochs": fused_epoch_pull_cuda.launches - before - 1,
                "rounds_mean": float(np.mean(res.rounds)),
                "n_exact_mean": float(np.mean(res.n_exact)),
                "coord_ops_share_of_live_nd": float(np.mean(res.coord_ops))
                / (loaded.n_live * d),
                **({"traced": traced_query(loaded, queries, seed)}
                   if traced else {})}

    def run():
        path = os.path.join(tmp, "index")
        timed("save_s", lambda: idx.save(path))
        out["bytes_written"] = sum(os.path.getsize(os.path.join(path, f))
                                   for f in os.listdir(path))
        loaded = timed("load_s", lambda: Index.load(path, device=dev))
        saved = idx.store.arrays()
        got = loaded.store.arrays()
        if sorted(got) != sorted(saved) or any(
                got[k].dtype != a.dtype or not torch.equal(got[k], a)
                for k, a in saved.items()):
            raise AssertionError("mutation: the loaded arrays differ from "
                                 "the saved ones")
        if (loaded.store.meta() != idx.store.meta()
                or not np.array_equal(loaded.payload, origin)):
            raise AssertionError("mutation: the loaded metadata or payload "
                                 "differs from the saved one")
        out["loaded_arrays_bit_equal"] = sorted(saved)
        shutil.rmtree(path)
        res = timed("query_loaded_s", lambda: loaded.query(queries, seed))
        if not (np.array_equal(res.indices, main_res.indices)
                and np.array_equal(res.values, main_res.values)):
            raise AssertionError("mutation: the loaded index's query differs "
                                 "from the main path's")
        out["query_loaded_equals_main"] = True

        fwht0 = fwht_cuda.launches
        slots = timed("insert_s", lambda: loaded.insert(
            inserted, payload=n + np.arange(MUTATION_ROWS)))
        out["insert_fwht_launches"] = fwht_cuda.launches - fwht0
        out["capacity_after_insert"] = loaded.capacity
        if out["insert_fwht_launches"] != 1:
            raise AssertionError(f"mutation: the insert launched fwht "
                                 f"{out['insert_fwht_launches']} times")
        r = np.random.default_rng(seed)
        dead = set(slots[:TWINS_DELETED].tolist()) | set(
            truth[TWINS:].ravel().tolist())
        others = np.setdiff1d(np.nonzero(loaded.store.alive.cpu().numpy())[0],
                              np.concatenate([slots[:TWINS],
                                              np.fromiter(dead, np.int64)]))
        dead |= set(r.choice(others, MUTATION_DELETES - len(dead),
                             replace=False).tolist())
        dead = np.array(sorted(dead), np.int64)
        timed("delete_s", lambda: loaded.delete(dead))
        out["n_live_after_delete"] = loaded.n_live
        out["tombstone_fraction"] = 1.0 - loaded.n_live / loaded.capacity
        out["after_delete"] = mutation_query("after_delete", loaded)

        before, payload_before = loaded.store, loaded.payload
        old_ids = timed("compact_s", loaded.maybe_compact)
        if old_ids is None:
            raise AssertionError("mutation: maybe_compact did not compact")
        after, m = loaded.store, loaded.n_live
        keep = torch.from_numpy(old_ids[:m]).to(dev)
        if not ((old_ids[:m] >= 0).all() and (old_ids[m:] == -1).all()
                and np.array_equal(loaded.payload[:m],
                                   payload_before[old_ids[:m]])
                and torch.equal(after.x[:m], before.x[keep])
                and torch.equal(after.prior_var[:m], before.prior_var[keep])
                and bool(before.alive[keep].all())):
            raise AssertionError("mutation: the compaction's old_ids, "
                                 "payload and rows disagree")
        del before, keep
        out["capacity_compacted"] = loaded.capacity
        out["after_compact"] = mutation_query("after_compact", loaded,
                                              traced=True)
        return loaded

    try:
        loaded, launches = counted(
            "mutation", {"fused_epoch_pull": fused_epoch_pull_cuda,
                         "fwht": fwht_cuda}, run)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    by_schedule = {"rows": fused_epoch_pull_cuda.launches_rows,
                   "pair": fused_epoch_pull_cuda.launches_pair}
    if by_schedule["rows"] != 4:       # 3 queries, 1 of them traced again
        raise AssertionError(f"mutation: {by_schedule['rows']} of the four "
                             "queries' inits took the rows schedule")
    want_cap = next_pow2(n + MUTATION_ROWS - MUTATION_DELETES)  # 65,536
    if out["capacity_compacted"] != want_cap:
        raise AssertionError(f"mutation: compacted to capacity "
                             f"{out['capacity_compacted']}, not {want_cap}")
    out.update(times, qps_after_delete=Q / times["query_after_delete_s"],
               qps_after_compact=Q / times["query_after_compact_s"],
               launches=launches, fused_epoch_pull_by_schedule=by_schedule,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del loaded
    return out


def paper_phase(corpus, queries, truth, seed: int) -> dict:
    """``core.bmo_nn.knn``: the paper's Algorithm 2, one race per query,
    with the rotation of corpus and queries done in the call."""
    import numpy as np
    import torch
    from repro_torch.configs.bmo_nn import DENSE
    from repro_torch.core.bmo_nn import knn
    from repro_torch.kernels.block_pull import block_pull_cuda
    from repro_torch.kernels.fwht import fwht_cuda
    from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda

    (n, d), k = corpus.shape, DENSE.bmo.k
    Q = queries.shape[0]

    def run():
        res = knn(corpus, queries, DENSE.bmo, seed)
        torch.cuda.synchronize()
        return res

    t = time.perf_counter()
    res, launches = counted(
        "paper", {"block_pull": block_pull_cuda,
                  "pairwise_dist": pairwise_dist_cuda, "fwht": fwht_cuda},
        run)
    seconds = time.perf_counter() - t
    return {"phase": "paper", "queries": Q, "seconds": seconds,
            "seconds_per_query": seconds / Q,
            **recall_of("paper", res.indices.cpu().numpy(),
                        res.values.cpu().numpy(), truth, n, k),
            "rounds_mean": float(res.rounds.float().mean()),
            "coord_ops_share_of_nd": float(res.coord_ops.mean()) / (n * d),
            "n_exact_mean": float(res.n_exact.float().mean()),
            "launches": launches}


def fleet_store_bytes(store) -> int:
    """Device bytes of a (single-shard or sharded) store's arrays."""
    shards = store.shards if hasattr(store, "shards") else [store]
    return sum(a.numel() * a.element_size()
               for s in shards for a in s.arrays().values())


def recording_shapes(seen: dict):
    """A context that wraps the three ops of the fleet path
    (``kernels.ops``) to keep, for each kernel and kind of launch, the
    widest operand shape it was given: ``fused_epoch_pull`` by (store
    capacity, schedule, shared arms) → (Q, B, T), ``fwht`` by corpus or
    query rows → (rows, d), ``pairwise_dist`` by variant → (Q, n, d).
    Shapes only: no tensor is kept."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.fused_race import N_BUF
    from repro_torch.kernels.pairwise_dist import variant
    from repro_torch.kernels.pull_schedule import fused_schedule, shares_arms
    real = {n: getattr(kops, n)
            for n in ("fused_epoch_pull", "fwht", "pairwise_dist")}

    def widest(kernel, key, shape):
        if shape > seen.get((kernel, key), ()):
            seen[(kernel, key)] = shape

    def pull(x, qs, arm_idx, blk_idx, **kw):
        Q, B, T = blk_idx.shape
        shared = shares_arms(arm_idx)
        sched = fused_schedule(Q, B, T, x.shape[1], kw["block"],
                               kw.get("n_buf", N_BUF), shared).name
        widest("fused_epoch_pull", (x.shape[0], sched, shared), (Q, B, T))
        return real["fused_epoch_pull"](x, qs, arm_idx, blk_idx, **kw)

    def transform(x, **kw):
        rows = x.numel() // x.shape[-1]
        widest("fwht", "corpus" if rows > FLEET_POOL else "queries",
               (rows, x.shape[-1]))
        return real["fwht"](x, **kw)

    def dist(qs, x, **kw):
        widest("pairwise_dist",
               variant(kw.get("metric", "l2"), qs.shape[0], qs.shape[1]),
               (qs.shape[0], x.shape[0], qs.shape[1]))
        return real["pairwise_dist"](qs, x, **kw)

    @contextlib.contextmanager
    def ctx():
        kops.fused_epoch_pull, kops.fwht, kops.pairwise_dist = pull, \
            transform, dist
        try:
            yield
        finally:
            for n, fn in real.items():
                setattr(kops, n, fn)
    return ctx()


def fleet_kernel_rows(stores: dict, seen: dict, seed: int) -> list:
    """Each kernel of the fleet path launched once more, outside the
    counted run, at the widest operands that run gave it (``seen``), on a
    namespace's store or shard of that capacity (``stores``: capacity →
    (store, the namespace's query pool)): random live arms (one shared
    vector where the run's were) and blocks for ``fused_epoch_pull``, the
    pool's queries in the store's layout for it and ``pairwise_dist`` (over
    the first n rows), normal rows for ``fwht``. Each held against its
    plain version at the kernel phase's tolerance: pulls at rtol 2e-4 /
    atol 1e-5, the fp32 transform at 1e-5, ℓ2 distances at 1e-4·|want| +
    1e-6·(‖q‖² + ‖x‖²)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_race import fused_epoch_pull_cuda
    from repro_torch.kernels.fwht import fwht_cuda
    from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rows = []
    for (kernel, key), shape in sorted(seen.items(), key=str):
        if kernel == "fwht":
            x = torch.randn(shape, generator=g, device="cuda")
            row = {"case": f"fleet_{key}",
                   "shape": {"rows": shape[0], "d": shape[1]},
                   **compare(f"fwht fleet {key}", fwht_cuda(x),
                             ref.fwht_ref(x), rtol=1e-5, atol=1e-5)}
        elif kernel == "fused_epoch_pull":
            (cap, sched, shared), (Q, B, T) = key, shape
            st, pool = stores[cap]
            qs = st.prepare_queries(np.resize(pool, (Q, pool.shape[1])))
            live = torch.nonzero(st.alive).reshape(-1)
            if shared:
                vec = (live[torch.randperm(live.numel(), generator=g,
                                           device="cuda")[:B]]
                       if B <= live.numel()
                       else torch.arange(B, device="cuda"))
                arm = vec[None].expand(Q, B)
            else:
                arm = live[torch.randint(0, live.numel(), (Q, B),
                                         generator=g, device="cuda")]
            blk = torch.randint(0, st.d_pad // st.block, (Q, B, T),
                                generator=g, device="cuda", dtype=torch.int32)
            row = {"case": f"fleet_{'shard' if cap < FLEET_ROWS else 'store'}"
                           f"_{sched}_{'init' if shared else 'epoch'}",
                   "shape": {"Q": Q, "B": B, "T": T, "block": st.block,
                             "d_pad": st.d_pad, "n": cap,
                             "shared_arms": shared},
                   **compare(f"fused_epoch_pull fleet {sched}",
                             fused_epoch_pull_cuda(st.x, qs, arm, blk,
                                                   block=st.block),
                             ref.fused_epoch_pull_ref(st.x, qs, arm, blk,
                                                      st.block),
                             rtol=2e-4, atol=1e-5)}
        else:
            Q, n, d = shape
            st, pool = stores[FLEET_ROWS]
            qq = st.prepare_queries(np.resize(pool, (Q, pool.shape[1])))
            xx = st.x[:n]
            allowance = 1e-6 * ((qq ** 2).sum(1)[:, None]
                                + (xx ** 2).sum(1)[None])
            row = {"case": f"fleet_{key}", "shape": {"Q": Q, "n": n, "d": d},
                   **compare(f"pairwise_dist fleet {key}",
                             pairwise_dist_cuda(qq, xx),
                             ref.pairwise_dist_ref(qq, xx, "l2"), rtol=1e-4,
                             atol=0.0, allowance=allowance)}
        rows.append({"kernel": kernel, **row})
    missing = {"fused_epoch_pull", "fwht", "pairwise_dist"} - {
        r["kernel"] for r in rows}
    if missing:
        raise AssertionError(f"fleet: no operands recorded for {missing}")
    return rows


def policy_applied(fleet, plane, hot, cold, pools, root, seed: int) -> dict:
    """``FleetPressurePolicy`` fed a drained plane's stats with skewed
    ``ns_queue_depth`` for ``sustain`` windows, each decision executed by
    ``apply_fleet``: spread demand evicts the least-demanded namespace (a
    resident cold one), one namespace's half of the demand rebalances the
    plan over FLEET_PLAN_DEVICES devices. On one card a sharded window that
    moved keeps its tensors (the offset is recorded in the store and the
    manifest, through the epoch fence) and answers as before."""
    import dataclasses
    import numpy as np
    from repro_torch.fleet.manifest import load_manifest
    from repro_torch.fleet.placement import plan_placement
    from repro_torch.serve import FleetPressurePolicy, apply_fleet

    def decide(depth):
        policy = FleetPressurePolicy()
        stats = dataclasses.replace(plane.stats, ns_queue_depth=depth)
        for _ in range(policy.sustain):
            decision = policy.recommend(stats)
        return decision

    out = {}
    victim = cold[0]
    fleet.get(victim)
    spread = {victim: 1, hot[0]: 4, hot[1]: 4, cold[1]: 4}
    d = decide(spread)
    out["evict"] = {"depth": spread, "action": d.action, "target": d.target,
                    "acted": apply_fleet(fleet, d),
                    "target_resident_after": d.target in fleet.resident}
    if (d.action, d.target) != ("evict_namespace", victim) \
            or not out["evict"]["acted"] or out["evict"]["target_resident_after"]:
        raise AssertionError(f"fleet: policy eviction {out['evict']}")
    sharded = [n for n in hot if fleet.get(n).sharded]
    q = {n: pools[n][:FLEET_REQUEST_ROWS] for n in sharded}
    before = {n: plane.query(q[n], rng=seed + 5, namespace=n, cache="bypass")
              for n in sharded}
    epochs = {n: fleet.peek(n).epoch for n in sharded}
    skewed = {hot[0]: 6, hot[1]: 1, cold[1]: 1}
    d = decide(skewed)
    want = plan_placement(fleet.footprints(), FLEET_PLAN_DEVICES)
    acted = apply_fleet(fleet, d, n_devices=FLEET_PLAN_DEVICES)
    records = load_manifest(root)["namespaces"]
    offsets = {n: int(r.get("device_offset", 0)) for n, r in records.items()}
    moved = [n for n in sharded if want[n] != 0]
    rows = {}
    for n in sharded:
        idx = fleet.peek(n)
        got = plane.query(q[n], rng=seed + 5, namespace=n, cache="bypass")
        rows[n] = {"offset": want[n], "store_offset": idx.store.device_offset,
                   "fenced": idx.epoch == epochs[n] + (n in moved),
                   "devices": sorted({str(v) for v in idx.store.devices}),
                   "answers_as_before": bool(
                       np.array_equal(got.indices, before[n].indices)
                       and np.array_equal(got.values, before[n].values))}
    out["rebalance"] = {"depth": skewed, "action": d.action,
                        "target": d.target, "acted": acted,
                        "n_devices": FLEET_PLAN_DEVICES,
                        "offsets_nonzero": {n: o for n, o in want.items() if o},
                        "manifest_matches_plan": offsets == want,
                        "sharded": rows}
    if (d.action != "rebalance" or not acted or offsets != want or not moved
            or any(r["store_offset"] != r["offset"] or not r["fenced"]
                   or r["devices"] != ["cuda:0"] or not r["answers_as_before"]
                   for r in rows.values())):
        raise AssertionError(f"fleet: policy rebalance {out['rebalance']}")
    return out


def fleet_phase(seed: int) -> dict:
    """The namespace fleet (``repro_torch.fleet``) on the card, after the
    reference's own bench (``tools/bench_fleet.py``: 64 namespaces, 8
    resident, 4-query requests, a hot set of two namespaces taking 70% of
    them) at a tenant size users would call real: FLEET_NAMESPACES
    namespaces of FLEET_ROWS × FLEET_DIM fp32 rows (rotated box,
    ``DENSE.bmo``'s race settings), namespace i drawn by
    ``make_knn_benchmark_data`` from ``seed + 1 + i``, the last two at 2
    shards on the one card; ``FleetConfig(max_resident=8)`` over a root in
    ``save_dir``, deleted at the end. Each create checkpoints at once.

    Checks, in order: evict → reload bit-identical (a single-shard and a
    sharded namespace, same seed, same ids and values); FLEET_REQUESTS
    requests through ``fleet.serve()`` (a router-only plane with the
    δ-audit on every certified ticket, ``audit_flush`` between steps),
    closed loop with FLEET_CLIENTS in flight, ``cache="bypass"``, 70% to
    the hot pair, ``enforce_residency()`` after every step and a
    ``FleetPressurePolicy`` consulted on ``plane.stats`` every step (its
    decisions executed by ``apply_fleet``): every ticket certified at
    recall ≥ 0.99 against its namespace's float64 brute force; one vector
    in two namespaces (each its own answer, no cache hit across them) and
    its exact repeat (from the cache, free, the same answer); a sharded
    save killed mid-publish (``checkpoint.manager.save`` patched) leaves
    the previous checkpoint whole, no tmp left, and it answers as before;
    after the queues drain the resident count ≤ 8 and the device memory
    within 10% of the resident stores plus what was allocated before the
    phase; 0 audit mismatches; the health document's ``fleet`` section; a
    ``CheckpointManager(keep=2, async_save=True)`` over one namespace's
    store tensors from the card (3 steps, 2 left, the last restored onto
    the card equal, no tmp); then ``flush()``, the fleet dropped, and
    ``Fleet.open(root)``: all namespaces back, none materialized, no device
    memory taken, and the namespaces of the first check answering as before
    the restart. After the traffic, ``policy_applied`` runs the policy's
    two decisions; after the counted run, ``fleet_kernel_rows`` holds each
    of the path's kernels against its plain version at the widest operands
    the run gave it."""
    import shutil
    import numpy as np
    import torch
    import repro_torch.checkpoint.manager as ckpt
    from repro_torch.api import Index
    from repro_torch.configs.bmo_nn import DENSE
    from repro_torch.data.synthetic import make_knn_benchmark_data
    from repro_torch.fleet import Fleet, FleetConfig
    from repro_torch.kernels.fused_race import fused_epoch_pull_cuda
    from repro_torch.kernels.fwht import fwht_cuda
    from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda
    from repro_torch.obs.health import health_snapshot
    from repro_torch.serve import (FleetPressurePolicy, PlaneConfig,
                                   RequestPlane, apply_fleet)

    cfg, k, R = DENSE.bmo, DENSE.bmo.k, FLEET_REQUEST_ROWS
    names = [f"t{i:02d}" for i in range(FLEET_NAMESPACES)]
    hot, cold = names[-FLEET_HOT:], names[:-FLEET_HOT]
    x_bytes = FLEET_ROWS * FLEET_DIM * 4
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    parent = save_dir((FLEET_NAMESPACES + 2) * x_bytes, copies=1)
    root = os.path.join(parent, "fleet")
    out = {"phase": "fleet", "namespaces": FLEET_NAMESPACES,
           "rows": FLEET_ROWS, "dim": FLEET_DIM, "k": k, "delta": cfg.delta,
           "block": cfg.block, "batch_arms": cfg.batch_arms,
           "rotate": cfg.rotate, "sharded": [names[i] for i in FLEET_SHARDED],
           "max_resident": FLEET_MAX_RESIDENT, "requests": FLEET_REQUESTS,
           "rows_per_request": R, "hot": hot, "hot_share": FLEET_HOT_SHARE,
           "clients": FLEET_CLIENTS,
           "disk_free_gb": shutil.disk_usage(parent).free / 1e9}
    pools, truths, row_of, cross = {}, {}, {}, {}
    ckpt_s, reload_ms, decisions = [], [], []

    def rows(name, ids):
        ids = np.asarray(ids)
        return row_of[name][ids] if name in row_of else ids

    def same(a, b):
        return (np.array_equal(a.indices, b.indices)
                and np.array_equal(a.values, b.values))

    def run():
        fleet = Fleet(root, FleetConfig(max_resident=FLEET_MAX_RESIDENT))
        real_ckpt, real_reload = fleet._checkpoint, fleet._reload

        def timed_ckpt(st):
            t = time.perf_counter()
            wrote = real_ckpt(st)
            if wrote:
                ckpt_s.append(time.perf_counter() - t)
            return wrote

        def timed_reload(st):
            t = time.perf_counter()
            real_reload(st)
            torch.cuda.synchronize()
            reload_ms.append((time.perf_counter() - t) * 1e3)

        fleet._checkpoint, fleet._reload = timed_ckpt, timed_reload
        res = {}
        # --- build: every namespace created and checkpointed at once -----
        t0 = time.perf_counter()
        for i, name in enumerate(names):
            corpus, queries = make_knn_benchmark_data(
                "dense", FLEET_ROWS, FLEET_DIM, FLEET_POOL,
                seed=seed + 1 + i, device="cuda")
            truths[name] = brute_force_topk(corpus, queries, k)
            pools[name] = queries.cpu().numpy()
            if name == hot[1]:      # the hot pair's shared vector
                cross[name] = brute_force_topk(
                    corpus, torch.from_numpy(pools[hot[0]][:R]).cuda(), k)
            idx = fleet.create(name, corpus, cfg, seed + i,
                               shards=FLEET_SHARDS if i in FLEET_SHARDED
                               else 1)
            if idx.sharded:
                m = np.full(idx.capacity, -1, np.int64)
                m[idx.build_gids] = np.arange(FLEET_ROWS)
                row_of[name] = m
            del corpus, queries, idx
        torch.cuda.synchronize()
        res["build_s"] = time.perf_counter() - t0
        res["checkpoint_s"] = sum(ckpt_s)
        res["checkpoint_gb_per_s"] = (FLEET_NAMESPACES * x_bytes / 1e9
                                      / max(sum(ckpt_s), 1e-9))
        res["ns_bytes"] = fleet_store_bytes(fleet.peek(names[-1]).store)
        plane = fleet.serve(PlaneConfig(audit_rate=1.0))
        # --- evict → reload, bit for bit ----------------------------------
        answers = {}
        for name in (names[0], hot[0]):
            q = pools[name][:R]
            a = plane.query(q, rng=seed, namespace=name, cache="bypass")
            if not fleet.evict(name):
                raise AssertionError(f"fleet: {name} could not be evicted")
            b = plane.query(q, rng=seed, namespace=name, cache="bypass")
            if not same(a, b) or fleet.peek(name) is None:
                raise AssertionError(f"fleet: {name} answered differently "
                                     "after evict → reload")
            answers[name] = a
        plane.audit_flush()
        res["reload_bit_identical"] = sorted(answers)
        # --- closed-loop traffic -------------------------------------------
        r = np.random.default_rng(seed)
        plan = []
        for _ in range(FLEET_REQUESTS):
            name = (hot[int(r.integers(FLEET_HOT))]
                    if r.random() < FLEET_HOT_SHARE
                    else cold[int(r.integers(len(cold)))])
            plan.append((name, int(r.integers(FLEET_POOL // R)) * R))
        policy = FleetPressurePolicy()
        inflight, done = [], []
        peak = fleet.resident_count
        reloads0, evictions0 = fleet.reload_count, fleet.eviction_count
        t0 = time.perf_counter()
        nxt = steps = 0
        while nxt < len(plan) or inflight:
            while nxt < len(plan) and len(inflight) < FLEET_CLIENTS:
                name, w = plan[nxt]
                t = plane.submit(pools[name][w:w + R], namespace=name,
                                 rng=seed + 1000 + nxt, cache="bypass",
                                 tenant=f"c{nxt % FLEET_CLIENTS}")
                inflight.append((t, name, w))
                nxt += 1
                peak = max(peak, fleet.resident_count)
            plane.step()
            steps += 1
            inflight, finished = ([e for e in inflight if not e[0].terminal],
                                  [e for e in inflight if e[0].terminal])
            done += finished
            if finished:
                plane.audit_flush()     # while their namespaces are resident
            fleet.enforce_residency()
            decision = policy.recommend(plane.stats)
            if decision.action != "none":
                decisions.append({"step": steps, "action": decision.action,
                                  "target": decision.target,
                                  "reason": decision.reason,
                                  "acted": apply_fleet(fleet, decision)})
        traffic_s = time.perf_counter() - t0
        res["traffic_s"] = traffic_s
        res["rows_per_s"] = FLEET_REQUESTS * R / traffic_s
        res["steps"] = steps
        res["resident_peak"] = peak
        res["reloads"] = fleet.reload_count - reloads0
        res["evictions"] = fleet.eviction_count - evictions0
        bad = [(t.id, t.reason) for t, _, _ in done
               if t.status != "done" or t.reason != "certified"]
        if bad:
            raise AssertionError(f"fleet: tickets not certified: {bad[:5]}")
        res["recall"] = recall_of(
            "fleet traffic",
            np.concatenate([rows(n, t.result.indices) for t, n, _ in done]),
            np.concatenate([t.result.values for t, _, _ in done]),
            np.concatenate([truths[n][w:w + R] for _, n, w in done]),
            FLEET_ROWS, k)
        for label, group in (("hot", [t for t, n, _ in done if n in hot]),
                             ("cold", [t for t, n, _ in done
                                       if n not in hot])):
            lat = [t.latency_ms for t in group]
            res[f"{label}_tickets"] = len(lat)
            res[f"{label}_p50_ms"] = float(np.percentile(lat, 50))
            res[f"{label}_p99_ms"] = float(np.percentile(lat, 99))
        # --- the policy's two decisions, executed -------------------------
        # (the closed loop never queues FLEET_CLIENTS deep enough in one
        # namespace for the policy to act: it is fed skewed queue depths)
        res["policy_applied"] = policy_applied(fleet, plane, hot, cold, pools,
                                               root, seed)
        # --- one vector in two namespaces, and its exact repeat -------------
        v = pools[hot[0]][:R]
        a1 = plane.query(v, rng=seed + 7, namespace=hot[0])
        hits = fleet._cache.hits
        b1 = plane.query(v, rng=seed + 7, namespace=hot[1])
        if fleet._cache.hits != hits or np.array_equal(a1.indices,
                                                       b1.indices):
            raise AssertionError("fleet: two namespaces exchanged a vector's "
                                 "answer")
        a2 = plane.query(v, rng=seed + 8, namespace=hot[0])
        if (fleet._cache.hits != hits + R or not same(a1, a2)
                or float(np.sum(a2.coord_ops)) != 0.0):
            raise AssertionError("fleet: the exact repeat was not served "
                                 "from the cache")
        res["isolation"] = {
            hot[0]: recall_of("fleet isolation", rows(hot[0], a1.indices),
                              a1.values, truths[hot[0]][:R], FLEET_ROWS, k),
            hot[1]: recall_of("fleet isolation", rows(hot[1], b1.indices),
                              b1.values, cross[hot[1]], FLEET_ROWS, k),
            "repeat_cache_hits": R}
        # --- a sharded save killed mid-publish -----------------------------
        name = hot[1]
        q = pools[name][:R]
        before = plane.query(q, rng=seed + 9, namespace=name, cache="bypass")
        keep = set(truths[name].ravel().tolist())
        far = next(i for i in range(FLEET_ROWS - 1, -1, -1) if i not in keep)
        idx = fleet.get(name)
        idx.delete([int(np.nonzero(row_of[name] == far)[0][0])])
        del idx                             # the namespace is now dirty
        calls, real_save = [0], ckpt.save

        def boom(path, state, **kw):
            calls[0] += 1
            if calls[0] == 2:               # after shard 0 was staged
                raise OSError("killed mid-publish")
            return real_save(path, state, **kw)

        ckpt.save = boom
        try:
            fleet.evict(name)
            raise AssertionError("fleet: the patched save did not fail")
        except OSError:
            pass
        finally:
            ckpt.save = real_save
        ns_root = os.path.dirname(fleet._dir(name))
        left = [p for p in os.listdir(ns_root) if ".tmp-" in p]
        old = Index.load(fleet._dir(name), device="cuda")   # shards repeat it
        again = RequestPlane(old).query(q, rng=seed + 9, cache="bypass")
        after = plane.query(q, rng=seed + 9, namespace=name, cache="bypass")
        res["killed_save"] = {"namespace": name, "calls": calls[0],
                              "tmp_left": left, "old_n_live": old.n_live,
                              "old_answers_as_before": same(again, before),
                              "resident_ids_as_before": np.array_equal(
                                  after.indices, before.indices)}
        del old, again
        if (left or res["killed_save"]["old_n_live"] != FLEET_ROWS
                or not res["killed_save"]["old_answers_as_before"]
                or not res["killed_save"]["resident_ids_as_before"]
                or fleet.peek(name) is None):
            raise AssertionError(f"fleet: killed save {res['killed_save']}")
        # --- residency and device memory once the queues drain -------------
        fleet.enforce_residency()
        gc.collect()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        want = sum(fleet_store_bytes(fleet.peek(n).store)
                   for n in fleet.resident)
        res["memory"] = {"resident": fleet.resident_count,
                         "held_gb": held / 1e9, "resident_stores_gb":
                         want / 1e9}
        if (fleet.resident_count > FLEET_MAX_RESIDENT
                or abs(held - want) > 0.1 * want):
            raise AssertionError(f"fleet: memory after eviction "
                                 f"{res['memory']}")
        # --- audit and health ----------------------------------------------
        plane.audit_flush()
        a = plane.auditor.summary()
        res["audit"] = {"sampled_rows": a["sampled_rows"],
                        "mismatch_rows": a["mismatch_rows"],
                        "skipped": a["skipped"], "keys": len(a["keys"])}
        if a["sampled_rows"] == 0 or a["mismatch_rows"] != 0:
            raise AssertionError(f"fleet: audit {res['audit']}")
        doc = health_snapshot(plane=plane)
        if doc.get("fleet", {}).get("namespaces") != FLEET_NAMESPACES:
            raise AssertionError("fleet: health document without its fleet "
                                 "section")
        res["health_fleet"] = doc["fleet"]
        # --- the keep-last-N checkpoint manager from the card ---------------
        arrays = fleet.get(names[0]).store.arrays()
        mdir = os.path.join(parent, "manager")
        mgr = ckpt.CheckpointManager(mdir, keep=2, async_save=True)
        t = time.perf_counter()
        for step in range(1, FLEET_CKPT_STEPS + 1):
            state = {"store": arrays,
                     "step": torch.full((1,), float(step), device="cuda")}
            mgr.save(step, state, meta={"namespace": names[0]})
        mgr.wait()
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        back, meta = mgr.restore_latest(state, device="cuda")
        torch.cuda.synchronize()
        res["manager"] = {
            "steps": mgr.all_steps(), "save_s": save_s,
            "restore_s": time.perf_counter() - t, "meta": meta,
            "tmp_left": [p for p in os.listdir(mdir) if ".tmp" in p],
            "restored_equal": all(torch.equal(back["store"][n], x)
                                  for n, x in arrays.items())
            and float(back["step"][0]) == FLEET_CKPT_STEPS
            and back["step"].device.type == "cuda"}
        del back, state, arrays
        if (res["manager"]["steps"] != [FLEET_CKPT_STEPS - 1,
                                        FLEET_CKPT_STEPS]
                or res["manager"]["tmp_left"]
                or not res["manager"]["restored_equal"]):
            raise AssertionError(f"fleet: manager {res['manager']}")
        # --- flush, restart, recover ---------------------------------------
        t = time.perf_counter()
        res["flush_wrote"] = fleet.flush()
        res["flush_s"] = time.perf_counter() - t
        plane = fleet = None
        gc.collect()
        torch.cuda.synchronize()
        freed = torch.cuda.memory_allocated()
        t = time.perf_counter()
        fleet = Fleet.open(root)
        res["open_s"] = time.perf_counter() - t
        res["open_memory_growth_bytes"] = torch.cuda.memory_allocated() - freed
        if (len(fleet) != FLEET_NAMESPACES or fleet.resident_count != 0
                or res["open_memory_growth_bytes"] != 0):
            raise AssertionError(f"fleet: Fleet.open recovered {fleet}")
        plane = fleet.serve()
        for name, a in answers.items():
            got = plane.query(pools[name][:R], rng=seed, namespace=name,
                              cache="bypass")
            if not same(got, a):
                raise AssertionError(f"fleet: {name} answered differently "
                                     "after the restart")
        res["recovered_as_before"] = sorted(answers)
        return res, fleet

    t = time.perf_counter()
    seen = {}
    try:
        with recording_shapes(seen):
            (res, fleet), launches = counted(
                "fleet", {"fused_epoch_pull": fused_epoch_pull_cuda,
                          "fwht": fwht_cuda,
                          "pairwise_dist": pairwise_dist_cuda}, run)
        schedules = {s: getattr(fused_epoch_pull_cuda, f"launches_{s}")
                     for s in ("rows", "pair")}
        # the path's kernels at its own operands: a single-shard namespace's
        # store and a shard of a sharded one
        one, two = fleet.get(names[0]).store, fleet.get(hot[0]).store
        stores = {one.capacity: (one, pools[names[0]]),
                  two.shards[0].capacity: (two.shards[0], pools[hot[0]])}
        res["kernel_checks"] = fleet_kernel_rows(stores, seen, seed)
        del fleet, one, two, stores
    finally:
        shutil.rmtree(parent, ignore_errors=True)
    out.update(res)
    out["fused_epoch_pull_schedules"] = schedules
    out["reload_count"] = len(reload_ms)
    if reload_ms:
        out["reload_p50_ms"] = float(np.percentile(reload_ms, 50))
        out["reload_p99_ms"] = float(np.percentile(reload_ms, 99))
        out["reload_gb_per_s"] = (res["ns_bytes"] * len(reload_ms) / 1e9
                                  / (sum(reload_ms) / 1e3))
    out["policy_decisions"] = decisions
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t
    return out


def l1_truth(indices, values, q_idx, q_val, d: int, k: int,
             chunk: int = 8192):
    """Exact top-k by float64 ℓ1 distance: ``torch.cdist(p=1)`` over
    densified rows, ``chunk`` corpus rows at a time. Returns (ids, the
    float64 distances) on the host, the lower index first among ties."""
    import torch

    def dense(idx, val):
        r = idx.shape[0]
        out = torch.zeros((r, d + 1), dtype=torch.float64, device=idx.device)
        out.scatter_(1, idx.long(), val.to(torch.float64))
        return out[:, :d]

    q = dense(q_idx, q_val)
    best = torch.zeros((q.shape[0], 0), dtype=torch.float64, device=q.device)
    ids = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=q.device)
    for s in range(0, indices.shape[0], chunk):
        dist = torch.cdist(q, dense(indices[s:s + chunk],
                                    values[s:s + chunk]), p=1)
        cand = torch.cat([best, dist], 1)
        cand_ids = torch.cat([ids, torch.arange(
            s, s + dist.shape[1], device=q.device).expand(q.shape[0], -1)], 1)
        keep = torch.sort(cand, dim=1, stable=True).indices[:, :k]
        best = torch.gather(cand, 1, keep)
        ids = torch.gather(cand_ids, 1, keep)
    return ids.cpu().numpy(), best.cpu().numpy()


def sparse_rows(corpus, rows: int, n_queries: int, seed: int):
    """The first ``rows`` rows of the corpus as a corpus of their own (its
    width their largest nnz), and ``n_queries`` copies of its rows drawn
    from ``seed``: the race steps' cut."""
    import torch
    from repro_torch.core.datasets import SparseDataset
    nnz = corpus.nnz[:rows]
    m = max(int(nnz.max()), 1)
    sub = SparseDataset(indices=corpus.indices[:rows, :m].clone(),
                        values=corpus.values[:rows, :m].clone(), nnz=nnz.clone(),
                        d=corpus.d)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    pick = torch.randint(0, rows, (n_queries,), generator=g, device="cuda")
    return sub, (sub.indices[pick], sub.values[pick], sub.nnz[pick])


def profiled(fn) -> tuple:
    """``fn()`` under torch.profiler: (wall ms, device rows by kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    return wall_ms, kernel_breakdown(prof)


def round_cost(race, cap: int, traced: int) -> tuple:
    """What one round of a race costs. ``race(r)`` runs the race capped at
    r rounds; it runs to 1 and to 1 + ``cap`` rounds, timed, then to 1 and
    to 1 + ``traced`` under the profiler. Each difference holds rounds
    alone (the init and the first round cancel): ms a round, and from the
    traces device ms, kernels and the device's idle share a round and the
    kernels that take most of it. Returns (the race capped at 1 + cap,
    the costs)."""
    import torch
    wall = {}
    for r in (1, 1 + cap):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = race(r)
        torch.cuda.synchronize()
        wall[r] = time.perf_counter() - t
    w0, k0 = profiled(lambda: race(1))
    w1, k1 = profiled(lambda: race(1 + traced))
    base = {r["name"]: r for r in k0}
    per = sorted(({"name": r["name"],
                   "device_ms": (r["device_ms"] - base.get(r["name"], {})
                                 .get("device_ms", 0.0)) / traced,
                   "calls": (r["calls"] - base.get(r["name"], {})
                             .get("calls", 0)) / traced} for r in k1),
                 key=lambda r: -r["device_ms"])
    busy, traced_ms = sum(r["device_ms"] for r in per), (w1 - w0) / traced
    return res, {"capped_rounds": cap,
                 "ms_per_round": (wall[1 + cap] - wall[1]) * 1e3 / cap,
                 "traced_ms_per_round": traced_ms,
                 "device_ms_per_round": busy,
                 "kernels_per_round": sum(r["calls"] for r in per),
                 "device_idle_share": max(0.0, 1.0 - busy / traced_ms),
                 "top": per[:8]}


def inserted_rows(corpus, first: int, m: int, seed: int):
    """The mutation steps' SPARSE_INSERTS dense rows: copies of corpus rows
    ``first`` on, and one row with m + 100 nonzeros, wider than a store
    ``m`` wide."""
    import torch
    d = corpus.d
    src = torch.arange(first, first + SPARSE_INSERTS - 1, device="cuda")
    rows = torch.zeros((SPARSE_INSERTS, d + 1), device="cuda")
    rows[:-1].scatter_(1, corpus.indices[src].long(), corpus.values[src])
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 3)
    wide = torch.randperm(d, generator=g, device="cuda")[:m + 100]
    rows[-1, wide] = 1.0 + torch.rand(len(wide), generator=g, device="cuda")
    return rows[:, :d]


def sparse_phase(seed: int, n_queries: int) -> dict:
    """The ``bmo-nn-sparse`` workload (§IV-A): the corpus drawn on the card
    at its published size (n = 100,000, d = 28,672, 7% nonzero), the
    benchmark's 1,024 queries (copies of corpus rows). Steps, each timed.
    At full size: build (``Index.build``); oracle (``exact_knn_sparse`` of
    every query, its sets against ``l1_truth``); files (save and load,
    every array bit for bit); races capped at 1 + SPARSE_CAPPED_ROUNDS
    rounds, ``Index.query`` of ``n_queries`` queries and ``core.bmo_nn.knn``
    of one (``round_cost``: a round's ms, device ms, kernels and idle
    share); mutation (an insert that widens the rows, deletes, a capped
    query, ``maybe_compact``, a capped query: the inserted and the
    compacted rows held bit for bit, no dead slot returned). Then races run
    to certification over the first SPARSE_RACE_ROWS rows: rounds
    (``Index.query`` of ``n_queries`` copies of its rows); paper
    (``core.bmo_nn.knn`` of SPARSE_PAPER_QUERIES of them); mutation (that
    index saved and loaded, its race equal to the built index's over the
    first 1 + SPARSE_CAPPED_ROUNDS rounds, an
    insert that grows and widens the store, deletes, a query,
    ``maybe_compact``, a query). Recall ≥ 0.99 on every race run to
    certification, no dead slot returned."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    from repro_torch.api import EffortBudget, Index
    from repro_torch.configs.bmo_nn import SPARSE
    from repro_torch.core.bmo_nn import knn
    from repro_torch.core.datasets import SparseDataset
    from repro_torch.core.oracle import exact_knn_sparse
    from repro_torch.data.synthetic import make_knn_benchmark_data
    from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda
    from repro_torch.serve import RequestPlane

    cfg, n, d, k = SPARSE.bmo, SPARSE.n_points, SPARSE.dim, SPARSE.bmo.k
    out = {"phase": "sparse", "workload": SPARSE.name, "n": n, "d": d,
           "sparsity": SPARSE.sparsity, "queries": SPARSE.n_queries, "k": k,
           "delta": cfg.delta, "block": cfg.block,
           "batch_arms": cfg.batch_arms,
           "pulls_per_round": cfg.pulls_per_round, "seed": seed}
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        return result

    def store_bytes(idx):
        return sum(a.numel() * a.element_size()
                   for a in idx.store.arrays().values())

    def same_arrays(what, a, b):
        if a.store.meta() != b.store.meta() or sorted(
                a.store.arrays()) != sorted(b.store.arrays()) or any(
                x.dtype != b.store.arrays()[name].dtype
                or not torch.equal(x, b.store.arrays()[name])
                for name, x in a.store.arrays().items()):
            raise AssertionError(f"sparse {what}: the loaded arrays differ "
                                 "from the saved ones")

    def race_checks(what, res, truth, n_rows):
        got = recall_of(f"sparse {what}", np.asarray(res.indices),
                        np.asarray(res.values), truth, n_rows, k)
        return {**got, "rounds_max": int(np.max(res.rounds)),
                "rounds_mean": float(np.mean(res.rounds)),
                "n_exact_mean": float(np.mean(res.n_exact)),
                "coord_ops_mean": float(np.mean(res.coord_ops))}

    def oracle_count(sub, q_nnz):
        """The sparsity-aware exact cost of the queries over ``sub``."""
        return (len(q_nnz) * float(sub.nnz.double().sum())
                + float(q_nnz.double().sum()) * sub.n)

    def run():
        corpus, queries = timed("data_s", lambda: make_knn_benchmark_data(
            "sparse", n, d, SPARSE.n_queries, seed=seed, device="cuda"))
        idx = timed("build_s", lambda: Index.build(corpus, cfg, seed))
        out.update(m=idx.store.m, capacity=idx.capacity,
                   index_bytes=store_bytes(idx),
                   nnz_mean=float(corpus.nnz.double().mean()))

        # --- oracle: every query at full size against a float64 truth ----
        ex = timed("oracle_s", lambda: exact_knn_sparse(corpus, *queries, k))
        truth, tdist = timed("truth_s", lambda: l1_truth(
            corpus.indices, corpus.values, *queries[:2], d, k))
        got = ex.indices.cpu().numpy()
        disagreements = []
        for i in np.nonzero([set(a) != set(b) for a, b in
                             zip(got.tolist(), truth.tolist())])[0]:
            worst = float(ex.values[i].max()) * d
            disagreements.append({"query": int(i),
                                  "rel_gap": abs(worst - tdist[i, -1])
                                  / tdist[i, -1]})
        value_err = float(np.max(np.abs(ex.values.double().cpu().numpy() * d
                                        - tdist) / np.maximum(tdist, 1e-30)))
        out["oracle"] = {"set_disagreements": disagreements,
                         "max_value_rel_err": value_err,
                         "coord_ops": float(ex.coord_ops),
                         "coord_ops_share_of_nd": float(ex.coord_ops)
                         / (SPARSE.n_queries * n * d)}
        if any(x["rel_gap"] > 1e-4 for x in disagreements) or \
                value_err > 1e-4:
            raise AssertionError(f"sparse oracle disagrees with the float64 "
                                 f"truth: {out['oracle']}")
        del ex

        # --- files at full size ------------------------------------------
        tmp = save_dir(2 * out["index_bytes"])
        try:
            path = os.path.join(tmp, "sparse")
            timed("save_s", lambda: idx.save(path))
            out["bytes_written"] = sum(
                os.path.getsize(os.path.join(path, f))
                for f in os.listdir(path))
            loaded = timed("load_s", lambda: Index.load(path))
            same_arrays("files", idx, loaded)
            out["loaded_arrays_bit_equal"] = sorted(idx.store.arrays())
            del loaded
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

        # --- races at full size, capped: what a round costs ---------------
        t_full = time.perf_counter()
        qf = tuple(t[:n_queries] for t in queries)

        def capped_checks(what, res, alive):
            ids = np.asarray(res.indices)
            if ids.ndim != 2 or ids.shape[1] != k or \
                    not np.isfinite(np.asarray(res.values)).all() or \
                    not alive[ids].all():
                raise AssertionError(f"sparse {what}: a capped race returned "
                                     "a bad shape, a non-finite value or a "
                                     "dead slot")
            return {"rounds_max": int(np.max(res.rounds)),
                    "queries": int(ids.shape[0])}

        full = {}
        res, full["rounds"] = round_cost(
            lambda r: idx.query(qf, seed, max_rounds=r),
            SPARSE_CAPPED_ROUNDS, SPARSE_TRACED_ROUNDS)
        full["rounds"].update(capped_checks(
            "full-size rounds", res, idx.store.alive.cpu().numpy()))
        pq = tuple(t[:SPARSE_PAPER_QUERIES] for t in queries)
        res, full["paper"] = round_cost(
            lambda r: knn(corpus, pq, dataclasses.replace(cfg, max_rounds=r),
                          seed), SPARSE_CAPPED_ROUNDS, SPARSE_TRACED_ROUNDS)
        full["paper"].update(capped_checks(
            "full-size paper", res._replace(
                **{f: t.cpu().numpy() for f, t in res._asdict().items()}),
            np.ones(n, bool)))

        # --- tickets at full size: an effort budget of a few epochs gives
        # a certified prefix where a race to certification takes an hour --
        syncs = EpochSyncs()
        plane = RequestPlane(idx)
        fq = tuple(t[:PLANE_SPARSE_FULL_QUERIES].cpu().numpy()
                   for t in queries)
        with syncs.watching():
            t0 = time.perf_counter()
            fpairs = [(plane.submit(
                tuple(a[s:s + PLANE_ROWS] for a in fq), rng=seed,
                budget=EffortBudget(epochs=PLANE_SPARSE_FULL_EPOCHS)),
                np.arange(s, s + PLANE_ROWS))
                for s in range(0, PLANE_SPARSE_FULL_QUERIES, PLANE_ROWS)]
            plane.drain()
            times["tickets_full_size_s"] = time.perf_counter() - t0
        out["tickets_full_size"] = {
            **ticket_report([t for t, _ in fpairs]),
            **plane_checks("sparse, full size", fpairs,
                           lambda rows: truth[rows], n, k),
            "host_syncs": syncs.report()}
        del plane

        # --- mutation at full size: an insert that widens the rows,
        # deletes to 64 under half the capacity, maybe_compact ------------
        fm = {"m_before": idx.store.m}
        rows_in = inserted_rows(corpus, 0, idx.store.m, seed)
        slots = timed("full_insert_s", lambda: idx.insert(rows_in))
        got = {f: getattr(idx.store, f)[torch.from_numpy(slots).cuda()]
               for f in ("indices", "values", "nnz")}
        want = SparseDataset.build(rows_in)
        if idx.store.m <= fm["m_before"] or not (
                torch.equal(got["nnz"], want.nnz)
                and torch.equal(got["indices"][:, :want.m], want.indices)
                and torch.equal(got["values"][:, :want.m], want.values)
                and bool((got["indices"][:, want.m:] == d).all())):
            raise AssertionError("sparse full-size insert: the store did not "
                                 "widen or holds other rows than inserted")
        fm.update(m_after_insert=idx.store.m, n_live=idx.n_live)
        r = np.random.default_rng(seed)
        live = np.nonzero(idx.store.alive.cpu().numpy())[0]
        timed("full_delete_s", lambda: idx.delete(r.choice(
            live, idx.n_live - idx.capacity // 2 + 64, replace=False)))
        fm["n_live_after_delete"] = idx.n_live
        fm["after_delete"] = capped_checks(
            "full-size mutation, after delete",
            idx.query(qf, seed, max_rounds=SPARSE_TRACED_ROUNDS),
            idx.store.alive.cpu().numpy())
        before = idx.store
        old_ids = timed("full_compact_s", idx.maybe_compact)
        if old_ids is None:
            raise AssertionError("sparse full-size mutation: maybe_compact "
                                 "did not compact")
        keep = torch.from_numpy(old_ids[old_ids >= 0]).cuda()
        if not all(torch.equal(getattr(idx.store, f)[:len(keep)],
                               getattr(before, f)[keep])
                   for f in ("indices", "values", "nnz")):
            raise AssertionError("sparse full-size compact: the compacted "
                                 "rows differ from the live ones")
        del before
        fm["capacity_compacted"] = idx.capacity
        fm["after_compact"] = capped_checks(
            "full-size mutation, after compact",
            idx.query(qf, seed, max_rounds=SPARSE_TRACED_ROUNDS),
            idx.store.alive.cpu().numpy())
        full["mutation"] = fm
        out["full_size"] = full
        times["full_size_s"] = time.perf_counter() - t_full
        del idx, queries, res
        torch.cuda.empty_cache()

        # --- rounds: the per-round driver over the cut --------------------
        rows = SPARSE_RACE_ROWS
        sub, q = sparse_rows(corpus, rows, n_queries, seed)
        ridx = Index.build(sub, cfg, seed)
        truth_sub, _ = l1_truth(sub.indices, sub.values, *q[:2], d, k)
        built = timed("rounds_query_s", lambda: ridx.query(q, seed))
        exact_cost = oracle_count(sub, q[2])
        out["rounds"] = {
            "rows": rows, "queries": n_queries,
            "qps": n_queries / times["rounds_query_s"],
            **race_checks("rounds", built, truth_sub, rows),
            "ms_per_round": times["rounds_query_s"] * 1e3
            / max(int(np.max(built.rounds)), 1),
            "coord_ops": float(np.sum(built.coord_ops)),
            "oracle_coord_ops": exact_cost,
            "coord_op_gain": exact_cost / float(np.sum(built.coord_ops))}

        # --- tickets over the cut, raced to certification ----------------
        plane = RequestPlane(ridx)
        cq = tuple(t[:PLANE_SPARSE_CUT_QUERIES].cpu().numpy() for t in q)
        t0 = time.perf_counter()
        cpairs = [(plane.submit(cq, rng=seed),
                   np.arange(PLANE_SPARSE_CUT_QUERIES))]
        plane.drain()
        times["tickets_cut_s"] = time.perf_counter() - t0
        out["tickets_cut"] = {
            "rows": rows, **ticket_report([t for t, _ in cpairs]),
            **plane_checks("sparse, cut", cpairs,
                           lambda r: truth_sub[r], rows, k)}
        del plane

        # --- paper: Algorithm 2, one race per query -----------------------
        pq = tuple(t[:SPARSE_PAPER_QUERIES] for t in q)
        pres = timed("paper_s", lambda: knn(sub, pq, cfg, seed))
        out["paper"] = {
            "rows": rows, "queries": SPARSE_PAPER_QUERIES,
            "seconds_per_query": times["paper_s"] / SPARSE_PAPER_QUERIES,
            **race_checks("paper", pres._replace(
                **{f: t.cpu().numpy() for f, t in pres._asdict().items()}),
                truth_sub[:SPARSE_PAPER_QUERIES], rows)}
        # a race to certification at full size, projected: the rounds a
        # row over the cut times the rows, at a full-size round's ms
        for what, res in (("rounds", built), ("paper", pres)):
            full[what]["projected_race_s"] = (
                float(res.rounds.max()) / rows * n
                * full[what]["ms_per_round"] / 1e3)

        # --- mutation of the rounds step's index: files, insert (growth
        # and widening), deletes, maybe_compact, each query held to a
        # float64 truth over the live slots -------------------------------
        ridx.attach_payload(np.arange(rows))
        mut = {"m_before": ridx.store.m}
        tmp = save_dir(4 * store_bytes(ridx))
        try:
            path = os.path.join(tmp, "mutation")
            ridx.save(path)
            loaded = timed("mutation_load_s", lambda: Index.load(path))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        same_arrays("mutation files", ridx, loaded)
        # the loaded index replays the built one's race, both capped at
        # 1 + SPARSE_CAPPED_ROUNDS rounds (to certification it takes as
        # long as the rounds step)
        capped = ridx.query(q, seed, max_rounds=SPARSE_CAPPED_ROUNDS)
        again = timed("mutation_query_loaded_s", lambda: loaded.query(
            q, seed, max_rounds=SPARSE_CAPPED_ROUNDS))
        if not all(np.array_equal(getattr(again, f), getattr(capped, f))
                   for f in ("indices", "values", "rounds", "coord_ops")):
            raise AssertionError("sparse mutation: the loaded index's "
                                 "query differs from the built one's")
        mut["query_loaded_equals_built"] = True
        mut["query_loaded_capped_rounds"] = 1 + SPARSE_CAPPED_ROUNDS
        del ridx
        # the inserted rows: copies of corpus rows past the cut, and one
        # row denser than the store is wide
        dense_rows = inserted_rows(corpus, rows, loaded.store.m, seed)
        mut["capacity_before_insert"] = loaded.capacity
        timed("mutation_insert_s", lambda: loaded.insert(
            dense_rows, payload=rows + np.arange(SPARSE_INSERTS)))
        mut.update(capacity_after_insert=loaded.capacity,
                   m_after_insert=loaded.store.m)
        if loaded.store.m <= mut["m_before"] or \
                loaded.capacity <= mut["capacity_before_insert"]:
            raise AssertionError(f"sparse mutation: the insert did not grow "
                                 f"and widen the store: {mut}")
        # payload value → its CSR row: the cut's rows, then the inserted
        rows_of = [sub, SparseDataset.build(dense_rows)]
        every = torch.cat([torch.nn.functional.pad(
            r.indices, (0, loaded.store.m - r.m), value=d) for r in rows_of])
        every_val = torch.cat([torch.nn.functional.pad(
            r.values, (0, loaded.store.m - r.m)) for r in rows_of])

        def live_check(what, res):
            """Recall over the live slots against the float64 truth of the
            rows they hold, and no dead slot returned."""
            alive = loaded.store.alive.cpu().numpy()
            live = np.nonzero(alive)[0]
            origin = torch.from_numpy(loaded.payload[live]).cuda()
            ids, _ = l1_truth(every[origin], every_val[origin], *q[:2], d, k)
            got = race_checks(f"mutation, {what}", res, live[ids],
                              loaded.capacity)
            got["dead_slot_hits"] = int((~alive[res.indices]).sum())
            if got["dead_slot_hits"]:
                raise AssertionError(f"sparse mutation, {what}: {got}")
            return got

        r = np.random.default_rng(seed)
        true_top = set(loaded.payload[built.indices[:SPARSE_TOP_DELETED]]
                       .ravel().tolist())
        pool = np.setdiff1d(np.nonzero(loaded.store.alive.cpu().numpy())[0],
                            list(true_top))
        n_dead = loaded.n_live - loaded.capacity // 2 + 64
        dead = np.array(sorted(true_top | set(r.choice(
            pool, n_dead - len(true_top), replace=False).tolist())))
        timed("mutation_delete_s", lambda: loaded.delete(dead))
        mut["n_live_after_delete"] = loaded.n_live
        res = timed("mutation_query_after_delete_s",
                    lambda: loaded.query(q, seed))
        mut["after_delete"] = live_check("after delete", res)
        old_ids = timed("mutation_compact_s", loaded.maybe_compact)
        if old_ids is None:
            raise AssertionError("sparse mutation: maybe_compact did not "
                                 "compact")
        mut["capacity_compacted"] = loaded.capacity
        res = timed("mutation_query_after_compact_s",
                    lambda: loaded.query(q, seed))
        mut["after_compact"] = live_check("after compact", res)
        out["mutation"] = mut
        del loaded

    _, launches = counted("sparse", {"pairwise_dist": pairwise_dist_cuda},
                          run)
    out.update(times, launches=launches,
               launches_cuda_cores=pairwise_dist_cuda.launches_cc,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def kernel_breakdown(prof) -> list:
    """Device time by kernel name under a torch.profiler run, largest
    first."""
    import torch
    rows = []
    for ev in prof.key_averages():
        # kernel rows only: an operator's row repeats its kernels' time
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append({"name": ev.key[:90], "device_ms": dev_us / 1e3,
                         "calls": ev.count})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


LM_SITES = ("lm.attention", "lm.mlp", "lm.norm", "lm.loss")


@contextlib.contextmanager
def call_site_labels(model):
    """torch.profiler.record_function ranges named by LM_SITES around each
    layer's attention and MLP (module hooks), every rmsnorm and the loss's
    cross entropy (the two functions wrapped while the context lasts)."""
    import torch
    from repro_torch.models import common
    from repro_torch.train import loss as loss_mod
    open_ranges = []

    def enter(name):
        def hook(module, args):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            open_ranges.append(rf)
        return hook

    def leave(module, args, result):
        open_ranges.pop().__exit__(None, None, None)

    def wrap(fn, name):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return inner

    hooks = []
    for layer in model.layers:
        for module, name in ((layer.attn, "lm.attention"),
                             (layer.mlp, "lm.mlp")):
            hooks += [module.register_forward_pre_hook(enter(name)),
                      module.register_forward_hook(leave)]
    saved = common.rmsnorm, loss_mod.cross_entropy
    common.rmsnorm = wrap(saved[0], "lm.norm")
    loss_mod.cross_entropy = wrap(saved[1], "lm.loss")
    try:
        yield
    finally:
        common.rmsnorm, loss_mod.cross_entropy = saved
        for h in hooks:
            h.remove()


def is_copy(kernel_name: str) -> bool:
    return "copy" in kernel_name.lower() or kernel_name.startswith("Memcpy")


def call_site_breakdown(events):
    """Device time of each LM_SITES call site on the device's own clock:
    the profiler lays each record_function range on the device timeline
    too, from its first kernel to its last (``device_ms``, summed over the
    site's ranges), and a kernel belongs to the range its start falls in
    (``kernel_ms``, and ``copy_ms`` of the copy kernels among them).
    "other" is the kernels outside every range: the embedding, the
    residual adds, the logits' matmul. None (not measured) when the trace
    holds no device ranges."""
    import bisect
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    on_device = [ev for ev in events if ev.device_type == cuda]
    ranges = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                    for ev in on_device if ev.name in LM_SITES)
    if not ranges:
        return None
    sites = {name: {"device_ms": 0.0, "kernel_ms": 0.0, "copy_ms": 0.0,
                    "ranges": 0} for name in LM_SITES}
    for t0, t1, name in ranges:
        sites[name]["device_ms"] += (t1 - t0) / 1e3
        sites[name]["ranges"] += 1
    starts = [r[0] for r in ranges]
    other = {"kernel_ms": 0.0, "copy_ms": 0.0}
    for ev in on_device:
        if ev.name in LM_SITES:
            continue
        t0, t1 = ev.time_range.start, ev.time_range.end
        i = bisect.bisect_right(starts, t0) - 1
        site = sites[ranges[i][2]] if i >= 0 and t0 < ranges[i][1] else other
        site["kernel_ms"] += (t1 - t0) / 1e3
        if is_copy(ev.name):
            site["copy_ms"] += (t1 - t0) / 1e3
    sites["other"] = other
    sites["copies_ms"] = sum(v["copy_ms"] for v in sites.values())
    return sites


def build_lm(seed: int) -> tuple:
    """qwen2.5-14b's ``CONFIG`` at full width and depth with attn_impl
    "pallas", its parameters drawn on the card from ``seed`` (bf16, norms
    fp32): (the model, the seconds it took), shared by the lm_forward and
    serve phases."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_arch(LM_ARCH).config, attn_impl="pallas")
    t = time.perf_counter()
    model = build_model(cfg, param_dtype=torch.bfloat16, device="cuda",
                        rng=seed)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t


def lm_forward_phase(model, init_s: float, seed: int) -> dict:
    """qwen2.5-14b (``build_lm``): ``lm_loss`` forward under inference mode
    over LM_BATCH sequences of LM_SEQ tokens drawn from ``seed`` over the
    whole vocabulary (labels: the tokens shifted by one). Nothing is cut:
    the peak stays near 37 GB.

    All 48 launches must take the tensor-core kernel. One traced forward
    carries record_function labels by call site (``call_site_labels``).

    Then, on the first sequence, the whole forward twice, through the
    kernel and through the plain version. In the kernel's run every layer's
    attention is also held against the plain version on that layer's own
    q, k and v (layer 0 included), as ``tc_check``.
    The two whole forwards are compared layer by layer and at the loss.
    Their residual streams after layer 0 must agree to 1e-2 relative (L2).
    From there the gap grows: at this init each attention row is nearly
    one-hot and its output dominates the residual stream, so rounding-level
    differences flip near-tied picks. The logits' gap and the loss's are
    reported, and the loss is held only to 1e-2 relative, several times
    the spread of two decorrelated forwards (about 2e-3 over 4,096
    tokens). The loss of a random-init model is also checked to be finite
    and within 1 of ln(V) + 1/2."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attn import flash_attention_cuda
    from repro_torch.train.loss import cross_entropy, lm_loss

    cfg = model.cfg
    out = {"phase": "lm_forward", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "n_kv_heads": cfg.n_kv_heads, "vocab": cfg.vocab_size,
           "seq_len": LM_SEQ, "seed": seed, "attn_impl": cfg.attn_impl,
           "init_s": init_s,
           "params": sum(p.numel() for p in model.parameters()),
           "param_gb": sum(p.numel() * p.element_size()
                           for p in model.parameters()) / 1e9}
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ + 1),
                           generator=g, device="cuda")

    def loss_of(batch, impl="auto"):
        with torch.inference_mode():
            loss, metrics = lm_loss(model, batch, impl=impl)
        return float(loss), float(metrics["tokens"])

    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    (loss, n_tok), launches = counted(
        "lm_forward", {"flash_attention": flash_attention_cuda},
        lambda: loss_of(batch))
    cold_s = time.perf_counter() - t
    launches_tc = flash_attention_cuda.launches_tc
    if launches["flash_attention"] != cfg.n_layers or \
            launches_tc != cfg.n_layers:
        raise AssertionError(f"lm_forward launched flash_attention "
                             f"{launches['flash_attention']} times, "
                             f"{launches_tc} of them on the tensor cores, not "
                             f"once per layer ({cfg.n_layers}) there")
    if n_tok != LM_BATCH * LM_SEQ:
        raise AssertionError(f"lm_forward scored {n_tok} tokens")
    expect = math.log(cfg.vocab_size) + 0.5
    if not (math.isfinite(loss) and abs(loss - expect) < 1.0):
        raise AssertionError(f"lm_forward loss {loss}, expected near {expect}")
    out.update({"batch": LM_BATCH, "tokens": n_tok, "loss": loss,
                "ln_vocab": math.log(cfg.vocab_size), "launches": launches,
                "launches_tensor_cores": launches_tc,
                "cold_s": cold_s,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})

    # steady state, synced, then one profiled forward for the breakdown
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss_of(batch)
    out["forward_s"] = time.perf_counter() - t
    out["tokens_per_s"] = n_tok / out["forward_s"]
    with call_site_labels(model), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        loss_of(batch)
        traced_ms = (time.perf_counter() - t) * 1e3
    rows = kernel_breakdown(prof)
    busy = sum(r["device_ms"] for r in rows)
    attn = sum(r["device_ms"] for r in rows if "flash_attn" in r["name"])
    gemm = sum(r["device_ms"] for r in rows
               if any(w in r["name"].lower()
                      for w in ("gemm", "xmma", "cutlass", "nvjet")))
    out["traced"] = {"wall_ms": traced_ms, "device_busy_ms": busy,
                     "device_idle_share": max(0.0, 1.0 - busy / traced_ms),
                     "attention_ms": attn, "matmul_ms": gemm,
                     "other_ms": busy - attn - gemm,
                     "attention_share_of_forward": attn / (out["forward_s"] * 1e3),
                     "by_call_site": call_site_breakdown(prof.events()),
                     "top": rows[:12]}
    del batch
    torch.cuda.empty_cache()

    # the first sequence through the kernel and through the plain version
    one = {"tokens": tokens[:1, :-1], "labels": tokens[:1, 1:]}
    streams = {"cuda": [], "ref": []}
    layer_checks = []

    def keep(name, module, args, result):
        streams[name].append(result)

    def check(i, module, args, kwargs):
        x, positions = args
        q, k, v = (t.transpose(1, 2)
                   for t in module.qkv(x, positions, torch.bfloat16))
        got = flash_attention_cuda(q, k, v)
        layer_checks.append({"layer": i, "max_abs_v": float(v.abs().max()),
                             **tc_check(f"lm_forward layer {i} attention",
                                        got, ref.flash_attention_tc_bounds(
                                            q, k, v, True, 0))})

    losses = {}
    for impl in ("cuda", "ref"):
        hooks = [layer.register_forward_hook(functools.partial(keep, impl))
                 for layer in model.layers]
        if impl == "cuda":
            hooks += [layer.attn.register_forward_pre_hook(
                functools.partial(check, i), with_kwargs=True)
                for i, layer in enumerate(model.layers)]
        try:
            with torch.inference_mode():
                logits, _ = model(one, impl=impl)
                losses[impl], _ = cross_entropy(logits, one["labels"])
        finally:
            for h in hooks:
                h.remove()
        streams[impl + "_logits"] = logits.float()
        del logits
    gaps = [float((a.float() - b.float()).norm() / b.float().norm())
            for a, b in zip(streams["cuda"], streams["ref"])]
    la, lb = (float(losses[k]) for k in ("cuda", "ref"))
    ga, gb = streams["cuda_logits"], streams["ref_logits"]
    diff = (ga - gb).abs()
    out["first_sequence"] = {
        "layer_checks_max_abs_err": max(c["max_abs_err"] for c in layer_checks),
        "layer_checks_max_share_of_limit": {
            name: max(c[f"share_of_limit_{name}"] for c in layer_checks)
            for name in ("p_bf16", "p_fp32")},
        "layer_checks": len(layer_checks),
        "stream_rel_l2_by_layer": gaps,
        "loss_cuda": la, "loss_plain": lb,
        "loss_rel_diff": abs(la - lb) / abs(lb),
        "logits_rel_l2": float((ga - gb).norm() / gb.norm()),
        "logits_max_abs_err": float(diff.max()),
        "logits_share_beyond_3e-2": float(
            (diff > 3e-2 + 3e-2 * gb.abs()).float().mean())}
    out["layer_checks"] = layer_checks
    del streams, ga, gb, diff
    fs = out["first_sequence"]
    if len(layer_checks) != cfg.n_layers:
        raise AssertionError(f"{len(layer_checks)} layer checks, not "
                             f"{cfg.n_layers}")
    if gaps[0] > 1e-2:
        raise AssertionError(f"residual stream after layer 0: kernel and "
                             f"plain version differ by {gaps[0]} (L2)")
    if not fs["loss_rel_diff"] <= 1e-2:
        raise AssertionError(f"whole-forward loss: kernel {la}, plain {lb}")
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def model_config(model, **changes):
    """The config of the model and of each of its modules that holds one
    (the attention modules, the blocks), replaced by ``changes`` while the
    context lasts (``kv_quant``, ``attn_impl``)."""
    import dataclasses
    saved = model.cfg
    mods = [m for m in model.modules() if hasattr(m, "cfg")]
    for m in mods:
        m.cfg = dataclasses.replace(saved, **changes)
    try:
        yield
    finally:
        for m in mods:
            m.cfg = saved


def live_distances(store, queries):
    """(float64 squared distances (Q, n_live), the live slot ids) of
    ``queries`` against the store's live rows, in chunks of rows."""
    import torch
    live = torch.nonzero(store.alive).reshape(-1)
    q = queries.to(torch.float64)
    q2 = (q * q).sum(1)[:, None]
    out = []
    for s in range(0, live.shape[0], SERVE_TRUTH_CHUNK):
        x = store.x[live[s:s + SERVE_TRUTH_CHUNK], :queries.shape[1]].to(
            torch.float64)
        out.append(q2 + (x * x).sum(1)[None] - 2.0 * (q @ x.T))
    return torch.cat(out, 1), live


def tie_recall(served, dist, live, k: int) -> tuple:
    """(recall, rows below full recall) of the served (Q, k) slot ids: a
    served slot is a hit when its float64 distance is within 1e-4 of the
    k-th smallest, relatively (exact duplicates and near-ties at the
    precision of an fp32 sum of d terms tie)."""
    import torch
    kth = torch.topk(dist, k, dim=1, largest=False).values[:, -1]
    pos = torch.full((int(live.max()) + 1,), -1, dtype=torch.int64,
                     device=dist.device)
    pos[live] = torch.arange(live.shape[0], device=dist.device)
    s = torch.as_tensor(served, dtype=torch.int64, device=dist.device)
    if bool(((s < 0) | (s >= pos.shape[0])).any()) or \
            bool((pos[s] < 0).any()):
        raise AssertionError("serve: a served slot is not live")
    if any(len(set(r)) < k for r in s.tolist()):
        raise AssertionError("serve: a served row repeats a slot")
    got = torch.gather(dist, 1, pos[s])
    hits = (got <= kth[:, None] * (1 + 1e-4)).sum(1)
    return float(hits.sum()) / s.numel(), int((hits < k).sum())


def plain_vote(indices, values, payload, V: int, T: float, device):
    """The kNN vote recomputed plainly in float64: each neighbour's weight
    softmax(−value/T) added to its next token, log(p + 1e-9)."""
    import numpy as np
    import torch
    vals = torch.as_tensor(np.asarray(values, np.float64), device=device)
    w = torch.softmax(-vals / T, dim=1)
    toks = torch.as_tensor(payload[np.asarray(indices)], dtype=torch.int64,
                           device=device)
    p = torch.zeros((toks.shape[0], V), dtype=torch.float64, device=device)
    for j in range(toks.shape[1]):
        p[torch.arange(toks.shape[0], device=device), toks[:, j]] += w[:, j]
    return torch.log(p + 1e-9)


def synced_timer(times: list, fn):
    """``fn`` wrapped to append its synced wall seconds to ``times``."""
    import torch

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out
    return timed


def serve_datastore(model, seed: int):
    """The kNN-LM datastore of ``examples/knn_serve.py``'s flow at full
    size: the model's cache-free forward (attn_impl "pallas": the
    flash_attention kernel) over SERVE_DS_STEPS batches of ``lm_batch(V,
    SERVE_DS_BATCH, SERVE_DS_SEQ)``, each position's final hidden state in
    fp32 keyed to its next token. Returns (keys on the card, payload,
    launches, seconds)."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels.flash_attn import flash_attention_cuda
    cfg = model.cfg
    rows = SERVE_DS_BATCH * SERVE_DS_SEQ
    keys = torch.empty((SERVE_DS_STEPS * rows, cfg.d_model),
                       device=model.device)
    payload = np.empty((SERVE_DS_STEPS * rows,), np.int32)

    def run():
        with torch.inference_mode():
            for s in range(SERVE_DS_STEPS):
                b = lm_batch(cfg.vocab_size, SERVE_DS_BATCH, SERVE_DS_SEQ,
                             seed=seed, step=s)
                _, _, h = model({"tokens": torch.from_numpy(
                    b["tokens"]).to(model.device)}, return_hidden=True)
                keys[s * rows:(s + 1) * rows] = h.reshape(rows, -1)
                payload[s * rows:(s + 1) * rows] = b["labels"].reshape(-1)
                del h
        torch.cuda.synchronize()

    t = time.perf_counter()
    _, launches = counted("serve datastore",
                          {"flash_attention": flash_attention_cuda}, run)
    return keys, payload, launches, time.perf_counter() - t


def serve_lm_check(model, prompts) -> dict:
    """The cache path without kNN against the cache-free forward, and the
    int8 cache (see ``serve_phase``)."""
    import numpy as np
    import torch
    from repro_torch.models import common
    from repro_torch.serve import ServeEngine
    B, S0 = prompts.shape
    n_new = SERVE_CHECK_TOKENS
    max_seq = S0 + n_new + 8
    out = {}
    logits_seen = []

    def keep_logits(fn):
        def inner(*args):
            forwards.append([])
            res = fn(*args)
            logits_seen.append(res[0][:, -1].float())
            return res
        return inner

    engine = ServeEngine(model, batch_size=B, max_seq=max_seq,
                         device=model.device)
    prefill_s, decode_s = [], []
    engine.prefill_step = synced_timer(prefill_s,
                                       keep_logits(engine.prefill_step))
    engine.decode_step = synced_timer(decode_s,
                                      keep_logits(engine.decode_step))
    with layer_calls(model) as forwards:
        tokens, _ = engine.generate(prompts, n_new)
    del engine
    gc.collect()
    got = torch.stack(logits_seen, 1)             # prefill + decode steps
    toks = torch.from_numpy(tokens).to(got.device)
    seq = torch.from_numpy(np.concatenate([prompts, tokens[:, :-1]], 1)
                           ).to(device=model.device, dtype=torch.int64)
    # one chunk of queries: prompt + new − 1 positions need not be a
    # multiple of attn_chunk, and the chunks only partition the rows
    def plain():
        return model_config(model, attn_impl="auto", attn_chunk=seq.shape[1])

    prefill_layer0 = forwards[0][0][3]            # (B, S0, d)
    with torch.inference_mode():
        check, forced = teacher_forced(model, forwards)
    top2 = torch.topk(forced, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    agree = toks == torch.argmax(forced, -1)
    out["vs_cache_free_per_layer"] = {
        **check,
        "logits_rel_l2": float((got - forced).norm() / forced.norm()),
        "logits_max_abs_err": float((got - forced).abs().max()),
        "greedy_agreement": float(agree.float().mean()),
        "margin_bound": SERVE_TOKEN_MARGIN,
        "positions_above_bound": int((margin > SERVE_TOKEN_MARGIN).sum()),
        "disagreements_margin_max": float(margin[~agree].max())
        if bool((~agree).any()) else None}
    bad = (~agree) & (margin > SERVE_TOKEN_MARGIN)
    if bool(bad.any()):
        raise AssertionError(
            f"serve: {int(bad.sum())} greedy tokens differ from the "
            f"teacher-forced forward's where its top-two margin exceeds "
            f"{SERVE_TOKEN_MARGIN}")
    del forced

    # free-running: the whole cache-free forward over the same tokens
    ref_layer0 = []
    hook = model.layers[0].register_forward_hook(
        lambda m, a, r: ref_layer0.append(r))
    try:
        with plain(), torch.inference_mode():
            full, _ = model({"tokens": seq})
    finally:
        hook.remove()
    want = full[:, S0 - 1:].float()               # (B, n_new, V)
    del full
    gaps = [float((got[:, t] - want[:, t]).norm() / want[:, t].norm())
            for t in range(n_new)]
    ref0 = ref_layer0[0][:, :S0].float()
    l0 = float((prefill_layer0.float() - ref0).norm() / ref0.norm())
    agree = toks == torch.argmax(want, -1)
    out["vs_cache_free"] = {
        "layer0_rel_l2": l0, "logits_rel_l2_by_step": gaps,
        "logits_max_abs_err": float((got - want).abs().max()),
        "greedy_agreement": float(agree.float().mean())}
    del got, want, ref0, ref_layer0, prefill_layer0
    if l0 > 1e-2:
        raise AssertionError(f"serve: the prefill's layer-0 residual differs "
                             f"from the cache-free forward's by {l0} (L2)")
    out["prefill_tokens_per_s"] = B * S0 / prefill_s[0]
    out["decode_ms_per_step"] = 1e3 * float(np.median(decode_s))
    out["decode_tokens_per_s"] = B / float(np.median(decode_s))

    # the int8 cache: every cached entry's round trip against its bf16 value
    quantize = common.quantize_kv
    worst = {"share_of_bound": 0.0, "calls": 0}

    def checked(t):
        q, s = quantize(t)
        tf = t.float()
        s32 = torch.clamp(tf.abs().amax(-1), min=0.0) / 127.0
        s32 = torch.where(s32 > 0, s32, torch.ones_like(s32))
        deq = common.dequantize_kv(q, s, t.dtype).float()
        bound = (s32 / 2)[..., None] + q.float().abs() * (
            s.float() - s32).abs()[..., None] + deq.abs() * 2.0 ** -8 \
            + 2.0 ** -20 * (s32[..., None] + deq.abs())
        share = float(((deq - tf).abs() / bound).max())
        worst["share_of_bound"] = max(worst["share_of_bound"], share)
        worst["calls"] += 1
        return q, s

    common.quantize_kv = checked
    try:
        with model_config(model, kv_quant=True):
            engine = ServeEngine(model, batch_size=B, max_seq=max_seq,
                                 device=model.device)
            quant_tokens, _ = engine.generate(prompts, n_new)
            del engine
            gc.collect()
    finally:
        common.quantize_kv = quantize
    out["kv_quant"] = {
        "round_trip_share_of_bound": worst["share_of_bound"],
        "quantize_calls": worst["calls"],
        "token_agreement_with_bf16_cache": float(
            (quant_tokens == tokens).mean())}
    if worst["calls"] != model.cfg.n_layers * 2 * n_new or \
            worst["share_of_bound"] > 1.0:
        raise AssertionError(f"serve: int8 cache round trip {worst}")
    out["tokens"] = tokens
    return out


def serve_pull_rows(store, qs, seed: int) -> list:
    """``fused_epoch_pull`` at the serve path's epoch shapes, Q = 8 rows
    of hidden states over the full-size store: the CLI's config (B 16, T
    8) and the kNN run's (B 2,048, T 80), random live arms and blocks,
    each held against the plain version at the kernel phase's tolerance
    and timed beside its bound (its device time inside the path is the
    traced retrieval's)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_race import fused_epoch_pull_cuda
    g = torch.Generator(device=qs.device)
    g.manual_seed(seed)
    live = torch.nonzero(store.alive).reshape(-1).to(torch.int32)
    block, nb = store.block, store.d_pad // store.block
    rows = []
    for name, B, T in (("cli", SERVE_BMO["batch_arms"], 8),
                       ("served", SERVE_TUNED["batch_arms"],
                        SERVE_TUNED["epoch_rounds"]
                        * SERVE_TUNED["pulls_per_round"])):
        arm = live[torch.randint(0, live.shape[0], (qs.shape[0], B),
                                 generator=g, device=qs.device)]
        blk = torch.randint(0, nb, (qs.shape[0], B, T), generator=g,
                            device=qs.device, dtype=torch.int32)
        run = lambda: fused_epoch_pull_cuda(store.x, qs, arm, blk,
                                            block=block)
        plain = lambda: ref.fused_epoch_pull_ref(store.x, qs, arm, blk,
                                                 block)
        row = {"kernel": "fused_epoch_pull", "case": f"serve_{name}",
               "shape": {"Q": qs.shape[0], "B": B, "T": T, "block": block,
                         "d_pad": store.d_pad, "n": store.capacity},
               **compare(f"fused_epoch_pull serve {name}", run(), plain(),
                         rtol=2e-4, atol=1e-5)}
        row["ms"] = cuda_ms(run, reps=50, warmup=5)
        row["plain_ms"] = cuda_ms(plain, reps=5, warmup=1)
        row["bound_ms"], row["bound_by"] = pull_bound(store.x, arm, blk,
                                                      block)
        row["library_ms"] = None
        rows.append(row)
    return rows


def serve_phase(model, seed: int) -> dict:
    """qwen2.5-14b at full width and depth (``build_lm``) serving through
    ``serve.ServeEngine`` with the kNN-LM hook. Nothing of the model, the
    datastore or the traffic is cut:

    * datastore: ``serve_datastore``, 262,144 rows × 5,120 (5.4 GB) from
      ``--seed``; ``Index.build`` (the engine's) on the CLI's BMOConfig (k
      8, δ 0.05, block 64, batch_arms 16, unrotated);
    * traffic: SERVE_BATCH requests of ``lm_batch(V, 8, 1024,
      step=SERVE_DS_STEPS)`` prompts, ``max_seq`` = prompt + new + 8 (the
      CLI's), SERVE_KNN_TOKENS greedy tokens with ``index_append``.

    Held: each step's served top-k against a float64 brute force over the
    rows live at that step (``tie_recall``) at recall ≥ 0.99 over all
    steps; each step's vote against ``plain_vote`` at rtol = atol = 1e-6;
    the appended rows equal to the steps' hidden states and their payload
    to the generated tokens; ``fused_epoch_pull`` launched on the path (the
    ``counted`` wrapper) and no other kernel of the table; the run without
    kNN and the int8 cache (``serve_lm_check``): the prefill's layer-0
    residual within 1e-2 relative (L2) of the cache-free forward's (plain
    ``sdpa``, as the cache path), greedy tokens equal to that forward's
    wherever its top-two margin exceeds SERVE_TOKEN_MARGIN, every int8
    cache entry's round trip within s/2 of its bf16 value plus what the
    scale's rounding to bf16 (|q|·|s_bf16 − s|) and the bf16 output (half
    an ulp, 2⁻⁸ of it) add, and 2⁻²⁰ of slack for the fp32 steps.

    The retrieval serves a ``TunedConfig`` (SERVE_TUNED) installed
    through the tuner's in-process cache: on this datastore every row ends
    in an exact evaluation (its random-init hidden states are nearly
    isotropic), and the CLI's config (B 16, T 8) takes some 160,000
    epochs a step to get there; its race on the first step's rows is run
    for SERVE_CLI_CAP_S seconds and reported (epochs, coordinate ops, the
    projected seconds to certify)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import BMOConfig
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels.block_pull import (block_pull_cuda,
                                                block_pull_multi_cuda)
    from repro_torch.kernels.flash_attn import flash_attention_cuda
    from repro_torch.kernels.fused_race import fused_epoch_pull_cuda
    from repro_torch.kernels.fwht import fwht_cuda
    from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda
    from repro_torch.serve import KNNLMConfig, ServeEngine
    from repro_torch.tune import (TunedConfig, cache_clear, cache_put,
                                  signature_of)
    from repro_torch.utils import hostsync

    cfg, dev = model.cfg, model.device
    V, d, k = cfg.vocab_size, cfg.d_model, SERVE_BMO["k"]
    torch.cuda.reset_peak_memory_stats()
    out = {"phase": "serve", "arch": cfg.name, "seed": seed,
           "datastore_rows": SERVE_DS_STEPS * SERVE_DS_BATCH * SERVE_DS_SEQ,
           "batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT,
           "knn_tokens": SERVE_KNN_TOKENS, "bmo": SERVE_BMO,
           "serving_tuned": SERVE_TUNED}
    t_phase = time.perf_counter()
    keys, payload, ds_launches, out["datastore_forward_s"] = \
        serve_datastore(model, seed)
    norms = keys.norm(dim=1)
    out["key_norm_range"] = [float(norms.min()), float(norms.max())]
    if not bool(torch.isfinite(norms).all()):
        raise AssertionError("serve: non-finite datastore keys")
    prompts = lm_batch(V, SERVE_BATCH, SERVE_PROMPT, seed=seed,
                       step=SERVE_DS_STEPS)["tokens"]

    out["lm"] = serve_lm_check(model, prompts)
    first_tokens = out["lm"].pop("tokens")

    max_seq = SERVE_PROMPT + SERVE_KNN_TOKENS + 8
    knn = KNNLMConfig(lam=0.2, bmo=BMOConfig(**SERVE_BMO))
    torch.cuda.synchronize()
    t = time.perf_counter()
    engine = ServeEngine(model, batch_size=SERVE_BATCH, max_seq=max_seq,
                         knn_lm=knn, datastore=(keys, payload),
                         index_append=True, device=dev)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t
    del keys
    n0 = engine.index.n_live

    # the CLI's config on the first decode step's rows, capped
    seq = torch.from_numpy(np.concatenate(
        [prompts, first_tokens[:, :1]], 1)).to(dev)
    with torch.inference_mode():
        _, _, h = model({"tokens": seq}, return_hidden=True)
    first_rows = h[:, -1].float().contiguous()
    del h
    sess = engine.index.race(first_rows, seed)
    t = time.perf_counter()
    epochs = 0
    while not sess.done.all() and time.perf_counter() - t < SERVE_CLI_CAP_S:
        sess.step()
        epochs += 1
    cap_s = time.perf_counter() - t
    snap = sess.snapshot
    capped = {"cfg": "CLI (R 4, P 2, B 16)", "seconds": cap_s,
              "epochs": epochs, "ms_per_epoch": 1e3 * cap_s / max(epochs, 1),
              "certified": snap.acc_count.tolist(),
              "coord_ops_share_of_nd": float(np.mean(snap.coord_ops))
              / (n0 * d),
              "n_exact_mean": float(np.mean(snap.n_exact))}
    del sess, snap

    cache_clear()
    cache_put(signature_of(engine.index.store),
              TunedConfig(**SERVE_TUNED, mode="fused"))
    report = engine.index.tune()
    if not report.get("cached") or engine.index.cfg.batch_arms != \
            SERVE_TUNED["batch_arms"]:
        raise AssertionError(f"serve: the serving config was not installed: "
                             f"{report}")
    out["pull_rows"] = serve_pull_rows(engine.index.store, first_rows, seed)
    del first_rows

    # the kNN run: every step timed, its retrieval held and its vote redone
    per_step = {"lm_s": [], "retrieval_s": [], "append_s": [],
                "syncs": [], "epochs": [], "recall": [], "vote_err": []}
    record = {"hidden": [], "res": None}
    below = 0
    query = engine.plane.query
    knn_logits = engine._knn_logits

    def checked_query(hidden, **kw):
        nonlocal below
        store = engine.index.store
        dist, live = live_distances(store, hidden)
        record["hidden"].append(hidden.clone())
        syncs, launches = hostsync.syncs(), fused_epoch_pull_cuda.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = query(hidden, **kw)
        per_step["retrieval_s"].append(time.perf_counter() - t)
        per_step["syncs"].append(hostsync.syncs() - syncs)
        per_step["epochs"].append(fused_epoch_pull_cuda.launches - launches)
        rec, rows_below = tie_recall(res.indices, dist, live, k)
        per_step["recall"].append(rec)
        below += rows_below
        record["res"] = res
        return res

    def checked_vote(hidden, rng):
        logits, ops = knn_logits(hidden, rng)
        res = record["res"]
        want = plain_vote(res.indices, res.values, engine.index.payload, V,
                          knn.temperature, logits.device)
        err = (logits.double() - want).abs()
        per_step["vote_err"].append(float(err.max()))
        if not bool((err <= 1e-6 + 1e-6 * want.abs()).all()):
            raise AssertionError(f"serve: the vote differs from its plain "
                                 f"recompute by {float(err.max())}")
        return logits, ops

    engine.plane.query = checked_query
    engine._knn_logits = checked_vote
    engine.decode_step = synced_timer(per_step["lm_s"], engine.decode_step)
    engine._append_to_index = synced_timer(per_step["append_s"],
                                           engine._append_to_index)
    prefill_s = []
    engine.prefill_step = synced_timer(prefill_s, engine.prefill_step)
    others = {"fwht": fwht_cuda, "block_pull": block_pull_cuda,
              "block_pull_multi": block_pull_multi_cuda,
              "pairwise_dist": pairwise_dist_cuda,
              "flash_attention": flash_attention_cuda}
    for w in others.values():
        w.launches = 0
    t = time.perf_counter()
    (tokens, ops), launches = counted(
        "serve", {"fused_epoch_pull": fused_epoch_pull_cuda},
        lambda: engine.generate(prompts, SERVE_KNN_TOKENS, rng=seed))
    wall = time.perf_counter() - t
    stray = {name: w.launches for name, w in others.items() if w.launches}
    if stray:
        raise AssertionError(f"serve: the kNN run launched {stray}")
    launches["flash_attention"] = ds_launches["flash_attention"]

    n_steps = SERVE_KNN_TOKENS - 1
    if len(per_step["recall"]) != n_steps:
        raise AssertionError(f"serve: {len(per_step['recall'])} retrievals "
                             f"for {n_steps} decode steps")
    recall = float(np.mean(per_step["recall"]))
    if recall < 0.99:
        raise AssertionError(f"serve: recall {recall} < 0.99")
    if tokens.shape != (SERVE_BATCH, SERVE_KNN_TOKENS) or \
            not ((tokens >= 0) & (tokens < V)).all():
        raise AssertionError("serve: malformed tokens")
    idx = engine.index
    new = np.arange(n0, n0 + n_steps * SERVE_BATCH)
    new_t = torch.from_numpy(new).to(dev)
    if not bool(idx.store.alive[new_t].all()) or \
            idx.n_live != n0 + new.size:
        raise AssertionError("serve: the appended rows are not the live "
                             "slots after the datastore's")
    if not np.array_equal(idx.payload[new], tokens[:, 1:].T.reshape(-1)):
        raise AssertionError("serve: the appended payload is not the "
                             "generated tokens")
    hidden = torch.cat(record["hidden"])
    if not torch.equal(idx.store.x[new_t, :d], hidden):
        raise AssertionError("serve: the appended rows are not the steps' "
                             "hidden states")

    lm_s, ret_s, app_s = (float(np.sum(per_step[key]))
                          for key in ("lm_s", "retrieval_s", "append_s"))
    coord_per_row = ops / (n_steps * SERVE_BATCH)
    capped["projected_s_to_certify"] = (
        cap_s * coord_per_row / (n0 * d)
        / max(capped["coord_ops_share_of_nd"], 1e-12))
    out.update({
        "launches": launches, "retrieval_cli_config_capped": capped,
        "knn_run": {
            "wall_s": wall, "prefill_s": prefill_s[0],
            "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT
            / prefill_s[0],
            "step_ms": 1e3 * (lm_s + ret_s + app_s) / n_steps,
            "lm_ms_per_step": 1e3 * lm_s / n_steps,
            "retrieval_ms_per_step": 1e3 * ret_s / n_steps,
            "append_ms_per_step": 1e3 * app_s / n_steps,
            "retrieval_ms_per_step_max": 1e3 * max(per_step["retrieval_s"]),
            "retrieval_rows_per_s": n_steps * SERVE_BATCH / ret_s,
            "epochs_per_step": float(np.mean(per_step["epochs"])),
            "host_syncs_per_step": float(np.mean(per_step["syncs"])),
            "coord_ops_per_row_share_of_nd": coord_per_row / (n0 * d),
            "recall": recall, "rows_below_full_recall": below,
            "vote_max_abs_err": max(per_step["vote_err"]),
            "appended_rows": int(new.size),
            "capacity_after": idx.capacity,
            "stats": {key: v for key, v in engine.stats.as_dict().items()
                      if key in ("races", "raced_queries", "cache_hits",
                                 "near_hits", "compactions",
                                 "plane_epochs")}},
        "decode_floor_ms": sum(p.numel() * p.element_size()
                               for p in model.parameters())
        / HBM_BYTES_PER_S * 1e3,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    # one more retrieval of the last step's rows, traced, on the same
    # serving config (the blocking fused driver the sessions share)
    rows = record["hidden"][-1]
    wall_ms, kernels = profiled(
        lambda: idx.query(rows, seed, cache="bypass"))
    busy = sum(r["device_ms"] for r in kernels)
    out["traced_retrieval"] = {
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "top": kernels[:8]}
    # the wrappers above close over the engine: drop every reference and
    # collect the cycle, so that its store and cache leave the card
    del engine, idx, hidden, record, rows, query, knn_logits
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def serve_cli_phase() -> dict:
    """``python -m repro_torch.launch.serve`` at full width (its own
    qwen2.5-14b, bf16 from seed 0, and its 2,048-row random datastore),
    called in the process through ``main``: SERVE_BATCH × 1,024-token
    prompts, SERVE_CLI_TOKENS new tokens, the index built into and saved
    to a fresh directory, appends, a δ-audit of every certified ticket, the
    SLOs and a health dump. It must finish, log "0/N audited rows
    mismatched" and both SLOs "ok", and write the health document."""
    import logging
    import re
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.launch import serve

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    health = os.path.join(root, "health.json")
    argv = ["--arch", LM_ARCH, "--batch", str(SERVE_BATCH),
            "--prompt-len", str(SERVE_PROMPT), "--new-tokens",
            str(SERVE_CLI_TOKENS), "--knn-lm", "--index-dir",
            os.path.join(root, "idx"), "--index-append", "--audit-rate",
            "1.0", "--slo", "--health-dump", health]
    logger = logging.getLogger("repro_torch.serve")
    handler = Keep()
    logger.addHandler(handler)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    try:
        run = serve.main(argv)
        with open(health) as f:
            doc = json.load(f)
    finally:
        logger.removeHandler(handler)
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t
    audit = [m for m in lines if "audited rows mismatched" in m]
    slos = [m for m in lines if m.startswith("SLO ")]
    found = re.search(r"(\d+)/(\d+) audited rows mismatched",
                      audit[0]) if audit else None
    out = {"phase": "serve_cli", "argv": argv, "seconds": seconds,
           "generate_s": run["seconds"],
           "tokens_per_s": run["tokens"].size / run["seconds"],
           "retrieval_ops": run["retrieval_ops"], "audit_line": audit,
           "slo_lines": slos, "health_keys": sorted(doc),
           "audit_skipped": run["audit"]["skipped"] if run["audit"] else None,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    tokens = run["tokens"]
    if tokens.shape != (SERVE_BATCH, SERVE_CLI_TOKENS) or \
            not np.isfinite(run["retrieval_ops"]) or \
            run["retrieval_ops"] <= 0:
        raise AssertionError(f"serve_cli: malformed run {out}")
    if found is None or found.group(1) != "0":
        raise AssertionError(f"serve_cli: audit line {audit}")
    if len(slos) != 2 or not all(m.endswith(" ok") for m in slos):
        raise AssertionError(f"serve_cli: SLO lines {slos}")
    out["sharded_smoke"] = serve_cli_sharded()
    out["fleet_smoke"] = serve_cli_fleet()
    return out


# the families phase: (arch, layers kept (None: the published depth),
# lm_loss batch and length (whisper: frames, with S // dec_seq_div decoder
# tokens), serving batch, prompt (whisper: 8 decoder tokens after its
# frames) and greedy decode steps)
FAMILY_RUNS = (
    ("xlstm-350m", None, (4, 1024), (8, 1024, 16)),
    ("zamba2-2.7b", None, (4, 4096), (8, 1024, 16)),
    ("qwen2-vl-2b", None, (4, 4096), (8, 1024, 16)),
    ("whisper-base", None, (8, 1500), (8, 8, 16)),
    ("granite-34b", 4, (1, 4096), (2, 512, 8)),
    ("nemotron-4-340b", 4, (1, 4096), (2, 512, 8)),
    ("llama3-405b", 4, (1, 4096), (2, 512, 8)),
    ("deepseek-v3-671b", 4, (1, 4096), (2, 512, 8)),
    ("dbrx-132b", 4, (1, 4096), (2, 512, 8)),
)
FAMILY_CLI_ARCHS = ("xlstm-350m", "zamba2-2.7b")
# the MoE archs through the CLI at ``--smoke`` (their full configs hold
# 671 B and 132 B parameters)
FAMILY_CLI_SMOKE_ARCHS = ("deepseek-v3-671b", "dbrx-132b")
# the length of each family's untimed warm-up run (``family_run``)
FAMILY_WARMUP_LEN = 256


def family_batch(cfg, B: int, S: int, g, labels: bool) -> dict:
    """What the family's forward reads, drawn on the card from ``g``: token
    ids over the whole vocabulary; for the VLM bf16 N(0, 1) embeddings with
    all three M-RoPE streams at arange(S) (the reference's
    ``tests/test_models.py:_batch``); for whisper bf16 N(0, 1) frames and
    S // dec_seq_div decoder tokens (its serving prompt: the frames and 8
    tokens). Labels: random token ids of the decoder's length."""
    import torch
    dev = g.device
    if cfg.family == "vlm":
        out = {"embeds": torch.randn((B, S, cfg.d_model), generator=g,
                                     device=dev).to(torch.bfloat16),
               "positions3": torch.arange(S, device=dev)[None, None].expand(
                   3, B, S)}
        n = S
    elif cfg.family == "audio":
        n = S // cfg.dec_seq_div if labels else 8
        out = {"frames": torch.randn((B, S, cfg.d_model), generator=g,
                                     device=dev).to(torch.bfloat16),
               "tokens": torch.randint(0, cfg.vocab_size, (B, n),
                                       generator=g, device=dev)}
    else:
        n = S
        out = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                       generator=g, device=dev)}
    if labels:
        out["labels"] = torch.randint(0, cfg.vocab_size, (B, n), generator=g,
                                      device=dev)
    return out


def attention_calls(cfg) -> int:
    """Cache-free attention layers in one forward: the fused op's launches
    under attn_impl "pallas" (none for MLA, which takes the plain ``sdpa``
    as the reference's does)."""
    if cfg.family == "moe":
        return 0 if cfg.use_mla else cfg.n_layers
    return {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
            "audio": cfg.enc_layers + cfg.dec_layers}.get(cfg.family,
                                                          cfg.n_layers)


@contextlib.contextmanager
def layer_calls(model):
    """Records every layer call of the model (dense, Mamba2, mLSTM, sLSTM,
    whisper's decoder, the MoE LM's blocks), forward by forward: yields a
    list to which
    ``begin()`` (the returned function) adds a new forward's list of
    (module, args, kwargs, output)."""
    from repro_torch.models.audio import DecoderLayer
    from repro_torch.models.hybrid import MambaLayer
    from repro_torch.models.moe import MoEBlock
    from repro_torch.models.ssm import MLSTMBlock, SLSTMBlock
    from repro_torch.models.transformer import DenseLayer
    forwards = []

    def hook(module, args, kwargs, out):
        if forwards:
            forwards[-1].append((module, args, kwargs, out))

    hooks = [m.register_forward_hook(hook, with_kwargs=True)
             for m in model.modules()
             if isinstance(m, (DenseLayer, MambaLayer, MLSTMBlock, SLSTMBlock,
                               DecoderLayer, MoEBlock))]
    try:
        yield forwards
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def recording_flash(seen: set):
    """Wraps ``kernels.ops.flash_attention``, the fused op's one call site
    (``GQAAttention``), to keep each distinct launch it is given: q's,
    k's and v's shapes and strides, the type, ``causal`` and ``q_offset``.
    Shapes only: no tensor is kept."""
    from repro_torch.kernels import ops as kops
    real = kops.flash_attention

    def flash(q, k, v, *, causal=True, q_offset=0, impl="auto"):
        seen.add((tuple((tuple(t.shape), t.stride()) for t in (q, k, v)),
                  q.dtype, causal, q_offset))
        return real(q, k, v, causal=causal, q_offset=q_offset, impl=impl)

    kops.flash_attention = flash
    try:
        yield
    finally:
        kops.flash_attention = real


def family_flash_rows(arch: str, seen: set, g) -> list:
    """flash_attention at each distinct launch of one family's counted run
    (``recording_flash``), launched once more on fresh N(0, 1) inputs laid
    out as the path's (shapes and strides) and held against the plain
    version at the kernel phase's tolerances: the tensor-core variant by
    ``tc_check``, the CUDA-core one within one bf16 ulp (rtol 8e-3, atol
    1e-4). Raises on a mismatch."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attn import flash_attention_cuda, variant
    rows = []
    for layout, dtype, causal, q_offset in sorted(seen, key=str):
        q, k, v = (torch.empty_strided(shape, stride, dtype=dtype,
                                       device=g.device).copy_(torch.randn(
                                           shape, generator=g,
                                           device=g.device))
                   for shape, stride in layout)
        (B, H, Sq, D), (KV, Sk), Dv = q.shape, k.shape[1:3], v.shape[-1]
        row = {"variant": variant(dtype, D, Dv), "causal": causal,
               "q_offset": q_offset,
               "shape": {"B": B, "H": H, "KV": KV, "Sq": Sq, "Sk": Sk,
                         "D": D, "Dv": Dv},
               "contiguous": all(t.is_contiguous() for t in (q, k, v))}
        what = f"families {arch}: flash_attention {row['shape']}"
        got = flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
        if row["variant"] == "tensor_cores":
            row.update(tc_check(what, got, ref.flash_attention_tc_bounds(
                q, k, v, causal, q_offset)))
            row["tolerance"] = "ref.flash_attention_tc_bounds"
        else:
            tol = {"rtol": 8e-3, "atol": 1e-4}
            row.update(compare(what, got, ref.flash_attention_ref(
                q, k, v, causal, q_offset), **tol))
            row["tolerance"] = tol
        rows.append(row)
        del q, k, v, got
    return rows


class MoERoutes:
    """The MoE layers' routing on the cache path, forced on their
    teacher-forced reruns. Wraps ``models.moe.route`` (each MoE module's
    one call site), keyed by the module that calls it: after ``start()``
    it keeps each layer's top-k ids, call by call (the prefill, then each
    decode step); after ``replay(B)`` each layer's next call routes its B
    rows by those ids, concatenated along the sequence as the rerun's
    input is, its weights recomputed from its own logits
    (``moe.expert_weights``), and ``flips`` counts, by layer, the tokens
    whose own top k differs. So a bf16 near-tie that the rerun rounds the
    other way does not move a whole token in a check of the cache path;
    the routing itself is held bit for bit by ``moe_layer_checks``."""

    def __init__(self, model):
        from repro_torch.models import moe
        self.moe = moe
        self.real = moe.route
        self.current = None
        self.recording = False
        self.recorded = collections.defaultdict(list)
        self.forced = {}
        self.flips = {}
        mods = [m for m in model.modules() if isinstance(m, moe.MoE)]
        self.names = {id(m): f"moe_layer_{i}" for i, m in enumerate(mods)}
        self.hooks = [m.register_forward_pre_hook(self._enter) for m in mods]
        moe.route = self._route

    def _enter(self, module, args):
        self.current = id(module)

    def _route(self, cfg, logits):
        w, i = self.real(cfg, logits)
        key = self.current
        if key in self.forced:
            ids = self.forced.pop(key)
            self.flips[self.names[key]] = int((ids != i).any(-1).sum())
            return self.moe.expert_weights(cfg, logits, ids), ids
        if self.recording:
            self.recorded[key].append(i)
        return w, i

    def start(self):
        self.recording = True

    def replay(self, B: int):
        import torch
        self.recording = False
        for key, calls in self.recorded.items():
            k = calls[0].shape[-1]
            self.forced[key] = torch.cat([c.view(B, -1, k) for c in calls],
                                         1).reshape(-1, k)
        self.recorded.clear()

    def close(self):
        self.moe.route = self.real
        for h in self.hooks:
            h.remove()


def teacher_forced(model, forwards, routes=None, batch: int = 0) -> tuple:
    """The cache path held layer by layer, in the serve phase and the
    families phase: each layer on the cache path (a layer called in the
    prefill and in every decode step; ``forwards`` from ``layer_calls``,
    which this consumes) run cache-free over the whole sequence on the
    cache run's own inputs (teacher-forced), its output against the cache
    run's by relative L2, over all positions and over the decode
    positions; raises beyond TEACHER_FORCED_L2. Whole free-running forwards
    are not held: at the reference's init every attention row is nearly
    one-hot, so rounding-level differences decorrelate them in depth
    (qwen2.5-14b's free-running logits differ by 1.2 relative L2 in the
    serve phase while each layer agrees to 5e-5). The cache-free runs take
    the plain ``sdpa`` (attn_impl "auto", one q chunk), as the cache path
    does, so both round the probabilities the same way. Returns (the
    gaps, the last layer's cache-free output through the final norm and
    the head as fp32 logits (B, n, V) at the prompt's last position and
    each later one: what the prefill's last position and each decode
    step give on the cache path). ``routes``: an MoE model's
    ``MoERoutes``, whose recorded ids the reruns route by (``batch``
    rows); the tokens each layer would route otherwise are reported."""
    import torch
    from repro_torch.models import common

    def keys(calls):
        seen = collections.Counter()
        out = []
        for module, args, kwargs, o in calls:
            out.append((id(module), seen[id(module)]))
            seen[id(module)] += 1
        return out

    series = collections.defaultdict(list)
    for calls in forwards:
        for key, call in zip(keys(calls), calls):
            series[key].append(call)
    order = keys(forwards[-1])                # the cache path, in call order
    forwards.clear()
    if routes is not None:
        routes.replay(batch)
    with model_config(model, attn_impl="auto", attn_chunk=1 << 30):
        gaps, decode_gaps, tail = _forced_layers(series, order)
    norm = model.dec_norm if hasattr(model, "dec_norm") else model.final_norm
    h = common.rmsnorm(tail.to(torch.bfloat16), norm, model.cfg.norm_eps)
    forced = model.embed.lm_head(h).float()
    out = {"layers_checked": len(gaps), "layer_rel_l2_max": max(gaps),
           "layer_rel_l2_decode_positions_max": max(decode_gaps),
           "layer_rel_l2_by_layer": gaps, "bound": TEACHER_FORCED_L2}
    if routes is not None:
        out["router_flips_in_reruns"] = dict(routes.flips)
    worst = max(gaps + decode_gaps)
    if not worst <= TEACHER_FORCED_L2:
        raise AssertionError(f"{model.cfg.name}: a layer of the cache path "
                             f"differs from its teacher-forced cache-free "
                             f"run by {worst} (L2): {out}")
    return out, forced


def _forced_layers(series, order) -> tuple:
    """``teacher_forced``'s cache-free runs: each layer's relative L2 gaps
    over all positions and over the decode positions, and the last layer's
    output from the prompt's last position on."""
    import torch
    from repro_torch.models.audio import DecoderLayer
    from repro_torch.models.hybrid import MambaLayer
    from repro_torch.models.moe import MoEBlock
    from repro_torch.models.transformer import DenseLayer
    gaps, decode_gaps, tail = [], [], None
    for key in order:
        calls = series.pop(key)
        module, args, kwargs = calls[0][:3]
        outs = [c[3][0] if isinstance(c[3], tuple) else c[3] for c in calls]
        x = torch.cat([c[1][0] for c in calls], 1)
        del calls
        B, S = x.shape[:2]
        pos = torch.arange(S, device=x.device)[None].expand(B, S)
        if isinstance(module, DecoderLayer):
            want = module(x, pos, args[2], args[3], args[4], args[5])
        elif isinstance(module, DenseLayer):
            vlm = kwargs.get("positions3") is not None
            want = module(x, None if vlm else pos, args[2], args[3],
                          causal=kwargs.get("causal", True),
                          positions3=pos[None].expand(3, B, S) if vlm
                          else None)
        elif isinstance(module, MoEBlock):
            # cache-free and MLA expanded, against the absorbed decode
            want = module(x, pos, args[2], args[3])[0]
        elif isinstance(module, MambaLayer):
            want = module(x, None, args[2])
        else:
            want = module(x, None, args[2])[0]
        got = torch.cat(outs, 1).float()
        want = want.float()
        S0 = outs[0].shape[1]
        gaps.append(float((got - want).norm() / want.norm()))
        decode_gaps.append(float((got[:, S0:] - want[:, S0:]).norm()
                                 / want[:, S0:].norm()))
        tail = want[:, S0 - 1:]
        del x, got, want, outs
    return gaps, decode_gaps, tail


def moe_layer_checks(layer, h) -> dict:
    """An MoE layer of a families run at its input in the loss half (the
    published capacity factor): its routing on the card (the router's bf16
    logits cast to fp32, the top-k ids and weights, the dispatch's order,
    slots and keep mask) recomputed on the CPU from the same fp32 logits,
    ids, order, slots and mask equal bit for bit and the weights within
    1e-6; the slots dropped at that factor counted; and the layer run
    twice on that input, its output and aux equal bit for bit (the combine
    adds in a fixed order, without atomics). Raises on a mismatch."""
    import torch
    from repro_torch.models import moe
    cfg = layer.cfg
    x2d = h.reshape(-1, h.shape[-1])
    T, E, k = x2d.shape[0], cfg.n_experts, cfg.n_experts_active
    cap = moe.capacity(T, k, E, factor=cfg.moe_capacity_factor)

    def routing(logits):
        w, i = moe.route(cfg, logits)
        dest, order, keep = moe.dispatch_indices(i.reshape(-1), E, cap)
        return {"top_w": w, "top_i": i, "order": order, "dest": dest,
                "keep": keep}

    with torch.inference_mode():
        logits = layer.router_logits(x2d, torch.bfloat16)
        card = routing(logits)
        cpu = routing(logits.cpu())
        (a, a_aux), (b, b_aux) = (layer(h, torch.bfloat16) for _ in range(2))
        ms = cuda_ms(lambda: layer(h, torch.bfloat16), reps=3, warmup=1)
    keep = card["keep"]
    load = torch.bincount(card["top_i"].reshape(-1), minlength=E)
    out = {"tokens": T, "experts": E, "k": k,
           "capacity_factor": cfg.moe_capacity_factor, "capacity": cap,
           "slots": T * k, "dropped_slots": int((~keep).sum()),
           "tokens_an_expert_max": int(load.max()),
           "tokens_an_expert_min": int(load.min()),
           "routing_equal": {n: bool(torch.equal(card[n].cpu(), cpu[n]))
                             for n in ("top_i", "order", "dest", "keep")},
           "weights_max_abs_diff": float((card["top_w"].cpu()
                                          - cpu["top_w"]).abs().max()),
           "deterministic": bool(torch.equal(a, b)
                                 and torch.equal(a_aux, b_aux)),
           "layer_ms": ms}
    if not (all(out["routing_equal"].values())
            and out["weights_max_abs_diff"] <= 1e-6):
        raise AssertionError(f"{cfg.name}: the MoE routing on the card "
                             f"differs from the CPU's on the same logits: "
                             f"{out}")
    if not out["deterministic"]:
        raise AssertionError(f"{cfg.name}: an MoE layer gave other bits on "
                             f"a second call: {out}")
    return out


def family_run(arch: str, layers, loss_shape, serve_shape, seed: int,
               device: str = "cuda") -> dict:
    """One architecture of the families phase (see ``families_phase``)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attn import flash_attention_cuda, variant
    from repro_torch.models import build_model
    from repro_torch.serve.steps import (init_cache, make_decode_step,
                                         make_prefill_step)
    from repro_torch.train.loss import lm_loss

    cfg = dataclasses.replace(get_arch(arch).config, attn_impl="pallas")
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t = time.perf_counter()
    model = build_model(cfg, param_dtype=torch.bfloat16, device=device,
                        rng=seed)
    torch.cuda.synchronize()
    out = {"arch": arch, "family": cfg.family, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "head_dim": cfg.head_dim_,
           "init_s": time.perf_counter() - t,
           "params": sum(p.numel() for p in model.parameters()),
           "param_gb": sum(p.numel() * p.element_size()
                           for p in model.parameters()) / 1e9,
           "flash_variant": variant(torch.bfloat16, cfg.head_dim_,
                                    cfg.head_dim_)
           if attention_calls(cfg) else None}
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    B, S = loss_shape
    Bs, S0, steps = serve_shape
    batch = family_batch(cfg, B, S, g, labels=True)
    if cfg.family == "audio":
        prompt = family_batch(cfg, Bs, S, g, labels=False)
        max_seq = S
    else:
        prompt = family_batch(cfg, Bs, S0, g, labels=False)
        max_seq = S0 + steps + 8
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)
    flash = flash_attention_cuda
    timings = {}
    is_moe = cfg.family == "moe"

    def serving():
        # the serve half of an MoE model runs dropless (capacity factor
        # E/k), so its cache path and the cache-free reruns drop nothing
        # and route the same tokens; the loss half keeps the published 1.25
        if not is_moe:
            return contextlib.nullcontext()
        return model_config(model, moe_capacity_factor=cfg.n_experts
                            / cfg.n_experts_active)

    def warm_up():
        # the same calls at a short length, untimed, so that the timed
        # ones pay no one-off set-up (library handles, first launches)
        n = min(S, FAMILY_WARMUP_LEN)
        short = family_batch(cfg, B, n, g, labels=True)
        p = family_batch(cfg, Bs, n if cfg.family == "audio"
                         else min(S0, FAMILY_WARMUP_LEN), g, labels=False)
        with torch.inference_mode(), serving():
            lm_loss(model, short)
            cache = init_cache(model, Bs, n if cfg.family == "audio"
                               else min(S0, FAMILY_WARMUP_LEN) + 8)
            logits, cache = prefill(p, cache)
            decode(cache, torch.argmax(logits[:, -1].float(), -1).to(
                torch.int32)[:, None])
        torch.cuda.synchronize()

    def run():
        # an MoE model's first MoE layer input in the loss half, for
        # ``moe_layer_checks``
        moe_in = []
        hook = (model.layers[0].moe.register_forward_pre_hook(
            lambda m, a: moe_in.append(a[0])) if is_moe else None)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.inference_mode():
            loss, metrics = lm_loss(model, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        timings["loss_s"] = time.perf_counter() - t
        timings["loss_launches"] = (flash.launches_tc, flash.launches_cc)
        if hook is not None:
            hook.remove()
        cache = init_cache(model, Bs, max_seq)
        with layer_calls(model) as forwards, serving():
            if routes is not None:
                routes.start()
            forwards.append([])
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = prefill(prompt, cache)
            torch.cuda.synchronize()
            timings["prefill_s"] = time.perf_counter() - t
            tok = torch.argmax(logits[:, -1].float(), -1).to(torch.int32)[
                :, None]
            step_s = []
            for _ in range(steps):
                forwards.append([])
                t = time.perf_counter()
                tok, logits, cache = decode(cache, tok)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
        timings["step_s"] = step_s
        return metrics, moe_in, forwards, logits[:, -1]

    warm_up()
    routes = MoERoutes(model) if is_moe else None
    # the counts from 0 just before the path and read just after (an
    # xLSTM launches none, so ``counted``'s "never launched" does not apply)
    seen = set()
    for attr in [a for a in vars(flash) if a.startswith("launches")]:
        setattr(flash, attr, 0)
    try:
        with recording_flash(seen):
            metrics, moe_in, forwards, last = run()
        launches = {"tensor_cores": flash.launches_tc,
                    "cuda_cores": flash.launches_cc}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        loss, n_tok = metrics["loss"], metrics["tokens"]
        if not bool(torch.isfinite(last.float()).all()):
            raise AssertionError(f"families {arch}: non-finite decode logits")
        with torch.inference_mode(), serving():
            check, forced = teacher_forced(model, forwards, routes, Bs)
    finally:
        if routes is not None:
            routes.close()
    # the loss's forward, and whisper's prefill encodes its frames
    # cache-free; every other prefill and decode step reads the cache
    want_launches = attention_calls(cfg) + (
        cfg.enc_layers if cfg.family == "audio" else 0)
    if sum(launches.values()) != want_launches or (
            want_launches and launches[out["flash_variant"]]
            != want_launches):
        raise AssertionError(f"families {arch}: flash_attention launches "
                             f"{launches}, expected {want_launches} on "
                             f"{out['flash_variant']}")
    # the cross entropy (an MoE loss adds its aux and MTP terms)
    expect = math.log(cfg.vocab_size)
    if not (math.isfinite(loss) and abs(metrics["ce"] - expect) < 2.0):
        raise AssertionError(f"families {arch}: cross entropy "
                             f"{metrics['ce']}, expected near ln V = "
                             f"{expect}")
    n_prompt_tokens = Bs * (S0 if cfg.family != "audio" else 8)
    step = float(sorted(timings["step_s"])[len(timings["step_s"]) // 2])
    out.update({
        "loss_batch": [B, S], "loss": loss, "ce": metrics["ce"],
        "ln_vocab": expect,
        "loss_tokens": n_tok, "loss_s": timings["loss_s"],
        "loss_tokens_per_s": n_tok / timings["loss_s"],
        "serve_batch": Bs, "prompt": S0, "decode_steps": steps,
        "prefill_s": timings["prefill_s"],
        "prefill_tokens_per_s": n_prompt_tokens / timings["prefill_s"],
        "decode_ms_per_step": 1e3 * step,
        "decode_tokens_per_s": Bs / step,
        "launches": launches,
        "launches_in_loss": dict(zip(("tensor_cores", "cuda_cores"),
                                     timings["loss_launches"])),
        "peak_memory_gb": peak_gb})
    if is_moe:
        out.update({"aux": metrics["aux"], "mtp_ce": metrics.get("mtp_ce"),
                    "capacity_factor_loss": cfg.moe_capacity_factor,
                    "capacity_factor_serve": cfg.n_experts
                    / cfg.n_experts_active})
        if not all(math.isfinite(v) for v in (metrics["aux"],
                                               metrics.get("mtp_ce", 0.0))):
            raise AssertionError(f"families {arch}: aux or MTP loss "
                                 f"{metrics}")
        out["moe_checks"] = moe_layer_checks(model.layers[0].moe, moe_in[0])
        del moe_in
    got, want = last.float(), forced[:, -1]
    check.update({
        "last_step_logits_rel_l2": float((got - want).norm() / want.norm()),
        "last_step_greedy_agreement": float(
            (got.argmax(-1) == want.argmax(-1)).float().mean())})
    out["check"] = check
    if not check["last_step_logits_rel_l2"] <= TEACHER_FORCED_L2:
        raise AssertionError(f"families {arch}: the last decode step's "
                             f"logits differ from the teacher-forced "
                             f"cache-free run's: {check}")
    del forced, got, want, batch, prompt, model
    gc.collect()
    torch.cuda.empty_cache()
    # the path's flash launches again, each against its plain version
    out["flash_checks"] = family_flash_rows(arch, seen, g)
    torch.cuda.empty_cache()
    return out


def families_phase(seed: int) -> dict:
    """Every model family the port serves besides qwen2.5-14b's dense LM,
    on the card in bf16 with random weights from ``seed`` (FAMILY_RUNS):
    xlstm-350m, zamba2-2.7b, qwen2-vl-2b and whisper-base whole at their
    published configs, granite-34b, nemotron-4-340b, llama3-405b,
    deepseek-v3-671b and dbrx-132b at full width cut to 4 layers (deepseek:
    its 3 dense MLA layers, 1 MoE layer and the MTP head). Each: ``lm_loss``
    through the cache-free forward
    with attn_impl "pallas" (flash_attention once per attention layer, on
    the variant its head width takes), then a prefill and greedy decode
    steps through ``serve.steps`` (the cache path reads its KV cache
    through the plain ``sdpa``, as the reference's does), timed after an
    untimed warm-up at FAMILY_WARMUP_LEN tokens, each model's launches
    counted from 0 over those two; then the teacher-forced check
    (``teacher_forced``) at TEACHER_FORCED_L2 relative L2, the serve
    phase's bound, and each distinct flash launch of the counted run held
    once more against the plain version (``family_flash_rows``). The MoE
    models' loss half keeps the published capacity factor 1.25 and their
    serve half runs dropless (E/k), their teacher-forced reruns route by
    the cache path's ids (``MoERoutes``), and their first MoE layer's
    routing and determinism are held (``moe_layer_checks``). Then the
    serving CLI at full width for FAMILY_CLI_ARCHS and at ``--smoke`` for
    FAMILY_CLI_SMOKE_ARCHS (``family_cli``)."""
    import torch
    t = time.perf_counter()
    held_gb = torch.cuda.memory_allocated() / 1e9
    runs = []
    for arch, layers, loss_shape, serve_shape in FAMILY_RUNS:
        runs.append(family_run(arch, layers, loss_shape, serve_shape, seed))
        emit({"families_run": arch, **runs[-1]})
    launches = {v: sum(r["launches"][v] for r in runs)
                for v in ("tensor_cores", "cuda_cores")}
    out = {"phase": "families", "held_at_start_gb": held_gb, "runs": runs,
           "cli": family_cli(),
           "launches": {"flash_attention": sum(launches.values())},
           "launches_by_variant": launches,
           "flash_checks": [{"arch": r["arch"], **c} for r in runs
                            for c in r["flash_checks"]],
           "seconds": time.perf_counter() - t}
    return out


def family_cli() -> list:
    """``repro_torch.launch.serve.main`` at full width for each of
    FAMILY_CLI_ARCHS (SERVE_BATCH prompts of SERVE_PROMPT tokens,
    SERVE_CLI_TOKENS new tokens) and at ``--smoke`` for each of
    FAMILY_CLI_SMOKE_ARCHS (2 prompts of 8 tokens, 3 new tokens)."""
    import numpy as np
    from repro_torch.launch import serve
    runs = [(arch, ["--batch", str(SERVE_BATCH), "--prompt-len",
                    str(SERVE_PROMPT), "--new-tokens", str(SERVE_CLI_TOKENS)],
             (SERVE_BATCH, SERVE_CLI_TOKENS)) for arch in FAMILY_CLI_ARCHS]
    runs += [(arch, ["--smoke", "--batch", "2", "--prompt-len", "8",
                     "--new-tokens", "3"], (2, 3))
             for arch in FAMILY_CLI_SMOKE_ARCHS]
    rows = []
    for arch, flags, shape in runs:
        argv = ["--arch", arch] + flags
        t = time.perf_counter()
        run = serve.main(argv)
        tokens = run["tokens"]
        if tokens.shape != shape or not (
                (tokens >= 0).all() and np.isfinite(run["seconds"])):
            raise AssertionError(f"families CLI {arch}: malformed run")
        rows.append({"arch": arch, "argv": argv,
                     "seconds": time.perf_counter() - t,
                     "generate_s": run["seconds"],
                     "tokens_per_s": tokens.size / run["seconds"]})
        gc.collect()
    return rows


def serve_cli_fleet() -> dict:
    """The CLI at ``--smoke`` with ``--fleet-root``: the first launch
    creates the fleet's ``default`` namespace, the second recovers it from
    ``fleet.json``; both serve through the fleet's plane with a δ-audit of
    every certified ticket (0 mismatches) and log their ``fleet stats``
    line, which is printed here."""
    import logging
    import shutil
    import tempfile
    from repro_torch.launch import serve

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    root = tempfile.mkdtemp(prefix="chip_smoke_serve_fleet_")
    argv = ["--arch", LM_ARCH, "--smoke", "--batch", "2", "--prompt-len",
            "8", "--new-tokens", "6", "--knn-lm", "--datastore-size", "256",
            "--fleet-root", os.path.join(root, "fleet"), "--max-resident",
            "2", "--audit-rate", "1.0"]
    logger = logging.getLogger("repro_torch.serve")
    handler = Keep()
    logger.addHandler(handler)
    runs = []
    try:
        for launch in ("create", "recover"):
            del lines[:]
            t = time.perf_counter()
            run = serve.main(argv)
            stats_line = [m for m in lines if m.startswith("fleet stats")]
            opened = [m for m in lines if "namespace 'default'" in m]
            print(stats_line[0] if stats_line else "fleet stats: missing",
                  flush=True)
            runs.append({"launch": launch,
                         "seconds": time.perf_counter() - t,
                         "tokens_shape": list(run["tokens"].shape),
                         "retrieval_ops": run["retrieval_ops"],
                         "fleet": run["fleet"], "opened": opened,
                         "audit_mismatches": run["audit"]["mismatch_rows"],
                         "audit_rows": run["audit"]["sampled_rows"]})
            want = "created" if launch == "create" else "recovered"
            if (run["tokens"].shape != (2, 6) or run["retrieval_ops"] <= 0
                    or not stats_line or len(opened) != 1
                    or want not in opened[0]
                    or run["fleet"]["namespaces"] != 1
                    or run["audit"]["mismatch_rows"] != 0
                    or run["audit"]["sampled_rows"] == 0):
                raise AssertionError(f"serve_cli fleet: {runs[-1]}")
    finally:
        logger.removeHandler(handler)
        shutil.rmtree(root, ignore_errors=True)
    return {"argv": argv, "runs": runs}


def serve_cli_sharded() -> dict:
    """The CLI at its small (``--smoke``) size with ``--index-shards
    SERVE_CLI_SHARDS``: one launch builds and saves the sharded index (its
    shards on the card), a second loads the directory and appends; both
    must serve with per-shard telemetry for every shard."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.launch import serve

    root = tempfile.mkdtemp(prefix="chip_smoke_serve_sharded_")
    argv = ["--arch", LM_ARCH, "--smoke", "--batch", "2", "--prompt-len",
            "8", "--new-tokens", "6", "--knn-lm", "--datastore-size", "256",
            "--index-shards", str(SERVE_CLI_SHARDS), "--index-dir",
            os.path.join(root, "idx"), "--index-append"]
    runs = []
    try:
        for launch in ("build", "load"):
            t = time.perf_counter()
            run = serve.main(argv)
            shard_ops = run["stats"]["shard_coord_ops"]
            runs.append({"launch": launch,
                         "seconds": time.perf_counter() - t,
                         "tokens_shape": list(run["tokens"].shape),
                         "retrieval_ops": run["retrieval_ops"],
                         "shard_coord_ops": shard_ops})
            if (run["tokens"].shape != (2, 6) or run["retrieval_ops"] <= 0
                    or not np.isfinite(run["retrieval_ops"])
                    or shard_ops is None
                    or len(shard_ops) != SERVE_CLI_SHARDS):
                raise AssertionError(f"serve_cli sharded: {runs[-1]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"argv": argv, "runs": runs}


def shard_recall(what: str, idx, res, rows_of, queries, k: int) -> dict:
    """Recall of a sharded query against ``live_truth`` (its slots are
    global ids), which must be 1.0, with no dead slot returned."""
    import numpy as np
    truth = live_truth(idx, rows_of, queries, k)
    out = recall_of(what, res.indices, res.values, truth, idx.capacity, k)
    alive = idx.store.alive.cpu().numpy()
    out["dead_slot_hits"] = int((~alive[res.indices]).sum())
    if out["recall"] != 1.0 or out["dead_slot_hits"]:
        raise AssertionError(f"{what}: {out}")
    return out


def sharded_phase(corpus, queries, truth, seed: int, rounds_queries: int
                  ) -> dict:
    """``bmo-nn-dense`` as a sharded index: ``Index.build(shards=SHARDS)``
    with every shard on ``cuda:0`` (the reference places one a device), all
    queries raced (recall 1.0), then each checked on the card: the rounds
    driver on ``rounds_queries`` queries; SHARD_INSERTS inserts and
    SHARD_DELETES deletes through global ids, ``maybe_compact`` and all
    queries; ``live_reshard`` to RESHARD_TO shards, its store bit for bit
    against a save at SHARDS and a load at RESHARD_TO, and all queries;
    ``add_replicas(2)`` with two batches served round-robin; two
    ``Index.race`` sessions through the request plane, one under an
    ``EffortBudget`` and one under a ``Deadline``; ``Index.tune()``; and a
    δ-audit of SHARD_AUDIT_ROWS rows on the exact oracle. Every recall is
    against a float64 brute force over the live rows."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.api import Deadline, EffortBudget, Index
    from repro_torch.configs.bmo_nn import DENSE
    from repro_torch.index.placement import balance
    from repro_torch.kernels.block_pull import block_pull_multi_cuda
    from repro_torch.kernels.fused_race import fused_epoch_pull_cuda
    from repro_torch.kernels.fwht import fwht_cuda
    from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda
    from repro_torch.obs.audit import check_topk
    from repro_torch.serve import RequestPlane

    cfg, k = DENSE.bmo, DENSE.bmo.k
    (n, d), Q = corpus.shape, queries.shape[0]
    dev = corpus.device
    times = {}
    out = {"phase": "sharded", "workload": DENSE.name, "shards": SHARDS,
           "devices": [str(dev)] * SHARDS, "queries": Q, "seed": seed}
    torch.cuda.reset_peak_memory_stats()

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        return result

    def launched(fn):
        """fn's result and its fused_epoch_pull and fwht launches."""
        f0, w0 = fused_epoch_pull_cuda.launches, fwht_cuda.launches
        result = fn()
        return result, {"fused_epoch_pull": fused_epoch_pull_cuda.launches
                        - f0, "fwht": fwht_cuda.launches - w0}

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)
    twins = queries[:SHARD_INSERTS] + 1e-3 * torch.randn(
        (SHARD_INSERTS, d), generator=g, device=dev)
    rows_of = (corpus, twins)                     # payload value → its row

    def run():
        idx = timed("build_s", lambda: Index.build(
            corpus, cfg, seed, shards=SHARDS, device=[dev] * SHARDS))
        # (no reference to a store outlives its step: at most two
        # full-size stores are alive at once)
        stacked = idx.store.stacked_x
        if stacked is None or stacked.shape[0] != SHARDS:
            raise AssertionError("sharded: the shards' rows are not one "
                                 "stacked tensor")
        del stacked
        origin = np.full(idx.capacity, -1, np.int64)
        origin[idx.build_gids] = np.arange(n)
        idx.attach_payload(origin)
        out["stride"] = idx.store.stride
        out["live_per_shard"] = idx.store.live_per_shard
        out["balance"] = balance(out["live_per_shard"])

        res, launches = launched(lambda: timed(
            "query_s", lambda: idx.query(queries, seed, cache="bypass")))
        out["race"] = {
            **shard_recall("sharded race", idx, res, rows_of, queries, k),
            "qps": Q / times["query_s"], "launches": launches,
            "epoch_launches": launches["fused_epoch_pull"] - SHARDS,
            "shard_coord_ops": res.shard_coord_ops,
            "shard_rounds": res.shard_rounds,
            "rounds_mean": float(np.mean(res.rounds)),
            "n_exact_mean": float(np.mean(res.n_exact))}

        Qr = rounds_queries
        b0 = block_pull_multi_cuda.launches
        res = timed("rounds_s", lambda: idx.query(
            queries[:Qr], seed, mode="rounds", cache="bypass"))
        out["rounds"] = {
            **shard_recall("sharded rounds", idx, res, rows_of,
                           queries[:Qr], k),
            "queries": Qr, "qps": Qr / times["rounds_s"],
            "block_pull_multi_launches": block_pull_multi_cuda.launches - b0,
            "shard_rounds": res.shard_rounds}

        gids, launches = launched(lambda: timed("insert_s", lambda: idx.insert(
            twins, payload=n + np.arange(SHARD_INSERTS))))
        r = np.random.default_rng(seed)
        live = np.nonzero(idx.store.alive.cpu().numpy())[0]
        dead = np.concatenate([gids[:SHARD_INSERTS // 4], r.choice(
            np.setdiff1d(live, gids), SHARD_DELETES - SHARD_INSERTS // 4,
            replace=False)])
        timed("delete_s", lambda: idx.delete(dead))
        old = timed("maybe_compact_s", idx.maybe_compact)
        res = timed("query_mutated_s",
                    lambda: idx.query(queries, seed, cache="bypass"))
        out["mutated"] = {
            **shard_recall("sharded, mutated", idx, res, rows_of, queries,
                           k),
            "inserted": SHARD_INSERTS, "deleted": SHARD_DELETES,
            "insert_launches": launches, "compacted": old is not None,
            "live_per_shard": idx.store.live_per_shard,
            "balance": balance(idx.store.live_per_shard),
            "qps": Q / times["query_mutated_s"]}

        need = sum(a.numel() * a.element_size() for s in idx.store.shards
                   for a in s.arrays().values())
        tmp = save_dir(need)
        try:
            path = os.path.join(tmp, "index")
            timed("save_s", lambda: idx.save(path))
            timed("live_reshard_s", lambda: idx.reshard(RESHARD_TO))
            loaded = timed("load_resharded_s", lambda: Index.load(
                path, shards=RESHARD_TO, device=[dev] * RESHARD_TO))
            for a, b in zip(idx.store.shards, loaded.store.shards):
                got, want = a.arrays(), b.arrays()
                if sorted(got) != sorted(want) or a.meta() != b.meta() or \
                        any(not torch.equal(got[k_], want[k_]) for k_ in got):
                    raise AssertionError("sharded: live_reshard differs from "
                                         "save and load at the new count")
            if not np.array_equal(idx.payload, loaded.payload):
                raise AssertionError("sharded: the re-sharded payloads "
                                     "differ")
            del loaded, a, b, got, want
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        res = timed("query_resharded_s",
                    lambda: idx.query(queries, seed, cache="bypass"))
        out["resharded"] = {
            **shard_recall("sharded, re-sharded", idx, res, rows_of,
                           queries, k),
            "shards": idx.n_shards, "stride": idx.store.stride,
            "bit_equal_to_save_and_load": True,
            "qps": Q / times["query_resharded_s"]}

        idx.add_replicas(2)
        rr0 = idx._rr
        half = Q // 2
        for i in range(2):
            res = timed(f"replica_query_{i}_s", lambda: idx.query(
                queries[i * half:(i + 1) * half], seed, cache="bypass"))
            shard_recall(f"sharded, replica batch {i}", idx, res, rows_of,
                         queries[i * half:(i + 1) * half], k)
        out["replicas"] = {"replicas": idx.stats.replicas,
                           "batches_routed": idx._rr - rr0,
                           "placements_shared": idx._replica_stores[1]
                           is idx._replica_stores[0]}
        if idx._rr - rr0 != 2:
            raise AssertionError("sharded: the two batches were not routed "
                                 "round-robin")
        idx.add_replicas(1)

        plane = RequestPlane(idx)
        sessions = {}
        for what, rows, kw in (
                ("effort_budget", slice(0, SHARD_SESSION_ROWS),
                 dict(budget=EffortBudget(epochs=SHARD_BUDGET_EPOCHS))),
                ("deadline", slice(SHARD_SESSION_ROWS,
                                   2 * SHARD_SESSION_ROWS),
                 dict(deadline=Deadline(ms=SHARD_DEADLINE_MS)))):
            q = queries[rows]
            t = time.perf_counter()
            r_ = plane.query(q, **kw)
            seconds = time.perf_counter() - t
            tr = live_truth(idx, rows_of, q, k)
            cert = np.asarray(r_.certified_count)
            ids = np.asarray(r_.indices)
            wrong = sum(not set(ids[i, :c].tolist()) <= set(tr[i].tolist())
                        for i, c in enumerate(cert))
            alive = idx.store.alive.cpu().numpy()
            filled = bool((ids >= 0).all() and (ids < idx.capacity).all())
            sessions[what] = {
                "seconds": seconds, "reason": r_.reason, "epochs": r_.epochs,
                "certified_positions": int(cert.sum()),
                "positions": int(cert.size * k),
                "uncertain_prefixes": wrong,
                "rows_with_a_missing_id": int((ids < 0).any(1).sum()),
                "dead_slot_hits": int((~alive[ids]).sum()) if filled else None,
                "rows_with_a_repeated_id": sum(
                    len(set(r.tolist())) < k for r in ids)}
            s_ = sessions[what]
            want = ("budget",) if what == "effort_budget" else (
                "certified", "deadline")
            if wrong or not filled or s_["dead_slot_hits"] \
                    or s_["rows_with_a_repeated_id"] \
                    or not s_["certified_positions"] or r_.reason not in want:
                raise AssertionError(f"sharded session {what}: {s_}")
        out["sessions"] = sessions

        report = timed("tune_s", lambda: idx.tune(rng=seed))
        res = timed("query_tuned_s", lambda: idx.query(
            queries[:SHARD_TUNED_QUERIES], seed, cache="bypass"))
        out["tune"] = {
            "config": report["config"], "raced": report.get("raced"),
            "winner_median_ms": report.get("winner_median_ms"),
            "default_median_ms": report.get("default_median_ms"),
            "signature_shards": report["signature"]["shards"],
            **shard_recall("sharded, tuned", idx, res, rows_of,
                           queries[:SHARD_TUNED_QUERIES], k),
            "qps": SHARD_TUNED_QUERIES / times["query_tuned_s"]}

        qa = queries[:SHARD_AUDIT_ROWS]
        served = idx.query(qa, seed, cache="bypass")
        check = timed("audit_s", lambda: check_topk(idx.store, qa,
                                                    served.indices, k))
        out["audit"] = {"rows": SHARD_AUDIT_ROWS,
                        "mismatches": check.mismatches}
        if check.mismatches:
            raise AssertionError(f"sharded: {check.mismatches} audited rows "
                                 "mismatched")
        return idx

    idx, launches = counted(
        "sharded", {"fused_epoch_pull": fused_epoch_pull_cuda,
                    "fwht": fwht_cuda,
                    "block_pull_multi": block_pull_multi_cuda,
                    "pairwise_dist": pairwise_dist_cuda}, run)
    del idx
    out.update(times, launches=launches,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def replay_pulls(path: str, x, qs, B: int, P: int, block: int,
                 seed: int) -> list:
    """One launch of a path's pull kernel at the path's own operands,
    outside its counted run: a round's (B random arms a query, P blocks
    each) and the wide init's (every arm, one arange expanded over the
    queries, as the drivers pass it). ``qs`` is one query (``block_pull``,
    the paper box) or a (Q, d) batch (``block_pull_multi``; the init's plain
    version on its first REPLAY_INIT_QUERIES). Arm ids int64, block ids
    int32, as the drivers give them; each held against the plain version at
    the kernel phase's tolerance."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_pull import (block_pull_cuda,
                                                block_pull_multi_cuda)
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    n, nb = x.shape[0], x.shape[1] // block
    one = qs.dim() == 1
    Q = 1 if one else qs.shape[0]
    rows = []
    for case, Bc in (("round", min(B, n)), ("init", n)):
        if case == "round":
            arm = torch.randint(0, n, (Q, Bc), generator=g, device=x.device)
        else:
            arm = torch.arange(n, device=x.device)[None].expand(Q, n)
        blk = torch.randint(0, nb, (Q, Bc, P), generator=g, device=x.device,
                            dtype=torch.int32)
        sub = Q if case == "round" else min(Q, REPLAY_INIT_QUERIES)
        if one:
            got = block_pull_cuda(x, qs, arm[0], blk[0], block=block)[None]
            want = ref.block_pull_ref(x, qs, arm[0], blk[0], block)[None]
        else:
            got = block_pull_multi_cuda(x, qs, arm, blk, block=block)[:sub]
            want = ref.block_pull_multi_ref(x, qs[:sub], arm[:sub],
                                            blk[:sub], block)
        rows.append({
            "kernel": "block_pull" if one else "block_pull_multi",
            "case": f"{path}_{case}",
            "shape": {"Q": Q, "B": Bc, "P": P, "block": block,
                      "d_pad": x.shape[1], "n": n},
            "x_contiguous": x.is_contiguous(),
            **({} if sub == Q else {"plain_checked_on_queries": sub}),
            **compare(f"{path} {case} pull", got, want, rtol=2e-4,
                      atol=1e-5)})
        del got, want, arm, blk
    return rows


def distributed_phase(corpus, queries, truth, seed: int) -> dict:
    """``core.distributed.distributed_knn`` over a 2 × 2 (data × model)
    grid whose four cells are all ``cuda:0``: each data row races half the
    corpus with the per-round driver, every pull averaging one block of
    each half of the columns, the merge on the host's gather. The dense
    box on the raw corpus (the grid splits d, so no rotation); recall 1.0
    against the float64 brute force."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.bmo_nn import DENSE
    from repro_torch.core.distributed import distributed_knn
    from repro_torch.kernels.block_pull import block_pull_multi_cuda

    cfg = dataclasses.replace(DENSE.bmo, rotate=False)
    dev = str(corpus.device)
    grid = [[dev, dev], [dev, dev]]
    Q = queries.shape[0]
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res, launches = counted(
        "distributed", {"block_pull_multi": block_pull_multi_cuda},
        lambda: distributed_knn(corpus, queries, cfg, grid, seed))
    seconds = time.perf_counter() - t
    idx, vals = res.indices.cpu().numpy(), res.values.cpu().numpy()
    out = {"phase": "distributed", "grid": "2 x 2 (data x model)",
           "devices": grid, "queries": Q, "seconds": seconds,
           "qps": Q / seconds,
           **recall_of("distributed", idx, vals, truth, corpus.shape[0],
                       cfg.k),
           "rounds_max": int(res.rounds), "coord_ops": float(res.coord_ops),
           "coord_ops_share_of_nd": float(res.coord_ops)
           / (Q * corpus.shape[0] * corpus.shape[1]),
           "launches": launches,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if out["recall"] != 1.0:
        raise AssertionError(f"distributed: recall {out['recall']}")
    # block_pull_multi at one grid cell's operands: its column part of its
    # data row, and its part of the queries
    n_loc, d_m = corpus.shape[0] // 2, corpus.shape[1] // 2
    out["pull_rows"] = replay_pulls(
        "distributed", corpus[:n_loc, :d_m].contiguous(),
        queries[:, :d_m].contiguous(), cfg.batch_arms, cfg.pulls_per_round,
        cfg.block, seed)
    return out


def kmeans_phase(seed: int, n: int) -> dict:
    """BMO k-means at Fig. 5's configuration (``benchmarks/fig5_kmeans.py``:
    ``clustered_dense(n, 8192, n_clusters=32, noise=0.1, seed=31)``, k 32,
    2 iterations, k = 1 races with block 64, B 8, one pull a round and a
    single-pull init), the points drawn on the card: ``core.kmeans.kmeans``
    (each assignment ``bmo_nn.knn``, one race a point, on ``block_pull``,
    and ``pairwise_dist`` for any arm evaluated exactly), its coord-op gain
    over exact Lloyd and its final assignment's accuracy against
    ``assign_exact`` (``pairwise_dist``) to the final centroids (≥ 0.99,
    the benchmark's measure and ``tests/test_kmeans.py``'s bound)."""
    import torch
    from repro_torch.configs.base import BMOConfig
    from repro_torch.core import kmeans
    from repro_torch.core.datasets import DenseDataset
    from repro_torch.data.synthetic import clustered_dense
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_pull import block_pull_cuda
    from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda

    pts = clustered_dense(n, KMEANS_D, n_clusters=KMEANS_K, noise=0.1,
                          seed=31, device="cuda")
    cfg = BMOConfig(k=1, delta=0.01, block=64, batch_arms=8,
                    pulls_per_round=1, init_pulls=1, metric="l2")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    times = {}

    def run():
        res = kmeans.kmeans(pts, KMEANS_K, KMEANS_ITERS, cfg, seed)
        torch.cuda.synchronize()
        times["kmeans_s"] = time.perf_counter() - t
        return res, kmeans.assign_exact(pts, res.centroids)[0]

    (res, exact), launches = counted(
        "kmeans", {"block_pull": block_pull_cuda,
                   "pairwise_dist": pairwise_dist_cuda}, run)
    seconds = times["kmeans_s"]
    acc = float((res.assignment == exact).float().mean())
    # the path's kernels at its own operands: block_pull over the final
    # centroids (the arms) for one point, and pairwise_dist as the
    # assignment's oracle (every point against the centroids) and as a
    # race's exact evaluation (one point against B centroids)
    ds = DenseDataset.build(res.centroids, block=cfg.block)
    q = ds.pad_query(pts[:1])[0]
    checks = replay_pulls("kmeans", ds.x, q, cfg.batch_arms,
                          cfg.pulls_per_round, cfg.block, seed)
    for case, qq, xx in (("kmeans_assign_exact", pts, res.centroids),
                         ("kmeans_exact_eval", q[None],
                          ds.x[:cfg.batch_arms])):
        allowance = 1e-6 * ((qq ** 2).sum(1)[:, None]
                            + (xx ** 2).sum(1)[None])
        checks.append({
            "kernel": "pairwise_dist", "case": case,
            "shape": {"Q": qq.shape[0], "n": xx.shape[0], "d": xx.shape[1]},
            **compare(f"pairwise_dist {case}", pairwise_dist_cuda(qq, xx),
                      ref.pairwise_dist_ref(qq, xx, "l2"), rtol=1e-4,
                      atol=0.0, allowance=allowance)})
    out = {"phase": "kmeans", "n": n, "d": KMEANS_D, "k": KMEANS_K,
           "iters": KMEANS_ITERS, "seconds": seconds,
           "seconds_per_iteration": seconds / KMEANS_ITERS,
           "coord_ops": float(res.coord_ops),
           "exact_ops": float(res.exact_ops),
           "gain": float(res.exact_ops) / float(res.coord_ops),
           "assignment_accuracy": acc, "launches": launches,
           "kernel_checks": checks,
           "centroids_finite": bool(torch.isfinite(res.centroids).all()),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if acc < 0.99 or not out["centroids_finite"]:
        raise AssertionError(f"kmeans: {out}")
    return out


def traced_query(idx, queries, seed: int) -> dict:
    """One more query under torch.profiler, past the query cache that the
    query before filled: device time by kernel and the device's idle share
    of the query's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        idx.query(queries, seed, cache="bypass")
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = kernel_breakdown(prof)
    busy = sum(r["device_ms"] for r in rows)
    ours = [r for r in rows
            if "fused_epoch_pull" in r["name"] or "fwht_kernel" in r["name"]]
    # fused_epoch_pull's launches in the order they ran: the first is the
    # wide init, the rest the epochs
    pulls = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and "fused_epoch_pull" in ev.name)
    init = pulls[0] if pulls else None
    epochs = [(t1 - t0) / 1e3 for t0, t1, _ in pulls[1:]]
    split = {"init_device_ms": (init[1] - init[0]) / 1e3 if init else None,
             "init_kernel": init[2] if init else None,
             "epochs": len(epochs), "epochs_device_ms": sum(epochs),
             "epoch_device_ms_max": max(epochs, default=None)}
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            "fused_epoch_pull": split, "port_kernels": ours,
            "top": rows[:15]}


def traced_build(corpus, cfg, seed: int) -> dict:
    """``Index.build`` once more under torch.profiler (the timed build is
    not traced): device time by kernel name, the five largest, and the
    device's idle share of its wall time. The allocator keeps the build's
    freed blocks cached, as it does after the timed build, so the oracle
    phase that follows allocates as it did before this trace was added."""
    from repro_torch.api import Index
    wall_ms, rows = profiled(lambda: Index.build(corpus, cfg, seed))
    busy = sum(r["device_ms"] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            "top": rows[:5]}


# name, source, the TPU kernel it replaces, the paths that launch it; the
# summary takes each kernel's first kernel-phase row (its path's per-call
# shape) and the launches of its paths
# the train phase: (arch, layers, steps) at full width, each on its
# published plan, over batches of TRAIN_BATCH × TRAIN_SEQ tokens
TRAIN_RUNS = (("qwen2.5-14b", 4, 3), ("dbrx-132b", 4, 2))
TRAIN_BATCH = 8
TRAIN_SEQ = 4096
# a run whose peak passes this many GB is cut to TRAIN_CUT_LAYERS layers
TRAIN_PEAK_CUT_GB = 75.0
TRAIN_CUT_LAYERS = 2
# grad accumulation 4 against 1 on one batch of 4 × 1,024 (qwen2.5-14b,
# bf16 compute, no clip): the relative L2 difference of the two steps'
# moves, and the relative gaps of their loss and gradient norm (2.3e-4,
# 7.7e-8 and 1.1e-7 on an H100 80GB HBM3 at 700 W; a missing 1/ga puts
# the norms 3.0 apart, a dropped microbatch 0.13: PERF.md §6)
TRAIN_GA_BATCH = (4, 1024)
TRAIN_GA_L2 = 1e-3
TRAIN_GA_METRICS = {"loss": 1e-6, "grad_norm": 1e-6}
# one SMOKE step on the card against the CPU in fp32: every leaf within
# this share of its largest entry; the metrics at these relative
# tolerances (the gradients' norm sums 82 leaves' squares in another
# order on each side: 1.9e-5 apart on an H100 80GB HBM3 at 700 W)
TRAIN_SMOKE_REL = 1e-4
TRAIN_SMOKE_METRICS = {"loss": 1e-5, "grad_norm": 1e-4, "lr": 0.0}
# the training CLI's two runs: steps, batch, sequence, checkpoint period,
# the failure's step
TRAIN_CLI = dict(steps=8, batch=4, seq=64, every=3, fail_at=5)


def sync(device: str) -> None:
    """Wait for the card (nothing to wait for on the CPU, where the train
    phase's functions rehearse at SMOKE size)."""
    import torch
    if device != "cpu":
        torch.cuda.synchronize()


@contextlib.contextmanager
def train_timer(times: dict, device: str):
    """Splits a train step at its clip (``train.steps``' call of
    ``clip_by_global_norm``, after the last backward): ``times["grads"]``,
    the seconds from the step's start to the end of its backward passes,
    synchronized; the update is the rest of the step."""
    from repro_torch.train import steps
    real = steps.clip_by_global_norm

    def clip(grads, max_norm):
        sync(device)
        times["grads"] = time.perf_counter() - times["start"]
        return real(grads, max_norm)

    steps.clip_by_global_norm = clip
    try:
        yield
    finally:
        steps.clip_by_global_norm = real


@contextlib.contextmanager
def dropped_counter(counts: dict):
    """Counts the (token, expert) pairs each MoE dispatch drops, on the
    device (no sync): ``counts["dropped"]`` and ``counts["pairs"]`` over
    ``counts["calls"]`` dispatches (forwards and their recomputations)."""
    from repro_torch.models import moe
    real = moe.dispatch_indices

    def counted(expert_ids, E, cap):
        dest, order, keep = real(expert_ids, E, cap)
        counts["dropped"] = counts.get("dropped", 0) + (~keep).sum()
        counts["pairs"] = counts.get("pairs", 0) + keep.numel()
        counts["calls"] = counts.get("calls", 0) + 1
        return dest, order, keep

    moe.dispatch_indices = counted
    try:
        yield
    finally:
        moe.dispatch_indices = real


def train_run(arch: str, layers: int, steps: int, seed: int,
              device: str = "cuda", smoke: bool = False,
              shape=(TRAIN_BATCH, TRAIN_SEQ)) -> dict:
    """One architecture's run of the train phase: the model at full width
    (the SMOKE config with ``smoke``, to rehearse on the CPU) cut to
    ``layers``, on its published plan on one card, ``steps`` steps of
    ``shape`` (TRAIN_BATCH × TRAIN_SEQ) tokens from ``ShardedLoader``."""
    import dataclasses
    import torch
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.models import build_model
    from repro_torch.train.steps import (DTYPES, init_train_state,
                                         make_train_step)
    entry = get_arch(arch)
    cfg = dataclasses.replace(entry.smoke if smoke else entry.config,
                              n_layers=layers)
    plan = dataclasses.replace(entry.plan, fsdp=False, tp=False, sp=False,
                               ep=False)
    tcfg = TrainConfig(total_steps=steps, warmup_steps=1, seed=seed)
    cuda = device != "cpu"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = build_model(cfg, param_dtype=DTYPES[plan.param_dtype],
                        device=device, rng=seed)
    state = init_train_state(model, plan, tcfg, seed)
    sync(device)
    out = {"arch": arch, "n_layers": layers, "plan": dataclasses.asdict(plan),
           "init_s": time.perf_counter() - t,
           "params": sum(p.numel() for p in model.parameters()),
           "param_gb": sum(p.numel() * p.element_size()
                           for p in model.parameters()) / 1e9,
           "state_gb": torch.cuda.memory_allocated() / 1e9 if cuda else 0.0,
           "tokens_a_step": shape[0] * shape[1], "steps": []}
    step_fn = make_train_step(model, plan, tcfg)
    loader = ShardedLoader(cfg.vocab_size, *shape, seed=seed, device=device)
    counts = {}

    def moe_ctx():
        return (dropped_counter(counts) if cfg.family == "moe"
                else contextlib.nullcontext())

    for step in range(steps):
        batch = loader.get(step)
        times = {}
        with train_timer(times, device), moe_ctx():
            sync(device)
            times["start"] = time.perf_counter()
            state, metrics = step_fn(state, batch)
            sync(device)
            total = time.perf_counter() - times["start"]
        row = {"step": step, "s": total, "grads_s": times["grads"],
               "update_s": total - times["grads"],
               "tokens_per_s": out["tokens_a_step"] / total,
               **{k: float(v) for k, v in metrics.items()}}
        if counts:
            row["dropped_pairs"] = int(counts.pop("dropped"))
            row["routed_pairs"] = int(counts.pop("pairs"))
            row["dispatches"] = counts.pop("calls")
            row["dropped_share"] = row["dropped_pairs"] / row["routed_pairs"]
        out["steps"].append(row)
        if not math.isfinite(row["loss"]) or not math.isfinite(
                row["grad_norm"]):
            raise RuntimeError(f"train {arch}: step {step} is not finite: "
                               f"{row}")
    timed = out["steps"][1:] or out["steps"]
    out["s_a_step"] = sum(r["s"] for r in timed) / len(timed)
    out["tokens_per_s"] = out["tokens_a_step"] / out["s_a_step"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    out["steps_timed"] = "after the first" if len(out["steps"]) > 1 \
        else "the only one"
    del state, model, step_fn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def train_ga_check(seed: int, device: str = "cuda", smoke: bool = False,
                   shape=TRAIN_GA_BATCH) -> dict:
    """Grad accumulation 4 against 1: qwen2.5-14b at full width cut to 4
    layers, its plan (fp32 parameters, bf16 compute, remat full) with SGD
    at lr 1, no warm-up and no clip, so that each step moves the
    parameters by the gradient itself (AdamW's first step is lr·g/|g|,
    whose signs flip on gradients near zero, and a clip to a norm far
    below the gradient's would hide the gradient's scale), from the same
    seed-drawn parameters, one step on one TRAIN_GA_BATCH batch each.
    Held: the relative L2 between the two steps' moves, within
    TRAIN_GA_L2, and the loss and grad_norm within TRAIN_GA_METRICS.
    ``smoke``, ``device`` and ``shape``: a rehearsal on the CPU."""
    import dataclasses
    import torch
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.models import build_model
    from repro_torch.train.steps import init_train_state, make_train_step
    entry = get_arch("qwen2.5-14b")
    cfg = dataclasses.replace(entry.smoke if smoke else entry.config,
                              n_layers=4)
    plan = dataclasses.replace(entry.plan, fsdp=False, tp=False, sp=False,
                               ep=False, optimizer="sgd")
    tcfg = TrainConfig(lr=1.0, warmup_steps=0, total_steps=1, seed=seed,
                       grad_clip=float("inf"))
    model = build_model(cfg, device=device, rng=seed)
    B, S = shape
    batch = ShardedLoader(cfg.vocab_size, B, S, seed=seed,
                          device=device).get(0)
    moved, metrics = {}, {}
    for ga in (1, 4):
        state = init_train_state(model, plan, tcfg, seed)
        if ga == 4:
            with torch.no_grad():
                base = sum(float(torch.sum((moved[n] - p.float()) ** 2))
                           for n, p in state["params"].items())
        state, m = make_train_step(model, plan, tcfg, grad_accum=ga)(
            state, batch)
        metrics[ga] = {k: float(v) for k, v in m.items()}
        if ga == 1:
            moved = {n: p.detach().float().clone()
                     for n, p in state["params"].items()}
    with torch.no_grad():
        diff = sum(float(torch.sum((p.float() - moved[n]) ** 2))
                   for n, p in model.named_parameters())
    l2 = (diff / base) ** 0.5
    gaps = {k: abs(metrics[4][k] - metrics[1][k]) / abs(metrics[1][k])
            for k in TRAIN_GA_METRICS}
    out = {"batch": list(shape), "metrics_ga1": metrics[1],
           "metrics_ga4": metrics[4], "move_rel_l2": l2,
           "tolerance": TRAIN_GA_L2, "metric_rel_gaps": gaps,
           "metric_tolerances": TRAIN_GA_METRICS}
    if not (l2 <= TRAIN_GA_L2
            and all(gaps[k] <= t for k, t in TRAIN_GA_METRICS.items())):
        raise RuntimeError(f"train: grad accumulation 4 against 1: {out}")
    del model, moved
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return out


def train_smoke_check(seed: int, device: str = "cuda") -> dict:
    """One qwen2.5-14b SMOKE step (AdamW, fp32 parameters and compute,
    grad accumulation 2, 8 × 64 tokens) on the card against the same step
    on the CPU, from parameters drawn on the CPU from ``seed`` and copied
    to the card, AdamW's v set to 0.01 on both (so the step is linear in
    the gradient): loss, grad_norm and lr (TRAIN_SMOKE_METRICS), and
    every parameter and optimizer leaf within TRAIN_SMOKE_REL of its
    largest entry. With
    ``device="cpu"`` (a rehearsal) the CPU against itself."""
    import dataclasses
    import torch
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.models import build_model
    from repro_torch.train.steps import init_train_state, make_train_step
    entry = get_arch("qwen2.5-14b")
    plan = dataclasses.replace(entry.plan, fsdp=False, tp=False, sp=False,
                               ep=False, grad_accum=2, compute_dtype="float32")
    tcfg = TrainConfig(lr=1e-3, warmup_steps=0, total_steps=4)
    runs, drawn = {}, None
    for side, dev in (("cpu", "cpu"), ("card", device)):
        model = build_model(entry.smoke, device=dev, rng=seed)
        state = init_train_state(model, plan, tcfg, seed)
        with torch.no_grad():
            if drawn is None:
                drawn = {n: p.detach().clone()
                         for n, p in state["params"].items()}
            for n, p in state["params"].items():
                p.copy_(drawn[n])
            for v in state["opt"]["v"].values():
                v.fill_(0.01)
        batch = ShardedLoader(entry.smoke.vocab_size, 8, 64, seed=seed,
                              device=dev).get(0)
        runs[side] = make_train_step(model, plan, tcfg)(state, batch)
    want, wmet = runs["cpu"]
    got, gmet = runs["card"]
    worst = {}
    leaves = [(f"params/{n}", p, want["params"][n])
              for n, p in got["params"].items()]
    leaves += [(f"opt/{k}/{n}", t, want["opt"][k][n])
               for k in ("m", "v") for n, t in got["opt"][k].items()]
    for name, g, w in leaves:
        w = w.detach().float()
        err = float((g.detach().float().cpu() - w).abs().max())
        worst[name] = err / max(float(w.abs().max()), 1e-30)
    out = {"metrics_card": {k: float(v) for k, v in gmet.items()},
           "metrics_cpu": {k: float(v) for k, v in wmet.items()},
           "worst_leaf": max(worst, key=worst.get),
           "worst_rel": max(worst.values()), "tolerance": TRAIN_SMOKE_REL}
    for k, rtol in TRAIN_SMOKE_METRICS.items():
        a, b = out["metrics_card"][k], out["metrics_cpu"][k]
        if not abs(a - b) <= rtol * abs(b):
            raise RuntimeError(f"train: SMOKE step {k} {a} on the card, {b} "
                               "on the CPU")
    if not out["worst_rel"] <= TRAIN_SMOKE_REL:
        raise RuntimeError(f"train: SMOKE step on the card against the CPU: "
                           f"{out}")
    return out


def train_cli_restart(device: str = "cuda") -> dict:
    """``python -m repro_torch.launch.train`` at ``--smoke`` on the card,
    called through ``main`` twice in a process of its own that sets
    ``CUBLAS_WORKSPACE_CONFIG`` before any CUDA work and runs under
    ``torch.use_deterministic_algorithms(True)`` throughout
    (``train_cli_restart_child``): uninterrupted, and with ``--fail-at``
    after a checkpoint. The final checkpoints must hold the same bits."""
    import json
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            f"chip_smoke.train_cli_restart_child({device!r})")
    t = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t
    if child.returncode != 0:
        raise RuntimeError(f"train: the CLI restart's process exited "
                           f"{child.returncode}: {child.stderr[-2000:]}")
    out = json.loads(child.stdout.strip().splitlines()[-1])
    out["process_s"] = seconds
    if out["leaves_differ"] or not out["same_leaves"] or \
            out["clean"]["loss"] != out["faulty"]["loss"]:
        raise RuntimeError(f"train: the CLI's restart is not the clean run's "
                           f"bits: {out}")
    return out


def train_cli_restart_child(device: str) -> None:
    """The body of ``train_cli_restart``, in its own process: prints its
    result as one JSON line."""
    import json
    import shutil
    import tempfile
    import numpy as np
    import torch
    torch.use_deterministic_algorithms(True)
    from repro_torch.checkpoint import load_arrays
    from repro_torch.launch import train as train_cli
    c = TRAIN_CLI
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    args = ["--arch", "qwen2.5-14b", "--smoke", "--steps", str(c["steps"]),
            "--batch", str(c["batch"]), "--seq", str(c["seq"]),
            "--ckpt-every", str(c["every"]), "--log-every", "1000",
            "--device", device]
    try:
        t = time.perf_counter()
        clean = train_cli.main(args + ["--ckpt-dir",
                                       os.path.join(root, "clean")])
        faulty = train_cli.main(args + ["--ckpt-dir",
                                        os.path.join(root, "faulty"),
                                        "--fail-at", str(c["fail_at"])])
        seconds = time.perf_counter() - t
        last = f"step_{c['steps'] - 1:08d}"
        a = load_arrays(os.path.join(root, "clean", last))
        b = load_arrays(os.path.join(root, "faulty", last))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    differ = sorted(k for k in a if not np.array_equal(a[k], b.get(k)))
    print(json.dumps({
        "args": args, "fail_at": c["fail_at"], "leaves": len(a),
        "same_leaves": set(a) == set(b), "leaves_differ": differ,
        "clean": clean, "faulty": faulty, "seconds": seconds,
        "deterministic": torch.are_deterministic_algorithms_enabled(),
        "cublas_workspace_config": os.environ.get(
            "CUBLAS_WORKSPACE_CONFIG")}), flush=True)


def train_phase(seed: int) -> dict:
    """The training path on the card (see the module docstring, item 11):
    ``train_run`` for each of TRAIN_RUNS (dbrx cut to TRAIN_CUT_LAYERS
    layers, with a ``cut`` line, if its peak passes TRAIN_PEAK_CUT_GB or
    the card runs out of memory), ``train_ga_check``,
    ``train_smoke_check`` and ``train_cli_restart``."""
    import torch
    t = time.perf_counter()
    runs = []
    for arch, layers, steps in TRAIN_RUNS:
        try:
            run = train_run(arch, layers, steps, seed)
            over = run["peak_gb"] > TRAIN_PEAK_CUT_GB
        except torch.cuda.OutOfMemoryError as e:
            run, over = {"error": str(e).splitlines()[0]}, True
        if over:
            # after the except block, so its traceback's tensors are gone
            gc.collect()
            torch.cuda.empty_cache()
            emit({"cut": f"train: {arch} cut to {TRAIN_CUT_LAYERS} layers: "
                         f"at {layers} it peaked past {TRAIN_PEAK_CUT_GB} GB "
                         f"({run.get('peak_gb', run.get('error'))})"})
            run = train_run(arch, TRAIN_CUT_LAYERS, steps, seed)
        runs.append(run)
        emit({"train_run": arch, **{k: v for k, v in run.items()
                                    if k != "plan"}})
    out = {"phase": "train", "runs": runs, "ga_check": train_ga_check(seed)}
    emit({"train_check": "ga", **out["ga_check"]})
    out["smoke_check"] = train_smoke_check(seed)
    emit({"train_check": "smoke_cuda_vs_cpu", **out["smoke_check"]})
    out["cli"] = train_cli_restart()
    emit({"train_check": "cli_restart",
          **{k: v for k, v in out["cli"].items() if k != "args"}})
    out["seconds"] = time.perf_counter() - t
    return out


# ---------------------------------------------------------------------------
# 12. plans: the multi-device plans as ranks of a torch.distributed group
# ---------------------------------------------------------------------------

PLANS_ARCH = "qwen2.5-14b"
# serve: batch, prompt length, teacher-forced decode steps; layers kept
PLANS_SERVE = (4, 512, 16)
PLANS_SERVE_LAYERS = 4
# the cache-free tp forward through flash_attention: batch, length, and
# the layers kept (one: the random-weight model's depth amplifies bf16
# rounding of the row-parallel partial sums, as the serve check shows)
PLANS_FLASH = (2, 512)
PLANS_FLASH_LAYERS = 1
# train: layers kept (1, a cut from 2, and grad accumulation 1, a cut from
# 2, to keep the phase near 120 s: each layer and each microbatch gathers
# the FSDP-split fp32 weights again, forward and recomputed, through host
# memory), batch × length, sampled entries
PLANS_TRAIN_LAYERS = 1
PLANS_TRAIN_SHAPE = (4, 1024)
PLANS_TRAIN_GA = 1
# the step's compute types, each held against one rank's step in the same
# type: fp32, where the orders of the sharded sums are all that differ, and
# the published bf16 (see plans_phase)
PLANS_TRAIN_COMPUTES = ("float32", "bfloat16")
# each step's limits against one rank's step in its type. On an H100 80GB
# HBM3 at 700 W (PERF.md): fp32 loss 9.5e-7 apart, grad_norm 1.8e-6
# relative, m 3.3e-4 relative L2, where the control (half the batch) is at
# 0.35 and 0.75; bf16 loss 3.6e-5, grad_norm 8.1e-3, m 0.52, while one
# rank's bf16 step is itself 0.74 from its fp32 step in m (bf16 rounding of
# the step's gradients, beyond the control's reach): m is held in fp32 only
PLANS_TRAIN_LIMITS = {
    "float32": {"loss_abs": 1e-4, "grad_norm_rel": 1e-4, "m_rel_l2": 1e-2,
                "params_max_abs_err": 0.0},
    "bfloat16": {"loss_abs": 1e-3, "grad_norm_rel": 5e-2,
                 "params_max_abs_err": 0.0}}
PLANS_SAMPLES = 65_536
# EP: dbrx-132b's first MoE layer, tokens (batch × length)
PLANS_EP_TOKENS = (4, 512)
# pipeline: stages × layers a stage, microbatches of (1, length)
PLANS_PIPE = (2, 2, 4, 512)
# compress: gradient elements; elastic: xlstm-350m cut to layers, tokens
PLANS_COMPRESS = 1 << 26
PLANS_ELASTIC = ("xlstm-350m", 2, (2, 32))
# the direct probe: pairs of ranks on cuda:0, each pair a backend's own
# group (no staging) and the collectives it tries, in order; a collective
# that kills its rank ends its pair's list, so the two that have killed
# one on an H100 with PyTorch 2.11 (gloo's send of a CUDA tensor; a bf16
# all-gather inside DTensor) each come last in a pair (PERF.md)
PLANS_DIRECT = (
    ("gloo", ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
              "all_to_all_single", "broadcast", "all_gather_bf16_large")),
    ("gloo", ("send_recv",)),
    ("nccl", ("all_reduce",)))


def plans_cfg(arch: str, layers: int, smoke: bool, **kw):
    import dataclasses
    from repro_torch.configs import get_arch
    entry = get_arch(arch)
    base = entry.smoke if smoke else entry.config
    return dataclasses.replace(base, n_layers=layers, **kw)


def plans_free(cuda: bool) -> None:
    """Drop what this process's allocator holds on the card."""
    import torch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def plans_sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def plans_serve_run(model, tokens, prompt: int, plan=None, mesh=None,
                    compute=None):
    """Prefill of ``prompt`` tokens, teacher-forced decode of the rest:
    (the (B, steps, V) fp32 logits on the host, prefill s, decode ms a
    step). ``compute``: the serving steps' type, and the cache's (default
    bf16)."""
    import torch
    import repro_torch.serve.steps as steps
    compute = compute or torch.bfloat16
    was, steps.COMPUTE_DTYPE = steps.COMPUTE_DTYPE, compute
    try:
        return _plans_serve_run(model, tokens, prompt, plan, mesh, compute)
    finally:
        steps.COMPUTE_DTYPE = was


def _plans_serve_run(model, tokens, prompt, plan, mesh, compute):
    import torch
    from repro_torch.serve.steps import (init_cache, make_decode_step,
                                         make_prefill_step)
    B, S = tokens.shape
    device = tokens.device
    cache = init_cache(model, B, S + 1, dtype=compute, device=device,
                       mesh=mesh, plan=plan)
    pre = make_prefill_step(model, plan, mesh)
    dec = make_decode_step(model, plan, mesh)
    plans_sync(device)
    t = time.perf_counter()
    logits, cache = pre({"tokens": tokens[:, :prompt]}, cache)
    plans_sync(device)
    prefill_s = time.perf_counter() - t
    out = [logits.float().cpu()]
    t = time.perf_counter()
    for i in range(prompt, S):
        _, logits, cache = dec(cache, tokens[:, i:i + 1])
        out.append(logits.float().cpu())
    plans_sync(device)
    decode_ms = (time.perf_counter() - t) * 1e3 / max(S - prompt, 1)
    return torch.cat(out, dim=1), prefill_s, decode_ms


def plans_tokens(cfg, shape, seed: int, device):
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, shape, generator=g).to(device)


def plans_samples(params: dict, seed: int) -> dict:
    """{leaf: (flat indices, values, L2 norm)}: PLANS_SAMPLES entries of each
    leaf drawn from ``seed`` (every entry of a smaller leaf), on the host:
    what the ranks hold their gathered leaves to, without moving the
    one-rank state between processes."""
    import torch
    out = {}
    for i, (n, p) in enumerate(sorted(params.items())):
        flat = p.detach().reshape(-1)
        if flat.numel() <= PLANS_SAMPLES:
            idx = torch.arange(flat.numel(), device=flat.device)
        else:
            g = torch.Generator(device="cpu").manual_seed(seed + i)
            idx = torch.randint(0, flat.numel(), (PLANS_SAMPLES,),
                                generator=g).to(flat.device)
        out[n] = (idx.cpu(), flat[idx].float().cpu(),
                  float(torch.linalg.vector_norm(flat.float())))
    return out


def plans_local_samples(t, flat_idx):
    """(the entries of DTensor ``t`` at the flat global indices
    ``flat_idx`` that lie in this rank's shard, fp32 on the host; the mask
    of those indices), with no collective."""
    import torch
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    coords = torch.stack(torch.unravel_index(flat_idx, tuple(t.shape)))
    off = torch.tensor(offset)[:, None]
    size = torch.tensor(shape)[:, None]
    local = coords - off
    keep = ((local >= 0) & (local < size)).all(dim=0)
    loc = t.to_local()
    got = loc[tuple(local[:, keep].to(loc.device))] if keep.any() else \
        loc.new_zeros((0,))
    return got.float().cpu(), keep


def plans_train_plan(compute: str):
    """qwen2.5-14b's published plan at PLANS_TRAIN_GA, computing in
    ``compute``."""
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(PLANS_ARCH).plan,
                               grad_accum=PLANS_TRAIN_GA,
                               compute_dtype=compute)


def plans_train_batch(cfg, seed: int, device):
    from repro_torch.data.loader import ShardedLoader
    return ShardedLoader(cfg.vocab_size, *PLANS_TRAIN_SHAPE, seed=seed,
                         device=device).get(0)


def plans_ranks_two(rank, world, seed, smoke, serve_tokens, flash_tokens,
                    ep_x, ckpt_dir):
    """Two ranks on one device: tp serving and the tp cache-free forward
    through flash_attention (1 × 2), dbrx's EP layer (1 × 2), the GPipe
    schedule (2 stages), the collective probe, and the elastic run's
    second half (the four ranks' checkpoint resumed on 1 × 2)."""
    import torch
    import torch.distributed as dist
    from repro_torch import dist as rdist
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attn import flash_attention_cuda
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import context as sctx
    from repro_torch.sharding.place import draw_sharded
    from repro_torch.sharding.spec import param_pspecs, rules_for
    device = rdist.rank_device()
    out = {"probe": plans_probe(device)}
    plans_note("probe")
    mesh = make_host_mesh(1, 2)
    plan = get_arch(PLANS_ARCH).plan
    rules = rules_for(plan, mesh)
    cfg = plans_cfg(PLANS_ARCH, PLANS_SERVE_LAYERS, smoke,
                    attn_impl="pallas")
    model = build_model(cfg, param_dtype=torch.bfloat16, device="meta")
    draw_sharded(model, seed, param_pspecs(model, rules), mesh)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    logits, pre_s, dec_ms = plans_serve_run(
        model, serve_tokens.to(device), PLANS_SERVE[1], plan, mesh)
    out["serve"] = {"logits": logits, "prefill_s": pre_s,
                    "decode_ms_a_step": dec_ms}
    # again, each layer's input and output recorded (whole) for the
    # teacher-forced replay on one rank
    calls = []

    def record(module, args, kwargs, output):
        calls.append((layer_ids[id(module)], plans_whole(args[0]),
                      plans_whole(output)))

    layer_ids = {id(m): i for i, m in enumerate(model.layers)}
    hooks = [m.register_forward_hook(record, with_kwargs=True)
             for m in model.layers]
    try:
        plans_serve_run(model, serve_tokens.to(device), PLANS_SERVE[1],
                        plan, mesh)
    finally:
        for h in hooks:
            h.remove()
    out["serve"]["calls"] = calls if dist.get_rank() == 0 else None
    plans_note("serve")
    del model
    cfg = plans_cfg(PLANS_ARCH, PLANS_FLASH_LAYERS, smoke,
                    attn_impl="pallas")
    model = build_model(cfg, param_dtype=torch.bfloat16, device="meta")
    draw_sharded(model, seed, param_pspecs(model, rules), mesh)
    # the cache-free forward under tp: each rank's flash_attention on its
    # own heads, counted from 0 just before and read just after
    for attr in ("launches", "launches_tc", "launches_cc"):
        setattr(flash_attention_cuda, attr, 0)
    with torch.no_grad(), sctx.activation_sharding(rules, mesh):
        from repro_torch.train.steps import place_batch
        lg, _ = model(place_batch({"tokens": flash_tokens.to(device)}, rules,
                                  mesh), remat="none",
                      compute_dtype=torch.bfloat16)
        lg = lg.full_tensor().float().cpu()
    counts = {"launches": flash_attention_cuda.launches,
              "tensor_cores": flash_attention_cuda.launches_tc,
              "cuda_cores": flash_attention_cuda.launches_cc}
    out["flash"] = {"logits": lg, "launches_by_rank": gather(counts),
                    "local_heads": (cfg.n_heads // 2, cfg.n_kv_heads // 2)}
    del model
    plans_note("tp_forward")
    out["ep"] = plans_ep_ranks(seed, smoke, ep_x, device)
    plans_note("ep")
    out["pipeline"] = plans_pipeline_ranks(seed, smoke, device)
    plans_note("pipeline")
    out["peak_gb_by_rank"] = gather(
        torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda"
        else 0.0)
    out["elastic"] = plans_elastic(seed, smoke, ckpt_dir, range(2, 4),
                                   save=False)
    out["staged"] = gather(rdist.staged_bytes())
    return out


def plans_whole(t):
    """A DTensor gathered whole (every rank calls it), on the host."""
    from repro_torch.sharding import context as sctx
    return sctx.replicated(t).detach().cpu()


def plans_teacher_forced(model, calls, logits, prompt: int) -> dict:
    """Every call of every layer on the tp ranks' cache path (``calls``: the
    prefill's, then each decode step's, in order) replayed on one rank on
    the ranks' own inputs, each layer with its own cache filled by the
    replay; its output held to the ranks' by relative L2, and the head on
    the ranks' last layer output to their logits (the serve phase's
    teacher forcing: free-running bf16 runs of the random-weight model
    decorrelate in depth, as the whole logits show)."""
    import torch
    from repro_torch.models import common as cm
    from repro_torch.serve.steps import init_cache
    L = len(model.layers)
    B = calls[0][1].shape[0]
    steps = len(calls) // L
    device = model.device
    cache = init_cache(model, B, prompt + steps, device=device)
    layer_gaps, head_gaps = [], []

    def rel(a, b):
        return float((a.float() - b.float()).norm()
                     / b.float().norm().clamp(min=1e-30))

    with torch.no_grad():
        for c in range(steps):
            S = prompt if c == 0 else 1
            index = 0 if c == 0 else prompt + c - 1
            positions = (torch.arange(S, device=device) + index)[None].expand(
                B, S)
            for li, x_in, x_out in calls[c * L:(c + 1) * L]:
                got = model.layers[li](
                    x_in.to(device), positions, torch.bfloat16, "auto",
                    cache_kv=(cache["k"][li], cache["v"][li]),
                    cache_index=index)
                layer_gaps.append(rel(got.cpu(), x_out))
            h = cm.rmsnorm(x_out.to(device), model.final_norm,
                           model.cfg.norm_eps)
            head = model.embed.lm_head(h[:, -1:], torch.bfloat16)
            head_gaps.append(rel(head.float().cpu()[:, 0], logits[:, c]))
    return {"layer_rel_l2_max": max(layer_gaps),
            "layer_rel_l2_prefill": layer_gaps[:L],
            "layer_rel_l2_decode_max": max(layer_gaps[L:] or [0.0]),
            "head_rel_l2_max": max(head_gaps), "layers": L,
            "calls": len(layer_gaps)}


def plans_note(what: str) -> None:
    """A rank's progress on stderr (a rank that dies shows how far it
    got)."""
    import torch.distributed as dist
    print(json.dumps({"plans_rank": dist.get_rank(), "done": what,
                      "at_s": time.perf_counter() - T0}), file=sys.stderr,
          flush=True)


def gather(obj):
    import torch.distributed as dist
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return got


def plans_collectives(device, w: int, r: int) -> list:
    """(name, check) for each collective the slice uses, on tensors of
    ``device`` through the default group of ``w`` ranks (this one ``r``):
    each check runs its collective and says whether the result is right."""
    import torch
    import torch.distributed as dist

    def ar():
        x = torch.full((1024,), float(r + 1), device=device,
                       dtype=torch.bfloat16)
        dist.all_reduce(x)
        return float(x[0]) == w * (w + 1) / 2

    def ag(n=16, dtype=torch.float32):
        y = torch.empty(w * n, device=device, dtype=dtype)
        dist.all_gather_into_tensor(y, torch.full(
            (n,), float(r), device=device, dtype=dtype))
        return all(float(y[i * n]) == i for i in range(w))

    def rs():
        y = torch.empty(16, device=device)
        dist.reduce_scatter_tensor(y, torch.ones(w * 16, device=device))
        return float(y[0]) == w

    def a2a():
        y = torch.empty(w * 4, device=device)
        dist.all_to_all_single(y, torch.full((w * 4,), float(r),
                                             device=device))
        return all(float(y[i * 4]) == i for i in range(w))

    def bc():
        x = torch.full((16,), float(r), device=device)
        dist.broadcast(x, 0)
        return float(x[0]) == 0.0

    def sr():
        x = torch.full((16,), float(r), device=device)
        if r == 0:
            dist.send(x, 1)
        elif r == 1:
            dist.recv(x, 0)
            return float(x[0]) == 0.0
        return True

    return [("all_reduce", ar), ("all_gather_into_tensor", ag),
            ("reduce_scatter_tensor", rs), ("all_to_all_single", a2a),
            ("broadcast", bc),
            # a sequence-split activation of the tp forward, as DTensor
            # gathers it (4 × 256 × 5,120 in bf16)
            ("all_gather_bf16_large",
             functools.partial(ag, 4 * 256 * 5120, torch.bfloat16)),
            ("send_recv", sr)]


def plans_probe(device) -> dict:
    """Each collective of ``plans_collectives`` through the ranks' group,
    checked. On the card that group stages every collective through pinned
    host memory (``repro_torch.dist.StagedGroup``; ``plans_direct_*`` try
    the backends' own groups in the same run); on the CPU it is gloo's."""
    import torch.distributed as dist
    how = ("staged through pinned host memory" if device.type == "cuda"
           else "gloo")
    res = {}
    for name, fn in plans_collectives(device, dist.get_world_size(),
                                      dist.get_rank()):
        try:
            res[name] = how if fn() else "wrong"
        except Exception as e:          # reported, and the phase fails
            res[name] = f"error: {str(e).splitlines()[0][:120]}"
    return res


def plans_direct_rank(rank: int, world: int, store_dir: str, backend: str,
                      which: tuple) -> None:
    """A rank of the direct probe on ``cuda:0``: the collectives ``which``
    of ``plans_collectives`` through ``backend``'s own group, no staging.
    Each is written to the rank's file as it starts and as it ends, so one
    that kills the process is still named."""
    import datetime
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    log = open(os.path.join(store_dir, f"rank{rank}.jsonl"), "a")

    def note(name, what):
        log.write(json.dumps([name, what]) + "\n")
        log.flush()

    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(store_dir, "store"),
                                          world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=10))
        for name, fn in plans_collectives(dev, world, rank):
            if name in which:
                note(name, "started")
                try:
                    ok = fn()
                    torch.cuda.synchronize()
                    note(name, "ok" if ok else "wrong")
                except Exception as e:
                    note(name, f"error: {str(e).splitlines()[0][:120]}")
    except Exception as e:
        note("init", f"error: {str(e).splitlines()[0][:120]}")
    finally:
        log.close()
        # no teardown: a failed group's can hang
        os._exit(0)


def plans_direct_start():
    """The pairs of ``PLANS_DIRECT``, started side by side."""
    import tempfile
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    runs = []
    for backend, which in PLANS_DIRECT:
        d = tempfile.mkdtemp(prefix="plans_direct_")
        procs = [ctx.Process(target=plans_direct_rank,
                             args=(r, 2, d, backend, which), daemon=True)
                 for r in range(2)]
        for p in procs:
            p.start()
        runs.append((backend, which, d, procs))
    return runs, time.perf_counter()


def plans_direct_finish(started) -> list:
    """Each pair's outcomes, [{"backend", collective: outcome}]: "ok",
    "wrong", the error, "killed the rank" (it started and the process
    died), "hung" (still running when the budget ran out) or "not
    reached"; one outcome for both ranks where they agree. The pairs get
    60 s from their start; no rank outlives the call."""
    budget_s = 60.0
    runs, t0 = started
    out = []
    for backend, which, d, procs in runs:
        for p in procs:
            p.join(timeout=max(0.0, budget_s - (time.perf_counter() - t0)))
        hung = [p.is_alive() for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        by_rank = []
        for r in range(len(procs)):
            path = os.path.join(d, f"rank{r}.jsonl")
            got = {}
            if os.path.exists(path):
                with open(path) as f:
                    got = dict(json.loads(x) for x in f if x.strip())
            res = {"init": got["init"]} if "init" in got else {}
            for name in which:
                what = got.get(name, "not reached")
                if what == "started":
                    what = "hung" if hung[r] else (
                        f"killed the rank (exit code {procs[r].exitcode})")
                res[name] = what
            by_rank.append(res)
        shutil.rmtree(d, ignore_errors=True)
        pair = {"backend": backend}
        for k in by_rank[0]:
            seen = [res.get(k) for res in by_rank]
            pair[k] = seen[0] if len(set(seen)) == 1 else {
                f"rank{r}": v for r, v in enumerate(seen)}
        out.append(pair)
    return out


def plans_dispatch_spy(seen: list):
    """A ``dispatch_indices`` that records (expert ids, kept) a call."""
    from repro_torch.models import moe
    real = moe.dispatch_indices

    def spy(expert_ids, E, cap):
        dest, order, keep = real(expert_ids, E, cap)
        seen.append((expert_ids.cpu(), keep.cpu()))
        return dest, order, keep
    return real, spy


def plans_ep_ranks(seed, smoke, x, device) -> dict:
    """dbrx-132b's MoE layer at full width (bf16) under ep on 1 × 2: each
    rank owns half the experts, the buffer crosses in two all-to-alls."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import context as sctx
    from repro_torch.sharding.place import draw_sharded
    from repro_torch.sharding.spec import param_pspecs, rules_for
    cfg = plans_cfg("dbrx-132b", 1, smoke)
    mesh = make_host_mesh(1, 2)
    rules = rules_for(get_arch("dbrx-132b").plan, mesh)
    layer = moe.MoE(cfg, torch.bfloat16, "meta")
    draw_sharded(layer, seed, param_pspecs(layer, rules), mesh)
    seen = []
    real, spy = plans_dispatch_spy(seen)
    moe.dispatch_indices = spy
    try:
        with torch.no_grad(), sctx.activation_sharding(rules, mesh):
            plans_sync(device)
            t = time.perf_counter()
            y, _ = layer(sctx.shard_act(x.to(device)), torch.bfloat16)
            y = y.full_tensor()
            plans_sync(device)
            s = time.perf_counter() - t
    finally:
        moe.dispatch_indices = real
    return {"out": y.float().cpu(), "seen": seen, "s": s}


def plans_pipeline_ranks(seed, smoke, device) -> dict:
    """qwen2.5-14b's layers at full width (bf16), PLANS_PIPE: stages ×
    layers a stage, through ``pipeline_apply`` against rank 0's
    sequential run of all of them; outputs and the gradients of
    sum(y²) in every layer's weights."""
    import torch
    import torch.distributed as dist
    from torch.func import functional_call
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import common as cm
    from repro_torch.models.transformer import DenseLayer
    from repro_torch.train.pipeline import pipeline_apply
    S_, per, n_micro, L = PLANS_PIPE
    cfg = plans_cfg(PLANS_ARCH, S_ * per, smoke)
    g = torch.Generator(device=device).manual_seed(seed)
    layer = DenseLayer(cfg, torch.bfloat16, device)
    names = [n for n, _ in layer.named_parameters()]
    stacked = {}
    for n, p in layer.named_parameters():
        leaves = []
        for _ in range(S_ * per):
            t = torch.empty_like(p)
            t.init, t.scale, t.by_slice = p.init, p.scale, False
            cm.init_leaf(t, g)
            leaves.append(t)
        stacked[n] = torch.stack(leaves)
    x = torch.randn((n_micro, 1, L, cfg.d_model), generator=g,
                    device=device).to(torch.bfloat16)
    pos = torch.arange(L, device=device)[None]

    def stage_fn(params, xm):
        for i in range(next(iter(params.values())).shape[0]):
            xm = functional_call(layer, {n: params[n][i] for n in names},
                                 (xm, pos, torch.bfloat16, "auto"))
        return xm

    mesh = make_mesh((S_,), ("stage",))
    split = {n: t.reshape((S_, per) + tuple(t.shape[1:])).requires_grad_(True)
             for n, t in stacked.items()}
    plans_sync(device)
    t0 = time.perf_counter()
    y = pipeline_apply(stage_fn, split, x, mesh)
    torch.sum(y.float() ** 2).backward()
    plans_sync(device)
    pipe_s = time.perf_counter() - t0
    # every rank runs the sequential reference and holds its own stage's
    # gradients to it (no gradient crosses ranks)
    r = dist.get_rank()
    mine = slice(r * per, (r + 1) * per)
    full = {n: t.clone().requires_grad_(True) for n, t in stacked.items()}
    plans_sync(device)
    t0 = time.perf_counter()
    ys = torch.stack([stage_fn(full, xm) for xm in x])
    torch.sum(ys.float() ** 2).backward()
    plans_sync(device)
    seq_s = time.perf_counter() - t0
    errs = torch.tensor([
        float((y.detach().float() - ys.detach().float()).abs().max()),
        max(float((t.grad.reshape(stacked[n].shape)[mine].float()
                   - full[n].grad[mine].float()).norm()
                  / full[n].grad[mine].float().norm().clamp(min=1e-30))
            for n, t in split.items())])
    dist.all_reduce(errs, op=dist.ReduceOp.MAX)
    return {"s": pipe_s, "sequential_s": seq_s,
            "out_max_abs_err": float(errs[0]),
            "out_scale": float(ys.detach().float().abs().max()),
            "grad_rel_err": float(errs[1])}


def plans_ranks_four(rank, world, seed, smoke, want, ckpt_dir):
    """Four ranks on one device: qwen2.5-14b's published plan (fsdp + tp +
    sp) over 2 × 2, one step in each of PLANS_TRAIN_COMPUTES against the
    one-rank step's samples; ``compressed_psum`` over the four against
    ``compressed_mean``; the elastic run's first half (a checkpoint at 2 ×
    2)."""
    from repro_torch import dist as rdist
    device = rdist.rank_device()
    out = {"train": {c: plans_train_ranks(c, seed, smoke, want[c], device)
                     for c in PLANS_TRAIN_COMPUTES}}
    out["compress"] = plans_compress(seed, device,
                                     1 << 20 if smoke else PLANS_COMPRESS)
    out["elastic"] = plans_elastic(seed, smoke, ckpt_dir, range(0, 2),
                                   save=True)
    out["staged"] = gather(rdist.staged_bytes())
    return out


def plans_train_ranks(compute, seed, smoke, want, device) -> dict:
    """One step of the published plan over 2 × 2 in ``compute``, held on
    each rank to the one-rank step's samples (``want``) of the parameters
    and of AdamW's m, over the sampled entries in the rank's own shards:
    the worst parameter error, and m's squared error and norm summed over
    the ranks (its relative L2)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train.steps import (DTYPES, init_train_state,
                                         make_train_step)
    cfg = plans_cfg(PLANS_ARCH, PLANS_TRAIN_LAYERS, smoke)
    plan = plans_train_plan(compute)
    tcfg = TrainConfig(total_steps=4, warmup_steps=1, seed=seed)
    mesh = make_host_mesh(2, 2)
    plans_free(device.type == "cuda")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = build_model(cfg, param_dtype=DTYPES[plan.param_dtype],
                        device="meta")
    state = init_train_state(model, plan, tcfg, seed, mesh=mesh)
    step = make_train_step(model, plan, tcfg, mesh)
    batch = plans_train_batch(cfg, seed, device)
    plans_sync(device)
    init_s = time.perf_counter() - t
    plans_note(f"train_init_{compute}")
    # one step, as the reference's sharded test takes: its lr is 0 (the
    # warm-up), so the parameters come back as they went in, through the
    # layouts, and the step's gradients are in AdamW's m = (1 - b1)·g
    plans_sync(device)
    t = time.perf_counter()
    state, m = step(state, batch)
    plans_sync(device)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "s_a_step": time.perf_counter() - t, "init_s": init_s}
    p_err = 0.0
    m_num = m_den = 0.0
    for n, p in sorted(state["params"].items()):
        idx, vals, _ = want["params"][n]
        got, keep = plans_local_samples(p, idx)
        if keep.any():
            p_err = max(p_err, float((got - vals[keep]).abs().max()))
        idx, vals, _ = want["m"][n]
        got, keep = plans_local_samples(state["opt"]["m"][n], idx)
        m_num += float(((got - vals[keep]) ** 2).sum())
        m_den += float((vals[keep] ** 2).sum())
    t_ = torch.tensor(p_err)
    dist.all_reduce(t_, op=dist.ReduceOp.MAX)
    out["params_max_abs_err"] = float(t_)
    t_ = torch.tensor([m_num, m_den], dtype=torch.float64)
    dist.all_reduce(t_)
    out["m_rel_l2"] = float((t_[0] / t_[1].clamp(min=1e-300)).sqrt())
    out["peak_gb_by_rank"] = gather(
        torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda"
        else 0.0)
    del state, model, step
    plans_note(f"train_{compute}")
    return out


def plans_compress(seed, device, n: int) -> dict:
    """``compressed_psum`` of an ``n``-element gradient over every rank
    against rank 0's ``compressed_mean`` of all of them, bit for bit."""
    import torch
    import torch.distributed as dist
    from repro_torch.optim.compress import compressed_mean, compressed_psum
    w, r = dist.get_world_size(), dist.get_rank()

    def draw(k, scale):
        g = torch.Generator(device=device).manual_seed(seed + k)
        return torch.randn(n, generator=g, device=device) * scale

    plans_sync(device)
    t = time.perf_counter()
    mean, new_e = compressed_psum({"g": draw(r, 1.0)}, None,
                                  {"g": draw(100 + r, 1e-2)})
    plans_sync(device)
    s = time.perf_counter() - t
    if r == 0:
        want_m, want_e = compressed_mean(
            {"g": torch.stack([draw(k, 1.0) for k in range(w)])},
            {"g": torch.stack([draw(100 + k, 1e-2) for k in range(w)])})
        ok_m = torch.equal(mean["g"], want_m["g"])
        ok_e = torch.equal(new_e["g"], want_e["g"][0])
        return {"elements": n, "ranks": w, "mean_bit_equal": ok_m,
                "error_bit_equal": ok_e, "s": s,
                "payload": "int32 all-reduce"}
    return {}


def plans_elastic(seed, smoke, ckpt_dir, steps, save: bool) -> dict:
    """xlstm-350m at full width cut to PLANS_ELASTIC's layers under its
    plan (tp), AdamW: resume from ``ckpt_dir`` (every leaf gathered and
    held to the checkpoint's arrays bit for bit), run ``steps``, and with
    ``save`` write a checkpoint (gathered whole, rank 0 writes)."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import dist as rdist
    from repro_torch.checkpoint import CheckpointManager, load_arrays
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.models import build_model
    from repro_torch.runtime.elastic import (make_elastic_mesh,
                                             restore_sharded, save_sharded)
    from repro_torch.sharding.place import full_tree
    from repro_torch.train.steps import init_train_state, make_train_step
    arch, layers, shape = PLANS_ELASTIC
    entry = get_arch(arch)
    cfg = plans_cfg(arch, layers, smoke)
    plan = dataclasses.replace(entry.plan, grad_accum=1)
    tcfg = TrainConfig(total_steps=8, warmup_steps=1, seed=seed)
    device = rdist.rank_device()
    mesh = make_elastic_mesh(prefer_model=2)
    model = build_model(cfg, device="meta")
    state = init_train_state(model, plan, tcfg, seed, mesh=mesh)
    ckpt = CheckpointManager(ckpt_dir, keep=2, async_save=False)
    t = time.perf_counter()
    restored, meta = restore_sharded(ckpt, model, plan, mesh, state)
    out = {"mesh": list(mesh.mesh.shape), "restore_s": time.perf_counter() - t}
    if restored is not None:
        state = restored
        arrays = load_arrays(ckpt._step_dir(int(meta["step"])))
        full = full_tree({"params": dict(state["params"]),
                          "opt": state["opt"], "step": state["step"]})
        from repro_torch.checkpoint.manager import _flatten, _host
        mismatched = [k for k, v in _flatten(full).items()
                      if not np.array_equal(_host(v), arrays[k])]
        out.update(leaves=len(arrays), mismatched=mismatched,
                   bit_for_bit=not mismatched)
    step = make_train_step(model, plan, tcfg, mesh)
    loader = ShardedLoader(cfg.vocab_size, *shape, seed=seed, device=device)
    losses = []
    for s_ in steps:
        state, m = step(state, loader.get(s_))
        losses.append(float(m["loss"]))
    out["losses"] = losses
    if save:
        t = time.perf_counter()
        save_sharded(ckpt, steps[-1], state)
        out["save_s"] = time.perf_counter() - t
    return out


def plans_m_rel_l2(got: dict, want: dict) -> float:
    """The relative L2 of one step's sampled AdamW m against another's,
    over every leaf's samples together (``plans_samples``' trees)."""
    num = den = 0.0
    for n, (_, vals, _) in want.items():
        num += float(((got[n][1] - vals) ** 2).sum())
        den += float((vals ** 2).sum())
    return (num / max(den, 1e-300)) ** 0.5


def plans_train_check(one: dict, want: dict, ranks: dict) -> dict:
    """The sharded steps held to the one-rank steps in the same type
    (``PLANS_TRAIN_LIMITS``): the loss, the gradients' global norm and
    AdamW's m (the step's gradients), and the parameters bit for bit (lr
    is 0). Each gradient limit must sit below its control, the one-rank
    fp32 step on half the batch against the whole (what a rank holds when
    the data ranks' reduction is missing), or the check could not see that
    fault. bf16 rounding moves a one-rank step too; its reading (bf16
    against fp32 on one rank) is printed beside the bf16 step's."""
    lim = PLANS_TRAIN_LIMITS
    full, half = one["float32"], one["float32_half_batch"]
    control = {"grad_norm_rel": abs(half["grad_norm"] - full["grad_norm"])
               / full["grad_norm"],
               "m_rel_l2": plans_m_rel_l2(want["float32_half_batch"]["m"],
                                          want["float32"]["m"])}
    witness = {"loss_abs": abs(one["bfloat16"]["loss"] - full["loss"]),
               "grad_norm_rel": abs(one["bfloat16"]["grad_norm"]
                                    - full["grad_norm"]) / full["grad_norm"],
               "m_rel_l2": plans_m_rel_l2(want["bfloat16"]["m"],
                                          want["float32"]["m"])}
    out = {"arch": PLANS_ARCH, "layers": PLANS_TRAIN_LAYERS, "mesh": [2, 2],
           "plan": f"fsdp+tp+sp, AdamW fp32, ga {PLANS_TRAIN_GA}",
           "tokens": list(PLANS_TRAIN_SHAPE),
           "sampled_entries_a_leaf": PLANS_SAMPLES,
           "control_half_batch": control,
           "bf16_against_fp32_one_rank": witness, "limits": lim}
    bad = [f"{c} {k}: control under the limit" for c in PLANS_TRAIN_COMPUTES
           for k in control if k in lim[c] and not control[k] > lim[c][k]]
    for c in PLANS_TRAIN_COMPUTES:
        r, o = ranks[c], one[c]
        got = {"loss_abs": abs(r["loss"] - o["loss"]),
               "grad_norm_rel": abs(r["grad_norm"] - o["grad_norm"])
               / o["grad_norm"],
               "m_rel_l2": r["m_rel_l2"],
               "params_max_abs_err": r["params_max_abs_err"]}
        out[c] = {"one_rank": o, "four_ranks": r, **got}
        bad += [f"{c} {k}" for k, v in lim[c].items() if not got[k] <= v]
    out["failed"] = bad
    emit({"plans_check": "train", **out})
    if bad:
        raise AssertionError(f"plans train: {bad}: {out}")
    return out


def plans_phase(seed: int, device: str = "cuda", smoke: bool = False,
                staged=None) -> dict:
    """The multi-device plans on one card, their ranks S processes on
    ``cuda:0`` joined by gloo (see the module docstring, item 12). The
    one-rank baselines run here first; every check raises on a miss.
    ``staged``: the ranks' group (``repro_torch.dist.init_rank``; on the
    card the staged one), to rehearse the card's group on the CPU."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch import dist as rdist
    from repro_torch.configs import TrainConfig
    from repro_torch.models import build_model, moe
    from repro_torch.train.steps import (DTYPES, init_train_state,
                                         make_train_step)
    t_phase = time.perf_counter()
    cuda = device != "cpu"
    out = {"phase": "plans"}
    # the CPU rehearsal at SMOKE width (d 64) rounds more, relatively:
    # held at 0.1 there, at TEACHER_FORCED_L2 on the card
    limit = TEACHER_FORCED_L2 if not smoke else 0.1
    # one rank: serving, the cache-free forward, the train step, EP
    cfg = plans_cfg(PLANS_ARCH, PLANS_SERVE_LAYERS, smoke, attn_impl="pallas")
    model = build_model(cfg, param_dtype=torch.bfloat16, device=device,
                        rng=seed)
    B, P, steps = PLANS_SERVE
    serve_tokens = plans_tokens(cfg, (B, P + steps), seed, device)
    flash_tokens = plans_tokens(cfg, PLANS_FLASH, seed + 1, device)
    want_serve, pre_s, dec_ms = plans_serve_run(model, serve_tokens, P)
    del model
    fcfg = plans_cfg(PLANS_ARCH, PLANS_FLASH_LAYERS, smoke,
                     attn_impl="pallas")
    model = build_model(fcfg, param_dtype=torch.bfloat16, device=device,
                        rng=seed)
    with torch.no_grad():
        want_flash = model({"tokens": flash_tokens}, remat="none",
                           compute_dtype=torch.bfloat16)[0].float().cpu()
    del model
    torch.cuda.empty_cache() if cuda else None
    # the one-rank steps: in each compute type the ranks' reference, and
    # in fp32 on half the batch the control (a rank's gradient with the
    # data ranks' reduction missing)
    tcfg_ = plans_cfg(PLANS_ARCH, PLANS_TRAIN_LAYERS, smoke)
    tcfg = TrainConfig(total_steps=4, warmup_steps=1, seed=seed)
    model = build_model(tcfg_, device=device, rng=seed,
                        param_dtype=DTYPES[plans_train_plan("float32")
                                           .param_dtype])
    batch = plans_train_batch(tcfg_, seed, device)
    half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
    one_train, want_train = {}, {}
    for name, compute, b in (("float32", "float32", batch),
                             ("bfloat16", "bfloat16", batch),
                             ("float32_half_batch", "float32", half)):
        one = dataclasses.replace(plans_train_plan(compute), fsdp=False,
                                  tp=False, sp=False)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        state = init_train_state(model, one, tcfg, seed)
        step = make_train_step(model, one, tcfg)
        plans_sync(device)
        t = time.perf_counter()
        state, m = step(state, b)
        plans_sync(device)
        one_train[name] = {
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "s_a_step": time.perf_counter() - t,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9
            if cuda else 0.0}
        want_train[name] = {"params": plans_samples(state["params"], seed),
                            "m": plans_samples(state["opt"]["m"], seed)}
        del state, step
    del model
    gc.collect()
    torch.cuda.empty_cache() if cuda else None
    ecfg = plans_cfg("dbrx-132b", 1, smoke)
    layer = moe.MoE(ecfg, torch.bfloat16, device)
    from repro_torch.models import common as cm
    cm.draw_params(layer, seed, device)
    g = torch.Generator(device="cpu").manual_seed(seed + 2)
    ep_x = torch.randn(PLANS_EP_TOKENS + (ecfg.d_model,), generator=g
                       ).to(torch.bfloat16)
    seen = []
    real, spy = plans_dispatch_spy(seen)
    moe.dispatch_indices = spy
    try:
        with torch.no_grad():
            want_ep = layer(ep_x.to(device), torch.bfloat16)[0].float().cpu()
    finally:
        moe.dispatch_indices = real
    del layer
    gc.collect()
    torch.cuda.empty_cache() if cuda else None
    out["baselines_s"] = time.perf_counter() - t_phase

    # four ranks (the train step, compress, a checkpoint), then two (the
    # rest, and the checkpoint resumed); the parent keeps no device memory
    # while they run (they share its card)
    rdist.reset_staged()
    ckpt = tempfile.mkdtemp(prefix="plans_ckpt_")
    plans_free(cuda)
    out["parent_reserved_gb_before_four"] = (
        torch.cuda.memory_reserved() / 1e9 if cuda else 0.0)
    t = time.perf_counter()
    # the direct probe's pairs run beside the four ranks, which spend their
    # first seconds reaching the card
    direct = plans_direct_start() if cuda else None
    try:
        four = rdist.spawn(plans_ranks_four, 4,
                           (seed, smoke, {c: want_train[c]
                                          for c in PLANS_TRAIN_COMPUTES},
                            ckpt),
                           device=device, timeout=600, staged=staged)
    finally:
        direct = (plans_direct_finish(direct) if direct is not None else
                  "not run: the CPU ranks use gloo's own group")
    out["four_ranks_s"] = time.perf_counter() - t
    emit({"plans_group": "four", "s": out["four_ranks_s"],
          "init_s": {c: four["train"][c]["init_s"]
                     for c in PLANS_TRAIN_COMPUTES}})
    t = time.perf_counter()
    two = rdist.spawn(plans_ranks_two, 2, (seed, smoke, serve_tokens.cpu(),
                                           flash_tokens.cpu(), ep_x, ckpt),
                      device=device, timeout=600, staged=staged)
    out["two_ranks_s"] = time.perf_counter() - t
    emit({"plans_group": "two", "s": out["two_ranks_s"],
          "baselines_s": out["baselines_s"]})
    shutil.rmtree(ckpt, ignore_errors=True)
    out["probe"] = {"ranks_group": two["probe"], "direct": direct}
    emit({"plans_probe": two["probe"],
          "group": "StagedGroup over gloo" if cuda else "gloo",
          "ranks_on": "cuda:0" if cuda else "cpu",
          "direct_on_cuda_tensors": direct})
    bad = [k for k, v in two["probe"].items() if v not in (
        "gloo", "staged through pinned host memory")]
    if bad:
        raise AssertionError(f"plans: collectives {bad} failed: "
                             f"{two['probe']}")

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-30))

    got = two["serve"]["logits"]
    per_step = [rel_l2(got[:, i], want_serve[:, i])
                for i in range(got.shape[1])]
    # held teacher-forced, layer by layer (the serve phase's check): the
    # free-running logits of the random-weight model decorrelate in depth,
    # so they are reported, not held
    model = build_model(cfg, param_dtype=torch.bfloat16, device=device,
                        rng=seed)
    forced = plans_teacher_forced(model, two["serve"]["calls"], got, P)
    del model
    out["serve"] = {"arch": PLANS_ARCH, "layers": PLANS_SERVE_LAYERS,
                    "mesh": [1, 2], "shape": list(PLANS_SERVE),
                    "teacher_forced": forced,
                    "free_running_logits_rel_l2": per_step,
                    "argmax_agree": float(
                        (got.argmax(-1) == want_serve.argmax(-1)).float()
                        .mean()),
                    "limit": limit,
                    "prefill_s": {"one_rank": pre_s,
                                  "tp2": two["serve"]["prefill_s"]},
                    "decode_ms_a_step": {
                        "one_rank": dec_ms,
                        "tp2": two["serve"]["decode_ms_a_step"]}}
    emit({"plans_check": "serve", **out["serve"]})
    if not (forced["layer_rel_l2_max"] <= limit
            and forced["head_rel_l2_max"] <= limit):
        raise AssertionError(f"plans serve: {forced}")
    fl = two["flash"]
    launches = [c["tensor_cores"] for c in fl["launches_by_rank"]]
    out["flash"] = {"shape": list(PLANS_FLASH),
                    "layers": PLANS_FLASH_LAYERS,
                    "local_heads_q_kv": list(fl["local_heads"]),
                    "launches_by_rank": fl["launches_by_rank"],
                    "logits_rel_l2": rel_l2(fl["logits"], want_flash),
                    "limit": limit}
    emit({"plans_check": "tp_forward_flash", **out["flash"]})
    if cuda and (min(launches) < PLANS_FLASH_LAYERS):
        raise AssertionError(f"plans: flash_attention's tensor-core kernel "
                             f"launched {launches} times under tp")
    if not out["flash"]["logits_rel_l2"] <= limit:
        raise AssertionError(f"plans tp forward: {out['flash']}")
    out["launches"] = {"flash_attention": sum(
        c["launches"] for c in fl["launches_by_rank"])}
    out["launches_by_variant"] = {
        "tensor_cores": sum(c["tensor_cores"] for c in fl["launches_by_rank"]),
        "cuda_cores": sum(c["cuda_cores"] for c in fl["launches_by_rank"])}
    # EP: both ranks route the same tokens as the one-rank layer (1 × 2:
    # every rank's tokens are all of them, so the capacity is the same)
    ep = two["ep"]
    keep_one = torch.cat([k for _, k in seen])
    same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(ep["seen"], seen)) and len(ep["seen"]) == len(
                   seen)
    err = (ep["out"] - want_ep).abs().max() / want_ep.abs().max()
    out["ep"] = {"arch": "dbrx-132b", "experts": ecfg.n_experts,
                 "top_k": ecfg.n_experts_active, "mesh": [1, 2],
                 "tokens": list(PLANS_EP_TOKENS),
                 "routing_and_kept_equal": same,
                 "kept_share": float(keep_one.float().mean()),
                 "kept_share_limit": 0.95,
                 "max_abs_err_over_scale": float(err), "limit": 1e-3,
                 "s": ep["s"]}
    emit({"plans_check": "ep", **out["ep"]})
    if not (same and out["ep"]["kept_share"] > 0.95 and err <= 1e-3):
        raise AssertionError(f"plans ep: {out['ep']}")
    pp = two["pipeline"]
    out["pipeline"] = {"stages": PLANS_PIPE[0], "layers_a_stage": PLANS_PIPE[1],
                       "microbatches": PLANS_PIPE[2], **pp,
                       "limits": {"out_rel": 1e-2, "grad_rel_l2": 1e-2}}
    emit({"plans_check": "pipeline", **out["pipeline"]})
    if not (pp["out_max_abs_err"] <= 1e-2 * pp["out_scale"]
            and pp["grad_rel_err"] <= 1e-2):
        raise AssertionError(f"plans pipeline: {out['pipeline']}")
    out["peak_gb_two_ranks"] = two["peak_gb_by_rank"]

    out["train"] = plans_train_check(one_train, want_train, four["train"])
    out["compress"] = four["compress"]
    emit({"plans_check": "compress", **out["compress"]})
    if not (four["compress"]["mean_bit_equal"]
            and four["compress"]["error_bit_equal"]):
        raise AssertionError(f"plans compress: {four['compress']}")
    el = two["elastic"]
    out["elastic"] = {"arch": PLANS_ELASTIC[0], "layers": PLANS_ELASTIC[1],
                      "tokens": list(PLANS_ELASTIC[2]),
                      "written_on": four["elastic"]["mesh"],
                      "resumed_on": el["mesh"],
                      "leaves": el.get("leaves"),
                      "bit_for_bit": el.get("bit_for_bit"),
                      "losses": four["elastic"]["losses"] + el["losses"],
                      "save_s": four["elastic"]["save_s"],
                      "restore_s": el["restore_s"]}
    emit({"plans_check": "elastic", **out["elastic"]})
    if not (el.get("bit_for_bit") and all(math.isfinite(v) for v in
                                          out["elastic"]["losses"])):
        raise AssertionError(f"plans elastic: {el}")
    out["staged"] = {"bytes_by_rank": {
        "two": [g["bytes"] for g in two["staged"]],
        "four": [g["bytes"] for g in four["staged"]]},
        "what": "every collective's tensors, to pinned host memory and back"
                if cuda else "none: the CPU ranks use gloo as it is"}
    emit({"plans_staged": out["staged"]})
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# 13. dryrun: the dry run and the roofline, host-only, beside the card
# ---------------------------------------------------------------------------

# full-width production cells: (arch, shape, mesh)
DRYRUN_CELLS = (("qwen2.5-14b", "train_4k", "single"),
                ("dbrx-132b", "decode_32k", "multi"),
                ("xlstm-350m", "long_500k", "single"),
                ("bmo-nn", "knn_100k_12k", "single"))
# the train phase's own qwen2.5-14b step, priced at one chip: its cut,
# batch and seq (the published plan, ga 8, AdamW, fp32 parameters)
DRYRUN_TRAIN_STEP = ("qwen2.5-14b", TRAIN_RUNS[0][1], TRAIN_BATCH, TRAIN_SEQ)
# seconds the child may take after the card phases end
DRYRUN_JOIN_S = 300


def dryrun_start(out_dir: str):
    """The dryrun phase's child process (``dryrun_child``), started at
    once: host-only (no card visible), one thread, so it runs beside the
    card phases. Returns (process, result path, log path)."""
    out = os.path.join(out_dir, "dryrun.json")
    log = os.path.join(out_dir, "dryrun.log")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    # at the lowest priority: the card phases' host threads come first
    code = (f"import os, sys; os.nice(19); sys.path.insert(0, {ROOT!r}); "
            f"import chip_smoke; chip_smoke.dryrun_child({out!r})")
    with open(log, "w") as fh:
        proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                                stdout=fh, stderr=subprocess.STDOUT,
                                cwd=ROOT)
    return proc, out, log


def dryrun_child(out: str) -> None:
    """The body of the dryrun phase, in its own process: each of
    DRYRUN_CELLS through ``repro_torch.launch.dryrun`` (its fake process
    group of 256 or 512 ranks, every tensor on ``meta``), and the train
    phase's qwen2.5-14b step priced at one chip; writes the records to
    ``out``."""
    import dataclasses
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    t = time.perf_counter()
    cells = []
    for arch, shape, mesh in DRYRUN_CELLS:
        t_cell = time.perf_counter()
        try:
            rec = (dryrun.run_bmo_cell(shape, mesh) if arch == "bmo-nn"
                   else dryrun.run_cell(arch, shape, mesh))
        except Exception as e:  # noqa: BLE001 - reported, then fails the run
            rec = {"arch": arch, "shape": shape, "mesh": mesh,
                   "status": "error", "error": f"{type(e).__name__}: {e}"}
        rec["wall_s"] = time.perf_counter() - t_cell
        cells.append(rec)
    arch, layers, batch, seq = DRYRUN_TRAIN_STEP
    entry = get_arch(arch)
    cfg = dataclasses.replace(entry.config, n_layers=layers)
    # the train phase's plan: the published one on one card
    plan = dataclasses.replace(entry.plan, fsdp=False, tp=False, sp=False,
                               ep=False)
    step = dryrun.price_train_step(cfg, plan, batch, seq,
                                   name=f"train_phase_{batch}x{seq}")
    with open(out, "w") as fh:
        json.dump({"cells": cells, "train_step": step,
                   "seconds": time.perf_counter() - t}, fh)


def dryrun_finish(started, train: dict) -> dict:
    """Join the dryrun phase's child (at most DRYRUN_JOIN_S more), check
    every cell ``ok`` and ``hardware.HBM_BYTES`` equal to the card's
    memory, and put the priced train step beside the train phase's
    measured s a step."""
    import torch
    from repro_torch import hardware
    proc, out, log = started
    t = time.perf_counter()
    try:
        proc.wait(timeout=DRYRUN_JOIN_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    waited = time.perf_counter() - t
    if proc.returncode != 0 or not os.path.exists(out):
        with open(log) as fh:
            tail = fh.read()[-3000:]
        raise RuntimeError(f"dryrun: the child exited {proc.returncode}: "
                           f"{tail}")
    with open(out) as fh:
        res = json.load(fh)
    total = torch.cuda.get_device_properties(0).total_memory
    keys = ("arch", "shape", "mesh", "chips", "status", "t_compute",
            "t_memory", "t_collective", "bottleneck", "roofline_fraction",
            "peak_memory_per_chip", "fits_hbm", "compile_s", "wall_s")
    cells = [{k: c.get(k) for k in keys + ("error",) if k in c}
             for c in res["cells"]]
    for c in cells:
        emit({"dryrun_cell": c})
    qwen = next(r for r in train["runs"] if r.get("arch") == "qwen2.5-14b")
    step = res["train_step"]
    priced = {k: step[k] for k in ("hlo_flops", "hlo_bytes", "t_compute",
                                   "t_memory", "t_collective", "t_bound",
                                   "bottleneck", "peak_memory_per_chip",
                                   "model_flops", "useful_flops_ratio")}
    priced.update({"arch": DRYRUN_TRAIN_STEP[0],
                   "n_layers": qwen["n_layers"],
                   "measured_s_a_step": qwen["s_a_step"],
                   "measured_peak_gb": qwen["peak_gb"],
                   "measured_over_bound": qwen["s_a_step"] / step["t_bound"]})
    emit({"dryrun_train_step": priced})
    out_d = {"phase": "dryrun", "child_s": res["seconds"],
             "joined_after_s": waited, "cells": cells,
             "train_step": priced, "hbm_bytes": hardware.HBM_BYTES,
             "total_memory": total}
    bad = [c for c in cells if c["status"] != "ok"]
    if bad:
        raise AssertionError(f"dryrun: cells not ok: {bad}")
    if hardware.HBM_BYTES != total:
        raise AssertionError(f"dryrun: hardware.HBM_BYTES "
                             f"{hardware.HBM_BYTES} != the card's "
                             f"total_memory {total}")
    if qwen["n_layers"] != DRYRUN_TRAIN_STEP[1]:
        raise AssertionError(f"dryrun: the train phase ran qwen2.5-14b at "
                             f"{qwen['n_layers']} layers, priced at "
                             f"{DRYRUN_TRAIN_STEP[1]}")
    return out_d


# ---------------------------------------------------------------------------
# 14. lint: the invariant lint over the port and the kernels' ptxas records
# ---------------------------------------------------------------------------


def lint_phase(out_dir: str) -> dict:
    """``tools/torch_lint.py`` over ``src/repro_torch`` against the port's
    baseline with this run's ``ptxas -v`` record of every built kernel and
    the launches the traces so far recorded (LAUNCHES; the Hopper rule): 0
    new findings, from the sources' rules and from the Hopper rule.
    Returns the counts by rule and by status."""
    from repro_torch.kernels import _build
    t = time.perf_counter()
    logs = os.path.join(out_dir, "ptxas")
    os.makedirs(logs, exist_ok=True)
    missing = [stem for stem, v in _build.build_log.items()
               if not v.get("log")]
    if missing or not _build.build_log:
        raise AssertionError(f"lint: no ptxas record for {missing}")
    for stem, v in _build.build_log.items():
        with open(os.path.join(logs, f"{stem}.log"), "w") as fh:
            fh.write(v["log"])
    launches = os.path.join(out_dir, "launches.json")
    with open(launches, "w") as fh:
        json.dump(sorted(LAUNCHES.values(), key=lambda r: r["kernel"]), fh)
    report = os.path.join(out_dir, "lint.json")
    run = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_lint.py"),
         "--json", report, "--ptxas-log", logs, "--launches", launches],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    if run.returncode != 0:
        raise AssertionError(f"lint: exit {run.returncode}: "
                             f"{run.stdout[-3000:]}{run.stderr[-2000:]}")
    with open(report) as fh:
        doc = json.load(fh)
    by_rule: dict = {}
    for f in doc["findings"]:
        row = by_rule.setdefault(f["rule"], {})
        row[f["status"]] = row.get(f["status"], 0) + 1
    if doc["counts"]["new"]:
        raise AssertionError(f"lint: new findings: {doc}")
    from repro_torch.analysis.rules_hopper import launch_key
    ours = {launch_key(r["kernel"])[0] for r in LAUNCHES.values()}
    ours = sorted(n for n in ours if any(
        n in v["log"] for v in _build.build_log.values()))
    if not ours:
        raise AssertionError("lint: the profiler's traces recorded no "
                             "launch of this repo's kernels")
    return {"phase": "lint", "counts": doc["counts"], "by_rule": by_rule,
            "kernels_priced": sorted(_build.build_log),
            "launch_records": len(LAUNCHES),
            "kernels_priced_at_launch": ours,
            "launch_record_s": LAUNCH_RECORD_S[0],
            "seconds": time.perf_counter() - t}


KERNELS = (
    ("fused_epoch_pull", "src/repro_torch/csrc/fused_epoch_pull.cu",
     "src/repro/kernels/fused_race.py:89",
     ("main_path", "tune", "plane", "mutation", "sharded", "fleet",
      "serve")),
    ("fwht", "src/repro_torch/csrc/fwht.cu", "src/repro/kernels/fwht.py:30",
     ("main_path", "tune", "plane", "mutation", "sharded", "fleet")),
    ("block_pull_multi", "src/repro_torch/csrc/block_pull.cu",
     "src/repro/kernels/block_pull.py:78",
     ("rounds", "tune", "sharded", "distributed")),
    ("block_pull", "src/repro_torch/csrc/block_pull.cu",
     "src/repro/kernels/block_pull.py:41", ("paper", "kmeans")),
    ("pairwise_dist", "src/repro_torch/csrc/pairwise_dist_sm90.cu",
     "src/repro/kernels/pairwise_dist.py:41",
     ("oracle", "plane", "paper", "fleet", "sparse", "sharded", "kmeans")),
    ("flash_attention", "src/repro_torch/csrc/flash_attn_sm90.cu",
     "src/repro/kernels/flash_attn.py:69", ("lm_forward", "serve",
                                            "families", "plans")),
)
# the other variant of a kernel with two: flash_attention's on the CUDA
# cores (fp32, and bf16 at other head widths: the families phase's 64, 80
# and 192); pairwise_dist's on the CUDA cores (ℓ1, ℓ2 with Q ≤ 4 as the
# paper path's exact evaluation, d % 4 ≠ 0)
OTHER_VARIANT_SOURCE = {
    "flash_attention": "src/repro_torch/csrc/flash_attn.cu",
    "pairwise_dist": "src/repro_torch/csrc/pairwise_dist.cu"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=1024,
                    help="query batch of the workload (its own is 1024)")
    ap.add_argument("--rounds-queries", type=int, default=128,
                    help="queries of the rounds phase (a cut from 1024)")
    ap.add_argument("--shard-rounds-queries", type=int, default=128,
                    help="queries of the sharded phase's rounds race and "
                         "the distributed phase (a cut from 1024)")
    ap.add_argument("--sparse-queries", type=int, default=32,
                    help="queries of the sparse phase's rounds step (a cut "
                         "from 1024)")
    ap.add_argument("--kmeans-points", type=int, default=64,
                    help="points of the kmeans phase (a cut from Fig. 5's "
                         f"{KMEANS_FIG5_POINTS})")
    ap.add_argument("--out", help="write every detail to this JSON file")
    args = ap.parse_args()

    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.bmo_nn import DENSE
    from repro_torch.data.synthetic import make_knn_benchmark_data
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "allow_tf32_matmul": False,
          "allow_tf32_cudnn": False})
    for what, got in (("queries", args.queries),
                      ("rounds-phase queries", args.rounds_queries),
                      ("sharded rounds and distributed queries",
                       args.shard_rounds_queries),
                      ("sparse rounds-step queries", args.sparse_queries)):
        if got != 1024:
            emit({"cut": f"{what} {got} instead of the workload's 1024"})
    emit({"cut": f"sparse races at the workload's 100,000 rows: capped at "
                 f"1 + {SPARSE_CAPPED_ROUNDS} rounds (8.7-8.9 rounds a row a "
                 "query would make some 880,000); recall held over the "
                 f"first {SPARSE_RACE_ROWS} rows, races run to certification"})
    emit({"cut": "sparse mutation step: the loaded index's race held to the "
                 f"built one's over 1 + {SPARSE_CAPPED_ROUNDS} rounds, not "
                 "to certification"})
    emit({"cut": f"sparse paper step: {SPARSE_PAPER_QUERIES} queries "
                 "instead of the workload's 1024 (one race each)"})
    emit({"cut": f"paper: {PAPER_QUERIES} queries instead of the workload's "
                 "1024 (one host-driven race each; 16, then 4 before the "
                 "fleet phase)"})
    emit({"cut": f"serve_cli: {SERVE_CLI_TOKENS} new tokens (16 before the "
                 "sharded phases)"})
    emit({"cut": f"serve: {SERVE_KNN_TOKENS} kNN-LM tokens (64 before the "
                 "sharded phases, then 16 before the fleet phase)"})
    emit({"cut": f"{SHARDS} shards on one card; the reference places one a "
                 "device"})
    emit({"cut": "distributed: a 2 x 2 grid of cuda:0; the reference places "
                 "one cell a device"})
    emit({"cut": "fleet: closed loop with 8 requests in flight; the "
                 "reference's bench also drives open-loop arrivals, which "
                 "the port has no load generator for yet"})
    emit({"cut": f"fleet: {FLEET_REQUESTS} requests instead of the 160 of "
                 "its design, to keep the script's time on slow hosts"})
    for arch, layers, *_ in FAMILY_RUNS:
        if layers is not None:
            emit({"cut": f"families: {arch} at full width, cut to {layers} "
                         "layers so that the card holds it"})
    emit({"cut": "families: xlstm-350m's lm_loss over 4 x 1,024 tokens, not "
                 "the 4,096 of the LM phase (its cells step token by "
                 "token)"})
    for arch, layers, steps in TRAIN_RUNS:
        emit({"cut": f"train: {arch} at full width cut to {layers} layers, "
                     f"{steps} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens"})
    emit({"cut": "train: deepseek-v3-671b stays off the card: by its "
                 "shapes its 4-layer cut needs about 62 GB of bf16 "
                 "parameters and gradients, before the plain sdpa's MLA "
                 "scores at 4,096 positions (arithmetic, not measured)"})
    emit({"cut": f"plans: {PLANS_ARCH} at full width, serving cut to "
                 f"{PLANS_SERVE_LAYERS} layers, the tp forward through "
                 f"flash_attention to {PLANS_FLASH_LAYERS}, the train step "
                 f"to {PLANS_TRAIN_LAYERS} layer at ga {PLANS_TRAIN_GA} "
                 "(published: ga 8); the elastic run's "
                 f"{PLANS_ELASTIC[0]} to {PLANS_ELASTIC[1]} layers"})
    emit({"cut": "families: the MoE archs serve at capacity factor E/k "
                 "(dropless), so the cache path and its cache-free reruns "
                 "route the same tokens; their loss keeps the published "
                 "1.25"})
    if args.kmeans_points != KMEANS_FIG5_POINTS:
        emit({"cut": f"kmeans: {args.kmeans_points} points instead of Fig. "
                     f"5's {KMEANS_FIG5_POINTS} (one host-driven race a "
                     "point an iteration)"})

    t = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "per_source_s": {k: v["seconds"] for k, v in _build.build_log.items()}})
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    dryrun = dryrun_start(work)
    try:
        return run_phases(args, t_start, smi, work, dryrun)
    finally:
        if dryrun[0].poll() is None:
            dryrun[0].kill()
            dryrun[0].wait()
        shutil.rmtree(work, ignore_errors=True)


def run_phases(args, t_start: float, smi: str, work: str, dryrun) -> int:
    """Every phase after the build, in order (the module docstring); the
    dryrun phase's child runs beside them from the start."""
    import torch
    from repro_torch.configs.bmo_nn import DENSE
    from repro_torch.data.synthetic import make_knn_benchmark_data
    from repro_torch.kernels import _build

    report = {"nvidia_smi": smi.strip(),
              "build_log": {k: v["log"] for k, v in _build.build_log.items()}}
    report["kernels"] = kernel_phase(args.seed, args.queries, DENSE.n_points)
    report["lint"] = lint_phase(work)
    emit(report["lint"])
    report["small_input"] = small_input_phase()
    emit({"phase": "small_input", **report["small_input"]})

    t = time.perf_counter()
    corpus, queries = make_knn_benchmark_data(
        "dense", DENSE.n_points, DENSE.dim, args.queries, seed=args.seed,
        device="cuda")
    truth = brute_force_topk(corpus, queries, DENSE.bmo.k)
    emit({"phase": "data", "seconds": time.perf_counter() - t,
          "ground_truth": "float64 brute force on the card; allow_tf32 "
                          "False for matmul and cuDNN"})
    report["main_path"], idx, main_res = main_path_phase(corpus, queries,
                                                         truth, args.seed)
    emit({k: v for k, v in report["main_path"].items()
          if k not in ("traced", "traced_build")})
    emit({"phase": "traced_query", **report["main_path"]["traced"]})
    emit({"phase": "traced_build", **report["main_path"]["traced_build"]})
    report["oracle"] = oracle_phase(corpus, queries, truth)
    emit(report["oracle"])
    Qr = args.rounds_queries
    report["rounds"] = rounds_phase(idx, queries[:Qr], truth[:Qr], args.seed)
    emit(report["rounds"])
    report["tune"] = tune_phase(idx, corpus, queries, truth, args.seed)
    emit(report["tune"])
    report["plane"] = plane_phase(idx, corpus, queries, truth, main_res,
                                  args.seed)
    emit({k: v for k, v in report["plane"].items() if k != "traced_step"})
    emit({"phase": "plane_traced_step", **report["plane"]["traced_step"]})
    report["mutation"] = mutation_phase(idx, main_res, corpus, queries, truth,
                                        args.seed)
    mut = report["mutation"]
    emit({k: ({a: b for a, b in v.items() if a != "traced"}
              if k.startswith("after_") else v) for k, v in mut.items()})
    emit({"phase": "mutation_traced_after_compact",
          **mut["after_compact"]["traced"]})
    del idx, main_res
    torch.cuda.empty_cache()
    Qs = args.shard_rounds_queries
    report["sharded"] = sharded_phase(corpus, queries, truth, args.seed, Qs)
    emit(report["sharded"])
    gc.collect()
    torch.cuda.empty_cache()
    report["distributed"] = distributed_phase(corpus, queries[:Qs],
                                              truth[:Qs], args.seed)
    emit(report["distributed"])
    torch.cuda.empty_cache()
    report["paper"] = paper_phase(corpus, queries[:PAPER_QUERIES],
                                  truth[:PAPER_QUERIES], args.seed)
    emit(report["paper"])
    del corpus, queries, truth
    gc.collect()
    torch.cuda.empty_cache()
    report["fleet"] = fleet_phase(args.seed)
    emit(report["fleet"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    report["sparse"] = sparse_phase(args.seed, args.sparse_queries)
    emit(report["sparse"])
    torch.cuda.empty_cache()
    report["kmeans"] = kmeans_phase(args.seed, args.kmeans_points)
    emit(report["kmeans"])
    torch.cuda.empty_cache()
    model, init_s = build_lm(args.seed)
    report["lm_forward"] = lm_forward_phase(model, init_s, args.seed)
    emit({k: v for k, v in report["lm_forward"].items()
          if k not in ("traced", "layer_checks")})
    emit({"phase": "lm_forward_traced", **report["lm_forward"]["traced"]})
    report["serve"] = serve_phase(model, args.seed)
    emit(report["serve"])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    report["serve_cli"] = serve_cli_phase()
    emit(report["serve_cli"])
    gc.collect()
    torch.cuda.empty_cache()
    report["families"] = families_phase(args.seed)
    emit({k: v for k, v in report["families"].items() if k != "runs"})
    gc.collect()
    torch.cuda.empty_cache()
    report["train"] = train_phase(args.seed)
    emit({k: v for k, v in report["train"].items()
          if k not in ("runs", "ga_check", "smoke_check", "cli")})
    gc.collect()
    torch.cuda.empty_cache()
    report["plans"] = plans_phase(args.seed)
    emit({k: report["plans"][k] for k in (
        "phase", "seconds", "baselines_s", "four_ranks_s", "two_ranks_s",
        "launches", "launches_by_variant")})
    report["dryrun"] = dryrun_finish(dryrun, report["train"])
    emit({k: v for k, v in report["dryrun"].items()
          if k not in ("cells", "train_step")})
    report["profiler_misses"] = PROFILER_MISSES
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)

    summary = []
    for name, src, replaces, paths in KERNELS:
        row = report["kernels"][name][0]
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(report[p]["launches"][name] for p in paths),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
        if "variant" in row:
            summary[-1].update({"variant": row["variant"],
                                "other_variant_source":
                                    OTHER_VARIANT_SOURCE[name]})
        if name == "flash_attention":
            # the families phase's launches by variant, and the kernel
            # phase's rows at its shapes (nemotron's D 192 on the wide
            # instantiation among them)
            summary[-1]["families_launches_by_variant"] = \
                report["families"]["launches_by_variant"]
            summary[-1]["plans_launches_by_variant"] = \
                report["plans"]["launches_by_variant"]
            summary[-1]["families_path_checks"] = [
                {k: c[k] for k in ("arch", "variant", "shape", "causal",
                                   "max_abs_err")}
                for c in report["families"]["flash_checks"]]
            summary[-1]["family_cases"] = [
                {k: r[k] for k in ("case", "variant", "shape", "causal",
                                   "max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
                for r in report["kernels"][name]
                if r["case"] in {c[0] for c in FAMILY_FLASH_CASES}]
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "profiler_misses": PROFILER_MISSES})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
