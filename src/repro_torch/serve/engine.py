"""Batched serving engine with the BMO-NN retrieval hook (kNN-LM
interpolation: the paper's technique at serving time), the port of
``repro/serve/engine.py``.

A small engine (static batch of decode slots, greedy decoding): prefill,
then each decode step's final hidden states are a k-NN query against a
datastore of (hidden, next-token) pairs, and the neighbours' distance-
weighted vote is interpolated into the LM's distribution.

Retrieval goes through one ``repro_torch.api.Index`` handle, built at
construction or passed in built or loaded; the next-token payload rides the
handle. The engine owns a request plane (``serve.plane.RequestPlane``) over
that handle, or takes one passed in: each step's retrieval is the plane's
blocking ``query`` shim under the reserved tenant ``"__engine__"``, so
external tickets on ``engine.plane`` share its scheduler and query cache.
With ``index_append=True`` each step's (hidden, next-token) pairs are
inserted back into the index, and the handle's ``CompactionPolicy``
amortises the tombstone debt.

The model is an ``nn.Module`` holding its weights (no parameter tree);
the engine runs on one device, or under a plan over a mesh of ranks
(``mesh=``: the model and cache laid out, every rank generating the same
tokens), and a sharded index
(``index_shards > 1``) puts its shards on that device. On a fleet's shared
plane (``Fleet.serve()``) the retrieval tickets carry ``plane_namespace``,
and the payload lookups and appends go to that namespace's live handle,
reloaded by the fleet when it was evicted.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.api import (CachePolicy, CompactionPolicy, Index, QueryCache,
                             ServeStats)
from repro_torch.configs.base import BMOConfig, ParallelPlan
from repro_torch.device import resolve_device
from repro_torch.serve.plane import PlaneConfig, RequestPlane
from repro_torch.serve.steps import (COMPUTE_DTYPE, init_cache,
                                     make_prefill_step)
from repro_torch.sharding import context as sctx
from repro_torch.sharding.place import place
from repro_torch.sharding.spec import rules_for
from repro_torch.train.steps import batch_pspecs

__all__ = ["KNNLMConfig", "QueryCache", "ServeEngine", "TOKEN_FAMILIES"]

# the families whose prefill reads token prompts, which ``generate`` feeds;
# the VLM reads embeddings and whisper frames, and the reference's engine
# fails on them
TOKEN_FAMILIES = ("dense", "moe", "ssm", "hybrid")

# the decode loop's tenant on the plane: external backpressure can shed
# external tickets, never this one
ENGINE_TENANT = "__engine__"
# seeds a step's race draws from: [0, 2**31)
_SEED_SPAN = 2 ** 31


@dataclasses.dataclass
class KNNLMConfig:
    """The kNN-LM hook's knobs, the reference's, with its defaults."""

    lam: float = 0.25          # interpolation weight toward the kNN dist
    temperature: float = 1.0
    bmo: BMOConfig = dataclasses.field(default_factory=lambda: BMOConfig(k=8))
    cache_size: int = 256      # query LRU entries (0 disables)
    compact_threshold: float = 0.5  # auto-compact when tombstones cross this
                                    # (>=1 disables)
    index_shards: int = 0      # >1: a sharded index (its shards on the
                               # engine's device)
    near_threshold: float = 0.95    # cosine similarity above which a cache
                                    # miss races CI-warm-started from the
                                    # cached neighbour (0 disables)
    near_prior_scale: float = 0.25  # variance-prior tightening applied to
                                    # the cached neighbour's top-k arms
    plane: PlaneConfig = dataclasses.field(default_factory=PlaneConfig)

    def cache_policy(self) -> CachePolicy:
        return CachePolicy(capacity=self.cache_size,
                           near_threshold=self.near_threshold,
                           near_prior_scale=self.near_prior_scale)

    def compaction_policy(self) -> CompactionPolicy:
        return CompactionPolicy(threshold=self.compact_threshold)


def step_seeds(rng):
    """One race seed a decode step: from an integer seed s, step i draws
    with ``SeedSequence([s, i])``; from a ``torch.Generator``, each step
    takes the next integer it draws."""
    if isinstance(rng, torch.Generator):
        while True:
            yield int(torch.randint(_SEED_SPAN, (1,), generator=rng,
                                    device=rng.device))
    seed = 0 if rng is None else int(rng)
    step = 0
    while True:
        yield int(np.random.SeedSequence([seed, step]).generate_state(1)[0]
                  % _SEED_SPAN)
        step += 1


class ServeEngine:
    def __init__(self, model, plan: Optional[ParallelPlan] = None, *,
                 batch_size: int, max_seq: int,
                 knn_lm: Optional[KNNLMConfig] = None,
                 datastore=None, index=None, index_append: bool = False,
                 plane: Optional[RequestPlane] = None,
                 plane_namespace: Optional[str] = None, device=None,
                 mesh=None):
        """``model``: a model of a token family (``TOKEN_FAMILIES``) on
        ``device`` (default: the GPU; raises without one); the kNN-LM hook
        reads hidden states, which only the dense family exposes. ``datastore``: (keys (N, d), next-token ids (N,)),
        preprocessed into an ``Index`` here. ``index``: a built or loaded
        ``Index``, or a raw ``IndexStore`` wrapped on the way in (pass the
        next-token ids as ``datastore=(None, ids)``). ``index_append``:
        insert each decode step's (hidden, token) pairs into the index.
        ``plane``: a ``RequestPlane`` owned elsewhere, in place of a private
        one (e.g. a fleet's shared plane from ``Fleet.serve()``).
        ``plane_namespace``: the namespace label the decode loop's
        retrieval tickets carry on a fleet's plane (None on a one-index
        plane). There the engine keeps no handle of its own: ``index``
        (given, if at all, to attach the next-token ids) is read back from
        the router at each use, so an evicted namespace is not pinned.
        ``mesh``: serve under ``plan`` over this ``DeviceMesh``, the
        model's parameters laid out on it (``serve.steps.place_model``),
        the cache sharded batch × heads, every rank running the same
        ``generate`` (the reference's ``ServeEngine`` over its mesh); the
        retrieval index stays where it is, on each rank's device."""
        device = resolve_device(device)
        family = model.cfg.family
        if family not in TOKEN_FAMILIES:
            raise ValueError(f"the engine serves token prompts; the "
                             f"{family!r} family reads "
                             f"{'embeddings' if family == 'vlm' else 'frames'}"
                             f" (serving families: {TOKEN_FAMILIES})")
        if knn_lm is not None and family != "dense":
            raise ValueError("the kNN-LM hook needs a hidden-state-exposing "
                             f"DenseLM, not the {family!r} family")
        if model.device != device:
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"serves on {device}")
        self.model = model
        self.device = device
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.mesh = mesh
        self.rules = rules_for(plan, mesh) if mesh is not None else None
        self.prefill_step = make_prefill_step(model, plan, mesh,
                                              rules=self.rules)
        self.knn_lm = knn_lm
        self._index: Optional[Index] = None
        self.index_append = index_append
        self.plane_namespace = plane_namespace
        self._router = (getattr(plane, "router", None)
                        if plane_namespace is not None else None)
        if self._router is not None and (
                not (index is None or isinstance(index, Index))
                or (datastore is not None and datastore[0] is not None)):
            raise ValueError("behind a fleet's plane the namespace comes from "
                             "the fleet: pass its handle or none, not a "
                             "store or a datastore to build")
        if knn_lm is not None and (index is not None or datastore is not None
                                   or self._router is not None):
            next_ids = datastore[1] if datastore is not None else None
            if next_ids is not None:
                next_ids = np.asarray(next_ids, np.int32)
            if index is None and self._router is not None:
                index = self._router.get(plane_namespace)
            if isinstance(index, Index):
                handle = index
                if next_ids is not None:
                    handle.attach_payload(next_ids)
            elif index is not None:
                handle = Index.open(index, payload=next_ids,
                                    cache=knn_lm.cache_policy(),
                                    compaction=knn_lm.compaction_policy())
            else:
                handle = Index.build(
                    datastore[0], knn_lm.bmo, 7,
                    shards=max(knn_lm.index_shards, 1), payload=next_ids,
                    cache=knn_lm.cache_policy(),
                    compaction=knn_lm.compaction_policy(), device=device)
            if handle.payload is None:
                # uncovered slots vote token 0: make that explicit
                handle.attach_payload(np.zeros((handle.capacity,), np.int32))
            if self._router is None:
                self._index = handle
        if plane is not None:
            self.plane: Optional[RequestPlane] = plane
        else:
            self.plane = (RequestPlane(self._index, knn_lm.plane)
                          if self._index is not None else None)
        self.cache = init_cache(model, batch_size, max_seq, mesh=mesh,
                                plan=plan, rules=self.rules)

    @torch.no_grad()
    def decode_step(self, cache, tokens):
        """(logits, new_cache, last hidden (B, d) in fp32, or None without
        the kNN-LM hook), in bf16; over a mesh, the logits and hidden
        whole on every rank."""
        if self.mesh is None:
            return self._decode(cache, tokens, lambda t: t)
        with sctx.activation_sharding(self.rules, self.mesh):
            tokens = place(tokens, batch_pspecs(
                {"tokens": tokens}, self.rules)["tokens"], self.mesh)
            return self._decode(cache, tokens, sctx.replicated)

    def _decode(self, cache, tokens, whole):
        if self.knn_lm is None:
            logits, new_cache = self.model.decode_step(
                cache, tokens, compute_dtype=COMPUTE_DTYPE)
            return whole(logits), new_cache, None
        logits, new_cache, hidden = self.model.decode_step(
            cache, tokens, compute_dtype=COMPUTE_DTYPE, return_hidden=True)
        return (whole(logits), new_cache,
                whole(hidden)[:, -1].to(torch.float32))

    # -- kNN-LM hook (the paper's technique in the serving path) ------------

    @property
    def stats(self) -> ServeStats:
        """The plane's typed serving counters (``ServeStats``, schema v2):
        cache hits and misses, races, near-repeat warm starts, compactions,
        queue depth, shed counts, latency percentiles, audit counts."""
        if self.plane is not None:
            return self.plane.stats
        return self._index.stats if self._index is not None else ServeStats()

    def _knn_logits(self, hidden, rng):
        """(log(p_knn + 1e-9) (B, V) fp32, coordinate ops): the plane's
        certified top-k of the rows ``hidden``, each neighbour voting its
        next token with weight softmax(−value / T); repeated tokens add
        up."""
        res = self.plane.query(hidden, rng=rng, tenant=ENGINE_TENANT,
                               namespace=self.plane_namespace)
        ops = float(np.asarray(res.coord_ops).sum())
        B = res.indices.shape[0]
        V = self.model.cfg.vocab_size
        vals = torch.as_tensor(np.asarray(res.values, np.float32),
                               device=self.device)
        w = torch.softmax(-vals / self.knn_lm.temperature, dim=-1)
        toks = torch.as_tensor(self.index.payload[np.asarray(res.indices)],
                               dtype=torch.int64, device=self.device)
        probs = torch.zeros((B, V), dtype=torch.float32, device=self.device)
        probs.scatter_add_(1, toks, w)
        return torch.log(probs + 1e-9), ops

    def _append_to_index(self, hidden, tok):
        """Fold this step's (hidden, next-token) pairs into the live index:
        the handle keeps the payload aligned through growth and compaction,
        fences the cache and applies its ``CompactionPolicy``."""
        index = self.index
        index.insert(hidden, payload=tok[:, 0].cpu().numpy())
        index.maybe_compact()

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, max_new_tokens: int, rng=None):
        """prompts (B, S0) int → ((B, max_new_tokens) int32 greedy tokens,
        retrieval coordinate ops). With the kNN-LM hook, each decode step's
        log-probabilities are mixed with the retrieval's: log((1 − λ)·p_LM
        + λ·p_kNN). ``rng`` (a seed, default 0, or a ``torch.Generator``)
        gives each step's race its own seed (``step_seeds``)."""
        B = prompts.shape[0]
        if B != self.batch_size:
            raise ValueError(f"{B} prompts for {self.batch_size} slots")
        seeds = step_seeds(rng)
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                 device=self.device)
        logits, cache = self.prefill_step({"tokens": tokens}, self.cache)
        tok = torch.argmax(logits[:, -1].to(torch.float32),
                           dim=-1).to(torch.int32)[:, None]
        out = [tok]
        retrieval_ops = 0.0
        for _ in range(max_new_tokens - 1):
            logits, cache, hidden = self.decode_step(cache, tok)
            mix, ops = self._mix(logits, hidden, seeds)
            retrieval_ops += ops
            tok = torch.argmax(mix, dim=-1).to(torch.int32)[:, None]
            if self._knn_on and self.index_append:
                self._append_to_index(hidden, tok)
            out.append(tok)
        self.cache = cache
        return torch.cat(out, dim=1).cpu().numpy(), retrieval_ops

    @property
    def index(self) -> Optional[Index]:
        """The retrieval index: behind a fleet's plane the namespace's live
        handle, fetched from the router (reloaded if it was evicted), else
        the engine's own."""
        if self._router is not None:
            return self._router.get(self.plane_namespace)
        return self._index

    @property
    def _knn_on(self) -> bool:
        return self.knn_lm is not None and (self._index is not None
                                            or self._router is not None)

    def _mix(self, logits, hidden, seeds):
        """A decode step's log-probabilities (B, V) in fp32 and the
        retrieval's coordinate ops: the LM's alone, or with the hook
        log((1 − λ)·p_LM + λ·p_kNN), its race seeded by ``next(seeds)``."""
        mix = torch.log_softmax(logits[:, -1].to(torch.float32), dim=-1)
        if not self._knn_on:
            return mix, 0.0
        knn_logits, ops = self._knn_logits(hidden, next(seeds))
        lam = torch.tensor(self.knn_lm.lam, dtype=torch.float32,
                           device=self.device)
        return torch.logaddexp(
            torch.log1p(-lam) + mix,
            torch.log(lam) + torch.log_softmax(knn_logits, dim=-1)), ops
