"""Tuned-config records and the candidate grid (DESIGN.md §9.1), the
reference's, over the port's knobs.

``TunedConfig`` is the unit the autotuner races, persists, and the
``Index`` handle applies: the per-store knobs that trade launch overhead
against wasted pulls —

  * ``epoch_rounds`` (R)      — racing rounds fused per kernel launch,
  * ``pulls_per_round`` (P)   — block pulls folded per round (T = R·P),
  * ``batch_arms`` (B)        — arms racing per launch,
  * ``frontier_floor``        — smallest survivor bucket the frontier
                                shrinks to (0 = derived),
  * ``kernel_buffers``        — the pair schedule's ring of pulls in flight
                                per arm in ``csrc/fused_epoch_pull.cu``
                                (``n_buf``, ``kernels/pull_schedule.py``),
  * ``mode``                  — fused-epoch vs per-round driver,

plus the measured per-epoch / per-round wall costs the racer observed —
the estimates the request plane's deadline-aware round selection runs on.

The grid is deliberately small and pow2-shaped, and the cost model
(``seed.py``) prunes it further before anything is timed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from repro_torch.configs.base import BMOConfig
from repro_torch.kernels.pull_schedule import fused_schedule
from repro_torch.tune.signature import backend_of

#: bump on any TunedConfig field change — stale sidecars then fail closed.
TUNED_VERSION = 1

#: BMOConfig fields a TunedConfig overrides when bound.
_BIND_FIELDS = ("epoch_rounds", "pulls_per_round", "batch_arms",
                "frontier_floor", "kernel_buffers")


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    epoch_rounds: int
    pulls_per_round: int
    batch_arms: int
    frontier_floor: int = 0
    kernel_buffers: int = 2
    mode: str = "auto"            # dispatch default when the spec says auto
    epoch_ms: float = 0.0         # measured mean wall per fused epoch
    round_ms: float = 0.0         # measured mean wall per racing round

    def bind(self, cfg: BMOConfig) -> BMOConfig:
        """Apply the racing knobs onto a store's build-time config (k, δ,
        metric, budgets stay the store's own — tuning never changes what
        the race certifies, only what it costs)."""
        return dataclasses.replace(
            cfg, **{f: getattr(self, f) for f in _BIND_FIELDS})

    def with_measured(self, *, epoch_ms: float,
                      round_ms: float) -> "TunedConfig":
        return dataclasses.replace(self, epoch_ms=float(epoch_ms),
                                   round_ms=float(round_ms))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TunedConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: d[k] for k in fields})

    @classmethod
    def from_cfg(cls, cfg: BMOConfig, mode: str = "auto") -> "TunedConfig":
        """The identity candidate: the store's hand-set defaults. Always in
        the race, so tuning can only tie or win."""
        return cls(mode=mode,
                   **{f: getattr(cfg, f) for f in _BIND_FIELDS})


def _fits(store, B: int, T: int, n_buf: int) -> bool:
    """Whether the fused pull's pair schedule can hold ``n_buf`` slots of
    the store's blocks in shared memory (the schedule takes fewer warps
    before it gives up)."""
    try:
        fused_schedule(1, B, T, store.d_pad, store.block, n_buf, False)
    except ValueError:
        return False
    return True


def candidate_grid(store, *, backend: str = "") -> List[TunedConfig]:
    """Enumerate the (R, P, B, floor, buffers, mode) grid for ``store``.

    Sparse boxes race on the per-round driver only (no corpus blocks to
    fuse), so their grid is the R sweep at mode="rounds". Dense/rotated
    boxes get the fused cross product plus one per-round candidate.
    ``kernel_buffers`` varies in (2, 4) only where the CUDA kernel runs
    (``backend == "cuda"``): the plain version on the CPU ignores the knob,
    so racing it there would time noise. A buffer count whose ring the
    pair schedule cannot fit in shared memory is left out of the grid. The
    identity candidate (the store's current config) is always first.
    ``backend`` defaults to the store's device type.
    """
    backend = backend or backend_of(store)
    cfg = store.cfg
    n = store.n_live
    out = [TunedConfig.from_cfg(cfg)]
    if store.kind == "sparse":
        for R in (2, 4, 8):
            out.append(TunedConfig(
                epoch_rounds=R, pulls_per_round=cfg.pulls_per_round,
                batch_arms=cfg.batch_arms, mode="rounds"))
        return _dedup(out)
    n_blocks = max(store.d // store.block, 1)
    bufs = (2, 4) if backend == "cuda" else (2,)
    for R in (2, 4, 8):
        for P in (1, 2, 4):
            if R * P > 4 * n_blocks:   # epoch pulls > 4 passes over the
                continue               # row's blocks: pure waste
            for B in (16, 32, 64):
                if B > n:
                    continue
                for floor in (0, 128):
                    for nb in bufs:
                        if nb != 2 and not _fits(store, B, R * P, nb):
                            continue
                        out.append(TunedConfig(
                            epoch_rounds=R, pulls_per_round=P,
                            batch_arms=B, frontier_floor=floor,
                            kernel_buffers=nb, mode="fused"))
    # one per-round fallback arm (launch fusion is not always a win)
    out.append(TunedConfig(
        epoch_rounds=cfg.epoch_rounds, pulls_per_round=cfg.pulls_per_round,
        batch_arms=cfg.batch_arms, mode="rounds"))
    return _dedup(out)


def _dedup(cands: List[TunedConfig]) -> List[TunedConfig]:
    seen, out = set(), []
    for c in cands:
        key = dataclasses.astuple(dataclasses.replace(
            c, epoch_ms=0.0, round_ms=0.0))
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out


def bind_store(store, cfg: BMOConfig):
    """Rebind a store onto ``cfg`` without touching its arrays (every
    shard's config, for a sharded store)."""
    from repro_torch.index.sharded import with_cfg
    return with_cfg(store, cfg)


def tuned_mode(tuned: Optional["TunedConfig"], spec_mode: str) -> str:
    """Dispatch-time mode resolution: an explicit spec mode always wins;
    "auto" defers to the tuned preference when one is installed."""
    if spec_mode != "auto" or tuned is None:
        return spec_mode
    return tuned.mode
