"""Typed anytime-streaming protocol of the request plane (DESIGN.md §7.2),
the reference's records unchanged.

The bandit race certifies its top-k incrementally, so a request needs more
vocabulary than "the answer": these records carry *partial* answers with an
honest uncertainty report.

  * ``Deadline`` / ``EffortBudget`` — the two early-termination contracts a
    ``QuerySpec`` can carry: wall-clock and pull-budget. A request
    terminates on whichever of {deadline, budget, full certification} comes
    first.
  * ``AnytimeResult`` — the partial/terminal result: current top-k
    estimates with CI radii, the *certified prefix* length
    (``certified_count`` leading entries are exact and final w.h.p. 1 − δ;
    everything after is a best-effort estimate), the store ``epoch`` the
    race ran against (the mutation fence tag — one result never mixes
    epochs), and a ``terminal`` flag with the exit ``reason``.
  * ``Ticket`` — the handle ``RequestPlane.submit`` returns; poll or stream
    it. Lifecycle: queued → racing → done | shed.

LeJeune et al.'s adaptive-estimation kNN and Neufeld et al.'s bandit budget
allocation (PAPERS.md) motivate exactly this shape: per-instance effort is
the algorithm's output too, and a shared pull budget is spent across
concurrent queries, not just arms.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

#: ticket lifecycle states
QUEUED = "queued"
RACING = "racing"
DONE = "done"
SHED = "shed"

#: terminal reasons
R_CERTIFIED = "certified"
R_DEADLINE = "deadline"
R_BUDGET = "budget"
R_SHED = "shed"


@dataclasses.dataclass(frozen=True)
class Deadline:
    """Wall-clock budget, measured from ``submit`` time."""

    ms: float

    def __post_init__(self):
        if not self.ms > 0:
            raise ValueError(f"deadline must be > 0 ms, got {self.ms}")


@dataclasses.dataclass(frozen=True)
class EffortBudget:
    """Pull-budget cap: scheduler epochs and/or per-query coordinate ops.
    Exceeding either terminates the request with its certified prefix."""

    epochs: Optional[int] = None       # scheduler epochs (race launches)
    coord_ops: Optional[float] = None  # max per-query coordinate reads

    def __post_init__(self):
        if self.epochs is None and self.coord_ops is None:
            raise ValueError("an EffortBudget needs epochs or coord_ops")
        if self.epochs is not None and self.epochs < 1:
            raise ValueError(f"budget epochs must be >= 1, got {self.epochs}")
        if self.coord_ops is not None and not self.coord_ops > 0:
            raise ValueError(
                f"budget coord_ops must be > 0, got {self.coord_ops}")


@dataclasses.dataclass(frozen=True)
class AnytimeResult:
    """Partial (or terminal) answer for one ticket's query batch.

    The first ``certified_count[q]`` entries of row q are the *certified
    prefix*: exact θ values, CI 0, and w.h.p. 1 − δ exactly the prefix of
    the full-certification answer. Entries after the prefix are best-effort
    estimates ordered accepted-first (an uncertified arm is never ranked
    above a certified one) with honest CI radii. ``epoch`` is the store
    epoch the race ran against — a single result never mixes epochs.
    """

    indices: Any                  # (Q, k) int — global slot ids
    values: Any                   # (Q, k) float — θ (exact ≤ certified)
    ci_radii: Any                 # (Q, k) float — 0 on the certified prefix
    certified_count: Any          # (Q,) int — certified-prefix length
    epoch: int                    # store epoch (mutation-fence tag)
    terminal: bool                # no further refinement will arrive
    reason: str                   # certified | deadline | budget | shed | …
    coord_ops: Any = None         # (Q,) coordinate reads paid
    rounds: Any = None            # (Q,) racing rounds paid
    epochs: int = 0               # scheduler epochs this ticket consumed

    def as_dict(self) -> dict:
        from repro_torch.api.spec import SCHEMA_VERSION
        out = dataclasses.asdict(self)
        out["schema_version"] = SCHEMA_VERSION
        return out


@dataclasses.dataclass
class Ticket:
    """Admission handle for one submitted query batch (one tenant)."""

    id: int
    tenant: str
    n_queries: int
    spec: Any                     # the bound QuerySpec
    status: str = QUEUED
    reason: str = ""              # shed/terminal detail
    submitted_at: float = 0.0     # time.monotonic() seconds
    admitted_at: Optional[float] = None
    finished_at: Optional[float] = None
    epochs: int = 0               # scheduler epochs consumed so far
    result: Optional[AnytimeResult] = None
    trace_id: Optional[str] = None  # obs trace id (p<plane>.t<ticket>)

    @property
    def terminal(self) -> bool:
        return self.status in (DONE, SHED)

    @property
    def latency_ms(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return 1e3 * (self.finished_at - self.submitted_at)


def percentile(samples: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile of a small host-side sample list."""
    if not samples:
        return None
    xs = sorted(samples)
    i = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[i]
