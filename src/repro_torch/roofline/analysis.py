"""Roofline terms of a dry-run cell, the port of
``repro/roofline/analysis.py``:

    compute    = flops / (chips × peak flop rate)
    memory     = bytes / (chips × HBM rate)
    collective = collective bytes / (chips × link rate × links)

The rates are one NVIDIA H100 SXM's (``repro_torch.hardware``): the bf16
tensor cores' 989e12 flop/s, HBM3's 3.35e12 B/s, and for collectives one
400 Gb/s NDR InfiniBand port a GPU, 50e9 B/s each way. A 16 × 16 mesh of
H100s spans 32 nodes of 8 (DGX H100's layout), so a 16-wide axis crosses
nodes and the slowest hop of its collectives is the InfiniBand port; the
reference keeps one rate for every collective, and so does this port.
NVLink's 450e9 B/s each way inside a node is recorded in ``hardware.py``
and unused.

The counts come from ``roofline/count.py``'s counting mode, one rank's
program × chips for the totals, as the reference multiplies its per-device
SPMD program.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch import hardware


@dataclasses.dataclass(frozen=True)
class Hardware:
    peak_flops: float = hardware.BF16_TC_FLOPS       # bf16 FLOP/s a chip
    hbm_bw: float = hardware.HBM_BYTES_PER_S         # B/s a chip
    ici_bw: float = hardware.LINK_BYTES_PER_S        # B/s a link
    ici_links: int = 1                               # one NDR port a GPU


HW = Hardware()


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_ops: int
    model_flops: float
    peak_memory_per_chip: float

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * HW.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HW.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * HW.ici_bw * HW.ici_links)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """model-useful compute time / achievable step time (the largest
        term)."""
        t_useful = self.model_flops / (self.chips * HW.peak_flops)
        t_step = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / max(t_step, 1e-30)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes, "coll_ops": self.coll_ops,
            "model_flops": self.model_flops,
            "peak_memory_per_chip": self.peak_memory_per_chip,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def analyze_counts(counts, *, arch: str, shape: str, mesh_name: str,
                   chips: int, model_flops: float,
                   arg_bytes: float = 0.0) -> RooflineTerms:
    """The three terms from one rank's counts (a ``count.Counts``): the
    totals are × chips, the counterpart of the reference's
    ``analyze_compiled``. ``hlo_*`` keep the reference's key names; here
    they are the counting mode's totals, not XLA's. The peak a chip is the
    rank's arguments (``arg_bytes``: its shards of the state, the batch
    and the cache) plus the largest live set of intermediates."""
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=counts.flops * chips,
        hlo_bytes=counts.bytes_accessed * chips,
        coll_bytes=counts.coll_bytes * chips, coll_ops=counts.coll_ops,
        model_flops=model_flops,
        peak_memory_per_chip=float(arg_bytes) + counts.peak_live_bytes)


def model_flops_estimate(cfg, shape, n_params_active: float,
                         n_params_total: Optional[float] = None) -> float:
    """6·N·D for train, 2·N·D for inference (D = processed tokens)."""
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_params_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_params_active * tokens
    # decode: one token per sequence
    return 2.0 * n_params_active * shape.global_batch
