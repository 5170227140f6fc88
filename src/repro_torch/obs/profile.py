"""Kernel profiling hooks (DESIGN.md §8.5): attribute time to kernel vs
host merge vs scheduler.

  * ``annotate(name)`` — host-side epoch loops: a
    ``torch.profiler.record_function`` range, visible on the Python thread
    track of a ``torch.profiler`` capture (the reference's
    ``jax.profiler.TraceAnnotation``). The port has no jitted code, so the
    reference's ``named_scope`` has no counterpart here: the kernels' own
    names label their device slices.
  * ``record_kernel_launch`` — per-launch coord-op accounting, host-side:
    the epoch drivers know how many kernel launches an epoch issued and what
    each cost, and fold that into the registry at the epoch boundary, under
    the reference's counter names and labels.
"""
from __future__ import annotations

import torch


def annotate(name: str):
    """Host-side profiler range (a no-op unless a profiler is recording)."""
    return torch.profiler.record_function(name)


def record_kernel_launch(obs, kernel: str, *, launches: int,
                         coord_ops: float, pulls: float = 0.0) -> None:
    """Fold one epoch's kernel-launch accounting into the registry:
    ``launches`` device programs of ``kernel`` paying ``coord_ops``
    coordinate reads total (``pulls`` block-pulls, when known)."""
    if not obs.enabled or launches <= 0:
        return
    obs.registry.counter(
        "repro_kernel_launches_total",
        "device kernel launches issued by the racing drivers",
        kernel=kernel).inc(launches)
    obs.registry.counter(
        "repro_kernel_coord_ops_total",
        "coordinate reads paid inside kernel launches",
        kernel=kernel).inc(max(coord_ops, 0.0))
    if pulls:
        obs.registry.counter(
            "repro_kernel_pulls_total",
            "block pulls executed inside kernel launches",
            kernel=kernel).inc(max(pulls, 0.0))
