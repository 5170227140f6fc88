"""Resumable data loader: the port of ``repro/data/loader.py``.

Every batch is a pure function of (seed, step), the reference's
``lm_batch`` (``data/synthetic.py``, bit for bit), so after a restart from
a checkpoint at step s the loader resumes at step s with the same data.
Over a mesh every rank reads the same global batch and the train step
keeps each rank's rows (``train.steps.place_batch``), so the global batch
is the same at any data-parallel width, as the reference's elastic
restore needs.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.data.synthetic import lm_batch
from repro_torch.device import resolve_device


class ShardedLoader:
    """``get(step)``: {"tokens", "labels"} (batch, seq) int32 on
    ``device`` (default the current CUDA device; raises without one)."""

    def __init__(self, vocab: int, batch: int, seq: int, *, seed: int = 0,
                 device=None):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed
        self.device = resolve_device(device)

    def get(self, step: int) -> Dict[str, torch.Tensor]:
        host = lm_batch(self.vocab, self.batch, self.seq, seed=self.seed,
                        step=step)
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in host.items()}
