"""Where the port's entry points run: ``cuda`` by default, the CPU only on
request. A missing GPU is an error, never a quiet fallback."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device and raises when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run its plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def make_generator(rng, device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``device``: ``rng`` is one already, or an
    integer seed."""
    if isinstance(rng, torch.Generator):
        return rng
    g = torch.Generator(device=device)
    g.manual_seed(int(rng))
    return g
