"""Dataset containers for BMO-NN: the dense corpus in its blocked layout,
plus the §IV-B randomized-Hadamard rotation. (The sparse container waits
for the sparse box.)"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


def next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


@dataclasses.dataclass
class DenseDataset:
    """Corpus (n, d), padded so d is a multiple of the sampling block."""

    x: torch.Tensor            # (n, d_pad) float32
    d: int                     # true dimension (θ normalizer)
    block: int                 # sampling block width

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def d_pad(self) -> int:
        return self.x.shape[1]

    @property
    def n_blocks(self) -> int:
        return self.d_pad // self.block

    @classmethod
    def build(cls, x, block: int = 128) -> "DenseDataset":
        x = torch.as_tensor(x, dtype=torch.float32)
        d = x.shape[1]
        pad = (-d) % block
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        return cls(x=x, d=d, block=block)

    def pad_query(self, q) -> torch.Tensor:
        q = torch.as_tensor(q, dtype=torch.float32, device=self.x.device)
        pad = self.d_pad - q.shape[-1]
        if pad:
            q = torch.nn.functional.pad(q, (0, pad))
        return q


def rademacher(dp: int, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """(dp,) fp32 random ±1 signs, drawn from ``generator``."""
    bits = torch.randint(0, 2, (dp,), generator=generator, device=device)
    return (2 * bits - 1).to(torch.float32)


def hadamard_rotate(x: torch.Tensor, generator: torch.Generator, *,
                    use_kernel: str = "auto",
                    sign_sampler: Optional[Callable[[int], torch.Tensor]] = None):
    """§IV-B: x' = H D x per row (D = random ±1 diag, H = normalized FWHT).
    Pads d to the next power of two (paper: 'zero padding'). Preserves
    pairwise ℓ2 distances up to the common padding. The signs come from
    ``generator``, or from ``sign_sampler(dp)`` when given (the tests replay
    the reference's draw through it). Returns (x', signs)."""
    from repro_torch.kernels import ops as kops
    d = x.shape[1]
    dp = next_pow2(d)
    if dp != d:
        x = torch.nn.functional.pad(x, (0, dp - d))
    if sign_sampler is None:
        signs = rademacher(dp, generator, x.device)
    else:
        signs = torch.as_tensor(sign_sampler(dp), dtype=torch.float32,
                                device=x.device)
    return kops.fwht(x * signs[None, :], impl=use_kernel), signs
