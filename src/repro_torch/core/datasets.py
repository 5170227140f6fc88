"""Dataset containers for BMO-NN: the dense corpus in its blocked layout,
the padded-CSR sparse corpus (§IV-A), plus the §IV-B randomized-Hadamard
rotation."""
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


@dataclasses.dataclass
class SparseDataset:
    """Padded-CSR corpus for the §IV-A sparse Monte-Carlo box (ℓ1).

    ``indices`` rows are sorted, padded with d (a sentinel larger than any
    real coordinate); ``values`` padded with 0; ``m`` is the largest nnz
    (at least 1)."""

    indices: torch.Tensor      # (n, m) int32, sorted, pad = d
    values: torch.Tensor       # (n, m) float32, pad = 0
    nnz: torch.Tensor          # (n,) int32
    d: int

    @property
    def n(self) -> int:
        return self.indices.shape[0]

    @property
    def m(self) -> int:
        return self.indices.shape[1]

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def to(self, device) -> "SparseDataset":
        """The same corpus on ``device`` (its own tensors when already
        there)."""
        return SparseDataset(indices=self.indices.to(device),
                             values=self.values.to(device),
                             nnz=self.nnz.to(device), d=self.d)

    @classmethod
    def build(cls, x, d: Optional[int] = None, *, device=None,
              chunk_elems: int = 1 << 27) -> "SparseDataset":
        """From a dense (n, d) array or tensor, zeros dropped. A tensor is
        compressed on its own device (``device`` moves it first; a numpy
        array goes to the CPU unless ``device`` says otherwise), with no
        loop over rows: rows are taken ``chunk_elems // d`` at a time, so
        the int64 coordinates of their nonzeros stay bounded."""
        x = torch.as_tensor(x, device=device)
        n, d_ = x.shape
        d = d or d_
        rows = max(1, chunk_elems // max(d_, 1))
        nnz = torch.cat([torch.count_nonzero(x[s:s + rows], dim=1)
                         for s in range(0, n, rows)] or
                        [x.new_zeros((0,), dtype=torch.int64)]).to(torch.int32)
        m = max(int(nnz.max()) if n else 0, 1)
        indices = torch.full((n, m), d, dtype=torch.int32, device=x.device)
        values = torch.zeros((n, m), dtype=torch.float32, device=x.device)
        for s in range(0, n, rows):
            r, c = torch.nonzero(x[s:s + rows], as_tuple=True)  # row-major
            place_rows(indices, values, s, r, nnz[s:s + rows],
                       c.to(torch.int32), x[s + r, c].to(torch.float32))
        return cls(indices=indices, values=values, nnz=nnz, d=d)


def place_rows(indices, values, s: int, r, nnz, idx, val) -> None:
    """Write nonzeros of rows s, s+1, … to their CSR slots: entry e lies in
    row s + r[e], the entries come in row-major order (so each row's in
    ascending coordinate order), and the k-th entry of a row goes to its
    column k. ``nnz`` are those rows' counts; ``values`` and ``val`` may be
    None (the indices alone)."""
    start = torch.cumsum(nnz.to(torch.int64), 0) - nnz.to(torch.int64)
    pos = torch.arange(r.numel(), device=r.device) - start[r]
    indices[s + r, pos] = idx
    if values is not None:
        values[s + r, pos] = val


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
