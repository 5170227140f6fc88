"""IndexStore: the corpus container behind the batched BMO-NN index
(DESIGN.md §3).

One store owns what the paper's Algorithm 2 would recompute per call: the
padded, blocked corpus layout (dense), the cached Hadamard rotation (sign
vector + pre-rotated corpus; only queries are rotated at request time), or
the padded-CSR layout (sparse, §IV-A); per-arm block-statistics priors;
and the ``alive`` tombstone mask. Arrays are capacity-padded (slots ≥ live
points).

``from_arrays`` takes the reference store's ``arrays()`` (as numpy) and
``meta()`` unchanged, so an index built by either package races in the
other.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import BMOConfig
from repro_torch.device import resolve_device

KINDS = ("dense", "rotated", "sparse")


@dataclasses.dataclass
class IndexStore:
    kind: str                           # dense | rotated | sparse
    cfg: BMOConfig                      # racing defaults bound at build time
    d: int                              # true dimension (θ normalizer)
    alive: torch.Tensor                 # (cap,) bool — tombstone mask
    # --- dense / rotated layout ---
    x: Optional[torch.Tensor] = None    # (cap, d_pad) fp32, blocked layout
    block: int = 128
    signs: Optional[torch.Tensor] = None      # (d_pad,) ±1 — cached rotation
    # --- sparse (padded-CSR) layout ---
    indices: Optional[torch.Tensor] = None    # (cap, m) int32, sorted, pad d
    values: Optional[torch.Tensor] = None     # (cap, m) fp32, pad 0
    nnz: Optional[torch.Tensor] = None        # (cap,) int32
    # --- priors ---
    prior_var: Optional[torch.Tensor] = None  # (cap,) per-arm variance
    prior_weight: float = 4.0                 # pseudo-observations

    @property
    def device(self) -> torch.device:
        return self.alive.device

    @property
    def capacity(self) -> int:
        return int(self.alive.shape[0])

    @property
    def n_live(self) -> int:
        # cached per instance: the k guard of every query reads it, and a
        # device sync per call would serialize host and device
        if "_n_live" not in self.__dict__:
            self._n_live = int(torch.sum(self.alive))
        return self._n_live

    @property
    def d_pad(self) -> int:
        return self.x.shape[1]

    @property
    def n_blocks(self) -> int:
        return self.d_pad // self.block

    @property
    def m(self) -> int:
        """The sparse layout's width: the largest nnz it holds."""
        return self.indices.shape[1]

    # -- query-side preprocessing ------------------------------------------

    def prepare_queries(self, queries, impl: str = "auto") -> torch.Tensor:
        """Pad (and rotate, with the cached signs) a (Q, d) query batch into
        the store's (Q, d_pad) layout on the store's device. Dense and
        rotated stores: a sparse store races the padded triplet as is."""
        from repro_torch.kernels import ops as kops
        if self.kind == "sparse":
            raise ValueError("a sparse store takes the (q_idx, q_val, "
                             "q_nnz) triplet, not dense queries")
        qs = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        pad = self.d_pad - qs.shape[-1]
        if pad:
            qs = torch.nn.functional.pad(qs, (0, pad))
        if self.kind == "rotated":
            qs = kops.fwht(qs * self.signs[None, :], impl=impl)
        return qs

    # -- (de)serialization --------------------------------------------------

    def arrays(self) -> dict:
        """The arrays a checkpoint persists, as tensors."""
        out = {"alive": self.alive}
        for name in ("x", "signs", "indices", "values", "nnz", "prior_var"):
            arr = getattr(self, name)
            if arr is not None:
                out[name] = arr
        return out

    def meta(self) -> dict:
        return {
            "kind": self.kind,
            "d": self.d,
            "block": self.block,
            "prior_weight": float(self.prior_weight),
            "cfg": dataclasses.asdict(self.cfg),
        }

    @classmethod
    def from_arrays(cls, arrays: dict, meta: dict,
                    device=None) -> "IndexStore":
        """A store from persisted arrays (numpy or tensors) and metadata —
        the reference's ``arrays()``/``meta()`` load unchanged. Runs on
        ``device`` (default: the GPU)."""
        if meta["kind"] not in KINDS:
            raise ValueError(f"unknown store kind {meta['kind']!r}")
        dev = resolve_device(device)

        def opt(name, dtype):
            if name not in arrays:
                return None
            a = arrays[name]
            if not isinstance(a, torch.Tensor):
                a = np.asarray(a)
                # a CPU store would share the caller's memory, and torch
                # cannot wrap a read-only array: copy only then; a CUDA
                # store transfers straight from the array
                if dev.type == "cpu" or not a.flags.writeable:
                    a = np.array(a)
                a = torch.from_numpy(a)
            return a.to(device=dev, dtype=dtype)

        return cls(
            kind=meta["kind"], cfg=BMOConfig(**meta["cfg"]), d=int(meta["d"]),
            alive=opt("alive", torch.bool), x=opt("x", torch.float32),
            block=int(meta["block"]), signs=opt("signs", torch.float32),
            indices=opt("indices", torch.int32),
            values=opt("values", torch.float32),
            nnz=opt("nnz", torch.int32), prior_var=opt("prior_var", torch.float32),
            prior_weight=float(meta.get("prior_weight", 4.0)),
        )


def free_slots(store: IndexStore) -> np.ndarray:
    """Host-side list of dead slot ids (insert targets), ascending."""
    return np.nonzero(~store.alive.cpu().numpy())[0]
