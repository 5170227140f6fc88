"""The sanctioned device→host boundary (DESIGN.md §8, §12.4).

The serving stack's transfer discipline: tensors cross to the host at ONE
deliberate boundary per epoch, and everything downstream works on
host-resident numpy. ``host_fetch`` is that boundary. A tuple (or list) of
tensors crosses as ONE ``.cpu()``: their bytes are packed into one uint8
tensor on the device, copied once, and viewed back as numpy arrays of
their own dtypes and shapes, bit for bit. Values already on the host
(numpy arrays, Python scalars) pass through, so call sites do not branch
on residency.

``syncs()`` counts the calls that moved at least one tensor (on any
device), so a driver's syncs per epoch can be held to its design;
``reset_syncs()`` sets the count to 0.
"""
from __future__ import annotations

import torch

__all__ = ["host_fetch", "reset_syncs", "syncs"]

_syncs = 0


def syncs() -> int:
    """Calls of ``host_fetch`` that moved tensors since the last reset."""
    return _syncs


def reset_syncs() -> None:
    global _syncs
    _syncs = 0


def _numpy_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def host_fetch(value):
    """Bring ``value`` (a tensor, or a tuple or list of tensors and host
    values) to the host as numpy, in one device→host copy."""
    global _syncs
    if isinstance(value, torch.Tensor):
        _syncs += 1
        return value.detach().cpu().numpy()
    if not isinstance(value, (tuple, list)):
        return value
    tensors = [v for v in value if isinstance(v, torch.Tensor)]
    if not tensors:
        return type(value)(value)
    _syncs += 1
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])
    raw = flat.cpu().numpy()
    out, at = [], 0
    for v in value:
        if not isinstance(v, torch.Tensor):
            out.append(v)
            continue
        dt = _numpy_dtype(v.dtype)
        nbytes = v.numel() * dt.itemsize
        out.append(raw[at:at + nbytes].view(dt).reshape(tuple(v.shape)))
        at += nbytes
    return type(value)(out)
