"""Atomic directory checkpoints, in the reference's layout:
``<path>/arrays.npz`` (numpy, one entry per array, keyed by name) beside
``<path>/meta.msgpack``. A directory written by either package loads in the
other.

``save`` stages the whole directory in a sibling ``<path>.tmp-<pid>`` and
publishes it with one rename (``staged_dir``), so ``path`` only ever holds
a complete checkpoint, sidecars included.
"""
from __future__ import annotations

import contextlib
import os
import shutil
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import msgpack_lite

ARRAYS_FILE = "arrays.npz"
META_FILE = "meta.msgpack"


@contextlib.contextmanager
def staged_dir(path: str):
    """All-or-nothing directory publish: yields a fresh sibling tmp dir to
    write the complete new content into; on a clean exit the tmp dir
    replaces ``path`` in one rename, on an exception it is torn down and
    ``path`` is left as it was. A crash mid-write leaves at worst a stale
    ``<path>.tmp-*`` sibling that readers never look at."""
    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        yield tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save(path: str, arrays: Dict[str, Any], *,
         meta: Optional[Dict[str, Any]] = None,
         extra: Optional[Callable[[str], None]] = None) -> None:
    """Atomic write of a flat dict of tensors or arrays and its metadata.
    ``extra(tmpdir)`` stages sidecars into the same publish, so the
    checkpoint and its sidecars appear, or don't, together."""
    with staged_dir(path) as tmp:
        np.savez(os.path.join(tmp, ARRAYS_FILE),
                 **{name: _host(a) for name, a in arrays.items()})
        with open(os.path.join(tmp, META_FILE), "wb") as f:
            f.write(msgpack_lite.packb(meta or {}))
        if extra is not None:
            extra(tmp)


def load_arrays(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint's flat array dict as it was saved (host numpy)."""
    with np.load(os.path.join(path, ARRAYS_FILE)) as data:
        return {k: data[k] for k in data.files}


def read_meta(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, META_FILE), "rb") as f:
        return msgpack_lite.unpackb(f.read())
