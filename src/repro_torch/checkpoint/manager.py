"""Atomic directory checkpoints, in the reference's layout:
``<path>/arrays.npz`` (numpy, one entry per array, keyed by its ``/``-joined
path in the saved state) beside ``<path>/meta.msgpack``. A directory
written by either package loads in the other.

``save`` stages the whole directory in a sibling ``<path>.tmp-<pid>`` and
publishes it with one rename (``staged_dir``), so ``path`` only ever holds
a complete checkpoint, sidecars included. ``restore`` reads one back into
the structure and dtypes of a template; ``CheckpointManager`` keeps the
last N steps of a training state under ``<dir>/step_<n>/``, optionally
writing each on a background thread.
"""
from __future__ import annotations

import contextlib
import logging
import os
import shutil
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import msgpack_lite
from repro_torch.device import resolve_device

log = logging.getLogger("repro_torch.checkpoint")

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


def _host(a, *, copy: bool = False) -> np.ndarray:
    """A host array of a tensor or array; bf16 is upcast to fp32 (numpy has
    no bf16, the upcast is lossless and ``restore`` casts back), as the
    reference does. ``copy``: never a view of the input's memory (a device
    tensor's host copy is one already)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        fresh = a.device.type != "cpu" or a.dtype == torch.bfloat16
        if a.dtype == torch.bfloat16:
            a = a.float()
        a = a.cpu().numpy()
        return a.copy() if copy and not fresh else a
    return np.array(a) if copy else np.asarray(a)


def _is_spec(leaf) -> bool:
    """A ``(shape, dtype)`` template leaf."""
    return (isinstance(leaf, tuple) and len(leaf) == 2
            and isinstance(leaf[0], (tuple, list, torch.Size))
            and not isinstance(leaf[1], (tuple, list, dict)))


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Leaves of a nested dict/list/tuple keyed by their ``/``-joined path
    (dict keys, sequence positions), the reference's checkpoint keys; a
    flat dict keeps its keys."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and not _is_spec(tree):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, sub in items:
        out.update(_flatten(sub, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _unflatten(tree, leaves: Dict[str, Any], prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(tree, dict):
        return type(tree)((key, _unflatten(
            sub, leaves, f"{prefix}/{key}" if prefix else str(key)))
            for key, sub in tree.items())
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return type(tree)(_unflatten(
            sub, leaves, f"{prefix}/{i}" if prefix else str(i))
            for i, sub in enumerate(tree))
    return leaves[prefix]


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def save(path: str, state, *, meta: Optional[Dict[str, Any]] = None,
         extra: Optional[Callable[[str], None]] = None) -> None:
    """Atomic write of a state (a flat or nested dict of tensors or arrays)
    and its metadata. ``extra(tmpdir)`` stages sidecars into the same
    publish, so the checkpoint and its sidecars appear, or don't,
    together."""
    with staged_dir(path) as tmp:
        np.savez(os.path.join(tmp, ARRAYS_FILE),
                 **{name: _host(a) for name, a in _flatten(state).items()})
        with open(os.path.join(tmp, META_FILE), "wb") as f:
            f.write(msgpack_lite.packb(meta or {}))
        if extra is not None:
            extra(tmp)


def restore(path: str, like, *, device=None):
    """The checkpoint at ``path`` in the structure of ``like``: a nested
    dict (or list, or a ``state_dict``) of tensors, arrays or ``(shape,
    dtype)`` specs. Each leaf comes back as a tensor of the template's
    dtype (bf16 included) on ``device``; by default a tensor template's
    own device, and the GPU for the others (raises without one). A key the
    checkpoint lacks raises ``KeyError``, a shape that differs
    ``ValueError``."""
    arrays = load_arrays(path)
    out = {}
    for key, leaf in _flatten(like).items():
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key!r}")
        if _is_spec(leaf):
            shape, dtype = tuple(leaf[0]), _torch_dtype(leaf[1])
            dev = resolve_device(device)
        else:
            shape, dtype = tuple(leaf.shape), _torch_dtype(leaf.dtype)
            dev = (torch.device(device) if device is not None
                   else leaf.device if isinstance(leaf, torch.Tensor)
                   else resolve_device(None))
        arr = arrays[key]
        if tuple(arr.shape) != shape:
            raise ValueError(f"checkpoint {key!r} has shape {arr.shape}, "
                             f"the template {shape}")
        # np.array copies (keeping a 0-d leaf 0-d): a tensor of its own
        out[key] = torch.from_numpy(np.array(arr)).to(device=dev,
                                                       dtype=dtype)
    return _unflatten(like, out)


def load_arrays(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint's flat array dict as it was saved (host numpy)."""
    with np.load(os.path.join(path, ARRAYS_FILE)) as data:
        return {k: data[k] for k in data.files}


def read_meta(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, META_FILE), "rb") as f:
        return msgpack_lite.unpackb(f.read())


class CheckpointManager:
    """Keep-last-N checkpoints of a state under ``<directory>/step_<n>/``
    (the reference's names), each an atomic ``save``. With ``async_save``
    the state is copied to the host before ``save`` returns (a later
    in-place update of a CUDA tensor cannot race the write) and the files
    are written on a background thread; ``wait`` joins it and re-raises
    what it raised."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def all_steps(self):
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, state,
             meta: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        # the host snapshot is taken here, before any thread starts
        host = {name: _host(a, copy=True)
                for name, a in _flatten(state).items()}
        meta = dict(meta or {}, step=step)

        def _do():
            save(self._step_dir(step), host, meta=meta)
            self._gc()
            log.info("saved checkpoint step=%d", step)

        if not self.async_save:
            _do()
            return

        def _guarded():
            try:
                _do()
            except BaseException as e:          # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_guarded, daemon=True)
        self._thread.start()

    def restore_latest(self, like, *, device=None):
        """(state, meta) of the latest step, or (None, None) when there is
        none."""
        self.wait()
        step = self.latest_step()
        if step is None:
            return None, None
        return (restore(self._step_dir(step), like, device=device),
                read_meta(self._step_dir(step)))

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
