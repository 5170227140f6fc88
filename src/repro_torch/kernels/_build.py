"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/<name>-<hash>.so`` at the
root of the checkout, and loaded with ``ctypes``. The hash covers the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edit
rebuilds and an unchanged source is reused. All sources compile in
parallel, one ``nvcc`` each, on the first call that needs any of them.
Nothing here runs at import time: a machine without ``nvcc`` imports the
package and runs the plain versions on the CPU.

``Entry`` and ``launch`` are every wrapper's call path, kept short because
the paper path's kernels (``block_pull``, ``pairwise_dist``) take a few µs
on the device: the C function is resolved once, the stream is read as a
raw pointer, and the device guard is entered only when the operands'
device is not the current one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per source: seconds spent in nvcc (0.0 when reused) and its output (None
#: when a reused library has none kept beside it)
build_log: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # shared headers
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every ``csrc/*.cu`` not yet built (all at once) and load each
    library. Returns {source stem: CDLL}; raises on a failed build."""
    with _lock:
        pending = {}
        for src in sorted(CSRC.glob("*.cu")):
            if src.stem in _libs:
                continue
            out = _target(src)
            if out.exists():
                # nvcc's output, kept beside the library when it was built
                log = out.with_suffix(".log")
                build_log[src.stem] = {
                    "seconds": 0.0,
                    "log": log.read_text() if log.exists() else None}
                _libs[src.stem] = ctypes.CDLL(str(out))
                continue
            BUILD.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            pending[src.stem] = (proc, tmp, out, time.perf_counter())
        failed = []
        for stem, (proc, tmp, out, t0) in pending.items():
            log, _ = proc.communicate()
            build_log[stem] = {"seconds": time.perf_counter() - t0, "log": log}
            if proc.returncode != 0:
                failed.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n{log}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
            _libs[stem] = ctypes.CDLL(str(out))
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return dict(_libs)


def library_path(stem: str) -> Path:
    """Where ``csrc/<stem>.cu`` is (or will be) built."""
    return _target(CSRC / f"{stem}.cu")


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    lib = _libs.get(stem)
    return lib if lib is not None else build_all()[stem]


class Entry:
    """A C entry point of ``csrc/<stem>.cu``, resolved (and the library built)
    on its first call and kept. Its last argument is the stream; it returns
    a CUDA error code."""
    __slots__ = ("stem", "symbol", "argtypes", "fn")

    def __init__(self, stem: str, symbol: str, argtypes: list):
        self.stem, self.symbol, self.argtypes = stem, symbol, argtypes
        self.fn = None

    def resolve(self):
        fn = getattr(library(self.stem), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self.fn = fn
        return fn


# the current stream of a device as a raw pointer, without making a Stream,
# and the current device without the lazy-init check (an operand on the card
# means CUDA is up)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)
_current_device = getattr(torch._C, "_cuda_getDevice", None) or \
    torch.cuda.current_device


def launch(entry: Entry, index: int, what: str, *args) -> None:
    """Calls ``entry(*args, stream)`` on the current stream of CUDA device
    ``index``, under a device guard only when that is not the current
    device; raises when it returns a CUDA error code, naming ``what``."""
    fn = entry.fn or entry.resolve()
    if index == _current_device():
        rc = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, _raw_stream(index))
    if rc != 0:
        raise RuntimeError(f"{what} launch: CUDA error {rc}")
