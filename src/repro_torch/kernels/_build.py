"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/<name>-<hash>.so`` at the
root of the checkout, and loaded with ``ctypes``. The hash covers the
source and the flags, so an edit rebuilds and an unchanged source is
reused. All sources compile in parallel, one ``nvcc`` each, on the first
call that needs any of them. Nothing here runs at import time: a machine
without ``nvcc`` imports the package and runs the plain versions on the CPU.
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


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
