import os
import sys

# tests run against the source tree (PYTHONPATH=src also works)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# NOTE: do NOT set xla_force_host_platform_device_count here — smoke tests
# and benches must see the real single device; multi-device tests spawn
# subprocesses with their own XLA_FLAGS.

try:
    import hypothesis  # noqa: F401
except ImportError:  # container without hypothesis: seeded-random fallback
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_stub

    sys.modules["hypothesis"] = _hypothesis_stub

import numpy as np
import pytest

# -- runtime-sanitizer tier (DESIGN.md §12.4) --------------------------------
# REPRO_SANITIZE=1 runs tier-1 with every implicit device->host transfer
# outlawed: only the explicit jax.device_get under the allow-scope inside
# repro.utils.hostsync.host_fetch (and host_boundary blocks) stays legal.
# On CPU the guard cannot trip (host and device memory are one — transfers
# are zero-copy and unguarded), so this tier is a no-op locally and real on
# TPU/GPU backends; wiring it here keeps the discipline testable the day a
# device backend lands. REPRO_SANITIZE=nan additionally arms debug_nans.
_SANITIZE = os.environ.get("REPRO_SANITIZE", "")
if _SANITIZE:
    import jax

    jax.config.update("jax_transfer_guard_device_to_host", "disallow")
    if _SANITIZE == "nan":
        jax.config.update("jax_debug_nans", True)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); "
        "skips without one")
