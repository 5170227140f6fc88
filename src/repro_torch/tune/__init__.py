"""repro_torch.tune — the self-racing autotuner (DESIGN.md §9), the
reference's package over the port's knobs.

Every hand-set performance constant in the serving stack — fused rounds
per launch R, pulls per round P, arms per launch B, the frontier's bucket
floor, the fused pull kernel's ring of pulls in flight, fused-vs-rounds
dispatch — is really a per-workload decision: the right values move with
corpus scale, dimensionality, dtype, sparsity, and the device underneath.
This package races those constants on the store itself:

  candidates.py — the (R, P, B, floor, buffers, mode) grid + TunedConfig
  seed.py       — an analytic cost model prunes the grid before timing
  racer.py      — successive-halving measurement race over survivors
  signature.py  — (n-bucket, d, dtype, kind, backend, shards, block) key
  sidecar.py    — tuned.json checkpoint sidecar + in-process cache
  autotune.py   — tune_store: the end-to-end pass

The api layer exposes it as ``Index.tune()`` (an admin op under the epoch
fence), persists the winner with ``Index.save`` and applies it on
``Index.load`` when the signature still matches — see api/handle.py.
"""
from repro_torch.tune.autotune import synth_queries, tune_store
from repro_torch.tune.candidates import (TUNED_VERSION, TunedConfig,
                                         bind_store, candidate_grid,
                                         tuned_mode)
from repro_torch.tune.racer import (Measurement, measure_candidate,
                                    race_candidates)
from repro_torch.tune.seed import model_efficiency, seed_candidates
from repro_torch.tune.sidecar import (TUNED_FILE, cache_clear, cache_get,
                                      cache_put, load_tuned, save_tuned)
from repro_torch.tune.signature import (SIGNATURE_SCHEME, StoreSignature,
                                        signature_of)

__all__ = [
    "Measurement", "SIGNATURE_SCHEME", "StoreSignature", "TUNED_FILE",
    "TUNED_VERSION", "TunedConfig", "bind_store", "cache_clear",
    "cache_get", "cache_put", "candidate_grid", "load_tuned",
    "measure_candidate", "model_efficiency", "race_candidates",
    "save_tuned", "seed_candidates", "signature_of", "synth_queries",
    "tune_store", "tuned_mode",
]
