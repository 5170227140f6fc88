"""repro_torch.serve — the serving steps (prefill, decode, the KV cache),
the kNN-LM ``ServeEngine``, the request plane over the port's index and its
autoscaling hints."""
from repro_torch.serve.engine import KNNLMConfig, ServeEngine
from repro_torch.serve.plane import PlaneConfig, RequestPlane
from repro_torch.serve.scale import (FleetPressurePolicy, QueueDepthPolicy,
                                     RecallGuardPolicy, ScaleDecision,
                                     ScalePolicy, apply_fleet, apply_guard)
from repro_torch.serve.steps import (init_cache, make_decode_step,
                                     make_prefill_step)

__all__ = ["FleetPressurePolicy", "KNNLMConfig", "PlaneConfig",
           "QueueDepthPolicy", "RecallGuardPolicy", "RequestPlane",
           "ScaleDecision", "ScalePolicy", "ServeEngine", "apply_fleet",
           "apply_guard", "init_cache",
           "make_decode_step", "make_prefill_step"]
