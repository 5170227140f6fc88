"""repro_torch.serve — the request plane over the port's index and its
autoscaling hints. The LM serving engine waits for the KV cache (ROADMAP.md
Queue 1 item 4)."""
from repro_torch.serve.plane import PlaneConfig, RequestPlane
from repro_torch.serve.scale import (QueueDepthPolicy, RecallGuardPolicy,
                                     ScaleDecision, ScalePolicy, apply_guard)

__all__ = ["PlaneConfig", "QueueDepthPolicy", "RecallGuardPolicy",
           "RequestPlane", "ScaleDecision", "ScalePolicy", "apply_guard"]
