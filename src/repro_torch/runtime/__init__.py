from repro_torch.runtime.straggler import StragglerWatchdog
from repro_torch.runtime.supervisor import FailureInjector, Supervisor

__all__ = ["Supervisor", "FailureInjector", "StragglerWatchdog"]
