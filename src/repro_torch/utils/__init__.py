from repro_torch.utils.hostsync import host_fetch
from repro_torch.utils.logging import StructuredLogger, get_logger

__all__ = ["StructuredLogger", "get_logger", "host_fetch"]
