from repro_torch.utils.hostsync import host_fetch

__all__ = ["host_fetch"]
