from repro_torch.configs.base import BMOConfig

__all__ = ["BMOConfig"]
