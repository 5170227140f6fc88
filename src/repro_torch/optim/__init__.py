from repro_torch.optim.optimizers import adafactor, adamw, make_optimizer, sgd
from repro_torch.optim.schedules import constant, warmup_cosine

__all__ = ["adamw", "adafactor", "sgd", "make_optimizer", "warmup_cosine",
           "constant"]
