from repro_torch.train.loss import lm_loss
from repro_torch.train.steps import init_train_state, make_train_step

__all__ = ["init_train_state", "make_train_step", "lm_loss"]
