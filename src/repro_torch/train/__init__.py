"""Training substrate on one card: optimizers, train step, gradient
compression (the port's counterpart of ``repro.train``)."""

from repro_torch.train.optimizer import adafactor, adamw, make_optimizer
from repro_torch.train.train_step import make_train_step

__all__ = ["adamw", "adafactor", "make_optimizer", "make_train_step"]
