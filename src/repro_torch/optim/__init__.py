"""Optimizers of the port (mirrors :mod:`repro.optim`): ``sgd`` and
``adamw`` with fp32 slots, each updating in place through its
``apply_updates``, and ``TrainState``."""
from repro_torch.optim.optimizers import Optimizer, TrainState, adamw, sgd

__all__ = ["Optimizer", "TrainState", "sgd", "adamw"]
