"""Optimizers + LR schedules on the port (counterpart of `repro.optim`)."""
from repro_torch.optim.optimizers import sgd, adamw, apply_updates, Optimizer
from repro_torch.optim.schedules import constant, cosine, warmup_cosine, wsd

__all__ = ["sgd", "adamw", "apply_updates", "Optimizer",
           "constant", "cosine", "warmup_cosine", "wsd"]
