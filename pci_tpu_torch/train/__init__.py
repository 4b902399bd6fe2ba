"""Training of the port (counterpart of ``pci_tpu.train``): the schedules,
the optimizer with frozen sub-trees, and the interpolation train and eval
steps."""

from .loop import interp_loss, make_interp_eval_step, make_interp_train_step
from .state import (
    Adam,
    bn_momentum_schedule,
    clipped_step_lr,
    freeze_params,
    make_optimizer,
)

__all__ = [
    "Adam",
    "bn_momentum_schedule",
    "clipped_step_lr",
    "freeze_params",
    "interp_loss",
    "make_interp_eval_step",
    "make_interp_train_step",
    "make_optimizer",
]
