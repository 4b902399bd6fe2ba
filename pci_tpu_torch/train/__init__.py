"""Training of the port (counterpart of ``pci_tpu.train``): the schedules,
the optimizer with frozen sub-trees, the interpolation train and eval
steps, model weights on disk and the metrics log."""

from .checkpoints import BestKeeper, load_flow_into, load_params, save_params
from .loop import interp_loss, make_interp_eval_step, make_interp_train_step
from .metrics import MetricLogger, metrics_to_csv
from .state import (
    Adam,
    bn_momentum_schedule,
    clipped_step_lr,
    freeze_params,
    make_optimizer,
)

__all__ = [
    "Adam",
    "BestKeeper",
    "MetricLogger",
    "bn_momentum_schedule",
    "clipped_step_lr",
    "freeze_params",
    "interp_loss",
    "load_flow_into",
    "load_params",
    "make_interp_eval_step",
    "make_interp_train_step",
    "make_optimizer",
    "metrics_to_csv",
    "save_params",
]
