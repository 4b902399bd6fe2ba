"""Schedules, the optimizer and frozen sub-trees (counterpart of
``pci_tpu/train/state.py``).

Adam with the reference's ClippedStepLR, the BatchNorm-momentum schedule,
and the frozen flow.  The JAX package labels a frozen sub-tree
``optax.set_to_zero`` and stop-grads it inside the loss; here its
parameters get ``requires_grad_(False)`` and stay out of the optimizer,
which has the same effect: no gradient, no moments, no update.  The model
and the optimizer hold the state that the JAX package's ``TrainState``
carries (parameters and BatchNorm statistics in the model, the Adam
moments and the update count in the optimizer).
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def clipped_step_lr(init_lr: float, step_size: int, gamma: float,
                    min_lr: float) -> Callable:
    """``lr(epoch) = max(init_lr * gamma ** (epoch // step_size), min_lr)``."""

    def schedule(epoch):
        return max(init_lr * gamma ** math.floor(epoch / step_size), min_lr)

    return schedule


def bn_momentum_schedule(init: float = 0.5, gamma: float = 0.5,
                         step_size: int = 100, floor: float = 0.01) -> Callable:
    """The reference's BatchNorm-momentum decay, an epoch-indexed schedule."""

    def schedule(epoch):
        return max(init * gamma ** math.floor(epoch / step_size), floor)

    return schedule


def freeze_params(model: torch.nn.Module, freeze_subtrees=()) -> list:
    """``requires_grad_(False)`` on every parameter under a module named in
    ``freeze_subtrees`` at any nesting level ("flow" freezes ISAPCInet's
    ``flow``); returns the frozen parameters' names."""
    frozen = []
    for name, p in model.named_parameters():
        if any(part in freeze_subtrees for part in name.split(".")[:-1]):
            p.requires_grad_(False)
            frozen.append(name)
    return frozen


class Adam(torch.optim.Adam):
    """PyTorch's Adam with ``optax.adam``'s constants (b1 0.9, b2 0.999,
    eps 1e-8) and its learning rate: a float, or a schedule of the number
    of updates made so far (optax's count: 0 for the first update)."""

    def __init__(self, params, learning_rate):
        self.schedule = learning_rate if callable(learning_rate) else None
        self.count = 0
        lr = learning_rate(0) if self.schedule else learning_rate
        super().__init__(params, lr=float(lr), betas=(0.9, 0.999), eps=1e-8)

    def step(self, closure=None):
        if self.schedule is not None:
            for group in self.param_groups:
                group["lr"] = float(self.schedule(self.count))
        self.count += 1
        return super().step(closure)


def make_optimizer(learning_rate, model: torch.nn.Module,
                   freeze_subtrees=()) -> Adam:
    """Adam over the parameters of ``model`` outside ``freeze_subtrees``
    (which :func:`freeze_params` freezes); ``learning_rate`` a float or a
    schedule of the update count."""
    freeze_params(model, freeze_subtrees)
    return Adam([p for p in model.parameters() if p.requires_grad], learning_rate)
