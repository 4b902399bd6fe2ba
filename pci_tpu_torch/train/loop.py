"""The interpolation train and eval steps (counterpart of
``pci_tpu/train/loop.py``): forward, chamfer loss, backward, Adam update
and the BatchNorm running statistics, one batch a call.

A batch is the JAX package's dict: ``forward`` / ``keys`` / ``backward``
lists of ``[B, N, 3]`` frames, ``t [B]``, ``gt [B, N, 3]`` and ``ini [B,
N, 3]`` zeros.  The ``sample`` rng of the JAX step is a
``torch.Generator`` here (the fusion's permutations and PointNet++'s FPS
starts); the BatchNorm momentum enters at call time, as there.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.chamfer import chamfer_distance, chamfer_per_sample
from .state import freeze_params


def _forward(model, batch, generator, **kw):
    return model(batch["forward"], batch["keys"], batch["backward"], batch["t"],
                 batch["ini"], generator=generator, **kw)


def interp_loss(model, batch, generator: torch.Generator | None = None,
                momentum: float = 0.1) -> torch.Tensor:
    """The training loss of one batch: the chamfer distance of the model's
    frame to ``gt``, with autograd, in whatever mode ``model`` is in."""
    return chamfer_distance(_forward(model, batch, generator, momentum=momentum),
                            batch["gt"])


def make_interp_train_step(model, optimizer, freeze_subtrees=()) -> Callable:
    """Train step for interpolation models (ISAPCInet batches).

    Returns ``step(batch, generator=None, momentum=0.1) -> loss`` (a
    detached scalar).  A step puts ``model`` in train mode, and leaves its
    parameters, its BatchNorm running statistics and ``optimizer``'s state
    updated.  ``freeze_subtrees``: the sub-trees frozen in ``optimizer``
    (see ``state.freeze_params``), frozen here too.
    """
    freeze_params(model, freeze_subtrees)

    def step(batch, generator: torch.Generator | None = None,
             momentum: float = 0.1) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = interp_loss(model, batch, generator, momentum)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_interp_eval_step(model) -> Callable:
    """Eval step: ``step(batch, generator=None) -> (chamfer [B], frame)``,
    the model in eval mode under ``torch.inference_mode()``."""

    def step(batch, generator: torch.Generator | None = None):
        model.eval()
        with torch.inference_mode():
            out = _forward(model, batch, generator)
            return chamfer_per_sample(out, batch["gt"]), out

    return step
