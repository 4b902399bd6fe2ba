"""Channels-last BatchNorm (counterpart of ``pci_tpu/nn/norm.py``)."""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """BatchNorm over the trailing channel axis of ``[..., C]``, eps 1e-3,
    in eval mode: ``(x - mean) * rsqrt(var + eps) * weight + bias`` with
    the running statistics.  Training (batch statistics) waits for the
    port's training slice, so ``train()`` mode raises."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("BatchNorm: the port runs eval only")
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias
