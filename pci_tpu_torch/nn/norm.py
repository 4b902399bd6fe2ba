"""Channels-last BatchNorm and GroupNorm (counterpart of
``pci_tpu/nn/norm.py``)."""

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


class GroupNorm(nn.Module):
    """Channels-last GroupNorm as flax's ``nn.GroupNorm`` computes it
    (``pci_tpu/nn/norm.py:group_norm``): eps 1e-5, statistics of each
    channel group over EVERY axis but the leading batch axis (S*K*C/G
    values on ``[B, S, K, C]``, N*C/G on ``[B, N, C]``), the fast variance
    ``max(E[x^2] - E[x]^2, 0)``, then ``(x - mean) * (rsqrt(var + eps) *
    weight) + bias``.  Eval only, like the rest of the port: ``train()``
    mode raises."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"GroupNorm: {num_groups} groups do not divide {channels}")
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("GroupNorm: the port runs eval only")
        B, C, G = x.shape[0], x.shape[-1], self.num_groups
        xg = x.float().reshape(B, -1, G, C // G)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        mean2 = (xg * xg).mean(dim=(1, 3), keepdim=True)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(G, C // G)
        y = (xg - mean) * mul + self.bias.reshape(G, C // G)
        return y.reshape(x.shape)
