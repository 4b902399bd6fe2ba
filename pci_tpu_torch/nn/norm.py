"""Channels-last BatchNorm and GroupNorm (counterpart of
``pci_tpu/nn/norm.py``)."""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """BatchNorm over the trailing channel axis of ``[..., C]``, eps 1e-3,
    as ``pci_tpu/nn/norm.py:BatchNorm`` computes it (not
    ``F.batch_norm``).

    Eval: ``(x - mean) * rsqrt(var + eps) * weight + bias`` with the
    running statistics.  Train: the same with the batch's statistics over
    every leading axis (the fast variance ``max(E[x^2] - E[x]^2, 0)``,
    biased), and the running statistics updated in place as ``running =
    (1 - m) * running + m * batch`` with the unbiased variance; the
    momentum ``m`` is given at call time (the trainer's schedule)."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, momentum: float = 0.1) -> torch.Tensor:
        if self.training:
            red = tuple(range(x.dim() - 1))
            x32 = x.float()
            mean = x32.mean(dim=red)
            var = torch.clamp_min((x32 * x32).mean(dim=red) - mean * mean, 0.0)
            n = x.numel() // x.shape[-1]
            with torch.no_grad():
                m = float(momentum)
                unbiased = var * (n / max(n - 1, 1))
                self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1.0 - m) * self.running_var + m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


class GroupNorm(nn.Module):
    """Channels-last GroupNorm as flax's ``nn.GroupNorm`` computes it
    (``pci_tpu/nn/norm.py:group_norm``): eps 1e-5, statistics of each
    channel group over EVERY axis but the leading batch axis (S*K*C/G
    values on ``[B, S, K, C]``, N*C/G on ``[B, N, C]``), the fast variance
    ``max(E[x^2] - E[x]^2, 0)``, then ``(x - mean) * (rsqrt(var + eps) *
    weight) + bias``.  It keeps no running statistics, so train and eval
    mode compute the same.

    The two means accumulate in fp64 and round to fp32: PyTorch's fp32
    sum over these strided axes drifts ~1e-5 from the exact mean, which
    the fast variance amplifies, where XLA's reduction stays within a
    rounding of it."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"GroupNorm: {num_groups} groups do not divide {channels}")
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, G = x.shape[0], x.shape[-1], self.num_groups
        xg = x.float().reshape(B, -1, G, C // G)
        f64 = torch.float64
        mean = xg.mean(dim=(1, 3), keepdim=True, dtype=f64).float()
        mean2 = (xg * xg).mean(dim=(1, 3), keepdim=True, dtype=f64).float()
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(G, C // G)
        y = (xg - mean) * mul + self.bias.reshape(G, C // G)
        return y.reshape(x.shape)
