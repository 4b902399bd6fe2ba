"""Time-conditioning and output heads (counterpart of
``pci_tpu/nn/heads.py``): ``Tnet``, ``Wnet`` and ``Outputer``.  Dense
stacks with GroupNorm(C/8), ``torch.matmul``s all (no kernel of the
port).
``dense.i`` / ``gn.i`` are flax's ``Dense_i`` / ``GroupNorm_i``.
"""

from __future__ import annotations

import torch
from torch import nn

from .norm import GroupNorm


class _TimeHead(nn.Module):
    """``t [B, 1]`` -> softmax weights ``[B, out]``: Dense, GroupNorm(C/8)
    and ReLU over ``widths``, then Dense(out)."""

    def __init__(self, widths, out: int):
        super().__init__()
        widths = [1, *widths]
        self.dense = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])]
            + [nn.Linear(widths[-1], out)])
        self.gn = nn.ModuleList(GroupNorm(w // 8, w) for w in widths[1:])

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        h = t.float()
        for dense, gn in zip(self.dense, self.gn):
            h = torch.relu(gn(dense(h)))
        return torch.softmax(self.dense[-1](h), dim=-1)


class Tnet(_TimeHead):
    """``t [B, 1]`` -> softmax weights ``[B, 2 * field]`` over the flow
    candidates (widths 64, 256, 256, 64)."""

    def __init__(self, field: int):
        super().__init__((64, 256, 256, 64), 2 * field)


class Wnet(_TimeHead):
    """``t [B, 1]`` -> softmax weights ``[B, 6 * field]``, PointINet2's
    fusion budgets (widths 128, 512, 512, 128)."""

    def __init__(self, field: int):
        super().__init__((128, 512, 512, 128), 6 * field)


class Outputer(nn.Module):
    """Per-point flow regression ``[B, N, C] -> [B, N, 3]``: Dense(128),
    GroupNorm(16), ReLU, Dense(32), GroupNorm(4), ReLU, Dense(3)."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.dense = nn.ModuleList([nn.Linear(in_channels, 128), nn.Linear(128, 32),
                                    nn.Linear(32, 3)])
        self.gn = nn.ModuleList([GroupNorm(16, 128), GroupNorm(4, 32)])

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.gn[0](self.dense[0](feats)))
        h = torch.relu(self.gn[1](self.dense[1](h)))
        return self.dense[2](h)
