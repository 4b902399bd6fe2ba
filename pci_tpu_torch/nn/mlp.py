"""Pointwise MLP stacks (counterpart of ``pci_tpu/nn/mlp.py``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.cuda_kernels import fold_bn_layers
from ..ops.cuda_kernels._build import PackedLayers
from .norm import BatchNorm


class PointMLP(nn.Module):
    """Dense -> BatchNorm(eps 1e-3) -> ReLU per layer, over the trailing
    channel axis.  ``dense.i`` / ``bn.i`` are flax's ``Dense_i`` /
    ``BatchNorm_i``."""

    def __init__(self, in_channels: int, features: Sequence[int]):
        super().__init__()
        widths = [in_channels, *features]
        self.dense = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])
        )
        self.bn = nn.ModuleList(BatchNorm(f) for f in features)
        self._fold_key = None
        self._folded = None

    @property
    def out_channels(self) -> int:
        return self.dense[-1].out_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for dense, bn in zip(self.dense, self.bn):
            x = torch.relu(bn(dense(x)))
        return x

    def folded(self) -> PackedLayers:
        """The chain with BatchNorm folded into each Dense layer
        (``[(W [cout, cin], b), ...]``), as the kernels take it.  Eval
        only; cached until a parameter or buffer changes (new storage or
        an in-place write, e.g. ``load_state_dict`` or ``.to``)."""
        if self.training:
            raise RuntimeError("PointMLP.folded: the port runs eval only; call .eval()")
        tensors = (*self.parameters(), *self.buffers())
        if any(t.is_inference() for t in tensors):
            # made under inference_mode: no version counter to key a cache on
            return PackedLayers(fold_bn_layers(self.dense, self.bn))
        key = tuple((t.data_ptr(), t._version) for t in tensors)
        if key != self._fold_key:
            with torch.no_grad():
                self._folded = PackedLayers(fold_bn_layers(self.dense, self.bn))
            self._fold_key = key
        return self._folded
