"""Pointwise MLP stacks (counterpart of ``pci_tpu/nn/mlp.py``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.cuda_kernels import fold_bn_layers
from ..ops.cuda_kernels._build import PackedLayers
from .norm import BatchNorm, GroupNorm


class PointMLP(nn.Module):
    """Dense -> norm -> ReLU per layer, over the trailing channel axis.

    ``norm``: ``"batch"`` (BatchNorm eps 1e-3; FlowNet3D, PointsFusion),
    ``"group"`` (GroupNorm with ``groups`` groups; PointNet++ MSG/FP) or
    ``"group_div"`` (GroupNorm with ``C // groups_div`` groups).
    ``dense.i`` / ``bn.i`` / ``gn.i`` are flax's ``Dense_i`` /
    ``BatchNorm_i`` / ``GroupNorm_i``.  The dense layers are
    ``torch.matmul``s (XLA's on the TPU); only a BatchNorm chain folds into
    a kernel (:meth:`folded`).
    """

    def __init__(self, in_channels: int, features: Sequence[int],
                 norm: str = "batch", groups: int = 4, groups_div: int = 8):
        super().__init__()
        widths = [in_channels, *features]
        self.norm = norm
        self.dense = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])
        )
        if norm == "batch":
            self.bn = nn.ModuleList(BatchNorm(f) for f in features)
        elif norm == "group":
            self.gn = nn.ModuleList(GroupNorm(groups, f) for f in features)
        elif norm == "group_div":
            self.gn = nn.ModuleList(GroupNorm(max(f // groups_div, 1), f) for f in features)
        else:
            raise ValueError(f"unknown norm {norm!r}")
        self._fold_key = None
        self._folded = None

    @property
    def out_channels(self) -> int:
        return self.dense[-1].out_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norms = self.bn if self.norm == "batch" else self.gn
        for dense, norm in zip(self.dense, norms):
            x = torch.relu(norm(dense(x)))
        return x

    def folded(self) -> PackedLayers:
        """The chain with BatchNorm folded into each Dense layer
        (``[(W [cout, cin], b), ...]``), as the kernels take it.  Eval
        only; cached until a parameter or buffer changes (new storage or
        an in-place write, e.g. ``load_state_dict`` or ``.to``)."""
        if self.norm != "batch":
            raise ValueError("PointMLP.folded: a GroupNorm chain cannot fold "
                             "(its statistics depend on the input)")
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
