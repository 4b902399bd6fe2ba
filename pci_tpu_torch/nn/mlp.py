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
    a kernel (:meth:`folded`, eval only).  In train mode the BatchNorms use
    the batch's statistics and update their running ones with the
    ``momentum`` given to :meth:`forward`.
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

    @property
    def out_channels(self) -> int:
        return self.dense[-1].out_features

    def forward(self, x: torch.Tensor, momentum: float = 0.1) -> torch.Tensor:
        if self.norm == "batch":
            for dense, bn in zip(self.dense, self.bn):
                x = torch.relu(bn(dense(x), momentum))
            return x
        for dense, gn in zip(self.dense, self.gn):
            x = torch.relu(gn(dense(x)))
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
            raise RuntimeError("PointMLP.folded: a fold takes the running statistics "
                               "(eval only); call .eval()")
        return cached_fold(self, lambda: fold_bn_layers(self.dense, self.bn), [self])


def cached_fold(holder: nn.Module, build, modules, pack=PackedLayers):
    """``pack(build())`` (``PackedLayers`` by default) made under
    ``torch.no_grad()`` and cached on
    ``holder`` until a parameter or buffer of ``modules`` changes (new
    storage or an in-place write, e.g. ``load_state_dict`` or ``.to``).
    Modules made under ``torch.inference_mode()`` have no version counter
    to key a cache on: they fold on every call."""
    tensors = [t for m in modules for t in (*m.parameters(), *m.buffers())]
    if any(t.is_inference() for t in tensors):
        return pack(build())
    key = tuple((t.data_ptr(), t._version) for t in tensors)
    if key != getattr(holder, "_fold_key", None):
        with torch.no_grad():
            holder._folded = pack(build())
        holder._fold_key = key
    return holder._folded
