"""FlowNet3D building blocks (counterpart of ``pci_tpu/nn/layers.py``):
SetConv, FlowEmbedding, SetUpConv, FeaturePropagation, Classifier, and the
helpers ``fps_start`` and ``gather_split``.

Eval only (FlowNet3D is frozen while the port trains ISAPCInet; its
training waits for backward paths of the set-conv and kNN-conv kernels):
every stage folds its BatchNorms into the Dense weights and runs as ONE
fused kernel call (a CUDA kernel on the card, its plain PyTorch version on
the CPU).  Channel concat orders follow the JAX
package, because they define the weight layout: SetConv groups
``[dxyz, feats]``; FlowEmbedding appends the query cloud's features last;
SetUpConv concats the skip features after the max-pool;
FeaturePropagation concats ``[interpolated, skip]``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .. import ops
from ..ops.cuda_kernels import knnconv_fused, setconv_fused
from .mlp import PointMLP
from .norm import BatchNorm


def fps_start(module: nn.Module, xyz: torch.Tensor,
              generator: torch.Generator | None = None):
    """FPS start index: 0 at eval; in training a per-sample ``randint(0,
    N)`` ``[B]`` from ``generator`` (on its device; the default generator
    of ``xyz``'s device for None), as ``pci_tpu/nn/layers.py:fps_start``
    draws one from the ``sample`` stream.  Tests replace this function to
    give both packages the same starts."""
    if not module.training:
        return 0
    B, N, _ = xyz.shape
    dev = generator.device if generator is not None else xyz.device
    return torch.randint(0, N, (B,), generator=generator, device=dev)


def require_eval(module: nn.Module) -> None:
    """FlowNet3D's layers run eval only."""
    if module.training:
        raise RuntimeError(f"{type(module).__name__}: FlowNet3D runs eval only "
                           "(frozen); call .eval()")


def gather_split(xyz: torch.Tensor, feats: torch.Tensor, idx: torch.Tensor):
    """Neighbour rows of ``[xyz | feats]`` by ONE fused row gather (the JAX
    package's fp32 route) -> ``(g_xyz [B, ..., 3], g_feats [B, ..., D])``."""
    g = ops.index_points(torch.cat([xyz.float(), feats.float()], -1), idx)
    return g[..., :3], g[..., 3:]


def fold_pointmlp_vars(mlp: PointMLP | None):
    """Folded ``[(W, b), ...]`` of a BatchNorm PointMLP (empty for None)."""
    return mlp.folded() if mlp is not None else []


class SetConv(nn.Module):
    """FPS-sample -> ball-group -> shared MLP -> max over the group."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 mlp: Sequence[int], in_channels: int):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mlp = PointMLP(3 + in_channels, mlp)

    def forward(self, xyz, feats):
        """``xyz [B,N,3]``, ``feats [B,N,D]`` -> (``new_xyz [B,S,3]``,
        ``new_feats [B,S,C']``)."""
        require_eval(self)
        # exact=False: interleaved FPS chains at N >= 4096, the JAX
        # package's accelerator route (SetConv.fps_exact defaults to False)
        new_xyz = ops.fps_points(xyz, self.npoint, 0, exact=False)
        pooled = setconv_fused(xyz, feats, new_xyz, self.radius, self.nsample,
                               self.mlp.folded())
        return new_xyz, pooled


class FlowEmbedding(nn.Module):
    """kNN-group cloud 2 around each cloud-1 point on ``[dxyz, f2, f1]``,
    MLP, max over the group."""

    def __init__(self, nsample: int, mlp: Sequence[int], c1: int, c2: int):
        super().__init__()
        self.nsample = nsample
        self.mlp = PointMLP(3 + c2 + c1, mlp)

    def forward(self, xyz1, xyz2, feats1, feats2):
        require_eval(self)
        return knnconv_fused(xyz1, xyz2, feats2, feats1, None, self.nsample,
                             self.mlp.folded(), [])


class SetUpConv(nn.Module):
    """kNN-group coarse features onto dense points, MLP1 (may be empty) +
    max, concat the dense skip features, MLP2."""

    def __init__(self, nsample: int, mlp1: Sequence[int], mlp2: Sequence[int],
                 coarse_channels: int, dense_channels: int):
        super().__init__()
        self.nsample = nsample
        cin1 = 3 + coarse_channels
        self.conv1 = PointMLP(cin1, mlp1) if mlp1 else None
        cm = mlp1[-1] if mlp1 else cin1
        self.conv2 = PointMLP(cm + dense_channels, mlp2)

    def forward(self, coarse_xyz, dense_xyz, coarse_feats, dense_feats):
        require_eval(self)
        return knnconv_fused(dense_xyz, coarse_xyz, coarse_feats, None,
                             dense_feats, self.nsample,
                             fold_pointmlp_vars(self.conv1),
                             self.conv2.folded())


class FeaturePropagation(nn.Module):
    """Inverse-distance 3-NN interpolation ("clamp") + skip concat + MLP."""

    def __init__(self, mlp: Sequence[int], sub_channels: int,
                 dense_channels: int):
        super().__init__()
        self.mlp = PointMLP(sub_channels + dense_channels, mlp)

    def forward(self, sub_xyz, dense_xyz, sub_feats, dense_feats):
        require_eval(self)
        return knnconv_fused(dense_xyz, sub_xyz, sub_feats, None, dense_feats,
                             3, [], self.mlp.folded(), interp=True)


class Classifier(nn.Module):
    """Flow regression head: Dense(128) + BN + ReLU + Dense(3), plain
    PyTorch (one matmul each; not a kernel of the port)."""

    def __init__(self):
        super().__init__()
        self.dense = nn.ModuleList([nn.Linear(256, 128),
                                    nn.Linear(128, 3)])
        self.bn = nn.ModuleList([BatchNorm(128)])

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        require_eval(self)
        h = torch.relu(self.bn[0](self.dense[0](feats)))
        return self.dense[1](h)
