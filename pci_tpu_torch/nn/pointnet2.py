"""PointNet++ multi-scale-grouping encoder/decoder over flow fields
(counterpart of ``pci_tpu/nn/pointnet2.py``).  Two routes, picked per call
by the JAX package's gate ``PCI_TPU_PN2_KERNEL`` (``_pn2mid_ok``): at eval
on a CUDA tensor where no gradient could flow (``_build.needs_grad``: the
input and the module's parameters), sa2 .. fp2 (everything on sa1's
1,024 points) is ONE kernel (``pn2mid_fused``); otherwise, and always in
training, every SA and FP level is a stage of its own.

Channel concat orders follow the JAX package, because they define the
weight layout: MSG groups concat ``[feats, dxyz]`` (features FIRST, unlike
FlowNet3D's SetConv); FP concats ``[skip, interpolated]``.  The GroupNorm
MLPs cannot fold into a kernel, so they run as ``torch.matmul`` +
GroupNorm; the ball query and FPS run on their kernels (on detached
clouds: their indices carry no gradient), and the gathers they feed are
differentiable.  The FP interpolation runs on the kNN-conv kernel at eval
and, as the JAX package routes it at train, through
``ops.three_nn_interpolate`` under autograd in training or where a
gradient could flow (its 3-NN on the kNN kernel).  In training each SA level draws its FPS start from the
``generator`` (``layers.fps_start``).
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
from torch import nn

from .. import ops
from ..ops.cuda_kernels import _build, ball_query_multi, knnconv_fused
from ..ops.cuda_kernels.pn2mid_cuda import PackedGroups, gn_pointmlp_vars, pn2mid_fused
from .layers import fps_start, gather_split
from .mlp import PointMLP, cached_fold
from .norm import GroupNorm


class SetAbstractionMsg(nn.Module):
    """FPS-sample, then per scale: ball-group (all scales from one ball
    query) -> GroupNorm(4) MLP -> max over the group.  ``scale{i}`` is
    flax's ``scale{i}``."""

    def __init__(self, npoint: int, radius_list: Sequence[float],
                 nsample_list: Sequence[int], mlp_list, in_channels: int):
        super().__init__()
        self.npoint = npoint
        self.radius_list, self.nsample_list = list(radius_list), list(nsample_list)
        for i, mlp in enumerate(mlp_list):
            self.add_module(f"scale{i}", PointMLP(in_channels + 3, mlp, norm="group", groups=4))

    def forward(self, xyz, feats, generator: torch.Generator | None = None):
        """``xyz [B, N, 3]``, ``feats [B, N, D]`` or None -> (``new_xyz
        [B, S, 3]``, ``new_feats [B, S, sum of the last widths]``)."""
        # exact=False: interleaved FPS chains at N >= 4096, the JAX
        # package's accelerator route (SetAbstractionMsg.fps_exact=False)
        new_xyz = ops.fps_points(xyz, self.npoint, fps_start(self, xyz, generator),
                                 exact=False)
        idx_list = ball_query_multi(self.radius_list, self.nsample_list, xyz, new_xyz)
        outs = []
        for i, idx in enumerate(idx_list):
            if feats is not None:
                g_xyz, g_feats = gather_split(xyz, feats, idx)
                h = torch.cat([g_feats, g_xyz - new_xyz[:, :, None, :]], -1)
            else:
                h = ops.index_points(xyz, idx) - new_xyz[:, :, None, :]
            outs.append(getattr(self, f"scale{i}")(h).amax(dim=2))
        return new_xyz, torch.cat(outs, -1)


class FeaturePropagationP2(nn.Module):
    """3-NN inverse-distance interpolation (weights ``1 / (d + 1e-8)``,
    the kNN-conv kernel's ``eps`` mode) + skip concat + GroupNorm(4) MLP;
    ``mlp`` is flax's ``PointMLP_0``."""

    def __init__(self, mlp: Sequence[int], sub_channels: int, dense_channels: int):
        super().__init__()
        self.mlp = PointMLP(sub_channels + dense_channels, mlp, norm="group", groups=4)

    def forward(self, dense_xyz, sub_xyz, dense_feats, sub_feats):
        """``dense_xyz [B, N, 3]``, ``sub_xyz [B, S, 3]``, ``dense_feats
        [B, N, D]`` or None, ``sub_feats [B, S, C]`` -> ``[B, N, C']``."""
        if sub_xyz.shape[1] == 1:
            interp = sub_feats.expand(-1, dense_xyz.shape[1], -1)
        elif self.training or _build.needs_grad(dense_xyz, sub_xyz, sub_feats):
            interp = ops.three_nn_interpolate(dense_xyz, sub_xyz, sub_feats, "eps")
        else:
            interp = knnconv_fused(dense_xyz, sub_xyz, sub_feats, None, None, 3,
                                   [], [], interp=True, recip="eps")
        h = interp if dense_feats is None else torch.cat([dense_feats, interp], -1)
        return self.mlp(h)


def _pn2mid_ok(train: bool, x: torch.Tensor) -> bool:
    """Route sa2 .. fp2 to the one-launch kernel: eval on a CUDA tensor
    that needs no gradient, unless ``PCI_TPU_PN2_KERNEL`` (read at call
    time, default "1", as ``pci_tpu/nn/pointnet2.py:_pn2mid_ok`` reads it)
    says otherwise.  Module-level for tests and A/B flips."""
    return (x.is_cuda and not train and not (torch.is_grad_enabled() and x.requires_grad)
            and os.environ.get("PCI_TPU_PN2_KERNEL", "1") == "1")


class Pointnet2FeatureAbstract(nn.Module):
    """PointNet++ MSG encoder-decoder over a flow cloud: 4 SA levels
    (1024/256/64/16 points, two radii each), 4 FP levels, then
    ``conv1`` -> GroupNorm(8) -> ReLU (``gn.0`` is flax's
    ``GroupNorm_0``)."""

    def __init__(self, out_channels: int):
        super().__init__()
        self.sa1 = SetAbstractionMsg(1024, [0.1, 0.2], [16, 32], [[16, 16, 32], [32, 32, 64]], 0)
        self.sa2 = SetAbstractionMsg(256, [0.2, 0.4], [16, 32], [[64, 64, 128], [64, 96, 128]], 96)
        self.sa3 = SetAbstractionMsg(64, [0.4, 0.8], [16, 32], [[128, 196, 256], [128, 196, 256]], 256)
        self.sa4 = SetAbstractionMsg(16, [0.8, 1.6], [16, 32], [[256, 256, 512], [256, 384, 512]], 512)
        self.fp4 = FeaturePropagationP2([256, 256], 1024, 512)
        self.fp3 = FeaturePropagationP2([256, 256], 256, 256)
        self.fp2 = FeaturePropagationP2([256, 128], 256, 96)
        self.fp1 = FeaturePropagationP2([128, 128, 128], 128, 0)
        self.conv1 = nn.Linear(128, out_channels)
        self.gn = nn.ModuleList([GroupNorm(8, out_channels)])

    def forward(self, xyz, generator: torch.Generator | None = None):
        """``xyz [B, M, 3]`` (flow vectors as a cloud) -> ``[B, M, out]``;
        ``generator``: the training FPS starts' (see ``layers.fps_start``)."""
        l1_xyz, l1_f = self.sa1(xyz, None, generator)
        if _pn2mid_ok(self.training, l1_f) and not _build.needs_grad(self):
            l1_f = self._mid_fused(l1_xyz, l1_f)
        else:
            l2_xyz, l2_f = self.sa2(l1_xyz, l1_f, generator)
            l3_xyz, l3_f = self.sa3(l2_xyz, l2_f, generator)
            l4_xyz, l4_f = self.sa4(l3_xyz, l3_f, generator)
            l3_f = self.fp4(l3_xyz, l4_xyz, l3_f, l4_f)
            l2_f = self.fp3(l2_xyz, l3_xyz, l2_f, l3_f)
            l1_f = self.fp2(l1_xyz, l2_xyz, l1_f, l2_f)
        l0_f = self.fp1(xyz, l1_xyz, None, l1_f)
        return torch.relu(self.gn[0](self.conv1(l0_f)))

    def _mid_fused(self, l1_xyz, l1_f):
        """sa2 .. fp2 at eval as one kernel (``pn2mid_fused``): only fp2's
        ``[B, 1024, 128]`` rows leave it."""
        return pn2mid_fused(l1_xyz, l1_f, self._mid_groups())

    def _mid_groups(self) -> PackedGroups:
        """sa2 .. fp2's nine GroupNorm MLPs in the kernel's layout
        (``pn2mid_cuda.GROUPS``), cached until a weight changes."""
        mlps = [self.sa2.scale0, self.sa2.scale1, self.sa3.scale0, self.sa3.scale1,
                self.sa4.scale0, self.sa4.scale1, self.fp4.mlp, self.fp3.mlp, self.fp2.mlp]
        return cached_fold(self, lambda: [gn_pointmlp_vars(m) for m in mlps], mlps,
                           pack=PackedGroups)
