"""PointINet eval path (counterpart of ``pci_tpu/models/pointinet.py`` with
the flow frozen): bidirectional FlowNet3D -> linear warp -> adaptive
attentive fusion.  Clouds are ``[B, N, 3]`` (xyz) or ``[B, N, 3 + C]``
(xyz + intensity, the reference's 4-channel KITTI mode): the flow and the
warp run on xyz, and the extra channels ride the fusion's attention
weights (``PointsFusionWithFeatures``)."""

from __future__ import annotations

import torch
from torch import nn

from ..nn.fusion import PointsFusionWithFeatures
from .flownet3d import FlowNet3D


class PointINet(nn.Module):
    """``fusion_k``: the fusion's neighbours (the reference's 32);
    ``fusion_sampling``: ``"random"`` or ``"fps"``, the order of each warped
    cloud for xyz clouds (clouds with extra channels sample randomly, as
    in the JAX model).  Neither adds a parameter."""

    def __init__(self, fusion_k: int = 32, fusion_sampling: str = "random"):
        super().__init__()
        self.fusion_k = fusion_k
        self.flow = FlowNet3D()
        # one score MLP for both widths, as the JAX package builds either
        # fusion class under the name "fusion"
        self.fusion = PointsFusionWithFeatures(fusion_sampling)

    def forward(self, points1, points2, feats1, feats2, t, perms=None,
                generator: torch.Generator | None = None):
        """``points1/2 [B, N, 3 + C]`` (C >= 0 extra channels, e.g.
        intensity), ``feats1/2 [B, N, 3]`` (the flow's colour input: zeros
        for LiDAR), ``t [B]`` in (0, 1) -> fused cloud ``[B, N, 3 + C]``.

        Both directions' flows share the two clouds' encodings.  ``perms``
        / ``generator``: the fusion's sampling permutations (see
        :class:`PointsFusion`)."""
        # (the flow's kernels take contiguous clouds)
        xyz1, extra1 = points1[..., :3].contiguous(), points1[..., 3:]
        xyz2, extra2 = points2[..., :3].contiguous(), points2[..., 3:]
        with torch.no_grad():  # the frozen flow (the JAX model's stop_gradient)
            flow12, flow21 = self.flow.bidirectional(xyz1, xyz2, feats1, feats2)
        tb = t.float()[:, None, None]
        warped1 = xyz1 + flow12 * tb
        warped2 = xyz2 + flow21 * (1.0 - tb)
        # no extra channel: PointsFusion's fusion (no payload)
        extra = (extra1, extra2) if extra1.shape[-1] else (None, None)
        return self.fusion(warped1, warped2, *extra, self.fusion_k, t, perms=perms,
                           generator=generator)
