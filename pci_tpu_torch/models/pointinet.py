"""PointINet eval path (counterpart of ``pci_tpu/models/pointinet.py`` with
the flow frozen): bidirectional FlowNet3D -> linear warp -> adaptive
attentive fusion."""

from __future__ import annotations

import torch
from torch import nn

from ..nn.fusion import PointsFusion
from .flownet3d import FlowNet3D


FUSION_K = 32  # fusion neighbours (PointINet's fusion_k)


class PointINet(nn.Module):
    def __init__(self):
        super().__init__()
        self.flow = FlowNet3D()
        self.fusion = PointsFusion()

    def forward(self, points1, points2, feats1, feats2, t, perms=None,
                generator: torch.Generator | None = None):
        """``points1/2 [B, N, 3]``, ``feats1/2 [B, N, 3]`` (zeros for
        LiDAR), ``t [B]`` in (0, 1) -> fused cloud ``[B, N, 3]``.

        Both directions' flows share the two clouds' encodings.  ``perms``
        / ``generator``: the fusion's sampling permutations (see
        :class:`PointsFusion`)."""
        if points1.shape[-1] != 3:
            raise NotImplementedError("PointINet: xyz clouds only (no intensity channel)")
        flow12, flow21 = self.flow.bidirectional(points1, points2, feats1, feats2)
        tb = t.float()[:, None, None]
        warped1 = points1 + flow12 * tb
        warped2 = points2 + flow21 * (1.0 - tb)
        return self.fusion(warped1, warped2, FUSION_K, t, perms=perms,
                           generator=generator)
