"""FlowNet3D scene-flow backbone, eval path (counterpart of
``pci_tpu/models/flownet3d.py``).

A 4-level set-conv encoder shared by both clouds (Siamese), a cross-cloud
flow embedding, three up-convs, feature propagation and a regression
head.  ``decode`` is the JAX package's non-fused branch
(``models/flownet3d.py:141-150``): every stage is one kernel call.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import (
    Classifier,
    FeaturePropagation,
    FlowEmbedding,
    SetConv,
    SetUpConv,
)


class FlowNet3D(nn.Module):
    """Eval-only FlowNet3D; input features are 3 channels (zeros for
    LiDAR), so set_conv1 sees 6 channels."""

    def __init__(self):
        super().__init__()
        self.set_conv1 = SetConv(1024, 0.5, 16, (32, 32, 64), 3)
        self.set_conv2 = SetConv(256, 1.0, 16, (64, 64, 128), 64)
        self.flow_embedding = FlowEmbedding(64, (128, 128, 128), 128, 128)
        self.set_conv3 = SetConv(64, 2.0, 8, (128, 128, 256), 128)
        self.set_conv4 = SetConv(16, 4.0, 8, (256, 256, 512), 256)
        self.set_upconv1 = SetUpConv(8, (), (256, 256), 512, 256)
        self.set_upconv2 = SetUpConv(8, (128, 128, 256), (256,), 256, 256)
        self.set_upconv3 = SetUpConv(8, (128, 128, 256), (256,), 256, 64)
        self.fp = FeaturePropagation((256, 256), 256, 3)
        self.classifier = Classifier()

    def encode(self, xyz, feats):
        """Two-level set-conv encoding of one cloud -> (xyz, feats, p_1,
        f_1, p_2, f_2), reusable across every pair the cloud is in."""
        p_1, f_1 = self.set_conv1(xyz, feats)
        p_2, f_2 = self.set_conv2(p_1, f_1)
        return (xyz, feats, p_1, f_1, p_2, f_2)

    def decode(self, enc_a, enc_b):
        """Flow a -> b ``[B, N, 3]`` from the two clouds' encodings."""
        xyza, featsa, pa_1, fa_1, pa_2, fa_2 = enc_a
        pb_2, fb_2 = enc_b[4], enc_b[5]
        emb = self.flow_embedding(pa_2, pb_2, fa_2, fb_2)
        pa_3, fa_3 = self.set_conv3(pa_2, emb)
        pa_4, fa_4 = self.set_conv4(pa_3, fa_3)
        nf_3 = self.set_upconv1(pa_4, pa_3, fa_4, fa_3)
        nf_2 = self.set_upconv2(pa_3, pa_2, nf_3, torch.cat([fa_2, emb], -1))
        nf_1 = self.set_upconv3(pa_2, pa_1, nf_2, fa_1)
        nf = self.fp(pa_1, xyza, nf_1, featsa)
        return self.classifier(nf)

    def multi(self, clouds, feats, pairs):
        """Flows for ``pairs`` of indices into ``clouds``; each cloud is
        encoded once."""
        encs = [self.encode(c, f) for c, f in zip(clouds, feats)]
        return [self.decode(encs[a], encs[b]) for a, b in pairs]

    def bidirectional(self, xyz1, xyz2, feats1, feats2):
        """(flow 1->2, flow 2->1) sharing both clouds' encodings."""
        f12, f21 = self.multi([xyz1, xyz2], [feats1, feats2], [(0, 1), (1, 0)])
        return f12, f21

    def forward(self, xyz1, xyz2, feats1, feats2):
        """Flow 1 -> 2 ``[B, N, 3]``."""
        return self.decode(self.encode(xyz1, feats1), self.encode(xyz2, feats2))
