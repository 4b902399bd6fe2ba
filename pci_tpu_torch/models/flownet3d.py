"""FlowNet3D scene-flow backbone, eval path (counterpart of
``pci_tpu/models/flownet3d.py``).

A 4-level set-conv encoder shared by both clouds (Siamese), a cross-cloud
flow embedding, three up-convs, feature propagation and a regression
head.  Two routes, picked per call by the JAX package's gates:

- fused (the default at eval on a CUDA tensor): ``encode`` is FPS then ONE
  kernel for set_conv1 + set_conv2 (``flowenc_fused``); ``decode`` is ONE
  kernel from the flow embedding to set_upconv3 (``flowmid_fused``), then
  the FeaturePropagation with the classifier folded into its chain
  (``knnconv_fused(..., n_final=1)``);
- per stage (``PCI_TPU_ENC_KERNEL`` / ``PCI_TPU_MID_KERNEL`` set to
  anything but "1", or a CPU tensor): every stage is one kernel call and
  the classifier plain PyTorch.  It is also the route where a gradient
  could flow (``_build.needs_grad``, the JAX package's ``has_tangents``
  test): its stages then run by differentiable ops (``nn/layers.py``).

Both routes pick the same points: the megakernels run the per-stage
kernels' bodies.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from .. import ops
from ..nn.layers import (
    Classifier,
    FeaturePropagation,
    FlowEmbedding,
    SetConv,
    SetUpConv,
    require_eval,
)
from ..nn.mlp import cached_fold
from ..ops.cuda_kernels import _build, flowenc_fused, flowmid_fused, knnconv_fused


def _enc_ok(train: bool, x: torch.Tensor) -> bool:
    """Route the Siamese encoder (set_conv1 + set_conv2) to the fused
    two-stage kernel: eval on a CUDA tensor, unless ``PCI_TPU_ENC_KERNEL``
    (read at call time, default "1", as the JAX package's ``_enc_ok``
    reads it) says otherwise.  Module-level for tests and A/B flips."""
    return x.is_cuda and not train and os.environ.get("PCI_TPU_ENC_KERNEL", "1") == "1"


def _mid_ok(train: bool, x: torch.Tensor) -> bool:
    """Route the decode (flow_embedding .. set_upconv3, then the
    FeaturePropagation with the classifier) to the fused kernels: eval on
    a CUDA tensor, unless ``PCI_TPU_MID_KERNEL`` (default "1") says
    otherwise.  Module-level for tests and A/B flips."""
    return x.is_cuda and not train and os.environ.get("PCI_TPU_MID_KERNEL", "1") == "1"


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
        require_eval(self)
        if _enc_ok(self.training, xyz) and not _build.needs_grad(self, xyz, feats):
            return self._encode_fused(xyz, feats)
        p_1, f_1 = self.set_conv1(xyz, feats)
        p_2, f_2 = self.set_conv2(p_1, f_1)
        return (xyz, feats, p_1, f_1, p_2, f_2)

    def _encode_fused(self, xyz, feats):
        """set_conv1's centres by FPS, then one kernel: set_conv1, the FPS
        of set_conv2's centres, set_conv2."""
        sc1, sc2 = self.set_conv1, self.set_conv2
        p_1 = ops.fps_points(xyz, sc1.npoint, 0, exact=False)
        f_1, f_2, p_2 = flowenc_fused(xyz, feats, p_1, sc1.mlp.folded(), sc2.mlp.folded(),
                                      sc2.npoint, sc1.radius, sc1.nsample, sc2.radius,
                                      sc2.nsample)
        return (xyz, feats, p_1, f_1, p_2, f_2)

    def decode(self, enc_a, enc_b):
        """Flow a -> b ``[B, N, 3]`` from the two clouds' encodings."""
        require_eval(self)
        xyza, featsa, pa_1, fa_1, pa_2, fa_2 = enc_a
        pb_2, fb_2 = enc_b[4], enc_b[5]
        if _mid_ok(self.training, xyza) and not _build.needs_grad(self, enc_a, enc_b):
            return self._decode_fused(xyza, featsa, pa_1, fa_1, pa_2, fa_2, pb_2, fb_2)
        emb = self.flow_embedding(pa_2, pb_2, fa_2, fb_2)
        pa_3, fa_3 = self.set_conv3(pa_2, emb)
        pa_4, fa_4 = self.set_conv4(pa_3, fa_3)
        nf_3 = self.set_upconv1(pa_4, pa_3, fa_4, fa_3)
        nf_2 = self.set_upconv2(pa_3, pa_2, nf_3, torch.cat([fa_2, emb], -1))
        nf_1 = self.set_upconv3(pa_2, pa_1, nf_2, fa_1)
        nf = self.fp(pa_1, xyza, nf_1, featsa)
        return self.classifier(nf)

    def _decode_fused(self, xyza, featsa, pa_1, fa_1, pa_2, fa_2, pb_2, fb_2):
        """Two kernels: the mid-section from the flow embedding to
        set_upconv3, then the FeaturePropagation with the classifier's
        folded layer and its linear last layer riding the chain."""
        sc3, sc4 = self.set_conv3, self.set_conv4
        su1, su2, su3 = self.set_upconv1, self.set_upconv2, self.set_upconv3
        groups = [self.flow_embedding.mlp.folded(), sc3.mlp.folded(), sc4.mlp.folded(),
                  su1.conv2.folded(), su2.conv1.folded(), su2.conv2.folded(),
                  su3.conv1.folded(), su3.conv2.folded()]
        nf_1 = flowmid_fused(pa_1, fa_1, pa_2, fa_2, pb_2, fb_2, groups, sc3.npoint,
                             sc4.npoint, self.flow_embedding.nsample, sc3.radius,
                             sc3.nsample, sc4.radius, sc4.nsample, su1.nsample)
        return knnconv_fused(xyza, pa_1, nf_1, None, featsa, 3, [], self._tail(),
                             interp=True, n_final=1)

    def _tail(self):
        """The FeaturePropagation's folded MLP, then the classifier's
        folded layers: one chain, cached until a weight changes."""
        return cached_fold(self, lambda: [*self.fp.mlp.folded(), *self.classifier.folded()],
                           [self.fp, self.classifier])

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
