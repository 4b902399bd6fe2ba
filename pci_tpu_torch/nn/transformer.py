"""Point-transformer self-attention layer (counterpart of
``pci_tpu/nn/transformer.py:TransformerLayer``, its default unsharded
route).

kNN(k) neighbourhoods of each point in its own cloud (on the detached
cloud), the neighbours' xyz and ``[K | V]`` rows gathered apart (each
contiguous: the tail kernels read a query's K | V block as one span, and a
slice of a fused ``[xyz | K | V]`` gather would be copied whole first),
offsets ``delta = xyz - knn_xyz``, then the vector-attention tail and
``fc2`` plus the residual.  On a large cloud (``ops.cells_eligible``: the
card, at least 32,768 points, ``k <= 64``) where no gradient can flow into
``xyz``, the offsets come from the box-pruned kNN's own residual output
(``ops.knn_self_resi``, the JAX layer's cells branch,
``pci_tpu/nn/transformer.py:116-122``): ``delta = -resi``, bit-equal to
the gather's (negation is exact and ``a - b = -(b - a)`` in IEEE
arithmetic), with no xyz gather.
The tail is one kernel on the card: the eval kernel, or in training the
trainable route (the same forward kernel and a backward kernel), as the
TPU's ``vector_attention_trainable``; each routes by shape before any
launch (``attention_cuda.kernel_route_ok`` / ``bwd_route_ok``: widths
the kernels do not take run the plain versions).  At eval with a gradient
that could flow (``_build.needs_grad``) the layer takes the trainable
route, as the JAX layer takes its XLA expression under a tangent.  Returns ``(out, None)``, as the TPU
routes do: the ``[B, N, k, d]`` attention maps are what the tail kernels
exist not to write.  The dense layers are ``torch.matmul``s.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import cells_eligible, index_points, knn_self_resi
from ..ops.cuda_kernels import _build, knn, vector_attention, vector_attention_trainable


class TransformerLayer(nn.Module):
    """``fc1``, ``w_qs``/``w_ks``/``w_vs`` (no bias), ``fc_delta_{0,1}``,
    ``fc_gamma_{0,1}``, ``fc2``: flax's names."""

    def __init__(self, d_points: int, d_model: int, k: int):
        super().__init__()
        self.k = k
        self.fc1 = nn.Linear(d_points, d_model)
        self.w_qs = nn.Linear(d_model, d_model, bias=False)
        self.w_ks = nn.Linear(d_model, d_model, bias=False)
        self.w_vs = nn.Linear(d_model, d_model, bias=False)
        self.fc_delta_0 = nn.Linear(3, d_model)
        self.fc_delta_1 = nn.Linear(d_model, d_model)
        self.fc_gamma_0 = nn.Linear(d_model, d_model)
        self.fc_gamma_1 = nn.Linear(d_model, d_model)
        self.fc2 = nn.Linear(d_model, d_points)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor):
        """``xyz [B, N, 3]``, ``feats [B, N, d_points]`` -> (``[B, N,
        d_points]``, None)."""
        x = self.fc1(feats)
        kv = torch.cat([self.w_ks(x), self.w_vs(x)], -1)
        if cells_eligible(xyz, self.k) and not _build.needs_grad(xyz):
            idx, resi = knn_self_resi(xyz, self.k)
            g, delta = index_points(kv.float(), idx), -resi
        else:
            _, idx = knn(xyz, xyz, self.k)
            knn_xyz, g = index_points(xyz.float(), idx), index_points(kv.float(), idx)
            delta = xyz[:, :, None, :] - knn_xyz  # [B, N, k, 3]
        tail = [(m.weight, m.bias) for m in (self.fc_delta_0, self.fc_delta_1,
                                            self.fc_gamma_0, self.fc_gamma_1)]
        trainable = self.training or _build.needs_grad(self, xyz, feats)
        tail_fn = vector_attention_trainable if trainable else vector_attention
        res = tail_fn(self.w_qs(x), g, delta, tail)
        return self.fc2(res) + feats.float(), None
