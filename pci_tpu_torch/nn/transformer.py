"""Point-transformer self-attention layer, eval (counterpart of
``pci_tpu/nn/transformer.py:TransformerLayer``, its default unsharded
route).

kNN(k) neighbourhoods of each point in its own cloud, one fused
``[xyz | K | V]`` row gather, offsets ``delta = xyz - knn_xyz``, then the
vector-attention tail (one kernel on the card) and ``fc2`` plus the
residual.  Returns ``(out, None)``, as the TPU eval route does: the
``[B, N, k, d]`` attention maps are what the tail kernel exists not to
write.  The dense layers are ``torch.matmul``s.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.cuda_kernels import knn, vector_attention
from .layers import gather_split


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
        if self.training:
            raise RuntimeError("TransformerLayer: the port runs eval only; call .eval()")
        x = self.fc1(feats)
        kv = torch.cat([self.w_ks(x), self.w_vs(x)], -1)
        _, idx = knn(xyz, xyz, self.k)
        knn_xyz, g = gather_split(xyz, kv, idx)
        delta = xyz[:, :, None, :] - knn_xyz  # [B, N, k, 3]
        tail = [(m.weight, m.bias) for m in (self.fc_delta_0, self.fc_delta_1,
                                            self.fc_gamma_0, self.fc_gamma_1)]
        res = vector_attention(self.w_qs(x), g, delta, tail)
        return self.fc2(res) + feats.float(), None
