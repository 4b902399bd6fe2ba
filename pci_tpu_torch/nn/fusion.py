"""Adaptive attentive points fusion (counterpart of ``pci_tpu/nn/fusion.py``
``PointsFusion``).

Adaptive sampling takes ``N1 = N - N2`` points of warped cloud 1 and
``N2 ~ N * t`` (aligned to ``_ALIGN``) of warped cloud 2, each through its
own random permutation, into one combined cloud; each combined point then
takes ``k1 = k - floor(k * t)`` neighbours from the cloud-1 segment and
``k2`` from the cloud-2 segment, and the attention head fuses them.  At
eval that is one kernel on the card
(``ops.cuda_kernels.knn_fusion_attention``); in training, as on the TPU,
the residual kNN kernel (``fusion_resi_knn``: indices and residuals, with
the fixed-neighbour backward) and then the head in PyTorch, its BatchNorms
on batch statistics (``fusion_head``).

The permutations come from ``torch.randperm`` with the caller's
``torch.Generator``: torch cannot reproduce ``jax.random``'s draws, so a
caller that needs given permutations passes ``perms=(perm1, perm2)``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.cuda_kernels import fusion_resi_knn, knn_fusion_attention
from ..ops.cuda_kernels.fusion_knn_cuda import fusion_head
from .mlp import PointMLP

# N2 rounds to a multiple of _ALIGN; with k <= _ALIGN a segment with a
# positive neighbour budget always holds at least k points
_ALIGN = 32


def _adaptive_budgets(N: int, k: int, t: torch.Tensor):
    """(N1, N2, k1, k2) ``[B]`` int32 each, computed in fp32 as in
    ``pci_tpu/nn/fusion.py:_adaptive_budgets``."""
    t = t.float()
    k2 = torch.floor(k * t).to(torch.int32)
    k1 = k - k2
    N2 = (torch.floor(N * t / _ALIGN + 0.5) * _ALIGN).to(torch.int32)
    N2 = torch.maximum(N2, _ALIGN * (k2 > 0).to(torch.int32))
    N2 = torch.minimum(N2, N - _ALIGN * (k1 > 0).to(torch.int32))
    return N - N2, N2, k1, k2


def _composed_shuffle_merge(points_list, perms, n_all):
    """Combined cloud = concat of each shuffled cloud's ``n_all[:, j]``
    prefix, by one gather from the concatenation.  Returns
    ``(combined [B, N, 3], gidx [B, N])`` with gidx indexing the
    ``cat(points_list, 1)`` rows."""
    B, N, _ = points_list[0].shape
    F = len(points_list)
    dev = points_list[0].device
    pos = torch.arange(N, device=dev)[None, :]
    cum = torch.cumsum(n_all.long(), dim=1)  # [B, F], last == N
    owner = (pos[:, :, None] >= cum[:, None, :-1]).sum(-1)  # [B, N]
    start = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
    local = pos - torch.gather(start, 1, owner)
    perm_flat = torch.stack([p.long() for p in perms], dim=1).reshape(B, F * N)
    src = torch.gather(perm_flat, 1, owner * N + local.clamp(0, N - 1))
    gidx = owner * N + src
    cat = torch.cat(points_list, dim=1)
    combined = torch.gather(cat, 1, gidx[..., None].expand(-1, -1, cat.shape[-1]))
    return combined, gidx


def random_perms(B: int, N: int, generator: torch.Generator | None,
                 device) -> torch.Tensor:
    """``[B, N]`` int64 uniform permutations from ``generator``."""
    return torch.stack([
        torch.randperm(N, generator=generator, device=device) for _ in range(B)
    ])


class PointsFusion(nn.Module):
    """Fuse two warped clouds with adaptive sampling and learned attention
    over ``k`` adaptive neighbours."""

    def __init__(self):
        super().__init__()
        self.mlp = PointMLP(4, (64, 64, 128))  # the score MLP

    def forward(self, points1, points2, k: int, t, perms=None,
                generator: torch.Generator | None = None, momentum: float = 0.1):
        """``points1/2 [B, N, 3]`` warped clouds, ``t [B]`` in (0, 1) ->
        fused ``[B, N, 3]``.  ``perms``: optional ``(perm1, perm2)``
        ``[B, N]``; otherwise drawn from ``generator``.  ``momentum``: the
        score MLP's BatchNorm momentum in training."""
        B, N, _ = points1.shape
        N1, N2, k1, k2 = _adaptive_budgets(N, k, t)
        if perms is None:
            perms = (random_perms(B, N, generator, points1.device),
                     random_perms(B, N, generator, points1.device))
        combined, _ = _composed_shuffle_merge(
            [points1, points2], [p.to(points1.device) for p in perms],
            torch.stack([N1, N2], dim=1),
        )
        seg_ends = torch.stack([N1, torch.full_like(N1, N)], dim=1)
        budgets = torch.stack([k1, k2], dim=1)
        if self.training:
            _, resi = fusion_resi_knn(combined, seg_ends, budgets, k)
            # the head in PyTorch (pci_tpu/nn/fusion.py:282-292)
            return fusion_head(combined, resi, lambda h: self.mlp(h, momentum))
        return knn_fusion_attention(combined, seg_ends, budgets,
                                    self.mlp.folded(), k)
