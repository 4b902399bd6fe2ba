"""Chamfer distance, the training loss and the eval metric (counterpart of
``pci_tpu/ops/chamfer.py``).

Squared distances, the mean over points in each direction, the two
directions summed, then the mean over the batch (pytorch3d's defaults).
The nearest neighbour is selected on detached clouds (the kNN kernel's
k=1 form on the card); the loss is differentiable through the gather
of the chosen point, ``|a - b[idx]|^2``.
"""

from __future__ import annotations

import torch

from .gather import index_points
from .knn import knn


def nearest_neighbor_idx(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Index in ``b [B, M, C]`` of the nearest neighbour of every point of
    ``a [B, N, C]`` -> ``[B, N]`` int64, ties to the lower index."""
    _, idx = knn(a, b, 1)
    return idx[..., 0]


def min_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differentiable per-point min squared distance ``a -> b``: ``[B, N]``."""
    nn = index_points(b, nearest_neighbor_idx(a, b))
    return ((a - nn) ** 2).sum(-1)


def chamfer_per_sample(pc1: torch.Tensor, pc2: torch.Tensor) -> torch.Tensor:
    """Per-sample chamfer ``[B]``: ``mean_N d(pc1 -> pc2) + mean_M d(pc2 -> pc1)``."""
    return min_sqdist(pc1, pc2).mean(-1) + min_sqdist(pc2, pc1).mean(-1)


def chamfer_distance(pc1: torch.Tensor, pc2: torch.Tensor) -> torch.Tensor:
    """Symmetric chamfer distance of ``pc1 [B, N, 3]`` and ``pc2 [B, M, 3]``,
    averaged over the batch (a scalar)."""
    return chamfer_per_sample(pc1, pc2).mean()


def chamfer_loss_cf(pc1_cf: torch.Tensor, pc2_cf: torch.Tensor) -> torch.Tensor:
    """:func:`chamfer_distance` of channels-first ``[B, 3, N]`` clouds."""
    return chamfer_distance(pc1_cf.transpose(-1, -2), pc2_cf.transpose(-1, -2))
