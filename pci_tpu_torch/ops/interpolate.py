"""Three-nearest-neighbour inverse-distance interpolation (counterpart of
``pci_tpu/ops/interpolate.py``)."""

from __future__ import annotations

import torch

from .gather import index_points
from .knn import knn


def three_nn_interpolate(query_xyz: torch.Tensor, ref_xyz: torch.Tensor,
                         ref_feats: torch.Tensor,
                         mode: str = "clamp") -> torch.Tensor:
    """Interpolate ``ref_feats [B, S, C]`` onto ``query_xyz [B, N, 3]``.

    Distances are recomputed from the chosen indices.  ``mode="clamp"``:
    weights ``1 / max(d, 1e-10)``; ``mode="eps"``: ``1 / (d + 1e-8)``.
    """
    _, idx = knn(query_xyz, ref_xyz, 3)
    diff = index_points(ref_xyz, idx) - query_xyz[:, :, None, :]
    d = (diff * diff).sum(-1)
    if mode == "clamp":
        recip = 1.0 / d.clamp_min(1e-10)
    elif mode == "eps":
        recip = 1.0 / (d + 1e-8)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    weights = recip / recip.sum(-1, keepdim=True)
    return (index_points(ref_feats, idx) * weights[..., None]).sum(2)
