"""Exact k-nearest-neighbour search (counterpart of ``pci_tpu/ops/knn.py``
``knn`` and ``knn_prefix``).

Selection is a stable sort of the fp32 squared distances, so ties go to
the lower key index (``torch.topk`` leaves the order of ties unspecified).
``knn`` launches the kNN kernel (``cuda_kernels.knn_cuda``) on a CUDA
tensor.
"""

from __future__ import annotations

import torch

from .cuda_kernels.knn_cuda import knn, select_min_k
from .distance import square_distance

_SENTINEL = 1e30


def knn_prefix(query: torch.Tensor, points: torch.Tensor, k: int,
               valid_n: torch.Tensor):
    """kNN into the first ``valid_n[b]`` rows of ``points`` only.

    Keys at positions ``>= valid_n`` get the sentinel distance 1e30 and
    sort last; if ``valid_n < k`` the surplus slots hold sentinel
    distances with arbitrary indices.
    """
    d = square_distance(query.detach(), points.detach())
    pos = torch.arange(points.shape[1], device=points.device)
    mask = pos[None, None, :] < valid_n.to(points.device)[:, None, None]
    d = torch.where(mask, d, torch.tensor(_SENTINEL, device=d.device))
    return select_min_k(d, k)


__all__ = ["knn", "knn_prefix"]
