"""Exact k-nearest-neighbour search (counterpart of ``pci_tpu/ops/knn.py``
``knn`` and, with ``valid_n``, ``knn_prefix``; ``cells_eligible`` and
``knn_self_resi``).

Selection is a stable sort of the fp32 squared distances, so ties go to
the lower key index (``torch.topk`` leaves the order of ties unspecified).
On a CUDA tensor ``knn`` launches the kNN kernel (``cuda_kernels.knn_cuda``).
"""

from __future__ import annotations

import torch

from .cuda_kernels.knn_cuda import MAX_K, knn, knn_cells
from .gather import index_points

# From this many points the self-kNN with residuals takes the box-pruned
# kernel's residual output (pci_tpu/ops/knn.py:_CELLS_MIN_N)
CELLS_MIN_N = 32768


def cells_eligible(points: torch.Tensor, k: int) -> bool:
    """True when :func:`knn_self_resi` takes the box-pruned kernel's
    residual output: an xyz CUDA cloud of at least ``CELLS_MIN_N`` points
    and ``k <= 64`` (``pci_tpu/ops/knn.py:cells_eligible``).  Callers branch
    on it by shape and device."""
    return (points.is_cuda and points.shape[-1] == 3 and points.shape[-2] >= CELLS_MIN_N
            and 1 <= k <= MAX_K)


def knn_self_resi(points: torch.Tensor, k: int):
    """Self-kNN and the exact neighbour-minus-query residuals: ``points
    [B, N, 3]`` -> ``(idx [B, N, k]`` int64, ``resi [B, N, k, 3]`` fp32,
    ``points[idx] - points[:, :, None]``), no gradient.  Where
    :func:`cells_eligible`, on the card, the box-pruned kernel writes the
    residuals itself (csrc/knn_cells.cu's segment form, no xyz gather; its
    plain version under ``plain_versions()``); elsewhere :func:`knn` and the
    gather.  The same indices and residuals
    bit for bit either way."""
    points = points.detach().float()
    if cells_eligible(points, k):  # the kernel, or its plain version under plain_versions()
        points = points.contiguous()
        _, idx, resi = knn_cells(points, points, k, emit_resi=True)
        return idx, resi
    _, idx = knn(points, points, k)
    return idx, index_points(points, idx) - points[:, :, None, :]


__all__ = ["cells_eligible", "knn", "knn_self_resi"]
