"""Pairwise squared distances, in fp32.

Counterpart of ``pci_tpu/ops/distance.py:square_distance``.  The JAX
version expands ``|a|^2 + |b|^2 - 2 a.b`` to run the cross term on the
TPU's matrix unit; this one sums the per-coordinate differences directly,
``(dx*dx + dy*dy) + dz*dz`` with every operation rounded on its own.  That
is the form every CUDA kernel of the port evaluates (csrc/common.cuh
``sqdist3``), so selections made from these distances (ball membership,
k-nearest order, FPS argmax) agree with the kernels bit for bit, and it
has no cancellation error far from the origin.
"""

from __future__ import annotations

import torch


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``[..., N, C]`` x ``[..., M, C]`` -> ``[..., N, M]`` fp32
    ``|src_i - dst_j|^2``."""
    src = src.float()
    dst = dst.float()
    d = None
    for c in range(src.shape[-1]):
        diff = src[..., :, None, c] - dst[..., None, :, c]
        sq = diff * diff
        d = sq if d is None else d + sq
    return d
