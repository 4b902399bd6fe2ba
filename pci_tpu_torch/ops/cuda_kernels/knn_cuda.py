"""Exact k-nearest neighbours: the CUDA kernel (csrc/knn.cu) and its plain
PyTorch version.

Replaces ``pci_tpu/ops/pallas_kernels/knn_cells_tpu.py:knn_cells`` (the
transformer's self-kNN) with the EXACT function that
``pci_tpu.ops.knn(..., exact=True)`` defines: the ``k`` least fp32 squared
distances ``(dx*dx + dy*dy) + dz*dz``, ascending, ties to the lower key
index (a stable sort; ``torch.topk`` leaves the order of ties unspecified).
The TPU kernel is approximate (recall about 0.97).
"""

from __future__ import annotations

import torch

from ..distance import square_distance
from . import _build

MAX_K = 64  # the kernel keeps the top list in registers
# the plain version sorts [rows, N] blocks: about 2**27 elements a block
# (distances, sorted values and int64 indices: ~2 GB) whatever N is
_PLAIN_BLOCK = 1 << 27


def knn(query: torch.Tensor, points: torch.Tensor, k: int):
    """``query [B, S, C]``, ``points [B, N, C]`` -> ``(sq_dists [B, S, k]``
    fp32, ``idx [B, S, k]`` int64), ascending by distance.  The kernel on a
    CUDA tensor (xyz clouds, ``k <= 64``); it raises on anything else."""
    _build.check_eval_only("knn", query, points)
    if _build.use_kernel(points):
        return knn_kernel(query.detach().float().contiguous(),
                          points.detach().float().contiguous(), k)
    return knn_plain(query, points, k)


def knn_kernel(query, points, k):
    dev = points.device
    for name, t in (("query", query), ("points", points)):
        _build.require(t, name, torch.float32, 3, dev)
    B, N, C = points.shape
    S = query.shape[1]
    if C != 3 or query.shape[-1] != 3 or query.shape[0] != B:
        raise ValueError("knn kernel takes [B, S, 3] queries and [B, N, 3] keys")
    if not 1 <= k <= min(MAX_K, N):
        raise ValueError(f"knn kernel: k={k} needs 1 <= k <= min({MAX_K}, N={N})")
    dist = torch.empty((B, S, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, S, k), dtype=torch.int64, device=dev)
    err = _build.library().pci_knn(
        query.data_ptr(), points.data_ptr(), dist.data_ptr(), idx.data_ptr(),
        B, N, S, k, _build.stream_ptr(dev),
    )
    _build.check_launch("knn", err)
    knn_kernel.launches += 1
    return dist, idx


knn_kernel.launches = 0


def select_min_k(d: torch.Tensor, k: int):
    """Row-wise ``k`` least of ``d [..., N]`` by a stable sort."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def knn_plain(query, points, k):
    """Query blocks of bounded size: one ``[rows, N]`` distance matrix and
    its stable sort at a time."""
    query, points = query.detach(), points.detach()
    B, S = query.shape[:2]
    N = points.shape[1]
    rows = max(1, _PLAIN_BLOCK // max(1, B * N))
    parts = [select_min_k(square_distance(query[:, s:s + rows], points), k)
             for s in range(0, S, rows)]
    return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)
