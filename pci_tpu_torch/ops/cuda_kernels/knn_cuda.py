"""Exact k-nearest neighbours: the CUDA kernel (csrc/knn.cu) and its plain
PyTorch version, behind one wrapper, :func:`knn`.

It replaces two TPU kernels with the EXACT function that
``pci_tpu.ops.knn(..., exact=True)`` and ``pci_tpu.ops.knn_prefix(...,
exact=True)`` define: the ``k`` least fp32 squared distances ``(dx*dx +
dy*dy) + dz*dz``, ascending, ties to the lower key index (a stable sort;
``torch.topk`` leaves the order of ties unspecified), over the first
``valid_n[b]`` keys when ``valid_n`` is given.  Keys at or past
``valid_n`` have the sentinel distance 1e30, so when ``valid_n < k`` the
surplus slots hold 1e30 and the indices ``valid_n, valid_n + 1, ...``.

- ``pci_tpu/ops/pallas_kernels/knn_cells_tpu.py:knn_cells`` (the
  transformer's self-kNN, and the small cross-cloud kNNs), approximate on
  the TPU (recall about 0.97): the kernel's k-list forms, counted in
  ``knn_kernel.launches``.
- ``pci_tpu/ops/pallas_kernels/knn_tpu.py:knn_pallas`` (the chamfer loss's
  nearest neighbour, k=1): the kernel's one-running-minimum form, counted
  in ``nearest_launches.launches``.  The TPU kernel takes k <= 128 and
  buckets its keys; this one is exact and takes k <= 64.

Distances and indices carry no gradient: the inputs are detached, as
``knn_pallas`` stop-gradients them.
"""

from __future__ import annotations

import types

import torch

from ..distance import square_distance
from . import _build

MAX_K = 64  # the kernel keeps the top list in registers
SENTINEL = 1e30  # the distance of a key outside the prefix
# the plain version sorts [rows, N] blocks: about 2**27 elements a block
# (distances, sorted values and int64 indices: ~2 GB) whatever N is
_PLAIN_BLOCK = 1 << 27


def knn(query: torch.Tensor, points: torch.Tensor, k: int,
        valid_n: torch.Tensor | None = None):
    """``query [B, S, C]``, ``points [B, N, C]``, ``valid_n [B]`` int or
    None (every key) -> ``(sq_dists [B, S, k]`` fp32, ``idx [B, S, k]``
    int64), ascending by distance.  The kernel on a CUDA tensor (xyz
    clouds, ``k <= 64``); it raises on anything else."""
    query, points = query.detach(), points.detach()
    if _build.use_kernel(points):
        return knn_kernel(query.float().contiguous(), points.float().contiguous(),
                          k, valid_n)
    return knn_plain(query, points, k, valid_n)


def _launch(query, points, k, valid_n):
    dev = points.device
    for name, t in (("query", query), ("points", points)):
        _build.require(t, name, torch.float32, 3, dev)
    B, N, C = points.shape
    S = query.shape[1]
    if C != 3 or query.shape[-1] != 3 or query.shape[0] != B:
        raise ValueError("knn kernel takes [B, S, 3] queries and [B, N, 3] keys")
    if not 1 <= k <= min(MAX_K, N):
        raise ValueError(f"knn kernel: k={k} needs 1 <= k <= min({MAX_K}, N={N})")
    if valid_n is not None:
        valid_n = valid_n.to(dev, torch.int32).reshape(B).contiguous()
    dist = torch.empty((B, S, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, S, k), dtype=torch.int64, device=dev)
    err = _build.library().pci_knn(
        query.data_ptr(), points.data_ptr(),
        None if valid_n is None else valid_n.data_ptr(),
        dist.data_ptr(), idx.data_ptr(), B, N, S, k, _build.stream_ptr(dev),
    )
    _build.check_launch("knn", err)
    return dist, idx


def knn_kernel(query, points, k, valid_n=None):
    """Launch csrc/knn.cu; a launch of its k=1 form counts in
    ``nearest_launches``, any other in ``knn_kernel.launches``."""
    out = _launch(query, points, k, valid_n)
    if k == 1:
        nearest_launches.launches += 1
    else:
        knn_kernel.launches += 1
    return out


knn_kernel.launches = 0
nearest_launches = types.SimpleNamespace(launches=0)


def select_min_k(d: torch.Tensor, k: int):
    """Row-wise ``k`` least of ``d [..., N]`` by a stable sort (copies:
    a slice would keep the whole sorted block alive)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].contiguous()


def knn_plain(query, points, k, valid_n=None):
    """Query blocks of bounded size: one ``[rows, N]`` distance matrix,
    masked past ``valid_n``, and its stable sort at a time."""
    query, points = query.detach(), points.detach()
    B, S = query.shape[:2]
    N = points.shape[1]
    rows = max(1, _PLAIN_BLOCK // max(1, B * N))
    mask = None
    if valid_n is not None:
        pos = torch.arange(N, device=points.device)
        mask = pos[None, None, :] < valid_n.to(points.device).reshape(B)[:, None, None]
    parts = []
    for s in range(0, S, rows):
        d = square_distance(query[:, s:s + rows], points)
        if mask is not None:
            d = torch.where(mask, d, torch.tensor(SENTINEL, device=d.device))
        parts.append(select_min_k(d, k))
    return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)
