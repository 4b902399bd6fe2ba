"""Batched row gather and its transpose (counterpart of
``pci_tpu/ops/gather.py``)."""

from __future__ import annotations

import torch


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points [B, N, C]``, ``idx [B, ...]`` integer -> ``[B, ..., C]``."""
    B, C = points.shape[0], points.shape[-1]
    flat = idx.reshape(B, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(*idx.shape, C)


def knn_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x [B, N, C]``, neighbour indices ``idx [B, S, K]`` -> ``[B, S, K, C]``."""
    return index_points(x, idx)


def scatter_add_rows(idx: torch.Tensor, g: torch.Tensor, n_out: int) -> torch.Tensor:
    """Transpose of a batched row gather: ``out[b, m] += g[b, q]`` for every
    ``q`` with ``idx[b, q] == m``; ``idx [B, Q]`` in ``[0, n_out)``, ``g
    [B, Q, C]`` -> ``[B, n_out, C]``.  One ``index_add_`` (the JAX
    package's ``"scatter"`` method; on a CUDA tensor its adds are atomic,
    so their order, and the last bits of a sum, change from run to run)."""
    B, Q = idx.shape
    C = g.shape[2:]
    flat = (idx.long() + n_out * torch.arange(B, device=idx.device)[:, None]).reshape(-1)
    out = torch.zeros((B * n_out, *C), dtype=g.dtype, device=g.device)
    out.index_add_(0, flat, g.reshape(B * Q, *C))
    return out.reshape(B, n_out, *C)
