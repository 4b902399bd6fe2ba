"""Morton order and chunk boxes for cell-pruned neighbour search (the
counterparts of ``pci_tpu/ops/pallas_kernels/knn_cells_tpu.py``'s
``morton_codes``, ``_sort_by_morton``, ``_chunk_boxes`` and ``_box_lb``,
computed as those are, so the sort and the boxes equal the JAX package's).

A cloud sorted along the z-order curve keeps close points in nearby rows;
cut into contiguous chunks, each chunk's axis-aligned box bounds the
distance from any query to any key in it.  The cell-pruned fusion kernel
(``cuda_kernels/fusion_cells_cuda.py``) walks chunks in the order of these
bounds and skips the ones that cannot hold a neighbour.
"""

from __future__ import annotations

import functools

import torch

BIG = 1e30  # an empty box is (+BIG, -BIG): its bound to anything is ~BIG^2


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``v`` to bit positions 0, 3, 6, ... 27."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


@functools.cache
def _spread_table(device: torch.device) -> torch.Tensor:
    """``_spread3`` of 0 .. 1023, ``[1024, 3]`` int32 with columns shifted
    for x, y, z: one gather spreads a grid cell's three coordinates."""
    v = _spread3(torch.arange(1024, dtype=torch.int32, device=device))
    return torch.stack([v, v << 1, v << 2], dim=1)


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """``[B, N, 3]`` -> ``[B, N]`` int32 z-order codes on a per-batch
    1024^3 grid over the cloud's bounding box."""
    p = points.float()
    lo = p.amin(dim=1, keepdim=True)
    hi = p.amax(dim=1, keepdim=True)
    scale = 1024.0 / torch.clamp_min(hi - lo, 1e-6)
    q = torch.clamp((p - lo) * scale, 0.0, 1023.0).to(torch.int64)
    bits = torch.gather(_spread_table(p.device), 0, q.reshape(-1, 3)).reshape(q.shape)
    return bits[..., 0] | bits[..., 1] | bits[..., 2]


def sort_by_morton(points: torch.Tensor, n_pad: int):
    """Stable sort by Morton code -> ``(sorted points [B, N + n_pad, 3],
    perm [B, N + n_pad] int32)``; pad rows sit at +1e15 with perm id N,
    at the tail."""
    B, N, _ = points.shape
    perm = torch.argsort(morton_codes(points), dim=-1, stable=True)
    pts = torch.gather(points.float(), 1, perm[..., None].expand(-1, -1, 3))
    perm = perm.to(torch.int32)
    if n_pad:
        pts = torch.cat([pts, pts.new_full((B, n_pad, 3), 1e15)], dim=1)
        perm = torch.cat([perm, perm.new_full((B, n_pad), N)], dim=1)
    return pts, perm


def chunk_boxes(pts: torch.Tensor, C: int, valid: torch.Tensor | None = None):
    """``[..., Np, 3]`` -> ``(lo [..., Np // C, 3], hi [..., Np // C, 3])``,
    the box of each length-``C`` chunk over its ``valid`` ``[..., Np]`` rows
    (all rows for None; the leading axes broadcast); a chunk with no valid
    row gets ``(+BIG, -BIG)``."""
    Np = pts.shape[-2]
    r = pts.reshape(*pts.shape[:-2], Np // C, C, 3)
    if valid is None:
        return r.amin(dim=-2), r.amax(dim=-2)
    v = valid.reshape(*valid.shape[:-1], Np // C, C, 1)
    return torch.where(v, r, BIG).amin(dim=-2), torch.where(v, r, -BIG).amax(dim=-2)


def box_lb(qlo, qhi, klo, khi) -> torch.Tensor:
    """Squared box-to-box lower-bound distance: ``qlo/qhi [..., T, 3]``,
    ``klo/khi [..., nc, 3]`` -> ``[..., T, nc]`` (the leading axes
    broadcast)."""
    gap = torch.clamp_min(torch.maximum(qlo[..., :, None, :] - khi[..., None, :, :],
                                        klo[..., None, :, :] - qhi[..., :, None, :]), 0.0)
    return (gap * gap).sum(-1)
