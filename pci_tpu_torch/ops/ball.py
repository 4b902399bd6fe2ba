"""Radius (ball) query with a fixed neighbour budget (counterpart of
``pci_tpu/ops/ball.py:ball_query``)."""

from __future__ import annotations

import torch

from .distance import square_distance


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """First ``nsample`` in-radius keys of each query, IN INDEX ORDER.

    ``xyz [B, N, 3]`` keys, ``new_xyz [B, S, 3]`` queries ->
    ``[B, S, nsample]`` int64.  A shortfall repeats the first hit; a query
    with no key in radius gets index 0.  In radius means
    ``d <= radius**2`` in fp32.
    """
    N = xyz.shape[1]
    d = square_distance(new_xyz.detach(), xyz.detach())  # [B, S, N]
    r2 = torch.tensor(float(radius) ** 2, dtype=torch.float32)
    pos = torch.arange(N, device=xyz.device)
    # the nsample smallest candidate indices are the first hits
    cand = torch.where(d <= r2.to(d.device), pos, N)
    k = min(nsample, N)
    idx = torch.sort(cand, dim=-1).values[..., :k]
    if k < nsample:
        idx = torch.cat([idx, idx.new_full((*idx.shape[:-1], nsample - k), N)], -1)
    idx = torch.where(idx == N, idx[..., :1], idx)
    # an all-empty row still holds N: read key 0, as the set-conv kernels
    # do (the JAX XLA path clips it to N - 1 instead)
    return torch.where(idx == N, 0, idx)
