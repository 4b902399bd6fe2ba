"""Radius (ball) query with a fixed neighbour budget (counterpart of
``pci_tpu/ops/ball.py``: ``ball_query`` and ``ball_query_multi``)."""

from __future__ import annotations

import torch

from .cuda_kernels.ball_cuda import ball_query_multi


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """First ``nsample`` in-radius keys of each query, IN INDEX ORDER.

    ``xyz [B, N, 3]`` keys, ``new_xyz [B, S, 3]`` queries ->
    ``[B, S, nsample]`` int64.  A shortfall repeats the first hit; a query
    with no key in radius gets index ``N - 1`` in every slot, as the JAX
    package's XLA path and ``finish_ball_idx`` give it (their docstrings
    say 0; the code clips to N - 1).  In radius means ``d <= radius**2``
    in fp32.  The ball kernel on a CUDA tensor.
    """
    (idx,) = ball_query_multi([radius], [nsample], xyz, new_xyz)
    return idx


__all__ = ["ball_query", "ball_query_multi"]
