"""Farthest point sampling (counterpart of ``pci_tpu/ops/fps.py``).

Greedy FPS: each iteration picks the point farthest from the chosen set.
``exact=False`` at N >= 4096 runs ``P`` interleaved greedy chains over
strided subsets (``_auto_parallel``), the JAX package's accelerator route.
The port applies that rule on EVERY device, so its CPU output at
N >= 4096 with ``exact=False`` equals the JAX package's TPU result (the
JAX package itself runs exact greedy on the CPU).
"""

from __future__ import annotations

import torch

from .cuda_kernels.fps_cuda import fps_index
from .gather import index_points


def _auto_parallel(N: int, npoint: int) -> int:
    """Interleaved-chain count: each chain must make >= 32 picks from
    >= 512 candidates (``pci_tpu/ops/fps.py:_auto_parallel``)."""
    for P in (8, 4, 2):
        if npoint % P == 0 and npoint // P >= 32 and N // P >= 512:
            return P
    return 1


def fps(xyz: torch.Tensor, npoint: int, start_idx: int | torch.Tensor = 0,
        exact: bool = True) -> torch.Tensor:
    """``xyz [B, N, 3]`` -> ``[B, npoint]`` int32 indices (selection order).

    ``start_idx``: scalar or ``[B]`` start index (0 keeps eval
    deterministic).  ``npoint > N`` behaves like the greedy loop: once
    every distance is 0 the argmax is index 0 again.
    """
    N = xyz.shape[1]
    P = 1 if exact or N < 4096 else _auto_parallel(N, npoint)
    start = (start_idx if isinstance(start_idx, int)  # an int needs no device copy
             else torch.as_tensor(start_idx, device=xyz.device).reshape(-1))
    return fps_index(xyz.detach(), npoint, start, P)


def fps_points(xyz: torch.Tensor, npoint: int,
               start_idx: int | torch.Tensor = 0,
               exact: bool = True) -> torch.Tensor:
    """FPS returning the sampled coordinates ``[B, npoint, 3]``."""
    return index_points(xyz, fps(xyz, npoint, start_idx, exact))
