"""Farthest point sampling: the CUDA kernel (csrc/fps.cu) and its plain
PyTorch version.

Replaces ``pci_tpu/ops/pallas_kernels/fps_tpu.py`` (``fps_pallas`` and
``fps_pallas_interleaved``).  ``P`` greedy chains run over the strided
subsets ``s, s+P, s+2P, ...``; chain ``s`` starts at ``start // P``
(clamped to its subset) and the picks interleave iteration-major.  ``P=1``
is exact greedy FPS.  Ties go to the lowest index, as ``jnp.argmax``.
"""

from __future__ import annotations

import torch

from . import _build


def fps_index(xyz: torch.Tensor, npoint: int, start: torch.Tensor,
              P: int) -> torch.Tensor:
    """``xyz [B, N, 3]`` fp32, ``start [B]`` int -> ``[B, npoint]`` int32
    selection order.  Kernel on a CUDA tensor, plain version on the CPU.
    Indices carry no gradient: ``xyz`` is detached."""
    xyz = xyz.detach()
    if npoint % P:
        raise ValueError(f"npoint={npoint} must divide into P={P} chains")
    if _build.use_kernel(xyz):
        return fps_kernel(xyz, npoint, start, P)
    return fps_plain(xyz, npoint, start, P)


def fps_kernel(xyz: torch.Tensor, npoint: int, start: torch.Tensor,
               P: int) -> torch.Tensor:
    B, N, _ = xyz.shape
    dev = xyz.device
    _build.require(xyz, "xyz", torch.float32, 3, dev)
    if xyz.shape[-1] != 3:
        raise ValueError("fps kernel takes [B, N, 3] clouds")
    if -(-N // P) > 16384:
        raise ValueError("fps kernel holds at most 16,384 points a chain")
    start = start.to(device=dev, dtype=torch.int32).expand(B).contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=dev)
    err = _build.library().pci_fps(
        xyz.data_ptr(), start.data_ptr(), out.data_ptr(), B, N, npoint, P,
        _build.stream_ptr(dev),
    )
    _build.check_launch("fps", err)
    fps_kernel.launches += 1
    return out


fps_kernel.launches = 0


def fps_plain(xyz: torch.Tensor, npoint: int, start: torch.Tensor,
              P: int) -> torch.Tensor:
    B, N, _ = xyz.shape
    dev = xyz.device
    L = -(-N // P)
    x = xyz.float()
    if L * P != N:
        x = torch.nn.functional.pad(x, (0, 0, 0, L * P - N))
    # subset s = rows s, s+P, ...: [B, L, P, 3] -> [B*P, L, 3]
    sub = x.reshape(B, L, P, 3).transpose(1, 2).reshape(B * P, L, 3)
    pos = torch.arange(L * P, device=dev).reshape(L, P).t()  # global index
    valid = (pos < N).expand(B, P, L).reshape(B * P, L)
    start = start.to(device=dev, dtype=torch.long).expand(B)
    far = torch.minimum(start.repeat_interleave(P) // P, valid.sum(-1) - 1)
    dist = torch.where(valid, float("inf"), -1.0)
    rows = torch.arange(B * P, device=dev)
    picks = []
    for _ in range(npoint // P):
        picks.append(far)
        diff = sub - sub[rows, far][:, None, :]
        d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
            + diff[..., 2] * diff[..., 2]
        dist = torch.where(valid, torch.minimum(dist, d), dist)
        far = torch.argmax(dist, dim=-1)  # first maximum
    local = torch.stack(picks, -1).reshape(B, P, npoint // P)
    glob = local * P + torch.arange(P, device=dev)[None, :, None]
    return glob.transpose(1, 2).reshape(B, npoint).to(torch.int32)
