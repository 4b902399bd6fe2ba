"""Multi-scale ball query: the CUDA kernel (csrc/ball.cu) and its plain
PyTorch version.

Replaces ``pci_tpu/ops/pallas_kernels/ball_tpu.py:ball_query_pallas`` and
its ``finish_ball_idx``.  For each (radius, K) scale, each query takes the
first K keys in radius IN INDEX ORDER (in radius: ``d <= radius**2`` in
fp32); a never-filled slot repeats the first hit, and a query with no key
in radius holds ``N - 1`` in every slot, as ``pci_tpu.ops.ball_query``
clips its sentinel.  On the card: one warp a query over the first
``PREFIX`` keys, then the queries still short of K as tasks of ``RANGE``
keys taken by persistent warps, merged in range order (csrc/ball.cu).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..distance import square_distance
from . import _build

MAX_SCALES = 8
PREFIX = 2048  # keys the first phase scans (csrc/ball.cu BALL_PREFIX)
RANGE = 1024  # keys a task (BALL_RANGE)
INFO = 2 + MAX_SCALES  # ints a listed query (BALL_INFO)
STAMPS = 4  # int64 a stamp row (BALL_STAMPS)


def ball_query_multi(radius_list, nsample_list, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> list:
    """``xyz [B, N, 3]`` keys, ``new_xyz [B, S, 3]`` queries -> one
    ``[B, S, K_s]`` int64 index tensor per (radius, K) scale, all scales
    from one scan of the keys.  Indices carry no gradient: the clouds are
    detached."""
    if len(radius_list) != len(nsample_list) or not 1 <= len(radius_list) <= MAX_SCALES:
        raise ValueError(f"ball query: 1 to {MAX_SCALES} (radius, K) scales")
    if _build.use_kernel(xyz):  # reads the clouds' data only: no detach needed
        if xyz.dtype != torch.float32 or not xyz.is_contiguous():
            xyz = xyz.detach().float().contiguous()
        if new_xyz.dtype != torch.float32 or not new_xyz.is_contiguous():
            new_xyz = new_xyz.detach().float().contiguous()
        return ball_kernel(xyz, new_xyz, radius_list, nsample_list)
    return ball_plain(xyz.detach(), new_xyz.detach(), radius_list, nsample_list, empty="last")


@functools.lru_cache(maxsize=64)
def scales_array(radii: tuple, ks: tuple) -> ctypes.Array:
    """The kernel's scale argument: the squared radii as fp32 bits (``r *
    r`` rounded to fp32 as ``ball_plain`` rounds it), then the budgets,
    int32.  Kept per (radii, budgets): a pure function of its key."""
    r2 = np.array([float(r) ** 2 for r in radii], np.float32).view(np.int32)
    return _build.int_array([*r2.tolist(), *ks])


def scratch_ints(B: int, N: int, S: int, ks) -> int:
    """The kernel's int32 scratch: two counters, then each query's entry in
    the list of queries not full after the prefix, then a record a task
    (a hit count a scale and up to K hits a scale); 0 when every key lies
    in the prefix (no task)."""
    nr = -(-(N - PREFIX) // RANGE) if N > PREFIX else 0
    return 2 + B * S * INFO + B * S * nr * (len(ks) + sum(ks)) if nr else 0


def ball_kernel(xyz, new_xyz, radius_list, nsample_list, stamps=None, scratch=None):
    """One call of csrc/ball.cu.  ``stamps``: a zeroed int64 ``[rows,
    STAMPS]`` CUDA tensor (``rows = pci_ball_stamp_rows(B, S)``) that takes
    each prefix block's start and end and each task warp's start, end,
    tasks and merges (``%globaltimer`` ns); ``scratch``: a given int32
    buffer of at least :func:`scratch_ints` (its first two entries then
    hold the listed queries and the tasks taken); both for measurement."""
    dev = xyz.device
    _build.require(xyz, "xyz", torch.float32, 3, dev)
    _build.require(new_xyz, "new_xyz", torch.float32, 3, dev)
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    if xyz.shape[-1] != 3 or new_xyz.shape[-1] != 3 or new_xyz.shape[0] != B:
        raise ValueError("ball kernel takes [B, N, 3] keys and [B, S, 3] queries")
    ks = tuple(int(k) for k in nsample_list)
    if min(ks) < 1:
        raise ValueError(f"ball kernel: budgets {list(ks)} must be positive")
    out = torch.empty(B * S * sum(ks), dtype=torch.int64, device=dev)
    need = scratch_ints(B, N, S, ks)
    if scratch is None and need:
        scratch = torch.empty(need, dtype=torch.int32, device=dev)
    if need and (scratch.dtype != torch.int32 or scratch.numel() < need
                 or not scratch.is_contiguous() or scratch.device != dev):
        raise ValueError(f"ball kernel: scratch of {need} contiguous int32 on {dev}")
    err = _build.library().pci_ball(
        xyz.data_ptr(), new_xyz.data_ptr(), out.data_ptr(),
        scales_array(tuple(radius_list), ks), len(ks), B, N, S,
        scratch.data_ptr() if need else None,
        stamps.data_ptr() if stamps is not None else None, _build.stream_ptr(dev),
    )
    _build.check_launch("ball", err)
    ball_kernel.launches += 1
    views, off = [], 0
    for k in ks:  # the scales' [B, S, K] blocks, back to back
        views.append(out.as_strided((B, S, k), (S * k, k, 1), off))
        off += B * S * k
    return views


ball_kernel.launches = 0


def ball_plain(xyz, new_xyz, radius_list, nsample_list, empty: str):
    """One shared ``[B, S, N]`` distance matrix for every scale.  ``empty``
    says what an all-empty row holds: ``"last"`` (``N - 1``, the JAX
    package's ball query) or ``"first"`` (key 0, what the set-conv kernels
    read)."""
    N = xyz.shape[1]
    d = square_distance(new_xyz.detach(), xyz.detach())  # [B, S, N]
    pos = torch.arange(N, device=xyz.device)
    outs = []
    for radius, nsample in zip(radius_list, nsample_list):
        r2 = torch.tensor(float(radius) ** 2, dtype=torch.float32, device=d.device)
        # the nsample smallest candidate indices are the first hits
        cand = torch.where(d <= r2, pos, N)
        k = min(nsample, N)
        idx = torch.sort(cand, dim=-1).values[..., :k]
        if k < nsample:
            idx = torch.cat([idx, idx.new_full((*idx.shape[:-1], nsample - k), N)], -1)
        idx = torch.where(idx == N, idx[..., :1], idx)
        outs.append(torch.where(idx == N, N - 1 if empty == "last" else 0, idx))
    return outs
