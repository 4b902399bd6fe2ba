"""Multi-scale ball query: the CUDA kernel (csrc/ball.cu) and its plain
PyTorch version.

Replaces ``pci_tpu/ops/pallas_kernels/ball_tpu.py:ball_query_pallas`` and
its ``finish_ball_idx``.  For each (radius, K) scale, each query takes the
first K keys in radius IN INDEX ORDER (in radius: ``d <= radius**2`` in
fp32); a never-filled slot repeats the first hit, and a query with no key
in radius holds ``N - 1`` in every slot, as ``pci_tpu.ops.ball_query``
clips its sentinel.
"""

from __future__ import annotations

import torch

from ..distance import square_distance
from . import _build

MAX_SCALES = 8


def ball_query_multi(radius_list, nsample_list, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> list:
    """``xyz [B, N, 3]`` keys, ``new_xyz [B, S, 3]`` queries -> one
    ``[B, S, K_s]`` int64 index tensor per (radius, K) scale, all scales
    from one scan of the keys."""
    if len(radius_list) != len(nsample_list) or not 1 <= len(radius_list) <= MAX_SCALES:
        raise ValueError(f"ball query: 1 to {MAX_SCALES} (radius, K) scales")
    _build.check_eval_only("ball_query", xyz, new_xyz)
    if _build.use_kernel(xyz):
        return ball_kernel(xyz.detach().float().contiguous(),
                           new_xyz.detach().float().contiguous(),
                           radius_list, nsample_list)
    return ball_plain(xyz, new_xyz, radius_list, nsample_list, empty="last")


def ball_kernel(xyz, new_xyz, radius_list, nsample_list):
    dev = xyz.device
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz)):
        _build.require(t, name, torch.float32, 3, dev)
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    if xyz.shape[-1] != 3 or new_xyz.shape[-1] != 3 or new_xyz.shape[0] != B:
        raise ValueError("ball kernel takes [B, N, 3] keys and [B, S, 3] queries")
    ks = [int(k) for k in nsample_list]
    if min(ks) < 1:
        raise ValueError(f"ball kernel: budgets {ks} must be positive")
    out = torch.empty(B * S * sum(ks), dtype=torch.int64, device=dev)
    err = _build.library().pci_ball(
        xyz.data_ptr(), new_xyz.data_ptr(), out.data_ptr(),
        _build.float_array([float(r) ** 2 for r in radius_list]),
        _build.int_array(ks), len(ks), B, N, S, _build.stream_ptr(dev),
    )
    _build.check_launch("ball", err)
    ball_kernel.launches += 1
    return [o.view(B, S, k) for o, k in zip(out.split([B * S * k for k in ks]), ks)]


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
