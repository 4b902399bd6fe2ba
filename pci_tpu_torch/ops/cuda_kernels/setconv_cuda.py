"""Fused set-conv tail: ball group + folded-BN MLP + max over the slots.
The CUDA kernel (csrc/setconv.cu) and its plain PyTorch version.

Replaces ``pci_tpu/ops/pallas_kernels/setconv_tpu.py:setconv_fused``;
``fold_bn_layers`` is the same file's host-side fold.
"""

from __future__ import annotations

import torch

from ..gather import index_points
from . import _build
from .ball_cuda import ball_plain


def fold_bn_layers(linears, norms):
    """Fold eval-mode BatchNorm into the Dense layers before it.

    ``linears``: ``nn.Linear`` modules (``weight [cout, cin]``, ``bias``);
    ``norms``: the BatchNorm after each (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``eps``).  Returns
    ``[(W [cout, cin], b [cout]), ...]`` with
    ``W = weight * s``, ``b = bias * s + (beta - mean * s)``,
    ``s = gamma / sqrt(var + eps)``.
    """
    layers = []
    for lin, bn in zip(linears, norms):
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        w = lin.weight * scale[:, None]
        b = lin.bias * scale + (bn.bias - bn.running_mean * scale)
        layers.append((w, b))
    return layers


def setconv_fused(xyz: torch.Tensor, feats: torch.Tensor,
                  new_xyz: torch.Tensor, radius: float, nsample: int,
                  layers) -> torch.Tensor:
    """Ball-group ``[xyz - query | feats]`` rows around each query (first
    ``nsample`` in-radius keys in index order; shortfall repeats the first
    hit; an empty query reads key 0), run the folded MLP chain (ReLU after
    every layer) and max over the slots.

    ``xyz [B, N, 3]``, ``feats [B, N, D]``, ``new_xyz [B, S, 3]``,
    ``layers`` from :func:`fold_bn_layers` -> ``[B, S, C_last]`` fp32.
    """
    _build.check_eval_only("setconv_fused", xyz, feats, new_xyz,
                           *[t for wb in layers for t in wb])
    if _build.use_kernel(xyz):
        return setconv_kernel(xyz.float().contiguous(),
                              feats.float().contiguous(),
                              new_xyz.float().contiguous(), radius, nsample,
                              layers)
    return setconv_plain(xyz, feats, new_xyz, radius, nsample, layers)


def setconv_kernel(xyz, feats, new_xyz, radius, nsample, layers):
    dev = xyz.device
    B, N, _ = xyz.shape
    S, D = new_xyz.shape[1], feats.shape[-1]
    for name, t in (("xyz", xyz), ("feats", feats), ("new_xyz", new_xyz)):
        _build.require(t, name, torch.float32, 3, dev)
    if feats.shape[:2] != (B, N) or new_xyz.shape[0] != B:
        raise ValueError("setconv: batch or key counts disagree")
    wbuf, dims = _build.pack_layers(layers, dev)
    if not dims or dims[0] != 3 + D:
        raise ValueError(f"setconv: MLP widths {dims} do not take 3 + {D} channels")
    out = torch.empty((B, S, dims[-1]), dtype=torch.float32, device=dev)
    err = _build.library().pci_setconv(
        xyz.data_ptr(), feats.data_ptr(), new_xyz.data_ptr(), wbuf.data_ptr(),
        _build.int_array(dims), len(layers), out.data_ptr(), B, N, S, D,
        float(radius) ** 2, nsample, _build.stream_ptr(dev),
    )
    _build.check_launch("setconv", err)
    setconv_kernel.launches += 1
    return out


setconv_kernel.launches = 0


def setconv_plain(xyz, feats, new_xyz, radius, nsample, layers):
    # an all-empty row reads key 0, as setconv_tpu does (the ball query
    # itself gives N - 1 there)
    (idx,) = ball_plain(xyz, new_xyz, [radius], [nsample], empty="first")
    h = torch.cat([index_points(xyz, idx) - new_xyz[:, :, None, :],
                   index_points(feats.float(), idx)], dim=-1)
    return _build.mlp_plain(h, layers).amax(dim=2)
