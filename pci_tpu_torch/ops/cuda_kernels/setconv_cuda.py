"""Fused set-conv tail: ball group + folded-BN MLP + max over the slots.
The CUDA kernel (csrc/setconv.cu: the MLP on the tensor cores in 3xTF32,
on ``ball_conv_tile`` or, for long scans and few centres, on a tile whose
layer columns split over thread-block clusters) and its plain PyTorch
version.

Replaces ``pci_tpu/ops/pallas_kernels/setconv_tpu.py:setconv_fused``;
``fold_bn_layers`` is the same file's host-side fold.
"""

from __future__ import annotations

import torch

from ..gather import index_points
from . import _build
from .ball_cuda import ball_plain

MAX_NSAMPLE = 128  # the JAX package's gate (pci_tpu/nn/layers.py:_setconv_ok)
# csrc/setconv.cu's limits: common.cuh's PCI_MAX_LAYERS, and the widest
# layer whose two 16-row buffers, pooled row and weight ring fit a block
MAX_LAYERS, MAX_WIDTH = 8, 1024
STAMPS = 6  # csrc/setconv.cu SETCONV_STAMPS: scan, gather, mlp, pool, whole (ns), tiles
PLAN_KEYS = ("Q", "C", "R", "ring_ntw", "smem", "blocks", "cluster")


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
    if _build.use_kernel(xyz) and kernel_route_ok(nsample, _build.layer_widths(layers)):
        return setconv_kernel(xyz.float().contiguous(),
                              feats.float().contiguous(),
                              new_xyz.float().contiguous(), radius, nsample,
                              layers)
    return setconv_plain(xyz, feats, new_xyz, radius, nsample, layers)


def kernel_route_ok(nsample: int, dims) -> bool:
    """The shapes the kernel takes: ``1 <= nsample <= MAX_NSAMPLE`` (the JAX
    gate) and 1 to ``MAX_LAYERS`` layers of at most ``MAX_WIDTH``
    channels (``dims``: the chain's widths); the plain version serves the
    rest, decided before any launch."""
    return (1 <= nsample <= MAX_NSAMPLE and 1 <= len(dims) - 1 <= MAX_LAYERS
            and max(dims) <= MAX_WIDTH)


def setconv_kernel(xyz, feats, new_xyz, radius, nsample, layers, stamps=None):
    """The launch.  ``stamps`` (a measurement launch only): a zeroed int64
    ``[blocks, STAMPS]`` tensor (:func:`setconv_plan`'s ``blocks``) that
    gets each block's stage times where the plan takes the cluster tile."""
    dev = xyz.device
    B, N, _ = xyz.shape
    S, D = new_xyz.shape[1], feats.shape[-1]
    for name, t in (("xyz", xyz), ("feats", feats), ("new_xyz", new_xyz)):
        _build.require(t, name, torch.float32, 3, dev)
    if feats.shape[:2] != (B, N) or new_xyz.shape[0] != B:
        raise ValueError("setconv: batch or key counts disagree")
    dims = _build.layer_widths(layers)
    if not dims or dims[0] != 3 + D:
        raise ValueError(f"setconv: MLP widths {dims} do not take 3 + {D} channels")
    if not kernel_route_ok(nsample, dims):
        raise ValueError(f"setconv: nsample {nsample} or widths {dims} past the kernel's")
    wbuf = _build.pack_tf32(layers, dev)
    out = torch.empty((B, S, dims[-1]), dtype=torch.float32, device=dev)
    err = _build.library().pci_setconv(
        xyz.data_ptr(), feats.data_ptr(), new_xyz.data_ptr(), wbuf.data_ptr(),
        _build.int_array(dims), len(dims) - 1, out.data_ptr(), B, N, S, D,
        float(radius) ** 2, nsample, stamps.data_ptr() if stamps is not None else None,
        _build.stream_ptr(dev),
    )
    _build.check_launch("setconv", err)
    setconv_kernel.launches += 1
    return out


setconv_kernel.launches = 0


def setconv_plan(B, N, S, D, nsample, dims) -> dict:
    """The plan csrc/setconv.cu takes for these shapes (on the current
    CUDA device): centres a tile ``Q``, blocks a cluster ``C``, MLP rows a
    chunk ``R``, the weight ring's n-tiles ``ring_ntw``, dynamic shared
    bytes ``smem``, blocks in the grid ``blocks``, and ``cluster`` 1 for
    the cluster tile, 0 for ``ball_conv_tile``."""
    out = _build.int_array([0] * len(PLAN_KEYS))
    err = _build.library().pci_setconv_plan(_build.int_array(dims), len(dims) - 1, B, N, S, D,
                                            nsample, out)
    _build.check_launch("setconv_plan", err)
    return dict(zip(PLAN_KEYS, out))


def setconv_stages(xyz, feats, new_xyz, radius, nsample, layers) -> dict:
    """The launch's plan and, where it takes the cluster tile, one
    measurement launch with the stamps on (CUDA inputs, the wrapper's
    arguments): the scan's, gather's, MLP's and pool's shares of the
    blocks' summed time, the longest block's time (``span_ms``) and mean
    block time (``block_ms``)."""
    B, N, _ = xyz.shape
    plan = setconv_plan(B, N, new_xyz.shape[1], feats.shape[-1], nsample,
                        _build.layer_widths(layers))
    if not plan["cluster"]:
        return plan
    stamps = torch.zeros((plan["blocks"], STAMPS), dtype=torch.int64, device=xyz.device)
    setconv_kernel(xyz.float().contiguous(), feats.float().contiguous(),
                   new_xyz.float().contiguous(), radius, nsample, layers, stamps)
    t = stamps.cpu().double()
    parts = t[:, :4].sum(0)
    total = float(parts.sum())
    return {**{k: float(v) / total for k, v in zip(("scan", "gather", "mlp", "pool"), parts)},
            "span_ms": float(t[:, 4].max()) * 1e-6, "block_ms": float(t[:, 4].mean()) * 1e-6,
            **plan}


def setconv_plain(xyz, feats, new_xyz, radius, nsample, layers):
    # an all-empty row reads key 0, as setconv_tpu does (the ball query
    # itself gives N - 1 there)
    (idx,) = ball_plain(xyz, new_xyz, [radius], [nsample], empty="first")
    h = torch.cat([index_points(xyz, idx) - new_xyz[:, :, None, :],
                   index_points(feats.float(), idx)], dim=-1)
    return _build.mlp_plain(h, layers).amax(dim=2)
