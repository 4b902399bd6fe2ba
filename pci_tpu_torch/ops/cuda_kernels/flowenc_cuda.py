"""FlowNet3D's encoder in one launch: set_conv1 at given centres, greedy FPS
of set_conv2's centres, set_conv2 over ``[centres1 | f_1]``.  The CUDA
kernel (csrc/flowenc.cu) and its plain PyTorch version.

Replaces ``pci_tpu/ops/pallas_kernels/flowenc_tpu.py:flowenc_fused``.
"""

from __future__ import annotations

import torch

from ..gather import index_points
from . import _build
from .fps_cuda import fps_plain
from .setconv_cuda import setconv_plain


def flowenc_fused(xyz, feats, centres1, layers1, layers2, s2: int,
                  radius1: float, k1: int, radius2: float, k2: int):
    """set_conv1 + set_conv2 of FlowNet3D's encoder.

    ``xyz [B, N, 3]`` and ``feats [B, N, D]`` the cloud, ``centres1 [B, S1,
    3]`` set_conv1's centres (FPS of ``xyz``, outside); ``layers1`` /
    ``layers2`` the two folded MLPs (:func:`fold_bn_layers`); ``s2``
    set_conv2's centres, picked here by exact greedy FPS of ``centres1``
    from index 0.  Each set-conv is :func:`setconv_fused`'s ball group (the
    first ``k`` keys within the radius in index order) + MLP + max.

    Returns ``(f_1 [B, S1, C1], f_2 [B, S2, C2], centres2 [B, S2, 3])``
    fp32.
    """
    _build.check_eval_only("flowenc_fused", xyz, feats, centres1,
                           *[t for wb in list(layers1) + list(layers2) for t in wb])
    if _build.use_kernel(xyz):
        return flowenc_kernel(xyz.float().contiguous(), feats.float().contiguous(),
                              centres1.float().contiguous(), layers1, layers2, s2,
                              radius1, k1, radius2, k2)
    return flowenc_plain(xyz, feats, centres1, layers1, layers2, s2, radius1, k1,
                         radius2, k2)


def flowenc_kernel(xyz, feats, centres1, layers1, layers2, s2, radius1, k1,
                   radius2, k2):
    dev = xyz.device
    B, N, _ = xyz.shape
    S1, D = centres1.shape[1], feats.shape[-1]
    for name, t in (("xyz", xyz), ("feats", feats), ("centres1", centres1)):
        _build.require(t, name, torch.float32, 3, dev)
    if feats.shape[:2] != (B, N) or centres1.shape[0] != B:
        raise ValueError("flowenc: batch or point counts disagree")
    if S1 > 4096:
        raise ValueError("flowenc: the in-kernel FPS holds at most 4,096 centres")
    w1, dims1 = _build.pack_layers(layers1, dev)
    w2, dims2 = _build.pack_layers(layers2, dev)
    if not dims1 or dims1[0] != 3 + D or not dims2 or dims2[0] != 3 + dims1[-1]:
        raise ValueError(f"flowenc: MLP widths {dims1} / {dims2} do not take 3 + {D} "
                         "and 3 + set_conv1's channels")
    f1 = torch.empty((B, S1, dims1[-1]), dtype=torch.float32, device=dev)
    f2 = torch.empty((B, s2, dims2[-1]), dtype=torch.float32, device=dev)
    c2 = torch.empty((B, s2, 3), dtype=torch.float32, device=dev)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    err = _build.library().pci_flowenc(
        xyz.data_ptr(), feats.data_ptr(), centres1.data_ptr(),
        w1.data_ptr(), _build.int_array(dims1), len(dims1) - 1,
        w2.data_ptr(), _build.int_array(dims2), len(dims2) - 1,
        f1.data_ptr(), f2.data_ptr(), c2.data_ptr(), bar.data_ptr(),
        B, N, D, S1, s2, float(radius1) ** 2, k1, float(radius2) ** 2, k2,
        _build.stream_ptr(dev),
    )
    _build.check_launch("flowenc", err)
    flowenc_kernel.launches += 1
    return f1, f2, c2


flowenc_kernel.launches = 0


def flowenc_plain(xyz, feats, centres1, layers1, layers2, s2, radius1, k1,
                  radius2, k2):
    f1 = setconv_plain(xyz, feats, centres1, radius1, k1, layers1)
    start = torch.zeros(1, dtype=torch.long, device=xyz.device)
    c2 = index_points(centres1.float(), fps_plain(centres1, s2, start, 1))
    return f1, setconv_plain(centres1, f1, c2, radius2, k2, layers2), c2
