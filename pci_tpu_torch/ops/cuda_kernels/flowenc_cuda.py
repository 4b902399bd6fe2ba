"""FlowNet3D's encoder in one launch: set_conv1 at given centres, greedy FPS
of set_conv2's centres, set_conv2 over ``[centres1 | f_1]``.  The CUDA
kernel (csrc/flowenc.cu, its MLPs on the tensor cores in 3xTF32) and its
plain PyTorch version.

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
                   radius2, k2, stamps=None):
    """The launch; ``stamps`` (a measurement launch only): a zeroed int64
    tensor of ``FLOWENC_STAMPS`` entries for each block the grid may hold,
    which gets each block's stage stamps (:func:`flowenc_stages`)."""
    dev = xyz.device
    B, N, _ = xyz.shape
    S1, D = centres1.shape[1], feats.shape[-1]
    for name, t in (("xyz", xyz), ("feats", feats), ("centres1", centres1)):
        _build.require(t, name, torch.float32, 3, dev)
    if feats.shape[:2] != (B, N) or centres1.shape[0] != B:
        raise ValueError("flowenc: batch or point counts disagree")
    if S1 > 1024:
        raise ValueError("flowenc: the in-kernel FPS (one warp) holds at most 1,024 centres")
    dims1, dims2 = _build.layer_widths(layers1), _build.layer_widths(layers2)
    if not dims1 or dims1[0] != 3 + D or not dims2 or dims2[0] != 3 + dims1[-1]:
        raise ValueError(f"flowenc: MLP widths {dims1} / {dims2} do not take 3 + {D} "
                         "and 3 + set_conv1's channels")
    # split for the tensor cores once per weight set (kept on PackedLayers)
    w1, w2 = _build.pack_tf32(layers1, dev), _build.pack_tf32(layers2, dev)
    f1 = torch.empty((B, S1, dims1[-1]), dtype=torch.float32, device=dev)
    f2 = torch.empty((B, s2, dims2[-1]), dtype=torch.float32, device=dev)
    c2 = torch.empty((B, s2, 3), dtype=torch.float32, device=dev)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    err = _build.library().pci_flowenc(
        xyz.data_ptr(), feats.data_ptr(), centres1.data_ptr(),
        w1.data_ptr(), _build.int_array(dims1), len(dims1) - 1,
        w2.data_ptr(), _build.int_array(dims2), len(dims2) - 1,
        f1.data_ptr(), f2.data_ptr(), c2.data_ptr(), bar.data_ptr(),
        stamps.data_ptr() if stamps is not None else 0, B, N, D, S1, s2, float(radius1) ** 2, k1, float(radius2) ** 2, k2,
        _build.stream_ptr(dev),
    )
    _build.check_launch("flowenc", err)
    flowenc_kernel.launches += 1
    return f1, f2, c2


flowenc_kernel.launches = 0
FLOWENC_STAMPS = 5  # csrc/flowenc.cu: start, FPS done, at the barrier, released, end


def flowenc_stages(*args):
    """One measurement launch of :func:`flowenc_fused`'s kernel on CUDA
    inputs ``args`` (its arguments) with the stage stamps on: the
    milliseconds of the FPS chain (the longest FPS block), set_conv1's
    tiles (the busiest block), stage 1 (launch to the last arrival at the
    grid barrier), set_conv2's tiles (the busiest block) and the whole
    kernel, from each block's ``%globaltimer`` stamps."""
    dev = args[0].device
    # the most blocks of 256 threads the card holds at once (8 an SM)
    blocks = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    stamps = torch.zeros((blocks, FLOWENC_STAMPS), dtype=torch.int64, device=dev)
    xyz, feats, c1, *rest = args
    flowenc_kernel(xyz.float().contiguous(), feats.float().contiguous(),
                   c1.float().contiguous(), *rest, stamps=stamps)
    t = stamps.cpu()
    t = t[t[:, 0] > 0]  # the grid's blocks
    t = (t - t[:, 0].min()).double() * 1e-6
    n_fps = xyz.shape[0]
    return {"fps": float((t[:n_fps, 1] - t[:n_fps, 0]).max()),
            "set_conv1": float((t[:, 2] - t[:, 1]).max()),
            "stage1": float(t[:, 2].max()),
            "set_conv2": float((t[:, 4] - t[:, 3]).max()),
            "kernel": float(t[:, 4].max())}


def flowenc_plain(xyz, feats, centres1, layers1, layers2, s2, radius1, k1,
                  radius2, k2):
    f1 = setconv_plain(xyz, feats, centres1, radius1, k1, layers1)
    start = torch.zeros(1, dtype=torch.long, device=xyz.device)
    c2 = index_points(centres1.float(), fps_plain(centres1, s2, start, 1))
    return f1, setconv_plain(centres1, f1, c2, radius2, k2, layers2), c2
