"""Fused kNN set-conv tail: exact kNN group + MLP1 + max + skip + MLP2, or
3-NN inverse-distance interpolation + skip + MLP2, the last ``n_final``
MLP2 layers linear.  The CUDA kernel (csrc/knnconv.cu, its MLPs on the
tensor cores in 3xTF32) and its plain PyTorch version.

Replaces ``pci_tpu/ops/pallas_kernels/knnconv_tpu.py:knnconv_fused``;
with ``n_final=1`` FlowNet3D's classifier rides the FeaturePropagation's
chain (its fused decode).
"""

from __future__ import annotations

import torch

from ..gather import index_points
from ..interpolate import three_nn_interpolate
from ..knn import knn
from . import _build


def knnconv_fused(q_xyz, k_xyz, k_feats, q_feats, skip_feats, k, mlp1, mlp2,
                  interp: bool = False, n_final: int = 0,
                  recip: str = "clamp") -> torch.Tensor:
    """Group each query's exact ``k`` nearest keys (ties to the lower
    index) and pool them, then MLP2 over ``[pooled | skip]``.

    Args:
      q_xyz ``[B, S, 3]`` queries; k_xyz ``[B, N, 3]`` keys;
      k_feats ``[B, N, D]``; q_feats ``[B, S, C1]`` or None (appended to
      every slot, FlowEmbedding); skip_feats ``[B, S, Cs]`` or None.
      mlp1 / mlp2: folded ``[(W, b), ...]`` chains, either may be empty;
      every layer ends in ReLU but the last ``n_final`` of MLP2.
      interp: pool by 3-NN inverse distance, with weights from distances
        recomputed off the chosen keys (needs ``k == 3``, ``mlp1 == []``
        and no q_feats).
      n_final: the trailing ``n_final`` MLP2 layers skip the ReLU (a
        linear regression head, such as FlowNet3D's classifier with its
        BatchNorm folded).
      recip: the interp weights, ``"clamp"`` ``1 / max(d, 1e-10)``
        (FlowNet3D) or ``"eps"`` ``1 / (d + 1e-8)`` (PointNet++).

    Returns ``[B, S, C_out]`` fp32.
    """
    if not 0 <= n_final <= len(mlp2):
        raise ValueError(f"knnconv_fused: n_final={n_final} of {len(mlp2)} MLP2 layers")
    if interp and (k != 3 or mlp1 or q_feats is not None):
        raise ValueError("knnconv_fused: interp mode is 3-NN with no MLP1 or q_feats")
    if recip not in ("clamp", "eps"):
        raise ValueError(f"knnconv_fused: unknown recip {recip!r}")
    _build.check_eval_only(
        "knnconv_fused", q_xyz, k_xyz, k_feats, q_feats, skip_feats,
        *[t for wb in list(mlp1) + list(mlp2) for t in wb])
    if _build.use_kernel(q_xyz):
        prep = lambda t: None if t is None else t.float().contiguous()  # noqa: E731
        return knnconv_kernel(prep(q_xyz), prep(k_xyz), prep(k_feats),
                              prep(q_feats), prep(skip_feats), k, mlp1, mlp2,
                              interp, recip, n_final)
    return knnconv_plain(q_xyz, k_xyz, k_feats, q_feats, skip_feats, k, mlp1,
                         mlp2, interp, recip, n_final)


def knnconv_kernel(q_xyz, k_xyz, k_feats, q_feats, skip_feats, k, mlp1, mlp2,
                   interp, recip, n_final=0):
    dev = q_xyz.device
    B, S, _ = q_xyz.shape
    N, D = k_xyz.shape[1], k_feats.shape[-1]
    C1 = q_feats.shape[-1] if q_feats is not None else 0
    Cs = skip_feats.shape[-1] if skip_feats is not None else 0
    named = (("q_xyz", q_xyz), ("k_xyz", k_xyz), ("k_feats", k_feats),
             ("q_feats", q_feats), ("skip_feats", skip_feats))
    for name, t in named:
        if t is not None:
            _build.require(t, name, torch.float32, 3, dev)
    if not 1 <= k <= N:
        raise ValueError(f"knnconv: k={k} needs 1 <= k <= N={N}")
    dims1, dims2 = _build.layer_widths(mlp1), _build.layer_widths(mlp2)
    c0 = 3 + D + C1
    cm = D if interp else (dims1[-1] if dims1 else c0)
    if dims1 and dims1[0] != c0 or dims2 and dims2[0] != cm + Cs:
        raise ValueError(f"knnconv: MLP widths {dims1} / {dims2} do not fit "
                         f"the {c0} grouped and {Cs} skip channels")
    # split for the tensor cores once per weight set (kept on PackedLayers)
    w1, w2 = _build.pack_tf32(mlp1, dev), _build.pack_tf32(mlp2, dev)
    c_out = dims2[-1] if dims2 else cm + Cs
    out = torch.empty((B, S, c_out), dtype=torch.float32, device=dev)
    null = 0
    err = _build.library().pci_knnconv(
        q_xyz.data_ptr(), k_xyz.data_ptr(), k_feats.data_ptr(),
        q_feats.data_ptr() if C1 else null,
        skip_feats.data_ptr() if Cs else null,
        w1.data_ptr() if w1.numel() else null, w2.data_ptr() if w2.numel() else null,
        _build.int_array(dims1 or [c0]), len(mlp1),
        _build.int_array(dims2 or [cm + Cs]), len(mlp2),
        out.data_ptr(), B, N, S, D, C1, Cs, k, int(interp), int(recip == "eps"),
        n_final, _build.stream_ptr(dev),
    )
    _build.check_launch("knnconv", err)
    knnconv_kernel.launches += 1
    return out


knnconv_kernel.launches = 0


def knnconv_plain(q_xyz, k_xyz, k_feats, q_feats, skip_feats, k, mlp1, mlp2,
                  interp, recip="clamp", n_final=0):
    if interp:
        h = three_nn_interpolate(q_xyz, k_xyz, k_feats.float(), recip)
    else:
        _, idx = knn(q_xyz, k_xyz, k)  # [B, S, k]
        parts = [index_points(k_xyz, idx) - q_xyz[:, :, None, :],
                 index_points(k_feats.float(), idx)]
        if q_feats is not None:
            parts.append(q_feats.float()[:, :, None, :].expand(-1, -1, k, -1))
        h = _build.mlp_plain(torch.cat(parts, dim=-1), mlp1).amax(dim=2)
    if skip_feats is not None:
        h = torch.cat([h, skip_feats.float()], dim=-1)
    return _build.mlp_plain(h, mlp2, n_final)
