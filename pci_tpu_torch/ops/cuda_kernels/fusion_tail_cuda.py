"""The fusion's attention head over given residuals: score MLP, max over
channels, softmax over the k slots, weighted residual (and payload) sum.
The CUDA kernel (csrc/fusion_tail.cu) and its plain PyTorch version.

Replaces ``pci_tpu/ops/pallas_kernels/fusion_tail_tpu.py:fusion_attention_tail``
(PointsFusion at eval with the one-shot kernel off, after the residual
kNN ``fusion_resi_knn``).  The kernel runs the one-shot kernels' head
(csrc/fusion_head.cuh) on the tensor cores in 3xTF32, from the score MLP
split by ``_build.pack_tf32(..., chain=True)``, in persistent blocks that
prefetch each warp's next row; any k past 64 streams each row's slots 32
at a time through an online softmax, with a payload of at most
``MAX_PAYLOAD`` channels there.
"""

from __future__ import annotations

import torch

from . import _build
from .fusion_knn_cuda import MAX_PAYLOAD, PAIR_K, SCORE_MLP, fusion_head


def fusion_attention_tail(combined: torch.Tensor, resi: torch.Tensor,
                          extra: torch.Tensor | None, layers) -> torch.Tensor:
    """``combined [B, N, 3]``, residuals ``resi [B, N, k, 3]`` (neighbour -
    row), an optional payload ``extra [B, N, k, Ce]`` and the folded score
    MLP ``layers`` (``4 -> 64 -> 64 -> 128``, ReLU each) -> ``[B, N, 3 +
    Ce]``: ``w = softmax_k(max_c MLP([resi | safe_norm(resi)]))``, then
    ``[combined + sum_k w * resi, sum_k w * extra]``."""
    _build.check_eval_only("fusion_attention_tail", combined, resi, extra,
                           *[t for wb in layers for t in wb])
    if _build.use_kernel(combined):
        f = lambda t: None if t is None else t.float().contiguous()  # noqa: E731
        return fusion_tail_kernel(f(combined), f(resi), f(extra), layers)
    return fusion_tail_plain(combined, resi, extra, layers)


def fusion_tail_kernel(combined, resi, extra, layers):
    dev = combined.device
    _build.require(combined, "combined", torch.float32, 3, dev)
    _build.require(resi, "resi", torch.float32, 4, dev)
    B, N, C = combined.shape
    k = resi.shape[2]
    if C != 3 or resi.shape != (B, N, k, 3) or k < 1:
        raise ValueError("fusion_tail kernel: [B, N, 3] rows, [B, N, k >= 1, 3] residuals")
    Ce = 0
    if extra is not None:
        _build.require(extra, "extra", torch.float32, 4, dev)
        if extra.shape[:3] != (B, N, k):
            raise ValueError("fusion_tail kernel: extra is [B, N, k, Ce]")
        Ce = extra.shape[3]
        if k > PAIR_K and Ce > MAX_PAYLOAD:
            raise ValueError(f"fusion_tail kernel: past k = {PAIR_K} a payload of at most "
                             f"{MAX_PAYLOAD} channels")
    dims = tuple(_build.layer_widths(layers))
    if dims != SCORE_MLP:
        raise ValueError(f"fusion_tail kernel is built for the {SCORE_MLP} score MLP, got {dims}")
    wtc = _build.pack_tf32(layers, dev, chain=True)
    out = torch.empty((B, N, 3 + Ce), dtype=torch.float32, device=dev)
    err = _build.library().pci_fusion_tail(
        combined.data_ptr(), resi.data_ptr(), extra.data_ptr() if Ce else 0,
        wtc.data_ptr(), *dims[1:], out.data_ptr(), B, N, k, Ce,
        _build.stream_ptr(dev),
    )
    _build.check_launch("fusion_tail", err)
    fusion_tail_kernel.launches += 1
    return out


fusion_tail_kernel.launches = 0


def fusion_tail_plain(combined, resi, extra, layers):
    return fusion_head(combined.float(), resi.float(),
                       lambda h: _build.mlp_plain(h, layers),
                       None if extra is None else extra.float())
