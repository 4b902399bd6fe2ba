"""One-shot attentive fusion: budgeted two-segment self-kNN + score MLP +
softmax over k + weighted residual sum.  The CUDA kernel
(csrc/fusion_knn.cu) and its plain PyTorch version.

Replaces ``pci_tpu/ops/pallas_kernels/fusion_knn_tpu.py:knn_fusion_attention``
(one-shot route, no payload).  The function is the exact XLA route of
``pci_tpu/nn/fusion.py:426-440``, not the TPU kernel's bucketed
approximation.
"""

from __future__ import annotations

import torch

from ..gather import index_points
from ..knn import knn
from . import _build

SCORE_MLP = (4, 64, 64, 128)  # the widths the kernel is built for


def safe_norm(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(sum(x*x) + 1e-12)`` over the last axis, kept (finite
    gradient at 0: a combined point's nearest neighbour is itself)."""
    return torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-12)


def knn_fusion_attention(combined: torch.Tensor, seg_ends: torch.Tensor,
                         budgets: torch.Tensor, layers, k: int) -> torch.Tensor:
    """Fuse each row of ``combined [B, N, 3]`` with its neighbours.

    Row ``n`` takes its exact ``budgets[b, 0]`` nearest rows in
    ``[0, seg_ends[b, 0])`` then its exact ``budgets[b, 1]`` nearest in
    ``[seg_ends[b, 0], N)`` (ties to the lower index; a segment shorter
    than its budget leaves zero residuals, a self-neighbour).  With
    ``resi = neighbour - row``: ``score = max_c MLP([resi | safe_norm])``,
    ``w = softmax_k(score)``, output ``row + sum_k w * resi``.

    ``seg_ends`` / ``budgets``: ``[B, 2]`` int, ``seg_ends[:, 1] == N``,
    budgets summing to ``k``; ``layers``: the folded score MLP
    (``4 -> 64 -> 64 -> 128``, ReLU after each layer).
    """
    _build.check_eval_only("knn_fusion_attention", combined,
                           *[t for wb in layers for t in wb])
    if _build.use_kernel(combined):
        return fusion_kernel(combined.float().contiguous(), seg_ends, budgets,
                             layers, k)
    return fusion_plain(combined, seg_ends, budgets, layers, k)


def fusion_kernel(combined, seg_ends, budgets, layers, k):
    dev = combined.device
    _build.require(combined, "combined", torch.float32, 3, dev)
    B, N, C = combined.shape
    if C != 3:
        raise ValueError("fusion kernel takes [B, N, 3] clouds")
    if k > 32:
        raise ValueError("fusion kernel: k <= 32 (one lane a slot)")
    if seg_ends.shape != (B, 2) or budgets.shape != (B, 2):
        raise ValueError("fusion kernel: two segments a batch row")
    wbuf, dims = _build.pack_layers(layers, dev)
    if tuple(dims) != SCORE_MLP:
        raise ValueError(f"fusion kernel is built for the {SCORE_MLP} score MLP, got {dims}")
    seg = torch.cat([seg_ends, budgets], dim=1).to(dev, torch.int32).contiguous()
    out = torch.empty_like(combined)
    err = _build.library().pci_fusion(
        combined.data_ptr(), seg.data_ptr(), wbuf.data_ptr(), *dims[1:],
        out.data_ptr(), B, N, _build.stream_ptr(dev),
    )
    _build.check_launch("fusion", err)
    fusion_kernel.launches += 1
    return out


fusion_kernel.launches = 0


def fusion_plain(combined, seg_ends, budgets, layers, k):
    B, N, _ = combined.shape
    combined = combined.float()
    outs = []
    for b, (ends, buds) in enumerate(zip(seg_ends.tolist(), budgets.tolist())):
        q = combined[b:b + 1]
        parts, start = [], 0
        for end, kk in zip(ends, buds):
            resi = q.new_zeros((1, N, kk, 3))
            n = min(kk, end - start)
            if n > 0:
                seg = q[:, start:end]
                _, idx = knn(q, seg, n)
                resi[:, :, :n] = index_points(seg, idx) - q[:, :, None, :]
            parts.append(resi)
            start = end
        resi = torch.cat(parts, dim=2)  # [1, N, k, 3]
        h = _build.mlp_plain(torch.cat([resi, safe_norm(resi)], -1), layers)
        w = torch.softmax(h.amax(dim=-1), dim=-1)[..., None]
        outs.append(q + (w * resi).sum(dim=2))
    return torch.cat(outs)
