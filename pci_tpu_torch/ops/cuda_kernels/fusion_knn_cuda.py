"""The fusion's budgeted self-kNN, two kernels in csrc/fusion_knn.cu, each
beside its plain PyTorch version.

- One-shot attentive fusion (eval): budgeted two-segment self-kNN + score
  MLP + softmax over k + weighted residual sum.  Replaces
  ``pci_tpu/ops/pallas_kernels/fusion_knn_tpu.py:knn_fusion_attention``
  (one-shot route, no payload).
- Residual kNN (training): the budgeted F-segment self-kNN's indices and
  residuals, differentiable in the cloud with fixed neighbours.  Replaces
  the same file's ``knn_fusion_adaptive`` / ``knn_fusion_multi``
  (``_fusion_core`` and its custom VJP).

Both compute the exact XLA route of ``pci_tpu/nn/fusion.py:426-440``
(``knn_prefix`` per segment + ``_prefix_merge`` / ``_budget_compact``), not
the TPU kernels' bucketed approximation.
"""

from __future__ import annotations

import torch

from ..gather import index_points, scatter_add_rows
from . import _build
from .knn_cuda import knn_plain

MAX_SEGMENTS = 4  # the residual kernel keeps one top list a segment

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
    """The residual kNN's plain version, then :func:`fusion_head`."""
    combined = combined.float()
    _, resi = fusion_resi_plain(combined, seg_ends, budgets, k)
    return fusion_head(combined, resi, lambda h: _build.mlp_plain(h, layers))


def fusion_head(combined, resi, score):
    """The attention head over given residuals ``resi [B, N, k, 3]``:
    ``s = max_c score([resi | safe_norm(resi)])`` with ``score`` the
    per-slot MLP, ``w = softmax_k(s)``, ``combined + sum_k w * resi``."""
    h = score(torch.cat([resi, safe_norm(resi)], -1))
    w = torch.softmax(h.amax(dim=-1), dim=-1)[..., None]
    return combined + (w * resi).sum(dim=2)


def fusion_resi_knn(combined: torch.Tensor, seg_ends: torch.Tensor,
                    budgets: torch.Tensor, k: int):
    """Budgeted F-segment self-kNN of ``combined [B, N, 3]``.

    Row ``n`` takes, for each segment ``j`` (rows ``[seg_ends[b, j-1],
    seg_ends[b, j])``), its exact ``budgets[b, j]`` nearest rows there,
    blocks in segment order, ties to the lower index; a slot its segment
    cannot fill (fewer rows than budget) holds the row itself.

    ``seg_ends`` / ``budgets``: ``[B, F]`` int, ``F <= 4``, the last end
    ``N``, budgets summing to ``k <= 32``.  Returns ``(idx [B, N, k]``
    int64, ``resi [B, N, k, 3]`` = neighbour - row``)``.  ``resi`` is
    differentiable in ``combined`` with the neighbours held fixed:
    ``d combined = scatter_add(idx, d resi) - sum_k d resi``, the JAX
    package's ``_fusion_core_bwd``.
    """
    return _FusionResiKnn.apply(combined, seg_ends, budgets, k)


class _FusionResiKnn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, combined, seg_ends, budgets, k):
        if _build.use_kernel(combined):
            idx, resi = fusion_resi_kernel(combined.detach().float().contiguous(),
                                           seg_ends, budgets, k)
        else:
            idx, resi = fusion_resi_plain(combined, seg_ends, budgets, k)
        ctx.save_for_backward(idx)
        ctx.mark_non_differentiable(idx)
        return idx, resi

    @staticmethod
    def backward(ctx, g_idx, g_resi):
        (idx,) = ctx.saved_tensors
        B, N, k = idx.shape
        g_comb = scatter_add_rows(idx.reshape(B, N * k), g_resi.reshape(B, N * k, 3), N)
        return g_comb - g_resi.sum(2), None, None, None


def fusion_resi_kernel(combined, seg_ends, budgets, k):
    dev = combined.device
    _build.require(combined, "combined", torch.float32, 3, dev)
    B, N, C = combined.shape
    F = seg_ends.shape[-1]
    if C != 3:
        raise ValueError("fusion_resi kernel takes [B, N, 3] clouds")
    if seg_ends.shape != (B, F) or budgets.shape != (B, F) or not 1 <= F <= MAX_SEGMENTS:
        raise ValueError(f"fusion_resi kernel: [B, F] segment ends and budgets, "
                         f"1 <= F <= {MAX_SEGMENTS}")
    if not 1 <= k <= 32:
        raise ValueError("fusion_resi kernel: k <= 32 (one lane a slot)")
    ends = seg_ends.to(dev, torch.int32).contiguous()
    buds = budgets.to(dev, torch.int32).contiguous()
    idx = torch.empty((B, N, k), dtype=torch.int64, device=dev)
    resi = torch.empty((B, N, k, 3), dtype=torch.float32, device=dev)
    err = _build.library().pci_fusion_resi(
        combined.data_ptr(), ends.data_ptr(), buds.data_ptr(), F,
        idx.data_ptr(), resi.data_ptr(), B, N, k, _build.stream_ptr(dev),
    )
    _build.check_launch("fusion_resi", err)
    fusion_resi_kernel.launches += 1
    return idx, resi


fusion_resi_kernel.launches = 0


def fusion_resi_plain(combined, seg_ends, budgets, k):
    """Per batch row and segment, the exact kNN of every row into the
    segment's rows (the plain kNN, chunked over queries), then the blocks
    compacted in segment order."""
    combined = combined.detach().float()
    B, N, _ = combined.shape
    own = torch.arange(N, device=combined.device)[None, :, None]
    rows = []
    for b, (ends, buds) in enumerate(zip(seg_ends.tolist(), budgets.tolist())):
        q = combined[b:b + 1]
        parts, start, used = [], 0, 0
        for end, kk in zip(ends, buds):
            kk = max(0, min(kk, k - used))
            block = own.expand(1, N, kk).clone()  # unfilled: the row itself
            n = min(kk, end - start)
            if n > 0:
                _, i = knn_plain(q, q[:, start:end], n)
                block[..., :n] = i + start
            parts.append(block)
            start, used = max(start, end), used + kk
        parts.append(own.expand(1, N, k - used))
        rows.append(torch.cat(parts, dim=2))
    idx = torch.cat(rows)
    return idx, index_points(combined, idx) - combined[:, :, None, :]
