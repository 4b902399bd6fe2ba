"""The fusion's budgeted self-kNN, two kernels in csrc/fusion_knn.cu, each
beside its plain PyTorch version.

- One-shot attentive fusion (eval): budgeted two-segment self-kNN + score
  MLP + softmax over k + weighted residual sum, and the weighted sum of a
  payload (``PointsFusionWithFeatures``' intensity) of up to
  ``MAX_PAYLOAD`` channels.  Replaces
  ``pci_tpu/ops/pallas_kernels/fusion_knn_tpu.py:knn_fusion_attention``
  (one-shot route, with or without a payload).  Persistent blocks, one an
  SM, keep the score MLP split for the tensor cores (3xTF32,
  ``_build.pack_tf32(..., chain=True)``) in shared memory; a warp a query
  scans the keys through cp.async double-buffered tiles, then runs its
  head on ``mma.sync`` and its payload sums.
- Residual kNN (training): the budgeted F-segment self-kNN's indices and
  residuals, differentiable in the cloud with fixed neighbours.  Replaces
  the same file's ``knn_fusion_adaptive`` / ``knn_fusion_multi``
  (``_fusion_core`` and its custom VJP).  One thread a query over keys
  broadcast from shared memory, the segments one after another, each
  segment's keys split over 1, 2 or 4 parts whose lists are merged.

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
# the flat fusion kernels' slots a query: one lane a slot up to 32, two a
# lane up to 64, four up to 128 (each kernel's k <= 64 instantiation and its
# k <= 128 kernel, chosen by k at launch)
MAX_KERNEL_K = 128
PAIR_K = 64  # the k <= 64 instantiations' slots (and the cell-pruned kernels' limit)
LANE_K = 32  # the k <= 32 instantiations' slots
MAX_PAYLOAD = 8  # payload channels the one-shot kernels carry (csrc/fusion_head.cuh PAYLOAD_MAX)
RESI_ITEM = 64  # queries a residual kernel item (csrc/fusion_knn.cu RES_Q)
RESI_STAMPS = 6  # int64 an item's stamp row (RES_STAMPS)

SCORE_MLP = (4, 64, 64, 128)  # the widths the kernel is built for


def safe_norm(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(sum(x*x) + 1e-12)`` over the last axis, kept (finite
    gradient at 0: a combined point's nearest neighbour is itself)."""
    return torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-12)


def knn_fusion_attention(combined: torch.Tensor, seg_ends: torch.Tensor,
                         budgets: torch.Tensor, layers, k: int,
                         payload: torch.Tensor | None = None) -> torch.Tensor:
    """Fuse each row of ``combined [B, N, 3]`` with its neighbours.

    Row ``n`` takes its exact ``budgets[b, 0]`` nearest rows in
    ``[0, seg_ends[b, 0])`` then its exact ``budgets[b, 1]`` nearest in
    ``[seg_ends[b, 0], N)`` (ties to the lower index; a segment shorter
    than its budget leaves zero residuals, a self-neighbour).  With
    ``resi = neighbour - row``: ``score = max_c MLP([resi | safe_norm])``,
    ``w = softmax_k(score)``, output ``row + sum_k w * resi``, and for a
    ``payload [B, N, Cp]`` (``Cp <= MAX_PAYLOAD`` on the card) ``sum_k w *
    payload[neighbour]`` appended (a self-neighbour carries the row's own),
    so ``[B, N, 3 + Cp]``.

    ``seg_ends`` / ``budgets``: ``[B, 2]`` int, ``seg_ends[:, 1] == N``,
    budgets summing to ``k``; ``layers``: the folded score MLP
    (``4 -> 64 -> 64 -> 128``, ReLU after each layer).
    """
    _build.check_eval_only("knn_fusion_attention", combined, payload,
                           *[t for wb in layers for t in wb])
    if _build.use_kernel(combined):
        return fusion_kernel(combined.float().contiguous(), seg_ends, budgets,
                             layers, k, as_payload(payload))
    return fusion_plain(combined, seg_ends, budgets, layers, k, payload)


def as_payload(payload):
    """A payload as the one-shot kernels take it: fp32, contiguous."""
    return None if payload is None else payload.float().contiguous()


def payload_channels(payload, combined, name: str) -> int:
    """``Cp`` of a one-shot kernel's ``payload [B, N, Cp]`` (0 for None),
    checked against ``combined [B, N, 3]`` and ``MAX_PAYLOAD``."""
    if payload is None:
        return 0
    _build.require(payload, "payload", torch.float32, 3, combined.device)
    if payload.shape[:2] != combined.shape[:2]:
        raise ValueError(f"{name} kernel: payload is [B, N, Cp], got {tuple(payload.shape)}")
    if payload.shape[2] > MAX_PAYLOAD:
        raise ValueError(f"{name} kernel: a payload of at most {MAX_PAYLOAD} channels")
    return payload.shape[2]


def fusion_kernel(combined, seg_ends, budgets, layers, k, payload=None):
    """One launch of the one-shot kernel: ``pci_fusion`` at k <= 32,
    ``pci_fusion64`` at k <= 64, ``pci_fusion128`` above."""
    dev = combined.device
    _build.require(combined, "combined", torch.float32, 3, dev)
    B, N, C = combined.shape
    if C != 3:
        raise ValueError("fusion kernel takes [B, N, 3] clouds")
    if not 1 <= k <= MAX_KERNEL_K:
        raise ValueError(f"fusion kernel: k <= {MAX_KERNEL_K} (four slots a lane at most)")
    if seg_ends.shape != (B, 2) or budgets.shape != (B, 2):
        raise ValueError("fusion kernel: two segments a batch row")
    Cp = payload_channels(payload, combined, "fusion")
    dims = tuple([layers[0][0].shape[1]] + [w.shape[0] for w, _ in layers]) if layers else ()
    if dims != SCORE_MLP:
        raise ValueError(f"fusion kernel is built for the {SCORE_MLP} score MLP, got {dims}")
    wtc = _build.pack_tf32(layers, dev, chain=True)
    seg = torch.cat([seg_ends, budgets], dim=1).to(dev, torch.int32).contiguous()
    out = torch.empty((B, N, 3 + Cp), dtype=torch.float32, device=dev)
    lib = _build.library()
    entry = (lib.pci_fusion if k <= LANE_K else lib.pci_fusion64 if k <= PAIR_K
             else lib.pci_fusion128)
    err = entry(
        combined.data_ptr(), seg.data_ptr(), wtc.data_ptr(), *dims[1:],
        payload.data_ptr() if Cp else None, Cp, out.data_ptr(), B, N,
        _build.stream_ptr(dev),
    )
    _build.check_launch("fusion", err)
    fusion_kernel.launches += 1
    return out


fusion_kernel.launches = 0


def fusion_plain(combined, seg_ends, budgets, layers, k, payload=None):
    """The residual kNN's plain version, then :func:`fusion_head`, with
    the payload gathered by the same indices (a self-neighbour's slot holds
    the row itself, so it carries the row's own payload)."""
    combined = combined.float()
    idx, resi = fusion_resi_plain(combined, seg_ends, budgets, k)
    extra = None if payload is None else index_points(payload.float(), idx)
    return fusion_head(combined, resi, lambda h: _build.mlp_plain(h, layers), extra)


def fusion_head(combined, resi, score, extra=None):
    """The attention head over given residuals ``resi [B, N, k, 3]``:
    ``s = max_c score([resi | safe_norm(resi)])`` with ``score`` the
    per-slot MLP, ``w = softmax_k(s)``, ``combined + sum_k w * resi``, and
    ``sum_k w * extra`` appended for a payload ``extra [B, N, k, Ce]``."""
    h = score(torch.cat([resi, safe_norm(resi)], -1))
    w = torch.softmax(h.amax(dim=-1), dim=-1)[..., None]
    fused = combined + (w * resi).sum(dim=2)
    if extra is None:
        return fused
    return torch.cat([fused, (w * extra).sum(dim=2)], dim=-1)


def fusion_resi_knn(combined: torch.Tensor, seg_ends: torch.Tensor,
                    budgets: torch.Tensor, k: int):
    """Budgeted F-segment self-kNN of ``combined [B, N, 3]``.

    Row ``n`` takes, for each segment ``j`` (rows ``[seg_ends[b, j-1],
    seg_ends[b, j])``), its exact ``budgets[b, j]`` nearest rows there,
    blocks in segment order, ties to the lower index; a slot its segment
    cannot fill (fewer rows than budget) holds the row itself.

    ``seg_ends`` / ``budgets``: ``[B, F]`` int, ``F <= 4``, the last end
    ``N``, budgets summing to ``k <= 128``.  Returns ``(idx [B, N, k]``
    int64, ``resi [B, N, k, 3]`` = neighbour - row``)``.  ``resi`` is
    differentiable in ``combined`` with the neighbours held fixed:
    ``d combined = scatter_add(idx, d resi) - sum_k d resi``, the JAX
    package's ``_fusion_core_bwd``.
    """
    return FusionResiKnn.apply(combined, seg_ends, budgets, k, fusion_resi_kernel)


class FusionResiKnn(torch.autograd.Function):
    """The budgeted self-kNN's residuals with the fixed-neighbour backward;
    ``kernel(combined, seg_ends, budgets, k) -> (idx, resi)`` computes the
    forward on a CUDA tensor (the flat kernel, or the cell-pruned one of
    ``fusion_cells_cuda``, which gives the same neighbours)."""

    @staticmethod
    def forward(ctx, combined, seg_ends, budgets, k, kernel):
        if _build.use_kernel(combined):
            idx, resi = kernel(combined.detach().float().contiguous(), seg_ends, budgets, k)
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
        return g_comb - g_resi.sum(2), None, None, None, None


def fusion_resi_kernel(combined, seg_ends, budgets, k, parts: int = 0, stamps=None):
    """One launch of csrc/fusion_knn.cu's residual kernel.  ``parts``: the
    key ranges a segment is split over (1, 2 or 4; 0 lets the kernel choose
    by the query count); ``stamps``: a zeroed int64 ``[B * ceil(N / 64),
    RESI_STAMPS]`` CUDA tensor that takes each 64-query item's start and end
    (``%globaltimer`` ns), its scan, merge and write ns, and its list
    inserts (measurement only).  k > 64 runs the warp-a-query kernel,
    which takes neither."""
    dev = combined.device
    _build.require(combined, "combined", torch.float32, 3, dev)
    B, N, C = combined.shape
    F = seg_ends.shape[-1]
    if C != 3:
        raise ValueError("fusion_resi kernel takes [B, N, 3] clouds")
    if seg_ends.shape != (B, F) or budgets.shape != (B, F) or not 1 <= F <= MAX_SEGMENTS:
        raise ValueError(f"fusion_resi kernel: [B, F] segment ends and budgets, "
                         f"1 <= F <= {MAX_SEGMENTS}")
    if not 1 <= k <= MAX_KERNEL_K:
        raise ValueError(f"fusion_resi kernel: k <= {MAX_KERNEL_K} (a list of at most "
                         f"{MAX_KERNEL_K} a segment)")
    if parts not in (0, 1, 2, 4):
        raise ValueError(f"fusion_resi kernel: parts {parts} not in 0, 1, 2, 4")
    if k > PAIR_K and (parts or stamps is not None):
        raise ValueError(f"fusion_resi kernel: no parts or stamps past k = {PAIR_K}")
    if stamps is not None:
        _build.require(stamps, "stamps", torch.int64, 2, dev)
        if stamps.shape != (B * -(-N // RESI_ITEM), RESI_STAMPS):
            raise ValueError(f"fusion_resi stamps: {(B * -(-N // RESI_ITEM), RESI_STAMPS)}")
    ends = seg_ends.to(dev, torch.int32).contiguous()
    buds = budgets.to(dev, torch.int32).contiguous()
    idx = torch.empty((B, N, k), dtype=torch.int64, device=dev)
    resi = torch.empty((B, N, k, 3), dtype=torch.float32, device=dev)
    err = _build.library().pci_fusion_resi(
        combined.data_ptr(), ends.data_ptr(), buds.data_ptr(), F,
        idx.data_ptr(), resi.data_ptr(), B, N, k, parts,
        stamps.data_ptr() if stamps is not None else None, _build.stream_ptr(dev),
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
