"""The fusion's budgeted two-segment self-kNN by cell pruning, for large
clouds: the CUDA kernel (csrc/fusion_cells.cu) in two modes, one-shot
(the attention head inside: fused rows) and residual (idx and resi, with the
fixed-neighbour backward), and its plain PyTorch version.

Replaces ``pci_tpu/ops/pallas_kernels/fusion_cells_tpu.py``
(``knn_fusion_cells`` and ``knn_fusion_cells_grad``), the JAX package's
fusion route at N >= 32,768.  The TPU kernel is approximate (it scans the
16 best chunks and keeps two packed-key minima a bucket); this one computes
the exact function of ``fusion_knn_cuda`` (its neighbours, slot for slot)
and only skips chunks that cannot hold a neighbour.  The Morton sort, the
chunk boxes and the per-tile chunk order are made here with torch ops, as
the JAX package makes them with XLA ops outside its ``pallas_call``.
"""

from __future__ import annotations

import torch

from ..cells import box_lb, chunk_boxes, sort_by_morton
from . import _build
from .fusion_knn_cuda import SCORE_MLP, FusionResiKnn, fusion_plain, fusion_resi_plain

CHUNK = 256  # keys a chunk
TILE = 64  # sorted queries sharing one chunk order


def fusion_cells_attention(combined: torch.Tensor, seg_ends: torch.Tensor,
                           budgets: torch.Tensor, layers, k: int) -> torch.Tensor:
    """:func:`fusion_knn_cuda.knn_fusion_attention`'s function (two
    segments, ``seg_ends [B, 2]`` ending at N, ``budgets [B, 2]``), by the
    cell-pruned kernel on a CUDA tensor.  Eval only."""
    _build.check_eval_only("fusion_cells_attention", combined,
                           *[t for wb in layers for t in wb])
    if _build.use_kernel(combined):
        return fusion_cells_kernel(combined.float().contiguous(), seg_ends, budgets, k,
                                   layers)
    return fusion_cells_plain(combined, seg_ends, budgets, k, layers)


def fusion_cells_resi_knn(combined: torch.Tensor, seg_ends: torch.Tensor,
                          budgets: torch.Tensor, k: int):
    """:func:`fusion_knn_cuda.fusion_resi_knn`'s function for two segments
    -> ``(idx [B, N, k] int64, resi [B, N, k, 3])``, by the cell-pruned
    kernel on a CUDA tensor; ``resi`` is differentiable in ``combined``
    with the neighbours held fixed (the JAX package's ``_kfc_bwd``)."""
    return FusionResiKnn.apply(combined, seg_ends, budgets, k, fusion_cells_kernel)


def cells_plan(combined: torch.Tensor, split: torch.Tensor, chunk: int = CHUNK,
               tile: int = TILE):
    """The kernel's inputs besides the cloud: ``(keys [B, 3, Np] sorted,
    ids [B, Np] int32 original row of each sorted key (N for a pad),
    boxes [B, nc, 4, 4] = (lo A, hi A, lo B, hi B) of each chunk, xyz and a
    pad, order [B, nt, nc] int32 chunks by ascending tile bound, lbs
    [B, nt, nc] those bounds)``; segment A is rows ``[0, split[b])``."""
    B, N, _ = combined.shape
    pts, perm = sort_by_morton(combined, (-N) % chunk)
    in_range = perm < N
    is_a = (perm < split.to(perm.device, torch.int32)[:, None]) & in_range
    seg = torch.stack([is_a, in_range & ~is_a], dim=1)  # [B, 2, Np]: A, B
    lo, hi = chunk_boxes(pts[:, None], chunk, seg)  # [B, 2, nc, 3]
    qlo, qhi = chunk_boxes(pts, tile, in_range)
    lbs, order = torch.sort(box_lb(qlo[:, None], qhi[:, None], lo, hi).amin(dim=1), dim=-1)
    boxes = torch.nn.functional.pad(torch.stack([lo, hi], dim=2), (0, 1))  # [B, 2, 2, nc, 4]
    boxes = boxes.permute(0, 3, 1, 2, 4).contiguous().reshape(B, -1, 4, 4)
    return pts.transpose(1, 2).contiguous(), perm, boxes, order.to(torch.int32), lbs


def fusion_cells_kernel(combined, seg_ends, budgets, k, layers=None, scanned=None):
    """One launch: one-shot with ``layers`` (the folded score MLP), else
    residual.  ``scanned``: an int64 ``[1]`` CUDA tensor that gains the
    number of (query, key) pairs the kernel scanned."""
    dev = combined.device
    _build.require(combined, "combined", torch.float32, 3, dev)
    B, N, C = combined.shape
    if C != 3:
        raise ValueError("fusion_cells kernel takes [B, N, 3] clouds")
    if not 1 <= k <= 32:
        raise ValueError("fusion_cells kernel: k <= 32 (one lane a slot)")
    if seg_ends.shape != (B, 2) or budgets.shape != (B, 2):
        raise ValueError("fusion_cells kernel: two segments a batch row")
    if scanned is not None:
        _build.require(scanned, "scanned", torch.int64, 1, dev)
    seg = torch.cat([seg_ends, budgets], dim=1).to(dev, torch.int32).contiguous()
    plan = cells_plan(combined, seg[:, 0])
    if not all(t.is_contiguous() for t in plan):
        raise ValueError("fusion_cells kernel: the plan's tensors must be contiguous")
    keys, ids, boxes, order, lbs = plan
    Np = keys.shape[-1]
    null = 0
    ptr = lambda t: t.data_ptr() if t is not None else null  # noqa: E731
    if layers is not None:
        wbuf, dims = _build.pack_layers(layers, dev)
        if tuple(dims) != SCORE_MLP:
            raise ValueError(f"fusion_cells kernel is built for the {SCORE_MLP} score MLP, "
                             f"got {dims}")
        out, out_i, out_r = torch.empty_like(combined), None, None
    else:
        wbuf, dims = None, [4, 0, 0, 0]
        out = None
        out_i = torch.empty((B, N, k), dtype=torch.int64, device=dev)
        out_r = torch.empty((B, N, k, 3), dtype=torch.float32, device=dev)
    err = _build.library().pci_fusion_cells(
        combined.data_ptr(), keys.data_ptr(), ids.data_ptr(), boxes.data_ptr(),
        order.data_ptr(), lbs.data_ptr(), seg.data_ptr(), ptr(wbuf), *dims[1:],
        ptr(out), ptr(out_i), ptr(out_r), ptr(scanned), B, N, Np, CHUNK, TILE, k,
        _build.stream_ptr(dev),
    )
    _build.check_launch("fusion_cells", err)
    fusion_cells_kernel.launches += 1
    return out if layers is not None else (out_i, out_r)


fusion_cells_kernel.launches = 0


def fusion_cells_plain(combined, seg_ends, budgets, k, layers=None):
    """The kernel's signature and function.  It computes through the flat
    plain versions (:func:`fusion_knn_cuda.fusion_plain` with ``layers``,
    :func:`fusion_knn_cuda.fusion_resi_plain` without), since pruning
    changes which pairs are scanned, not the neighbours."""
    if layers is not None:
        return fusion_plain(combined, seg_ends, budgets, layers, k)
    return fusion_resi_plain(combined, seg_ends, budgets, k)
