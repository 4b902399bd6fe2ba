"""The fusion's budgeted two-segment self-kNN by cell pruning, for large
clouds: the CUDA kernel (csrc/fusion_cells.cu) in two modes, one-shot
(the attention head inside: fused rows, with a payload's weighted sums)
and residual (idx and resi, with the fixed-neighbour backward), and its
plain PyTorch version.

Replaces ``pci_tpu/ops/pallas_kernels/fusion_cells_tpu.py``
(``knn_fusion_cells`` and ``knn_fusion_cells_grad``), the JAX package's
fusion route at N >= 32,768.  The TPU kernel is approximate (it scans the
16 best chunks and keeps two packed-key minima a bucket); this one computes
the exact function of ``fusion_knn_cuda`` (its neighbours, slot for slot)
and only skips chunks that cannot hold a neighbour.  The Morton sort, the
chunk boxes and the per-tile chunk order are made here with torch ops, as
the JAX package makes them with XLA ops outside its ``pallas_call``; on the
card they replay from a CUDA graph captured once per shape
(:func:`kernel_plan_graphed`).  k <= 64: the kernel's k <= 32 and k <= 64
instantiations, chosen by k at launch.

:func:`fusion_cells_multi_knn` is the F-segment residual kNN at large N
(``pci_tpu/nn/fusion.py:_cells_fusion_knn``'s two-pass branch, whose TPU
kernel is ``knn_cells``): one masked pass of the box-pruned kNN
(``knn_cuda``'s segment form, row 10) a segment, each writing its budget
straight into its slots of one ``[B, N, k]`` block.
"""

from __future__ import annotations

import collections

import torch

from ..cells import box_lb, chunk_boxes, sort_by_morton
from . import _build, knn_cuda
from .fusion_knn_cuda import (
    PAIR_K,
    SCORE_MLP,
    FusionResiKnn,
    as_payload,
    fusion_plain,
    fusion_resi_plain,
    payload_channels,
)

CHUNK = 256  # keys a chunk
TILE = 64  # sorted queries sharing one chunk order (two warps of the kernel)
# a tile's stamps: start, walk end, end (%globaltimer ns), chunks walked, pairs
# scanned, list inserts, warp-chunks scanned lane by lane, and needer by needer
STAMPS = 8
# (device, shape) -> the prep's CUDA graph, its inputs and its plan, the most
# recently used last; at most PLAN_GRAPHS shapes keep their graph
_PLAN_GRAPHS: collections.OrderedDict = collections.OrderedDict()
PLAN_GRAPHS = 4


def fusion_cells_attention(combined: torch.Tensor, seg_ends: torch.Tensor,
                           budgets: torch.Tensor, layers, k: int,
                           payload: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`fusion_knn_cuda.knn_fusion_attention`'s function (two
    segments, ``seg_ends [B, 2]`` ending at N, ``budgets [B, 2]``, an
    optional ``payload [B, N, Cp]``), by the cell-pruned kernel on a CUDA
    tensor.  Eval only."""
    _build.check_eval_only("fusion_cells_attention", combined, payload,
                           *[t for wb in layers for t in wb])
    if _build.use_kernel(combined):
        return fusion_cells_kernel(combined.float().contiguous(), seg_ends, budgets, k,
                                   layers, payload=as_payload(payload))
    return fusion_cells_plain(combined, seg_ends, budgets, k, layers, payload)


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
    pad, order [B, nt, nc] int32 chunks by ascending tile bound (for the
    chunks of bound 0 a key below 0: the tile's own chunk first, then by
    distance from it in the sorted order), lbs [B, nt, nc] those sort
    keys)``; segment A is rows ``[0, split[b])``."""
    B, N, _ = combined.shape
    pts, perm = sort_by_morton(combined, (-N) % chunk)
    in_range = perm < N
    is_a = (perm < split.to(perm.device, torch.int32)[:, None]) & in_range
    seg = torch.stack([is_a, in_range & ~is_a], dim=1)  # [B, 2, Np]: A, B
    lo, hi = chunk_boxes(pts[:, None], chunk, seg)  # [B, 2, nc, 3]
    qlo, qhi = chunk_boxes(pts, tile, in_range)
    lb = box_lb(qlo[:, None], qhi[:, None], lo, hi).amin(dim=1)  # [B, nt, nc]
    # the chunks of bound 0 nearest first: a key below 0 by their distance in
    # the sorted order from the tile's own chunk, so a query's lists fill
    # from its nearest keys and later keys rarely enter (inserts, not scans,
    # cost the kernel)
    nt, nc = lb.shape[1:]
    own = torch.arange(nt, device=lb.device)[:, None] * tile // chunk
    gap = (torch.arange(nc, device=lb.device)[None, :] - own).abs().float()
    lbs, order = torch.sort(torch.where(lb > 0, lb, -1.0 / (1.0 + gap)), dim=-1)
    boxes = torch.nn.functional.pad(torch.stack([lo, hi], dim=2), (0, 1))  # [B, 2, 2, nc, 4]
    boxes = boxes.permute(0, 3, 1, 2, 4).contiguous().reshape(B, -1, 4, 4)
    return pts.transpose(1, 2).contiguous(), perm, boxes, order.to(torch.int32), lbs


def kernel_plan(combined: torch.Tensor, split: torch.Tensor):
    """The kernel's plan: :func:`cells_plan`'s with the sorted keys as
    ``[B, Np, 4]`` rows (x, y, z, original row as int32 bits; pads at
    +1e15 with id N), each staged as one 16-byte copy, and the order the
    tiles are handed out in, ``torder [B * nt]`` int32, the widest tile
    boxes first (a wide tile holds sparse queries whose k-th neighbours
    are far, so its walk is long; started first, it ends with the rest):
    ``(keys, boxes, order, lbs, torder)``."""
    pts, ids, boxes, order, lbs = cells_plan(combined, split)
    keys = torch.cat([pts.transpose(1, 2), ids[..., None].view(torch.float32)], -1)
    qlo, qhi = chunk_boxes(keys[..., :3], TILE, ids < combined.shape[1])
    span = torch.clamp_min(qhi - qlo, 0.0)  # a tile of pad rows only: 0
    torder = torch.argsort((span * span).sum(-1).reshape(-1), descending=True, stable=True)
    return keys.contiguous(), boxes, order, lbs, torder.to(torch.int32)


def kernel_plan_graphed(combined: torch.Tensor, split: torch.Tensor):
    """:func:`kernel_plan` of CUDA tensors, replayed from a CUDA graph
    captured once per shape (``_build.graph_replay``): the cloud and the
    split are copied into the graph's inputs and the prep's ~30 small
    launches run as one.  The plan's tensors are the graph's own, so a
    plan must be consumed before the next call of its shape, on the
    stream the graph was captured for (another stream raises)."""
    key = (combined.device, tuple(combined.shape))
    return _build.graph_replay(_PLAN_GRAPHS, PLAN_GRAPHS, key, "fusion_cells plan",
                               kernel_plan, combined, split)


def fusion_cells_launch(combined, seg, k, plan, layers=None, scanned=None, stamps=None,
                        payload=None):
    """One launch of csrc/fusion_cells.cu on a :func:`kernel_plan` plan
    (counted in ``fusion_cells_kernel.launches``): one-shot with
    ``layers`` (the folded score MLP) and an optional ``payload [B, N,
    Cp]`` in the original row order (the kernel reads it by the slots'
    original rows), else residual.  ``seg [B, 4]`` int32 = (N1, N, k1,
    k2).  ``scanned``: an int64 ``[1]`` CUDA tensor that gains
    the (query, key) pairs scanned; ``stamps``: a zeroed int64 ``[B, nt,
    STAMPS]`` CUDA tensor that takes each tile's start, walk end and end
    (``%globaltimer`` ns), the chunks it walked, the pairs it scanned, its
    list inserts, and its warps' chunk scans lane by lane and needer by
    needer."""
    dev = combined.device
    B, N, _ = combined.shape
    keys, boxes, order, lbs, torder = plan
    for name, t in zip(("keys", "boxes", "order", "lbs", "torder"), plan):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"fusion_cells kernel: the plan's {name} must be contiguous on {dev}")
    if scanned is not None:
        _build.require(scanned, "scanned", torch.int64, 1, dev)
    if stamps is not None:
        _build.require(stamps, "stamps", torch.int64, 3, dev)
        if stamps.shape != (*order.shape[:2], STAMPS):
            raise ValueError(f"fusion_cells stamps: {(*order.shape[:2], STAMPS)}")
    Np = keys.shape[1]
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    Cp = payload_channels(payload, combined, "fusion_cells")
    if Cp and layers is None:
        raise ValueError("fusion_cells kernel: a payload in one-shot mode only")
    if layers is not None:
        dims = tuple(_build.layer_widths(layers))
        if dims != SCORE_MLP:
            raise ValueError(f"fusion_cells kernel is built for the {SCORE_MLP} score MLP, "
                             f"got {dims}")
        wtc = _build.pack_tf32(layers, dev, chain=True)
        out = torch.empty((B, N, 3 + Cp), dtype=torch.float32, device=dev)
        out_i = out_r = None
    else:
        wtc, dims = None, (4, 0, 0, 0)
        out = None
        out_i = torch.empty((B, N, k), dtype=torch.int64, device=dev)
        out_r = torch.empty((B, N, k, 3), dtype=torch.float32, device=dev)
    nxt = torch.zeros(1, dtype=torch.int32, device=dev)  # the tile counter
    err = _build.library().pci_fusion_cells(
        combined.data_ptr(), keys.data_ptr(), boxes.data_ptr(), order.data_ptr(),
        lbs.data_ptr(), torder.data_ptr(), seg.data_ptr(), ptr(wtc), *dims[1:],
        payload.data_ptr() if Cp else None, Cp, ptr(out), ptr(out_i),
        ptr(out_r), ptr(scanned), ptr(stamps), nxt.data_ptr(), B, N, Np, Np // boxes.shape[1],
        Np // order.shape[1], k, _build.stream_ptr(dev),
    )
    _build.check_launch("fusion_cells", err)
    fusion_cells_kernel.launches += 1
    return out if layers is not None else (out_i, out_r)


def fusion_cells_kernel(combined, seg_ends, budgets, k, layers=None, scanned=None,
                        payload=None):
    """The prep (:func:`kernel_plan_graphed`) and one launch
    (:func:`fusion_cells_launch`): one-shot with ``layers`` (the folded
    score MLP) and an optional ``payload``, else residual.  The payload
    does not ride the Morton sort: the plan is the cloud's alone."""
    dev = combined.device
    _build.require(combined, "combined", torch.float32, 3, dev)
    B, N, C = combined.shape
    if C != 3:
        raise ValueError("fusion_cells kernel takes [B, N, 3] clouds")
    if not 1 <= k <= PAIR_K:
        raise ValueError(f"fusion_cells kernel: k <= {PAIR_K} (two slots a lane)")
    if seg_ends.shape != (B, 2) or budgets.shape != (B, 2):
        raise ValueError("fusion_cells kernel: two segments a batch row")
    seg = torch.cat([seg_ends, budgets], dim=1).to(dev, torch.int32).contiguous()
    plan = kernel_plan_graphed(combined, seg[:, 0])
    return fusion_cells_launch(combined, seg, k, plan, layers, scanned, payload=payload)


fusion_cells_kernel.launches = 0


def fusion_cells_plain(combined, seg_ends, budgets, k, layers=None, payload=None):
    """The kernel's signature and function.  It computes through the flat
    plain versions (:func:`fusion_knn_cuda.fusion_plain` with ``layers``
    and the payload, :func:`fusion_knn_cuda.fusion_resi_plain` without),
    since pruning changes which pairs are scanned, not the neighbours."""
    if layers is not None:
        return fusion_plain(combined, seg_ends, budgets, layers, k, payload)
    return fusion_resi_plain(combined, seg_ends, budgets, k)


def segment_slots(budgets: torch.Tensor, k: int):
    """Each segment's slots as the residual kNN caps them
    (``fusion_resi_plain``): ``(caps [B, F], col0 [B, F])`` int32, segment
    f filling slots ``[col0, col0 + caps)`` with ``caps = max(0, min(budget,
    k - used))``; by device ops, no host sync."""
    caps, col0 = [], []
    used = torch.zeros_like(budgets[:, 0], dtype=torch.int32)
    for f in range(budgets.shape[1]):
        cap = torch.clamp(torch.minimum(budgets[:, f].to(torch.int32), k - used), min=0)
        caps.append(cap)
        col0.append(used)
        used = used + cap
    return torch.stack(caps, 1).to(torch.int32), torch.stack(col0, 1).to(torch.int32)


def fusion_cells_multi_knn(combined: torch.Tensor, seg_ends: torch.Tensor,
                           budgets: torch.Tensor, k: int, scanned=None):
    """:func:`fusion_knn_cuda.fusion_resi_knn`'s function for F segments
    (``seg_ends [B, F]`` cumulative, the last N; ``budgets [B, F]``) ->
    ``(idx [B, N, k] int64, resi [B, N, k, 3])``, slot for slot: on a CUDA
    tensor one launch of the box-pruned kNN's segment form a segment (all F
    launched, a segment whose budgets are all 0 too), its keys those of
    rows ``[end_{f-1}, end_f)``, pruned against each row's own budget's
    k-th, written into its slots; a slot its segment cannot fill is the row
    itself with a zero residual, and the last launch writes the slots past
    every budget so too.  ``scanned``: an int64 ``[F]`` CUDA tensor whose
    entry f gains the pairs pass f scanned.  Eval only (no backward: the
    route is taken where no gradient can flow); else
    :func:`fusion_resi_plain`."""
    _build.check_eval_only("fusion_cells_multi_knn", combined)
    if not _build.use_kernel(combined):
        return fusion_resi_plain(combined, seg_ends, budgets, k)
    combined = combined.detach().float().contiguous()
    dev = combined.device
    B, N, C = combined.shape
    F = seg_ends.shape[-1]
    if C != 3:
        raise ValueError("fusion_cells_multi_knn takes [B, N, 3] clouds")
    if seg_ends.shape != (B, F) or budgets.shape != (B, F):
        raise ValueError("fusion_cells_multi_knn: [B, F] segment ends and budgets")
    if not 1 <= k <= min(knn_cuda.MAX_K, N):
        raise ValueError(f"fusion_cells_multi_knn: k={k} needs 1 <= k <= min("
                         f"{knn_cuda.MAX_K}, N={N})")
    if scanned is not None and scanned.shape != (F,):
        raise ValueError(f"fusion_cells_multi_knn: scanned must be [{F}]")
    ends = seg_ends.to(dev, torch.int32)
    caps, col0 = segment_slots(budgets.to(dev), k)
    starts = torch.cat([torch.zeros_like(ends[:, :1]), torch.cummax(ends, 1).values[:, :-1]], 1)
    pos = torch.arange(N, device=dev, dtype=torch.int32)[None, :]
    idx = torch.empty((B, N, k), dtype=torch.int64, device=dev)
    resi = torch.empty((B, N, k, 3), dtype=torch.float32, device=dev)
    for f in range(F):
        valid = (pos >= starts[:, f:f + 1]) & (pos < ends[:, f:f + 1])
        plan = knn_cuda.knn_cells_plan_graphed(combined, combined, True, valid)
        knn_cuda.knn_cells_seg_launch(
            combined, combined, k, plan, budgets=caps[:, f].contiguous(),
            col0=col0[:, f].contiguous(), ks=k, fill=f == F - 1, out_i=idx, out_r=resi,
            scanned=None if scanned is None else scanned[f:f + 1])
    return idx, resi
