"""Adaptive attentive points fusion (counterpart of ``pci_tpu/nn/fusion.py``
``PointsFusion`` and ``PointsFusionWithFeatures``).

Adaptive sampling takes ``N1 = N - N2`` points of warped cloud 1 and
``N2 ~ N * t`` (aligned to ``_ALIGN``) of warped cloud 2, each through its
own random permutation, into one combined cloud; each combined point then
takes ``k1 = k - floor(k * t)`` neighbours from the cloud-1 segment and
``k2`` from the cloud-2 segment, and the attention head fuses them.  At
eval on the card that is one kernel (``knn_fusion_attention``), or, with
``PCI_TPU_FUSION_ONESHOT`` set to anything but "1", the JAX package's
two-kernel route: the residual kNN (``fusion_resi_knn``) and the attention
tail (``fusion_attention_tail``), which a CPU tensor also takes.  In
training, as on the TPU, the residual kNN (with the fixed-neighbour
backward) and then the head in PyTorch, its BatchNorms on batch
statistics (``fusion_head``).  At N >= ``_CELLS_FUSION_N`` points on the
card with k <= 64 the same two routes run on the cell-pruned kernel
(``fusion_cells_attention`` / ``fusion_cells_resi_knn``), as the JAX
package routes its 65,536-point protocol row; it gives the flat kernels'
neighbours while scanning a small share of the pairs.

``PointsFusionWithFeatures`` also carries per-point features (intensity)
through the same merge and reduces them with the same attention weights:
on the one-shot route as the kernel's payload (one launch, as without
it), on the two-kernel route as the tail's ``extra``, gathered by the
residual kNN's indices.

``PointsFusionMulti`` (PointINet2's last fusion) merges F clouds with
budgets from ``Wnet``'s weights: the budgeted F-segment residual kNN (one
kernel on the card), then a GroupNorm score MLP in PyTorch.  From
``_CELLS_FUSION_N`` points on the card (k <= 64) the kNN is cell-pruned, as
the JAX package's ``_cells_fusion_knn``: two segments (field 1) on the
cells kernel's residual mode, in training too; F >= 3 segments at eval,
where no gradient can flow, as F masked passes of the box-pruned kNN
(``fusion_cells_multi_knn``, row 10's ``key_valid`` form), each writing its
budget into its slots.

At eval with a gradient that could flow (``_build.needs_grad``: grad mode
on and an input or a parameter requiring grad, the counterpart of the
JAX package's ``ops.has_tangents``) the eval function runs by
differentiable ops: the residual kNN with its fixed-neighbour backward,
then the head in PyTorch on the BatchNorms' running statistics.

The permutations come from ``torch.randperm`` with the caller's
``torch.Generator``: torch cannot reproduce ``jax.random``'s draws, so a
caller that needs given permutations passes ``perms=(perm1, perm2)``.
``PointsFusion(sampling="fps")`` orders each cloud by greedy FPS over all
N points instead (``pci_tpu/nn/fusion.py:PointsFusion._orders``), from a
start drawn from the generator in training and 0 at eval.

The flat kernels serve k <= 128 (one, two or four slots a lane, chosen by
k at launch), the cell-pruned ones k <= 64, and the tail any k; past
those the budgeted kNN runs its plain version (on the card too) and the
head the tail kernel at eval, PyTorch in training.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from ..ops import index_points
from ..ops.fps import fps
from ..ops.cuda_kernels import (
    _build,
    fusion_attention_tail,
    fusion_cells_attention,
    fusion_cells_multi_knn,
    fusion_cells_resi_knn,
    fusion_resi_knn,
    knn_fusion_attention,
)
from ..ops.cuda_kernels.fusion_knn_cuda import (
    MAX_KERNEL_K,
    MAX_PAYLOAD,
    MAX_SEGMENTS,
    FusionResiKnn,
    fusion_head,
    fusion_resi_plain,
)
from ..ops.cuda_kernels.fusion_tail_cuda import fusion_tail_plain
from .layers import fps_start
from .mlp import PointMLP

SAMPLINGS = ("random", "fps")  # PointsFusion's orders of each cloud

# N2 rounds to a multiple of _ALIGN; with k <= _ALIGN a segment with a
# positive neighbour budget always holds at least k points (past it, a
# segment shorter than its budget leaves self-neighbour slots)
_ALIGN = 32

# From this many points on the fusion runs on the cell-pruned kernel
# (pci_tpu/nn/fusion.py:_CELLS_FUSION_N): the flat kernels' scan grows as N^2
_CELLS_FUSION_N = 32768


def _adaptive_budgets(N: int, k: int, t: torch.Tensor):
    """(N1, N2, k1, k2) ``[B]`` int32 each, computed in fp32 as in
    ``pci_tpu/nn/fusion.py:_adaptive_budgets``."""
    t = t.float()
    k2 = torch.floor(k * t).to(torch.int32)
    k1 = k - k2
    N2 = (torch.floor(N * t / _ALIGN + 0.5) * _ALIGN).to(torch.int32)
    N2 = torch.maximum(N2, _ALIGN * (k2 > 0).to(torch.int32))
    N2 = torch.minimum(N2, N - _ALIGN * (k1 > 0).to(torch.int32))
    return N - N2, N2, k1, k2


def _multi_budgets(N: int, k: int, w_head: torch.Tensor):
    """Per-cloud sample and neighbour budgets of F clouds from ``w_head
    [B, F - 1]`` (the last cloud takes the remainders): ``(n_all [B, F],
    k_all [B, F])`` int32, every n a multiple of ``_ALIGN`` and the last
    cloud at least ``_ALIGN`` points; a cloud the cumulative clamp leaves
    with no points gets no neighbour slots.  Computed in fp32 in the order
    of ``pci_tpu/nn/fusion.py:_multi_budgets``: ``floor(k * w)`` and the
    rounding of ``N * w / _ALIGN`` are rounding-sensitive."""
    w = w_head.float()
    k_budget = torch.floor(k * w).to(torch.int32)
    n_b = (torch.floor(N * w / _ALIGN + 0.5) * _ALIGN).to(torch.int32)
    n_b = torch.maximum(n_b, _ALIGN * (k_budget > 0).to(torch.int32))
    cum = torch.cumsum(n_b, dim=1).clamp(max=N - _ALIGN).to(torch.int32)
    n_b = torch.diff(cum, dim=1, prepend=torch.zeros_like(cum[:, :1]))
    n_all = torch.cat([n_b, N - cum[:, -1:]], dim=1)
    k_budget = torch.where(n_b > 0, k_budget, torch.zeros_like(k_budget))
    k_all = torch.cat([k_budget, k - k_budget.sum(dim=1, keepdim=True, dtype=torch.int32)], 1)
    return n_all, k_all


def _composed_shuffle_merge(points_list, perms, n_all):
    """Combined cloud = concat of each shuffled cloud's ``n_all[:, j]``
    prefix, by one gather from the concatenation.  Returns
    ``(combined [B, N, 3], gidx [B, N])`` with gidx indexing the
    ``cat(points_list, 1)`` rows."""
    B, N, _ = points_list[0].shape
    F = len(points_list)
    dev = points_list[0].device
    pos = torch.arange(N, device=dev)[None, :]
    cum = torch.cumsum(n_all.long(), dim=1)  # [B, F], last == N
    owner = (pos[:, :, None] >= cum[:, None, :-1]).sum(-1)  # [B, N]
    start = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
    local = pos - torch.gather(start, 1, owner)
    perm_flat = torch.stack([p.long() for p in perms], dim=1).reshape(B, F * N)
    src = torch.gather(perm_flat, 1, owner * N + local.clamp(0, N - 1))
    gidx = owner * N + src
    cat = torch.cat(points_list, dim=1)
    combined = torch.gather(cat, 1, gidx[..., None].expand(-1, -1, cat.shape[-1]))
    return combined, gidx


def _fusion_oneshot_ok(train: bool, x: torch.Tensor) -> bool:
    """Route the eval fusion to the one-shot kernel (kNN and attention head
    in one launch): eval on a CUDA tensor, unless
    ``PCI_TPU_FUSION_ONESHOT`` (read at call time, default "1", as the JAX
    package's gate reads it) says otherwise.  Module-level for tests and
    A/B flips."""
    return x.is_cuda and not train and os.environ.get("PCI_TPU_FUSION_ONESHOT", "1") == "1"


def _cells_route_ok(points: torch.Tensor, k: int, train: bool, n_seg: int = 2) -> bool:
    """Route the fusion's kNN to the cell-pruned kernels: a CUDA tensor of
    at least ``_CELLS_FUSION_N`` points and ``k <= 64``, in training only
    for two segments (``pci_tpu/nn/fusion.py:_cells_route_ok``).  Two
    segments (``PointsFusion``, and ``PointsFusionMulti`` at field 1) take
    the cells fusion kernel (row 12); more (``PointsFusionMulti``, eval
    only) the F masked passes of the box-pruned kNN (row 10,
    ``fusion_cells_multi_knn``).  No environment variable, as in the JAX
    package.  Module-level for tests."""
    return (points.is_cuda and points.shape[-2] >= _CELLS_FUSION_N and k <= 64
            and (n_seg == 2 or not train))


def _kernel_shape_ok(k: int, payload: torch.Tensor | None) -> bool:
    """The flat fusion kernels' shapes (rows 4 and 4b): ``k <=
    MAX_KERNEL_K`` (128: one lane a slot up to 32, two up to 64, four past
    it, in csrc/fusion_knn.cu; the cells route stops at 64) and a payload
    of at most ``MAX_PAYLOAD`` channels (the one-shot kernels').  Past
    either, the budgeted kNN takes its plain version on any device, inside
    the same fixed-neighbour autograd function, the counterpart of the JAX
    package's XLA kNN (``pci_tpu/nn/fusion.py:422-433``), which serves any
    k; the head then runs as :func:`_tail_shape_ok` says.  Module-level for
    tests."""
    return k <= MAX_KERNEL_K and _tail_shape_ok(payload)


def _tail_shape_ok(payload: torch.Tensor | None) -> bool:
    """The attention tail kernel's shapes (row 7, csrc/fusion_tail.cu): any
    k and a payload of at most ``MAX_PAYLOAD`` channels, as the JAX
    package sends every eval head to ``fusion_attention_tail``
    (``_apply_fusion_tail``).  Past it the head takes its plain version.
    Module-level for tests."""
    return payload is None or payload.shape[-1] <= MAX_PAYLOAD


def _neighbour_payload(payload, idx):
    """Each slot's payload ``[B, N, k, C]`` by the residual kNN's indices
    (a self-neighbour's slot holds the row, so its own payload), or None."""
    return None if payload is None else index_points(payload, idx)


def random_perms(B: int, N: int, generator: torch.Generator | None,
                 device) -> torch.Tensor:
    """``[B, N]`` int64 uniform permutations from ``generator``."""
    return torch.stack([
        torch.randperm(N, generator=generator, device=device) for _ in range(B)
    ])


class PointsFusion(nn.Module):
    """Fuse two warped clouds with adaptive sampling and learned attention
    over ``k`` adaptive neighbours.  ``sampling``: each cloud's order,
    ``"random"`` (a permutation) or ``"fps"`` (greedy FPS over all N
    points); any other raises ``ValueError``."""

    def __init__(self, sampling: str = "random"):
        super().__init__()
        if sampling not in SAMPLINGS:
            raise ValueError(f"unknown sampling {sampling!r}")
        self.sampling = sampling
        self.mlp = PointMLP(4, (64, 64, 128))  # the score MLP

    def forward(self, points1, points2, k: int, t, perms=None,
                generator: torch.Generator | None = None, momentum: float = 0.1):
        """``points1/2 [B, N, 3]`` warped clouds, ``t [B]`` in (0, 1) ->
        fused ``[B, N, 3]``.  ``perms``: optional ``(perm1, perm2)``
        ``[B, N]``; otherwise drawn from ``generator``.  ``momentum``: the
        score MLP's BatchNorm momentum in training."""
        return self._fuse(points1, points2, None, k, t, perms, generator, momentum)

    def _fuse(self, points1, points2, feats, k, t, perms, generator, momentum):
        """The fusion of both classes: ``feats`` is None, or ``(feats1,
        feats2)`` ``[B, N, C]`` carried through the same merge as their
        clouds and reduced with the attention weights (the payload), ->
        ``[B, N, 3 + C]``."""
        B, N, _ = points1.shape
        N1, N2, k1, k2 = _adaptive_budgets(N, k, t)
        if perms is None:
            perms = self._orders(points1, points2, feats is None, generator)
        combined, gidx = _composed_shuffle_merge(
            [points1, points2], [p.to(points1.device) for p in perms],
            torch.stack([N1, N2], dim=1),
        )
        payload = None
        if feats is not None:
            cat = torch.cat(feats, dim=1)
            payload = torch.gather(cat, 1, gidx[..., None].expand(-1, -1, cat.shape[-1]))
        seg_ends = torch.stack([N1, torch.full_like(N1, N)], dim=1)
        budgets = torch.stack([k1, k2], dim=1)
        shape_ok = _kernel_shape_ok(k, payload)
        grad = not self.training and _build.needs_grad(self, combined, payload)
        cells = shape_ok and _cells_route_ok(combined, k, self.training)
        if shape_ok and not grad and _fusion_oneshot_ok(self.training, combined):
            oneshot = fusion_cells_attention if cells else knn_fusion_attention
            return oneshot(combined, seg_ends, budgets, self.mlp.folded(), k, payload=payload)
        if shape_ok:
            knn = fusion_cells_resi_knn if cells else fusion_resi_knn
            idx, resi = knn(combined, seg_ends, budgets, k)
        else:
            idx, resi = FusionResiKnn.apply(combined, seg_ends, budgets, k, fusion_resi_plain)
        extra = _neighbour_payload(payload, idx)
        if self.training or grad:
            # the head in PyTorch (pci_tpu/nn/fusion.py:282-292), at eval on
            # the BatchNorms' running statistics
            return fusion_head(combined, resi, lambda h: self.mlp(h, momentum), extra)
        tail = fusion_attention_tail if _tail_shape_ok(payload) else fusion_tail_plain
        return tail(combined, resi, extra, self.mlp.folded())

    def _orders(self, points1, points2, xyz_only: bool, generator):
        """Both clouds' orders ``[B, N]``: FPS for ``sampling="fps"`` on a
        call without features (the JAX PointINet builds its xyz fusion with
        ``fusion_sampling`` and the one with features without it), random
        permutations otherwise."""
        B, N, _ = points1.shape
        if self.sampling == "fps" and xyz_only:
            return tuple(fps(p, N, fps_start(self, p, generator)) for p in (points1, points2))
        return (random_perms(B, N, generator, points1.device),
                random_perms(B, N, generator, points1.device))


class PointsFusionWithFeatures(PointsFusion):
    """:class:`PointsFusion` that also carries a feature channel (LiDAR
    intensity) through the attention weights, the counterpart of
    ``pci_tpu/nn/fusion.py:PointsFusionWithFeatures``
    (PointINet20230424/models/layers.py:335-430).  The same score MLP under
    the same name, so both classes load one state dict."""

    def forward(self, points1, points2, feats1, feats2, k: int, t, perms=None,
                generator: torch.Generator | None = None, momentum: float = 0.1):
        """``points1/2 [B, N, 3]`` warped clouds, ``feats1/2 [B, N, C]``
        their features, ``t [B]`` -> fused ``[B, N, 3 + C]``: the xyz of
        :class:`PointsFusion` and ``sum_k w * feature`` of the same
        neighbours (a slot its segment cannot fill is the row itself and
        carries the row's own).  Feature rows go through the clouds'
        permutations.  On the card at eval the payload rides the one-shot
        kernel's launch (up to ``MAX_PAYLOAD`` channels; wider ones take
        the plain versions; past k = 128 the kNN takes its plain version
        and the head the tail kernel).  ``feats1/2`` None:
        :class:`PointsFusion`'s ``[B, N, 3]``, ordered by ``sampling``;
        with features the orders are random, as the JAX class draws
        them."""
        feats = None if feats1 is None else (feats1, feats2)
        return self._fuse(points1, points2, feats, k, t, perms, generator, momentum)


class PointsFusionMulti(nn.Module):
    """Fusion across F = field + 1 clouds with per-cloud budgets (the
    counterpart of ``pci_tpu/nn/fusion.py:PointsFusionMulti``,
    Utils/Layers.py:286-381): cloud j < F - 1 takes ``n_j ~ N w_j`` sampled
    points and ``floor(k w_j)`` neighbours (:func:`_multi_budgets`), the
    last cloud the remainders.  The score MLP has GroupNorm(C/8) layers
    (``PointMLP_0``, flax's name), which no kernel can fold, so after the
    budgeted F-segment residual kNN (one kernel on the card, the plain
    version on the CPU; its fixed-neighbour backward; from
    ``_CELLS_FUSION_N`` points the cell-pruned routes, see the module's
    docstring) the head runs in PyTorch."""

    def __init__(self):
        super().__init__()
        self.mlp = PointMLP(4, (64, 64, 128), norm="group_div")

    def forward(self, points_list, k: int, weights, perms=None,
                generator: torch.Generator | None = None):
        """``points_list``: F clouds ``[B, N, 3]``; ``weights [B, >= F - 1]``
        (only ``weights[:, :F - 1]`` is read, as in the JAX module: PointINet2
        passes ``Wnet``'s ``[B, 6 field]``) -> fused ``[B, N, 3]``.
        ``perms``: F ``[B, N]`` permutations, one a cloud; otherwise drawn
        from ``generator``."""
        F = len(points_list)
        B, N, _ = points_list[0].shape
        dev = points_list[0].device
        n_all, k_all = _multi_budgets(N, k, weights[:, :F - 1])
        if perms is None:
            perms = [random_perms(B, N, generator, dev) for _ in range(F)]
        combined, _ = _composed_shuffle_merge(list(points_list), [p.to(dev) for p in perms],
                                              n_all.to(dev))
        seg_ends = torch.cumsum(n_all, dim=1)
        shape_ok = k <= MAX_KERNEL_K and F <= MAX_SEGMENTS  # k <= 128
        cells = _cells_route_ok(combined, k, self.training, F)  # k <= 64, any F
        if cells and F == 2:  # pci_tpu/nn/fusion.py:189-208, the single-pass kernel
            _, resi = fusion_cells_resi_knn(combined, seg_ends, k_all, k)
        elif cells and not _build.needs_grad(combined):  # :209-233, eval only
            _, resi = fusion_cells_multi_knn(combined, seg_ends, k_all, k)
        elif shape_ok:
            _, resi = fusion_resi_knn(combined, seg_ends, k_all, k)
        else:
            _, resi = FusionResiKnn.apply(combined, seg_ends, k_all, k, fusion_resi_plain)
        return fusion_head(combined, resi, self.mlp)
