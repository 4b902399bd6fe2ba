"""PointNet++ MSG mid-section in one launch: sa2, sa3, sa4 (FPS centres
inside, two ball scales a level, GroupNorm MLPs, slot max) and fp4, fp3,
fp2 (3-NN interpolation, GroupNorm MLPs).  The CUDA kernel (csrc/pn2mid.cu)
and its plain PyTorch version.

Replaces ``pci_tpu/ops/pallas_kernels/pn2mid_tpu.py:pn2mid_fused``.
"""

from __future__ import annotations

import ctypes

import torch

from ..gather import index_points
from . import _build
from .ball_cuda import ball_plain
from .fps_cuda import fps_plain
from .knn_cuda import knn_plain

# the nine GroupNorm MLPs in pn2mid_tpu's order, and their layer counts
GROUPS = ("sa2.scale0", "sa2.scale1", "sa3.scale0", "sa3.scale1", "sa4.scale0",
          "sa4.scale1", "fp4.mlp", "fp3.mlp", "fp2.mlp")
N_LAYERS = (3, 3, 3, 3, 3, 3, 2, 2, 2)
S_LIST = (256, 64, 16)
# samples a launch: csrc/pn2mid.cu's PN_MAXB sizes its per-sample GroupNorm
# statistics (PnStats); pn2mid_fused splits a larger batch
MAX_BATCH = 16
RADII = ((0.2, 0.4), (0.4, 0.8), (0.8, 1.6))
KS = ((16, 32), (16, 32), (16, 32))
GN_EPS = 1e-5
# the kernel's phases, each ended by a grid barrier (the last by none): the
# rows of its optional %globaltimer stamps (pn2mid_kernel(stamps=...))
PHASES = ("start", "fps", *(f"{lv}.l{i}" for lv in ("sa2", "sa3", "sa4") for i in range(3)),
          *(f"{lv}.{part}" for lv in ("fp4", "fp3", "fp2") for part in ("l0", "l0.sum", "l1")),
          "finish")
# a phase's stamps, a block: its arrival at and leaving of the phase's grid
# barrier (%globaltimer ns), its summed ns in each part of its items, its items
STAMP_PARTS = ("ids", "cols", "build", "mma", "out")
STAMPS = 2 + len(STAMP_PARTS) + 1


def gn_pointmlp_vars(mlp) -> list:
    """A ``PointMLP(norm="group")``'s layers as ``[(W [cin, cout], aux [3,
    cout]), ...]``, aux rows the dense bias, the GroupNorm scale and bias
    (``pci_tpu/ops/pallas_kernels/pn2mid_tpu.py:gn_pointmlp_vars``),
    detached: the kernel is eval only."""
    return [(d.weight.detach().t(), torch.stack([d.bias, g.weight, g.bias]).detach())
            for d, g in zip(mlp.dense, mlp.gn)]


class PackedGroups(list):
    """The nine groups ``[[(W, aux), ...], ...]`` that also carry their
    kernel-layout buffers (:func:`_pack`, :func:`pack_tc`), so a module
    packs its weights once and not on every launch."""

    def __init__(self, groups):
        super().__init__(groups)
        device = self[0][0][0].device
        self.buf, self.dims, self.doff, self.nl = _pack(self, device)
        self.wtc = pack_tc(self, device)


def pack_tc(groups, dev) -> torch.Tensor:
    """Every layer's W and dense bias split for the tensor cores
    (``_build.pack_tf32``'s layout, a layer at a time, in group order): the
    kernel's B operands."""
    return torch.cat([_build.pack_tf32([(w.t(), aux[0])], dev) for g in groups for w, aux in g])


def pn2mid_fused(l1_xyz: torch.Tensor, l1_f: torch.Tensor, groups,
                 s_list=S_LIST, radii=RADII, ks=KS) -> torch.Tensor:
    """sa2 .. sa4 and fp4 .. fp2 of ``Pointnet2FeatureAbstract`` at eval.

    ``l1_xyz [B, N1, 3]`` / ``l1_f [B, N1, C1]``: sa1's output; ``groups``:
    the nine GroupNorm MLPs of :data:`GROUPS` as :func:`gn_pointmlp_vars`
    gives them.  Centres by exact greedy FPS from index 0 (``s_list``);
    balls of ``radii`` / ``ks`` (the first K keys in index order, padded
    with the first hit, an empty ball reading key row 0) grouping
    ``[feats | dxyz]``; every layer Dense -> GroupNorm(4) -> ReLU, then the
    max over slots; FP: exact 3-NN (ties to the lower index), weights
    ``1 / (d + 1e-8)``, ``[skip | interp]``.  Returns ``[B, N1, C_out]``
    fp32.  Eval only.  On the card a batch of more than :data:`MAX_BATCH`
    samples runs as launches of at most that many, concatenated: every
    statistic is per sample (GroupNorm's, ``csrc/pn2mid.cu:pn_stats``), so
    the split is exact."""
    if len(groups) != len(GROUPS) or tuple(len(g) for g in groups) != N_LAYERS:
        raise ValueError(f"pn2mid: {len(GROUPS)} GroupNorm MLPs of {N_LAYERS} layers")
    _build.check_eval_only("pn2mid_fused", l1_xyz, l1_f,
                           *[t for g in groups for wa in g for t in wa])
    if _build.use_kernel(l1_xyz):
        x, f = l1_xyz.float().contiguous(), l1_f.float().contiguous()
        outs = [pn2mid_kernel(x[s:s + MAX_BATCH], f[s:s + MAX_BATCH], groups, s_list, radii, ks)
                for s in range(0, x.shape[0], MAX_BATCH)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)
    return pn2mid_plain(l1_xyz, l1_f, groups, s_list, radii, ks)


def _pack(groups, dev):
    parts, dims, doff, nl = [], [], [], []
    for g in groups:
        doff.append(len(dims))
        nl.append(len(g))
        dims.append(g[0][0].shape[0])
        for w, aux in g:
            if w.shape[0] != dims[-1] or aux.shape != (3, w.shape[1]):
                raise ValueError("pn2mid: layer widths do not chain")
            dims.append(w.shape[1])
            parts += [w.reshape(-1), aux.reshape(-1)]
    buf = torch.cat([t.float() for t in parts]).to(dev).contiguous()
    return buf, dims, doff, nl


def pn2mid_kernel(l1_xyz, l1_f, groups, s_list, radii, ks, stamps=None):
    """One launch.  ``stamps``: a zeroed int64 ``[blocks, len(PHASES),
    STAMPS]`` CUDA tensor (blocks at least the launch's grid) that takes, for
    each block and phase, its arrival at and leaving of the phase's grid
    barrier (``%globaltimer`` ns), its time in each of ``STAMP_PARTS`` of its
    items (the ball or 3-NN ids, the column tables, the input rows, the
    products, the output and statistics) and its items (a measurement
    launch only)."""
    dev = l1_xyz.device
    B, N1, _ = l1_xyz.shape
    C1 = l1_f.shape[-1]
    _build.require(l1_xyz, "l1_xyz", torch.float32, 3, dev)
    _build.require(l1_f, "l1_f", torch.float32, 3, dev)
    if l1_f.shape[:2] != (B, N1):
        raise ValueError("pn2mid: batch or point counts disagree")
    if B > MAX_BATCH or N1 > 4096:
        raise ValueError(f"pn2mid kernel: at most {MAX_BATCH} samples of 4,096 points")
    if isinstance(groups, PackedGroups) and groups.buf.device == dev:
        buf, dims, doff, nl, wtc = groups.buf, groups.dims, groups.doff, groups.nl, groups.wtc
    else:
        (buf, dims, doff, nl), wtc = _pack(groups, dev), pack_tc(groups, dev)
    ia = _build.int_array
    args = (ia(dims), ia(doff), ia(nl))
    shape = (B, N1, C1, ia(s_list), ia([k for lv in ks for k in lv]),
             _build.float_array([float(r) ** 2 for lv in radii for r in lv]))
    sizes = (ctypes.c_longlong * 2)()
    lib = _build.library()
    _build.check_launch("pn2mid scratch", lib.pci_pn2mid_scratch(*args, *shape, sizes))
    fscratch = torch.empty(sizes[0], dtype=torch.float32, device=dev)
    dscratch = torch.empty(sizes[1], dtype=torch.float64, device=dev)
    out = torch.empty((B, N1, dims[-1]), dtype=torch.float32, device=dev)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    if stamps is not None:
        _build.require(stamps, "stamps", torch.int64, 3, dev)
        if stamps.shape[1:] != (len(PHASES), STAMPS):
            raise ValueError(f"pn2mid stamps: [blocks, {len(PHASES)}, {STAMPS}]")
    err = lib.pci_pn2mid(l1_xyz.data_ptr(), l1_f.data_ptr(), buf.data_ptr(), *args,
                         fscratch.data_ptr(), dscratch.data_ptr(), out.data_ptr(),
                         bar.data_ptr(), *shape, wtc.data_ptr(),
                         stamps.data_ptr() if stamps is not None else None,
                         _build.stream_ptr(dev))
    _build.check_launch("pn2mid", err)
    pn2mid_kernel.launches += 1
    return out


pn2mid_kernel.launches = 0


def group_norm_relu(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int = 4) -> torch.Tensor:
    """``relu(GroupNorm(h))`` over ``h [B, ..., C]``: a group's statistics
    over every axis but the batch axis, the means accumulated in fp64 and
    rounded to fp32, var = max(E[x^2] - mean^2, 0), eps 1e-5
    (``nn.norm.GroupNorm``'s formula and pn2mid_tpu's)."""
    B, C = h.shape[0], h.shape[-1]
    xg = h.float().reshape(B, -1, groups, C // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True, dtype=torch.float64).float()
    mean2 = (xg * xg).mean(dim=(1, 3), keepdim=True, dtype=torch.float64).float()
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    mul = torch.rsqrt(var + GN_EPS) * scale.reshape(groups, C // groups)
    y = (xg - mean) * mul + bias.reshape(groups, C // groups)
    return torch.relu(y.reshape(h.shape))


def gn_mlp_plain(h: torch.Tensor, layers) -> torch.Tensor:
    for w, aux in layers:
        h = group_norm_relu(h @ w.float() + aux[0], aux[1], aux[2])
    return h


def interp3_plain(q, kx, kf):
    """Exact 3-NN of ``q`` in ``kx`` (ties to the lower index), ``num /
    den`` with weights ``1 / (d + 1e-8)`` from the exact distances."""
    _, idx = knn_plain(q, kx, 3)
    diff = index_points(kx, idx) - q[:, :, None, :]
    d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
    w = 1.0 / (d + 1e-8)
    f = index_points(kf, idx)
    num = (w[..., 0:1] * f[:, :, 0] + w[..., 1:2] * f[:, :, 1]) + w[..., 2:3] * f[:, :, 2]
    den = (w[..., 0:1] + w[..., 1:2]) + w[..., 2:3]
    return num / den


def pn2mid_plain(l1_xyz, l1_f, groups, s_list=S_LIST, radii=RADII, ks=KS):
    """The kernel's function stage by stage with plain ops and pn2mid's
    rules (an empty ball reads key row 0; 3-NN ``num / den``)."""
    x, f = l1_xyz.float(), l1_f.float()
    start = torch.zeros(1, dtype=torch.long, device=x.device)
    cs = []
    for s in s_list:
        cs.append(index_points(x if not cs else cs[-1], fps_plain(x if not cs else cs[-1], s,
                                                                  start, 1)))
    kx, kf, feats = x, f, []
    for lv, c in enumerate(cs):
        idx_list = ball_plain(kx, c, radii[lv], ks[lv], empty="first")
        outs = []
        for idx, g in zip(idx_list, groups[2 * lv:2 * lv + 2]):
            h = torch.cat([index_points(kf, idx), index_points(kx, idx) - c[:, :, None, :]], -1)
            outs.append(gn_mlp_plain(h, g).amax(dim=2))
        kx, kf = c, torch.cat(outs, -1)
        feats.append(kf)
    # fp4: c3 <- c4, skip l3_f; fp3: c2 <- c3, skip l2_f; fp2: l1 <- c2, skip l1_f
    skips = [(x, f), (cs[0], feats[0]), (cs[1], feats[1])]
    for g, lv in zip(groups[6:], (2, 1, 0)):
        q, skip = skips[lv]
        kf = gn_mlp_plain(torch.cat([skip, interp3_plain(q, cs[lv], kf)], -1), g)
    return kf
