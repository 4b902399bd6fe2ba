"""FlowNet3D's decode mid-section in one launch: FlowEmbedding, set_conv3 and
set_conv4 (their centres picked by greedy FPS inside), set_upconv1..3.  The
CUDA kernel (csrc/flowmid.cu) and its plain PyTorch version.

Replaces ``pci_tpu/ops/pallas_kernels/flowmid_tpu.py:flowmid_fused``.  The
kernel's stage MLPs run on the tensor cores in 3xTF32 (fp32 accuracy), their
weights split once per weight set (``_build.pack_tf32``) and streamed through
a cp.async ring in shared memory; the selections are the per-stage kernels'.
"""

from __future__ import annotations

import ctypes

import torch

from ..gather import index_points
from . import _build
from .fps_cuda import fps_plain
from .knnconv_cuda import knnconv_plain
from .setconv_cuda import setconv_plain

# the folded MLP groups, in flowmid_tpu's _N_LAYERS order
GROUPS = ("flow_embedding", "set_conv3", "set_conv4", "set_upconv1.conv2",
          "set_upconv2.conv1", "set_upconv2.conv2", "set_upconv3.conv1",
          "set_upconv3.conv2")


def flowmid_fused(pa_1, fa_1, pa_2, fa_2, pb_2, fb_2, groups, s3: int = 64,
                  s4: int = 16, k_fe: int = 64, radius3: float = 2.0,
                  ns3: int = 8, radius4: float = 4.0, ns4: int = 8,
                  k_up: int = 8) -> torch.Tensor:
    """FlowNet3D's decode from FlowEmbedding to set_upconv3 -> ``nf_1``.

    ``pa_1 [B, N1, 3]`` / ``fa_1 [B, N1, C1]`` and ``pa_2 [B, N2, 3]`` /
    ``fa_2 [B, N2, C2]``: the query cloud's two encoder levels; ``pb_2`` /
    ``fb_2``: the other cloud's second level.  ``groups``: the eight folded
    MLPs of :data:`GROUPS`.  In order:

    - FlowEmbedding: each ``pa_2`` point's ``k_fe`` nearest ``pb_2`` points,
      slots ``[dxyz | fb_2 | fa_2]``, MLP, max -> ``emb``;
    - set_conv3 at ``s3`` greedy-FPS centres of ``pa_2`` (from index 0)
      over ``[pa_2 | emb]``, radius3 / ns3 -> ``fa_3``;
    - set_conv4 at ``s4`` greedy-FPS centres of those over ``[x3 | fa_3]``,
      radius4 / ns4 -> ``fa_4``;
    - set_upconv1: ``x4``'s ``fa_4`` onto ``x3`` (no MLP1), skip ``fa_3``;
    - set_upconv2: onto ``pa_2``, skip ``[fa_2 | emb]``;
    - set_upconv3: onto ``pa_1``, skip ``fa_1`` -> ``nf_1``.

    Each stage is :func:`knnconv_fused` or :func:`setconv_fused`'s
    function.  Returns ``nf_1 [B, N1, C_out]`` fp32.
    """
    if len(groups) != len(GROUPS):
        raise ValueError(f"flowmid: {len(GROUPS)} MLP groups ({', '.join(GROUPS)})")
    _build.check_eval_only("flowmid_fused", pa_1, fa_1, pa_2, fa_2, pb_2, fb_2,
                           *[t for g in groups for wb in g for t in wb])
    args = (s3, s4, k_fe, radius3, ns3, radius4, ns4, k_up)
    if _build.use_kernel(pa_1):
        f = lambda t: t.float().contiguous()  # noqa: E731
        return flowmid_kernel(f(pa_1), f(fa_1), f(pa_2), f(fa_2), f(pb_2), f(fb_2),
                              groups, *args)
    return flowmid_plain(pa_1, fa_1, pa_2, fa_2, pb_2, fb_2, groups, *args)


def flowmid_kernel(pa_1, fa_1, pa_2, fa_2, pb_2, fb_2, groups, s3, s4, k_fe,
                   radius3, ns3, radius4, ns4, k_up):
    dev = pa_1.device
    B, N1, _ = pa_1.shape
    N2, C1, C2 = pa_2.shape[1], fa_1.shape[-1], fa_2.shape[-1]
    named = (("pa_1", pa_1), ("fa_1", fa_1), ("pa_2", pa_2), ("fa_2", fa_2),
             ("pb_2", pb_2), ("fb_2", fb_2))
    for name, t in named:
        _build.require(t, name, torch.float32, 3, dev)
    if (fa_1.shape[:2] != (B, N1) or any(t.shape[:2] != (B, N2) for t in (fa_2, pb_2, fb_2))
            or fb_2.shape[-1] != C2 or pa_2.shape[0] != B):
        raise ValueError("flowmid: batch, point or channel counts disagree")
    if N2 > 4096 or s3 > 4096:
        raise ValueError("flowmid: the in-kernel FPS holds at most 4,096 points")
    if any(not g for g in groups):
        raise ValueError("flowmid: every MLP group needs a layer")
    ptrs, dims, doff, nl, widths = _launch_args(groups, dev)
    # one allocation for the scratch (16-byte aligned parts) and the barrier
    parts = [(s3, 3), (s4, 3), (N2, widths[0]), (s3, widths[1]), (s4, widths[2]),
             (s3, widths[3]), (N2, widths[5])]
    sizes = [-(-B * n * c // 4) * 4 for n, c in parts]
    scratch = torch.empty(sum(sizes) + 4, dtype=torch.float32, device=dev)
    offs = [0]
    for n in sizes:
        offs.append(offs[-1] + n)
    sp = [scratch.data_ptr() + 4 * o for o in offs]
    nf1 = torch.empty((B, N1, widths[7]), dtype=torch.float32, device=dev)
    err = _build.library().pci_flowmid(
        pa_1.data_ptr(), fa_1.data_ptr(), pa_2.data_ptr(), fa_2.data_ptr(),
        pb_2.data_ptr(), fb_2.data_ptr(), ptrs, dims, doff, nl, *sp[:7], nf1.data_ptr(),
        sp[7], B, N1, N2, C1, C2, s3, s4, k_fe, float(radius3) ** 2, ns3,
        float(radius4) ** 2, ns4, k_up, _build.stream_ptr(dev),
    )
    _build.check_launch("flowmid", err)
    flowmid_kernel.launches += 1
    return nf1


flowmid_kernel.launches = 0
_ARGS: dict = {}  # (group ids, device) -> (groups, launch arrays), a few weight sets


def _launch_args(groups, dev):
    """The launch's weight pointers (split for the tensor cores, once per
    weight set by ``_build.pack_tf32``), widths, their offsets and the layer
    counts as ctypes arrays, and each group's output width; kept for the
    weight sets of the last few calls (a module's ``PackedLayers`` are the
    same objects until its weights change)."""
    key = (tuple(id(g) for g in groups), str(dev))
    hit = _ARGS.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], groups)):
        return hit[1]
    bufs = [_build.pack_tf32(g, dev) for g in groups]
    widths = [[g[0][0].shape[1]] + [w.shape[0] for w, _ in g] for g in groups]
    doff = [0]
    for ds in widths[:-1]:
        doff.append(doff[-1] + len(ds))
    args = ((ctypes.c_void_p * len(bufs))(*[b.data_ptr() for b in bufs]),
            _build.int_array([d for ds in widths for d in ds]), _build.int_array(doff),
            _build.int_array([len(ds) - 1 for ds in widths]), [ds[-1] for ds in widths])
    if len(_ARGS) >= 8:
        _ARGS.clear()
    _ARGS[key] = (list(groups), args, bufs)
    return args


def flowmid_plain(pa_1, fa_1, pa_2, fa_2, pb_2, fb_2, groups, s3, s4, k_fe,
                  radius3, ns3, radius4, ns4, k_up):
    fe, sc3, sc4, su1, su2_1, su2_2, su3_1, su3_2 = groups
    start = torch.zeros(1, dtype=torch.long, device=pa_2.device)
    x3 = index_points(pa_2.float(), fps_plain(pa_2, s3, start, 1))
    x4 = index_points(x3, fps_plain(x3, s4, start, 1))
    emb = knnconv_plain(pa_2, pb_2, fb_2, fa_2, None, k_fe, fe, [], False)
    fa3 = setconv_plain(pa_2, emb, x3, radius3, ns3, sc3)
    fa4 = setconv_plain(x3, fa3, x4, radius4, ns4, sc4)
    nf3 = knnconv_plain(x3, x4, fa4, None, fa3, k_up, [], su1, False)
    nf2 = knnconv_plain(pa_2, x3, nf3, None, torch.cat([fa_2.float(), emb], -1), k_up,
                        su2_1, su2_2, False)
    return knnconv_plain(pa_1, pa_2, nf2, None, fa_1, k_up, su3_1, su3_2, False)
