"""Point-transformer vector-attention tail: the CUDA kernels
(csrc/attention.cu, the forward; csrc/attention_bwd.cu, the backward) and
their plain PyTorch versions.

``vector_attention`` (eval) replaces
``pci_tpu/ops/pallas_kernels/attention_tpu.py:fused_vector_attention``;
``vector_attention_trainable`` replaces the same file's
``vector_attention_trainable`` (its forward ``_attn_fwd_f32`` and its
backward ``_vat_bwd_rule``).  The function is the XLA expression of
``pci_tpu/nn/transformer.py:165-181``, in fp32 throughout (the TPU eval
kernel casts q and K|V to bf16 first; the trainable one does not, so the
eval kernel here serves as the trainable forward)::

    pos = fc_delta_1(relu(fc_delta_0(delta)))
    a   = fc_gamma_1(relu(fc_gamma_0(q - K + pos)))
    res = sum_k softmax_k(a / sqrt(d)) * (V + pos)
"""

from __future__ import annotations

import math

import torch

from . import _build

# the backward's widths: d <= 64 holds five [64, d] tiles, the fp32 weights
# and its weight gradients' partial in shared memory; d in 72..128 (a
# multiple of 8, csrc/attention_bwd.cu attention_bwd_wide_kernel) keeps the
# five tiles there and reads the weights and its partial in device memory
BWD_MAX_D = 128
FWD_MAX_D, MAX_K = 128, 32  # the forward kernel's widths, both kernels' slots
# the forward's tensor-core routes (k <= 16): d <= WARP_MAX_D one warp a
# query (csrc/attention.cu attention_tc_kernel, its slots one 16-row tile,
# up to 8 n-tiles in registers, the chained split pack in shared memory);
# d in 72..128 block-wide over 64-row tiles (attention_wide_kernel, the
# unchained split pack streamed from device memory)
TC_MAX_D, TC_MAX_K, WARP_MAX_D = 128, 16, 64
FWD_WARPS, FWD_STAMPS = 12, 5  # csrc/attention.cu ATC_WARPS, ATC_STAMPS
BWD_STAMPS = 5  # csrc/attention_bwd.cu PCI_ABWD_STAMPS
_PACKS = []  # the most recent weight packs: (kind, tensors, versions, buffer)
# the plain backward runs blocks of this many (query, slot) rows
_PLAIN_ROWS = 1 << 16


def vector_attention(q: torch.Tensor, g: torch.Tensor, delta: torch.Tensor,
                     tail) -> torch.Tensor:
    """``q [B, N, d]``, ``g [B, N, k, 2d]`` gathered ``[K | V]``, ``delta
    [B, N, k, 3]`` (query minus neighbour), ``tail`` the four layers
    ``[(W [d, 3], b), (W [d, d], b), (W, b), (W, b)]`` of fc_delta_0,
    fc_delta_1, fc_gamma_0, fc_gamma_1 (``nn.Linear`` layout) ->
    ``res [B, N, d]`` fp32.  The kernel takes ``d <= 128`` (a multiple of 8)
    and ``k <= 32`` (:func:`kernel_route_ok`): on the tensor cores at ``k
    <= 16`` (:func:`tc_route_ok`; per warp at ``d <= 64``, block-wide
    above), the scalar route at ``k`` in 17..32; other shapes take the
    plain version on any device, decided before any launch (the JAX
    layer's XLA expression)."""
    _build.check_eval_only("vector_attention", q, g, delta,
                           *[t for wb in tail for t in wb])
    if _build.use_kernel(q) and kernel_route_ok(q.shape[-1], g.shape[2]):
        return attention_kernel(q.float().contiguous(), g.float().contiguous(),
                                delta.float().contiguous(), tail)
    return attention_plain(q, g, delta, tail)


def kernel_route_ok(d: int, k: int) -> bool:
    """The forward kernel's shapes: ``d`` a multiple of 8 in [8, 128] and
    ``1 <= k <= 32``."""
    return d % 8 == 0 and 8 <= d <= FWD_MAX_D and 1 <= k <= MAX_K


def bwd_route_ok(d: int, k: int) -> bool:
    """The trainable route's kernels: the forward's shapes where the
    backward kernel also takes them (``d <= 128``: every one)."""
    return kernel_route_ok(d, k) and d <= BWD_MAX_D


def tc_route_ok(d: int, k: int) -> bool:
    """The forward's tensor-core routes: ``d <= 128`` (a multiple of 8) and
    ``k <= 16`` (the transformer's k = 16 at ISAPCInet's widths 64, 96 and
    128): one warp a query at ``d <= 64``, block-wide tiles above; the
    scalar kernel serves the rest of the wrapper's shapes (k in 17..32)."""
    return d % 8 == 0 and 8 <= d <= TC_MAX_D and 1 <= k <= TC_MAX_K


def _cached(kind: str, tail, make) -> torch.Tensor:
    """``make()``, kept for the same weight tensors at the same versions
    (the entries hold the tensors, so a match cannot be a freed tensor's
    address reused); inference tensors carry no version and are packed
    every call."""
    ts = tuple(t for wb in tail for t in wb)
    if any(t.is_inference() for t in ts):
        return make()
    versions = tuple(t._version for t in ts)
    for entry in _PACKS:
        if entry[0] == kind and entry[2] == versions and all(
                a is b for a, b in zip(entry[1], ts)):
            return entry[3]
    buf = make()
    _PACKS.insert(0, (kind, ts, versions, buf))
    del _PACKS[8:]
    return buf


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def pack_tail(tail, device) -> torch.Tensor:
    """The csrc/attention.cu weight buffer: per layer ``W.T`` ([in][out],
    row-major) then ``b``."""
    parts = [t for w, b in tail for t in (w.t().reshape(-1), b.reshape(-1))]
    return torch.cat(parts).to(device=device, dtype=torch.float32).contiguous()


def pack_tail_tc(tail, device) -> torch.Tensor:
    """The tensor-core forward's weights: the four layers split for 3xTF32
    in :func:`_build.pack_tf32`'s layout; at ``d <= 64`` layers 1-3 chained
    (their A operand is the previous layer's accumulator fragments), above
    unchained (the block-wide kernel's A operand is rows in shared
    memory)."""
    return _build.pack_tf32(tail, device, chain=tail[1][0].shape[0] <= WARP_MAX_D)


def attention_kernel(q, g, delta, tail, stamps=None):
    dev = q.device
    _build.require(q, "q", torch.float32, 3, dev)
    _build.require(g, "g", torch.float32, 4, dev)
    _build.require(delta, "delta", torch.float32, 4, dev)
    B, N, d = q.shape
    k = g.shape[2]
    if g.shape != (B, N, k, 2 * d) or delta.shape != (B, N, k, 3):
        raise ValueError(f"attention kernel: q {tuple(q.shape)}, g {tuple(g.shape)}, "
                         f"delta {tuple(delta.shape)} do not fit")
    if not kernel_route_ok(d, k):
        raise ValueError(f"attention kernel takes d <= {FWD_MAX_D} (a multiple of 8) and "
                         f"k <= {MAX_K}, got d={d} k={k}")
    shapes = [tuple(w.shape) for w, _ in tail]
    if shapes != [(d, 3), (d, d), (d, d), (d, d)]:
        raise ValueError(f"attention kernel: tail layer shapes {shapes} for d={d}")
    tc = tc_route_ok(d, k)
    if stamps is not None:
        if not tc:
            raise ValueError("attention kernel: stamps are the tensor-core routes'")
        _build.require(stamps, "stamps", torch.int64, 2, dev)
        if stamps.shape[1] != FWD_STAMPS + 1 or stamps.shape[0] < _sm_count(dev) * FWD_WARPS:
            raise ValueError(f"attention kernel: stamps must be [>= SMs x {FWD_WARPS}, "
                             f"{FWD_STAMPS + 1}]")
    if tc:
        wbuf, wtc = None, _cached("tc", tail, lambda: pack_tail_tc(tail, dev))
    else:
        wbuf, wtc = _cached("fp32", tail, lambda: pack_tail(tail, dev)), None
    out = torch.empty((B, N, d), dtype=torch.float32, device=dev)
    err = _build.library().pci_attention(
        q.data_ptr(), g.data_ptr(), delta.data_ptr(),
        wbuf.data_ptr() if wbuf is not None else None,
        wtc.data_ptr() if wtc is not None else None, out.data_ptr(),
        stamps.data_ptr() if stamps is not None else None, B * N, d, k,
        _build.stream_ptr(dev),
    )
    _build.check_launch("attention", err)
    attention_kernel.launches += 1
    return out


attention_kernel.launches = 0


def attention_plain(q, g, delta, tail):
    d = q.shape[-1]
    lin = torch.nn.functional.linear
    (wd0, bd0), (wd1, bd1), (wg0, bg0), (wg1, bg1) = tail
    k_feat, v_feat = g[..., :d].float(), g[..., d:].float()
    pos = lin(torch.relu(lin(delta.float(), wd0, bd0)), wd1, bd1)
    a = lin(torch.relu(lin(q.float()[:, :, None, :] - k_feat + pos, wg0, bg0)), wg1, bg1)
    attn = torch.softmax(a / math.sqrt(d), dim=-2)
    return (attn * (v_feat + pos)).sum(dim=2)


def vector_attention_trainable(q: torch.Tensor, g: torch.Tensor,
                               delta: torch.Tensor, tail) -> torch.Tensor:
    """:func:`vector_attention` with gradients for every input and every
    weight and bias of ``tail``: the forward kernel, then the backward
    kernel (on a CUDA tensor at :func:`bwd_route_ok`'s shapes, decided for
    both directions at the forward; the plain versions elsewhere and on the
    CPU).  The backward takes the route the forward took."""
    (wd0, bd0), (wd1, bd1), (wg0, bg0), (wg1, bg1) = tail
    return _VectorAttention.apply(q, g, delta, wd0, bd0, wd1, bd1, wg0, bg0,
                                  wg1, bg1)


class _VectorAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, g, delta, *weights):
        tail = list(zip(weights[0::2], weights[1::2]))
        ctx.kernel = _build.use_kernel(q) and bwd_route_ok(q.shape[-1], g.shape[2])
        if ctx.kernel:
            out = attention_kernel(q.float().contiguous(), g.float().contiguous(),
                                   delta.float().contiguous(), tail)
        else:
            out = attention_plain(q, g, delta, tail)
        ctx.save_for_backward(q, g, delta, *weights)
        return out

    @staticmethod
    def backward(ctx, gout):
        q, g, delta, *weights = ctx.saved_tensors
        tail = list(zip(weights[0::2], weights[1::2]))
        return attention_bwd(q, g, delta, tail, gout, ctx.kernel)


def attention_bwd(q, g, delta, tail, gout, kernel: bool | None = None):
    """The trainable attention's backward at the output gradient ``gout
    [B, N, d]``: the kernel, or the plain version; ``kernel`` is the route
    (None: the one :func:`_build.use_kernel` gives ``q``).  Returns the
    gradients of ``(q, g, delta)`` and of the tail's eight weights and
    biases, the weights in ``nn.Linear`` layout."""
    if kernel is None:
        kernel = _build.use_kernel(q)
    if kernel:
        return attention_bwd_kernel(q.float().contiguous(), g.float().contiguous(),
                                    delta.float().contiguous(), tail,
                                    gout.float().contiguous())
    return attention_bwd_plain(q, g, delta, tail, gout)


def _unpack_grads(dw: torch.Tensor, d: int):
    """csrc/attention.cu's weight layout (``W.T`` then ``b`` a layer) ->
    the gradients of ``(W [d, in], b)`` for the four layers, flat."""
    out, off = [], 0
    for cin in (3, d, d, d):
        w = dw[off:off + cin * d].view(cin, d).t().contiguous()
        off += cin * d
        out += [w, dw[off:off + d]]
        off += d
    return out


def attention_bwd_kernel(q, g, delta, tail, gout, stamps=None):
    dev = q.device
    for name, t, nd in (("q", q, 3), ("g", g, 4), ("delta", delta, 4), ("gout", gout, 3)):
        _build.require(t, name, torch.float32, nd, dev)
    B, N, d = q.shape
    k = g.shape[2]
    if g.shape != (B, N, k, 2 * d) or delta.shape != (B, N, k, 3) or gout.shape != q.shape:
        raise ValueError(f"attention backward: q {tuple(q.shape)}, g {tuple(g.shape)}, "
                         f"delta {tuple(delta.shape)}, gout {tuple(gout.shape)} do not fit")
    if not (1 <= d <= WARP_MAX_D or d % 8 == 0 and d <= BWD_MAX_D) or not 1 <= k <= MAX_K:
        raise ValueError(f"attention backward kernel takes d <= {WARP_MAX_D}, or d <= "
                         f"{BWD_MAX_D} a multiple of 8, and k <= {MAX_K}, got d={d} k={k}")
    wbuf = _cached("fp32", tail, lambda: pack_tail(tail, dev))
    blocks = _sm_count(dev)
    if stamps is not None:
        _build.require(stamps, "stamps", torch.int64, 2, dev)
        if stamps.shape != (blocks, BWD_STAMPS + 1):
            raise ValueError(f"attention backward: stamps must be [{blocks}, {BWD_STAMPS + 1}]")
    partial = torch.empty(blocks * wbuf.numel(), dtype=torch.float32, device=dev)
    dw = torch.empty_like(wbuf)
    dq, dg, ddelta = torch.empty_like(q), torch.empty_like(g), torch.empty_like(delta)
    err = _build.library().pci_attention_bwd(
        q.data_ptr(), g.data_ptr(), delta.data_ptr(), wbuf.data_ptr(), gout.data_ptr(),
        dq.data_ptr(), dg.data_ptr(), ddelta.data_ptr(),
        partial.data_ptr(), dw.data_ptr(), stamps.data_ptr() if stamps is not None else None,
        B * N, d, k, blocks, _build.stream_ptr(dev),
    )
    _build.check_launch("attention_bwd", err)
    attention_bwd_kernel.launches += 1
    return (dq, dg, ddelta, *_unpack_grads(dw, d))


attention_bwd_kernel.launches = 0


def attention_stages(q, g, delta, tail, gout) -> dict:
    """One measurement launch of the forward and one of the backward on
    CUDA inputs with their ``%globaltimer`` stamps on: each kernel's stage
    times summed over its warps (forward at d <= 64: waiting for the
    query's copies, the pos MLP, forming h and V + pos, the gamma MLP, the
    softmax; block-wide at d > 64, thread 0 of each block: loading delta,
    the pos MLP, forming h, the gamma MLP, the softmax) or its blocks
    (backward: the tile's loads, the forward's layers, the softmax and
    gradient sums, the input gradients' products, the weight gradients),
    as shares of the summed time, with the kernel's span (the longest
    warp's or block's sum, ms) and queries or tiles a warp or block (mean
    and max)."""
    dev = q.device
    fs = torch.zeros((_sm_count(dev) * FWD_WARPS, FWD_STAMPS + 1), dtype=torch.int64,
                     device=dev)
    bs = torch.zeros((_sm_count(dev), BWD_STAMPS + 1), dtype=torch.int64, device=dev)
    attention_kernel(q, g, delta, tail, stamps=fs)
    attention_bwd_kernel(q, g, delta, tail, gout, stamps=bs)
    out = {}
    for name, t, keys in (
            ("forward", fs, ("wait", "pos_mlp", "h_vp", "gamma_mlp", "softmax")),
            ("backward", bs, ("loads", "fwd_layers", "softmax_sums", "dx_products",
                              "dw_products"))):
        t = t.cpu().double()
        t = t[t[:, -1] > 0]
        ns = t[:, :-1]
        total = float(ns.sum())
        out[name] = {**{k: float(ns[:, i].sum()) / total for i, k in enumerate(keys)},
                     "span_ms": float(ns.sum(1).max()) * 1e-6,
                     "units_mean": float(t[:, -1].mean()), "units_max": float(t[:, -1].max())}
    return out


def attention_bwd_plain(q, g, delta, tail, gout):
    """The backward as ``_attn_bwd_kernel`` writes it: recompute the
    forward, then the chain rule, over blocks of ``_PLAIN_ROWS`` (query,
    slot) rows; the weight gradients summed block after block.  Returns
    ``(dq, dg, ddelta, dW_d0, db_d0, dW_d1, db_d1, dW_g0, db_g0, dW_g1,
    db_g1)``, the weights' in ``nn.Linear`` layout."""
    B, N, d = q.shape
    k = g.shape[2]
    M = B * N
    lin = torch.nn.functional.linear
    (wd0, bd0), (wd1, bd1), (wg0, bg0), (wg1, bg1) = [(w.float(), b.float()) for w, b in tail]
    qf, gf = q.float().reshape(M, d), g.float().reshape(M, k, 2 * d)
    df, go = delta.float().reshape(M, k, 3), gout.float().reshape(M, d)
    dq, dg, ddelta = torch.empty_like(qf), torch.empty_like(gf), torch.empty_like(df)
    grads = [torch.zeros_like(t) for t in (wd0, bd0, wd1, bd1, wg0, bg0, wg1, bg1)]
    inv_sqrt_d = 1.0 / math.sqrt(d)
    step = max(1, _PLAIN_ROWS // k)
    for s in range(0, M, step):
        qc, gc, dc, gs = qf[s:s + step], gf[s:s + step], df[s:s + step], go[s:s + step]
        n = qc.shape[0]
        # forward recompute
        dlt = dc.reshape(n * k, 3)
        pre1 = lin(dlt, wd0, bd0)
        r1 = torch.relu(pre1)
        pos = lin(r1, wd1, bd1)
        kf, vf = gc[..., :d].reshape(n * k, d), gc[..., d:].reshape(n * k, d)
        h = qc[:, None, :].expand(n, k, d).reshape(n * k, d) - kf + pos
        pre2 = lin(h, wg0, bg0)
        r2 = torch.relu(pre2)
        a3 = lin(r2, wg1, bg1).reshape(n, k, d)
        e = torch.exp((a3 - a3.amax(dim=1, keepdim=True)) * inv_sqrt_d)
        s3 = e / e.sum(dim=1, keepdim=True)  # softmax over k, per channel
        vp3 = (vf + pos).reshape(n, k, d)
        # backward
        g3 = gs[:, None, :]
        dvp = (s3 * g3).reshape(n * k, d)
        ds3 = vp3 * g3
        da = (s3 * (ds3 - (s3 * ds3).sum(dim=1, keepdim=True)) * inv_sqrt_d).reshape(n * k, d)
        grads[7] += da.sum(0)
        grads[6] += da.t() @ r2
        dpre2 = torch.where(pre2 > 0, da @ wg1, 0.0)
        grads[5] += dpre2.sum(0)
        grads[4] += dpre2.t() @ h
        dh = dpre2 @ wg0
        dq[s:s + step] = dh.reshape(n, k, d).sum(dim=1)
        dpos = dh + dvp  # pos feeds both h and (V + pos)
        grads[3] += dpos.sum(0)
        grads[2] += dpos.t() @ r1
        dpre1 = torch.where(pre1 > 0, dpos @ wd1, 0.0)
        grads[1] += dpre1.sum(0)
        grads[0] += dpre1.t() @ dlt
        dg[s:s + step] = torch.cat([-dh, dvp], dim=1).reshape(n, k, 2 * d)
        ddelta[s:s + step] = (dpre1 @ wd0).reshape(n, k, 3)
    return (dq.reshape(q.shape), dg.reshape(g.shape), ddelta.reshape(delta.shape), *grads)
