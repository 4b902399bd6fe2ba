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

BWD_MAX_D = 64  # the backward holds the weights twice and five [64, d] tiles
# in shared memory
# the plain backward runs blocks of this many (query, slot) rows
_PLAIN_ROWS = 1 << 16


def vector_attention(q: torch.Tensor, g: torch.Tensor, delta: torch.Tensor,
                     tail) -> torch.Tensor:
    """``q [B, N, d]``, ``g [B, N, k, 2d]`` gathered ``[K | V]``, ``delta
    [B, N, k, 3]`` (query minus neighbour), ``tail`` the four layers
    ``[(W [d, 3], b), (W [d, d], b), (W, b), (W, b)]`` of fc_delta_0,
    fc_delta_1, fc_gamma_0, fc_gamma_1 (``nn.Linear`` layout) ->
    ``res [B, N, d]`` fp32.  The kernel takes ``d <= 128`` (a multiple of 8)
    and ``k <= 32``."""
    _build.check_eval_only("vector_attention", q, g, delta,
                           *[t for wb in tail for t in wb])
    if _build.use_kernel(q):
        return attention_kernel(q.float().contiguous(), g.float().contiguous(),
                                delta.float().contiguous(), tail)
    return attention_plain(q, g, delta, tail)


def pack_tail(tail, device) -> torch.Tensor:
    """The csrc/attention.cu weight buffer: per layer ``W.T`` ([in][out],
    row-major) then ``b``."""
    parts = [t for w, b in tail for t in (w.t().reshape(-1), b.reshape(-1))]
    return torch.cat(parts).to(device=device, dtype=torch.float32).contiguous()


def attention_kernel(q, g, delta, tail):
    dev = q.device
    _build.require(q, "q", torch.float32, 3, dev)
    _build.require(g, "g", torch.float32, 4, dev)
    _build.require(delta, "delta", torch.float32, 4, dev)
    B, N, d = q.shape
    k = g.shape[2]
    if g.shape != (B, N, k, 2 * d) or delta.shape != (B, N, k, 3):
        raise ValueError(f"attention kernel: q {tuple(q.shape)}, g {tuple(g.shape)}, "
                         f"delta {tuple(delta.shape)} do not fit")
    if d % 8 or not 8 <= d <= 128 or not 1 <= k <= 32:
        raise ValueError(f"attention kernel takes d <= 128 (a multiple of 8) and "
                         f"k <= 32, got d={d} k={k}")
    shapes = [tuple(w.shape) for w, _ in tail]
    if shapes != [(d, 3), (d, d), (d, d), (d, d)]:
        raise ValueError(f"attention kernel: tail layer shapes {shapes} for d={d}")
    wbuf = pack_tail(tail, dev)
    out = torch.empty((B, N, d), dtype=torch.float32, device=dev)
    err = _build.library().pci_attention(
        q.data_ptr(), g.data_ptr(), delta.data_ptr(), wbuf.data_ptr(),
        out.data_ptr(), B * N, d, k, _build.stream_ptr(dev),
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
    kernel (on a CUDA tensor; the plain versions on the CPU).  The
    backward takes the route the forward took."""
    (wd0, bd0), (wd1, bd1), (wg0, bg0), (wg1, bg1) = tail
    return _VectorAttention.apply(q, g, delta, wd0, bd0, wd1, bd1, wg0, bg0,
                                  wg1, bg1)


class _VectorAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, g, delta, *weights):
        tail = list(zip(weights[0::2], weights[1::2]))
        ctx.kernel = _build.use_kernel(q)
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


def attention_bwd_kernel(q, g, delta, tail, gout):
    dev = q.device
    for name, t, nd in (("q", q, 3), ("g", g, 4), ("delta", delta, 4), ("gout", gout, 3)):
        _build.require(t, name, torch.float32, nd, dev)
    B, N, d = q.shape
    k = g.shape[2]
    if g.shape != (B, N, k, 2 * d) or delta.shape != (B, N, k, 3) or gout.shape != q.shape:
        raise ValueError(f"attention backward: q {tuple(q.shape)}, g {tuple(g.shape)}, "
                         f"delta {tuple(delta.shape)}, gout {tuple(gout.shape)} do not fit")
    if not 1 <= d <= BWD_MAX_D or not 1 <= k <= 32:
        raise ValueError(f"attention backward kernel takes d <= {BWD_MAX_D} and k <= 32, "
                         f"got d={d} k={k}")
    wbuf = pack_tail(tail, dev)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty(blocks * wbuf.numel(), dtype=torch.float32, device=dev)
    dw = torch.empty_like(wbuf)
    dq, dg, ddelta = torch.empty_like(q), torch.empty_like(g), torch.empty_like(delta)
    err = _build.library().pci_attention_bwd(
        q.data_ptr(), g.data_ptr(), delta.data_ptr(), wbuf.data_ptr(), gout.data_ptr(),
        dq.data_ptr(), dg.data_ptr(), ddelta.data_ptr(), partial.data_ptr(),
        dw.data_ptr(), B * N, d, k, blocks, _build.stream_ptr(dev),
    )
    _build.check_launch("attention_bwd", err)
    attention_bwd_kernel.launches += 1
    return (dq, dg, ddelta, *_unpack_grads(dw, d))


attention_bwd_kernel.launches = 0


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
