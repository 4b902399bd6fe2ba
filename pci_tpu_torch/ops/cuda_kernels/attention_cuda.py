"""Point-transformer vector-attention tail: the CUDA kernel
(csrc/attention.cu) and its plain PyTorch version.

Replaces ``pci_tpu/ops/pallas_kernels/attention_tpu.py:fused_vector_attention``
(eval).  The function is the XLA expression of
``pci_tpu/nn/transformer.py:165-181``, in fp32 throughout (the TPU kernel
casts q and K|V to bf16 first)::

    pos = fc_delta_1(relu(fc_delta_0(delta)))
    a   = fc_gamma_1(relu(fc_gamma_0(q - K + pos)))
    res = sum_k softmax_k(a / sqrt(d)) * (V + pos)
"""

from __future__ import annotations

import math

import torch

from . import _build


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
