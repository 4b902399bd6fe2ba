"""The 3xTF32 split of the tensor-core kernels (pci_tpu_torch/csrc/mma_tf32.cuh)
held on the CPU: the host-side split and fragment layout of
``_build.PackedLayers.tf32`` / ``_build.pack_tf32``, and a torch emulation of
the three-product layer chain at the widths the one-shot fusion (row 4),
the FlowNet3D decode megakernel (row 6), kNN-conv's FeaturePropagation with
the classifier (row 3) and the encoder megakernel's two set-convs (row 5)
run, against the fp64 chain.

The card runs the same arithmetic in its mma instructions; chip_smoke.py
holds the kernels against their plain versions there."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pci_tpu_torch.ops.cuda_kernels import _build

SCORE = (4, 64, 64, 128)  # the fusion's score MLP
FLOW_EMBEDDING = (259, 128, 128, 128)
SET_UPCONV3 = ((259, 128, 128, 256), (320, 256))  # conv1, conv2
FP_CLASSIFIER = (259, 256, 256, 128, 3)  # [pooled | skip], the last layer linear
SET_CONV1 = (6, 32, 32, 64)
SET_CONV2 = (67, 64, 64, 128)


def _layers(dims, seed):
    """Seeded folded layers ``[(W [cout, cin], b)]`` at a Dense layer's init
    scale (uniform, 1 / sqrt(cin)), as torch tensors."""
    rng = np.random.default_rng(seed)
    out = []
    for cin, cout in zip(dims[:-1], dims[1:]):
        s = 1.0 / np.sqrt(cin)
        w = rng.uniform(-s, s, (cout, cin)).astype(np.float32)
        b = rng.uniform(-s, s, cout).astype(np.float32)
        out.append((torch.from_numpy(w), torch.from_numpy(b)))
    return out


def _decode(buf, dims, chain):
    """Read ``buf`` back through the layout mma_tf32.cuh documents: per layer
    the hi / lo halves of ``W.T`` padded to ``[K8, N8]`` and the bias padded
    to ``N8``, plus the float count consumed."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    buf = buf.numpy()
    off, layers = 0, []
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        k8, n8 = -(-cin // 8) * 8, -(-cout // 8) * 8
        frag = buf[off:off + k8 * n8 * 2].reshape(k8 // 8, n8 // 8, 32, 4)
        off += k8 * n8 * 2
        k0, k1 = (2 * t, 2 * t + 1) if chain and i else (t, t + 4)
        hi, lo = np.full((k8, n8), np.nan, np.float32), np.full((k8, n8), np.nan, np.float32)
        for kt in range(k8 // 8):
            for nt in range(n8 // 8):
                f = frag[kt, nt]
                hi[8 * kt + k0, 8 * nt + g] = f[:, 0]
                hi[8 * kt + k1, 8 * nt + g] = f[:, 1]
                lo[8 * kt + k0, 8 * nt + g] = f[:, 2]
                lo[8 * kt + k1, 8 * nt + g] = f[:, 3]
        layers.append((hi, lo, buf[off:off + n8]))
        off += n8
    return layers, off


def _chain(x, decoded, dims, split=True, n_linear=0):
    """The kernels' layer chain in torch fp32: each activation split in the
    kernel's way (or rounded once to TF32, ``split=False``), the three
    products ``a_hi w_lo + a_lo w_hi + a_hi w_hi`` (or ``a w``), + bias,
    ReLU after every layer but the last ``n_linear``; ``x [R, dims[0]]``."""
    h = x.float()
    for i, ((hi, lo, b), cin, cout) in enumerate(zip(decoded, dims[:-1], dims[1:])):
        k8 = hi.shape[0]
        a = torch.zeros(h.shape[0], k8)
        a[:, :cin] = h
        whi, wlo = torch.from_numpy(hi), torch.from_numpy(lo)
        ahi, alo = _build.tf32_split(a)
        if split:
            y = ahi @ wlo + alo @ whi + ahi @ whi
        else:
            y = ahi @ whi
        h = (y + torch.from_numpy(b))[:, :cout]
        if i < len(decoded) - n_linear:
            h = torch.relu(h)
    return h


def _chain64(x, layers, n_linear=0):
    h = x.double()
    for i, (w, b) in enumerate(layers):
        h = h @ w.double().t() + b.double()
        if i < len(layers) - n_linear:
            h = torch.relu(h)
    return h


def _rows(dims, n, seed, relu_feats=True):
    """Seeded MLP input rows: xyz offsets of ~1 m, then ReLU'd features."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dims[0])).astype(np.float32)
    if relu_feats:
        x[:, 3:] = np.maximum(x[:, 3:], 0.0)
    return torch.from_numpy(x)


def _check_bits(layers, chain):
    """hi's 13 low mantissa bits are zero, lo is TF32 too, hi + lo rebuilds
    W.T within 2^-21 |W|, and the padding is zero."""
    packed = _build.PackedLayers(layers)
    dims = packed.dims
    decoded, used = _decode(packed.tf32(chain), dims, chain)
    assert used == packed.tf32(chain).numel()
    for (hi, lo, b), (w, bias) in zip(decoded, layers):
        cout, cin = w.shape
        assert not np.isnan(hi).any() and not np.isnan(lo).any()  # every entry written
        for half in (hi, lo):
            assert (half.view(np.int32) & 0x1FFF == 0).all()
        wt = w.t().numpy().astype(np.float64)
        rebuilt = hi[:cin, :cout].astype(np.float64) + lo[:cin, :cout]
        assert (np.abs(rebuilt - wt) <= 2.0 ** -21 * np.abs(wt)).all()
        assert (hi[cin:] == 0).all() and (hi[:, cout:] == 0).all()
        assert (lo[cin:] == 0).all() and (lo[:, cout:] == 0).all()
        np.testing.assert_array_equal(b[:cout], bias.numpy())
        assert (b[cout:] == 0).all()


def _case_round():
    """cvt.rna.tf32: nearest, ties away from zero, low 13 bits zero."""
    vals = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11),
                     1.0 + 3 * 2.0 ** -12, 3.0e-3, -7.5e4], np.float32)
    got = _build.tf32_round(torch.from_numpy(vals)).numpy()
    want = np.array([1.0, 1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10), 1.0 + 2.0 ** -10,
                     np.nan, np.nan], np.float32)
    np.testing.assert_array_equal(got[:5], want[:5])
    assert (got.view(np.int32) & 0x1FFF == 0).all()
    rel = np.abs(got[5:].astype(np.float64) / vals[5:] - 1)
    assert (rel <= 2.0 ** -11).all()


def _case_bits_score():
    _check_bits(_layers(SCORE, 1), chain=True)


def _case_bits_flow():
    _check_bits(_layers(FLOW_EMBEDDING, 2), chain=False)


def _case_bits_upconv():
    _check_bits(_layers(SET_UPCONV3[0], 3), chain=False)
    _check_bits(_layers(SET_UPCONV3[1], 4), chain=False)


def _case_cached():
    """Built once per layout and weight set, then reused; a plain list of
    layers packs the same bits."""
    layers = _layers(SCORE, 5)
    packed = _build.PackedLayers(layers)
    first = packed.tf32(True)
    assert packed.tf32(True) is first
    assert _build.pack_tf32(packed, torch.device("cpu"), chain=True) is first
    assert not torch.equal(packed.tf32(False), first)  # layers 2-3 permuted
    assert torch.equal(_build.pack_tf32(layers, torch.device("cpu"), chain=True), first)
    with pytest.raises(ValueError):
        _build.pack_tf32([layers[1], layers[0]], torch.device("cpu"))


def _emulate(layers, rows, chain, n_linear=0):
    """The emulated 3xTF32 chain (from the packed buffer) against fp64:
    returns (max error, single-TF32 max error), both relative to the
    output's largest magnitude."""
    packed = _build.PackedLayers(layers)
    decoded, _ = _decode(packed.tf32(chain), packed.dims, chain)
    want = _chain64(rows, layers, n_linear)
    top = want.abs().max().item()
    err = (_chain(rows, decoded, packed.dims, n_linear=n_linear) - want).abs().max().item() / top
    one = (_chain(rows, decoded, packed.dims, split=False, n_linear=n_linear)
           - want).abs().max().item() / top
    return err, one


def _case_emulate(layers, rows, chain, tol, n_linear=0):
    err, one = _emulate(layers, rows, chain, n_linear)
    # well under chip_smoke's 1e-4 hold; one TF32 product is not
    assert err <= tol, err
    assert one > 20 * err, (one, err)


def _case_score():
    # 64 queries x 32 slots: [resi | safe_norm(resi)]
    rng = np.random.default_rng(6)
    r = rng.standard_normal((2048, 3)).astype(np.float32)
    x = np.concatenate([r, np.sqrt((r * r).sum(-1, keepdims=True) + 1e-12)], -1)
    _case_emulate(_layers(SCORE, 7), torch.from_numpy(x), True, 2e-6)


def _case_flow_embedding():
    # one query's 64 slots x 4 queries: [dxyz | fb_2 | fa_2]
    _case_emulate(_layers(FLOW_EMBEDDING, 8), _rows(FLOW_EMBEDDING, 256, 9), False, 2e-6)


def _case_set_upconv3():
    conv1, conv2 = _layers(SET_UPCONV3[0], 10), _layers(SET_UPCONV3[1], 11)
    _case_emulate(conv1, _rows(SET_UPCONV3[0], 512, 12), False, 2e-6)
    _case_emulate(conv2, _rows(SET_UPCONV3[1], 64, 13, relu_feats=False).abs(), False, 2e-6)


def _case_bits_fp_classifier():
    _check_bits(_layers(FP_CLASSIFIER, 14), chain=False)


def _case_bits_set_convs():
    _check_bits(_layers(SET_CONV1, 15), chain=False)
    _check_bits(_layers(SET_CONV2, 16), chain=False)


def _case_fp_classifier():
    # 64 queries a tile: [3-NN interpolated nf_1 (ReLU'd) | the cloud's
    # 3 skip channels], the classifier's last layer linear
    rng = np.random.default_rng(17)
    x = np.concatenate([np.maximum(rng.standard_normal((512, 256)), 0.0),
                        rng.standard_normal((512, 3))], -1).astype(np.float32)
    _case_emulate(_layers(FP_CLASSIFIER, 18), torch.from_numpy(x), False, 2e-6, n_linear=1)


def _case_set_convs():
    # 8 centres x 16 slots: [dxyz | feats]
    _case_emulate(_layers(SET_CONV1, 19), _rows(SET_CONV1, 128, 20), False, 2e-6)
    _case_emulate(_layers(SET_CONV2, 21), _rows(SET_CONV2, 128, 22), False, 2e-6)


CASES = {
    "tf32_round": _case_round,
    "bits_score_mlp": _case_bits_score,
    "bits_flow_embedding": _case_bits_flow,
    "bits_set_upconv3": _case_bits_upconv,
    "built_once": _case_cached,
    "chain_score_mlp": _case_score,
    "chain_flow_embedding": _case_flow_embedding,
    "chain_set_upconv3": _case_set_upconv3,
    "bits_fp_classifier": _case_bits_fp_classifier,
    "bits_set_convs": _case_bits_set_convs,
    "chain_fp_classifier": _case_fp_classifier,
    "chain_set_convs": _case_set_convs,
}


@pytest.mark.parametrize("case", list(CASES))
def test_tf32_split(case):
    CASES[case]()
