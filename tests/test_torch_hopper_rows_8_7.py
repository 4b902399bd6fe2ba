"""The redesigned nearest-neighbour kNN (csrc/knn.cu ``nearest_kernel``, k =
1) and attention tail (csrc/fusion_tail.cu) held on the CPU, where neither
kernel runs: the rules their designs rest on, and their wrappers.

- A numpy emulation of the k = 1 scan split over the CTAs of a cluster
  (contiguous 4-key-aligned ranges of the valid keys in rank order; each
  range in tiles packed as (x, y, z, |k|^2) with the tile's largest |k|^2;
  a warp's block of keys at a time marked by the three-FMA form against
  the query's running minimum's limit, checked to be a superset of the
  exact test at every step, 300 m out too; the marked keys measured op by
  op, their least (distance, index) taken when strictly below the
  minimum; the ranks merged in range order, strictly) gives
  ``knn_plain(..., 1, valid_n)``'s indices and distances bit for bit, and
  ``pci_tpu.ops.knn_prefix(..., exact=True)``'s indices on grid clouds,
  with points duplicated across range boundaries, prefixes inside a range,
  at 0 and past N, and S and N ragged against the tiles and ranges.
- ``fusion_tail_plain`` against the JAX package's XLA head
  (``pci_tpu/nn/fusion.py:_apply_fusion_tail``, whose tail gate is off on
  the CPU) at k = 7, 16 and 32 with and without a payload; a torch
  emulation of the kernel's 3xTF32 head (the chained split pack decoded,
  two 16-slot tiles or one, slots at or past k inactive) against fp64.
- Both wrappers on a stub kernel library (the CUDA route forced): their
  launch arguments, and their outputs assembled from what the stub writes.

chip_smoke.py holds the kernels themselves against their plain versions on
the card."""

from __future__ import annotations

import ctypes

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pci_tpu.nn.fusion as jfusion
from pci_tpu import ops as jops
from pci_tpu_torch.convert import flax_to_state_dict
from pci_tpu_torch.nn import PointsFusion
from pci_tpu_torch.ops import knn
from pci_tpu_torch.ops.cuda_kernels import _build, fusion_tail_cuda, knn_cuda
from tests.test_torch_hopper_rows_9_4b import StubLibrary, fma_mark, grid_cloud, norms, sqd, write
from tests.test_torch_tf32 import SCORE, _chain, _decode, _layers

F32 = np.float32
T = torch.from_numpy

# ---- row 8: the k = 1 scan split over a cluster's ranks -----------------------------


def emulate_nearest(q, x, valid, C, TK, BL, QT):
    """csrc/knn.cu's nearest_kernel on queries ``q [B, S, 3]`` and keys ``x
    [B, N, 3]`` with ``C`` ranks, tiles of ``TK`` keys, steps of ``BL`` keys
    (a warp's block: 32 lanes x NN_KL keys) and query tiles of ``QT`` (the
    tile's last queries clamped to S - 1, as the kernel loads them): each
    rank scans its range tile by tile and block by block; a query marks
    the block's keys below its limit as it stood at the step's start (the
    mark asserted a superset of the exact test), measures the marked ones
    and takes their least (distance, index) when strictly below its
    minimum; the ranks merge in range order, strictly.  Returns (distances
    [B, S, 1], indices [B, S, 1]) and the share of pairs measured."""
    B, S, _ = q.shape
    N = x.shape[1]
    out_d = np.empty((B, S, 1), F32)
    out_i = np.empty((B, S, 1), np.int64)
    marked = pairs = 0
    for b in range(B):
        nb = N if valid is None else max(0, min(int(valid[b]), N))
        chunk = -(-(-(-nb // C)) // 4) * 4
        for t0 in range(0, S, QT):
            qs = q[b, np.minimum(np.arange(t0, t0 + QT), S - 1)]
            part = []
            for r in range(C):
                a, e = min(r * chunk, nb), min((r + 1) * chunk, nb)
                best = np.full(QT, np.inf, F32)
                bi = np.full(QT, -1, np.int64)
                for k0 in range(a, e, TK):
                    tile = x[b, k0:min(e, k0 + TK)]
                    kmax = norms(tile).max()
                    for base in range(0, tile.shape[0], BL):
                        keys = tile[base:base + BL]
                        d = sqd(keys[None], qs[:, None])  # [QT, n]
                        mark = fma_mark(keys, qs, best, kmax)
                        assert not ((d < best[:, None]) & ~mark).any()  # a superset
                        marked += int(mark.sum())
                        pairs += mark.size
                        cand = np.where(mark, d, np.inf)
                        j = np.argmin(cand, 1)  # the first least: the lowest index
                        dm = cand[np.arange(QT), j]
                        take = dm < best
                        best[take], bi[take] = dm[take], k0 + base + j[take]
                part.append((best, bi))
            d, i = part[0]
            for od, oi in part[1:]:
                take = od < d
                d, i = np.where(take, od, d), np.where(take, oi, i)
            n = min(QT, S - t0)
            out_d[b, t0:t0 + n, 0] = d[:n] if nb else F32(1e30)
            out_i[b, t0:t0 + n, 0] = i[:n] if nb else 0
    return out_d, out_i, marked / max(pairs, 1)


def _nearest_cloud(name, rng, B, S, N):
    if name.startswith("dups"):  # N // 8 points, eight copies: ties across the ranges
        base = (rng.standard_normal((B, N // 8, 3)) * 2).astype(F32)
        x = np.concatenate([base] * 8, 1)
        q = base[:, rng.integers(0, N // 8, S)]
        q = (q + (rng.random((B, S, 1)) < 0.5) * rng.standard_normal((B, S, 3))).astype(F32)
        return q, x
    if name == "grid":
        return grid_cloud(rng, B, S, 1.5), grid_cloud(rng, B, N, 1.5)
    x = (rng.standard_normal((B, N, 3)) * 2).astype(F32)
    q = (rng.standard_normal((B, S, 3)) * 2).astype(F32)
    if name == "far":  # the mark's cancellation at its largest
        x, q = (x * 0.05 + F32(300.0)).astype(F32), (q * 0.05 + F32(300.0)).astype(F32)
    return q, x


NEAREST_CASES = {
    # name: (B, S, N, valid_n, C, TK, BL, QT)
    "ragged": (2, 333, 1001, None, 4, 128, 64, 128),
    "valid_inside_range": (2, 200, 1500, (1100, 1500), 8, 128, 64, 128),
    "valid_0_and_past_n": (2, 100, 700, (0, 5000), 4, 256, 128, 64),
    "dups_aligned": (1, 300, 1024, None, 8, 128, 64, 128),  # a range a copy
    "dups_across": (1, 250, 1000, None, 8, 96, 32, 128),  # copies across range boundaries
    "far": (1, 200, 1200, None, 4, 256, 128, 128),
    "grid": (2, 150, 900, (700, 900), 2, 256, 256, 128),
}


@pytest.mark.parametrize("name", list(NEAREST_CASES))
def test_emulated_nearest_gives_plain(name):
    """The emulation equals knn_plain(..., 1, valid_n) bit for bit; a
    prefix of 0 gives 1e30 at index 0; duplicated points give the first
    copy."""
    B, S, N, valid, C, TK, BL, QT = NEAREST_CASES[name]
    rng = np.random.default_rng(1400 + N)
    q, x = _nearest_cloud(name, rng, B, S, N)
    vn = None if valid is None else torch.tensor(valid)
    got_d, got_i, _ = emulate_nearest(q, x, valid, C, TK, BL, QT)
    want_d, want_i = knn_cuda.knn_plain(T(q), T(x), 1, vn)
    np.testing.assert_array_equal(got_i, want_i.numpy())
    np.testing.assert_array_equal(got_d, want_d.numpy())
    if valid is not None and 0 in valid:
        row = valid.index(0)
        assert (got_d[row] == F32(1e30)).all() and (got_i[row] == 0).all()
    if name.startswith("dups"):  # ties: the first copy's index
        assert (got_i < N // 8).all()


def test_emulated_nearest_marks_few_pairs():
    """At a training step's range length (8,192 keys a rank, blocks of 256
    keys) the mark sends under 5% of the pairs to the exact test: a range's
    first block (its limit still infinite, 3.1%), the running minimum's
    improvements and the keys within the margin."""
    rng = np.random.default_rng(1405)
    q, x = _nearest_cloud("ragged", rng, 1, 64, 8192)
    got_d, got_i, share = emulate_nearest(q, x, None, 1, 1024, 256, 64)
    want_d, want_i = knn_cuda.knn_plain(T(q), T(x), 1)
    np.testing.assert_array_equal(got_i, want_i.numpy())
    np.testing.assert_array_equal(got_d, want_d.numpy())
    assert share < 0.05, share


def test_emulated_nearest_gives_jax_indices():
    """On grid clouds (exact squared distances by both formulas, many
    ties) the emulation's indices equal the JAX package's
    knn_prefix(exact=True), and its distances JAX's."""
    B, S, N, valid, C, TK, BL, QT = NEAREST_CASES["grid"]
    rng = np.random.default_rng(1400 + N)
    q, x = _nearest_cloud("grid", rng, B, S, N)
    got_d, got_i, _ = emulate_nearest(q, x, valid, C, TK, BL, QT)
    jd, ji = jops.knn_prefix(jnp.asarray(q), jnp.asarray(x), 1, jnp.asarray(np.int32(valid)),
                             exact=True)
    np.testing.assert_array_equal(got_i, np.asarray(ji))
    np.testing.assert_array_equal(got_d, np.asarray(jd))


# ---- row 7: the tail's head ---------------------------------------------------------

TAIL_CASES = [(7, 0), (7, 2), (16, 0), (16, 2), (32, 0), (32, 2)]  # (k, Ce)
TAIL_N = 96


class _Head(fnn.Module):
    """The JAX package's shared attention head (its XLA route: the tail
    gate is off on the CPU), the score MLP named as PointsFusion names it."""

    @fnn.compact
    def __call__(self, combined, resi, extra):
        return jfusion._apply_fusion_tail(self, (64, 64, 128), combined, resi, extra, False, 0.9)


@pytest.fixture(scope="module")
def tail_cases():
    """Seeded rows, residuals (one query in five with its last slots zero:
    an unfilled segment) and payloads for TAIL_CASES, one JAX head's
    variables (non-trivial BatchNorm statistics) and its rows for every
    case from one jit, and the port's PointsFusion holding those
    variables."""
    rng = np.random.default_rng(1410)
    data = []
    for k, ce in TAIL_CASES:
        comb = (rng.standard_normal((1, TAIL_N, 3)) * 5).astype(F32)
        resi = rng.standard_normal((1, TAIL_N, k, 3)).astype(F32)
        resi[:, ::5, k // 2:] = 0.0
        extra = rng.standard_normal((1, TAIL_N, k, ce)).astype(F32) if ce else None
        data.append((comb, resi, extra))
    head = _Head()
    comb, resi, extra = data[0]
    v = head.init(jax.random.key(0), jnp.asarray(comb), jnp.asarray(resi), None)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.01 * jnp.arange(a.size, dtype=a.dtype).reshape(a.shape)
                             if a.ndim == 1 else a), v)

    @jax.jit
    def all_rows(cases):
        return [head.apply(v, c, r, x) for c, r, x in cases]

    want = all_rows([tuple(None if t is None else jnp.asarray(t) for t in c) for c in data])
    mod = PointsFusion()
    mod.load_state_dict(flax_to_state_dict(v))
    return data, [np.asarray(w) for w in want], mod.eval()


@pytest.mark.parametrize("case", range(len(TAIL_CASES)))
def test_tail_plain_matches_jax_head(tail_cases, case):
    """fusion_tail_plain on the folded score MLP equals the JAX head within
    1e-5 (rows and payload channels; both fp32, BatchNorm folded on one
    side)."""
    data, want, mod = tail_cases
    comb, resi, extra = data[case]
    with torch.inference_mode():
        got = fusion_tail_cuda.fusion_tail_plain(
            T(comb), T(resi), None if extra is None else T(extra), mod.mlp.folded())
    assert got.shape == want[case].shape
    np.testing.assert_allclose(got.numpy(), want[case], atol=1e-5, rtol=1e-5)


def _tf32_head(comb, resi, extra, layers, k, split=True):
    """csrc/fusion_tail.cu's arithmetic in torch: 32 slots a query (lane L
    slot L; slots at or past k zero and inactive), the score MLP from the
    chained split pack in 3xTF32 over one 16-slot tile (k <= 16) or two,
    the max over channels, the softmax over the active slots, and the
    weighted sums; ``split=False``: one TF32 product a multiply-add."""
    R = comb.shape[0] * comb.shape[1]
    tiles = 1 if k <= 16 else 2
    r = torch.zeros(R, 32, 3)
    r[:, :k] = resi.reshape(R, k, 3)
    feats = torch.cat([r, torch.sqrt((r * r).sum(-1, keepdim=True) + 1e-12)], -1)
    packed = _build.PackedLayers(layers)
    decoded, _ = _decode(packed.tf32(True), packed.dims, True)
    rows = feats[:, :16 * tiles].reshape(-1, 4)
    score = _chain(rows, decoded, packed.dims, split=split).amax(-1).reshape(R, 16 * tiles)
    score = torch.where(torch.arange(16 * tiles) < k, score, -torch.inf)
    w = torch.exp(score - score.amax(-1, keepdim=True))[:, :k, None]
    sw = w.sum(1)
    out = comb.reshape(R, 3) + (w * resi.reshape(R, k, 3)).sum(1) / sw
    if extra is not None:
        out = torch.cat([out, (w * extra.reshape(R, k, -1)).sum(1) / sw], -1)
    return out.reshape(*comb.shape[:2], -1)


@pytest.mark.parametrize("k, ce", [(7, 0), (16, 2), (32, 1)])
def test_tf32_head_emulation_against_fp64(k, ce):
    """The emulated 3xTF32 head with its inactive slots equals the head in
    fp64 within 2e-6 m (rows and payload; the plain fp32 version's error
    here too, ~5e-7; the kernel holds' 1e-4 leaves room for the card's
    summation order), and the single-TF32 head misses by far more
    (~1e-4)."""
    rng = np.random.default_rng(1420 + k)
    N = 64
    layers = _layers(SCORE, 1421 + k)
    comb = T((rng.standard_normal((1, N, 3)) * 5).astype(F32))
    resi = T(rng.standard_normal((1, N, k, 3)).astype(F32))
    resi[:, ::4, k // 2:] = 0.0
    extra = T(rng.standard_normal((1, N, k, ce)).astype(F32)) if ce else None
    got = _tf32_head(comb, resi, extra, layers, k)
    r64 = resi.double()
    h = torch.cat([r64, torch.sqrt((r64 * r64).sum(-1, keepdim=True) + 1e-12)], -1)
    for w, b in layers:
        h = torch.relu(h @ w.double().t() + b.double())
    wgt = torch.softmax(h.amax(-1), -1)[..., None]
    want = comb.double() + (wgt * r64).sum(2)
    if extra is not None:
        want = torch.cat([want, (wgt * extra.double()).sum(2)], -1)
    err = (got.double() - want).abs().max().item()
    one = (_tf32_head(comb, resi, extra, layers, k, split=False).double() - want).abs().max()
    plain = fusion_tail_cuda.fusion_tail_plain(comb, resi, extra, layers)
    assert err <= 2e-6, err
    assert one > 10 * err, (one, err)  # one TF32 product is not enough
    assert (plain.double() - want).abs().max().item() <= 2e-6


# ---- both wrappers on a stub library ------------------------------------------------


@pytest.fixture
def cuda_route(monkeypatch):
    monkeypatch.setattr(_build, "use_kernel", lambda t: not _build._PLAIN.get())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)

    def install(stub):
        monkeypatch.setattr(_build, "library", lambda: stub)
        return stub
    return install


def _ints(ptr, n):
    return np.ctypeslib.as_array((ctypes.c_int32 * n).from_address(ptr)).copy()


@pytest.mark.parametrize("valid", [None, (300, 2000)])
def test_nearest_wrapper_launch_arguments(cuda_route, valid):
    """ops.knn at k = 1 on the forced CUDA route launches pci_nearest once
    (and no list kernel) with the int32 prefix, B, N, S and no measurement
    outputs, counted in nearest_launches; the stub's rows come back as the
    [B, S, 1] results.  k = 3 launches the list kernel, pci_knn."""
    rng = np.random.default_rng(1430)
    B, S, N = 2, 70, 500
    q, x = T((rng.standard_normal((B, S, 3))).astype(F32)), T(
        rng.standard_normal((B, N, 3)).astype(F32))
    vn = None if valid is None else torch.tensor(valid)
    want = knn_cuda.knn_plain(q, x, 1, vn)

    def run(qp, xp, vp, dp, ip, B_, N_, S_, marked, stamps, stream):
        assert (qp, xp, B_, N_, S_) == (q.data_ptr(), x.data_ptr(), B, N, S)
        assert (vp is None) == (valid is None) and marked is None and stamps is None
        if valid is not None:
            assert _ints(vp, B).tolist() == list(valid)
        write(dp, want[0])
        write(ip, want[1])

    def lists(*args):
        write(args[3], torch.zeros(B, S, 3))
        write(args[4], torch.zeros(B, S, 3, dtype=torch.int64))

    stub = cuda_route(StubLibrary(pci_nearest=run, pci_knn=lists))
    before = knn_cuda.nearest_launches.launches
    got = knn(q, x, 1, vn)
    assert [n for n, _ in stub.calls] == ["pci_nearest"]
    assert knn_cuda.nearest_launches.launches - before == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    knn(q, x, 3, vn)
    assert [n for n, _ in stub.calls] == ["pci_nearest", "pci_knn"]
    assert stub.named("pci_knn")[0][8] == 3


def test_nearest_kernel_measurement_arguments(cuda_route):
    """nearest_kernel's marked counter and stamps go to the launch as
    pointers, the stamps shaped by pci_nearest_shape's CTA count; one
    without the other, or stamps of another shape, raise."""
    B, S, N = 1, 600, 900
    q, x = torch.zeros(B, S, 3), torch.ones(B, N, 3)

    def shape(B_, N_, S_, out):
        ctypes.memmove(ctypes.addressof(out), np.int32([4, 8, 132]).ctypes.data, 12)

    seen = []
    stub = cuda_route(StubLibrary(pci_nearest=lambda *a: seen.append(a),
                                  pci_nearest_shape=shape))
    assert knn_cuda.nearest_shape(B, N, S) == (4, 8, 132)
    marked, stamps = torch.zeros(1, dtype=torch.int64), torch.zeros(8, 2, dtype=torch.int64)
    knn_cuda.nearest_kernel(q, x, None, marked, stamps)
    assert seen[0][8:10] == (marked.data_ptr(), stamps.data_ptr())
    with pytest.raises(ValueError):
        knn_cuda.nearest_kernel(q, x, None, marked, None)
    with pytest.raises(ValueError):
        knn_cuda.nearest_kernel(q, x, None, marked, torch.zeros(7, 2, dtype=torch.int64))
    assert len(stub.named("pci_nearest")) == 1


@pytest.mark.parametrize("k, ce", [(32, 0), (9, 1)])
def test_fusion_tail_wrapper_launch_arguments(cuda_route, k, ce):
    """fusion_attention_tail on the forced CUDA route launches
    pci_fusion_tail once with the score MLP split by pack_tf32(chain=True)
    (the buffer the kernel copies into shared memory), the widths 64, 64,
    128, B, N, k and Ce; the stub's rows come back as [B, N, 3 + Ce]."""
    rng = np.random.default_rng(1440 + k)
    B, N = 2, 40
    layers = _build.PackedLayers(_layers(SCORE, 1441))
    comb = T(rng.standard_normal((B, N, 3)).astype(F32))
    resi = T(rng.standard_normal((B, N, k, 3)).astype(F32))
    extra = T(rng.standard_normal((B, N, k, ce)).astype(F32)) if ce else None
    want = fusion_tail_cuda.fusion_tail_plain(comb, resi, extra, layers)
    wtc = _build.pack_tf32(layers, torch.device("cpu"), chain=True)

    def run(cp, rp, xp, wp, h1, h2, h3, op, B_, N_, k_, Ce, stream):
        assert (cp, rp, h1, h2, h3, B_, N_, k_, Ce) == (
            comb.data_ptr(), resi.data_ptr(), 64, 64, 128, B, N, k, ce)
        assert xp == (extra.data_ptr() if ce else 0)
        got = np.ctypeslib.as_array((ctypes.c_float * wtc.numel()).from_address(wp))
        np.testing.assert_array_equal(got, wtc.numpy())
        write(op, want)

    stub = cuda_route(StubLibrary(pci_fusion_tail=run))
    before = fusion_tail_cuda.fusion_tail_kernel.launches
    with torch.inference_mode():
        got = fusion_tail_cuda.fusion_attention_tail(comb, resi, extra, layers)
    assert len(stub.named("pci_fusion_tail")) == 1
    assert fusion_tail_cuda.fusion_tail_kernel.launches - before == 1
    assert got.shape == (B, N, 3 + ce) and torch.equal(got, want)
