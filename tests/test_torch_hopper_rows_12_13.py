"""The redesigned cell-pruned fusion (csrc/fusion_cells.cu) and PointNet++
mid-section (csrc/pn2mid.cu) held on the CPU, where neither kernel runs:
what surrounds them and the rules they follow.

- The fusion kernel's plan (``fusion_cells_cuda.kernel_plan``: the Morton-
  sorted keys as (x, y, z, original id bits) rows, the per-segment chunk
  boxes, each tile's chunk order and bounds) against JAX's Morton sort and
  boxes, bit for bit.
- A numpy emulation of the kernel's tile walk (a tile's 64 queries share
  one chunk order; each query skips a chunk by its round-down box bound and
  drops out once the tile bound passes its larger k_s-th distance; the tile
  stops when a vote finds every query out) gives the plain version's
  neighbours exactly, and stops short of the whole order.
- pn2mid's tensor-core weights (``pn2mid_cuda.pack_tc``) decoded back to
  ``gn_pointmlp_vars``' W (the TF32 hi/lo split, zero padding) and dense
  bias.
- pn2mid's centres on ``stages.cuh:fps_centres``' chains (the one-warp
  chain up to 256 points, the 8-warp group chain above), emulated, equal
  the plain version's FPS chain l1 -> c2 -> c3 -> c4.
- Both wrappers on a stub kernel library (the CUDA route forced): the
  arguments they launch with (the plan, the split weights, the tile
  counter, the stamps) and pn2mid's launches of at most 16 samples.

chip_smoke.py holds the kernels themselves against their plain versions on
the card."""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pci_tpu.ops.pallas_kernels import knn_cells_tpu as jcells
from pci_tpu_torch import nn as tnn
from pci_tpu_torch.ops import index_points
from pci_tpu_torch.ops.cuda_kernels import _build, fusion_cells_cuda, pn2mid_cuda
from pci_tpu_torch.ops.cuda_kernels.fps_cuda import fps_plain
from tests.test_torch_fps_chain import group_chain, warp_chain

F64, F32 = np.float64, np.float32
IMAX = 0x7FFFFFFF
T = torch.from_numpy


def cloud(rng, b, n, scale=1.0):
    return (rng.standard_normal((b, n, 3)) * scale).astype(F32)


# ---- the fusion kernel's plan ---------------------------------------------


@pytest.mark.parametrize("B,n", [(1, 1000), (2, 2048)])
def test_kernel_plan_equals_jax_sort_and_boxes(B, n):
    """kernel_plan's key rows are JAX's Morton-sorted points with the sort
    permutation's ids in the fourth column (pads at +1e15, id N), bit for
    bit; its boxes, orders and bounds are cells_plan's; every tensor is
    contiguous, of the shapes the kernel reads."""
    rng = np.random.default_rng(1200 + n)
    x = cloud(rng, B, n, 3.0)
    x[0, :9] = x[0, 50:59]  # duplicates: equal codes keep their order
    split = torch.tensor([n // 3, n // 2][:B], dtype=torch.int32)
    keys, boxes, order, lbs, torder = fusion_cells_cuda.kernel_plan(T(x), split)
    C, TQ = fusion_cells_cuda.CHUNK, fusion_cells_cuda.TILE
    Np = -(-n // C) * C
    assert keys.shape == (B, Np, 4) and keys.dtype == torch.float32
    assert boxes.shape == (B, Np // C, 4, 4) and order.shape == lbs.shape == (B, Np // TQ, Np // C)
    assert all(t.is_contiguous() for t in (keys, boxes, order, lbs, torder))
    nt = Np // TQ
    assert torder.dtype == torch.int32 and sorted(torder.tolist()) == list(range(B * nt))
    span = []  # the tile boxes' squared diagonals, widest first
    for tt in torder.tolist():
        b, t = divmod(tt, nt)
        rows = keys[b, t * TQ:(t + 1) * TQ]
        rows = rows[rows[:, 3].contiguous().view(torch.int32) < n, :3]
        span.append(float(((rows.amax(0) - rows.amin(0)) ** 2).sum()) if len(rows) else 0.0)
    assert span == sorted(span, reverse=True)
    jp, jperm = jcells._sort_by_morton(jnp.asarray(x), Np - n)
    np.testing.assert_array_equal(keys[..., :3].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(keys[..., 3].contiguous().view(torch.int32).numpy(),
                                  np.asarray(jperm))
    _, _, want_boxes, want_order, want_lbs = fusion_cells_cuda.cells_plan(T(x), split)
    for got, want in ((boxes, want_boxes), (order, want_order), (lbs, want_lbs)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


# ---- the fusion kernel's tile walk, emulated --------------------------------


def rd32(x):
    """float64 values rounded down to float32 (CUDA's __f*_rd)."""
    x = np.asarray(x, F64)
    with np.errstate(over="ignore"):
        r = x.astype(F32)
    up = r.astype(F64) > x
    r[up] = np.nextafter(r[up], F32(-np.inf))
    return r


def box_bound_rd(lo, hi, q):
    """cells.cuh:box_bound_rd for queries ``q [n, 3]``."""
    g = np.maximum(F32(0), np.maximum(rd32(lo.astype(F64) - q), rd32(q.astype(F64) - hi)))
    sq = rd32(g.astype(F64) * g)
    return rd32(rd32(sq[:, 0].astype(F64) + sq[:, 1]).astype(F64) + sq[:, 2])


def sqd(keys, q):
    """sqdist3 ``[n, C]``: (dx*dx + dy*dy) + dz*dz, each op rounded."""
    d = [keys[None, :, c] - q[:, None, c] for c in range(3)]
    return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]


def merge(dl, il, d, i, cap):
    """The ``cap`` least (distance, index) of a list and its candidates
    (lex_insert's order)."""
    dc, ic = np.concatenate([dl, d], 1), np.concatenate([il, i], 1)
    o = np.lexsort((ic, dc), axis=1)[:, :cap]
    return np.take_along_axis(dc, o, 1), np.take_along_axis(ic, o, 1)


def emulate_walk(x, split, k1, k2):
    """csrc/fusion_cells.cu's walk over one batch row ``x [N, 3]`` on
    kernel_plan's plan -> (idx [N, k1 + k2] by original row, unfilled slots
    the row itself; each tile's chunks walked; chunks in the order)."""
    N = x.shape[0]
    keys, boxes, order, lbs, _ = (t[0].numpy() for t in fusion_cells_cuda.kernel_plan(
        T(x)[None], torch.tensor([split], dtype=torch.int32)))
    ids = keys[:, 3].copy().view(np.int32).astype(np.int64)
    C, TQ = fusion_cells_cuda.CHUNK, fusion_cells_cuda.TILE
    out = np.zeros((N, k1 + k2), np.int64)
    walked = []
    for t in range(order.shape[0]):
        s = np.arange(t * TQ, (t + 1) * TQ)
        real = ids[s] < N
        q = keys[s, :3]
        lists = [[np.full((TQ, kk), np.inf, F32), np.full((TQ, kk), IMAX, np.int64)]
                 for kk in (k1, k2)]
        m = 0
        for m in range(order.shape[1] + 1):
            if m == order.shape[1]:
                break
            thd = [lst[0][:, -1] if kk else np.full(TQ, -np.inf, F32)
                   for lst, kk in zip(lists, (k1, k2))]
            live = real & ~(lbs[t, m] > np.maximum(thd[0], thd[1]) * F32(1.00001) + F32(1e-30))
            if not live.any():  # the vote at the barrier that hands over chunk m
                break
            c = order[t, m]
            kid = ids[c * C:(c + 1) * C]
            d = sqd(keys[c * C:(c + 1) * C, :3], q)
            for seg, kk in ((0, k1), (1, k2)):
                lo, hi = boxes[c, 2 * seg, :3], boxes[c, 2 * seg + 1, :3]
                need = live & (kk > 0) & (lo[0] <= hi[0]) & (box_bound_rd(lo, hi, q) <= thd[seg])
                if not kk:
                    continue
                inseg = (kid < split) if seg == 0 else (kid >= split) & (kid < N)
                ok = need[:, None] & inseg[None, :]
                lists[seg] = merge(*lists[seg], np.where(ok, d, np.inf),
                                   np.where(ok, kid[None, :], IMAX), kk)
        walked.append(m)
        il = np.concatenate([lists[0][1], lists[1][1]], 1)
        own = ids[s][:, None]
        out[ids[s][real]] = np.where(il == IMAX, own, il)[real]
    return out, np.array(walked), order.shape[1]


def walk_case(name, seed):
    rng = np.random.default_rng(seed)
    if name == "gauss":
        return cloud(rng, 1, 4096, 10.0)[0], 2048, 16, 16
    if name == "gauss_t02":
        return cloud(rng, 1, 3000, 10.0)[0], 2400, 26, 6
    if name == "far_tiny_b":
        x = cloud(rng, 1, 2048, 2.0)[0]
        x[1900:] = x[1900:] * 0.1 + 80.0
        return x, 1900, 5, 3
    if name == "split_0":
        return cloud(rng, 1, 1024, 3.0)[0], 0, 0, 32
    if name == "duplicates":
        x = cloud(rng, 1, 2048, 3.0)[0]
        x[1024:] = x[:1024]
        x[100:164] = x[0]
        return x, 1024, 16, 16
    raise ValueError(name)


WALK_CASES = ["gauss", "gauss_t02", "far_tiny_b", "split_0", "duplicates"]


@pytest.mark.parametrize("name", WALK_CASES)
def test_emulated_tile_walk_gives_plain_neighbours(name):
    """The tile walk's slots equal fusion_cells_plain's exactly (the flat
    kernel's neighbours, ties to the lower index, unfilled slots the row
    itself); on the spread clouds tiles stop before their order ends."""
    x, split, k1, k2 = walk_case(name, 1210 + WALK_CASES.index(name))
    N = x.shape[0]
    got, walked, nc = emulate_walk(x, split, k1, k2)
    want, _ = fusion_cells_cuda.fusion_cells_plain(
        T(x)[None], torch.tensor([[split, N]]), torch.tensor([[k1, k2]]), k1 + k2)
    np.testing.assert_array_equal(got, want[0].numpy())
    print(f"{name}: chunks walked a tile mean {walked.mean():.1f} max {walked.max()} of {nc}")
    if name in ("gauss", "gauss_t02"):
        assert walked.min() < nc and walked.mean() < nc


# ---- pn2mid's tensor-core weights and centres --------------------------------


@pytest.fixture(scope="module")
def pn2_groups():
    torch.manual_seed(12)
    module = tnn.Pointnet2FeatureAbstract(32).eval()
    return module._mid_groups()


def test_pn2mid_tc_pack_round_trip(pn2_groups):
    """pack_tc laid out layer after layer in group order: each layer's
    fragments decode to W's TF32 hi and lo halves (hi + lo within 2^-21 of
    W, hi = cvt.rna(W)), zeros in the padding, then the dense bias padded
    to N8; the buffer is PackedGroups' and has no other floats."""
    wtc = pn2_groups.wtc
    lane = torch.arange(32)
    g, tq = lane // 4, lane % 4
    off = 0
    for group in pn2_groups:
        for w, aux in group:
            cin, cout = w.shape
            k8, n8 = -(-cin // 8) * 8, -(-cout // 8) * 8
            frag = wtc[off:off + k8 * n8 * 2].reshape(k8 // 8, n8 // 8, 32, 4)
            off += k8 * n8 * 2
            hi = torch.zeros(k8, n8)
            lo = torch.zeros(k8, n8)
            kt = torch.arange(k8 // 8)[:, None, None] * 8
            col = torch.arange(n8 // 8)[None, :, None] * 8 + g
            for r, ih, il in ((kt + tq, 0, 2), (kt + tq + 4, 1, 3)):
                hi[r, col] = frag[..., ih]
                lo[r, col] = frag[..., il]
            W = torch.zeros(k8, n8)
            W[:cin, :cout] = w
            torch.testing.assert_close(hi, _build.tf32_round(W), atol=0, rtol=0)
            assert ((hi + lo) - W).abs().max() <= 2.0 ** -21 * W.abs().max()
            assert not hi[cin:].any() and not hi[:, cout:].any() and not lo[cin:].any()
            bias = wtc[off:off + n8]
            off += n8
            torch.testing.assert_close(bias[:cout], aux[0], atol=0, rtol=0)
            assert not bias[cout:].any()
    assert off == wtc.numel()


def _fps_centres(x: np.ndarray, npick: int) -> np.ndarray:
    """stages.cuh:fps_centres' picks: the one-warp chain up to 256 points,
    the group chain of the block's 8 warps above."""
    return warp_chain(x, npick) if x.shape[0] <= 256 else group_chain(x, npick, 0, 8)


@pytest.mark.parametrize("n1", [1024, 700, 2048])
def test_pn2mid_centres_on_fps_chains(n1):
    """The kernel's three FPS picks (l1 -> c2 -> c3 -> c4, each from index 0
    over the previous level's centres) on fps_centres' chains equal
    pn2mid_plain's chain of fps_plain picks, bit for bit."""
    rng = np.random.default_rng(1220 + n1)
    x = (rng.standard_normal((n1, 3)) * 0.5).astype(F32)
    x[:40] = x[40:80]  # duplicate points
    got, src = [], x
    want, wsrc = [], T(x)[None]
    start = torch.zeros(1, dtype=torch.long)
    for s in pn2mid_cuda.S_LIST:
        idx = _fps_centres(src, s)
        src = src[idx]
        got.append(src)
        wsrc = index_points(wsrc, fps_plain(wsrc, s, start, 1))
        want.append(wsrc[0].numpy())
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_, w_)


# ---- the wrappers' launches, on a stub library --------------------------------


class StubLibrary:
    """Stands in for the kernel library: every C entry called is recorded;
    the ones in ``impl`` run and return 0, any other fails the test."""

    def __init__(self, **impl):
        self.calls = []
        self.impl = impl

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            if name not in self.impl:
                raise AssertionError(f"unexpected launch of {name}")
            self.impl[name](*args)
            return 0
        return entry

    def named(self, name):
        return [args for n, args in self.calls if n == name]


def write(ptr: int, t: torch.Tensor) -> None:
    t = t.contiguous()
    ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())


def read_i32(ptr: int) -> int:
    return ctypes.c_int32.from_address(ptr).value


@pytest.fixture
def cuda_route(monkeypatch):
    """CPU tensors routed as CUDA ones, the prep's graph replaced by the
    eager plan; returns a function that installs a stub library."""
    monkeypatch.setattr(_build, "use_kernel", lambda t: not _build._PLAIN.get())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(fusion_cells_cuda, "kernel_plan_graphed", fusion_cells_cuda.kernel_plan)

    def install(stub):
        monkeypatch.setattr(_build, "library", lambda: stub)
        return stub
    return install


@pytest.mark.parametrize("oneshot", [True, False])
def test_fusion_cells_wrapper_launch_arguments(cuda_route, oneshot):
    """fusion_cells_attention / fusion_cells_resi_knn on the forced CUDA
    route launch once with the plan's tensors (keys [B, Np, 4], chunks of
    CHUNK keys, tiles of TILE queries), the score MLP split in the chained
    TF32 layout (one-shot; null in residual mode), no payload, a zeroed tile
    counter and no stamps; the stub writes the plain version's result, which comes back
    unchanged."""
    rng = np.random.default_rng(1230 + oneshot)
    B, N, k = 2, 700, 32
    x = T(cloud(rng, B, N, 2.0))
    seg, bud = torch.tensor([[300, N], [450, N]]), torch.tensor([[20, 12], [26, 6]])
    layers = _build.PackedLayers([
        (T((rng.standard_normal((o, i)) / np.sqrt(i)).astype(F32)),
         T((0.1 * rng.standard_normal(o)).astype(F32))) for i, o in ((4, 64), (64, 64), (64, 128))])
    with _build.plain_versions():
        want = fusion_cells_cuda.fusion_cells_plain(x, seg, bud, k, layers if oneshot else None)

    def run(pts, keys, boxes, order, lbs, torder, segp, wtc, h1, h2, h3, payload, Cp, out,
            out_i, out_r, scanned, stamps, nxt, B_, N_, Np, C, TQ, k_, stream):
        assert (B_, N_, Np, C, TQ, k_) == (B, N, 768, fusion_cells_cuda.CHUNK,
                                           fusion_cells_cuda.TILE, k)
        assert pts == x.data_ptr() and scanned is None and stamps is None
        assert payload is None and Cp == 0
        assert read_i32(nxt) == 0
        if oneshot:
            assert wtc == layers.tf32(chain=True).data_ptr() and (h1, h2, h3) == (64, 64, 128)
            write(out, want)
        else:
            assert wtc is None and out is None
            write(out_i, want[0])
            write(out_r, want[1])

    stub = cuda_route(StubLibrary(pci_fusion_cells=run))
    before = fusion_cells_cuda.fusion_cells_kernel.launches
    with torch.inference_mode():
        got = (fusion_cells_cuda.fusion_cells_attention(x, seg, bud, layers, k) if oneshot
               else fusion_cells_cuda.fusion_cells_resi_knn(x, seg, bud, k))
    assert len(stub.named("pci_fusion_cells")) == 1
    assert fusion_cells_cuda.fusion_cells_kernel.launches - before == 1
    for g_, w_ in zip(got if not oneshot else [got], want if not oneshot else [want]):
        torch.testing.assert_close(g_, w_, atol=0, rtol=0)


def test_pn2mid_wrapper_launch_arguments(cuda_route, pn2_groups):
    """pn2mid_fused over 17 samples: launches of 16 and 1, each with the
    module's packed buffers (the fp32 layers and the tensor-core pack) and
    the stamps pointer a measurement launch passes (null otherwise); the
    stub writes the plain version's rows, assembled in order."""
    rng = np.random.default_rng(1240)
    B, N1, C1 = 17, 300, 96
    x = T((0.3 * rng.standard_normal((B, N1, 3))).astype(F32))
    f = T(np.maximum(rng.standard_normal((B, N1, C1)), 0).astype(F32))
    sample = x[0].numel() * x.element_size()

    def scratch(*args):
        args[-1][0], args[-1][1] = 1, 1

    def run(xp, fp, wbuf, dims, doff, nl, fs, ds, out, bar, B_, N_, C_, S, ks, r2, wtc,
            stamps, stream):
        assert wbuf == pn2_groups.buf.data_ptr() and wtc == pn2_groups.wtc.data_ptr()
        s = (xp - x.data_ptr()) // sample
        with _build.plain_versions():
            write(out, pn2mid_cuda.pn2mid_plain(x[s:s + B_], f[s:s + B_], pn2_groups))

    stub = cuda_route(StubLibrary(pci_pn2mid_scratch=scratch, pci_pn2mid=run))
    with torch.inference_mode():
        got = pn2mid_cuda.pn2mid_fused(x, f, pn2_groups)
        stamps = torch.zeros((4, len(pn2mid_cuda.PHASES), pn2mid_cuda.STAMPS), dtype=torch.int64)
        pn2mid_cuda.pn2mid_kernel(x[:1], f[:1], pn2_groups, pn2mid_cuda.S_LIST,
                                  pn2mid_cuda.RADII, pn2mid_cuda.KS, stamps=stamps)
    launches = stub.named("pci_pn2mid")
    assert [a[10] for a in launches] == [16, 1, 1]
    assert [a[17] for a in launches] == [None, None, stamps.data_ptr()]
    with _build.plain_versions():
        want = pn2mid_cuda.pn2mid_plain(x, f, pn2_groups)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
