"""The CUDA routes of five callers at shapes their kernels once refused,
where the JAX package runs a kernel or XLA: pn2mid over more than 16
samples (split into launches of at most 16), ``ops.knn`` on clouds that
are not xyz or with k in (64, 128] (the plain version, or the flat
kernel's local-memory list), ``ops.fps`` over more than 16,384 points a
chain (the long-chain kernel), ``PointsFusion`` past k = 128 (the kNN's
plain version, no kNN launch; at eval the attention tail, which takes any
k; at k = 32, 48 and 64 the fusion kernels, past 32 their
two-slots-a-lane instantiations) and ``PointsFusionMulti`` (one residual
kNN launch), and ``TransformerLayer`` at widths its attention
kernels do not take (d_model 20 and 256: the plain versions, no launch;
in training both directions decided at the forward), and the per-stage
set-conv (row 2: FlowNet3D's stage widths launch ``pci_setconv``, whose
tiles both run on the tensor cores, with ``_build.pack_tf32``'s weights; nsample past 128 or a
layer past 1,024 channels, the plain version, no launch); on the cells route (its size gate
lowered for the CPU), ``PointsFusion`` at k = 48 and 64 on the cells
kernel and ``PointsFusionMulti`` by segments and gradient (F = 3 at eval:
three masked passes of the box-pruned kNN; F = 2: the cells kernel's
residual mode; F = 3 in training or under a gradient: row 4b).

The CPU has no kernel, so each test forces the CUDA route
(``_build.use_kernel`` patched true) and replaces the kernel library by a
stub whose C entries record their arguments and compute the kernel's
function with its plain version, writing the result through the output
pointers as the kernel would.  What a test holds is the wrapper's route,
split and launch arguments, and the assembled result against the plain
version on the whole input and against the JAX package.  chip_smoke.py
holds the kernels themselves at these shapes on the card."""

from __future__ import annotations

import contextlib
import copy
import ctypes
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pci_tpu.ops import fps as jax_fps
from pci_tpu.ops import knn as jax_knn
from pci_tpu_torch import nn as tnn
from pci_tpu_torch.ops import fps, knn
from pci_tpu_torch.ops.cuda_kernels import _build
from pci_tpu_torch.ops.cuda_kernels import (
    attention_cuda,
    fps_cuda,
    fusion_knn_cuda,
    knn_cuda,
    pn2mid_cuda,
    setconv_cuda,
)


class StubLibrary:
    """Stands in for the kernel library: every C entry called is recorded
    with its arguments; the ones in ``impl`` run it and return 0, any other
    fails the test."""

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
    """``t``'s bytes to the output pointer ``ptr`` (what a kernel stores)."""
    t = t.contiguous()
    ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())


def read(ptr: int, shape, ctype=ctypes.c_float) -> torch.Tensor:
    """A copy of the ``shape`` array at the input pointer ``ptr`` (what a
    kernel reads)."""
    n = int(np.prod(shape))
    return torch.from_numpy(np.ctypeslib.as_array((ctype * n).from_address(ptr))
                            .reshape(shape).copy())


def knn_stub(qp, pp, vn, dp, ip, B, N, S, k, stream):
    """``pci_knn`` (k >= 2) by the plain kNN on the arrays it is given."""
    assert vn is None
    d, i = knn_cuda.knn_plain(read(qp, (B, S, 3)), read(pp, (B, N, 3)), k)
    write(dp, d)
    write(ip, i)


@pytest.fixture
def cuda_route(monkeypatch):
    """CPU tensors routed as CUDA ones; returns a function that installs a
    stub library."""
    monkeypatch.setattr(_build, "use_kernel", lambda t: not _build._PLAIN.get())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)

    def install(stub):
        monkeypatch.setattr(_build, "library", lambda: stub)
        return stub
    return install


# ---- pn2mid over more than 16 samples -----------------------------------------


def test_pn2mid_splits_batches_over_16(cuda_route):
    """17 samples run as launches of 16 and 1 (pn2mid.cu's PN_MAXB sizes its
    per-sample GroupNorm statistics; every statistic is per sample, so the
    split is exact), the chunks concatenated in order: equal to the plain
    version on the whole batch, within the rounding its batched products
    differ by (1e-5 of the output's largest magnitude)."""
    torch.manual_seed(0)
    module = tnn.Pointnet2FeatureAbstract(32).eval()
    groups = module._mid_groups()
    rng = np.random.default_rng(801)
    B, N1, C1 = 17, 300, 96
    x = torch.from_numpy((0.3 * rng.standard_normal((B, N1, 3))).astype(np.float32))
    f = torch.from_numpy(np.maximum(rng.standard_normal((B, N1, C1)), 0).astype(np.float32))
    sample = x[0].numel() * x.element_size()

    def scratch(*args):
        args[-1][0], args[-1][1] = 1, 1

    def run(xp, fp, *args):
        s, n = (xp - x.data_ptr()) // sample, args[8]  # the chunk's first sample and size
        assert fp == f[s].data_ptr()
        with _build.plain_versions():
            write(args[6], pn2mid_cuda.pn2mid_plain(x[s:s + n], f[s:s + n], groups))

    stub = cuda_route(StubLibrary(pci_pn2mid_scratch=scratch, pci_pn2mid=run))
    before = pn2mid_cuda.pn2mid_kernel.launches
    with torch.inference_mode():
        got = pn2mid_cuda.pn2mid_fused(x, f, groups)
    assert [a[10] for a in stub.named("pci_pn2mid")] == [16, 1]  # B
    assert pn2mid_cuda.pn2mid_kernel.launches - before == 2
    with torch.inference_mode(), _build.plain_versions():
        want = pn2mid_cuda.pn2mid_plain(x, f, groups)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# ---- ops.knn by shape -----------------------------------------------------------


def _cloud(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _jax_knn(query, points, k):
    d, i = jax_knn(jnp.asarray(query.numpy()), jnp.asarray(points.numpy()), k, exact=True)
    return np.asarray(d), np.asarray(i)


@pytest.mark.parametrize("C, k", [(4, 8), (3, 200)])
def test_knn_routes_plain_outside_the_kernels_shapes(cuda_route, C, k):
    """A 4-channel cloud, or k above 128, launches nothing: the plain
    version, as the JAX op takes XLA there; indices equal JAX's exact kNN,
    distances within 1e-5 of its."""
    rng = np.random.default_rng(802 + C)
    q, p = _cloud(rng, 2, 50, C), _cloud(rng, 2, 300, C)
    stub = cuda_route(StubLibrary())
    dist, idx = knn(q, p, k)
    assert stub.calls == []
    want = knn_cuda.knn_plain(q, p, k)
    assert torch.equal(idx, want[1]) and torch.equal(dist, want[0])
    jd, ji = _jax_knn(q, p, k)
    np.testing.assert_array_equal(idx.numpy(), ji)
    np.testing.assert_allclose(dist.numpy(), jd, rtol=0, atol=1e-5)


def test_knn_k96_takes_the_flat_kernel(cuda_route):
    """k = 96 on xyz clouds of 5,000 keys (the JAX op's kernel shapes: xyz,
    k <= 128) launches the flat kernel with k = 96, no longer refused at
    k > 64: distances equal the plain version's, indices JAX's exact kNN
    (its distances, from |q|^2 + |p|^2 - 2 q.p, within 1e-5)."""
    rng = np.random.default_rng(804)
    q, p = _cloud(rng, 1, 40, 3), _cloud(rng, 1, 5000, 3)

    def run(qp, pp, vn, dp, ip, B, N, S, k, stream):
        assert (qp, pp, vn, B, N, S, k) == (q.data_ptr(), p.data_ptr(), None, 1, 5000, 40, 96)
        d, i = knn_cuda.knn_plain(q, p, k)
        write(dp, d)
        write(ip, i)

    stub = cuda_route(StubLibrary(pci_knn=run))
    dist, idx = knn(q, p, 96)
    assert len(stub.named("pci_knn")) == 1
    assert torch.equal(dist, knn_cuda.knn_plain(q, p, 96)[0])
    jd, ji = _jax_knn(q, p, 96)
    np.testing.assert_array_equal(idx.numpy(), ji)
    np.testing.assert_allclose(dist.numpy(), jd, rtol=0, atol=1e-5)


# ---- ops.fps over long chains -----------------------------------------------------


@pytest.mark.parametrize("N, exact, entry", [(20000, True, "pci_fps_long"),
                                             (16384, True, "pci_fps"),
                                             (131080, False, "pci_fps_long")])
def test_fps_long_chains_take_the_long_chain_kernel(cuda_route, N, exact, entry):
    """An exact FPS over more than 16,384 points, or interleaved chains of
    more than 16,384 points each, launch fps_long_kernel with a scratch of
    5 floats a point; 16,384 points a chain keep the block chain.  Picks
    equal the plain version's and, for the exact case, JAX's exact FPS."""
    rng = np.random.default_rng(805)
    x = _cloud(rng, 1, N, 3)
    npoint = 64 if exact else 256

    def run(xp, sp, op, *args):
        assert xp == x.data_ptr()
        if entry == "pci_fps_long":
            scratch, B, n, m, P = args[0], *args[1:5]
        else:
            B, n, m, P = args[:4]
        assert (B, n, m) == (1, N, npoint)
        if entry == "pci_fps_long":
            assert scratch is not None
        write(op, fps_cuda.fps_plain(x, m, torch.zeros(1, dtype=torch.int32), P))

    stub = cuda_route(StubLibrary(**{entry: run}))
    got = fps(x, npoint, exact=exact)
    assert [n for n, _ in stub.calls] == [entry]
    P = stub.calls[0][1][-2]
    assert P == (1 if exact else 8) and (-(-N // P) > fps_cuda.CHAIN_MAX) == (entry != "pci_fps")
    want = fps_cuda.fps_plain(x, npoint, torch.zeros(1, dtype=torch.int32), P)
    assert torch.equal(got.to(torch.int32), want)
    if exact:
        jw = np.asarray(jax_fps(jnp.asarray(x.numpy()), npoint))
        np.testing.assert_array_equal(got.numpy(), jw)


# ---- PointsFusion past the fusion kernels' k ---------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_fusion(seed: int, N: int, k: int):
    """Two seeded clouds, two permutations and t for PointsFusion, the JAX
    module, its variables (non-trivial BatchNorm statistics) as numpy, and
    its eval rows at ``k`` with those permutations."""
    import jax

    import pci_tpu.nn.fusion as jfusion

    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((1, N, 3)) * 2).astype(np.float32)
    b = a + 0.2 * rng.standard_normal((1, N, 3)).astype(np.float32)
    perms = [rng.permutation(N)[None].astype(np.int32) for _ in range(2)]
    tt = np.array([0.3], np.float32)
    jmod = jfusion.PointsFusion((64, 64, 128))
    v = jax.jit(lambda a, b, tt: jmod.init({"params": jax.random.key(0),
                                            "sample": jax.random.key(1)}, a, b, 32, tt))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(tt))
    v = jax.tree_util.tree_map(
        lambda x: np.asarray(x + 0.01 * jnp.arange(x.size, dtype=x.dtype) if x.ndim == 1 else x), v)
    draws = iter([jnp.asarray(p) for p in perms])
    saved = jfusion._random_perms
    jfusion._random_perms = lambda key, B, n: next(draws)
    try:  # one compiled call (the draws are its constants)
        want = np.asarray(jax.jit(lambda v, a, b, tt: jmod.apply(
            v, a, b, k, tt, rngs={"sample": jax.random.key(2)}))(
            v, jnp.asarray(a), jnp.asarray(b), jnp.asarray(tt)))
    finally:
        jfusion._random_perms = saved
    return (a, b, tt, perms), v, want


def _fusion_inputs(seed: int, k: int, N: int = 1024):
    """:func:`_jax_fusion`'s inputs and JAX rows, and a port module holding
    its variables."""
    from pci_tpu_torch.convert import flax_to_state_dict

    inputs, v, want = _jax_fusion(seed, N, k)
    mod = tnn.PointsFusion()
    mod.load_state_dict(flax_to_state_dict(v))
    return inputs, want, mod


@pytest.mark.parametrize("mode", ["eval_oneshot", "eval_two_kernels", "train"])
def test_points_fusion_past_k32_launches_nothing(cuda_route, monkeypatch, mode):
    """PointsFusion at k = 160, past the flat fusion kernels' k <= 128, on
    the forced CUDA route (each eval gate forced as the mode says) launches
    no kNN kernel: at eval the kNN's plain version, then the attention tail
    once at k = 160 (the TPU's XLA kNN and its tail kernel; the stub writes
    the tail's plain version), its rows equal to the JAX PointsFusion's at
    k = 160 on the same weights and permutations (its XLA route; 1e-5, the
    cells route test's tolerance); in training nothing launches (the stub
    fails any) and its rows and the gradients into both clouds through
    FusionResiKnn equal the plain route's bit for bit."""
    import pci_tpu_torch.nn.fusion as tfusion
    from pci_tpu_torch.ops.cuda_kernels.fusion_tail_cuda import fusion_tail_plain

    monkeypatch.setattr(tfusion, "_fusion_oneshot_ok",
                        lambda train, x: mode == "eval_oneshot" and not train)
    k = 160
    (a, b, tt, perms), want, mod = _fusion_inputs(806, k)
    tp = tuple(torch.from_numpy(p) for p in perms)

    def tail(comb, res, extra, wbuf, h1, h2, h3, out, B, N, k_, Ce, stream):
        assert (k_, Ce, extra) == (k, 0, 0)
        write(out, fusion_tail_plain(read(comb, (B, N, 3)), read(res, (B, N, k_, 3)), None,
                                     mod.mlp.folded()))

    stub = cuda_route(StubLibrary(**({} if mode == "train" else {"pci_fusion_tail": tail})))
    if mode != "train":
        with torch.inference_mode():
            got = mod.eval()(*(torch.from_numpy(x) for x in (a, b)), k, torch.from_numpy(tt),
                             perms=tp).numpy()
        assert [n for n, _ in stub.calls] == ["pci_fusion_tail"]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        return
    G = torch.from_numpy(np.random.default_rng(807).standard_normal((1, a.shape[1], 3))
                         .astype(np.float32))
    outs = []
    for plain in (False, True):
        m = copy.deepcopy(mod).train()
        x1, x2 = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
        with _build.plain_versions() if plain else contextlib.nullcontext():
            out = m(x1, x2, k, torch.from_numpy(tt), perms=tp)
            (out * G).sum().backward()
        outs.append((out.detach(), x1.grad, x2.grad))
    assert stub.calls == []
    for got, want in zip(*outs):
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode, entries", [
    ("eval_oneshot", ["pci_fusion"]),
    ("eval_two_kernels", ["pci_fusion_resi", "pci_fusion_tail"]),
    ("train", ["pci_fusion_resi"]),
])
def test_points_fusion_at_k32_takes_the_kernels(cuda_route, monkeypatch, mode, entries):
    """At k = 32 the same forced route still launches the fusion kernels:
    the one-shot kernel at eval, the residual kNN and the tail with
    one-shot off, the residual kNN in training (the stubs write the plain
    versions' results)."""
    _fusion_takes_the_kernels(cuda_route, monkeypatch, mode, entries, 32)


@pytest.mark.parametrize("k", [48, 64])
@pytest.mark.parametrize("mode, entries", [
    ("eval_oneshot", ["pci_fusion64"]),
    ("eval_two_kernels", ["pci_fusion_resi", "pci_fusion_tail"]),
    ("train", ["pci_fusion_resi"]),
])
def test_points_fusion_at_k48_k64_takes_the_kernels(cuda_route, monkeypatch, mode, entries, k):
    """At k = 48 and 64 (PointINet2's ring fusions) the forced route
    launches the fusion kernels' k <= 64 instantiations: the one-shot
    kernel's own entry at eval, the residual kNN and the tail (their k
    chooses the instantiation) with one-shot off, the residual kNN in
    training; the rows equal the plain route's."""
    _fusion_takes_the_kernels(cuda_route, monkeypatch, mode, entries, k)


def _fusion_takes_the_kernels(cuda_route, monkeypatch, mode, entries, k):
    import pci_tpu_torch.nn.fusion as tfusion
    from pci_tpu_torch.ops.cuda_kernels import fusion_tail_cuda

    monkeypatch.setattr(tfusion, "_fusion_oneshot_ok",
                        lambda train, x: mode == "eval_oneshot" and not train)
    from pci_tpu_torch.serving import init_weights

    rng = np.random.default_rng(808)
    N = 256
    a = (rng.standard_normal((1, N, 3)) * 2).astype(np.float32)
    b = a + 0.2 * rng.standard_normal((1, N, 3)).astype(np.float32)
    perms = [rng.permutation(N)[None] for _ in range(2)]
    tt = np.array([0.3], np.float32)
    mod = tnn.PointsFusion()
    init_weights(mod, 809)
    tp = tuple(torch.from_numpy(p) for p in perms)
    seen = {}

    def resi(pts, ends, buds, F, oi, orr, B, N, k_, parts, stamps, stream):
        assert k_ == k
        x = read(pts, (B, N, 3))
        e, bu = read(ends, (B, F), ctypes.c_int32), read(buds, (B, F), ctypes.c_int32)
        i, r = fusion_knn_cuda.fusion_resi_plain(x, e, bu, k_)
        seen["resi"] = (x, i, r)
        write(oi, i)
        write(orr, r)

    def tail(comb, res, extra, wbuf, h1, h2, h3, out, B, N, k_, Ce, stream):
        assert k_ == k
        x, _, r = seen["resi"]
        write(out, fusion_tail_cuda.fusion_tail_plain(x, r, None, mod.mlp.folded()))

    def oneshot(pts, seg, wtc, h1, h2, h3, payload, Cp, out, B, N, stream):
        assert payload is None and Cp == 0  # PointsFusion carries no payload
        x = read(pts, (B, N, 3))
        s4 = read(seg, (B, 4), ctypes.c_int32)
        assert int(s4[0, 2] + s4[0, 3]) == k
        write(out, fusion_knn_cuda.fusion_plain(x, s4[:, :2], s4[:, 2:], mod.mlp.folded(), k))

    stub = cuda_route(StubLibrary(pci_fusion_resi=resi, pci_fusion_tail=tail,
                                  **{"pci_fusion" if k <= 32 else "pci_fusion64": oneshot}))
    x1, x2 = torch.from_numpy(a), torch.from_numpy(b)
    if mode == "train":
        got = mod.train()(x1.requires_grad_(), x2.requires_grad_(), k, torch.from_numpy(tt),
                          perms=tp)
        got.sum().backward()
    else:
        with torch.inference_mode():
            got = mod.eval()(x1, x2, k, torch.from_numpy(tt), perms=tp)
    assert [n for n, _ in stub.calls] == entries
    with _build.plain_versions(), (torch.inference_mode() if mode != "train"
                                   else contextlib.nullcontext()):
        want = copy.deepcopy(mod)(torch.from_numpy(a), torch.from_numpy(b), k,
                                  torch.from_numpy(tt), perms=tp)
    torch.testing.assert_close(got.detach(), want.detach(), atol=1e-6, rtol=1e-6)


def test_points_fusion_multi_launches_one_residual_knn(cuda_route):
    """PointsFusionMulti over three clouds at k = 64 (PointINet2's fusion2)
    launches the residual kNN once, its three segments and Wnet-sized
    budgets as ``_multi_budgets`` gives them, then its GroupNorm head in
    PyTorch; the rows equal the plain route's."""
    from pci_tpu_torch.nn.fusion import _multi_budgets
    from pci_tpu_torch.serving import init_weights

    rng = np.random.default_rng(810)
    N, k = 512, 64
    clouds = [torch.from_numpy((rng.standard_normal((1, N, 3)) * 2).astype(np.float32))
              for _ in range(3)]
    perms = [torch.from_numpy(rng.permutation(N)[None]) for _ in range(3)]
    weights = torch.softmax(torch.from_numpy(rng.standard_normal((1, 12)).astype(np.float32)), -1)
    mod = tnn.PointsFusionMulti()
    init_weights(mod, 811)
    n_all, k_all = _multi_budgets(N, k, weights[:, :2])

    def resi(pts, ends, buds, F, oi, orr, B, N_, k_, parts, stamps, stream):
        e, bu = read(ends, (B, F), ctypes.c_int32), read(buds, (B, F), ctypes.c_int32)
        assert (F, k_) == (3, k) and torch.equal(e, torch.cumsum(n_all, 1).to(torch.int32))
        assert torch.equal(bu, k_all)
        i, r = fusion_knn_cuda.fusion_resi_plain(read(pts, (B, N_, 3)), e, bu, k_)
        write(oi, i)
        write(orr, r)

    stub = cuda_route(StubLibrary(pci_fusion_resi=resi))
    with torch.inference_mode():
        got = mod.eval()(clouds, k, weights, perms=perms)
        assert [n for n, _ in stub.calls] == ["pci_fusion_resi"]
        with _build.plain_versions():
            want = mod(clouds, k, weights, perms=perms)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


# ---- the cell-pruned routes at k <= 64 ------------------------------------------


def cells_gate(monkeypatch, n_min: int = 256):
    """The fusion's cells gate as on the card (k <= 64, in training two
    segments only) from ``n_min`` points on (the plain versions at 32,768
    points would take minutes on the CPU), and each plan built by torch
    ops directly (the CUDA graphs need a card)."""
    import pci_tpu_torch.nn.fusion as tfusion
    from pci_tpu_torch.ops.cuda_kernels import fusion_cells_cuda

    gate = tfusion._cells_route_ok
    monkeypatch.setattr(tfusion, "_cells_route_ok", lambda p, k, train, n_seg=2: p.shape[-2] >= n_min
                        and gate(types.SimpleNamespace(is_cuda=True, shape=(1, 1 << 20, 3)), k,
                                 train, n_seg))
    monkeypatch.setattr(fusion_cells_cuda, "kernel_plan_graphed", fusion_cells_cuda.kernel_plan)
    monkeypatch.setattr(knn_cuda, "knn_cells_plan_graphed",
                        lambda q, p, self_knn, key_valid=None: knn_cuda.knn_cells_plan(
                            q, p, self_knn, key_valid=key_valid))


def fusion_cells_stub(layers, seen=None):
    """``pci_fusion_cells`` by the plain versions: the one-shot rows (with
    ``layers``) or the residual kNN, from the cloud and (N1, N, k1, k2)."""
    def run(pts, keys, boxes, order, lbs, torder, seg, wtc, h1, h2, h3, payload, Cp, out,
            out_i, out_r, scanned, stamps, nxt, B, N, Np, C, TQ, k, stream):
        x = read(pts, (B, N, 3))
        s4 = read(seg, (B, 4), ctypes.c_int32)
        if seen is not None:
            seen.append((int(k), wtc is not None))
        if wtc is not None:
            write(out, fusion_knn_cuda.fusion_plain(x, s4[:, :2], s4[:, 2:], layers, k))
            return
        i, r = fusion_knn_cuda.fusion_resi_plain(x, s4[:, :2], s4[:, 2:], k)
        write(out_i, i)
        write(out_r, r)
    return run


def knn_cells_seg_stub(seen):
    """``pci_knn_cells_seg`` as the kernel writes: the key mask read back
    from the plan's NaN rows, each row's budget capped at k and its slots
    [col0, col0 + budget) from the masked plain kNN (idx, distances,
    residuals), with ``fill`` the rest of the row as the row itself;
    nothing else of the output is touched."""
    def run(keys, qry, boxes, order, lbs, kpts, bud, col0, out_d, out_i, out_r, scanned,
            B, S, N, Np, Sp, C, TQ, k, ks, fill, stream):
        rows = read(keys, (B, Np, 4))
        ids = rows[..., 3].contiguous().view(torch.int32).long()
        kv = torch.zeros(B, N, dtype=torch.bool)
        for b in range(B):
            ok = ~torch.isnan(rows[b, :, 0])
            kv[b, ids[b][ok]] = True
        x = read(kpts, (B, N, 3))
        budgets = read(bud, (B,), ctypes.c_int32)
        c0 = read(col0, (B,), ctypes.c_int32)
        seen.append((kv, budgets, c0, bool(fill)))
        oi, orr = read(out_i, (B, S, ks), ctypes.c_int64), read(out_r, (B, S, ks, 3))
        for b in range(B):
            kq, c = min(int(budgets[b]), k), int(c0[b])
            if kq:
                _, i, r = knn_cuda.knn_cells_plain(x[b:b + 1], x[b:b + 1], kq, kv[b:b + 1], True)
                oi[b, :, c:c + kq], orr[b, :, c:c + kq] = i[0], r[0]
            if fill:
                oi[b, :, c + kq:] = torch.arange(S)[:, None]
                orr[b, :, c + kq:] = 0.0
        write(out_i, oi)
        write(out_r, orr)
    return run


@pytest.mark.parametrize("k", [48, 64])
@pytest.mark.parametrize("mode, entries", [
    ("eval_oneshot", ["pci_fusion_cells"]),
    ("eval_two_kernels", ["pci_fusion_cells", "pci_fusion_tail"]),
    ("train", ["pci_fusion_cells"]),
])
def test_points_fusion_at_k48_k64_takes_the_cells_kernel(cuda_route, monkeypatch, mode,
                                                         entries, k):
    """At k = 48 and 64 on the cells route (PointINet2's rings at 32,768
    points and more; the gate lowered to 256 points here) PointsFusion
    launches the cells kernel: one-shot at eval, residual then the tail
    with one-shot off, residual in training, each with its k; the rows
    equal the plain route's."""
    import pci_tpu_torch.nn.fusion as tfusion
    from pci_tpu_torch.ops.cuda_kernels import fusion_tail_cuda
    from pci_tpu_torch.serving import init_weights

    cells_gate(monkeypatch)
    monkeypatch.setattr(tfusion, "_fusion_oneshot_ok",
                        lambda train, x: mode == "eval_oneshot" and not train)
    rng = np.random.default_rng(816)
    N = 512
    a = (rng.standard_normal((1, N, 3)) * 2).astype(np.float32)
    b = a + 0.2 * rng.standard_normal((1, N, 3)).astype(np.float32)
    tp = tuple(torch.from_numpy(rng.permutation(N)[None]) for _ in range(2))
    tt = torch.tensor([0.3])
    mod = tnn.PointsFusion()
    init_weights(mod, 817)
    seen = []

    def tail(comb, res, extra, wbuf, h1, h2, h3, out, B, N_, k_, Ce, stream):
        assert k_ == k
        write(out, fusion_tail_cuda.fusion_tail_plain(read(comb, (B, N_, 3)),
                                                      read(res, (B, N_, k_, 3)), None,
                                                      mod.mlp.folded()))

    layers = copy.deepcopy(mod).eval().mlp.folded()
    stub = cuda_route(StubLibrary(pci_fusion_cells=fusion_cells_stub(layers, seen),
                                  pci_fusion_tail=tail))
    x1, x2 = torch.from_numpy(a), torch.from_numpy(b)
    if mode == "train":
        got = mod.train()(x1.requires_grad_(), x2.requires_grad_(), k, tt, perms=tp)
        got.sum().backward()
    else:
        with torch.inference_mode():
            got = mod.eval()(x1, x2, k, tt, perms=tp)
    assert [n for n, _ in stub.calls] == entries
    assert seen == [(k, mode == "eval_oneshot")]
    with _build.plain_versions(), (torch.inference_mode() if mode != "train"
                                   else contextlib.nullcontext()):
        want = copy.deepcopy(mod)(torch.from_numpy(a), torch.from_numpy(b), k, tt, perms=tp)
    torch.testing.assert_close(got.detach(), want.detach(), atol=1e-6, rtol=1e-6)


def _multi_inputs(F: int, seed: int):
    from pci_tpu_torch.serving import init_weights

    rng = np.random.default_rng(seed)
    N, k = 512, 64
    clouds = [torch.from_numpy((rng.standard_normal((1, N, 3)) * 2).astype(np.float32))
              for _ in range(F)]
    perms = [torch.from_numpy(rng.permutation(N)[None]) for _ in range(F)]
    weights = torch.softmax(torch.from_numpy(rng.standard_normal((1, 12)).astype(np.float32)), -1)
    mod = tnn.PointsFusionMulti()
    init_weights(mod, seed + 1)
    return clouds, perms, weights, mod, k


def test_points_fusion_multi_f3_launches_three_masked_knn_cells(cuda_route, monkeypatch):
    """PointsFusionMulti over three clouds at k = 64 on the cells route
    (eval, no gradient) launches row 10's segment form three times: each
    pass's key mask is its segment's rows of the combined cloud, its
    budgets and first slots the capped ``_multi_budgets``, the last pass
    filling; the rows equal the plain route's, and the launches count in
    ``knn_cells_kernel.launches``."""
    from pci_tpu_torch.nn.fusion import _multi_budgets
    from pci_tpu_torch.ops.cuda_kernels.fusion_cells_cuda import segment_slots

    cells_gate(monkeypatch)
    clouds, perms, weights, mod, k = _multi_inputs(3, 818)
    N = clouds[0].shape[1]
    seen = []
    stub = cuda_route(StubLibrary(pci_knn_cells_seg=knn_cells_seg_stub(seen)))
    before = knn_cuda.knn_cells_kernel.launches
    with torch.inference_mode():
        got = mod.eval()(clouds, k, weights, perms=perms)
        with _build.plain_versions():
            want = mod(clouds, k, weights, perms=perms)
    assert [n for n, _ in stub.calls] == ["pci_knn_cells_seg"] * 3
    assert knn_cuda.knn_cells_kernel.launches - before == 3
    n_all, k_all = _multi_budgets(N, k, weights[:, :2])
    caps, col0 = segment_slots(k_all, k)
    ends = torch.cumsum(n_all, 1)[0].tolist()
    for f, (kv, budgets, c0, fill) in enumerate(seen):
        pos = torch.arange(N)
        assert torch.equal(kv[0], (pos >= ([0] + ends)[f]) & (pos < ends[f]))
        assert torch.equal(budgets, caps[:, f]) and torch.equal(c0, col0[:, f])
        assert fill == (f == 2)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case, entries", [
    ("f2_eval", ["pci_fusion_cells"]),
    ("f2_train", ["pci_fusion_cells"]),
    ("f3_train", ["pci_fusion_resi"]),
    ("f3_eval_grad", ["pci_fusion_resi"]),
])
def test_points_fusion_multi_cells_routes_by_segments_and_grad(cuda_route, monkeypatch, case,
                                                               entries):
    """On the cells route two segments (field 1) take row 12's residual
    mode once, at eval and in training (its fixed-neighbour backward); at
    F = 3 training and an eval call through which a gradient could flow
    into the clouds keep row 4b's residual kNN (JAX's F > 2 cells branch is
    eval only).  The rows equal the plain route's."""
    cells_gate(monkeypatch)
    F = 2 if case.startswith("f2") else 3
    clouds, perms, weights, mod, k = _multi_inputs(F, 820 + F)

    def resi(pts, ends, buds, F_, oi, orr, B, N_, k_, parts, stamps, stream):
        i, r = fusion_knn_cuda.fusion_resi_plain(
            read(pts, (B, N_, 3)), read(ends, (B, F_), ctypes.c_int32),
            read(buds, (B, F_), ctypes.c_int32), k_)
        write(oi, i)
        write(orr, r)

    seen = []
    stub = cuda_route(StubLibrary(pci_fusion_cells=fusion_cells_stub(None, seen),
                                  pci_fusion_resi=resi))
    train = case.endswith("train")
    grad = train or case.endswith("grad")
    cl = [c.clone().requires_grad_(grad) for c in clouds]
    with torch.inference_mode() if not grad else contextlib.nullcontext():
        got = mod.train(train)(cl, k, weights, perms=perms)
    if grad:
        got.sum().backward()
        assert all(c.grad is not None for c in cl)
    assert [n for n, _ in stub.calls] == entries
    if F == 2:
        assert seen == [(k, False)]
    with _build.plain_versions(), torch.no_grad():
        want = copy.deepcopy(mod).train(train)(clouds, k, weights, perms=perms)
    torch.testing.assert_close(got.detach(), want, atol=1e-5, rtol=1e-5)


# ---- TransformerLayer at widths its attention kernels do not take -----------------


@pytest.mark.parametrize("d_model", [20, 256])
def test_transformer_eval_outside_the_kernels_widths_launches_nothing(cuda_route, d_model):
    """Eval ``TransformerLayer(64, d_model, 16)`` at d_model = 20 (not a
    multiple of 8) and 256 (past the forward kernel's 128) routes its tail
    to the plain version before any launch (the JAX layer's XLA
    expression): only the kNN launches, and the rows equal the plain
    route's."""
    torch.manual_seed(812)
    layer = tnn.TransformerLayer(64, d_model, 16).eval()
    rng = np.random.default_rng(813)
    xyz, feats = _cloud(rng, 1, 256, 3), _cloud(rng, 1, 256, 64)
    stub = cuda_route(StubLibrary(pci_knn=knn_stub))
    with torch.inference_mode():
        got, _ = layer(xyz, feats)
        assert [n for n, _ in stub.calls] == ["pci_knn"]
        with _build.plain_versions():
            want, _ = layer(xyz, feats)
    assert attention_cuda.kernel_route_ok(d_model, 16) is False
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_transformer_training_past_d128_runs_the_plain_directions(cuda_route):
    """Training ``TransformerLayer(64, 256, 16)``: past both attention
    kernels' 128, the trainable route decides at its forward to run both
    directions plain: no attention launch, and the rows and every gradient
    equal the plain route's.  (At 96 and 128 both kernels launch:
    tests/test_torch_variants.py.)"""
    torch.manual_seed(814)
    base = tnn.TransformerLayer(64, 256, 16).train()
    rng = np.random.default_rng(815)
    xyz, feats = _cloud(rng, 1, 200, 3), _cloud(rng, 1, 200, 64)
    G = _cloud(rng, 1, 200, 64)
    stub = cuda_route(StubLibrary(pci_knn=knn_stub))
    outs = []
    for plain in (False, True):
        layer = copy.deepcopy(base)
        f = feats.clone().requires_grad_()
        with _build.plain_versions() if plain else contextlib.nullcontext():
            out, _ = layer(xyz, f)
            (out * G).sum().backward()
        outs.append([out.detach(), f.grad] + [p.grad for p in layer.parameters()])
    assert {n for n, _ in stub.calls} == {"pci_knn"}
    assert not attention_cuda.kernel_route_ok(256, 16) and not attention_cuda.bwd_route_ok(256, 16)
    for got, want in zip(*outs, strict=True):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


# ---- the per-stage set-conv (row 2) -------------------------------------------------


def _setconv_case(rng, N, D, widths, S):
    xyz = torch.from_numpy((rng.random((1, N, 3)) * 6.0).astype(np.float32))
    feats = torch.from_numpy(np.maximum(rng.standard_normal((1, N, D)), 0).astype(np.float32))
    layers, cin = [], 3 + D
    for cout in widths:
        layers.append((torch.from_numpy((rng.standard_normal((cout, cin)) / np.sqrt(cin))
                                        .astype(np.float32)),
                       torch.from_numpy((0.1 * rng.standard_normal(cout)).astype(np.float32))))
        cin = cout
    return xyz, feats, xyz[:, :S].contiguous(), layers


@pytest.mark.parametrize("D, widths, K", [(3, (32, 32, 64), 16), (128, (128, 128, 256), 8),
                                          (256, (256, 256, 512), 8)],
                         ids=["set_conv1", "set_conv3", "set_conv4"])
def test_setconv_stages_launch_the_tensor_tile(cuda_route, D, widths, K):
    """FlowNet3D's set-conv widths launch ``pci_setconv`` once (no
    stamps), with the chain's widths and the
    weights in ``_build.pack_tf32``'s layout, bit for bit; the result the
    stub writes (the plain version on the arrays the launch passed) comes
    back whole."""
    rng = np.random.default_rng(830 + D)
    xyz, feats, q, layers = _setconv_case(rng, 200, D, widths, 24)
    dims = [3 + D, *widths]
    pack = _build.pack_tf32(layers, torch.device("cpu"))

    def pci_setconv(xp, fp, qp, wp, dp, n, op, B, N, S, Dd, r2, k, stamps, stream):
        assert (n, list(dp)[:n + 1], stamps, k, Dd) == (len(widths), dims, None, K, D)
        assert torch.equal(read(wp, (pack.numel(),)), pack)
        args = (read(xp, (B, N, 3)), read(fp, (B, N, Dd)), read(qp, (B, S, 3)))
        write(op, setconv_cuda.setconv_plain(*args, float(r2) ** 0.5, k, layers))

    stub = cuda_route(StubLibrary(pci_setconv=pci_setconv))
    got = setconv_cuda.setconv_fused(xyz, feats, q, 1.5, K, layers)
    assert len(stub.named("pci_setconv")) == 1
    want = setconv_cuda.setconv_plain(xyz, feats, q, 1.5, K, layers)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("K, widths", [(129, (32, 64)), (200, (32, 64)), (16, (1032, 64))],
                         ids=["k129", "k200", "width1032"])
def test_setconv_past_the_kernels_shapes_launches_nothing(cuda_route, K, widths):
    """nsample past 128 (the JAX package's gate) or a layer past 1,024
    channels: the wrapper takes the plain version before any launch."""
    rng = np.random.default_rng(840 + K)
    xyz, feats, q, layers = _setconv_case(rng, 300, 5, widths, 16)
    stub = cuda_route(StubLibrary())
    got = setconv_cuda.setconv_fused(xyz, feats, q, 2.0, K, layers)
    assert stub.calls == []
    assert not setconv_cuda.kernel_route_ok(K, [8, *widths])
    want = setconv_cuda.setconv_plain(xyz, feats, q, 2.0, K, layers)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
