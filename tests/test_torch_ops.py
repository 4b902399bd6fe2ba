"""The port's ops and kernel plain versions against the JAX package, on CPU.

Inputs come from numpy with a fixed seed per test and pass to both
packages as arrays.  Tolerances: indices (FPS, ball query, kNN) exact;
fp32 outputs of MLP chains atol=rtol=2e-4 (summation order differs, the
bound of tests/test_layers.py's kernel parity tests); plain geometry 1e-5.
The Pallas kernels run in interpret mode, as the JAX package's own CPU
tests run them.
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pci_tpu_torch import ops as tops
from pci_tpu_torch.ops import cuda_kernels as tk
from pci_tpu_torch.ops.cuda_kernels import (
    attention_cuda,
    ball_cuda,
    fps_cuda,
    fusion_knn_cuda,
    knn_cuda,
    knnconv_cuda,
    setconv_cuda,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def cloud(rng, b, n, c=3, scale=2.0):
    return (rng.standard_normal((b, n, c)) * scale).astype(np.float32)


def t_(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def folded_layers(rng, widths):
    """Random folded MLP: JAX flat ``(WT, b, ...)`` and the port's
    ``[(W, b), ...]`` (both ``W [cout, cin]``)."""
    flat, layers = [], []
    for cin, cout in zip(widths[:-1], widths[1:]):
        w = (rng.standard_normal((cout, cin)) / np.sqrt(cin)).astype(np.float32)
        b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
        flat += [jnp.asarray(w), jnp.asarray(b)]
        layers.append((t_(w), t_(b)))
    return tuple(flat), layers


def test_square_distance_and_gather():
    from pci_tpu import ops as jops

    rng = np.random.default_rng(100)
    a, b = cloud(rng, 2, 40), cloud(rng, 2, 70)
    got = tops.square_distance(t_(a), t_(b)).numpy()
    want = np.asarray(jops.square_distance(jnp.asarray(a), jnp.asarray(b)))
    # JAX expands |a|^2+|b|^2-2ab; the port sums differences directly
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    idx = rng.integers(0, 70, (2, 40, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        tops.index_points(t_(b), t_(idx)).numpy(),
        np.asarray(jops.index_points(jnp.asarray(b), jnp.asarray(idx))),
    )


@pytest.mark.parametrize("npoint", [64, 300])
def test_fps_exact_matches_jax_and_pallas(npoint):
    """P=1 greedy at N=256 == pci_tpu.ops.fps == fps_pallas (interpret);
    npoint=300 > N checks the pick-0-again tail."""
    from pci_tpu import ops as jops
    from pci_tpu.ops.pallas_kernels.fps_tpu import fps_pallas

    rng = np.random.default_rng(101)
    xyz = cloud(rng, 2, 256)
    got = tops.fps(t_(xyz), npoint).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.fps(jnp.asarray(xyz), npoint)))
    np.testing.assert_array_equal(
        got, np.asarray(fps_pallas(jnp.asarray(xyz), npoint, 0, True)))


def test_fps_interleaved_matches_strided_jax_chains():
    """exact=False at N=4096 runs P=8 chains (the JAX package's TPU
    route): each chain == pci_tpu.ops.fps on its strided subset, picks
    interleaved iteration-major."""
    from pci_tpu import ops as jops

    rng = np.random.default_rng(102)
    N, npoint, P = 4096, 256, 8
    xyz = cloud(rng, 1, N, scale=10.0)
    got = tops.fps(t_(xyz), npoint, exact=False).numpy()
    chains = [
        np.asarray(jops.fps(jnp.asarray(xyz[:, s::P]), npoint // P)) * P + s
        for s in range(P)
    ]
    want = np.stack(chains, axis=-1).reshape(1, npoint)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == npoint


def test_ball_query_matches_jax():
    """Exact indices on every row, the empty ones included: a query with
    no key in radius holds N - 1, as the JAX package's XLA path clips its
    sentinel (its docstring says 0)."""
    from pci_tpu import ops as jops

    rng = np.random.default_rng(103)
    xyz, q = cloud(rng, 2, 300), cloud(rng, 2, 50)
    q[:, :3] = 50.0
    got = tops.ball_query(0.8, 8, t_(xyz), t_(q)).numpy()
    want = np.asarray(jops.ball_query(0.8, 8, jnp.asarray(xyz), jnp.asarray(q)))
    hit = (((q[:, :, None] - xyz[:, None]) ** 2).sum(-1) <= 0.64).any(-1)
    assert hit.sum() > 40 and (~hit[:, :3]).all()
    np.testing.assert_array_equal(got, want)
    assert (got[~hit] == 299).all()


def grid_cloud(rng, b, n, scale=1.0):
    """Coordinates on a 1/64 grid: squared distances are exact in fp32 by
    both the direct and the expanded formula, so ball membership cannot
    differ between the port and the JAX package at a radius shell."""
    return (np.round(rng.standard_normal((b, n, 3)) * scale * 64) / 64).astype(np.float32)


def test_ball_query_multi_matches_jax_and_pallas():
    """ball_query_multi vs pci_tpu.ops.ball_query_multi and vs
    ball_query_pallas (interpret) + finish_ball_idx: exact indices at two
    radii with K=16/32, N=300 (not a multiple of the 256-key tile), a row
    with no hit and a row with fewer than K hits."""
    from pci_tpu import ops as jops
    from pci_tpu.ops.pallas_kernels.ball_tpu import ball_query_pallas, finish_ball_idx

    rng = np.random.default_rng(111)
    N = 300
    xyz, q = grid_cloud(rng, 2, N, 0.3), grid_cloud(rng, 2, 40, 0.3)
    q[:, 0] = 40.0  # no hit
    q[:, 1] = [6.0, 0.0, 0.0]  # one hit at r=0.3, two at r=0.6
    xyz[:, 7] = [6.25, 0.0, 0.0]
    xyz[:, 8] = [6.0, 0.5, 0.0]
    radii, ks = [0.3, 0.6], [16, 32]
    got = [i.numpy() for i in tops.ball_query_multi(radii, ks, t_(xyz), t_(q))]
    J = jnp.asarray
    want = [np.asarray(i) for i in jops.ball_query_multi(radii, ks, J(xyz), J(q))]
    raw = ball_query_pallas(J(xyz), J(q), J(np.float32(radii)), tuple(ks), True)
    pallas = [np.asarray(finish_ball_idx(i, N)) for i in raw]
    d = ((q[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    hits = [(d <= r * r).sum(-1) for r in radii]
    assert (hits[1][:, 0] == 0).all() and (0 < hits[0][:, 1]).all() and (hits[1][:, 1] < 32).all()
    assert (hits[0] >= 16).any() and (hits[1] >= 32).any()
    for g, w, p in zip(got, want, pallas):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)
    assert (got[0][:, 0] == N - 1).all()
    np.testing.assert_array_equal(got[1][:, 1], np.broadcast_to([[7, 8] + [7] * 30], (2, 32)))  # pad: the first hit


def test_knn_chunked_matches_jax_exact(monkeypatch):
    """The plain knn, forced into 7-row query blocks, vs
    pci_tpu.ops.knn(exact=True) on a cloud with duplicated points: equal
    indices (ties to the lower key index)."""
    from pci_tpu import ops as jops

    rng = np.random.default_rng(112)
    p = cloud(rng, 2, 200)
    p[:, 100:140] = p[:, 20:60]  # exact duplicates
    q = p[:, ::3].copy()
    monkeypatch.setattr(knn_cuda, "_PLAIN_BLOCK", 7 * 200)
    d, i = tops.knn(t_(q), t_(p), 12)
    jd, ji = jops.knn(jnp.asarray(q), jnp.asarray(p), 12, exact=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    assert (d.numpy()[..., 0] == 0).all()


def test_knn_cells_never_beats_exact():
    """knn_cells (the TPU kernel, interpret) is approximate: on the same
    self-cloud each rank of its neighbours' distances (recomputed exactly
    from its indices) is >= the port's exact distance at that rank."""
    from pci_tpu.ops.pallas_kernels.knn_cells_tpu import knn_cells

    rng = np.random.default_rng(113)
    x = cloud(rng, 1, 1024)
    xj = jnp.asarray(x)
    _, ci = knn_cells(xj, xj, 8, interpret=True)
    ci = t_(np.array(ci)).long()
    d_cells = ((tops.index_points(t_(x), ci) - t_(x)[:, :, None]) ** 2).sum(-1)
    d_exact, _ = tops.knn(t_(x), t_(x), 8)
    d_cells = torch.sort(d_cells, -1).values
    assert (d_cells >= d_exact - 1e-6).all()
    assert (d_cells == d_exact).float().mean() > 0.5


def test_vector_attention_plain_matches_pallas():
    """The plain attention tail vs fused_vector_attention (interpret) at
    N=600 (padded to the 512-query grain there), k=16, d=32.  q and K|V
    are rounded to bf16 first, so the TPU kernel's bf16 cast is exact;
    then both are fp32: tolerance 1e-5."""
    from pci_tpu.ops.pallas_kernels.attention_tpu import fused_vector_attention

    rng = np.random.default_rng(114)
    N, k, d = 600, 16, 32
    bf = lambda x: t_(x).to(torch.bfloat16).float().numpy()  # noqa: E731
    q = bf(cloud(rng, 1, N, d, scale=0.5))
    g = bf((rng.standard_normal((1, N, k, 2 * d)) * 0.5).astype(np.float32))
    delta = (rng.standard_normal((1, N, k, 3)) * 0.3).astype(np.float32)
    ws = [(rng.standard_normal((cin, d)) / np.sqrt(cin)).astype(np.float32) for cin in (3, d, d, d)]
    bs = [(0.1 * rng.standard_normal(d)).astype(np.float32) for _ in range(4)]
    J = jnp.asarray
    flat = [J(a) for wb in zip(ws, bs) for a in wb]
    want = np.asarray(fused_vector_attention(J(q), J(g), J(delta), *flat, True))
    tail = [(t_(w.T.copy()), t_(b)) for w, b in zip(ws, bs)]
    got = attention_cuda.vector_attention(t_(q), t_(g), t_(delta), tail).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_knn_and_knn_prefix_match_jax():
    from pci_tpu import ops as jops

    rng = np.random.default_rng(104)
    q, p = cloud(rng, 2, 64), cloud(rng, 2, 200)
    d, i = tops.knn(t_(q), t_(p), 8)
    jd, ji = jops.knn(jnp.asarray(q), jnp.asarray(p), 8, exact=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    valid = np.array([37, 200], np.int32)
    _, i = tops.knn(t_(q), t_(p), 8, t_(valid))
    _, ji = jops.knn_prefix(jnp.asarray(q), jnp.asarray(p), 8, jnp.asarray(valid), exact=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert (i.numpy()[0] < 37).all()


@pytest.mark.parametrize("mode", ["clamp", "eps"])
def test_three_nn_interpolate_matches_jax(mode):
    from pci_tpu import ops as jops

    rng = np.random.default_rng(105)
    dense, sub = cloud(rng, 2, 120), cloud(rng, 2, 30)
    dense[:, :4] = sub[:, :4]  # exact hits exercise the clamp
    f = cloud(rng, 2, 30, 7, scale=1.0)
    got = tops.three_nn_interpolate(t_(dense), t_(sub), t_(f), mode).numpy()
    want = np.asarray(jops.three_nn_interpolate(
        jnp.asarray(dense), jnp.asarray(sub), jnp.asarray(f), mode))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_knn_gather_and_scatter_add_rows_match_jax():
    """knn_gather, and its transpose scatter_add_rows with duplicate
    targets (the fusion backward's), against the JAX package's."""
    from pci_tpu.ops import gather as jgather

    rng = np.random.default_rng(106)
    x = cloud(rng, 2, 50, 5)
    idx = rng.integers(0, 50, (2, 30, 4)).astype(np.int32)
    got = tops.knn_gather(t_(x), t_(idx).long()).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgather.knn_gather(jnp.asarray(x),
                                                                     jnp.asarray(idx))))
    g = cloud(rng, 2, 120, 3)
    flat = idx.reshape(2, 120)
    got = tops.scatter_add_rows(t_(flat), t_(g), 50).numpy()
    want = np.asarray(jgather.scatter_add_rows(jnp.asarray(flat), jnp.asarray(g), 50))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["clamp", "eps"])
def test_three_nn_interpolate_grads_match_jax(mode):
    """The training route of FeaturePropagationP2: gradients in the
    features and in both clouds (distances recomputed from the indices)
    against jax.grad."""
    from pci_tpu import ops as jops

    rng = np.random.default_rng(107)
    dense, sub = cloud(rng, 2, 120), cloud(rng, 2, 30)
    f, cot = cloud(rng, 2, 30, 7, scale=1.0), cloud(rng, 2, 120, 7, scale=1.0)
    want = jax.grad(lambda a, b, c: jnp.sum(jops.three_nn_interpolate(a, b, c, mode) * cot),
                    argnums=(0, 1, 2))(jnp.asarray(dense), jnp.asarray(sub), jnp.asarray(f))
    args = [t_(a).requires_grad_() for a in (dense, sub, f)]
    (tops.three_nn_interpolate(*args, mode) * t_(cot)).sum().backward()
    for a, w in zip(args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("far", [False, True])
def test_setconv_plain_matches_pallas(far):
    """setconv_fused (plain) vs setconv_tpu.setconv_fused (interpret):
    first-K-in-index-order grouping, pad-with-first, MLP, max.  far=True
    puts every query out of reach: each slot reads key 0."""
    from pci_tpu.ops.pallas_kernels.setconv_tpu import setconv_fused as jsc

    rng = np.random.default_rng(106)
    xyz, feats = cloud(rng, 2, 512), cloud(rng, 2, 512, 5, scale=1.0)
    q = xyz[:, ::8].copy()
    if far:
        q += 80.0
    flat, layers = folded_layers(rng, (8, 16, 16, 32))
    got = setconv_cuda.setconv_fused(t_(xyz), t_(feats), t_(q), 0.6, 8, layers)
    want = jsc(jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(q), 0.6, 8,
               flat, 3, True, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("stage", ["flow_embedding", "upconv_no_mlp1",
                                   "upconv_mlp1", "fp_interp", "fp_interp_eps"])
def test_knnconv_plain_matches_pallas(stage):
    """knnconv_fused (plain) vs knnconv_tpu.knnconv_fused (interpret) in
    each mode FlowNet3D uses, and the ``eps`` interpolation PointNet++'s
    FeaturePropagationP2 uses (no MLPs, no skip, D=1,024 key channels as
    at fp4, and exact key hits)."""
    from pci_tpu.ops.pallas_kernels.knnconv_tpu import knnconv_fused as jkc

    rng = np.random.default_rng({"flow_embedding": 12, "upconv_no_mlp1": 13,
                                 "upconv_mlp1": 14, "fp_interp": 15,
                                 "fp_interp_eps": 16}[stage])
    q, keys = cloud(rng, 2, 128), cloud(rng, 2, 48)
    kf = cloud(rng, 2, 48, 10, scale=1.0)
    qf = cloud(rng, 2, 128, 6, scale=1.0)
    skip = cloud(rng, 2, 128, 5, scale=1.0)
    J = jnp.asarray
    if stage == "flow_embedding":
        f1, l1 = folded_layers(rng, (19, 16, 32))
        args = (q, keys, kf, qf, None, 8)
        f2, l2, interp = (), [], False
    elif stage == "upconv_no_mlp1":
        f1, l1 = (), []
        f2, l2 = folded_layers(rng, (13 + 5, 24, 16))
        args, interp = (q, keys, kf, None, skip, 4), False
    elif stage == "upconv_mlp1":
        f1, l1 = folded_layers(rng, (13, 16, 24))
        f2, l2 = folded_layers(rng, (24 + 5, 16))
        args, interp = (q, keys, kf, None, skip, 4), False
    elif stage == "fp_interp":
        f1, l1 = (), []
        f2, l2 = folded_layers(rng, (10 + 5, 24, 16))
        args, interp = (q, keys, kf, None, skip, 3), True
    else:
        f1, l1, f2, l2 = (), [], (), []
        q[:, :5] = keys[:, :5]
        args, interp = (q, keys, cloud(rng, 2, 48, 1024, scale=1.0), None, None, 3), True
    recip = "eps" if stage == "fp_interp_eps" else "clamp"
    tq = [None if a is None else t_(a) for a in args[:5]]
    got = knnconv_cuda.knnconv_fused(*tq, args[5], l1, l2, interp=interp, recip=recip)
    jq = [None if a is None else J(a) for a in args[:5]]
    want = jkc(*jq, args[5], f1, f2, len(l1), len(l2), True, interp, recip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_knnconv_n_final_is_refused():
    rng = np.random.default_rng(107)
    q = t_(cloud(rng, 1, 8))
    with pytest.raises(NotImplementedError):
        knnconv_cuda.knnconv_fused(q, q, q, None, None, 3, [], [], True, 1)


@pytest.mark.parametrize("t", [0.5, 0.2, 0.02])
def test_fusion_plain_matches_jax_points_fusion(monkeypatch, t):
    """knn_fusion_attention (plain, through the port's PointsFusion) vs
    the JAX PointsFusion's exact XLA route, with the same permutations.
    t=0.02 gives k2=0 (every neighbour from cloud 1)."""
    import pci_tpu.nn.fusion as jfusion
    from pci_tpu_torch.convert import flax_to_state_dict
    from pci_tpu_torch.nn import PointsFusion

    rng = np.random.default_rng(108)
    N, k = 512, 32
    a = cloud(rng, 2, N)
    b = a + 0.2 * cloud(rng, 2, N, scale=1.0)
    p1 = np.stack([rng.permutation(N) for _ in range(2)]).astype(np.int32)
    p2 = np.stack([rng.permutation(N) for _ in range(2)]).astype(np.int32)
    tt = np.array([t, 1 - t], np.float32)
    jmod = jfusion.PointsFusion((64, 64, 128))
    rngs = {"params": jax.random.key(0), "sample": jax.random.key(1)}
    v = jmod.init(rngs, jnp.asarray(a), jnp.asarray(b), k, jnp.asarray(tt))
    v = jax.tree_util.tree_map(  # non-trivial BatchNorm statistics
        lambda x: x + 0.01 * jnp.arange(x.size, dtype=x.dtype) if x.ndim == 1 else x, v)
    draws = iter([p1, p2])
    monkeypatch.setattr(jfusion, "_random_perms", lambda key, B, n: jnp.asarray(next(draws)))
    want = jmod.apply(v, jnp.asarray(a), jnp.asarray(b), k, jnp.asarray(tt),
                      rngs={"sample": jax.random.key(2)})
    mod = PointsFusion()
    mod.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, v)))
    with torch.inference_mode():
        got = mod.eval()(t_(a), t_(b), k, t_(tt), perms=(t_(p1), t_(p2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_fusion_starved_segment_gives_zero_residuals():
    """A segment shorter than its budget fills the rest with zero
    residuals (self-neighbours)."""
    rng = np.random.default_rng(109)
    x = t_(cloud(rng, 1, 64))
    _, layers = folded_layers(rng, (4, 64, 64, 128))
    seg = torch.tensor([[4, 64]])
    got = fusion_knn_cuda.knn_fusion_attention(x, seg, torch.tensor([[8, 24]]), layers, 32)
    # reference: 4 real neighbours from segment A, 4 zero residuals
    _, ia = tops.knn(x, x[:, :4], 4)
    _, ib = tops.knn(x, x[:, 4:], 24)
    resi = torch.cat([tops.index_points(x[:, :4], ia) - x[:, :, None],
                      torch.zeros(1, 64, 4, 3),
                      tops.index_points(x[:, 4:], ib) - x[:, :, None]], dim=2)
    h = tk._build.mlp_plain(torch.cat([resi, fusion_knn_cuda.safe_norm(resi)], -1), layers)
    w = torch.softmax(h.amax(-1), -1)[..., None]
    torch.testing.assert_close(got, x + (w * resi).sum(2), atol=1e-6, rtol=1e-6)


def _grad_calls():
    rng = np.random.default_rng(110)
    x = t_(cloud(rng, 1, 64)).requires_grad_()
    f = t_(cloud(rng, 1, 64))
    _, sc = folded_layers(rng, (6, 8))
    _, fu = folded_layers(rng, (4, 64, 64, 128))
    _, tail = folded_layers(rng, (3, 8, 8, 8, 8))
    tail = [(w, b) for w, b in tail]
    seg = torch.tensor([[32, 64]])
    g = t_(cloud(rng, 1, 64 * 4, 16)).reshape(1, 64, 4, 16)
    return {
        "fps": lambda: fps_cuda.fps_index(x, 8, torch.zeros(1, dtype=torch.long), 1),
        "setconv": lambda: setconv_cuda.setconv_fused(x, f, x[:, :8], 0.5, 4, sc),
        "knnconv": lambda: knnconv_cuda.knnconv_fused(x, x, f, None, None, 4, sc, []),
        "fusion": lambda: fusion_knn_cuda.knn_fusion_attention(x, seg, torch.tensor([[16, 16]]), fu, 32),
        "ball": lambda: ball_cuda.ball_query_multi([0.5, 1.0], [4, 8], x, x[:, :8]),
        "knn": lambda: knn_cuda.knn(x, x, 4),
        "attention": lambda: attention_cuda.vector_attention(
            t_(cloud(rng, 1, 64, 8)), g, x[:, :, None].expand(-1, -1, 4, -1), tail),
    }


@pytest.mark.parametrize("kernel", ["fps", "setconv", "knnconv", "fusion", "ball",
                                    "knn", "attention"])
def test_eval_only_kernels_refuse_grad(kernel):
    """The eval kernels of differentiable values (set-conv, kNN-conv, the
    one-shot fusion, the eval attention) define no backward and refuse an
    input that needs a gradient; the index-only ones (FPS, ball query,
    kNN) take such an input detached, as their JAX counterparts
    stop-gradient theirs."""
    call = _grad_calls()[kernel]
    if kernel in ("fps", "ball", "knn"):
        got = call()
        with torch.no_grad():
            want = call()
        for g, w in zip(got if isinstance(got, (list, tuple)) else [got],
                        want if isinstance(want, (list, tuple)) else [want]):
            assert not g.requires_grad
            torch.testing.assert_close(g, w, atol=0, rtol=0)
        return
    with pytest.raises(RuntimeError, match="eval-only"):
        call()
    with torch.no_grad():
        call()


def test_kernel_routes_by_device():
    """CPU tensors take the plain version and never count a launch."""
    tk.reset_launch_counts()
    for call in _grad_calls().values():
        with torch.no_grad():
            call()
    x = t_(cloud(np.random.default_rng(111), 1, 64)).requires_grad_()
    fusion_knn_cuda.fusion_resi_knn(x, torch.tensor([[32, 64]]), torch.tensor([[16, 16]]),
                                    32)[1].sum().backward()
    tops.chamfer_distance(x, x.detach() + 0.1).backward()
    assert tk.launch_counts() == {"fps": 0, "setconv": 0, "knnconv": 0, "fusion": 0,
                                  "ball": 0, "knn": 0, "attention": 0, "fusion_resi": 0,
                                  "nearest": 0, "attention_bwd": 0}
    with pytest.raises(ValueError):
        tk._build.use_kernel(torch.empty(1, device="meta"))


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports JAX, flax, optax,
    orbax or the JAX package."""
    banned = ("jax", "flax", "optax", "orbax", "pci_tpu")
    files = sorted((ROOT / "pci_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, f"{path.name} imports {name}"
