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
    fps_cuda,
    fusion_knn_cuda,
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
    """Exact indices on every query with a hit.  A query with none reads
    key 0 (the documented contract, and what setconv_tpu does); the JAX
    XLA path clips such a row to N - 1 instead."""
    from pci_tpu import ops as jops

    rng = np.random.default_rng(103)
    xyz, q = cloud(rng, 2, 300), cloud(rng, 2, 50)
    q[:, :3] = 50.0
    got = tops.ball_query(0.8, 8, t_(xyz), t_(q)).numpy()
    want = np.asarray(jops.ball_query(0.8, 8, jnp.asarray(xyz), jnp.asarray(q)))
    hit = (((q[:, :, None] - xyz[:, None]) ** 2).sum(-1) <= 0.64).any(-1)
    assert hit.sum() > 40 and (~hit[:, :3]).all()
    np.testing.assert_array_equal(got[hit], want[hit])
    assert (got[~hit] == 0).all() and (want[~hit] == 299).all()


def test_knn_and_knn_prefix_match_jax():
    from pci_tpu import ops as jops

    rng = np.random.default_rng(104)
    q, p = cloud(rng, 2, 64), cloud(rng, 2, 200)
    d, i = tops.knn(t_(q), t_(p), 8)
    jd, ji = jops.knn(jnp.asarray(q), jnp.asarray(p), 8, exact=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    valid = np.array([37, 200], np.int32)
    _, i = tops.knn_prefix(t_(q), t_(p), 8, t_(valid))
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
                                   "upconv_mlp1", "fp_interp"])
def test_knnconv_plain_matches_pallas(stage):
    """knnconv_fused (plain) vs knnconv_tpu.knnconv_fused (interpret) in
    each mode FlowNet3D uses."""
    from pci_tpu.ops.pallas_kernels.knnconv_tpu import knnconv_fused as jkc

    rng = np.random.default_rng({"flow_embedding": 12, "upconv_no_mlp1": 13,
                                 "upconv_mlp1": 14, "fp_interp": 15}[stage])
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
    else:
        f1, l1 = (), []
        f2, l2 = folded_layers(rng, (10 + 5, 24, 16))
        args, interp = (q, keys, kf, None, skip, 3), True
    tq = [None if a is None else t_(a) for a in args[:5]]
    got = knnconv_cuda.knnconv_fused(*tq, args[5], l1, l2, interp=interp)
    jq = [None if a is None else J(a) for a in args[:5]]
    want = jkc(*jq, args[5], f1, f2, len(l1), len(l2), True, interp)
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
    seg = torch.tensor([[32, 64]])
    return {
        "fps": lambda: fps_cuda.fps_index(x, 8, torch.zeros(1, dtype=torch.long), 1),
        "setconv": lambda: setconv_cuda.setconv_fused(x, f, x[:, :8], 0.5, 4, sc),
        "knnconv": lambda: knnconv_cuda.knnconv_fused(x, x, f, None, None, 4, sc, []),
        "fusion": lambda: fusion_knn_cuda.knn_fusion_attention(x, seg, torch.tensor([[16, 16]]), fu, 32),
    }


@pytest.mark.parametrize("kernel", ["fps", "setconv", "knnconv", "fusion"])
def test_eval_only_kernels_refuse_grad(kernel):
    call = _grad_calls()[kernel]
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
    assert tk.launch_counts() == {"fps": 0, "setconv": 0, "knnconv": 0, "fusion": 0}
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
