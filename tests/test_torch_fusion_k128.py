"""The fusion at k in 65-128 and the models' ``fusion_k`` and
``fusion_sampling`` against the JAX package on the CPU.

The JAX package serves k <= 128 on the TPU's flat fusion kernels and any
k on its tail kernel; on the CPU it runs its exact XLA route, which the
port's plain versions hold here (the kernels, which the CPU cannot run,
are held against the same plain versions by chip_smoke.py on the card):

- ``PointsFusion``, ``PointsFusionWithFeatures`` and ``PointsFusionMulti``
  at k = 65, 96 and 128 on JAX's own permutations (recorded inside its
  jitted call), every segment holding at least its budget, within 1e-5;
- ``PointINet(fusion_k=96)`` with xyz and with an intensity channel,
  ``PointINet(fusion_sampling="fps")`` (exact greedy FPS over all N
  points in both packages, N < 4,096), ``ISAPCInet(field=1, fusion_k=96,
  fusion_sampling="fps")`` and ``PointINet2(field=1, fusion_k=96)``, each
  on given flows (FlowNet3D replaced on both sides, as
  tests/test_torch_isapci.py and tests/test_torch_pointinet2.py do; the
  ISAPCInet fusion, as there, on JAX's own warped clouds), at those
  files' whole-model tolerances; a JAX ``PointINet(fusion_k=96)``
  tree loads into the port unchanged (the fields add no parameter);
- an unknown sampling refused, and the port importing neither JAX nor
  the JAX package (a subprocess importing every module of the port);
- on a stub kernel library (tests/test_torch_kernel_routes.py's forced
  CUDA route) the launches: k = 96 takes ``pci_fusion128`` at eval, the
  residual kNN and the tail with one-shot off, the residual kNN in
  training, each with k = 96 and the rows of the plain route; k = 160
  launches the tail alone at eval.

Every JAX model runs once a test run (``shared_result``), its init and
apply in one jit.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pci_tpu.nn.fusion as jfusion
from pci_tpu.models import ISAPCInet as JISAPCInet
from pci_tpu.models import PointINet as JPointINet
from pci_tpu.models import PointINet2 as JPointINet2
from pci_tpu.models.flownet3d import FlowNet3D as JFlowNet3D
from pci_tpu_torch import nn as tnn
from pci_tpu_torch.convert import flax_to_state_dict
from pci_tpu_torch.models import ISAPCInet, PointINet, PointINet2
from pci_tpu_torch.nn.fusion import _adaptive_budgets, _multi_budgets
from pci_tpu_torch.ops.cuda_kernels import _build, fusion_knn_cuda
from pci_tpu_torch.ops.cuda_kernels.fusion_tail_cuda import fusion_tail_plain
from tests.test_torch_kernel_routes import StubLibrary, cuda_route, read, write  # noqa: F401
from tests.test_torch_shared import shared_result

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
KS = (65, 96, 128)
ROW_TOL = dict(atol=1e-5, rtol=1e-5)  # the fusion rows
POINTINET_TOL = dict(atol=1e-3, rtol=1e-3)  # tests/test_torch_pointinet.py, whole models
POINTINET2_TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_torch_pointinet2.py
J, T = jnp.asarray, torch.from_numpy


def shifted(v):
    """Every 1-D variable shifted, so the norms carry non-trivial affine
    terms and statistics (inside a jit)."""
    return jax.tree_util.tree_map(
        lambda x: x + 0.05 * jnp.arange(x.size, dtype=x.dtype) / x.size if x.ndim == 1 else x, v)


def init_and_apply(module, init_args, apply_args=None, **kw):
    """``module``'s variables from init (key 0, shifted) and its eval output
    on ``apply_args`` (default ``init_args``) with those variables, in one
    jit, and the permutations ``_random_perms`` drew in the apply, in
    order."""
    draws, orig = [], jfusion._random_perms

    def keep(key, B, n):
        p = orig(key, B, n)
        draws.append(p)
        return p

    def run(init_args, apply_args):
        v = module.init({"params": jax.random.key(0), "sample": jax.random.key(1)},
                        *init_args, train=False, **kw)
        v = shifted(v)
        start = len(draws)
        out = module.apply(v, *apply_args, train=False, rngs={"sample": jax.random.key(2)}, **kw)
        return v, out, draws[start:]

    jfusion._random_perms = keep
    try:
        v, out, perms = jax.jit(run)(init_args, init_args if apply_args is None else apply_args)
    finally:
        jfusion._random_perms = orig
    return (jax.tree_util.tree_map(np.asarray, v), jax.tree_util.tree_map(np.asarray, out),
            [np.asarray(p) for p in perms])


def cloud(rng, n, scale=2.0):
    return (rng.standard_normal((1, n, 3)) * scale).astype(np.float32)


# ---- the fusion modules at k = 65, 96, 128 ------------------------------------------


def jax_pair_fusions():
    """PointsFusion and PointsFusionWithFeatures (one channel) over two
    warped clouds, B = 2 at t = 0.3 and 0.6, N = 256: JAX's rows at each of
    ``KS`` and the permutations it drew (two a call)."""
    rng = np.random.default_rng(1901)
    N = 256
    a = np.concatenate([cloud(rng, N) for _ in range(2)])
    b = a + 0.2 * np.concatenate([cloud(rng, N, 1.0) for _ in range(2)])
    fa, fb = (rng.random((2, N, 1)).astype(np.float32) for _ in range(2))
    tt = np.array([0.3, 0.6], np.float32)
    out = {"inputs": (a, b, fa, fb, tt)}
    for name, mod, args in (
            ("xyz", jfusion.PointsFusion((64, 64, 128)), (a, b)),
            ("features", jfusion.PointsFusionWithFeatures((64, 64, 128)), (a, b, fa, fb))):
        jargs = [J(x) for x in args]
        draws, orig = [], jfusion._random_perms

        def keep(key, B, n, _orig=orig, _draws=draws):
            p = _orig(key, B, n)
            _draws.append(p)
            return p

        def run(*jargs_, _mod=mod, _draws=draws):
            v = _mod.init({"params": jax.random.key(0), "sample": jax.random.key(1)},
                          *jargs_, 32, J(tt))
            v = shifted(v)
            start = len(_draws)
            rows = [_mod.apply(v, *jargs_, k, J(tt), rngs={"sample": jax.random.key(2 + k)})
                    for k in KS]
            return v, rows, _draws[start:]

        jfusion._random_perms = keep
        try:
            v, rows, perms = jax.jit(run)(*jargs)
        finally:
            jfusion._random_perms = orig
        out[name] = (jax.tree_util.tree_map(np.asarray, v), [np.asarray(r) for r in rows],
                     [np.asarray(p) for p in perms])
    return out


def jax_multi_fusion():
    """PointsFusionMulti over F = 3 clouds (N = 512, weights ``[1, 12]``):
    JAX's rows at each of ``KS`` and its permutations (three a call)."""
    rng = np.random.default_rng(1902)
    N = 512
    base = cloud(rng, N)
    clouds = [base + 0.3 * cloud(rng, N, 1.0) for _ in range(3)]
    w = np.asarray(jax.nn.softmax(J(rng.standard_normal((1, 12)).astype(np.float32))))
    jm = jfusion.PointsFusionMulti((64, 64, 128))
    draws, orig = [], jfusion._random_perms

    def keep(key, B, n):
        p = orig(key, B, n)
        draws.append(p)
        return p

    def run(c, w):
        v = jm.init({"params": jax.random.key(0), "sample": jax.random.key(1)}, c, 32, w)
        v = shifted(v)
        start = len(draws)
        rows = [jm.apply(v, c, k, w, rngs={"sample": jax.random.key(2 + k)}) for k in KS]
        return v, rows, draws[start:]

    jfusion._random_perms = keep
    try:
        v, rows, perms = jax.jit(run)([J(c) for c in clouds], J(w))
    finally:
        jfusion._random_perms = orig
    return (clouds, w, jax.tree_util.tree_map(np.asarray, v), [np.asarray(r) for r in rows],
            [np.asarray(p) for p in perms])


@pytest.fixture(scope="module")
def pair_fusions(tmp_path_factory):
    return shared_result("fusion_k128_pairs", jax_pair_fusions, tmp_path_factory)


@pytest.fixture(scope="module")
def multi_fusion(tmp_path_factory):
    return shared_result("fusion_k128_multi", jax_multi_fusion, tmp_path_factory)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", ["xyz", "features"])
def test_pair_fusion_matches_jax(pair_fusions, name, k):
    """PointsFusion (``[B, N, 3]``) and PointsFusionWithFeatures (``[B, N,
    4]``) at k past 64 on JAX's permutations: the budgeted two-segment kNN
    (every segment at least its budget: no self-neighbour slot) and the
    head, within 1e-5 of JAX's rows."""
    a, b, fa, fb, tt = pair_fusions["inputs"]
    v, rows, perms = pair_fusions[name]
    i = KS.index(k)
    N1, N2, k1, k2 = _adaptive_budgets(a.shape[1], k, T(tt))
    assert (N1 >= k1).all() and (N2 >= k2).all()
    mod = tnn.PointsFusionWithFeatures() if name == "features" else tnn.PointsFusion()
    mod.load_state_dict(flax_to_state_dict(v))
    args = [T(a), T(b)] + ([T(fa), T(fb)] if name == "features" else [])
    with torch.inference_mode():
        got = mod.eval()(*args, k, T(tt), perms=(T(perms[2 * i]), T(perms[2 * i + 1])))
    assert got.shape == (2, a.shape[1], 4 if name == "features" else 3)
    np.testing.assert_allclose(got.numpy(), rows[i], **ROW_TOL)


@pytest.mark.parametrize("k", KS)
def test_multi_fusion_matches_jax(multi_fusion, k):
    """PointsFusionMulti over three clouds at k past 64 (F segments, every
    one at least its budget) and its GroupNorm head, on JAX's
    permutations, within 1e-5."""
    clouds, w, v, rows, perms = multi_fusion
    i = KS.index(k)
    n_all, k_all = _multi_budgets(clouds[0].shape[1], k, T(w)[:, :2])
    assert (n_all >= k_all).all() and int(k_all.sum()) == k
    mod = tnn.PointsFusionMulti()
    mod.load_state_dict(flax_to_state_dict(v))
    with torch.inference_mode():
        got = mod.eval()([T(c) for c in clouds], k, T(w), perms=[T(p) for p in perms[3 * i:3 * i + 3]])
    np.testing.assert_allclose(got.numpy(), rows[i], **ROW_TOL)


# ---- the models' fusion_k and fusion_sampling ---------------------------------------


def jax_pointinet(width: int, fusion_k: int, sampling: str):
    """JAX PointINet on given flows (N = 512, ``[1, N, width]`` clouds, the
    fourth channel intensity-like): (inputs, flows, variables, output,
    permutations)."""
    rng = np.random.default_rng(1910 + width)
    N = 512
    a = cloud(rng, N)
    b = a + 0.3 * cloud(rng, N, 1.0)
    if width == 4:
        a, b = (np.concatenate([x, rng.random((1, N, 1)).astype(np.float32)], -1)
                for x in (a, b))
    flows = tuple((0.2 * cloud(rng, N, 1.0)) for _ in range(2))
    z = np.zeros((1, N, 3), np.float32)
    tt = np.array([0.4], np.float32)
    model = JPointINet(freeze_flow=True, fusion_k=fusion_k, fusion_sampling=sampling)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFlowNet3D, "__call__", lambda self, *a_, **kw: tuple(J(f) for f in flows))
        v, out, perms = init_and_apply(model, [J(x) for x in (a, b, z, z, tt)])
    return (a, b, z, tt), flows, v, out, perms


POINTINET_CASES = {"k96_xyz": (3, 96, "random"), "k96_intensity": (4, 96, "random"),
                   "fps": (3, 32, "fps")}


@pytest.mark.parametrize("case", sorted(POINTINET_CASES))
def test_pointinet_fusion_fields_match_jax(case, tmp_path_factory):
    """PointINet(fusion_k=96) with xyz and with intensity (JAX's
    permutations), and PointINet(fusion_sampling="fps") (each warped cloud
    ordered by exact greedy FPS over its 512 points from index 0, no
    permutation given), on the same flows: the rows of the JAX model
    within tests/test_torch_pointinet.py's whole-model tolerance."""
    width, fusion_k, sampling = POINTINET_CASES[case]
    (a, b, z, tt), flows, v, want, perms = shared_result(
        f"fusion_k128_pointinet_{case}", lambda: jax_pointinet(width, fusion_k, sampling),
        tmp_path_factory)
    assert len(perms) == (0 if sampling == "fps" else 2)
    model = PointINet(fusion_k=fusion_k, fusion_sampling=sampling)
    missing, unexpected = model.load_state_dict(flax_to_state_dict(v), strict=False)
    assert unexpected == [] and all(m.startswith("flow.") for m in missing)
    model.flow.bidirectional = lambda *a_: tuple(T(f) for f in flows)
    with torch.inference_mode():
        got = model.eval()(T(a), T(b), T(z), T(z), T(tt),
                           perms=tuple(T(p) for p in perms) or None)
    assert got.shape == (1, 512, width)
    np.testing.assert_allclose(got.numpy(), want, **POINTINET_TOL)


def test_pointinet_k96_tree_loads_unchanged():
    """A JAX ``PointINet(fusion_k=96)`` variable tree (FlowNet3D and the
    fusion, initialised on 64 points) loads into the port's
    ``PointINet(fusion_k=96)`` through ``flax_to_state_dict`` strictly,
    key for key the tree of ``fusion_k=32``."""
    x = jnp.zeros((1, 64, 3))
    rngs = {"params": jax.random.key(0), "sample": jax.random.key(1)}
    trees = [jax.eval_shape(lambda k=k: JPointINet(freeze_flow=True, fusion_k=k).init(
        rngs, x, x, x, x, jnp.full((1,), 0.5), train=False)) for k in (32, 96)]
    shapes = [{key: tuple(val.shape) for key, val in flax_to_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)).items()}
        for tree in trees]
    assert shapes[0] == shapes[1]
    model = PointINet(fusion_k=96)
    model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), trees[1])))
    assert {key: tuple(val.shape) for key, val in model.state_dict().items()} == shapes[1]


def jax_isapci():
    """JAX ``ISAPCInet(field=1, ff_out_c=tr_out_c=16, fusion_k=96,
    fusion_sampling="fps")`` on given flows (N = 256), its init and apply in
    one jit: (inputs, flows, variables, the Outputer's two flows, output)."""
    N = 256
    rng = np.random.default_rng(1920)
    fwd, k0, k1, bwd = (cloud(rng, N) for _ in range(4))
    flows = [(0.1 * rng.standard_normal((1, N, 3))).astype(np.float32) for _ in range(4)]
    t = np.array([0.4], np.float32)
    z = np.zeros_like(k0)
    model = JISAPCInet(field=1, ff_out_c=16, tr_out_c=16, fusion_k=96, fusion_sampling="fps")
    args = ([J(fwd)], [J(k0), J(k1)], [J(bwd)], J(t), J(z))

    def run(*a):
        v = shifted(model.init({"params": jax.random.key(0)}, *a, train=False))
        out, state = model.apply(v, *a, train=False, capture_intermediates=True,
                                 mutable=["intermediates"])
        return v, out, state["intermediates"]["outputer"]["__call__"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFlowNet3D, "multi", lambda self, *a_, **kw: [J(f) for f in flows])
        v, out, nets = jax.jit(run)(*args)
    return ((fwd, k0, k1, bwd, t, z), flows, jax.tree_util.tree_map(np.asarray, v),
            [np.asarray(x) for x in nets], np.asarray(out))


def test_isapci_fusion_fields_match_jax(tmp_path_factory):
    """ISAPCInet(field=1, fusion_k=96, fusion_sampling="fps") on the same
    flows: Tnet, PointNet++, the transformer and Outputer against JAX's
    (tests/test_torch_isapci.py's whole-model tolerance), the forward's
    fusion called at k = 96 with no permutation; then that fusion on JAX's
    own warped clouds (FPS over warped clouds that differ by rounding may
    order a near-tied point elsewhere, so each package orders the same
    clouds) against JAX's frame."""
    (fwd, k0, k1, bwd, t, z), flows, v, want_nets, want = shared_result(
        "fusion_k128_isapci", jax_isapci, tmp_path_factory)
    model = ISAPCInet(1, ff_out_c=16, tr_out_c=16, fusion_k=96, fusion_sampling="fps")
    missing, unexpected = model.load_state_dict(flax_to_state_dict(v), strict=False)
    assert unexpected == [] and all(m.startswith("flow.") for m in missing)
    model.flow.multi = lambda clouds, feats, pairs: [T(f) for f in flows]
    nets, calls = [], []
    model.outputer.register_forward_hook(lambda mod, inp, out: nets.append(out.numpy()))
    model.fusion.register_forward_pre_hook(
        lambda mod, a, kw: calls.append((a[2], kw.get("perms"))), with_kwargs=True)
    with torch.inference_mode():
        model.eval()([T(fwd)], [T(k0), T(k1)], [T(bwd)], T(t), T(z))
        assert calls == [(96, None)] and model.fusion.sampling == "fps"
        for got_net, want_net in zip(nets, want_nets, strict=True):
            np.testing.assert_allclose(got_net, want_net, **POINTINET_TOL)
        tb = t[:, None, None]
        got = model.fusion(T(k0 + want_nets[0] * tb), T(k1 + want_nets[1] * (1.0 - tb)), 96,
                           T(t))
    np.testing.assert_allclose(got.numpy(), want, **POINTINET_TOL)


def jax_pointinet2():
    """JAX ``PointINet2(field=1, fusion_k=96)`` on given flows (N = 512):
    (inputs, flows, variables, output, permutations)."""
    N = 512
    rng = np.random.default_rng(1930)
    fwd, k0, k1, bwd = (cloud(rng, N) for _ in range(4))
    ring = [(0.2 * rng.standard_normal((1, N, 3))).astype(np.float32) for _ in range(2)]
    key = tuple((0.2 * rng.standard_normal((1, N, 3))).astype(np.float32) for _ in range(2))
    t = np.array([0.4], np.float32)
    z = np.zeros_like(k0)
    model = JPointINet2(field=1, fusion_k=96)
    args = ([J(fwd)], [J(k0), J(k1)], [J(bwd)], J(t), J(z))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFlowNet3D, "multi", lambda self, *a_, **kw: [J(f) for f in ring])
        mp.setattr(JFlowNet3D, "__call__", lambda self, *a_, **kw: tuple(J(f) for f in key))
        v, out, perms = init_and_apply(model, args)
    return (fwd, k0, k1, bwd, t, z), (ring, key), v, out, perms


def test_pointinet2_fusion_k_matches_jax(tmp_path_factory):
    """PointINet2(field=1, fusion_k=96) on the same flows and JAX's
    permutations: the key PointINet at k = 32, the ring's PointsFusion and
    PointsFusionMulti at k = 96, within tests/test_torch_pointinet2.py's
    tolerance."""
    (fwd, k0, k1, bwd, t, z), (ring, key), v, want, perms = shared_result(
        "fusion_k128_pointinet2", jax_pointinet2, tmp_path_factory)
    assert len(perms) == 2 + 2 + 2
    model = PointINet2(1, fusion_k=96)
    missing, unexpected = model.load_state_dict(flax_to_state_dict(v), strict=False)
    assert unexpected == [] and all(".flow." in f".{m}" for m in missing)
    model.flow.multi = lambda clouds, feats, pairs: [T(f) for f in ring]
    model.pointinet.flow.bidirectional = lambda *a_: tuple(T(f) for f in key)
    with torch.inference_mode():
        got = model.eval()([T(fwd)], [T(k0), T(k1)], [T(bwd)], T(t), T(z),
                           perms=[T(p) for p in perms])
    np.testing.assert_allclose(got.numpy(), want, **POINTINET2_TOL)


@pytest.mark.parametrize("build", [
    lambda: tnn.PointsFusion("farthest"),
    lambda: PointINet(fusion_sampling="grid"),
    lambda: ISAPCInet(1, fusion_sampling="random "),
])
def test_unknown_sampling_raises(build):
    """A sampling other than "random" or "fps" raises ``ValueError``, as
    the JAX module does."""
    with pytest.raises(ValueError, match="unknown sampling"):
        build()


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    """A fresh interpreter imports ``pci_tpu_torch`` and every module under
    it, builds and runs ``PointINet(fusion_k=96)`` on the CPU, and finds
    neither ``jax`` nor ``pci_tpu`` in ``sys.modules``."""
    code = """
import importlib, pkgutil, sys
import torch
import pci_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pci_tpu_torch.__path__, "pci_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from pci_tpu_torch.models import PointINet
model = PointINet(fusion_k=96).eval()
x = torch.randn(1, 128, 3)
with torch.inference_mode():
    out = model(x, x + 0.1, torch.zeros_like(x), torch.zeros_like(x), torch.tensor([0.5]),
                generator=torch.Generator().manual_seed(0))
assert out.shape == (1, 128, 3) and bool(torch.isfinite(out).all())
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "pci_tpu"))
print(len(names), bad)
"""
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "2", "HOME": str(tmp_path)}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    n, bad = res.stdout.split(" ", 1)
    assert int(n) > 30 and bad.strip() == "[]", res.stdout


# ---- the launches on the forced CUDA route ----------------------------------------


def _stub_fusion(k: int, width: int):
    """A seeded port fusion module in eval mode (non-trivial BatchNorm
    statistics) and its arguments: two ``[1, 256, 3]`` warped clouds, features of ``width
    - 3`` channels or none, t, and two permutations."""
    from pci_tpu_torch.serving import init_weights

    rng = np.random.default_rng(1940 + k)
    N = 256
    a = cloud(rng, N)
    b = a + 0.2 * cloud(rng, N, 1.0)
    mod = tnn.PointsFusionWithFeatures()
    init_weights(mod, 1941)
    with torch.no_grad():
        for buf in mod.buffers():
            buf += 0.01 * torch.arange(buf.numel(), dtype=buf.dtype).reshape(buf.shape)
    feats = [T(rng.random((1, N, width - 3)).astype(np.float32)) for _ in range(2)] \
        if width > 3 else [None, None]
    perms = tuple(T(rng.permutation(N)[None]) for _ in range(2))
    return mod.eval(), [T(a), T(b), *feats], torch.tensor([0.35]), perms


@pytest.mark.parametrize("width", [3, 4])
@pytest.mark.parametrize("mode, entries", [
    ("eval_oneshot", ["pci_fusion128"]),
    ("eval_two_kernels", ["pci_fusion_resi", "pci_fusion_tail"]),
    ("train", ["pci_fusion_resi"]),
])
def test_k96_launches_the_k128_kernels(cuda_route, monkeypatch, mode, entries, width):
    """At k = 96 the forced CUDA route launches rows 4, 4b and 7 with k = 96:
    the one-shot kernel's k <= 128 entry at eval (with the payload at width
    4, ``Cp = 1``), the residual kNN (its k > 64 kernel: no parts, no
    stamps) and the tail with one-shot off, the residual kNN in training;
    the stubs write the plain versions' results, and the rows (and in
    training the gradients into both clouds) equal the plain route's."""
    import pci_tpu_torch.nn.fusion as tfusion

    monkeypatch.setattr(tfusion, "_fusion_oneshot_ok",
                        lambda train, x: mode == "eval_oneshot" and not train)
    k, Cp = 96, width - 3
    mod, args, tt, perms = _stub_fusion(k, width)
    seen = {}

    def resi(pts, ends, buds, F, oi, orr, B, N, k_, parts, stamps, stream):
        assert (k_, F, parts, stamps) == (k, 2, 0, None)
        x = read(pts, (B, N, 3))
        i, r = fusion_knn_cuda.fusion_resi_plain(
            x, read(ends, (B, F), ctypes.c_int32), read(buds, (B, F), ctypes.c_int32), k_)
        seen["resi"] = (x, r)
        write(oi, i)
        write(orr, r)

    def tail(comb, res, extra, wbuf, h1, h2, h3, out, B, N, k_, Ce, stream):
        assert (k_, Ce) == (k, Cp)
        x, r = seen["resi"]
        write(out, fusion_tail_plain(x, r, read(extra, (B, N, k_, Ce)) if Ce else None,
                                     mod.mlp.folded()))

    def oneshot(pts, seg, wtc, h1, h2, h3, payload, Cp_, out, B, N, stream):
        assert Cp_ == Cp and (payload is not None) == bool(Cp)
        x = read(pts, (B, N, 3))
        s4 = read(seg, (B, 4), ctypes.c_int32)
        assert int(s4[0, 2] + s4[0, 3]) == k
        pay = read(payload, (B, N, Cp)) if Cp else None
        write(out, fusion_knn_cuda.fusion_plain(x, s4[:, :2], s4[:, 2:], mod.mlp.folded(), k,
                                                pay))

    stub = cuda_route(StubLibrary(pci_fusion_resi=resi, pci_fusion_tail=tail,
                                  pci_fusion128=oneshot))
    outs = []
    for plain in (False, True):
        m = copy.deepcopy(mod)
        xs = [x.clone().requires_grad_() if x is not None and i < 2 and mode == "train" else x
              for i, x in enumerate(args)]
        with (_build.plain_versions() if plain else contextlib.nullcontext()), \
                (torch.inference_mode() if mode != "train" else contextlib.nullcontext()):
            out = (m.train() if mode == "train" else m.eval())(*xs, k, tt, perms=perms)
            if mode == "train":
                out.sum().backward()
        if not plain:
            assert [n for n, _ in stub.calls] == entries
        outs.append([out.detach()] + ([xs[0].grad, xs[1].grad] if mode == "train" else []))
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("oneshot", [True, False])
def test_k160_launches_the_tail_alone(cuda_route, monkeypatch, oneshot):
    """At k = 160 (past the flat kernels' k <= 128) the forced route at eval
    runs the kNN's plain version and launches the tail once at k = 160,
    either one-shot gate; PointsFusionMulti at k = 160 launches nothing
    (its GroupNorm head is PyTorch's); the rows equal the plain route's."""
    import pci_tpu_torch.nn.fusion as tfusion

    monkeypatch.setattr(tfusion, "_fusion_oneshot_ok", lambda train, x: oneshot and not train)
    k = 160
    mod, args, tt, perms = _stub_fusion(k, 3)

    def tail(comb, res, extra, wbuf, h1, h2, h3, out, B, N, k_, Ce, stream):
        assert (k_, Ce) == (k, 0)
        write(out, fusion_tail_plain(read(comb, (B, N, 3)), read(res, (B, N, k_, 3)), None,
                                     mod.mlp.folded()))

    stub = cuda_route(StubLibrary(pci_fusion_tail=tail))
    with torch.inference_mode():
        got = mod.eval()(*args, k, tt, perms=perms)
        assert [n for n, _ in stub.calls] == ["pci_fusion_tail"]
        multi = tnn.PointsFusionMulti().eval()
        w = torch.softmax(torch.arange(6.0)[None], -1)
        multi([args[0], args[1]], k, w, perms=list(perms))
        assert [n for n, _ in stub.calls] == ["pci_fusion_tail"]
        with _build.plain_versions():
            want = mod(*args, k, tt, perms=perms)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
