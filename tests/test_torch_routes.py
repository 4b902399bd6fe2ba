"""The port's default eval routes against the JAX package's, on CPU: the
FlowNet3D megakernels (flowenc, flowmid), kNN-conv's linear ``n_final``
tail, the fusion's attention tail, the route gates, FlowNet3D's fused route
(against JAX's fused route and the port's per-stage route), PointINet with
the one-shot fusion off, and ``Interpolator.stream_batch``.

Inputs come from numpy with a fixed seed per test.  The Pallas kernels run
in interpret mode and the JAX routes are switched on through the JAX
package's own gates, as its tests do (``tests/test_models.py``); the port's
gates are patched the same way, so its fused route runs its plain versions
here.  Tolerances: stage outputs atol = rtol = 2e-4 (summation order, as in
tests/test_torch_ops.py), FPS centres exact; the attention tail 1e-5 (one
fp32 MLP and softmax); whole FlowNet3D against JAX's fused route rtol 1e-3 /
atol 3e-4, the JAX suite's own bound for its fused decode against its XLA
route (its kNN ranks by mantissa-packed keys); the port's two routes 1e-5
(they differ only in folding the classifier's BatchNorm); whole models
1e-3 (tests/test_torch_pointinet.py's bound).
"""

from __future__ import annotations

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pci_tpu.models.flownet3d as jflownet
import pci_tpu.nn.fusion as jfusion
import pci_tpu_torch.models.flownet3d as tflownet
import pci_tpu_torch.nn.fusion as tfusion
from pci_tpu.models import FlowNet3D as JFlowNet3D
from pci_tpu.ops.pallas_kernels import flowenc_tpu, flowmid_tpu, fusion_tail_tpu, knnconv_tpu
from pci_tpu_torch.convert import flax_to_state_dict, load_npz_tree
from pci_tpu_torch.models import FlowNet3D, PointINet
from pci_tpu_torch.ops.cuda_kernels import (
    flowenc_cuda,
    flowmid_cuda,
    fusion_tail_cuda,
    knnconv_cuda,
)
from pci_tpu_torch.serving import DEFAULT_WEIGHTS, Interpolator

torch.set_num_threads(2)

J = jnp.asarray
STAGE_TOL = dict(atol=2e-4, rtol=2e-4)
MODEL_TOL = dict(atol=1e-3, rtol=1e-3)


def T(x):
    return torch.from_numpy(np.array(x))


def cloud(rng, b, n, c=3, scale=1.0):
    return (rng.standard_normal((b, n, c)) * scale).astype(np.float32)


def folded_layers(rng, widths):
    """Random folded MLP: JAX flat ``(WT, b, ...)`` and the port's
    ``[(W, b), ...]`` (both ``W [cout, cin]``)."""
    flat, layers = [], []
    for cin, cout in zip(widths[:-1], widths[1:]):
        w = (rng.standard_normal((cout, cin)) / np.sqrt(cin)).astype(np.float32)
        b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
        flat += [J(w), J(b)]
        layers.append((T(w), T(b)))
    return tuple(flat), layers


def grid(x, step=1 / 16):
    """Coordinates on a grid: squared distances are exact in fp32 and
    distinct ones differ by more than the mantissa bits the Pallas kNN
    drops to pack its keys (below 128), so its ranking equals the exact
    one and ties go to the lower index on both sides."""
    return (np.round(x / step) * step).astype(np.float32)


def trained(sub=None):
    """The trained PointINet's variables (pci_tpu_torch/assets), or those
    of its ``flow`` or ``fusion`` sub-tree."""
    tree = load_npz_tree(DEFAULT_WEIGHTS)
    return tree if sub is None else {k: v[sub] for k, v in tree.items()}


def routes_on(monkeypatch, on=True):
    """The port's two FlowNet3D gates forced on (or off) for any device."""
    for gate in ("_enc_ok", "_mid_ok"):
        monkeypatch.setattr(tflownet, gate, lambda train, x: on and not train)


# ---- the gates -----------------------------------------------------------


@pytest.mark.parametrize("gate,env", [(tflownet._enc_ok, "PCI_TPU_ENC_KERNEL"),
                                      (tflownet._mid_ok, "PCI_TPU_MID_KERNEL"),
                                      (tfusion._fusion_oneshot_ok, "PCI_TPU_FUSION_ONESHOT")])
def test_route_gates(monkeypatch, gate, env):
    """True at eval on a CUDA tensor; the JAX gate's environment variable,
    read at call time with default "1", turns it off; false in training
    and for CPU tensors."""
    cuda, cpu = types.SimpleNamespace(is_cuda=True), torch.zeros(1)
    monkeypatch.delenv(env, raising=False)
    assert gate(False, cuda) and not gate(True, cuda) and not gate(False, cpu)
    monkeypatch.setenv(env, "0")
    assert not gate(False, cuda)
    monkeypatch.setenv(env, "1")
    assert gate(False, cuda)


# ---- the kernels' plain versions against the Pallas kernels --------------


def test_flowenc_plain_matches_pallas():
    """flowenc_fused (plain) vs flowenc_tpu.flowenc_fused (interpret) at
    B=2, N=512, S1=256, S2=128 with FlowNet3D's radii, K and widths:
    f_1, f_2 within 2e-4, set_conv2's in-kernel FPS centres exact."""
    rng = np.random.default_rng(600)
    xyz, feats = cloud(rng, 2, 512), cloud(rng, 2, 512)
    c1 = xyz[:, ::2].copy()
    flat1, l1 = folded_layers(rng, (6, 32, 32, 64))
    flat2, l2 = folded_layers(rng, (67, 64, 64, 128))
    want = flowenc_tpu.flowenc_fused(J(xyz), J(feats), J(c1), flat1 + flat2, 128,
                                     0.5, 16, 1.0, 16, 3, 3, True)
    got = flowenc_cuda.flowenc_fused(T(xyz), T(feats), T(c1), l1, l2, 128,
                                     0.5, 16, 1.0, 16)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STAGE_TOL)


@pytest.mark.parametrize("mode", ["interp", "mlp1"])
def test_knnconv_n_final_matches_pallas(mode):
    """knnconv_fused (plain) with n_final=1 vs knnconv_tpu.knnconv_fused
    (interpret): the 3-NN interpolation with the classifier-like linear
    last layer (FlowNet3D's fused FeaturePropagation) and a kNN group with
    MLP1."""
    rng = np.random.default_rng({"interp": 601, "mlp1": 602}[mode])
    q, keys = cloud(rng, 2, 128, scale=2.0), cloud(rng, 2, 48, scale=2.0)
    kf, skip = cloud(rng, 2, 48, 10), cloud(rng, 2, 128, 5)
    if mode == "interp":
        (f1, l1), k = ((), []), 3
        f2, l2 = folded_layers(rng, (15, 24, 16, 3))
    else:
        (f1, l1), k = folded_layers(rng, (13, 16, 24)), 4
        f2, l2 = folded_layers(rng, (29, 16, 3))
    want = knnconv_tpu.knnconv_fused(J(q), J(keys), J(kf), None, J(skip), k, f1, f2,
                                      len(l1), len(l2), True, mode == "interp", "clamp", 1)
    got = knnconv_cuda.knnconv_fused(T(q), T(keys), T(kf), None, T(skip), k, l1, l2,
                                     interp=mode == "interp", n_final=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STAGE_TOL)
    assert (np.asarray(want) < 0).any()  # the last layer is linear


@pytest.mark.parametrize("ce", [0, 1])
def test_fusion_tail_plain_matches_pallas(ce):
    """fusion_attention_tail (plain) vs fusion_tail_tpu (interpret) with
    the 4 -> 64 -> 64 -> 128 score MLP, k=32, with and without a payload
    channel: within 1e-5."""
    rng = np.random.default_rng(603 + ce)
    B, N, k = 2, 96, 32
    combined, resi = cloud(rng, B, N), cloud(rng, B, N * k, scale=0.3).reshape(B, N, k, 3)
    extra = cloud(rng, B, N * k, ce).reshape(B, N, k, ce) if ce else None
    flat, layers = folded_layers(rng, (4, 64, 64, 128))
    want = fusion_tail_tpu.fusion_attention_tail(
        J(combined), J(resi), None if extra is None else J(extra), flat, 3, True)
    got = fusion_tail_cuda.fusion_attention_tail(
        T(combined), T(resi), None if extra is None else T(extra), layers)
    assert got.shape == (B, N, 3 + ce)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# ---- FlowNet3D's fused route ----------------------------------------------


@pytest.fixture(scope="module")
def jax_fused():
    """JAX's FlowNet3D on its fused route (both gates on, interpret mode)
    at tests/test_models.py's sizes (B=2, N=160, clouds of scale 2, here on
    a grid), with the trained weights; the megakernel's inputs and outputs
    recorded."""
    rng = np.random.default_rng(610)
    x1, x2 = grid(cloud(rng, 2, 160, scale=2.0)), grid(cloud(rng, 2, 160, scale=2.0))
    z = np.zeros_like(x1)
    net, v = JFlowNet3D(), trained("flow")
    calls = {}

    def recorded(mod, name):
        fn = getattr(mod, name)

        def rec(*args, **kw):
            out = fn(*args, **kw)
            calls.setdefault(name, []).append((args, out))
            return out
        return rec

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jflownet, "_enc_ok", lambda train: not train)
        mp.setattr(jflownet, "_mid_ok", lambda train: not train)
        mp.setattr(flowmid_tpu, "flowmid_fused", recorded(flowmid_tpu, "flowmid_fused"))
        flow = net.apply(v, J(x1), J(x2), J(z), J(z), train=False)
    return {"x": (x1, x2, z), "v": v, "flow": np.asarray(flow), "calls": calls}


def port_flownet(v):
    m = FlowNet3D()
    m.load_state_dict(flax_to_state_dict(v))
    return m.eval()


def test_flowmid_plain_matches_pallas(jax_fused):
    """flowmid_fused (plain) vs flowmid_tpu.flowmid_fused (interpret) at
    FlowNet3D's widths and counts (pa_1 1,024, pa_2 256; the eight folded
    groups of _N_LAYERS), on the inputs of JAX's fused FlowNet3D: within
    2e-4."""
    (args, want), = jax_fused["calls"]["flowmid_fused"][:1]
    flat, off, groups = args[6], 0, []
    for n in flowmid_tpu._N_LAYERS:
        groups.append([(T(flat[2 * j]), T(flat[2 * j + 1])) for j in range(off, off + n)])
        off += n
    got = flowmid_cuda.flowmid_fused(*[T(a) for a in args[:6]], groups, *args[7:15])
    assert got.shape == (2, 1024, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STAGE_TOL)


def test_flownet3d_fused_matches_jax_fused(jax_fused, monkeypatch):
    """The port's fused route (flowenc, flowmid, kNN-conv with the
    classifier, plain versions) vs JAX's fused route: rtol 1e-3 / atol
    3e-4."""
    routes_on(monkeypatch)
    with torch.inference_mode():
        got = port_flownet(jax_fused["v"])(*(T(a) for a in jax_fused["x"][:2]),
                                           T(jax_fused["x"][2]), T(jax_fused["x"][2]))
    np.testing.assert_allclose(got.numpy(), jax_fused["flow"], rtol=1e-3, atol=3e-4)


def test_flownet3d_fused_matches_per_stage(monkeypatch):
    """The port's two routes on one pair (B=2, N=300, the trained
    weights): the same picks and the same arithmetic but the classifier's
    fold, within 1e-5."""
    rng = np.random.default_rng(611)
    a = cloud(rng, 2, 300, scale=3.0)
    b = a + 0.2 * cloud(rng, 2, 300)
    z = np.zeros_like(a)
    model = port_flownet(trained("flow"))
    flows = []
    for on in (False, True):
        routes_on(monkeypatch, on)
        with torch.inference_mode():
            flows.append(model.bidirectional(T(a), T(b), T(z), T(z)))
    for per_stage, fused in zip(*flows):
        torch.testing.assert_close(fused, per_stage, atol=1e-5, rtol=1e-5)


# ---- PointINet with the one-shot fusion off, stream_batch -----------------


def test_pointinet_oneshot_off_matches_jax(monkeypatch):
    """PointINet (B=2 at t 0.3 and 0.7, N=256, the trained weights) with
    the one-shot fusion off: the port's residual kNN + attention tail
    (plain) vs JAX's route of residuals then fusion_attention_tail
    (interpret; its residuals from the exact XLA kNN, which the port's
    residual kNN holds to, tests/test_torch_train.py), with the same
    permutations: 1e-3."""
    from pci_tpu.models import PointINet as JPointINet

    N = 256
    rng = np.random.default_rng(612)
    a = cloud(rng, 2, N, scale=2.0)
    b = a + 0.3 * cloud(rng, 2, N)
    z = np.zeros_like(a)
    p1, p2 = (np.stack([rng.permutation(N) for _ in range(2)]).astype(np.int32)
              for _ in range(2))
    tt = np.array([0.3, 0.7], np.float32)
    net, v = JPointINet(freeze_flow=True), trained()
    draws = iter([p1, p2])
    monkeypatch.setattr(jfusion, "_random_perms", lambda key, B, n: J(next(draws)))
    monkeypatch.setattr(jfusion, "_fusion_tail_ok", lambda train: not train)
    monkeypatch.setattr(jfusion, "_fusion_oneshot_ok", lambda train: False)
    monkeypatch.setattr(fusion_tail_tpu, "fusion_attention_tail", functools.partial(
        fusion_tail_tpu.fusion_attention_tail, interpret=True))
    want = jax.jit(lambda *x: net.apply(v, *x, train=False, rngs={"sample": jax.random.key(5)}))(
        J(a), J(b), J(z), J(z), J(tt))
    monkeypatch.setattr(tfusion, "_fusion_oneshot_ok", lambda train, x: False)
    model = PointINet()
    model.load_state_dict(flax_to_state_dict(v))
    with torch.inference_mode():
        got = model.eval()(T(a), T(b), T(z), T(z), T(tt), perms=(T(p1), T(p2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("route", ["fused", "per_stage"])
def test_stream_batch_equals_single_calls(monkeypatch, route):
    """Interpolator.stream_batch of four streams at four distinct t, with
    injected permutations, equals four single calls given each stream's
    permutations (1e-5: the plain dense layers' CPU blocking may differ
    with the batch)."""
    routes_on(monkeypatch, route == "fused")
    N, ts = 256, [0.2, 0.45, 0.6, 0.85]
    rng = np.random.default_rng(613)
    pairs = [(c, c + 0.2 * cloud(rng, 1, N)[0]) for c in cloud(rng, 4, N, scale=3.0)]
    perms = tuple(torch.from_numpy(np.stack([rng.permutation(N) for _ in ts])) for _ in range(2))
    interp = Interpolator.pointinet(npoints=N, weights=DEFAULT_WEIGHTS, device="cpu")
    frames = interp.stream_batch(pairs, ts, perms=perms)
    assert len(frames) == 4
    for i, ((a, b), t) in enumerate(zip(pairs, ts)):
        single = interp(a, b, t, perms=(perms[0][i:i + 1], perms[1][i:i + 1]))
        assert frames[i].shape == (N, 3) and np.isfinite(frames[i]).all()
        np.testing.assert_allclose(frames[i], single, atol=1e-5, rtol=1e-5)
    assert not np.allclose(frames[0], frames[3], atol=1e-2)


def test_stream_batch_refuses_mesh_and_windows():
    interp = Interpolator.pointinet(npoints=64, device="cpu")
    pair = [(np.zeros((64, 3), np.float32),) * 2]
    with pytest.raises(NotImplementedError):
        interp.stream_batch(pair, [0.5], mesh=object())
    with pytest.raises(ValueError):
        interp.stream_batch(pair, [0.5, 0.6])
    with pytest.raises(ValueError):
        Interpolator.isapci(field=1, npoints=64, device="cpu").stream_batch(pair, [0.5])
