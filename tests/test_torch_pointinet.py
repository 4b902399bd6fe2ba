"""The port's FlowNet3D and PointINet end to end against the JAX package, on
CPU, plus the serving API, the trained-weights export and the device rule.

Weights come from flax ``init`` (FlowNet3D with key 0: the golden case's
weights) and reach the port through ``pci_tpu_torch.convert``.  Tolerance
1e-3 for whole models (summation order over ~10 fp32 stages), except the
golden pin, whose clouds repeat FPS picks (N=96 < npoint=1024) and stay
within the JAX suite's own 1e-4 golden bound.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pci_tpu.nn.fusion as jfusion
from pci_tpu.models import FlowNet3D as JFlowNet3D
from pci_tpu_torch.convert import flax_to_state_dict, load_npz_tree
from pci_tpu_torch.models import FlowNet3D, PointINet
from pci_tpu_torch.serving import DEFAULT_WEIGHTS, Interpolator
from tests.test_torch_shared import shared_result

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
MODEL_TOL = dict(atol=1e-3, rtol=1e-3)


def golden_clouds():
    """tests/golden_cases.py's FlowNet3D inputs: seed 1, two [1, 96, 3]."""
    rng = np.random.default_rng(1)
    return [(rng.standard_normal((1, 96, 3)) * 2).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def flow_vars(tmp_path_factory):
    """FlowNet3D variables from init with key 0 (the golden case), once a
    test run."""
    return shared_result("flownet3d_golden_vars", jax_flow_vars, tmp_path_factory)


def jax_flow_vars():
    x1, x2 = (jnp.asarray(c) for c in golden_clouds())
    z = jnp.zeros_like(x1)
    v = jax.jit(lambda: JFlowNet3D().init(jax.random.key(0), x1, x2, z, z, train=False))()
    return jax.tree_util.tree_map(np.asarray, v)


def shifted(v):
    return jax.tree_util.tree_map(
        lambda x: x + 0.05 * np.arange(x.size, dtype=x.dtype) / x.size
        if x.ndim == 1 else x, v)


def port_flownet(v):
    m = FlowNet3D()
    m.load_state_dict(flax_to_state_dict(v))
    return m.eval()


def pair(seed, n):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((1, n, 3)) * 2).astype(np.float32)
    b = a + 0.3 * rng.standard_normal((1, n, 3)).astype(np.float32)
    return a, b


def test_flownet3d_matches_golden(flow_vars):
    """Port vs the committed flownet3d golden (N=96, so every FPS level
    past 96 repeats index 0, as the greedy loop does)."""
    x1, x2 = golden_clouds()
    z = np.zeros_like(x1)
    with torch.inference_mode():
        got = port_flownet(flow_vars)(*(torch.from_numpy(a) for a in (x1, x2, z, z)))
    want = np.load(ROOT / "tests" / "golden" / "model_outputs.npz")["flownet3d"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_flownet3d_bidirectional_matches_jax(flow_vars):
    v = shifted(flow_vars)
    a, b = pair(300, 1024)
    z = np.zeros_like(a)
    J = jnp.asarray
    j12, j21 = jax.jit(lambda v, *x: JFlowNet3D().apply(v, *x, train=False, bidirectional=True))(
        v, J(a), J(b), J(z), J(z))
    with torch.inference_mode():
        t12, t21 = port_flownet(v).bidirectional(*(torch.from_numpy(x) for x in (a, b, z, z)))
    np.testing.assert_allclose(t12.numpy(), np.asarray(j12), **MODEL_TOL)
    np.testing.assert_allclose(t21.numpy(), np.asarray(j21), **MODEL_TOL)


@pytest.mark.parametrize("t", [0.4, 0.75])
def test_pointinet_matches_jax(flow_vars, monkeypatch, t):
    """PointINet at N=1024 with the same fusion permutations on both sides
    (the JAX draw is replaced by the numpy permutations the port gets)."""
    from pci_tpu.models import PointINet as JPointINet

    N = 1024
    a, b = pair(301, N)
    z = np.zeros_like(a)
    rng = np.random.default_rng(302)
    p1, p2 = (rng.permutation(N)[None].astype(np.int32) for _ in range(2))
    tt = np.array([t], np.float32)
    J = jnp.asarray
    fus = jax.jit(lambda a, b, tt: jfusion.PointsFusion((64, 64, 128)).init(
        {"params": jax.random.key(3), "sample": jax.random.key(4)}, a, b, 32, tt))(
        J(a), J(b), J(tt))
    v = shifted({
        "params": {"flow": flow_vars["params"], "fusion": fus["params"]},
        "batch_stats": {"flow": flow_vars["batch_stats"],
                        "fusion": fus["batch_stats"]},
    })
    v = jax.tree_util.tree_map(np.asarray, v)
    draws = iter([p1, p2])
    monkeypatch.setattr(jfusion, "_random_perms", lambda key, B, n: J(next(draws)))
    want = jax.jit(lambda v, *x: JPointINet(freeze_flow=True).apply(
        v, *x, train=False, rngs={"sample": jax.random.key(5)}))(v, J(a), J(b), J(z), J(z), J(tt))
    model = PointINet()
    model.load_state_dict(flax_to_state_dict(v))
    with torch.inference_mode():
        got = model.eval()(*(torch.from_numpy(x) for x in (a, b, z, z, tt)),
                           perms=(torch.from_numpy(p1), torch.from_numpy(p2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_exported_weights_equal_orbax_checkpoint():
    """pci_tpu_torch/assets/pointinet_synth16k.npz holds, key for key, the
    orbax checkpoint results/checkpoints/pointinet_synth16k."""
    from pci_tpu.models import PointINet as JPointINet
    from pci_tpu.train import load_params

    z = jnp.zeros((1, 64, 3))
    rngs = {"params": jax.random.key(0), "sample": jax.random.key(1)}
    abstract = jax.eval_shape(lambda: JPointINet(freeze_flow=True).init(
        rngs, z, z, z, z, jnp.asarray([0.5]), train=False))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), abstract)
    v = load_params(str(ROOT / "results" / "checkpoints" / "pointinet_synth16k"), template)
    flat = {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
        for path, x in jax.tree_util.tree_flatten_with_path(v)[0]
    }
    with np.load(DEFAULT_WEIGHTS) as npz:
        assert sorted(npz.files) == sorted(flat)
        for key, val in flat.items():
            assert npz[key].dtype == np.float32
            np.testing.assert_array_equal(npz[key], val, err_msg=key)
    PointINet().load_state_dict(flax_to_state_dict(load_npz_tree(DEFAULT_WEIGHTS)))


def test_interpolator_serves_frames_on_cpu():
    """Interpolator.pointinet with the trained weights: one call and an
    upsample, [npoints, 3] finite frames."""
    it = Interpolator.pointinet(npoints=512, weights=DEFAULT_WEIGHTS, device="cpu")
    a, b = pair(303, 700)  # resampled to 512 points
    frame = it(a[0], b[0], 0.5)
    assert frame.shape == (512, 3) and np.isfinite(frame).all()
    frames = it.upsample(a[0], b[0], factor=3)
    assert len(frames) == 2 and all(f.shape == (512, 3) for f in frames)


def test_prep_branches():
    """``_prep`` (``tests/test_serving.py``'s shapes): subsample a larger
    scan, pad a smaller one, pass an exact-size one and a pre-batched
    ``[1, N, 3]`` cloud through as they are."""
    rng = np.random.default_rng(3)
    it = Interpolator.pointinet(npoints=64, device="cpu")
    big = rng.standard_normal((100, 3)).astype(np.float32)
    small = rng.standard_normal((40, 5)).astype(np.float32)
    exact = rng.standard_normal((64, 3)).astype(np.float32)
    for cloud in (big, small, exact, exact[None]):
        out = it._prep(cloud)
        assert tuple(out.shape) == (1, 64, 3) and torch.isfinite(out).all()
    np.testing.assert_array_equal(it._prep(exact)[0].numpy(), exact)
    np.testing.assert_array_equal(it._prep(exact[None]).numpy(), exact[None])
    padded = it._prep(small)[0].numpy()
    for row in small[:, :3]:
        assert (np.abs(padded - row).sum(-1) < 1e-6).any()


def test_interpolator_needs_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Interpolator.pointinet(npoints=64)
