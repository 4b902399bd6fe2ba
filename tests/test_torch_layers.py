"""The port's FlowNet3D layers against the JAX package's flax modules, CPU.

Weights come from the flax module's ``init`` (with every 1-D variable
shifted, so BatchNorm statistics and biases are non-trivial) and reach
the port through ``pci_tpu_torch.convert``.  Inputs come from numpy with a
fixed seed per test.  Tolerance atol=rtol=2e-4 in fp32 (the JAX package's
own kernel-parity bound, tests/test_layers.py): the port folds BatchNorm
into the weights and sums in another order.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pci_tpu.nn as jnn
from pci_tpu_torch import nn as tnn
from pci_tpu_torch.convert import flax_to_state_dict

torch.set_num_threads(2)

TOL = dict(atol=2e-4, rtol=2e-4)


def cloud(rng, b, n, c=3, scale=2.0):
    return (rng.standard_normal((b, n, c)) * scale).astype(np.float32)


def shifted(variables):
    """Non-trivial BatchNorm stats / biases (variances stay positive)."""
    return jax.tree_util.tree_map(
        lambda x: x + 0.05 * jnp.arange(x.size, dtype=x.dtype) / x.size
        if x.ndim == 1 else x,
        variables,
    )


def port(module, variables):
    module.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, variables)))
    return module.eval()


def run(module, *arrays):
    with torch.inference_mode():
        out = module(*(torch.from_numpy(a) for a in arrays))
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def test_point_mlp_fold_matches_flax():
    """PointMLP (Dense -> BatchNorm eps 1e-3 -> ReLU) and its folded
    chain both equal the flax module in eval mode."""
    rng = np.random.default_rng(200)
    x = cloud(rng, 2, 50, 7, scale=1.0)
    jm = jnn.PointMLP((16, 24, 8))
    v = shifted(jm.init(jax.random.key(0), jnp.asarray(x)))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = port(tnn.PointMLP(7, (16, 24, 8)), v)
    np.testing.assert_allclose(run(tm, x), want, **TOL)
    h = torch.from_numpy(x)
    for w, b in tm.folded():
        h = torch.relu(h @ w.T + b)
    np.testing.assert_allclose(h.numpy(), want, **TOL)


def test_set_conv_matches_flax():
    rng = np.random.default_rng(201)
    xyz, feats = cloud(rng, 2, 512), cloud(rng, 2, 512, 5, scale=1.0)
    jm = jnn.SetConv(64, 0.6, 8, (16, 16, 32))
    v = shifted(jm.init(jax.random.key(0), jnp.asarray(xyz), jnp.asarray(feats)))
    jx, jf = jm.apply(v, jnp.asarray(xyz), jnp.asarray(feats))
    tx, tf = run(port(tnn.SetConv(64, 0.6, 8, (16, 16, 32), 5), v), xyz, feats)
    np.testing.assert_array_equal(tx, np.asarray(jx))
    np.testing.assert_allclose(tf, np.asarray(jf), **TOL)


def test_flow_embedding_matches_flax():
    rng = np.random.default_rng(202)
    a, b = cloud(rng, 2, 96), cloud(rng, 2, 96)
    f1, f2 = cloud(rng, 2, 96, 6, scale=1.0), cloud(rng, 2, 96, 6, scale=1.0)
    jm = jnn.FlowEmbedding(8, (16, 16, 32))
    v = shifted(jm.init(jax.random.key(0), *(jnp.asarray(x) for x in (a, b, f1, f2))))
    want = np.asarray(jm.apply(v, *(jnp.asarray(x) for x in (a, b, f1, f2))))
    got = run(port(tnn.FlowEmbedding(8, (16, 16, 32), 6, 6), v), a, b, f1, f2)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mlp1", [(), (16, 24)])
def test_set_upconv_matches_flax(mlp1):
    """Both the empty-MLP1 case (set_upconv1) and the full one."""
    rng = np.random.default_rng(203)
    coarse, dense = cloud(rng, 2, 32), cloud(rng, 2, 128)
    cf, df = cloud(rng, 2, 32, 10, scale=1.0), cloud(rng, 2, 128, 5, scale=1.0)
    args = (coarse, dense, cf, df)
    jm = jnn.SetUpConv(4, mlp1, (24, 16))
    v = shifted(jm.init(jax.random.key(0), *(jnp.asarray(x) for x in args)))
    want = np.asarray(jm.apply(v, *(jnp.asarray(x) for x in args)))
    got = run(port(tnn.SetUpConv(4, mlp1, (24, 16), 10, 5), v), *args)
    np.testing.assert_allclose(got, want, **TOL)


def test_feature_propagation_matches_flax():
    rng = np.random.default_rng(204)
    sub, dense = cloud(rng, 2, 48), cloud(rng, 2, 160)
    sf, df = cloud(rng, 2, 48, 12, scale=1.0), cloud(rng, 2, 160, 5, scale=1.0)
    args = (sub, dense, sf, df)
    jm = jnn.FeaturePropagation((24, 16))
    v = shifted(jm.init(jax.random.key(0), *(jnp.asarray(x) for x in args)))
    want = np.asarray(jm.apply(v, *(jnp.asarray(x) for x in args)))
    got = run(port(tnn.FeaturePropagation((24, 16), 12, 5), v), *args)
    np.testing.assert_allclose(got, want, **TOL)


def test_classifier_matches_flax():
    rng = np.random.default_rng(205)
    x = cloud(rng, 2, 40, 256, scale=1.0)
    jm = jnn.layers.Classifier()
    v = shifted(jm.init(jax.random.key(0), jnp.asarray(x)))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(run(port(tnn.Classifier(), v), x), want, **TOL)


def test_layers_refuse_train_mode():
    """The port is eval-only: a module left in train mode raises instead
    of running BatchNorm on running statistics by mistake."""
    rng = np.random.default_rng(206)
    m = tnn.SetConv(8, 0.5, 4, (8,), 3)
    xyz = torch.from_numpy(cloud(rng, 1, 32))
    with torch.no_grad(), pytest.raises(RuntimeError, match="eval only"):
        m(xyz, xyz)
    m.eval()
    with torch.no_grad():
        assert m(xyz, xyz)[1].shape == (1, 8, 8)


def test_folded_weights_follow_updates():
    """PointMLP.folded() caches its fold, and refolds after the weights
    change (load_state_dict copies in place)."""
    m = tnn.PointMLP(4, (8,)).eval()
    first = m.folded()
    assert m.folded() is first
    sd = {k: v + 1.0 for k, v in m.state_dict().items()}
    m.load_state_dict(sd)
    second = m.folded()
    assert second is not first
    torch.testing.assert_close(second[0][1], m.folded()[0][1])
    assert not torch.equal(second[0][0], first[0][0])
