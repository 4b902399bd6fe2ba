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
    jm = jnn.PointMLP((16, 24, 8))  # each JAX init and apply one compiled call
    v = shifted(jax.jit(lambda x: jm.init(jax.random.key(0), x))(jnp.asarray(x)))
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    tm = port(tnn.PointMLP(7, (16, 24, 8)), v)
    np.testing.assert_allclose(run(tm, x), want, **TOL)
    h = torch.from_numpy(x)
    for w, b in tm.folded():
        h = torch.relu(h @ w.T + b)
    np.testing.assert_allclose(h.numpy(), want, **TOL)


def test_point_mlp_train_matches_flax():
    """A BatchNorm PointMLP in train mode at momentum 0.5: the output, the
    updated running statistics and every parameter's gradient against
    flax's apply(train=True, mutable=["batch_stats"]) and jax.grad."""
    rng = np.random.default_rng(218)
    x = cloud(rng, 2, 50, 7, scale=1.0)
    cot = cloud(rng, 2, 50, 8, scale=1.0)
    jm = jnn.PointMLP((16, 24, 8))  # the JAX init and gradient each one compiled call
    v = shifted(jax.jit(lambda x: jm.init(jax.random.key(0), x))(jnp.asarray(x)))

    def loss(params):
        out, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                            jnp.asarray(x), train=True, momentum=0.5, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd)

    (_, (want, upd)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    tm = port(tnn.PointMLP(7, (16, 24, 8)), v).train()
    got = tm(torch.from_numpy(x), 0.5)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    new_stats = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, upd))
    want_grads = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, {"params": grads}))
    for name, buf in tm.named_buffers():
        np.testing.assert_allclose(buf.numpy(), new_stats[name].numpy(), atol=1e-5, rtol=1e-5)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_transformer_layer_train_grads_match_flax():
    """TransformerLayer in train mode (the trainable attention's plain
    route): the output and every parameter's gradient against jax.grad of
    the flax layer at train=True."""
    rng = np.random.default_rng(219)
    xyz, f = cloud(rng, 2, 300, scale=0.5), cloud(rng, 2, 300, 16, scale=1.0)
    cot = cloud(rng, 2, 300, 16, scale=1.0)
    jm = jnn.TransformerLayer(16, 8)
    v = shifted(jm.init(jax.random.key(0), jnp.asarray(xyz), jnp.asarray(f)))

    def loss(params):
        out, _ = jm.apply({"params": params}, jnp.asarray(xyz), jnp.asarray(f), train=True)
        return jnp.sum(out * cot), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(v["params"])
    tm = port(tnn.TransformerLayer(16, 16, 8), v).train()
    got, _ = tm(torch.from_numpy(xyz), torch.from_numpy(f))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **GN_TOL)
    want_grads = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, {"params": grads}))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


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


# ---- the ISAPCInet layers: GroupNorm chains, PointNet++, transformer, heads
# Clouds sit on a 1/64 grid where a ball query runs, so squared distances
# are exact under both the port's direct formula and the JAX package's
# expansion and ball membership is the same on both sides.  Tolerance 1e-4
# (fp32, another summation order in the GroupNorm statistics).
GN_TOL = dict(atol=1e-4, rtol=1e-4)


def grid_cloud(rng, b, n, scale):
    return (np.round(rng.standard_normal((b, n, 3)) * scale * 64) / 64).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 40, 8, 16), (2, 300, 16), (3, 64)])
def test_group_norm_matches_flax(shape):
    """Statistics over every axis but the batch axis, per channel group,
    with flax's fast variance; scale and bias shifted off 1 and 0."""
    from pci_tpu.nn.norm import group_norm

    rng = np.random.default_rng(210)
    x = (rng.standard_normal(shape) * 0.7 + 0.2).astype(np.float32)
    jm = group_norm(4)
    v = shifted(jm.init(jax.random.key(0), jnp.asarray(x)))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(run(port(tnn.GroupNorm(4, shape[-1]), v), x), want, **GN_TOL)


@pytest.mark.parametrize("norm", ["group", "group_div"])
def test_group_point_mlp_matches_flax(norm):
    rng = np.random.default_rng(211)
    x = cloud(rng, 2, 60, 7, scale=1.0)
    jm = jnn.PointMLP((16, 32), norm=norm, groups=4)
    v = shifted(jm.init(jax.random.key(0), jnp.asarray(x)))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = port(tnn.PointMLP(7, (16, 32), norm=norm), v)
    np.testing.assert_allclose(run(tm, x), want, **GN_TOL)
    with pytest.raises(ValueError, match="cannot fold"):
        tm.folded()


@pytest.mark.parametrize("with_feats", [False, True])
def test_set_abstraction_msg_matches_flax(with_feats):
    """Two scales from one ball query; [feats, dxyz] (features first), or
    dxyz alone as at sa1."""
    rng = np.random.default_rng(212)
    xyz = grid_cloud(rng, 2, 400, 0.4)
    feats = cloud(rng, 2, 400, 6, scale=1.0) if with_feats else None
    jm = jnn.SetAbstractionMsg(64, [0.15, 0.3], [8, 16], [[16, 16], [16, 24]])
    J = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    v = shifted(jm.init(jax.random.key(0), J(xyz), J(feats)))
    jx, jf = jm.apply(v, J(xyz), J(feats))
    tm = port(tnn.SetAbstractionMsg(64, [0.15, 0.3], [8, 16], [[16, 16], [16, 24]],
                                    6 if with_feats else 0), v)
    with torch.inference_mode():
        tx, tf = tm(torch.from_numpy(xyz), None if feats is None else torch.from_numpy(feats))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **GN_TOL)


@pytest.mark.parametrize("with_dense", [False, True])
def test_feature_propagation_p2_matches_flax(with_dense):
    """eps-mode 3-NN interpolation (exact key hits included) + [skip,
    interp] + GroupNorm MLP."""
    rng = np.random.default_rng(213)
    dense, sub = cloud(rng, 2, 160), cloud(rng, 2, 40)
    dense[:, :5] = sub[:, :5]
    sf = cloud(rng, 2, 40, 12, scale=1.0)
    df = cloud(rng, 2, 160, 5, scale=1.0) if with_dense else None
    J = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    jm = jnn.pointnet2.FeaturePropagationP2([24, 16])
    v = shifted(jm.init(jax.random.key(0), J(dense), J(sub), J(df), J(sf)))
    want = np.asarray(jm.apply(v, J(dense), J(sub), J(df), J(sf)))
    tm = port(tnn.FeaturePropagationP2([24, 16], 12, 5 if with_dense else 0), v)
    with torch.inference_mode():
        got = tm(torch.from_numpy(dense), torch.from_numpy(sub),
                 None if df is None else torch.from_numpy(df), torch.from_numpy(sf))
    np.testing.assert_allclose(got.numpy(), want, **GN_TOL)


def test_pointnet2_feature_abstract_matches_flax():
    """The whole MSG encoder-decoder (4 SA, 4 FP, conv1 + GroupNorm(8)) on
    a dense 2,048-point cloud (sigma 0.1): sa1 takes 1,024 centres at radii
    0.1/0.2 and its balls fill, as on a real flow cloud.  (A sparse cloud
    leaves most slots repeating the centre, and GroupNorm's fast variance
    of nearly constant rows then differs at 1e-3 between any two
    summation orders.)  Off the grid: on it, the FP stages' 3-NN meets
    exact distance ties, which the JAX package's approximate top-k breaks
    in another order."""
    rng = np.random.default_rng(214)
    xyz = cloud(rng, 1, 2048, scale=0.1)
    jm = jnn.Pointnet2FeatureAbstract(16)
    v = shifted(jax.jit(jm.init)(jax.random.key(0), jnp.asarray(xyz)))
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(xyz)))
    got = run(port(tnn.Pointnet2FeatureAbstract(16), v), xyz)
    np.testing.assert_allclose(got, want, **GN_TOL)


def test_transformer_layer_matches_flax():
    """Self-kNN (k=8), fused [xyz | K | V] gather, the attention tail, fc2
    and the residual; the port returns no attention maps."""
    rng = np.random.default_rng(215)
    xyz, f = cloud(rng, 2, 300, scale=0.5), cloud(rng, 2, 300, 16, scale=1.0)
    jm = jnn.TransformerLayer(16, 8)
    v = shifted(jm.init(jax.random.key(0), jnp.asarray(xyz), jnp.asarray(f)))
    want, _ = jm.apply(v, jnp.asarray(xyz), jnp.asarray(f))
    tm = port(tnn.TransformerLayer(16, 16, 8), v)
    with torch.inference_mode():
        got, attn = tm(torch.from_numpy(xyz), torch.from_numpy(f))
    assert attn is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GN_TOL)


def test_tnet_and_outputer_match_flax():
    rng = np.random.default_rng(216)
    t = np.array([[0.2], [0.9]], np.float32)
    jm = jnn.Tnet(field=2)  # each JAX init and apply one compiled call
    v = shifted(jax.jit(lambda t: jm.init(jax.random.key(0), t))(jnp.asarray(t)))
    np.testing.assert_allclose(run(port(tnn.Tnet(2), v), t),
                               np.asarray(jax.jit(jm.apply)(v, jnp.asarray(t))), **GN_TOL)
    x = cloud(rng, 2, 70, 48, scale=1.0)
    jo = jnn.Outputer()
    v = shifted(jax.jit(lambda x: jo.init(jax.random.key(0), x))(jnp.asarray(x)))
    np.testing.assert_allclose(run(port(tnn.Outputer(48), v), x),
                               np.asarray(jax.jit(jo.apply)(v, jnp.asarray(x))), **GN_TOL)


def test_isapci_layers_refuse_train_mode():
    """What of ISAPCInet's layers still refuses train mode: only folding a
    BatchNorm chain (its running statistics).  SetAbstractionMsg,
    TransformerLayer and Tnet now train: in train mode each runs under
    autograd and gives every parameter a gradient; Tnet (GroupNorm keeps
    no running statistics) and the transformer (no norm) compute what they
    compute in eval mode, and SetAbstractionMsg does too from an FPS start
    of 0."""
    import pci_tpu_torch.nn.pointnet2 as tpn2

    rng = np.random.default_rng(217)
    xyz = torch.from_numpy(cloud(rng, 1, 64))
    with pytest.raises(RuntimeError, match="eval only"):
        tnn.PointMLP(4, (8,)).train().folded()
    for m, args in ((tnn.SetAbstractionMsg(8, [0.5], [4], [[8]], 0), (xyz, None)),
                    (tnn.TransformerLayer(3, 8, 4), (xyz, xyz)),
                    (tnn.Tnet(1), (torch.ones(1, 1),))):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tpn2, "fps_start", lambda module, x, gen=None: 0)
            out = m.train()(*args)
        out = out[-1] if isinstance(m, tnn.SetAbstractionMsg) else out
        out = out[0] if isinstance(out, tuple) else out
        out.square().sum().backward()
        assert all(p.grad is not None for p in m.parameters()), type(m).__name__
        with torch.no_grad():
            want = m.eval()(*args)
        want = want[-1] if isinstance(m, tnn.SetAbstractionMsg) else want
        want = want[0] if isinstance(want, tuple) else want
        torch.testing.assert_close(out.detach(), want, atol=1e-6, rtol=1e-6)
