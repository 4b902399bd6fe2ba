"""The port's PointNet++ mid-section route (``pn2mid_fused``, its plain
version on the CPU) against the JAX package's ``pn2mid`` megakernel route
and the port's own per-stage route, on CPU.

The JAX side runs its Pallas kernel in interpret mode, as
``tests/test_layers.py:404-422`` runs it, at that test's tolerance (rtol
1e-3, atol 3e-4: ball and kNN boundary ties can break apart under the TPU
kernel's packed-key 3-NN and the port's exact one).  The kernel's own
function is held at that test's input, sa1's output for a ``[1, 1200, 3]``
Gaussian cloud at scale 1.0 (the radii 0.2 .. 1.6 then span sparse and
dense balls).  The whole ``Pointnet2FeatureAbstract`` with both packages'
``_pn2mid_ok`` patched on (JAX's jitted once for the module) is held on a
dense 2,048-point cloud (sigma 0.1), as
``tests/test_torch_layers.py:test_pointnet2_feature_abstract_matches_flax``
holds the per-stage route: on the sparse cloud sa1's GroupNorm of nearly
constant rows already puts the two packages' per-stage routes 7.3e-4
apart at 8 of 38,400 outputs, before the mid-section.  Weights come from
flax ``init`` with every 1-D variable shifted (non-trivial GroupNorm scales
and biases) and reach the port through ``pci_tpu_torch.convert``.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pci_tpu.nn as jnn
import pci_tpu.nn.pointnet2 as jpn2
import pci_tpu_torch.nn.pointnet2 as tpn2
from pci_tpu.ops.pallas_kernels import pn2mid_tpu
from pci_tpu_torch import nn as tnn
from pci_tpu_torch.convert import flax_to_state_dict
from pci_tpu_torch.ops.cuda_kernels import pn2mid_cuda
from tests.test_torch_shared import shared_result

torch.set_num_threads(2)

TOL = dict(rtol=1e-3, atol=3e-4)
OUT_C = 32


def shifted(variables):
    return jax.tree_util.tree_map(
        lambda x: x + 0.05 * jnp.arange(x.size, dtype=x.dtype) / x.size if x.ndim == 1 else x,
        variables)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(dense cloud [1, 2048, 3], variables, JAX's output on its pn2mid
    route, the sparse cloud [1, 1200, 3] of tests/test_layers.py), once a
    test run."""
    return shared_result("pn2mid_case", jax_pn2mid_case, tmp_path_factory)


def jax_pn2mid_case():
    rng = np.random.default_rng(700)
    sparse = rng.standard_normal((1, 1200, 3)).astype(np.float32)
    xyz = (0.1 * rng.standard_normal((1, 2048, 3))).astype(np.float32)
    jm = jnn.Pointnet2FeatureAbstract(OUT_C)
    v = shifted(jax.jit(jm.init)(jax.random.key(0), jnp.asarray(xyz)))
    saved = jpn2._pn2mid_ok
    jpn2._pn2mid_ok = lambda train: not train
    try:
        want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(xyz)))
    finally:
        jpn2._pn2mid_ok = saved
    return xyz, jax.tree_util.tree_map(np.asarray, v), want, sparse


def port(v):
    m = tnn.Pointnet2FeatureAbstract(OUT_C)
    m.load_state_dict(flax_to_state_dict(v))
    return m.eval()


def run(module, xyz):
    with torch.inference_mode():
        return module(torch.from_numpy(xyz)).numpy()


def test_pn2mid_route_matches_jax_pn2mid_route(case, monkeypatch):
    """The port's route with its gate patched on (pn2mid's plain version)
    against JAX's with its gate patched on (the Pallas kernel, interpret
    mode)."""
    xyz, v, want, _ = case
    calls = []
    real = tpn2.pn2mid_fused
    monkeypatch.setattr(tpn2, "_pn2mid_ok", lambda train, x: not train)
    monkeypatch.setattr(tpn2, "pn2mid_fused", lambda *a: calls.append(1) or real(*a))
    got = run(port(v), xyz)
    assert calls == [1]
    np.testing.assert_allclose(got, want, **TOL)


def test_pn2mid_route_matches_per_stage_route(case, monkeypatch):
    """The port's two routes on the same weights: the one-launch route's
    plain version against sa2 .. fp2 stage by stage."""
    xyz, v, _, _ = case
    m = port(v)
    monkeypatch.setattr(tpn2, "_pn2mid_ok", lambda train, x: not train)
    fused = run(m, xyz)
    monkeypatch.setattr(tpn2, "_pn2mid_ok", lambda train, x: False)
    staged = run(m, xyz)
    np.testing.assert_allclose(fused, staged, **TOL)


def test_pn2mid_plain_matches_pallas_kernel(case):
    """pn2mid_plain against pn2mid_tpu.pn2mid_fused (interpret mode) on the
    same sa1 output of the sparse cloud, weights through gn_pointmlp_vars
    on both sides."""
    _, v, _, xyz = case
    m = port(v)
    with torch.inference_mode():
        l1_xyz, l1_f = m.sa1(torch.from_numpy(xyz), None)
    flat = tuple(jnp.asarray(t.numpy()) for g in m._mid_groups() for wa in g for t in wa)
    want = pn2mid_tpu.pn2mid_fused(jnp.asarray(l1_xyz.numpy()), jnp.asarray(l1_f.numpy()),
                                   flat, interpret=True)
    with torch.inference_mode():
        got = pn2mid_cuda.pn2mid_plain(l1_xyz, l1_f, m._mid_groups())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gn_pointmlp_vars_matches_jax(case):
    """The port's weight layout equals JAX's gn_pointmlp_vars, group for
    group, bit for bit."""
    _, v, _, _ = case
    m = port(v)
    p = v["params"]
    trees = [p["sa2"]["scale0"], p["sa2"]["scale1"], p["sa3"]["scale0"], p["sa3"]["scale1"],
             p["sa4"]["scale0"], p["sa4"]["scale1"], p["fp4"]["PointMLP_0"],
             p["fp3"]["PointMLP_0"], p["fp2"]["PointMLP_0"]]
    for g, tree, n in zip(m._mid_groups(), trees, pn2mid_cuda.N_LAYERS):
        want = pn2mid_tpu.gn_pointmlp_vars(tree, n)
        got = [t.numpy() for wa in g for t in wa]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_pn2mid_gate(monkeypatch):
    """True at eval on a CUDA tensor that needs no gradient; the JAX gate's
    environment variable, read at call time with default "1", turns it
    off; false in training, for a tensor that needs a gradient while grad
    mode is on, and for CPU tensors."""
    gate = tpn2._pn2mid_ok
    cuda = types.SimpleNamespace(is_cuda=True, requires_grad=False)
    needs = types.SimpleNamespace(is_cuda=True, requires_grad=True)
    monkeypatch.delenv("PCI_TPU_PN2_KERNEL", raising=False)
    assert gate(False, cuda) and not gate(True, cuda) and not gate(False, torch.zeros(1))
    assert not gate(False, needs)
    with torch.no_grad():
        assert gate(False, needs)
    monkeypatch.setenv("PCI_TPU_PN2_KERNEL", "0")
    assert not gate(False, cuda)
    monkeypatch.setenv("PCI_TPU_PN2_KERNEL", "1")
    assert gate(False, cuda)


def test_groups_cache_follows_weight_updates(case):
    """The packed groups are cached and rebuilt after a weight changes."""
    _, v, _, _ = case
    m = port(v)
    g1 = m._mid_groups()
    assert m._mid_groups() is g1
    with torch.no_grad():
        m.fp2.mlp.gn[1].bias.add_(1.0)
    g2 = m._mid_groups()
    assert g2 is not g1
    torch.testing.assert_close(g2[8][1][1][2], g1[8][1][1][2] + 1.0)
    assert g2.buf.numel() == g1.buf.numel()
