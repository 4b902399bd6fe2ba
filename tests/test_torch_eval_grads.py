"""Eval-mode gradients of the port's layers against ``jax.grad`` of the JAX
package's modules at ``train=False``, CPU.

At eval the JAX package's layers take their XLA expression when a tangent
could flow (``ops.has_tangents``), so ``jax.grad`` of an eval call gives
the gradient of the eval function: BatchNorm on its running statistics,
eval's selections (FPS from index 0, ball and kNN picks).  The port's
layers do the same where ``_build.needs_grad`` holds (grad mode on, and
an input or a parameter requiring grad): they run the same function by
differentiable ops instead of their eval-only kernels.  Each case holds
the gradients of every parameter and every input against JAX's on the
same weights (``convert.flax_to_state_dict``, every 1-D variable shifted
so that the BatchNorm statistics are non-trivial) and the same inputs and
permutations (numpy, one fixed seed a case), and the output with grad
enabled against the same call under ``torch.no_grad()``.

Tolerances, as the port's training-step test sets them: each gradient
within 1e-2 of its largest magnitude and a cosine of at least 0.999 to
JAX's (selections and max-pools route near-ties by rounding; the sums run
in another order); a gradient that is zero in exact arithmetic (its
largest magnitude below 1e-5 of the case's largest gradient, such as a
bias that a softmax cancels) is held to that floor instead; a whole
ISAPCInet's parameter gradients within 2e-2 (``GRAD_LIMITS``: measured
conditioning).  The output with grad enabled within 1e-5 of the no-grad
call (unfolded against folded BatchNorm).
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pci_tpu.nn as jnn
import pci_tpu.nn.fusion as jfusion
from pci_tpu.models import ISAPCInet as JISAPCInet
from pci_tpu.models.flownet3d import FlowNet3D as JFlowNet3D
from pci_tpu_torch import nn as tnn
from pci_tpu_torch.convert import flax_to_state_dict, load_subtrees
from pci_tpu_torch.models import FlowNet3D, ISAPCInet
from tests.test_torch_shared import shared_result

torch.set_num_threads(2)

N = 256
ISAPCI_N = 512  # ISAPCInet field 1: a 1,024-point flow cloud, PointNet++'s sa1 size


def shifted(variables):
    return jax.tree_util.tree_map(
        lambda x: x + 0.05 * jnp.arange(x.size, dtype=x.dtype) / x.size
        if x.ndim == 1 else x, variables)


def cloud(rng, n, c=3, scale=2.0):
    return (rng.standard_normal((1, n, c)) * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def case(name: str):
    """(variables, inputs, extra call args, permutations, cotangent, JAX
    output, JAX parameter and input gradients) for one module, computed
    once: a jitted init, then one jitted ``value_and_grad``."""
    rng = np.random.default_rng({"fusion16": 1601, "fusion64": 1602, "features": 1603,
                                 "transformer": 1604, "flownet3d": 1605,
                                 "pointnet2": 1606, "isapci_notnet": 1607}[name])
    perms = [rng.permutation(N)[None].astype(np.int32) for _ in range(2)]
    t = np.array([0.4], np.float32)
    flows = None
    if name.startswith("fusion") or name == "features":
        a = cloud(rng, N)
        b = a + 0.3 * cloud(rng, N, scale=1.0)
        k = 64 if name == "fusion64" else 16
        if name == "features":
            inputs = (a, b, cloud(rng, N, 1, 1.0), cloud(rng, N, 1, 1.0))
            jm = jfusion.PointsFusionWithFeatures((64, 64, 128))
        else:
            inputs = (a, b)
            jm = jfusion.PointsFusion((64, 64, 128))
        extra = (k, t)
    elif name == "transformer":
        inputs = (cloud(rng, N, scale=0.5), cloud(rng, N, 16, 1.0))
        jm, extra = jnn.TransformerLayer(16, 8), ()
    elif name == "flownet3d":
        inputs = (cloud(rng, N), cloud(rng, N), cloud(rng, N, scale=1.0),
                  cloud(rng, N, scale=1.0))
        jm, extra = JFlowNet3D(), ()
    elif name == "isapci_notnet":  # ISAPCInet field 1 without Tnet, on given flows
        # (tests/test_torch_variants.py): the key clouds' gradients through
        # the warp and the fusion; the context frames feed only the flows
        perms = [rng.permutation(ISAPCI_N)[None].astype(np.int32) for _ in range(2)]
        inputs = (cloud(rng, ISAPCI_N), cloud(rng, ISAPCI_N))
        flows = [(0.1 * rng.standard_normal((1, ISAPCI_N, 3))).astype(np.float32)
                 for _ in range(4)]
        ctx = [cloud(rng, ISAPCI_N) for _ in range(2)]
        jm = JISAPCInet(field=1, ff_out_c=16, tr_out_c=16, use_tnet=False)
        extra = (t,)
    else:  # a dense cloud: PointNet++'s balls fill (tests/test_torch_layers.py)
        inputs = (cloud(rng, 512, scale=0.1),)
        jm, extra = jnn.Pointnet2FeatureAbstract(16), ()
    J = [jnp.asarray(x) for x in inputs]
    args = list(J[:2]) + list(J[2:4]) if name == "features" else list(J)
    call_extra = [jnp.asarray(e) if isinstance(e, np.ndarray) else e for e in extra]
    if flows is not None:  # ISAPCInet's call: (forward, keys, backward, t, ini)
        def call_args(xs):
            return ([jnp.asarray(ctx[0])], list(xs), [jnp.asarray(ctx[1])], call_extra[0],
                    jnp.zeros_like(xs[0]))
    else:
        def call_args(xs):
            return (*xs, *call_extra)

    saved = jfusion._random_perms, JFlowNet3D.multi
    try:  # every trace draws the fusion's two permutations, in order
        draws = itertools.cycle(perms)
        jfusion._random_perms = lambda key, B, n: jnp.asarray(next(draws))
        if flows is not None:
            JFlowNet3D.multi = lambda self, clouds, feats, pairs, **kw: [jnp.asarray(f)
                                                                        for f in flows]
        rngs = {"params": jax.random.key(0), "sample": jax.random.key(1)}
        v = jax.tree_util.tree_map(np.asarray, shifted(jax.jit(
            lambda xs: jm.init(rngs, *call_args(xs), train=False))(args)))

        def apply(params, xs):
            out = jm.apply({**v, "params": params}, *call_args(xs), train=False,
                           rngs={"sample": jax.random.key(2)})
            return out[0] if isinstance(out, tuple) else out

        shape = jax.eval_shape(apply, v["params"], args).shape
        cot = rng.standard_normal(shape).astype(np.float32)

        def loss(params, xs):
            out = apply(params, xs)
            return jnp.sum(out * cot), out

        (_, out), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            v["params"], args)
        out = np.asarray(out)
    finally:
        jfusion._random_perms, JFlowNet3D.multi = saved
    want_p = {k: w.numpy() for k, w in flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, {"params": gp})).items()}
    if flows is not None:  # the port's ISAPCInet call: its flows and context frames
        extra = (t, flows, ctx)
    return v, inputs, extra, perms, cot, out, want_p, [np.asarray(g) for g in gx]


def port_module(name, v):
    if name == "isapci_notnet":  # the JAX init never ran FlowNet3D: no flow tree
        mod = ISAPCInet(1, ff_out_c=16, tr_out_c=16, use_tnet=False)
        load_subtrees(mod, v)
        return mod.eval()
    mod = {"fusion16": tnn.PointsFusion, "fusion64": tnn.PointsFusion,
           "features": tnn.PointsFusionWithFeatures,
           "transformer": lambda: tnn.TransformerLayer(16, 16, 8), "flownet3d": FlowNet3D,
           "pointnet2": lambda: tnn.Pointnet2FeatureAbstract(16)}[name]()
    mod.load_state_dict(flax_to_state_dict(v))
    return mod.eval()


def port_call(name, mod, xs, extra, perms):
    kw = {"perms": tuple(torch.from_numpy(p) for p in perms)} if extra else {}
    if name == "isapci_notnet":
        t, flows, ctx = extra
        mod.flow.multi = lambda clouds, feats, pairs: [torch.from_numpy(f) for f in flows]
        fwd, bwd = ([torch.from_numpy(c)] for c in ctx)
        return mod(fwd, list(xs), bwd, torch.from_numpy(t), torch.zeros_like(xs[0]), **kw)
    tail = [torch.from_numpy(e) if isinstance(e, np.ndarray) else e for e in extra]
    out = mod(*xs, *tail, **kw)
    return out[0] if isinstance(out, tuple) else out


def assert_grads(got: dict, want: dict, floor: float, limit: float = 1e-2):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        top = float(np.abs(w).max())
        if top < floor:  # zero in exact arithmetic: rounding noise on both sides
            assert float(np.abs(g).max()) <= floor, key
            continue
        err = float(np.abs(g - w).max())
        assert err <= limit * top, f"{key}: max |port - jax| {err} > {limit} x {top}"
        cos = float((g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w)))
        assert cos >= 0.999, f"{key}: cosine {cos}"


CASES = ["fusion16", "fusion64", "features", "transformer", "flownet3d", "pointnet2",
         "isapci_notnet"]
# A whole ISAPCInet's parameter gradients, each within 2e-2 of its largest
# magnitude: PointNet++ there runs over the 1,024-point flow cloud, whose
# slot max-pools and small sa4 groups make its gradients ill-conditioned (a
# one-ulp change of the given flows moves the port's own by up to 4.9e-3 of
# their largest, fp1's; the port and JAX part by up to 1.22e-2, sa4's, with
# cosines above 0.99999 and a median of 7e-4; tests/test_torch_train.py
# reads the same of the whole training step)
GRAD_LIMITS = {"isapci_notnet": 2e-2}


def shared_case(name: str, tmp_path_factory):
    """``case(name)``, computed once a test run across the xdist workers."""
    return shared_result(f"eval_grads_{name}", lambda: case(name), tmp_path_factory)


@pytest.mark.parametrize("name", CASES)
def test_eval_grads_match_jax(name, tmp_path_factory):
    """Every parameter's and every input's gradient of the eval call
    against ``jax.grad`` at ``train=False``: PointsFusion at k = 16 and 64,
    PointsFusionWithFeatures (the features' gradients too),
    TransformerLayer, FlowNet3D (both clouds and both feature inputs),
    PointNet++'s encoder-decoder and ISAPCInet without Tnet on given flows
    (the key clouds; the frozen flow has no gradient)."""
    v, inputs, extra, perms, cot, want, want_p, want_x = shared_case(name, tmp_path_factory)
    mod = port_module(name, v)
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out = port_call(name, mod, xs, extra, perms)
    assert out.requires_grad
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-3, rtol=1e-3)
    (out * torch.from_numpy(cot)).sum().backward()
    got = {f"param {k}": p.grad.numpy() for k, p in mod.named_parameters()
           if not k.startswith("flow.")}  # ISAPCInet's frozen flow
    got.update({f"input {i}": x.grad.numpy() for i, x in enumerate(xs)})
    exp = {f"param {k}": w for k, w in want_p.items()}
    exp.update({f"input {i}": w for i, w in enumerate(want_x)})
    floor = 1e-5 * max(float(np.abs(w).max()) for w in exp.values())
    assert_grads(got, exp, floor, GRAD_LIMITS.get(name, 1e-2))


@pytest.mark.parametrize("name", CASES)
def test_eval_output_with_grad_matches_no_grad(name, tmp_path_factory):
    """The differentiable eval route's output (grad enabled, parameters
    requiring grad) equals the same call under ``torch.no_grad()`` (the
    eval route of folded layers and eval kernels' plain versions) within
    1e-5."""
    v, inputs, extra, perms, _, _, _, _ = shared_case(name, tmp_path_factory)
    mod = port_module(name, v)
    xs = [torch.from_numpy(x) for x in inputs]
    got = port_call(name, mod, xs, extra, perms)
    assert got.requires_grad
    with torch.no_grad():
        want = port_call(name, mod, xs, extra, perms)
    torch.testing.assert_close(got.detach(), want, atol=1e-5, rtol=1e-5)
