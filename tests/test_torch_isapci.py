"""The port's ISAPCInet against the JAX package on CPU, plus its golden pin,
the weight loader and the serving API.

Inputs come from numpy with a fixed seed per test.  The JAX model's init
and apply are jitted, once per configuration (module-scoped fixtures).

Tolerances: 1e-3 for the whole model (fp32 over ~20 stages, GroupNorm
statistics summed in another order); 1e-4 for the ``isapci_f1`` golden
(N=96), the JAX suite's own golden bound.

The model comparison feeds both sides the SAME flows and the same fusion
permutations.  PointNet++ and the transformer select over the flow cloud
(FPS argmax, ball membership, kNN order), so the ~1e-6 difference between
the port's and the JAX package's FlowNet3D (held to 1e-3 by
tests/test_torch_pointinet.py) can flip a pick and move whole
neighbourhoods; given the same flows every selection is the same.  The
same holds at the fusion, whose 32 neighbours a 1e-5 difference in the
warped clouds can swap at a near tie: the Outputer's flows are held to
1e-3, then the fusion runs on the JAX model's own warped clouds.  The
golden pin runs the real flows through the whole model.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pci_tpu.nn.fusion as jfusion
from pci_tpu.models import ISAPCInet as JISAPCInet
from pci_tpu.models.flownet3d import FlowNet3D as JFlowNet3D
from pci_tpu.models.isapci import _flow_pair_plan
from pci_tpu_torch.convert import flax_to_state_dict, load_npz_tree, load_subtrees
from pci_tpu_torch.models import ISAPCInet
from pci_tpu_torch.models.isapci import flow_pair_plan
from pci_tpu_torch.serving import DEFAULT_WEIGHTS, Interpolator
from tests.test_torch_shared import shared_result

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
MODEL_TOL = dict(atol=1e-3, rtol=1e-3)
J, T = jnp.asarray, torch.from_numpy


def window(seed: int, field: int, n: int, scale: float = 2.0):
    """(forward, keys, backward) lists of [1, n, 3] clouds."""
    rng = np.random.default_rng(seed)
    clouds = [(rng.standard_normal((1, n, 3)) * scale).astype(np.float32)
              for _ in range(2 * field + 2)]
    return clouds[:field], clouds[field:field + 2], clouds[field + 2:]


def shifted(v):
    return jax.tree_util.tree_map(
        lambda x: x + 0.05 * np.arange(x.size, dtype=x.dtype) / x.size
        if x.ndim == 1 else x, v)


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=[1, 2], ids=["field1", "field2"])
def injected(request, tmp_path_factory):
    """JAX ISAPCInet (ff_out_c = tr_out_c = 16, N=512) run on given flows
    and given fusion permutations: (field, inputs, flows, perms, variables,
    the Outputer's two flows, JAX output), once a test run a field."""
    return shared_result(f"isapci_field{request.param}", lambda: jax_isapci(request.param),
                         tmp_path_factory)


def jax_isapci(field):
    N = 512
    fwd, keys, bwd = window(400 + field, field, N)
    rng = np.random.default_rng(410 + field)
    flows = [(0.1 * rng.standard_normal((1, N, 3))).astype(np.float32)
             for _ in range(4 * field)]
    perms = [rng.permutation(N)[None].astype(np.int32) for _ in range(2)]
    t = np.array([0.4], np.float32)
    z = np.zeros_like(keys[0])
    model = JISAPCInet(field=field, ff_out_c=16, tr_out_c=16)
    args = ([J(x) for x in fwd], [J(x) for x in keys], [J(x) for x in bwd], J(t), J(z))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFlowNet3D, "multi",
                   lambda self, clouds, feats, pairs, **kw: [J(f) for f in flows])
        rngs = {"params": jax.random.key(0), "sample": jax.random.key(1)}
        v = shifted(as_np(jax.jit(lambda *a: model.init(rngs, *a, train=False))(*args)))
        draws = iter(perms)
        mp.setattr(jfusion, "_random_perms", lambda key, B, n: J(next(draws)))
        out, state = jax.jit(lambda v, *a: model.apply(
            v, *a, train=False, rngs={"sample": jax.random.key(2)},
            capture_intermediates=True, mutable=["intermediates"]))(v, *args)
    nets = [np.asarray(n) for n in state["intermediates"]["outputer"]["__call__"]]
    return field, (fwd, keys, bwd, t, z), flows, perms, v, nets, np.asarray(out)


def test_isapci_matches_jax(injected):
    """Tnet weighting, PointNet++ over the Tnet-weighted flow cloud, the
    transformer over the unweighted one, the chunk-major fold and Outputer
    against the JAX model on the same flows; then warp and fusion."""
    field, (fwd, keys, bwd, t, z), flows, perms, v, want_nets, want = injected
    model = ISAPCInet(field, ff_out_c=16, tr_out_c=16)
    # the JAX init never ran FlowNet3D (its flows were given): every other
    # sub-tree loads, the port's flow keeps its seeded weights, unused here
    assert load_subtrees(model, v) == sorted(
        ["ffab", "flow_tr_backward", "flow_tr_forward", "fusion", "outputer",
         "tnet_backward", "tnet_forward"])
    model.eval()
    model.flow.multi = lambda clouds, feats, pairs: [T(f) for f in flows]
    nets = []
    model.outputer.register_forward_hook(lambda mod, inp, out: nets.append(out.numpy()))
    perms_t = tuple(T(p) for p in perms)
    with torch.inference_mode():
        model([T(x) for x in fwd], [T(x) for x in keys], [T(x) for x in bwd],
              T(t), T(z), perms=perms_t)
        for got_net, want_net in zip(nets, want_nets, strict=True):
            np.testing.assert_allclose(got_net, want_net, **MODEL_TOL)
        tb = t[:, None, None]
        warped = (keys[0] + want_nets[0] * tb, keys[1] + want_nets[1] * (1.0 - tb))
        got = model.fusion(T(warped[0]), T(warped[1]), 32, T(t), perms=perms_t)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


def test_window_flows_follow_the_plan():
    """flow_pair_plan is the JAX plan, and window_flows (each distinct frame
    encoded once) equals one FlowNet3D forward per planned pair, scaled."""
    for field in (1, 2, 3):
        assert flow_pair_plan(field) == _flow_pair_plan(field)
    field = 2
    fwd, keys, bwd = (list(map(T, c)) for c in window(420, field, 96))
    model = ISAPCInet(field, ff_out_c=16, tr_out_c=16).eval()
    frames = {"f": fwd, "b": bwd, "k": keys}
    z = torch.zeros_like(keys[0])
    with torch.inference_mode():
        got_f, got_b = model.window_flows(fwd, keys, bwd, z)
        plan_f, plan_b = flow_pair_plan(field)
        for got, plan in ((got_f, plan_f), (got_b, plan_b)):
            want = torch.stack([model.flow(frames[a][i], frames[c][j], z, z) * s
                                for a, i, c, j, s in plan], 1)
            torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_isapci_matches_golden():
    """The ``isapci_f1`` golden (tests/golden_cases.py: field=1,
    ff_out_c = tr_out_c = 32, N=96, init key 0) through the port, real
    flows included; the fusion permutations are the ones the JAX run
    draws, recorded from its jitted apply."""
    rng = np.random.default_rng(3)
    f1, k1, k2, b1 = [(rng.standard_normal((1, 96, 3)) * 2).astype(np.float32)
                      for _ in range(4)]
    t = np.array([0.4], np.float32)
    z = np.zeros_like(f1)
    model = JISAPCInet(field=1, ff_out_c=32, tr_out_c=32)
    args = ([J(f1)], [J(k1), J(k2)], [J(b1)], J(t), J(z))
    rngs = {"params": jax.random.key(0), "sample": jax.random.key(1)}
    v = as_np(jax.jit(lambda *a: model.init(rngs, *a, train=False))(*args))
    drawn = []
    draw = jfusion._random_perms

    def recorded(key, B, n):
        p = draw(key, B, n)
        jax.debug.callback(lambda x: drawn.append(np.asarray(x)), p, ordered=True)
        return p

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfusion, "_random_perms", recorded)
        jax.block_until_ready(jax.jit(lambda v, *a: model.apply(
            v, *a, train=False, rngs={"sample": jax.random.key(2)}))(v, *args))
    assert len(drawn) == 2
    port = ISAPCInet(1, ff_out_c=32, tr_out_c=32)
    port.load_state_dict(flax_to_state_dict(v))
    with torch.inference_mode():
        got = port.eval()([T(f1)], [T(k1), T(k2)], [T(b1)], T(t), T(z),
                          perms=tuple(T(p.copy()) for p in drawn))
    want = np.load(ROOT / "tests" / "golden" / "model_outputs.npz")["isapci_f1"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_pointinet_weights_load_into_flow_and_fusion():
    """The trained PointINet npz fills ISAPCInet's flow and fusion and
    nothing else; a key the model does not have is refused."""
    model = ISAPCInet(2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert load_subtrees(model, load_npz_tree(DEFAULT_WEIGHTS)) == ["flow", "fusion"]
    tree = load_npz_tree(DEFAULT_WEIGHTS)
    want = flax_to_state_dict(tree)
    for key, val in model.state_dict().items():
        if key.split(".")[0] in ("flow", "fusion"):
            torch.testing.assert_close(val, want[key], atol=0, rtol=0)
        else:
            assert torch.equal(val, before[key]), key
    tree["params"]["bogus"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="does not have"):
        load_subtrees(model, tree)


@pytest.mark.parametrize("field", [0, 1, 2])
def test_interpolator_isapci_serves_frames_on_cpu(field):
    """Interpolator.isapci on the CPU: a frame and an upsample, resampled
    to npoints; the context must hold ``field`` frames each side."""
    it = Interpolator.isapci(field=field, npoints=100, weights=DEFAULT_WEIGHTS,
                             device="cpu", ff_out_c=16, tr_out_c=16)
    fwd, (a, b), bwd = window(430, field, 130)
    context = ([c[0] for c in fwd], [c[0] for c in bwd])
    frame = it(a[0], b[0], 0.5, context=context)
    assert frame.shape == (100, 3) and np.isfinite(frame).all()
    if field == 2:
        frames = it.upsample(a[0], b[0], factor=3, context=context)
        assert len(frames) == 2 and all(f.shape == (100, 3) for f in frames)
        with pytest.raises(ValueError, match="context"):
            it(a[0], b[0], 0.5, context=(context[0][:1], context[1]))
        with pytest.raises(ValueError, match="context"):
            it(a[0], b[0], 0.5)


def test_interpolator_isapci_needs_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Interpolator.isapci(npoints=64)


def test_isapci_refuses_train_mode():
    """Train mode runs with the flow frozen: FlowNet3D stays in eval mode
    through ``train()`` and ``eval()`` toggles, and gets no gradient."""
    fwd, keys, bwd = (list(map(T, c)) for c in window(440, 1, 64))
    z = torch.zeros_like(keys[0])
    model = ISAPCInet(1, ff_out_c=16, tr_out_c=16)
    assert model.training and not model.flow.training
    assert not any(m.training for m in model.eval().modules())
    out = model.train()(fwd, keys, bwd, torch.tensor([0.5]), z)
    assert out.requires_grad and model.ffab.training and not model.flow.training
    assert not any(m.training for m in model.flow.modules())
    out.sum().backward()
    assert all(p.grad is None for p in model.flow.parameters())
    assert model.outputer.gn[0].weight.grad is not None
