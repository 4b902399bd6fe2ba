"""The port's PointINet2 (``Wnet``, ``_multi_budgets``, ``PointsFusionMulti``
and the model) against the JAX package on CPU, plus its golden pin, its
weight tree and its eval step.

Inputs come from numpy with a fixed seed per test; weights from the JAX
modules' ``init`` (every 1-D variable shifted, so GroupNorm and BatchNorm
carry non-trivial affine terms and statistics) through
``convert.flax_to_state_dict``.  JAX's fusion permutations are recorded
inside its jitted call (``jfusion._random_perms`` wrapped to hand its
draws out as outputs) and given to the port in the same order.  Every
JAX init and apply is jitted, the whole model's once a field (cached).

The whole model is held on the JAX model's own flows (FlowNet3D
replaced on both sides by the same seeded flows, as
tests/test_torch_isapci.py does): a 1e-6 difference in a warped cloud can
swap a near-tied 64th neighbour of the ring fusions; the golden pin runs
the real flows at its 96 points.  Tolerances: 1e-4 (tests/test_golden.py's
bound for a whole model) for the modules and the model, the golden's
rtol 1e-4 / atol 1e-5, the budgets exactly.
"""

from __future__ import annotations

import functools
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pci_tpu.nn.fusion as jfusion
from pci_tpu.models import PointINet2 as JPointINet2
from pci_tpu.models.flownet3d import FlowNet3D as JFlowNet3D
from pci_tpu.nn.heads import Wnet as JWnet
from pci_tpu_torch.convert import flax_to_state_dict
from pci_tpu_torch.models import PointINet2
from pci_tpu_torch.nn import PointsFusionMulti, Wnet
from pci_tpu_torch.nn.fusion import _multi_budgets
from pci_tpu_torch.train import make_interp_eval_step

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
J, T = jnp.asarray, torch.from_numpy


def shifted(v):
    return jax.tree_util.tree_map(
        lambda x: x + 0.05 * np.arange(x.size, dtype=x.dtype) / x.size
        if x.ndim == 1 else x, v)


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def recorded(fn):
    """``fn``'s outputs and the fusion permutations JAX drew while it ran,
    from one jit: ``_random_perms`` is wrapped to keep its draws, which the
    jitted function returns beside its own outputs."""
    draws, orig = [], jfusion._random_perms

    def keep(key, B, n):
        p = orig(key, B, n)
        draws.append(p)
        return p

    def run(*args):
        draws.clear()
        return fn(*args), list(draws)

    def call(*args):
        jfusion._random_perms = keep
        try:
            out, perms = jax.jit(run)(*args)
        finally:
            jfusion._random_perms = orig
        return out, [np.asarray(p) for p in perms]
    return call


def cloud(rng, n, scale=2.0):
    return (rng.standard_normal((1, n, 3)) * scale).astype(np.float32)


# ---- Wnet and the budgets ---------------------------------------------------------


@pytest.mark.parametrize("field", [1, 2])
def test_wnet_matches_jax(field):
    """Dense + GroupNorm(C/8) over 128, 512, 512, 128, then the softmax
    over 6 field weights, on a batch of t."""
    rng = np.random.default_rng(1700 + field)
    t = rng.random((5, 1)).astype(np.float32)
    jm = JWnet(field)
    v = shifted(as_np(jax.jit(lambda t: jm.init(jax.random.key(field), t))(J(t))))
    want = np.asarray(jax.jit(jm.apply)(v, J(t)))
    mod = Wnet(field)
    mod.load_state_dict(flax_to_state_dict(v))
    with torch.inference_mode():
        got = mod.eval()(T(t)).numpy()
    assert got.shape == (5, 6 * field)
    np.testing.assert_allclose(got, want, **TOL)


def test_multi_budgets_match_jax():
    """``_multi_budgets`` equals the JAX function exactly over a sweep of
    head weights (uniform, small and large scales, zeros, and rows where
    the cumulative clamp leaves a cloud with 0 points and 0 slots) at the
    sizes and k the models use."""
    rng = np.random.default_rng(1710)
    edges = np.array([[0.99, 0.004], [0.9, 0.05], [0.5, 0.5], [0.0, 0.0], [1 / 64, 1 / 32],
                      [1.0, 1.0], [0.49, 0.5]], np.float32)
    clamped = 0
    for N in (96, 256, 512, 4096, 16000, 16384):
        for k in (32, 48, 64):
            w = rng.random((500, 2)).astype(np.float32) * rng.choice(
                [0.05, 0.5, 1.0], (500, 1)).astype(np.float32)
            w = np.concatenate([w, edges])
            for F in (2, 3):
                n_all, k_all = _multi_budgets(N, k, T(w[:, :F - 1]))
                jn, jk = jfusion._multi_budgets(N, k, J(w[:, :F - 1]))
                np.testing.assert_array_equal(n_all.numpy(), np.asarray(jn))
                np.testing.assert_array_equal(k_all.numpy(), np.asarray(jk))
                assert n_all.dtype == k_all.dtype == torch.int32
                assert (n_all.sum(1) == N).all() and (k_all.sum(1) == k).all()
                clamped += int(((n_all[:, :-1] == 0) & (T(w[:, :F - 1]) > 0)).sum())
    assert clamped > 0  # the sweep reaches the zero-point clamp


# ---- PointsFusionMulti ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def multi_case(F: int):
    """F clouds at k = 64 (N = 512) with Wnet-like weights ``[B, 6 (F -
    1)]``, the JAX PointsFusionMulti's variables, its rows (its exact XLA
    route on the CPU) and the permutations it drew; once a process."""
    rng = np.random.default_rng(1720 + F)
    N, k = 512, 64
    base = cloud(rng, N)
    clouds = [base + 0.3 * cloud(rng, N, 1.0) for _ in range(F)]
    w = np.asarray(jax.nn.softmax(J(rng.standard_normal((1, 6 * (F - 1))).astype(np.float32))))
    jm = jfusion.PointsFusionMulti((64, 64, 128))
    jc = [J(c) for c in clouds]
    v = shifted(as_np(jax.jit(lambda c, w: jm.init(
        {"params": jax.random.key(0), "sample": jax.random.key(1)}, c, k, w))(jc, J(w))))
    want, perms = recorded(lambda v, c, w: jm.apply(v, c, k, w, rngs={
        "sample": jax.random.key(2)}))(v, jc, J(w))
    return clouds, w, k, v, np.asarray(want), perms


def multi_fusion(F: int):
    """The port's PointsFusionMulti on :func:`multi_case`'s variables, and
    a call of it (eval, inference mode) on the case's clouds and draws."""
    clouds, w, k, v, _, perms = multi_case(F)
    mod = PointsFusionMulti()
    mod.load_state_dict(flax_to_state_dict(v))

    def call():
        with torch.inference_mode():
            return mod.eval()([T(c) for c in clouds], k, T(w), perms=[T(p) for p in perms])
    return call


@pytest.mark.parametrize("F", [2, 3])
def test_points_fusion_multi_matches_jax(F):
    """F clouds at k = 64 with Wnet-like weights ``[B, 6 (F - 1)]`` (only
    the first F - 1 read): the budgeted merge, the F-segment residual kNN
    and the GroupNorm head, on JAX's permutations."""
    *_, want, perms = multi_case(F)
    assert len(perms) == F
    np.testing.assert_allclose(multi_fusion(F)().numpy(), want, **TOL)


def cells_route(monkeypatch):
    """The fusion's cells gate patched on for CPU tensors (its own rule
    otherwise: k <= 64, in training two segments only); returns the cells
    entry points reached, in order."""
    import pci_tpu_torch.nn.fusion as tfusion

    gate = tfusion._cells_route_ok
    monkeypatch.setattr(tfusion, "_cells_route_ok", lambda p, k, train, n_seg=2: gate(
        types.SimpleNamespace(is_cuda=True, shape=(1, tfusion._CELLS_FUSION_N, 3)), k, train,
        n_seg))
    reached = []
    for name in ("fusion_cells_resi_knn", "fusion_cells_multi_knn"):
        fn = getattr(tfusion, name)
        monkeypatch.setattr(tfusion, name, lambda *a, _fn=fn, _name=name, **kw:
                            reached.append(_name) or _fn(*a, **kw))
    return reached


@pytest.mark.parametrize("F", [2, 3])
def test_points_fusion_multi_cells_route_matches_jax(monkeypatch, F):
    """With the cells gate on (the plain versions on the CPU), F = 3
    reaches the F masked passes of row 10 (``fusion_cells_multi_knn``) and
    F = 2 row 12's residual entry (``fusion_cells_resi_knn``), as JAX's
    ``_cells_fusion_knn`` branches; the rows equal JAX PointsFusionMulti's
    within 1e-5."""
    reached = cells_route(monkeypatch)
    got = multi_fusion(F)()
    assert reached == ["fusion_cells_multi_knn" if F == 3 else "fusion_cells_resi_knn"]
    np.testing.assert_allclose(got.numpy(), multi_case(F)[4], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("F", [2, 3])
def test_points_fusion_multi_cells_route_equals_the_flat_route(monkeypatch, F):
    """The cells routes are the flat route's function slot for slot: the
    F-segment entry's idx and residuals equal ``fusion_resi_knn``'s on the
    case's combined cloud and budgets, and the module's rows on the cells
    route equal its flat route's bit for bit; in training, F = 3 keeps the
    flat route (JAX's F > 2 cells branch is eval only)."""
    from pci_tpu_torch.nn.fusion import _composed_shuffle_merge
    from pci_tpu_torch.ops.cuda_kernels import fusion_cells_multi_knn, fusion_resi_knn

    clouds, w, k, _, _, perms = multi_case(F)
    flat = multi_fusion(F)()
    reached = cells_route(monkeypatch)
    assert torch.equal(multi_fusion(F)(), flat)
    n_all, k_all = _multi_budgets(clouds[0].shape[1], k, T(w[:, :F - 1]))
    combined, _ = _composed_shuffle_merge([T(c) for c in clouds], [T(p) for p in perms], n_all)
    ends = torch.cumsum(n_all, 1)
    for got, want in zip(fusion_cells_multi_knn(combined, ends, k_all, k),
                         fusion_resi_knn(combined, ends, k_all, k)):
        assert torch.equal(got, want)
    reached.clear()
    mod = PointsFusionMulti().train()
    mod([T(c) for c in clouds], k, T(w), perms=[T(p) for p in perms])
    assert reached == ([] if F == 3 else ["fusion_cells_resi_knn"])


# ---- the model -----------------------------------------------------------------


def window(seed: int, field: int, n: int):
    rng = np.random.default_rng(seed)
    clouds = [cloud(rng, n) for _ in range(2 * field + 2)]
    return clouds[:field], clouds[field:field + 2], clouds[field + 2:]


@functools.lru_cache(maxsize=None)
def injected(field: int):
    """JAX PointINet2 (N = 512) on given flows: FlowNet3D's ``multi`` (the
    rings) and ``__call__`` (the key PointINet's bidirectional flow) both
    return seeded flows.  Returns (inputs, flows, variables, permutations,
    JAX output)."""
    N = 512
    fwd, keys, bwd = window(1730 + field, field, N)
    rng = np.random.default_rng(1740 + field)
    ring = [(0.2 * rng.standard_normal((1, N, 3))).astype(np.float32) for _ in range(2 * field)]
    key = tuple((0.2 * rng.standard_normal((1, N, 3))).astype(np.float32) for _ in range(2))
    t = np.array([0.4], np.float32)
    z = np.zeros_like(keys[0])
    args = ([J(x) for x in fwd], [J(x) for x in keys], [J(x) for x in bwd], J(t), J(z))
    model = JPointINet2(field=field)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFlowNet3D, "multi", lambda self, *a, **kw: [J(f) for f in ring])
        mp.setattr(JFlowNet3D, "__call__", lambda self, *a, **kw: tuple(J(f) for f in key))
        rngs = {"params": jax.random.key(0), "sample": jax.random.key(1)}
        v = shifted(as_np(jax.jit(lambda *a: model.init(rngs, *a, train=False))(*args)))
        out, perms = recorded(lambda v, *a: model.apply(
            v, *a, train=False, rngs={"sample": jax.random.key(2)}))(v, *args)
    return (fwd, keys, bwd, t, z), (ring, key), v, perms, np.asarray(out)


@pytest.mark.parametrize("field", [1, 2])
def test_pointinet2_matches_jax(field):
    """The whole model on the same flows and JAX's permutations: Wnet, the
    key PointINet's fusion (k = 32), each ring's warp (flows divided by
    the ring's index) and PointsFusion at k = 64, and PointsFusionMulti
    over the field + 1 fused clouds at k = 64."""
    (fwd, keys, bwd, t, z), (ring, key), v, perms, want = injected(field)
    assert len(perms) == 2 + 2 * field + field + 1
    model = PointINet2(field)
    # the JAX init never ran FlowNet3D (its flows were given): every other
    # weight loads; the port's flows are replaced as JAX's were
    missing, unexpected = model.load_state_dict(flax_to_state_dict(v), strict=False)
    assert unexpected == [] and all(".flow." in f".{m}" for m in missing)
    model.flow.multi = lambda clouds, feats, pairs: [T(f) for f in ring]
    model.pointinet.flow.bidirectional = lambda *a: tuple(T(f) for f in key)
    with torch.inference_mode():
        got = model.eval()([T(x) for x in fwd], [T(x) for x in keys], [T(x) for x in bwd],
                           T(t), T(z), perms=[T(p) for p in perms])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def golden_case():
    """tests/golden_cases.py's ``pointinet2`` case: its clouds, its JAX
    variables and the permutations JAX drew in its apply."""
    from tests.golden_cases import _clouds, _z

    f1, k1, k2, b1 = _clouds(5, 4)
    t = jnp.asarray([0.4], jnp.float32)
    net = JPointINet2(field=1)
    rngs = {"params": jax.random.key(0), "sample": jax.random.key(1)}
    args = ([f1], [k1, k2], [b1], t, _z())
    v = as_np(jax.jit(lambda *a: net.init(rngs, *a, train=False))(*args))
    _, perms = recorded(lambda v, *a: net.apply(v, *a, train=False, rngs={
        "sample": jax.random.key(2)}))(v, *args)
    return [np.asarray(x) for x in (f1, k1, k2, b1, t, _z())], v, perms


def test_pointinet2_matches_golden_and_loads_jax_tree():
    """The whole JAX variable tree of the golden case (flows included)
    loads into the port with no key left over or missing, and the port's
    forward on the golden clouds, with the golden apply's permutations,
    matches the committed ``pointinet2`` golden."""
    (f1, k1, k2, b1, t, z), v, perms = golden_case()
    model = PointINet2(1)
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.inference_mode():
        got = model.eval()([T(f1)], [T(k1), T(k2)], [T(b1)], T(t), T(z),
                           perms=[T(p) for p in perms])
    want = np.load(ROOT / "tests" / "golden" / "model_outputs.npz")["pointinet2"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_pointinet2_refuses_field0():
    """field 0: the JAX PointINet2 cannot be built (its Wnet's last Dense
    has 0 features, and flax's initializer divides by that), so the port's
    refuses it too."""
    with pytest.raises(ValueError, match="field >= 1"):
        PointINet2(0)
    with pytest.raises(ZeroDivisionError):
        JWnet(0).init(jax.random.key(0), jnp.zeros((1, 1)))


def test_eval_step_runs_pointinet2():
    """``make_interp_eval_step`` on PointINet2 (field 2, batch 2 of 256
    points, a seeded init, drawn permutations): finite ``[B]`` chamfers
    and ``[B, N, 3]`` frames."""
    torch.manual_seed(1750)
    rng = np.random.default_rng(1750)
    B, N, field = 2, 256, 2
    frames = [T((rng.standard_normal((B, N, 3)) * 2).astype(np.float32))
              for _ in range(2 * field + 3)]
    batch = {"forward": frames[:field], "keys": frames[field:field + 2],
             "backward": frames[field + 2:2 * field + 2], "gt": frames[-1],
             "t": T(np.array([0.3, 0.6], np.float32)), "ini": torch.zeros(B, N, 3)}
    step = make_interp_eval_step(PointINet2(field))
    cd, frame = step(batch, torch.Generator().manual_seed(1751))
    assert cd.shape == (B,) and frame.shape == (B, N, 3)
    assert torch.isfinite(cd).all() and torch.isfinite(frame).all()
