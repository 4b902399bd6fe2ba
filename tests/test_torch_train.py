"""The port's training slice against the JAX package, on CPU: the prefix
kNN, the chamfer loss, the fusion's residual kNN, the trainable attention's
backward, BatchNorm in train mode, the schedules and the frozen flow, and
ISAPCInet field=2's whole train step.

Inputs come from numpy with a fixed seed per test.  Pallas kernels run in
interpret mode, as the JAX package's own CPU tests run them.  The random
draws of a JAX train step (the fusion's permutations, PointNet++'s FPS
starts) cannot be reproduced by torch, so both sides get the same ones:
``pci_tpu.nn.fusion._random_perms`` and ``pci_tpu.nn.pointnet2.fps_start``
are patched on the JAX side, ``pci_tpu_torch.nn.fusion.random_perms`` and
``pci_tpu_torch.nn.pointnet2.fps_start`` on the port's; FlowNet3D.multi
returns the same given flows on both (PointNet++ and the transformer select
over the flow cloud, where a 1e-6 flow difference flips picks; see
tests/test_torch_isapci.py).

Run as a script, ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_train.py`` prints the readings that the whole step's
limits are set from (about a minute).
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import pci_tpu.nn.fusion as jfusion
import pci_tpu.nn.pointnet2 as jpn2
import pci_tpu_torch.nn.fusion as tfusion
import pci_tpu_torch.nn.pointnet2 as tpn2
from pci_tpu import ops as jops
from pci_tpu import train as jtrain
from pci_tpu.models import ISAPCInet as JISAPCInet
from pci_tpu.models.flownet3d import FlowNet3D as JFlowNet3D
from pci_tpu.nn.norm import BatchNorm as JBatchNorm
from pci_tpu_torch import ops as tops
from pci_tpu_torch import train as ttrain
from pci_tpu_torch.convert import flax_to_state_dict, load_subtrees
from pci_tpu_torch.models import ISAPCInet
from pci_tpu_torch.nn import BatchNorm
from pci_tpu_torch.ops.cuda_kernels import attention_cuda, fusion_knn_cuda
from pci_tpu_torch.serving import init_weights
from tests.test_torch_shared import shared_result

torch.set_num_threads(2)

J, T = jnp.asarray, torch.from_numpy


def cloud(rng, b, n, c=3, scale=1.0):
    return (rng.standard_normal((b, n, c)) * scale).astype(np.float32)


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- ops: the prefix kNN and the chamfer loss --------------------------


def test_knn_prefix_plain_matches_jax():
    """k=8 into key prefixes of 5 (fewer than k: the surplus slots hold
    the sentinel and the masked keys in index order) and of all 200, and
    the chamfer's k=1 nearest neighbour.  Indices equal; distances within
    1e-6 (clouds of scale 0.5, where the JAX package's expanded
    ``|a|^2 + |b|^2 - 2ab`` is exact to that)."""
    rng = np.random.default_rng(500)
    q, p = cloud(rng, 2, 64, scale=0.5), cloud(rng, 2, 200, scale=0.5)
    valid = np.array([5, 200], np.int32)
    d, i = tops.knn(T(q), T(p), 8, T(valid))
    jd, ji = jops.knn_prefix(J(q), J(p), 8, J(valid), exact=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    assert (i.numpy()[0, :, 5:] == np.arange(5, 8)).all()
    from pci_tpu.ops.chamfer import nearest_neighbor_idx

    got = tops.nearest_neighbor_idx(T(q), T(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(nearest_neighbor_idx(J(q), J(p))))


@pytest.mark.parametrize("k", [1, 16])
def test_knn_over_a_prefix_is_knn_of_the_prefix(k):
    """With ``valid_n >= k``, each batch row of ``knn(q, p, k, valid_n)``
    is that row's ``knn`` into its first ``valid_n`` keys: distances and
    indices bit-equal."""
    rng = np.random.default_rng(513)
    q, p = T(cloud(rng, 3, 50)), T(cloud(rng, 3, 120))
    valid = torch.tensor([16, 77, 120])
    d, i = tops.knn(q, p, k, valid)
    for b, n in enumerate(valid.tolist()):
        db, ib = tops.knn(q[b:b + 1], p[b:b + 1, :n], k)
        assert torch.equal(d[b:b + 1], db) and torch.equal(i[b:b + 1], ib), b


def test_chamfer_matches_jax():
    """chamfer_distance and chamfer_per_sample, values and gradients in
    both clouds ([2, 300, 3] against [2, 280, 3]), rtol 1e-5."""
    rng = np.random.default_rng(501)
    a, b = cloud(rng, 2, 300), cloud(rng, 2, 280)
    w = np.array([1.0, 0.3], np.float32)  # per-sample weights
    for jfn, tfn, wt in ((jops.chamfer_distance, tops.chamfer_distance, np.float32(1)),
                         (jops.chamfer_per_sample, tops.chamfer_per_sample, w)):
        want, (ga, gb) = jax.value_and_grad(
            lambda x, y: jnp.sum(jfn(x, y) * wt), argnums=(0, 1))(J(a), J(b))
        ta, tb = T(a).requires_grad_(), T(b).requires_grad_()
        got = (tfn(ta, tb) * torch.as_tensor(wt)).sum()
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), rtol=1e-5, atol=1e-7)
    cf = tops.chamfer_loss_cf(T(a).transpose(1, 2), T(b).transpose(1, 2))
    np.testing.assert_allclose(cf.item(), float(jops.chamfer_loss_cf(
        J(a).transpose(0, 2, 1), J(b).transpose(0, 2, 1))), rtol=1e-5)


# ---- the fusion's residual kNN (kernel row 4b) -------------------------


def jax_resi_route(combined, seg_ends, budgets, k):
    """The JAX package's XLA fusion route over F segments of ``combined``:
    one ``knn_prefix`` per segment (the segment rolled to the front, as the
    shuffled cloud's prefix is), then ``_prefix_merge`` (F=2) or
    ``_budget_compact`` (F>2).  Returns (idx into combined, resi)."""
    B, N, _ = combined.shape
    F = seg_ends.shape[1]
    starts = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), seg_ends[:, :-1]], 1)
    pos = jnp.arange(N, dtype=jnp.int32)
    nns, idxs = [], []
    for j in range(F):
        roll = (starts[:, j:j + 1] + pos[None]) % N
        seg = jnp.take_along_axis(combined, roll[..., None], axis=1)
        _, idx = jops.knn_prefix(combined, seg, k, seg_ends[:, j] - starts[:, j], exact=True)
        nns.append(jops.index_points(seg, idx))
        idxs.append(((idx + starts[:, j, None, None]) % N).astype(jnp.float32)[..., None])
    if F == 2:
        nn = jfusion._prefix_merge(nns[0], nns[1], budgets[:, 0], axis=2)
        idx = jfusion._prefix_merge(idxs[0], idxs[1], budgets[:, 0], axis=2)
    else:
        nn = jfusion._budget_compact(nns, budgets, k)
        idx = jfusion._budget_compact(idxs, budgets, k)
    return jnp.round(idx[..., 0]).astype(jnp.int32), nn - combined[:, :, None, :]


@pytest.mark.parametrize("F", [2, 3])
def test_fusion_resi_knn_matches_jax(F):
    """idx equal and resi within 1e-6 of the JAX route; the backward (the
    fixed-neighbour rule through scatter_add_rows) against jax.grad of the
    route within 1e-5.  F=3 is PointsFusionMulti's shape at field=2."""
    rng = np.random.default_rng(502 + F)
    N, k = 200, 32
    x = cloud(rng, 2, N)
    ends = {2: [[96, 200], [128, 200]], 3: [[64, 128, 200], [96, 160, 200]]}[F]
    buds = {2: [[16, 16], [23, 9]], 3: [[10, 12, 10], [20, 4, 8]]}[F]
    ends, buds = np.array(ends, np.int32), np.array(buds, np.int32)
    G = cloud(rng, 2, N * k).reshape(2, N, k, 3)
    jidx, jresi = jax_resi_route(J(x), J(ends), J(buds), k)
    jgrad = jax.grad(lambda c: jnp.sum(jax_resi_route(c, J(ends), J(buds), k)[1] * J(G)))(J(x))
    tx = T(x).requires_grad_()
    idx, resi = fusion_knn_cuda.fusion_resi_knn(tx, T(ends), T(buds), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(resi.detach().numpy(), np.asarray(jresi), atol=1e-6, rtol=0)
    (resi * T(G)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), atol=1e-5, rtol=1e-5)


def test_fusion_resi_knn_starved_segment():
    """A segment with fewer rows than its budget: its surplus slots hold
    the row itself (a zero residual), as fusion_knn_tpu does."""
    rng = np.random.default_rng(505)
    x = T(cloud(rng, 1, 64))
    idx, resi = fusion_knn_cuda.fusion_resi_knn(x, torch.tensor([[4, 64]]),
                                                torch.tensor([[8, 24]]), 32)
    _, ia = tops.knn(x, x[:, :4], 4)
    _, ib = tops.knn(x, x[:, 4:], 24)
    own = torch.arange(64)[None, :, None].expand(1, 64, 4)
    torch.testing.assert_close(idx, torch.cat([ia, own, ib + 4], dim=2), atol=0, rtol=0)
    assert (resi[:, :, 4:8] == 0).all()


# ---- the trainable attention's backward (kernel row 11b) ---------------


@pytest.mark.parametrize("d", [16, 96, 128])
def test_attention_backward_matches_jax(d):
    """The plain backward and the autograd route (plain versions) against
    jax.grad of vector_attention_trainable in interpret mode, at
    TestTrainableAttentionVJP's shapes and tolerances (tests/test_layers.py:
    B=1, N=300, k=4, d=16; rtol 2e-4, atol 2e-5), and at ISAPCInet's
    published widths 96 and 128 (N=48, the interpret mode's time; the d x d
    weights at 1.6 / sqrt(d), 0.4 at d = 16, so the activations keep d =
    16's scale; the same tolerances)."""
    from pci_tpu.ops.pallas_kernels.attention_tpu import vector_attention_trainable

    rng = np.random.default_rng(506)
    B, N, k = 1, 300 if d == 16 else 48, 4
    mk = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    q, g, delta = mk(B, N, d), mk(B, N, k, 2 * d), mk(B, N, k, 3)
    sc = 1.6 / d ** 0.5
    ws = [mk(3, d, sc=0.4), mk(d, d, sc=sc), mk(d, d, sc=sc), mk(d, d, sc=sc)]
    bs = [mk(d, sc=0.1) for _ in range(4)]
    flat = [a for wb in zip(ws, bs) for a in wb]
    cot = mk(B, N, d)
    jgrads = jax.grad(lambda *a: jnp.sum(vector_attention_trainable(*a, True) * J(cot)),
                      argnums=tuple(range(11)))(J(q), J(g), J(delta), *map(J, flat))
    names = "q g delta wd0 bd0 wd1 bd1 wg0 bg0 wg1 bg1".split()
    # the port's tail takes nn.Linear's layout: W [out, in]
    tail = [(T(w.T.copy()).requires_grad_(), T(b).requires_grad_()) for w, b in zip(ws, bs)]
    plain = attention_cuda.attention_bwd_plain(T(q), T(g), T(delta),
                                               [(w.detach(), b.detach()) for w, b in tail],
                                               T(cot))
    tq, tg, td = (T(a).requires_grad_() for a in (q, g, delta))
    out = attention_cuda.vector_attention_trainable(tq, tg, td, tail)
    (out * T(cot)).sum().backward()
    routed = [tq.grad, tg.grad, td.grad] + [t.grad for wb in tail for t in wb]
    for name, want, p, r in zip(names, jgrads, plain, routed):
        want = np.asarray(want)
        if name.startswith("w"):
            want = want.T  # flax [in, out] -> [out, in]
        for got in (p, r):
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5, err_msg=name)


# ---- BatchNorm, the schedules, the freeze ------------------------------


def test_batchnorm_train_matches_flax():
    """Output and updated running statistics at momentum 0.5 against
    flax's BatchNorm(train=True) with mutable batch_stats, within 1e-5."""
    rng = np.random.default_rng(507)
    x = (rng.standard_normal((2, 40, 8, 6)) * 1.5 + 0.7).astype(np.float32)
    jm = JBatchNorm()
    v = jm.init(jax.random.key(0), J(x), train=False)
    v = jax.tree_util.tree_map(lambda a: a + 0.1 * jnp.arange(a.size, dtype=a.dtype), v)
    want, upd = jm.apply(v, J(x), train=True, momentum=0.5, mutable=["batch_stats"])
    tm = BatchNorm(6)
    tm.load_state_dict(flax_to_state_dict(as_np(v)))
    tx = T(x).requires_grad_()
    got = tm.train()(tx, 0.5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tm.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tm.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               atol=1e-5, rtol=1e-5)
    got.sum().backward()  # statistics stay out of the graph
    assert tx.grad is not None and not tm.running_mean.requires_grad


def test_schedules_match_jax():
    """The values tests/test_train.py pins, and the JAX schedules' own at
    more epochs; the optimizer's learning rate follows a schedule of its
    update count."""
    lr, jlr = ttrain.clipped_step_lr(0.01, 100, 0.9, 1e-6), jtrain.clipped_step_lr(0.01, 100, 0.9, 1e-6)
    for e, want in ((0, 0.01), (99, 0.01), (100, 0.009), (100000, 1e-6)):
        assert lr(e) == pytest.approx(want)
    mom, jmom = ttrain.bn_momentum_schedule(0.5, 0.5, 100, 0.01), jtrain.bn_momentum_schedule(0.5, 0.5, 100, 0.01)
    for e, want in ((0, 0.5), (100, 0.25), (10000, 0.01)):
        assert mom(e) == pytest.approx(want)
    for e in (0, 1, 150, 250, 777, 5000):  # the JAX schedules round in fp32
        assert lr(e) == pytest.approx(float(jlr(e)), rel=1e-5)
        assert mom(e) == pytest.approx(float(jmom(e)), rel=1e-5)
    p = torch.nn.Parameter(torch.ones(3))
    opt = ttrain.Adam([p], lambda step: 0.1 * (step + 1))
    for want in (0.1, 0.2, 0.3):
        p.grad = torch.ones(3)
        opt.step()
        assert opt.param_groups[0]["lr"] == pytest.approx(want)


def batch_np(seed, field=2, n=96, b=2):
    rng = np.random.default_rng(seed)
    c = lambda: cloud(rng, b, n)  # noqa: E731
    return {"forward": [c() for _ in range(field)], "keys": [c(), c()],
            "backward": [c() for _ in range(field)],
            "t": np.array([0.5, 0.3], np.float32)[:b], "gt": c(),
            "ini": np.zeros((b, n, 3), np.float32)}


def to_torch(batch):
    return {k: [T(x) for x in v] if isinstance(v, list) else T(v) for k, v in batch.items()}


def to_jax(batch):
    return {k: [J(x) for x in v] if isinstance(v, list) else J(v) for k, v in batch.items()}


def test_frozen_flow_has_no_grad_and_stays():
    """A step of the port's ISAPCInet field=2 with its real FlowNet3D:
    the flow stays in eval mode, gets no gradient and no update (bit for
    bit, running statistics included); every other parameter gets a
    gradient and moves; the Adam state covers the trainable ones only."""
    model = ISAPCInet(2, ff_out_c=16, tr_out_c=16)
    init_weights(model, 0)
    opt = ttrain.make_optimizer(0.01, model, ("flow",))
    step = ttrain.make_interp_train_step(model, opt, ("flow",))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss = step(to_torch(batch_np(508)), torch.Generator().manual_seed(0), 0.5)
    assert torch.isfinite(loss) and model.training and not model.flow.training
    for name, p in model.named_parameters():
        if name.startswith("flow."):
            assert not p.requires_grad and p.grad is None, name
        else:
            assert p.grad is not None, name
    after = model.state_dict()
    for key, val in before.items():
        if key.startswith("flow."):
            assert torch.equal(after[key], val), key
    moved = [k for k, _ in model.named_parameters()
             if not k.startswith("flow.") and not torch.equal(after[k], before[k])]
    assert len(moved) == sum(1 for k, _ in model.named_parameters() if not k.startswith("flow."))
    assert len(opt.state) == len(moved)
    cds, frame = ttrain.make_interp_eval_step(model)(to_torch(batch_np(508)))
    assert cds.shape == (2,) and frame.shape == (2, 96, 3) and not model.training


# ---- the whole step ----------------------------------------------------

N_STEP, FIELD, LR = 256, 2, 1e-2
# Limits of the whole-step comparison, each just above its reading at
# N_STEP (``JAX_PLATFORMS=cpu python tests/test_torch_train.py`` prints the
# readings).  The gradients are ill-conditioned in their worst leaves:
# PointNet++'s slot max-pools hold maxima whose two top slots lie within
# 1e-6 of each other, so the two packages' rounding routes a few of them
# to different slots.  A one-ulp change of the given flows moves the
# port's own gradients by as much as the port and JAX differ.
GRAD_LIMIT = 1e-2  # of a leaf's largest JAX gradient; worst leaf 8.65e-3
GRAD_MEDIAN_LIMIT = 5e-4  # the same ratio's median over the leaves; 2.84e-4
COSINE_LIMIT = 0.99995  # least cosine of a leaf's two gradients; 0.999980
STEPS_LOSS_LIMIT = 7e-3  # the port's own three losses; worst 5.14e-3


def run_jax_step():
    """ISAPCInet field=2 (ff_out_c = tr_out_c = 16, N=256, B=2, t = 0.5
    and 0.3) trained by the JAX package's make_interp_train_step on given
    flows, permutations and FPS starts: the inputs, the initial variables,
    the gradients and variables after one step (the gradients recorded
    from inside the jitted step), and the losses of three steps.  N=256
    makes the flow cloud 1,024 points, sa1's sample count: a smaller cloud
    has sa1 repeat one point hundreds of times."""
    batch = batch_np(510, n=N_STEP)
    rng = np.random.default_rng(511)
    B, N = 2, N_STEP
    flows = [(0.1 * rng.standard_normal((B, N, 3))).astype(np.float32)
             for _ in range(4 * FIELD)]
    perms = [np.stack([rng.permutation(N) for _ in range(B)]).astype(np.int32)
             for _ in range(2)]
    sizes = [2 * FIELD * N, 1024, 256, 64]  # the SA levels' input sizes
    starts = [rng.integers(0, n, B).astype(np.int32) for _ in range(2) for n in sizes]
    jb = to_jax(batch)
    model = JISAPCInet(field=FIELD, ff_out_c=16, tr_out_c=16)
    grads = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFlowNet3D, "multi", lambda self, c, f, p, **kw: [J(x) for x in flows])
        perm_draws = itertools.cycle(perms)
        mp.setattr(jfusion, "_random_perms", lambda key, b, n: J(next(perm_draws)))
        start_draws = itertools.cycle(starts)
        mp.setattr(jpn2, "fps_start",
                   lambda module, xyz, train: J(next(start_draws)) if train else 0)
        v = jax.jit(lambda: model.init({"params": jax.random.key(0), "sample": jax.random.key(1)},
                                       jb["forward"], jb["keys"], jb["backward"], jb["t"],
                                       jb["ini"], train=False))()
        v = jax.tree_util.tree_map(  # non-trivial running statistics and biases
            lambda x: x + 0.05 * jnp.arange(x.size, dtype=x.dtype) / x.size if x.ndim == 1 else x, v)
        adam = jtrain.make_optimizer(LR, v["params"], freeze_subtrees=("flow",))

        def spy_update(g, s, p=None):
            jax.debug.callback(lambda gg: grads.append(as_np(gg)), g, ordered=True)
            return adam.update(g, s, p)

        spy = optax.GradientTransformation(adam.init, spy_update)
        state = jtrain.create_train_state(v["params"], v["batch_stats"], spy)
        step = jax.jit(jtrain.make_interp_train_step(model, spy, freeze_subtrees=("flow",)))
        states, losses = [state], []
        for i in range(3):
            s, metrics = step(states[-1], jb, jax.random.key(2 + i), jnp.float32(0.5))
            states.append(s)
            losses.append(float(metrics["loss"]))
        jax.effects_barrier()
    return dict(batch=batch, flows=flows, perms=perms, starts=starts,
                variables=as_np(v), grads=grads[0],
                after=[as_np(st.variables) for st in states[1:]], losses=losses)


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    return shared_result("train_jax_step", run_jax_step, tmp_path_factory)


def port_model(js, flow_ulps: int = 0):
    """The port's ISAPCInet with the JAX step's initial variables (its
    FlowNet3D keeps seeded weights: the given flows replace it on both
    sides) and the same flows, moved ``flow_ulps`` float32 steps (+1 up, -1
    down, 0 as given)."""
    model = ISAPCInet(FIELD, ff_out_c=16, tr_out_c=16)
    load_subtrees(model, js["variables"])
    flows = [np.nextafter(f, np.float32(np.inf * flow_ulps)) if flow_ulps else f
             for f in js["flows"]]
    model.flow.multi = lambda clouds, feats, pairs: [T(f) for f in flows]
    return model


def use_same_draws(mp, js):
    """The JAX step's permutations and FPS starts for the port's steps."""
    perms = itertools.cycle([T(p).long() for p in js["perms"]])
    mp.setattr(tfusion, "random_perms", lambda B, N, gen, dev: next(perms))
    starts = itertools.cycle([T(s).long() for s in js["starts"]])
    mp.setattr(tpn2, "fps_start",
               lambda module, xyz, gen=None: next(starts) if module.training else 0)


@pytest.fixture
def same_draws(jax_step, monkeypatch):
    use_same_draws(monkeypatch, jax_step)


def port_steps(js, steps: int = 1, flow_ulps: int = 0):
    """``steps`` steps of the port from the JAX step's initial variables
    -> (losses, model, its initial state dict)."""
    model = port_model(js, flow_ulps)
    p0 = {n: v.clone() for n, v in model.state_dict().items()}
    step = ttrain.make_interp_train_step(
        model, ttrain.make_optimizer(LR, model, ("flow",)), ("flow",))
    losses = [step(to_torch(js["batch"]), None, 0.5).item() for _ in range(steps)]
    return losses, model, p0


def grad_gaps(got: dict, want: dict) -> dict:
    """Per leaf: (max |got - want|, max |want|, cosine of the two; 1 where
    max |want| <= 1e-6)."""
    out = {}
    for name, w in want.items():
        g, w = got[name].astype(np.float64), w.astype(np.float64)
        scale = np.abs(w).max()
        cos = 1.0
        if scale > 1e-6:
            cos = float((g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w)))
        out[name] = (np.abs(g - w).max(), scale, cos)
    return out


def median_ratio(gaps: dict) -> float:
    """The median over the leaves with max |want| > 1e-6 of max |got -
    want| / max |want|."""
    return float(np.median([e / s for e, s, _ in gaps.values() if s > 1e-6]))


def trained_grads(model) -> dict:
    return {n: p.grad.numpy() for n, p in model.named_parameters() if p.requires_grad}


def test_train_step_matches_jax(jax_step, same_draws):
    """One step: the loss (rtol 1e-5), every trainable gradient, the Adam
    update and the new running statistics (1e-5).

    Gradients: each within GRAD_LIMIT of its largest magnitude plus 1e-6
    (the floor is for the leaves that are zero in exact arithmetic: the
    Dense biases before a train-mode BatchNorm, the last attention bias),
    the median leaf within GRAD_MEDIAN_LIMIT, cosines >= COSINE_LIMIT.
    Not elementwise at 1e-4: see the limits' comment.

    Adam moves a parameter by about lr * g / (|g| + 1e-8), so a gradient
    near 0 can move it either way on rounding alone.  The update is held
    twice: every parameter against optax.adam applied to the port's own
    gradient (within 3e-7, two ulps near 1; reading 1.2e-7), and against
    the JAX step's updated parameters, within lr * 1e-3, wherever |g| >
    1e-6 and |g| exceeds its leaf's gradient limit, so that the gradient
    check fixes the sign of the port's g (reading 1.2e-6)."""
    js = jax_step
    (loss,), model, p0 = port_steps(js)
    np.testing.assert_allclose(loss, js["losses"][0], rtol=1e-5)
    want = {n: t.numpy() for n, t in flax_to_state_dict({"params": js["grads"]}).items()}
    want_after = flax_to_state_dict(js["after"][0])
    got = trained_grads(model)
    assert sorted(got) == sorted(want), "the JAX tree has every trainable parameter"
    assert all(n.startswith("flow.") for n, p in model.named_parameters() if not p.requires_grad)
    gaps = grad_gaps(got, want)
    for name, (err, scale, cos) in gaps.items():
        assert err <= GRAD_LIMIT * scale + 1e-6, (name, err, scale)
        assert cos >= COSINE_LIMIT, (name, cos)
    assert median_ratio(gaps) <= GRAD_MEDIAN_LIMIT
    adam = optax.adam(LR)
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        upd, _ = adam.update(J(got[name]), adam.init(J(p0[name].numpy())))
        after = p.detach().numpy()
        np.testing.assert_allclose(after, p0[name].numpy() + np.asarray(upd),
                                   atol=3e-7, rtol=0, err_msg=name)
        g = want[name]
        fixed = (np.abs(g) > 1e-6) & (np.abs(g) > GRAD_LIMIT * np.abs(g).max() + 1e-6)
        np.testing.assert_allclose(after[fixed], want_after[name].numpy()[fixed],
                                   atol=LR * 1e-3, rtol=0, err_msg=name)
    for name, buf in model.named_buffers():
        if name.startswith("flow."):
            assert torch.equal(buf, p0[name]), name
        else:
            np.testing.assert_allclose(buf.numpy(), want_after[name].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=name)


def test_three_train_steps_match_jax(jax_step, same_draws):
    """Three steps on the same batch.  The port's loss at the JAX step's
    parameters after steps 1 and 2 equals the JAX step's losses 2 and 3
    (rtol 1e-5).  The port's own three steps give finite losses, the first
    within 1e-5 and all within STEPS_LOSS_LIMIT of the JAX step's: Adam's
    first steps move every parameter by about lr * sign(g), so a gradient
    near 0 whose sign the two packages round apart parts them by 2 lr."""
    js = jax_step
    losses, model, _ = port_steps(js, 3)
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[0], js["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(losses, js["losses"], rtol=STEPS_LOSS_LIMIT)
    for after, want in zip(js["after"][:2], js["losses"][1:]):
        model.load_state_dict(flax_to_state_dict(after), strict=False)
        with torch.no_grad():
            got = ttrain.interp_loss(model.train(), to_torch(js["batch"]), None, 0.5)
        np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_adam_matches_optax():
    """The port's Adam, with a step-count schedule, against optax.adam over
    three updates of the same gradients (optax.inject_hyperparams gives it
    the same learning rates): parameters within 1e-7."""
    rng = np.random.default_rng(512)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    gs = [rng.standard_normal((5, 7)).astype(np.float32) * 10.0 ** -i for i in range(3)]
    sched = lambda count: 0.01 * 0.5 ** count  # noqa: E731
    tx = optax.adam(lambda count: 0.01 * 0.5 ** count)
    jp, st = J(p0), tx.init(J(p0))
    p = torch.nn.Parameter(T(p0.copy()))
    opt = ttrain.Adam([p], sched)
    for g in gs:
        upd, st = tx.update(J(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = T(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), atol=1e-7, rtol=1e-6)


def near_tied_maxima(model, rel: float = 1e-6) -> dict:
    """Forward hooks on PointNet++'s slot MLPs: per MLP, the (center,
    channel) maxima over the slots whose two largest distinct values lie
    within ``rel`` of the MLP output's largest magnitude."""
    counts, hooks = {}, []
    for name, mod in model.ffab.named_modules():
        if name.startswith("sa") and ".scale" in name and name.count(".") == 1:
            def hook(mod, args, out, name=name):
                x = out.detach()
                top = x.topk(2, dim=2).values
                gap = (top[:, :, 0] - top[:, :, 1]) / x.abs().max()
                tied = (top[:, :, 0] > top[:, :, 1]) & (gap < rel)
                counts[name] = counts.get(name, 0) + int(tied.sum())
            hooks.append(mod.register_forward_hook(hook))
    return counts, hooks


def print_readings():
    """The readings the whole-step limits are set from."""
    js = run_jax_step()
    want = {n: t.numpy() for n, t in flax_to_state_dict({"params": js["grads"]}).items()}
    want_after = flax_to_state_dict(js["after"][0])
    with pytest.MonkeyPatch.context() as mp:
        use_same_draws(mp, js)
        model = port_model(js)
        ties, hooks = near_tied_maxima(model)
        step = ttrain.make_interp_train_step(
            model, ttrain.make_optimizer(LR, model, ("flow",)), ("flow",))
        p0 = {n: v.clone() for n, v in model.state_dict().items()}
        loss = step(to_torch(js["batch"]), None, 0.5).item()
        for h in hooks:
            h.remove()
        got = trained_grads(model)
        gaps = grad_gaps(got, want)
        print(f"one step: loss {loss!r} against JAX {js['losses'][0]!r}, "
              f"rel {abs(loss - js['losses'][0]) / abs(js['losses'][0]):.3g}")
        print("per leaf: max|port - JAX| / max|JAX|, max|JAX|, cosine")
        for name, (e, s, c) in sorted(gaps.items(), key=lambda kv: -kv[1][0] / kv[1][1]):
            print(f"  {e / s:.3e}  {s:.3e}  {c:.7f}  {name}")
        print(f"median over the {sum(s > 1e-6 for _, s, _ in gaps.values())} leaves above "
              f"1e-6: {median_ratio(gaps):.3e}; least cosine "
              f"{min(c for _, _, c in gaps.values()):.7f}")
        print(f"maxima within 1e-6 of a tie (slot MLP: count over both passes): {ties}")
        adam, own, vs_jax, fixed, big = optax.adam(LR), 0.0, 0.0, 0, 0
        for name, p in model.named_parameters():
            if not p.requires_grad:
                continue
            upd, _ = adam.update(J(got[name]), adam.init(J(p0[name].numpy())))
            after = p.detach().numpy()
            own = max(own, float(np.abs(after - p0[name].numpy() - np.asarray(upd)).max()))
            g = want[name]
            sel = (np.abs(g) > 1e-6) & (np.abs(g) > GRAD_LIMIT * np.abs(g).max() + 1e-6)
            fixed, big = fixed + int(sel.sum()), big + int((np.abs(g) > 1e-6).sum())
            if sel.any():
                vs_jax = max(vs_jax, float(np.abs(after - want_after[name].numpy())[sel].max()))
        print(f"Adam: max |port - optax.adam on the port's gradient| {own:.3g}; max |port - "
              f"JAX| {vs_jax:.3g} over the {fixed} of {big} elements with |g| > 1e-6 whose "
              f"sign the gradient limit fixes")
        for sign in (1, -1):
            (l, *_), m, _ = port_steps(js, flow_ulps=sign)
            moved = grad_gaps(trained_grads(m), got)
            worst = max(moved.items(), key=lambda kv: kv[1][0] / max(kv[1][1], 1e-30)
                        if kv[1][1] > 1e-6 else 0.0)
            print(f"flows one ulp {'up' if sign > 0 else 'down'}: loss rel {abs(l - loss) / loss:.3g}, "
                  f"the port's gradients move by up to {worst[1][0] / worst[1][1]:.3e} of "
                  f"max ({worst[0]}), median {median_ratio(moved):.3e}")
        losses, model, _ = port_steps(js, 3)
        rel = np.abs(np.array(losses) - js["losses"]) / np.abs(js["losses"])
        print(f"three steps: port {losses}, JAX {js['losses']}, rel {rel.tolist()}")
        for i, (after, want_loss) in enumerate(zip(js["after"][:2], js["losses"][1:])):
            model.load_state_dict(flax_to_state_dict(after), strict=False)
            with torch.no_grad():
                l = ttrain.interp_loss(model.train(), to_torch(js["batch"]), None, 0.5).item()
            print(f"the port's loss at JAX's parameters after step {i + 1}: rel "
                  f"{abs(l - want_loss) / abs(want_loss):.3g}")


if __name__ == "__main__":
    print_readings()
