"""PointINet with its intensity channel (``[B, N, 4]`` clouds, the reference's
KITTI 4-channel mode) in the port, held on the CPU against the JAX package.

- ``PointsFusionWithFeatures`` (plain versions) against JAX's (its XLA
  route, jitted once per k and width in a module fixture) at N = 256, k = 8
  and 32, t = 0.2 and 0.5, one and two feature channels, with the same
  permutations in both packages: within 1e-5.
- The port's PointINet at width 4 against JAX's (``freeze_flow``, the
  trained ``assets/pointinet_synth16k.npz`` in both) at N = 1,024, within
  ``tests/test_torch_pointinet.py``'s model tolerance.
- The weights carry across: JAX's PointINet has the same variable tree at
  widths 3 and 4, and the port's model loads the trained npz through
  ``convert`` unchanged.
- The CUDA routes on a stub kernel library (``_build.use_kernel`` forced;
  the stub records each C entry's arguments and writes the plain version's
  result): the one-shot kernel (flat, and cell-pruned with the cells gate
  patched low) launched once with the payload; one-shot off, the residual
  kNN and the tail with ``Ce = 1``; k = 160 (the tail alone) and a payload
  wider than ``MAX_PAYLOAD`` (nothing) launch no kNN kernel and give the
  plain route's rows.

chip_smoke.py holds the payload kernels themselves against their plain
versions on the card."""

from __future__ import annotations

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pci_tpu.nn.fusion as jfusion
import pci_tpu_torch.nn.fusion as tfusion
from pci_tpu.models import PointINet as JPointINet
from pci_tpu_torch.convert import flax_to_state_dict, load_npz_tree
from pci_tpu_torch.models import PointINet
from pci_tpu_torch.nn import PointsFusion, PointsFusionWithFeatures
from pci_tpu_torch.ops.cuda_kernels import _build, fusion_cells_cuda, fusion_knn_cuda
from pci_tpu_torch.ops.cuda_kernels.fusion_tail_cuda import fusion_tail_plain
from pci_tpu_torch.serving import DEFAULT_WEIGHTS
from tests.test_torch_hopper_rows_12_13 import StubLibrary, write
from tests.test_torch_pointinet import MODEL_TOL, pair

torch.set_num_threads(2)

F32 = np.float32
T = torch.from_numpy


def clouds(seed: int, N: int, C: int):
    """Two seeded warped clouds ``[1, N, 3]``, their features ``[1, N, C]``
    (intensity-like, in [0, 1]) and two permutations."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((1, N, 3)) * 2).astype(F32)
    b = a + (0.2 * rng.standard_normal((1, N, 3))).astype(F32)
    fa, fb = (rng.random((1, N, C)).astype(F32) for _ in range(2))
    perms = [rng.permutation(N)[None].astype(np.int32) for _ in range(2)]
    return a, b, fa, fb, perms


def trained(name: str) -> dict:
    """The trained npz's variables of the sub-module ``name``."""
    tree = load_npz_tree(DEFAULT_WEIGHTS)
    return {"params": tree["params"][name], "batch_stats": tree["batch_stats"][name]}


def fixed_perms(module_fn):
    """``module_fn(...)`` with JAX's fusion draws replaced by the last two
    arguments, in turn (read when a jitted caller traces)."""
    def call(*args):
        draws = iter(args[-2:])
        saved = jfusion._random_perms
        jfusion._random_perms = lambda key, B, n: next(draws)
        try:
            return module_fn(*args[:-2])
        finally:
            jfusion._random_perms = saved
    return call


@pytest.fixture(scope="module")
def jax_features():
    """The trained fusion's variables and JAX ``PointsFusionWithFeatures``'
    eval forward, jitted with k static and the permutations given:
    ``fwd(v, a, b, fa, fb, t, k, p1, p2)``."""
    jmod = jfusion.PointsFusionWithFeatures((64, 64, 128))
    fwd = fixed_perms(lambda v, a, b, fa, fb, t, k: jmod.apply(
        v, a, b, fa, fb, k, t, rngs={"sample": jax.random.key(2)}))
    return trained("fusion"), jax.jit(fwd, static_argnums=6)


def port_features(v) -> PointsFusionWithFeatures:
    mod = PointsFusionWithFeatures()
    mod.load_state_dict(flax_to_state_dict(v))
    return mod.eval()


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("t", [0.2, 0.5])
@pytest.mark.parametrize("k", [8, 32])
def test_features_fusion_matches_jax(jax_features, k, t, C):
    """The port's ``PointsFusionWithFeatures`` on the CPU (the residual kNN,
    the payload gathered by its indices, the tail with ``extra``) against
    JAX's XLA route on the same weights and permutations: ``[1, N, 3 + C]``
    within 1e-5 (the xyz as ``PointsFusion``'s hold; the features are
    weighted means of values in [0, 1])."""
    v, fwd = jax_features
    a, b, fa, fb, perms = clouds(1501 + k + C, 256, C)
    tt = np.array([t], F32)
    want = np.asarray(fwd(v, *map(jnp.asarray, (a, b, fa, fb, tt)), k, *map(jnp.asarray, perms)))
    with torch.inference_mode():
        got = port_features(v)(T(a), T(b), T(fa), T(fb), k, T(tt),
                               perms=tuple(T(p) for p in perms)).numpy()
    assert got.shape == (1, 256, 3 + C)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def four_channel_pair(seed: int, N: int):
    """:func:`tests.test_torch_pointinet.pair`'s clouds with a seeded
    intensity channel in [0, 1]: ``[1, N, 4]`` each."""
    a, b = pair(seed, N)
    rng = np.random.default_rng(seed + 1)
    return tuple(np.concatenate([x, rng.random((1, N, 1)).astype(F32)], -1) for x in (a, b))


def test_pointinet_width4_matches_jax(monkeypatch):
    """PointINet on ``[1, 1024, 4]`` clouds, the trained weights in both
    packages (JAX's ``freeze_flow``, jitted), the same fusion permutations:
    the flow and warp on xyz, the intensity through the fusion's weights,
    the ``[1, N, 4]`` frames within the model tolerance of
    ``test_pointinet_matches_jax``.  The flow gets contiguous xyz clouds,
    as its kernels require on the card."""
    N = 1024
    a, b = four_channel_pair(1510, N)
    z = np.zeros((1, N, 3), F32)
    rng = np.random.default_rng(1511)
    p1, p2 = (rng.permutation(N)[None].astype(np.int32) for _ in range(2))
    tt = np.array([0.4], F32)
    v = load_npz_tree(DEFAULT_WEIGHTS)
    fwd = jax.jit(fixed_perms(lambda v, a, b, z, t: JPointINet(freeze_flow=True).apply(
        v, a, b, z, z, t, train=False, rngs={"sample": jax.random.key(5)})))
    want = fwd(v, *map(jnp.asarray, (a, b, z, tt, p1, p2)))
    model = PointINet()
    model.load_state_dict(flax_to_state_dict(v))
    clouds_in = []
    bidirectional = model.flow.bidirectional
    monkeypatch.setattr(model.flow, "bidirectional",
                        lambda *x: clouds_in.extend(x[:2]) or bidirectional(*x))
    with torch.inference_mode():
        got = model.eval()(*(T(x) for x in (a, b, z, z, tt)), perms=(T(p1), T(p2)))
    assert [c.shape[-1] for c in clouds_in] == [3, 3]
    assert all(c.is_contiguous() for c in clouds_in)
    assert got.shape == (1, N, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_width4_weights_are_the_xyz_weights():
    """JAX's PointINet initialised on a width-4 cloud has the variable tree
    (keys, shapes, dtypes) of the width-3 one: both fusion classes build
    ``fusion/PointMLP_0``.  The port's one model class takes the trained
    npz through ``convert`` unchanged (strict) and runs both widths."""
    def tree(width):
        z = jnp.zeros((1, 64, width))
        zf = jnp.zeros((1, 64, 3))
        shapes = jax.eval_shape(lambda: JPointINet(freeze_flow=True).init(
            {"params": jax.random.key(0), "sample": jax.random.key(1)}, z, z, zf, zf,
            jnp.asarray([0.5]), train=False))
        return {"/".join(str(getattr(k, "key", k)) for k in path): (x.shape, x.dtype)
                for path, x in jax.tree_util.tree_flatten_with_path(shapes)[0]}

    three, four = tree(3), tree(4)
    assert three == four
    with np.load(DEFAULT_WEIGHTS) as npz:
        assert sorted(npz.files) == sorted(four)
    model = PointINet()
    model.load_state_dict(flax_to_state_dict(load_npz_tree(DEFAULT_WEIGHTS)))
    assert isinstance(model.fusion, PointsFusion)
    assert all(k.startswith(("flow.", "fusion.mlp.")) for k in model.state_dict())


# ---- the CUDA routes on a stub library ------------------------------------------


def floats(ptr: int, shape) -> torch.Tensor:
    """A copy of the fp32 tensor at ``ptr`` (what a kernel reads)."""
    n = int(np.prod(shape))
    return T(np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr)).reshape(shape).copy())


def ints(ptr: int, shape) -> torch.Tensor:
    n = int(np.prod(shape))
    return T(np.ctypeslib.as_array((ctypes.c_int32 * n).from_address(ptr)).reshape(shape).copy())


@pytest.fixture
def cuda_route(monkeypatch):
    """CPU tensors routed as CUDA ones (the cells prep eager); returns a
    function that installs a stub library."""
    monkeypatch.setattr(_build, "use_kernel", lambda t: not _build._PLAIN.get())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(fusion_cells_cuda, "kernel_plan_graphed", fusion_cells_cuda.kernel_plan)

    def install(stub):
        monkeypatch.setattr(_build, "library", lambda: stub)
        return stub
    return install


def stub_inputs(seed: int = 1520, N: int = 256, C: int = 1):
    """Seeded clouds, features and permutations, and a port module with a
    seeded score MLP (non-trivial BatchNorm statistics)."""
    from pci_tpu_torch.serving import init_weights

    a, b, fa, fb, perms = clouds(seed, N, C)
    mod = PointsFusionWithFeatures()
    init_weights(mod, seed)
    with torch.no_grad():
        for name, buf in mod.named_buffers():
            buf += 0.01 * torch.arange(buf.numel(), dtype=buf.dtype).reshape(buf.shape)
    args = [T(x) for x in (a, b, fa, fb)]
    return mod.eval(), args, tuple(T(p) for p in perms)


def plain_rows(mod, args, k, tt, perms):
    with _build.plain_versions(), torch.inference_mode():
        return mod(*args, k, tt, perms=perms)


@pytest.mark.parametrize("route", ["flat", "cells"])
def test_oneshot_launch_carries_the_payload(cuda_route, monkeypatch, route):
    """Width 4 at k = 32 on the forced CUDA route at eval: the one-shot kernel
    (``pci_fusion``, or ``pci_fusion_cells`` with the cells gate patched
    down to 64 points) launches once, with a non-null payload pointer to the
    merged features, ``Cp = 1`` and a ``[B, N, 4]`` output; the rows equal
    the plain route's."""
    monkeypatch.setattr(tfusion, "_fusion_oneshot_ok", lambda train, x: not train)
    monkeypatch.setattr(tfusion, "_CELLS_FUSION_N", 64)
    monkeypatch.setattr(tfusion, "_cells_route_ok", lambda points, k, train, n_seg=2:
                        route == "cells" and points.shape[-2] >= tfusion._CELLS_FUSION_N)
    mod, args, perms = stub_inputs()
    layers = mod.mlp.folded()
    k, tt = 32, torch.tensor([0.3])
    B, N = 1, 256
    seen = {}

    def payload_case(x, s4, payload, Cp, out):
        seen.update(payload=payload, Cp=Cp)
        pay = floats(payload, (B, N, Cp))
        write(out, fusion_knn_cuda.fusion_plain(x, s4[:, :2], s4[:, 2:], layers, k, pay))

    def flat(pts, seg, wtc, h1, h2, h3, payload, Cp, out, B_, N_, stream):
        payload_case(floats(pts, (B, N, 3)), ints(seg, (B, 4)), payload, Cp, out)

    def cells(pts, keys, boxes, order, lbs, torder, seg, wtc, h1, h2, h3, payload, Cp, out,
              out_i, out_r, scanned, stamps, nxt, B_, N_, Np, C, TQ, k_, stream):
        assert out_i is None and out_r is None and k_ == k
        payload_case(floats(pts, (B, N, 3)), ints(seg, (B, 4)), payload, Cp, out)

    entry = "pci_fusion" if route == "flat" else "pci_fusion_cells"
    stub = cuda_route(StubLibrary(**{entry: flat if route == "flat" else cells}))
    before = (fusion_knn_cuda.fusion_kernel.launches, fusion_cells_cuda.fusion_cells_kernel.launches)
    with torch.inference_mode():
        got = mod(*args, k, tt, perms=perms)
    assert [n for n, _ in stub.calls] == [entry]
    assert seen["payload"] is not None and seen["payload"] != 0 and seen["Cp"] == 1
    after = (fusion_knn_cuda.fusion_kernel.launches, fusion_cells_cuda.fusion_cells_kernel.launches)
    assert [y - x for x, y in zip(before, after)] == ([1, 0] if route == "flat" else [0, 1])
    assert got.shape == (B, N, 4)
    torch.testing.assert_close(got, plain_rows(mod, args, k, tt, perms), atol=1e-6, rtol=1e-6)


def test_oneshot_off_runs_the_tail_with_the_payload(cuda_route, monkeypatch):
    """One-shot off at eval: the residual kNN (``pci_fusion_resi``), then
    the tail (``pci_fusion_tail``) with ``extra`` = the features gathered by
    the kNN's indices, ``Ce = 1``; the rows equal the plain route's."""
    monkeypatch.setattr(tfusion, "_fusion_oneshot_ok", lambda train, x: False)
    mod, args, perms = stub_inputs(1521)
    layers = mod.mlp.folded()
    k, tt = 32, torch.tensor([0.6])
    seen = {}

    def resi(pts, ends, buds, F, oi, orr, B, N, k_, parts, stamps, stream):
        x = floats(pts, (B, N, 3))
        i, r = fusion_knn_cuda.fusion_resi_plain(x, ints(ends, (B, F)), ints(buds, (B, F)), k_)
        seen["resi"] = (x, r)
        write(oi, i)
        write(orr, r)

    def tail(comb, res, extra, wbuf, h1, h2, h3, out, B, N, k_, Ce, stream):
        assert extra and Ce == 1 and k_ == k
        x, r = seen["resi"]
        write(out, fusion_tail_plain(x, r, floats(extra, (B, N, k_, Ce)), layers))

    stub = cuda_route(StubLibrary(pci_fusion_resi=resi, pci_fusion_tail=tail))
    with torch.inference_mode():
        got = mod(*args, k, tt, perms=perms)
    assert [n for n, _ in stub.calls] == ["pci_fusion_resi", "pci_fusion_tail"]
    assert got.shape == (1, 256, 4)
    torch.testing.assert_close(got, plain_rows(mod, args, k, tt, perms), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("k, C", [(160, 1), (32, fusion_knn_cuda.MAX_PAYLOAD + 1)])
@pytest.mark.parametrize("oneshot", [True, False])
def test_past_the_kernels_shapes_launches_nothing(cuda_route, monkeypatch, k, C, oneshot):
    """k = 160 (past the flat fusion kernels' k <= 128), or a payload of
    MAX_PAYLOAD + 1 channels, on the forced CUDA route at eval (either
    one-shot gate): no one-shot and no residual kNN launch (the kNN's plain
    version by the explicit route); at k = 160 the attention tail, which
    takes any k, launches once with ``Ce = 1`` (its stub writes the plain
    version's rows), and with the wide payload nothing launches (the stub
    fails any); the rows of the plain route; the one-shot wrapper itself
    refuses the wide payload."""
    monkeypatch.setattr(tfusion, "_fusion_oneshot_ok", lambda train, x: oneshot and not train)
    mod, args, perms = stub_inputs(1522, C=C)
    tt = torch.tensor([0.3])

    def tail(comb, res, extra, wbuf, h1, h2, h3, out, B, N, k_, Ce, stream):
        assert extra and (Ce, k_) == (C, k)
        write(out, fusion_tail_plain(floats(comb, (B, N, 3)), floats(res, (B, N, k_, 3)),
                                     floats(extra, (B, N, k_, Ce)), mod.mlp.folded()))

    stub = cuda_route(StubLibrary(pci_fusion_tail=tail))
    with torch.inference_mode():
        got = mod(*args, k, tt, perms=perms)
    assert [n for n, _ in stub.calls] == (["pci_fusion_tail"] if k > 128 else [])
    assert got.shape == (1, 256, 3 + C)
    torch.testing.assert_close(got, plain_rows(mod, args, k, tt, perms), atol=0, rtol=0)
    if C > fusion_knn_cuda.MAX_PAYLOAD:
        x = args[0]
        with torch.inference_mode(), pytest.raises(ValueError, match="payload"):
            fusion_knn_cuda.knn_fusion_attention(x, torch.tensor([[128, 256]]),
                                                 torch.tensor([[16, 16]]), mod.mlp.folded(),
                                                 32, payload=args[2])
