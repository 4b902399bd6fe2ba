"""ISAPCInet's published width variants against the JAX package on CPU,
and their attention routes.

The reference ships ISAPCInet as width variants (SURVEY.md):
``New_Models0_noT_96.py`` drops Tnet and runs ff/tr = 96,
``New_Models_field_{0,1}.py`` run 128.  Here, at small widths:

- ``ISAPCInet(field=2, use_tnet=False)`` and ``ISAPCInet(field=1)`` on
  injected flows and permutations against the JAX model, loaded through
  ``convert.load_subtrees`` from the JAX init (one jitted init and apply a
  configuration, shared between the xdist workers); a JAX tree with Tnet
  is refused by the Tnet-less model, not dropped;
- ``cli.test --field 2 --use_tnet 0`` on a tiny synthetic scene beside
  the JAX CLI, on the same weights and fusion permutations: each window's
  CD within 1e-3 relative (tests/test_torch_cli.py's tolerance);
- on a stub kernel library (tests/test_torch_kernel_routes.py), the
  routes at d = 96 and 128: eval passes the block-wide kernel's unchained
  split pack (``wtc``) to ``pci_attention``; training launches
  ``pci_attention`` and ``pci_attention_bwd``, and its rows and gradients
  equal the plain route's.

Tolerances: 1e-3 for the whole model, as tests/test_torch_isapci.py; the
fusion's rows whose neighbour set is a tie (``near_tied``) are left out of
its comparison and counted; the stub routes equal the plain route exactly.
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pci_tpu.nn.fusion as jfusion
import pci_tpu_torch.nn.fusion as tfusion
from pci_tpu.cli import test as jtest_cli
from pci_tpu.models import ISAPCInet as JISAPCInet
from pci_tpu.models.flownet3d import FlowNet3D as JFlowNet3D
from pci_tpu_torch import nn as tnn
from pci_tpu_torch.cli import test as test_cli
from pci_tpu_torch.convert import load_subtrees
from pci_tpu_torch.models import ISAPCInet
from pci_tpu_torch.ops.cuda_kernels import _build, attention_cuda
from tests.test_cli import make_scene
from tests.test_torch_cli import fixed_perms, records, save_npz_tree, window_args
from tests.test_torch_isapci import as_np, shifted, window
from tests.test_torch_kernel_routes import StubLibrary, knn_stub, read, write
from tests.test_torch_shared import shared_result

torch.set_num_threads(2)

MODEL_TOL = dict(atol=1e-3, rtol=1e-3)
J, T = jnp.asarray, torch.from_numpy
# (field, N, ff_out_c = tr_out_c, use_tnet): noT_96 and field 1 at 128,
# each at a quarter of its width; the flow cloud holds sa1's 1,024 points
CONFIGS = {"noT": (2, 256, 24, False), "field1": (1, 512, 32, True)}


def jax_variant(name):
    """The JAX model on given flows and fusion permutations: (inputs, flows,
    perms, variables, the Outputer's two flows, output)."""
    field, N, width, use_tnet = CONFIGS[name]
    fwd, keys, bwd = window(450 + field, field, N)
    rng = np.random.default_rng(460 + field)
    flows = [(0.1 * rng.standard_normal((1, N, 3))).astype(np.float32)
             for _ in range(4 * field)]
    perms = [rng.permutation(N)[None].astype(np.int32) for _ in range(2)]
    t = np.array([0.3], np.float32)
    z = np.zeros_like(keys[0])
    model = JISAPCInet(field=field, ff_out_c=width, tr_out_c=width, use_tnet=use_tnet)
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
    # the fusion alone on the warped clouds the test gives the port: a
    # warp rounded apart from the jitted model's can swap a near-tied
    # neighbour (tests/test_torch_isapci.py)
    tb = t[:, None, None]
    warped = [J(keys[0] + nets[0] * tb), J(keys[1] + nets[1] * (1.0 - tb))]
    fv = {col: tree["fusion"] for col, tree in v.items() if "fusion" in tree}
    with pytest.MonkeyPatch.context() as mp:
        draws = iter(perms)
        mp.setattr(jfusion, "_random_perms", lambda key, B, n: J(next(draws)))
        fused = jax.jit(lambda fv, a, b: jfusion.PointsFusion((64, 64, 128)).apply(
            fv, a, b, 32, J(t), train=False, rngs={"sample": jax.random.key(2)}))(fv, *warped)
    return (fwd, keys, bwd, t, z), flows, perms, as_np(v), nets, np.asarray(fused)


@pytest.fixture(scope="module", params=list(CONFIGS))
def variant(request, tmp_path_factory):
    return request.param, shared_result(f"variant_{request.param}",
                                        lambda: jax_variant(request.param), tmp_path_factory)


def test_variant_matches_jax(variant):
    """The Outputer's flows against the JAX model's on the same flows
    (Tnet-weighted or, without Tnet, the raw flows into PointNet++; the
    transformer over the flow cloud at the variant's width), then the fusion
    against JAX's on the warped clouds of the JAX model's flows, on the rows
    whose neighbour sets are not ties (``near_tied``, at most 1%)."""
    name, ((fwd, keys, bwd, t, z), flows, perms, v, want_nets, want) = variant
    field, _, width, use_tnet = CONFIGS[name]
    model = ISAPCInet(field, ff_out_c=width, tr_out_c=width, use_tnet=use_tnet)
    tnet = ["tnet_backward", "tnet_forward"] if use_tnet else []
    assert load_subtrees(model, v) == sorted(
        ["ffab", "flow_tr_backward", "flow_tr_forward", "fusion", "outputer", *tnet])
    assert hasattr(model, "tnet_forward") == use_tnet
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
    tied = near_tied(T(warped[0]), T(warped[1]), 32, T(t), perms_t)
    assert int(tied.sum()) <= 0.01 * tied.numel()
    np.testing.assert_allclose(got.numpy()[0, ~tied], want[0, ~tied], **MODEL_TOL)


def near_tied(a, b, k, t, perms, rel: float = 1e-6):
    """``[N]`` bool: the fusion's rows whose budget-th and next nearest key
    in either segment of the combined cloud lie within ``rel`` of each
    other, where JAX's distance (its XLA kNN) and the port's op-by-op one
    can order them apart: such a row's neighbour set is a tie, not a
    result (a 1-ulp tie moved one of 512 rows by 0.08 m here)."""
    N = a.shape[1]
    N1, N2, k1, k2 = tfusion._adaptive_budgets(N, k, t)
    combined, _ = tfusion._composed_shuffle_merge([a, b], list(perms),
                                                  torch.stack([N1, N2], dim=1))
    c, n1 = combined[0], int(N1[0])
    tied = torch.zeros(N, dtype=torch.bool)
    for lo, hi, kb in ((0, n1, int(k1[0])), (n1, N, int(k2[0]))):
        if 0 < kb < hi - lo:
            d = torch.sort(((c[:, None, :] - c[None, lo:hi, :]) ** 2).sum(-1), dim=1).values
            tied |= d[:, kb] - d[:, kb - 1] <= rel * d[:, kb]
    return tied


def test_tnet_weights_are_refused_without_tnet(variant):
    """A JAX tree with Tnet does not load into an ISAPCInet built without
    it (its Tnet would be dropped), and one without Tnet does not fill a
    model that has one."""
    name, (_, _, _, v, _, _) = variant
    field, _, width, use_tnet = CONFIGS[name]
    other = ISAPCInet(field, ff_out_c=width, tr_out_c=width, use_tnet=not use_tnet)
    if use_tnet:  # the tree has tnet_*: the Tnet-less model refuses them
        with pytest.raises(KeyError, match="does not have.*tnet"):
            load_subtrees(other, v)
    else:  # every sub-tree loads, the model's own Tnet keeps its init
        before = {k: p.clone() for k, p in other.state_dict().items() if k.startswith("tnet_")}
        assert "tnet_forward" not in load_subtrees(other, v)
        for k, p in before.items():
            assert torch.equal(other.state_dict()[k], p), k


# ---- cli.test --use_tnet 0 ------------------------------------------------------

NOT_FLAGS = ["--field", "2", "--use_tnet", "0", "--ff_out_c", "24", "--tr_out_c", "24"]


def run_not_cli(tmp_path_factory):
    """The JAX CLI, then the port's on the JAX CLI's init exported to npz:
    (port records, JAX records)."""
    scene = tmp_path_factory.mktemp("not_scene")
    make_scene(scene, n_frames=16)  # two windows at field 2, interval 3
    recorded = {}

    def build_and_record(args, example):
        model, variables = build_isapci(args, example)
        recorded["v"] = variables
        return model, variables

    build_isapci = jtest_cli.build_isapci
    with pytest.MonkeyPatch.context() as mp:
        fixed_perms(mp)
        mp.setattr(jtest_cli, "build_isapci", build_and_record)
        jlog = tmp_path_factory.mktemp("not_jax")
        jtest_cli.main(window_args(scene, NOT_FLAGS + ["--log_dir", str(jlog)]))
        assert not any(k.startswith("tnet_") for k in recorded["v"]["params"])
        npz = save_npz_tree(recorded["v"], jlog / "init.npz")
        log = tmp_path_factory.mktemp("not_port")
        test_cli.main(window_args(scene, NOT_FLAGS + ["--pretrained_self_model", npz,
                                                      "--log_dir", str(log)]), device="cpu")
    return records(log), records(jlog)


def test_cli_without_tnet_matches_the_jax_cli(tmp_path_factory):
    """``cli.test --field 2 --use_tnet 0``: the JAX CLI's windows, each CD
    within 1e-3 relative of its own, same times, finite."""
    port, want = shared_result("not_cli", lambda: run_not_cli(tmp_path_factory),
                               tmp_path_factory)
    assert len(port) == len(want) == 2
    for r, w in zip(port, want, strict=True):
        assert r.keys() == w.keys() and r["t"] == w["t"] and np.isfinite(r["cd"])
        assert r["cd"] == pytest.approx(w["cd"], rel=1e-3)


# ---- the attention routes at d = 96 and 128, on a stub library -----------------


def attention_stub(tail, seen):
    """``pci_attention`` by the plain version on the arrays it is given,
    recording whether it got the split pack (``wtc``) or the fp32 one."""
    def run(qp, gp, dp, wbuf, wtc, out, stamps, M, d, k, stream):
        assert stamps is None and (wbuf is None) == (wtc is not None)
        n = 17 * d + 3 * (2 * d * d + d)  # the split pack's floats (_build.pack_tf32)
        seen.append(("wtc", read(wtc, (n,)), M, d, k) if wtc is not None else ("wbuf",))
        q, g, delta = read(qp, (1, M, d)), read(gp, (1, M, k, 2 * d)), read(dp, (1, M, k, 3))
        write(out, attention_cuda.attention_plain(q, g, delta, tail))
    return run


def attention_bwd_stub(tail):
    """``pci_attention_bwd`` by the plain backward, its weight gradients
    written in wbuf's layout (``W.T`` then ``b`` a layer)."""
    def run(qp, gp, dp, wbuf, gop, dq, dg, dd, partial, dw, stamps, M, d, k, blocks, stream):
        q, g, delta = read(qp, (1, M, d)), read(gp, (1, M, k, 2 * d)), read(dp, (1, M, k, 3))
        grads = attention_cuda.attention_bwd_plain(q, g, delta, tail, read(gop, (1, M, d)))
        for ptr, t in zip((dq, dg, dd), grads[:3]):
            write(ptr, t)
        write(dw, torch.cat([t for w, b in zip(grads[3::2], grads[4::2])
                             for t in (w.t().reshape(-1), b)]))
    return run


def _layer_inputs(seed: int, n: int = 200):
    rng = np.random.default_rng(seed)
    return [T(rng.standard_normal((1, n, c)).astype(np.float32)) for c in (3, 64, 64)]


@pytest.mark.parametrize("d", [96, 128])
def test_transformer_eval_at_the_variants_widths_takes_the_wide_kernel(monkeypatch, d):
    """Eval ``TransformerLayer(64, d, 16)``: one kNN and one
    ``pci_attention`` launch with the unchained split pack (the block-wide
    tensor-core route), no fp32 pack; the rows equal the plain route's."""
    monkeypatch.setattr(_build, "use_kernel", lambda t: not _build._PLAIN.get())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    torch.manual_seed(820 + d)
    layer = tnn.TransformerLayer(64, d, 16).eval()
    xyz, feats, _ = _layer_inputs(821 + d)
    tail = [(m.weight.detach(), m.bias.detach()) for m in (
        layer.fc_delta_0, layer.fc_delta_1, layer.fc_gamma_0, layer.fc_gamma_1)]
    seen = []
    stub = StubLibrary(pci_knn=knn_stub, pci_attention=attention_stub(tail, seen))
    monkeypatch.setattr(_build, "library", lambda: stub)
    assert attention_cuda.tc_route_ok(d, 16) and attention_cuda.bwd_route_ok(d, 16)
    with torch.inference_mode():
        got, _ = layer(xyz, feats)
        with _build.plain_versions():
            want, _ = layer(xyz, feats)
    assert [n for n, _ in stub.calls] == ["pci_knn", "pci_attention"]
    (kind, wtc, M, dd, k), = seen
    assert (kind, M, dd, k) == ("wtc", 200, d, 16)
    pack = _build.pack_tf32(tail, torch.device("cpu"), chain=False)
    torch.testing.assert_close(wtc, pack, atol=0, rtol=0)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("d", [96, 128])
def test_transformer_training_at_the_variants_widths_launches_both_kernels(monkeypatch, d):
    """Training ``TransformerLayer(64, d, 16)``: the trainable route takes
    both kernels at d = 96 and 128 (one ``pci_attention``, one
    ``pci_attention_bwd``), and the rows and every gradient equal the plain
    route's."""
    monkeypatch.setattr(_build, "use_kernel", lambda t: not _build._PLAIN.get())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(attention_cuda, "_sm_count", lambda dev: 4)
    torch.manual_seed(830 + d)
    base = tnn.TransformerLayer(64, d, 16).train()
    xyz, feats, G = _layer_inputs(831 + d)
    outs, calls = [], []
    for plain in (False, True):
        layer = copy.deepcopy(base)
        tail = [(m.weight.detach(), m.bias.detach()) for m in (
            layer.fc_delta_0, layer.fc_delta_1, layer.fc_gamma_0, layer.fc_gamma_1)]
        stub = StubLibrary(pci_knn=knn_stub, pci_attention=attention_stub(tail, []),
                           pci_attention_bwd=attention_bwd_stub(tail))
        monkeypatch.setattr(_build, "library", lambda: stub)
        f = feats.clone().requires_grad_()
        with _build.plain_versions() if plain else contextlib.nullcontext():
            out, _ = layer(xyz, f)
            (out * G).sum().backward()
        calls.append([n for n, _ in stub.calls])
        outs.append([out.detach(), f.grad] + [p.grad for p in layer.parameters()])
    assert calls == [["pci_knn", "pci_attention", "pci_attention_bwd"], []]
    for got, want in zip(*outs, strict=True):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
