"""The vector-attention tail's tensor-core kernels (kernel rows 11 and 11b:
``csrc/attention.cu``'s ``attention_tc_kernel``, ``csrc/attention_bwd.cu``)
held on the CPU through their host packing and their dataflow:

- the weights as each kernel reads them: the forward's chained split
  pack (``attention_cuda.pack_tail_tc``) decoded through
  ``csrc/mma_tf32.cuh``'s fragment layout, and the backward's fp32 copy in
  shared memory (``[d8][ld]``, zero-padded) read through its B-fragment
  addressing as ``W^T`` (the forward's products) and as ``W`` (the input
  gradients' ``dx = dy W``) and split in the kernel's way, each multiplied
  in 3xTF32 against the plain products ``X @ W.T`` and ``X @ W`` in fp64,
  at d = 64 and at the ragged d = 24;
- a torch emulation of each kernel's dataflow from those weights: the
  forward's per-query 16-row tile (rows past k masked, columns padded to
  a multiple of 8, the softmax a max and a sum over the tile's rows), and
  the backward's 64-row tiles of 64 / k queries (the last tile's missing
  queries zero, the ReLU masks kept in place, each tile's weight-gradient
  sum ``X^T D`` in 3xTF32 added to its block's partial in tile order, the
  blocks' partials summed in order), held against the port's plain
  versions and against the JAX package's ``vector_attention_trainable`` in
  interpret mode (its forward and ``jax.vjp``), at the shapes and
  tolerances of ``tests/test_torch_train.py``'s backward test (B = 1,
  N = 300, k = 4, d = 16; rtol 2e-4, atol 2e-5), at the transformer's
  k = 16, d = 64 (N = 256), and at k = 7, d = 24.

JAX's references run once a test run, in a process of their own
(:func:`jax_references`).  In two runs of the suite under six workers one
comparison here missed by far more than any rounding of these
well-conditioned inputs (ROADMAP C.7): the ``ragged`` forward emulation
against ``attention_plain`` (6.4e-5 at 23 of 2,328 outputs), then the
``train_test`` backward emulation's ``delta`` gradient against
``attention_bwd_plain`` (8.2e-5 at 33 of 3,600).  The cause is not
confirmed, so every emulation test checks its inputs against a fresh draw
of its seed before and after each call (:func:`assert_inputs_unchanged`),
records the worker's numeric state as it starts (:func:`numeric_state`),
and on a miss reports the elements that differ, that state, and which
side moved: the case is recomputed from its seed in a fresh process
(:func:`clean_outputs`) and each side is held against that clean run
(:func:`assert_close`).

The card runs the same products in its mma instructions; chip_smoke.py
holds the kernels against the plain versions there."""

from __future__ import annotations

import hashlib
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pci_tpu.ops.pallas_kernels.attention_tpu import vector_attention_trainable
from pci_tpu_torch.ops.cuda_kernels import _build
from pci_tpu_torch.ops.cuda_kernels import attention_cuda as ac
from tests.test_torch_shared import shared_result
from tests.test_torch_tf32 import _decode

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
ROWS = 64  # csrc/attention_bwd.cu PCI_ABWD_ROWS
# (B, N, k, d, weight scale, seed)
CASES = {"train_test": (1, 300, 4, 16, 0.4, 611), "transformer": (1, 256, 16, 64, 0.125, 612),
         "ragged": (1, 97, 7, 24, 0.2, 613)}


def _inputs(B, N, k, d, sc, seed):
    """Seeded numpy inputs: q, g, delta, the four layers in flax's [in, out]
    layout with their biases, the output gradient."""
    rng = np.random.default_rng(seed)
    mk = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    q, g, delta = mk(B, N, d), mk(B, N, k, 2 * d), mk(B, N, k, 3)
    ws = [mk(3, d, scale=0.4), mk(d, d, scale=sc), mk(d, d, scale=sc), mk(d, d, scale=sc)]
    bs = [mk(d, scale=0.1) for _ in range(4)]
    return q, g, delta, ws, bs, mk(B, N, d)


def _tail(ws, bs):
    """The port's tail: nn.Linear's [out, in] weights."""
    return [(torch.from_numpy(w.T.copy()), torch.from_numpy(b)) for w, b in zip(ws, bs)]


def jax_reference(name: str):
    """JAX's ``vector_attention_trainable`` (interpret mode, the forward
    and ``jax.vjp`` in one jit) on ``CASES[name]``'s inputs: its forward and
    its 11 gradients (weights in nn.Linear's ``[out, in]``), as numpy arrays
    of their own."""
    B, N, k, d, sc, seed = CASES[name]
    q, g, delta, ws, bs, cot = _inputs(B, N, k, d, sc, seed)
    flat = [a for wb in zip(ws, bs) for a in wb]
    f = lambda *a: vector_attention_trainable(*a, True)  # noqa: E731

    def forward_and_vjp(cot, *args):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(cot)

    out, grads = jax.jit(forward_and_vjp)(*(jnp.array(x) for x in (cot, q, g, delta, *flat)))
    grads = [np.array(x) for x in grads]
    grads[3::2] = [x.T.copy() for x in grads[3::2]]  # flax [in, out] -> nn.Linear [out, in]
    return np.array(out), grads


def jax_references(path) -> dict:
    """:func:`jax_reference` of every case, computed in a process of its own
    (JAX on the CPU, no persistent compilation cache) and read back from
    ``path``: no XLA computation runs in the process that holds the torch
    tensors, and no buffer is shared between the two packages (ROADMAP
    C.7)."""
    code = ("import pickle, sys, jax; jax.config.update('jax_platforms', 'cpu'); "
            "from tests.test_torch_attention_tc import CASES, jax_reference; "
            "pickle.dump({n: jax_reference(n) for n in sorted(CASES)}, open(sys.argv[1], 'wb'))")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_", "PYTEST"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code, str(path)], cwd=ROOT, env=env, check=True,
                   timeout=600, capture_output=True)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """Every case's JAX forward and gradients, once a test run."""
    return shared_result("attention_tc_jax", lambda: jax_references(
        tmp_path_factory.mktemp("attention_tc") / "refs.pkl"), tmp_path_factory)


def case_args(name: str):
    """``CASES[name]``'s torch inputs: (q, g, delta, tail, output gradient)."""
    q, g, delta, ws, bs, cot = _inputs(*CASES[name])
    T = torch.from_numpy
    return T(q), T(g), T(delta), _tail(ws, bs), T(cot)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, jax_refs):
    """(torch inputs, JAX's forward and its 11 gradients) for one case."""
    out, grads = jax_refs[request.param]
    return case_args(request.param), out, grads


def numeric_state() -> dict:
    """The process's torch settings that a CPU product's numbers can depend
    on, and whether a denormal survives a multiply (flush-to-zero)."""
    tiny = torch.tensor([1e-39], dtype=torch.float32)
    return {"threads": torch.get_num_threads(),
            "matmul_precision": torch.get_float32_matmul_precision(),
            "mkldnn": torch.backends.mkldnn.enabled,
            "deterministic": torch.are_deterministic_algorithms_enabled(),
            "default_dtype": str(torch.get_default_dtype()),
            "denormal_survives": bool((tiny * 3.0).item() != 0.0)}


@pytest.fixture(autouse=True)
def worker_state() -> dict:
    """:func:`numeric_state` as each test of the module starts (ROADMAP C.7)."""
    return numeric_state()


def clean_outputs(name: str, kind: str) -> dict:
    """Both sides of one comparison on ``CASES[name]``, recomputed from the
    seed in a fresh process at this process's thread count (torch only, no
    JAX call): ``kind`` "forward"
    (emulation, plain), "backward" (the 3-block emulation, plain) or
    "blocks" (the emulation at 1 and 5 blocks).  Returns ``{side: [numpy
    arrays]}`` and that process's :func:`numeric_state`."""
    code = ("import pickle, sys, torch; torch.set_num_threads(int(sys.argv[3])); "
            "from tests.test_torch_attention_tc import sides; "
            "pickle.dump(sides(sys.argv[1], sys.argv[2], numpy=True), sys.stdout.buffer)")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_", "PYTEST"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    run = subprocess.run([sys.executable, "-c", code, name, kind, str(torch.get_num_threads())],
                         cwd=ROOT, env=env,
                         check=True, timeout=600, capture_output=True)
    return pickle.loads(run.stdout)


def sides(name: str, kind: str, numpy: bool = False) -> dict:
    """The two sides :func:`clean_outputs` names, computed here on
    :func:`case_args`."""
    args = case_args(name)
    if kind == "forward":
        out = {"emulation": [emulate_forward(*args[:4])], "plain": [ac.attention_plain(*args[:4])]}
    elif kind == "backward":
        out = {"emulation": list(emulate_backward(*args, blocks=3)),
               "plain": list(ac.attention_bwd_plain(*args))}
    else:
        out = {"one": list(emulate_backward(*args, blocks=1)),
               "five": list(emulate_backward(*args, blocks=5))}
    if numpy:
        out = {k: [t.numpy() for t in v] for k, v in out.items()}
        out["state"] = numeric_state()
    return out


def miss_report(name: str, kind: str, label: str, index: int, held: dict, bad,
                state: dict) -> str:
    """What a tolerance miss of output ``index`` (``label``) shows: the
    elements that differ (at most 12), the worker's numeric state as the
    test started and now, and for each side the largest difference of its
    output here from a clean recomputation in a fresh process."""
    where = np.argwhere(bad)
    a, b = held.values()
    rows = "; ".join(f"{tuple(int(i) for i in at)}: {a[tuple(at)]!r} vs {b[tuple(at)]!r}"
                     for at in where[:12])
    lines = [f"{label}: {len(where)} elements differ, at {rows}",
             f"worker state at the start {state}, now {numeric_state()}"]
    try:
        clean = clean_outputs(name, kind)
    except (subprocess.SubprocessError, OSError) as e:  # the report, not the verdict
        lines.append(f"no clean recomputation: {e!r}")
        return "\n".join(lines)
    for side, out in held.items():
        moved = np.abs(out - clean[side][index])
        lines.append(f"{side} here vs a clean process: max |diff| {moved.max():.3g} at "
                     f"{int((moved > 0).sum())} elements")
    lines.append(f"clean process state {clean['state']}")
    return "\n".join(lines)


def assert_close(name: str, kind: str, label: str, index: int, held: dict, state: dict,
                 rtol: float = 2e-4, atol: float = 2e-5) -> None:
    """``np.testing.assert_allclose`` of the two sides in ``held`` ({side:
    array}, actual first), whose message on a miss is :func:`miss_report`'s."""
    a, b = held.values()
    bad = ~(np.abs(a - b) <= atol + rtol * np.abs(b))
    msg = miss_report(name, kind, label, index, held, bad, state) if bad.any() else label
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=msg)


def _product(x, hi, lo):
    """``x @ (hi + lo)`` in 3xTF32 as csrc/mma_tf32.cuh sums it: x split in
    the kernel's way, the large product, then the two small ones apart."""
    xhi, xlo = _build.tf32_split(x)
    return xhi @ torch.from_numpy(hi) + (xhi @ torch.from_numpy(lo) + xlo @ torch.from_numpy(hi))


def _layer(x, dec, relu=False):
    """One decoded layer ``(hi, lo, bias)`` over rows ``x [..., K8]``."""
    hi, lo, b = dec
    y = _product(x, hi, lo) + torch.from_numpy(b)
    return torch.relu(y) if relu else y


def _pad(x, width):
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def bwd_weights(tail, d):
    """csrc/attention_bwd.cu's weights as its tile_mma reads them: W^T
    ([in][out]) of fc_delta_1, fc_gamma_0 and fc_gamma_1 copied from the fp32
    buffer (``pack_tail``) into ``[d8][ld]`` (ld = round_up(d, 16) + 4, zero
    past d), then each B fragment gathered through the kernel's strides
    (``trans``: B = W, element (k, n) at ``Wt[n][k]``) for every k-step,
    n-tile and lane, and split: returns ``{(layer, trans): (hi, lo, zero
    bias)}`` as ``[d8, d8]`` matrices."""
    d8, ld = -(-d // 8) * 8, -(-d // 16) * 16 + 4
    buf = ac.pack_tail(tail, CPU)
    offs = (3 * d + d, 3 * d + d + d * d + d, 3 * d + d + 2 * (d * d + d))
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    out = {}
    for layer, off in enumerate(offs):
        ws = torch.zeros(d8 * ld)
        ws.view(d8, ld)[:d, :d] = buf[off:off + d * d].view(d, d)
        for trans in (False, True):
            ks, ns = (1, ld) if trans else (ld, 1)
            b = torch.full((d8, d8), float("nan"))
            for kt in range(d8 // 8):
                for nt in range(d8 // 8):
                    base = (8 * kt + t) * ks + (8 * nt + g) * ns
                    b[8 * kt + t, 8 * nt + g] = ws[base]
                    b[8 * kt + t + 4, 8 * nt + g] = ws[base + 4 * ks]
            hi, lo = _build.tf32_split(b)
            out[layer, trans] = (hi.numpy(), lo.numpy(), np.zeros(d8, np.float32))
    return out


# ---- the packs --------------------------------------------------------------


@pytest.mark.parametrize("d", [64, 24])
def test_packs_match_plain_products(d):
    """Each layer of the forward's chained pack decoded and multiplied in
    3xTF32 gives ``X @ W.T + b``; each d -> d layer of the backward's
    shared-memory copy, read through its B-fragment strides, gives ``X @
    W.T`` and, transposed, ``X @ W``: within 2e-6 of the fp64 products'
    largest magnitude, with the padding columns exactly 0."""
    rng = np.random.default_rng(d)
    B, N, k = 1, 8, 4
    _, _, _, ws, bs, _ = _inputs(B, N, k, d, 1.0 / math.sqrt(d), d)
    tail = _tail(ws, bs)
    d8 = -(-d // 8) * 8
    x = torch.from_numpy(rng.standard_normal((40, d8)).astype(np.float32))
    x[:, d:] = 0.0
    fwd, used = _decode(ac.pack_tail_tc(tail, CPU), [3, d, d, d, d], chain=True)
    assert used == ac.pack_tail_tc(tail, CPU).numel()
    x3 = _pad(x[:, :3], 8)
    for i, ((w, b), dec) in enumerate(zip(tail, fwd)):
        xi = x3 if i == 0 else x
        want = xi[:, :w.shape[1]].double() @ w.double().t() + b.double()
        got = _layer(xi, dec)
        assert (got[:, d:] == 0).all()
        top = want.abs().max().item()
        assert (got[:, :d].double() - want).abs().max().item() <= 2e-6 * top, i
    bwd = bwd_weights(tail, d)
    for layer, (w, _) in enumerate(tail[1:]):
        for trans in (False, True):
            # forward: X @ W.T; the input gradients: dx = dy @ W (W [out, in])
            want = x[:, :d].double() @ (w.double() if trans else w.double().t())
            got = _layer(x, bwd[layer, trans])
            assert (got[:, d:] == 0).all()
            top = want.abs().max().item()
            assert (got[:, :d].double() - want).abs().max().item() <= 2e-6 * top, (layer, trans)


# ---- the forward's dataflow ---------------------------------------------------


def emulate_forward(q, g, delta, tail):
    """attention_tc_kernel's dataflow: a query's k <= 16 slots as one 16-row
    tile (rows >= k zero and masked out of the softmax), columns padded to
    d8, the four layers from the chained pack, h = (q - K) + pos, V + pos,
    the softmax per column over the tile's rows."""
    B, N, d = q.shape
    k, M, d8 = g.shape[2], B * N, -(-d // 8) * 8
    L, _ = _decode(ac.pack_tail_tc(tail, CPU), [3, d, d, d, d], chain=True)

    def rows(x):  # [M, k, c] -> the query's 16-row tile, zero past k and c
        out = torch.zeros(M, 16, d8)
        out[:, :k, :x.shape[-1]] = x.reshape(M, k, -1)
        return out

    dl = torch.zeros(M, 16, 8)
    dl[:, :k, :3] = delta.reshape(M, k, 3)
    pos = _layer(_layer(dl, L[0], relu=True), L[1])
    h = (_pad(q.reshape(M, 1, d), d8) - rows(g[..., :d])) + pos
    vp = rows(g[..., d:]) + pos
    a = _layer(_layer(h, L[2], relu=True), L[3])
    x = a * (1.0 / math.sqrt(d))
    x[:, k:] = -math.inf
    e = torch.exp(x - x.amax(1, keepdim=True))
    return ((e * vp).sum(1) / e.sum(1))[:, :d].reshape(B, N, d)


def digest(*arrays) -> str:
    """One sha256 over the bytes of numpy arrays."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def assert_inputs_unchanged(name: str, args, jax_arrays, jax_sum: str, stage: str) -> None:
    """The case's torch inputs equal to a fresh :func:`_inputs` of its seed,
    and JAX's results to their :func:`digest` ``jax_sum``: a run whose
    inputs changed under the test reports that, not a tolerance miss
    (ROADMAP C.7)."""
    q, g, delta, ws, bs, cot = _inputs(*CASES[name])
    fresh = [torch.from_numpy(x) for x in (q, g, delta)]
    fresh += [t for wb in _tail(ws, bs) for t in wb] + [torch.from_numpy(cot)]
    held = [*args[:3], *[t for wb in args[3] for t in wb], args[4]]
    labels = "q g delta wd0 bd0 wd1 bd1 wg0 bg0 wg1 bg1 cot".split()
    changed = [n for n, a, b in zip(labels, held, fresh) if not torch.equal(a, b)]
    assert not changed, f"{stage}: the case's torch inputs {changed} changed"
    assert digest(*jax_arrays) == jax_sum, f"{stage}: JAX's results changed"


def test_forward_emulation_matches_plain_and_jax(case, request, worker_state):
    args, jax_out, _ = case
    name, (q, g, delta, tail, _) = request.node.callspec.params["case"], args
    jax_sum = digest(jax_out)
    assert_inputs_unchanged(name, args, [jax_out], jax_sum, "before the emulation")
    got = emulate_forward(q, g, delta, tail)
    assert_inputs_unchanged(name, args, [jax_out], jax_sum, "after the emulation")
    plain = ac.attention_plain(q, g, delta, tail)
    assert_inputs_unchanged(name, args, [jax_out], jax_sum, "after the plain version")
    assert_close(name, "forward", "out", 0, {"emulation": got.numpy(), "plain": plain.numpy()},
                 worker_state)
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=2e-4, atol=2e-5)


# ---- the backward's dataflow --------------------------------------------------


def _wgrad(x, dd):
    """``X^T D`` over a tile's rows in 3xTF32 (tile_wgrad_mma): both
    operands split, the large product, then the small ones."""
    xhi, xlo = _build.tf32_split(x)
    dhi, dlo = _build.tf32_split(dd)
    return xhi.t() @ dhi + (xhi.t() @ dlo + xlo.t() @ dhi)


def emulate_backward(q, g, delta, tail, gout, blocks: int):
    """attention_bwd_kernel's dataflow: tiles of QT = 64 // k queries (R =
    QT k rows; rows past R and queries past M zero), the d -> d layers'
    products from the shared-memory weights (bwd_weights; read as W^T
    forward and as W for the input gradients, with the ReLU masks read in
    place), the 3-wide layers in fp32; block b takes tiles b, b + blocks, ... and adds each tile's
    weight-gradient sums to its partial in that order; the partials are
    summed block after block.  Returns the plain version's 11 outputs."""
    B, N, d = q.shape
    k, M, d8 = g.shape[2], B * N, -(-d // 8) * 8
    QT = max(1, ROWS // k)
    R, inv = QT * k, 1.0 / math.sqrt(d)
    W = bwd_weights(tail, d)
    # the forward's layers: W^T and the bias padded to d8
    Lf = [(*W[i, False][:2], _pad(tail[i + 1][1], d8).numpy()) for i in range(3)]
    Lt = [W[2, True], W[1, True], W[0, True]]  # W_g1, W_g0, W_d1 themselves
    (wd0, bd0), *_ = tail
    qf, gf = q.reshape(M, d), g.reshape(M * k, 2 * d)
    df, go = delta.reshape(M * k, 3), gout.reshape(M, d)
    dq, dg, ddelta = torch.zeros(M, d), torch.zeros(M * k, 2 * d), torch.zeros(M * k, 3)
    shapes = [(3, d), (d,), (d, d), (d,), (d, d), (d,), (d, d), (d,)]  # wbuf's [in][out]
    partial = [[torch.zeros(s) for s in shapes] for _ in range(blocks)]
    tiles = -(-M // QT)
    for tl in range(tiles):
        G = partial[tl % blocks]
        q0 = tl * QT
        n = min(QT, M - q0)  # the tile's real queries
        nr = n * k
        buf = lambda x, w=d8: _pad(x, w)  # noqa: E731
        K = torch.zeros(ROWS, d8)
        V = torch.zeros(ROWS, d8)
        K[:nr, :d], V[:nr, :d] = gf[q0 * k:q0 * k + nr, :d], gf[q0 * k:q0 * k + nr, d:]
        Q, GO = torch.zeros(QT, d8), torch.zeros(QT, d8)
        Q[:n, :d], GO[:n, :d] = qf[q0:q0 + n], go[q0:q0 + n]
        DL = torch.zeros(ROWS, 3)
        DL[:nr] = df[q0 * k:q0 * k + nr]
        keep = torch.zeros(ROWS, 1)
        keep[:R] = 1.0  # rows the kernel stores
        A1 = buf(torch.relu(DL @ wd0.t() + bd0)) * keep
        A2 = _layer(A1, Lf[0]) * keep  # pos
        Qr = torch.zeros(ROWS, d8)
        Qr[:R] = Q.repeat_interleave(k, 0)
        A3 = ((Qr - K) + A2) * keep  # h
        A4 = _layer(A3, Lf[1], relu=True) * keep  # r2
        A5 = _layer(A4, Lf[2]) * keep  # a
        a3 = A5[:R].reshape(QT, k, d8)[..., :d] * inv
        s = torch.softmax(a3, dim=1)
        g3 = GO[:, None, :d]
        ds = (V[:R].reshape(QT, k, d8)[..., :d] + A2[:R].reshape(QT, k, d8)[..., :d]) * g3
        da = buf((s * (ds - (s * ds).sum(1, keepdim=True)) * inv).reshape(R, d))
        da = torch.cat([da, torch.zeros(ROWS - R, d8)])
        dv = (s * g3).reshape(R, d)  # d V, and the softmax's share of d pos
        G[6] += _wgrad(A4, da)[:d, :d]
        G[7] += da.sum(0)[:d]
        dpre2 = torch.where(A4 > 0, _product(da, *Lt[0][:2]), 0.0) * keep
        G[4] += _wgrad(A3, dpre2)[:d, :d]
        G[5] += dpre2.sum(0)[:d]
        dh = _product(dpre2, *Lt[1][:2]) * keep
        dpos = dh + torch.cat([buf(dv), torch.zeros(ROWS - R, d8)])
        G[2] += _wgrad(A1, dpos)[:d, :d]
        G[3] += dpos.sum(0)[:d]
        dpre1 = torch.where(A1 > 0, _product(dpos, *Lt[2][:2]), 0.0) * keep
        G[0] += DL.t() @ dpre1[:, :d]
        G[1] += dpre1.sum(0)[:d]
        dq[q0:q0 + n] = dh[:R, :d].reshape(QT, k, d).sum(1)[:n]
        dg[q0 * k:q0 * k + nr] = torch.cat([-dh[:nr, :d], dv[:nr]], 1)
        ddelta[q0 * k:q0 * k + nr] = dpre1[:nr, :d] @ wd0
    dw = [sum(p[i] for p in partial) for i in range(8)]
    dw = [w.t() if w.dim() == 2 else w for w in dw]  # nn.Linear's [out, in]
    return (dq.reshape(q.shape), dg.reshape(g.shape), ddelta.reshape(delta.shape), *dw)


GRAD_NAMES = "q g delta wd0 bd0 wd1 bd1 wg0 bg0 wg1 bg1".split()


def test_backward_emulation_matches_plain_and_jax(case, request, worker_state):
    """The emulated tile dataflow (3 blocks, so every block's partial holds
    several tiles) against attention_bwd_plain and JAX's vjp, every input
    and weight gradient."""
    args, jax_out, jax_grads = case
    case_name = request.node.callspec.params["case"]
    jax_sum = digest(jax_out, *jax_grads)
    check = lambda stage: assert_inputs_unchanged(  # noqa: E731
        case_name, args, [jax_out, *jax_grads], jax_sum, stage)
    check("before the emulation")
    got = emulate_backward(*args, blocks=3)
    check("after the emulation")
    plain = ac.attention_bwd_plain(*args)
    check("after the plain version")
    for i, (name, e, p, j) in enumerate(zip(GRAD_NAMES, got, plain, jax_grads)):
        assert_close(case_name, "backward", name, i,
                     {"emulation": e.numpy(), "plain": p.numpy()}, worker_state)
        np.testing.assert_allclose(e.numpy(), j, rtol=2e-4, atol=2e-5, err_msg=name)


def test_backward_emulation_block_count_changes_only_rounding(case, request, worker_state):
    """The blocks' partials cover every tile once: one block and 5 blocks
    give the same input gradients bit for bit (a tile's rows do not depend
    on its block) and weight gradients within rounding of the sum order
    (1e-5 of each gradient's largest magnitude)."""
    args, jax_out, jax_grads = case
    case_name = request.node.callspec.params["case"]
    jax_sum = digest(jax_out, *jax_grads)
    check = lambda stage: assert_inputs_unchanged(  # noqa: E731
        case_name, args, [jax_out, *jax_grads], jax_sum, stage)
    check("before the emulations")
    one = emulate_backward(*args, blocks=1)
    check("after one block's emulation")
    five = emulate_backward(*args, blocks=5)
    check("after five blocks' emulation")
    for i, (name, a, b) in enumerate(zip(GRAD_NAMES, one, five)):
        held = {"one": a.numpy(), "five": b.numpy()}
        tol = 0.0 if i < 3 else 1e-5 * b.abs().max().item()  # the message runs on a miss only
        assert (a - b).abs().max().item() <= tol if i >= 3 else torch.equal(a, b), miss_report(
            case_name, "blocks", name, i, held, np.abs(held["one"] - held["five"]) > tol,
            worker_state)


def test_tc_route_shapes():
    """The forward's tensor-core routes take d <= 128 (a multiple of 8) and
    k <= 16 (per warp to d = 64, block-wide at 72-128, ISAPCInet's width
    variants); the scalar kernel the rest of what the wrapper takes."""
    assert ac.tc_route_ok(64, 16) and ac.tc_route_ok(40, 7) and ac.tc_route_ok(8, 1)
    assert ac.tc_route_ok(72, 16) and ac.tc_route_ok(96, 16) and ac.tc_route_ok(128, 16)
    assert not ac.tc_route_ok(64, 17) and not ac.tc_route_ok(128, 17)
    assert not ac.tc_route_ok(136, 16) and not ac.tc_route_ok(20, 4)
