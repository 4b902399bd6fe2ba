"""Kernel row 2 (``csrc/setconv.cu``, the per-stage set-conv) held on the
CPU through its host packing and its dataflow, at FlowNet3D's four set-conv
stage widths (``pci_tpu_torch/models/flownet3d.py``: set_conv1 6 -> 32 ->
32 -> 64 at K 16, r 0.5; set_conv2 67 -> 64 -> 64 -> 128 at K 16, r 1;
set_conv3 131 -> 128 -> 128 -> 256 at K 8, r 2; set_conv4 259 -> 256 ->
256 -> 512 at K 8, r 4) on clouds of at most 512 keys:

- a torch emulation of its two tiles (both run the MLP on the tensor
  cores; the plan picks one a launch): each centre's slots as the cluster
  tile's warps place them (keys in staged chunks, each chunk's slices one a warp,
  the three-FMA mark then ``sqdist3``'s op-by-op distance on the marked
  keys, a warp's hits in a list of its own, the lists appended in slice
  order up to K, a shortfall padded with the first hit, an empty ball
  reading key 0: the first K hits by index; the mark held a superset of
  the keys within the radius; ``ball_conv_tile``'s scan, one warp a centre
  in index order, gives the same slots), the
  rows ``[key - centre | feats]`` of Q centres gathered in chunks of R rows
  padded to 16-row tiles (the
  padding rows NaN here: no real row may read them), the chain from
  ``_build.pack_tf32``'s weights decoded through the fragment layout
  (``tests/test_torch_tf32.py:_decode``) in 3xTF32 (activations split in
  the kernel's way, ``a_hi w_hi + (a_hi w_lo + a_lo w_hi)``, + bias, ReLU),
  each layer's n-tiles computed rank by rank over the cluster's C blocks
  (one block for ``ball_conv_tile``) and the last layer's columns pooled by
  their own rank, at the tiles and plans the kernel takes on an H100 (132
  SMs) for one stream (``chip_smoke.py``'s ``stages setconv`` lines print
  them), with the cluster tile at every stage, and at a plan of many
  chunks;
- held against ``setconv_cuda.setconv_plain`` (fp32) and JAX's
  ``setconv_fused`` in interpret mode, within ``rtol = atol = 2e-5``
  relative to the output's largest magnitude (3xTF32 keeps ~2^-22 of each
  product; the plain version's fp32 sums differ by the same order);
- the host plan's limits (``setconv_cuda.kernel_route_ok``).

JAX's four stages run once a test run, in one jit each, shared by the
xdist workers (``shared_result``).  chip_smoke.py holds the kernel against
the plain version on the card."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pci_tpu.ops.pallas_kernels.setconv_tpu import setconv_fused as jax_setconv
from pci_tpu_torch.ops.cuda_kernels import _build, setconv_cuda
from tests.test_torch_shared import shared_result
from tests.test_torch_tf32 import _decode

# stage -> (keys, feature channels D, MLP widths, centres S, K, radius,
# cloud side, seed); the clouds' sides put ~10 keys in a ball, so balls
# come full, short and (two far centres) empty
STAGES = {"set_conv1": (512, 3, (32, 32, 64), 64, 16, 0.5, 3.0, 2001),
          "set_conv2": (256, 64, (64, 64, 128), 64, 16, 1.0, 4.7, 2002),
          "set_conv3": (128, 128, (128, 128, 256), 32, 8, 2.0, 7.5, 2003),
          "set_conv4": (64, 256, (256, 256, 512), 16, 8, 4.0, 12.9, 2004)}
# (Q, C, R) of the tile csrc/setconv.cu's setconv_plan_launch takes for one
# stream of the stage on 132 SMs (set_conv2 and set_conv3 on ball_conv_tile,
# ball_conv_plan's tensor plan), of the cluster tile's own plan there
# (setconv_plan), and a plan of many chunks and ranks
PLANS = {"set_conv1": (8, 1, 64), "set_conv2": (2, 1, 32), "set_conv3": (1, 1, 16),
         "set_conv4": (4, 8, 32)}
CLUSTER_PLANS = {"set_conv1": (8, 1, 64), "set_conv2": (4, 2, 64), "set_conv3": (8, 8, 64),
                 "set_conv4": (4, 8, 32)}
CHUNKED = (2, 4, 16)
TOL = 2e-5


def stage_inputs(name: str):
    """Seeded numpy inputs of a stage: keys [1, N, 3], features [1, N, D]
    (non-negative, as pooled ReLU features are), centres [1, S, 3] (keys,
    the last two far from every key) and the folded layers ``[(W [cout,
    cin], b)]``."""
    N, D, widths, S, K, r, side, seed = STAGES[name]
    rng = np.random.default_rng(seed)
    xyz = (rng.random((1, N, 3)) * side).astype(np.float32)
    feats = np.maximum(rng.standard_normal((1, N, D)), 0).astype(np.float32)
    q = xyz[:, :S].copy()
    q[:, -2:] += 100.0
    layers, cin = [], 3 + D
    for cout in widths:
        w = (rng.standard_normal((cout, cin)) / np.sqrt(cin)).astype(np.float32)
        b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
        layers.append((w, b))
        cin = cout
    return xyz, feats, q, layers


def torch_layers(layers):
    return [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in layers]


def jax_stage(name: str) -> np.ndarray:
    """JAX's ``setconv_fused`` (interpret mode, one jit) on a stage's inputs."""
    _, _, _, _, K, r, _, _ = STAGES[name]
    xyz, feats, q, layers = stage_inputs(name)
    flat = tuple(jnp.asarray(a) for wb in layers for a in wb)
    return np.asarray(jax_setconv(jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(q), r, K,
                                  flat, len(layers), True, True))


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    """Every stage's JAX output, once a test run."""
    return shared_result("setconv_tc_jax", lambda: {n: jax_stage(n) for n in STAGES},
                         tmp_path_factory)


MARK_MARGIN = np.float32(1.9073486e-06)  # csrc/common.cuh


def scan_chunk(N: int) -> int:
    """csrc/setconv.cu:setconv_chunk: the keys a staged chunk holds."""
    return min(4096, -(-N // 512) * 512)


def sq3(a, b):
    """csrc/common.cuh sqdist3, fp32 op by op: (dx dx + dy dy) + dz dz."""
    d = (a - b).astype(np.float32)
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def fma32(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def marks(xyz, q, r: float) -> np.ndarray:
    """``[S, N]`` csrc/setconv.cu's three-FMA mark: mark_dot (|k|^2 - 2 q.k
    in three FMAs, |k|^2 = (x x + y y) + z z) below mark_limit(r^2, |q|^2,
    1.001 (2 |q| + r)^2) (fp32; the FMAs emulated in fp64)."""
    r2 = np.float32(r) ** 2
    kk = sq3(xyz, np.zeros(3, np.float32))
    qq = sq3(q, np.zeros(3, np.float32))
    reach = np.float32(2) * np.sqrt(qq) + np.sqrt(r2)
    lim = (r2 - qq) + MARK_MARGIN * (r2 + np.float32(1.001) * reach * reach)
    q2 = np.float32(-2) * q
    dot = fma32(q2[:, None, 0], xyz[None, :, 0],
                fma32(q2[:, None, 1], xyz[None, :, 1],
                      fma32(q2[:, None, 2], xyz[None, :, 2], kk[None, :])))
    return dot < lim[:, None]


def slots(xyz, q, r: float, K: int, kc: int, W: int = 8) -> np.ndarray:
    """``[S, K]`` key indices as csrc/setconv.cu's cluster tile places them:
    keys in chunks of ``kc``, each chunk cut into ``W`` slices of a
    multiple of 64 keys, one a warp; a warp's keys the mark passes and
    ``sqdist3`` puts within the radius (<= r^2), in index order, into its
    own list a centre, at most the slots the ball has left; the centre's
    lists appended in slice order; a shortfall repeats the first hit, an
    empty ball reads key 0."""
    r2 = np.float32(r) ** 2
    hit = marks(xyz, q, r) & (sq3(xyz[None], q[:, None]) <= r2)
    N = xyz.shape[0]
    out = np.zeros((q.shape[0], K), np.int64)
    for s in range(q.shape[0]):
        got = []
        for c0 in range(0, N, kc):
            room = K - len(got)
            if room <= 0:
                break
            n = min(kc, N - c0)
            span = -(-(-(-n // W)) // 64) * 64
            for w in range(W):
                lo, hi = min(n, w * span), min(n, w * span + span)
                lst = [c0 + j for j in range(lo, hi) if hit[s, c0 + j]][:room]
                got += lst[:K - len(got)]
        if got:
            out[s] = got + [got[0]] * (K - len(got))
    return out


def emulate(xyz, feats, q, r: float, K: int, layers, plan) -> torch.Tensor:
    """csrc/setconv.cu's tiles on one stream (see the module doc):
    tiles of Q centres (a tail tile repeats the last centre), R-row chunks
    padded to 16-row tiles with NaN rows, each layer's n-tiles by rank over
    C blocks from the decoded split pack, the max over each centre's slots
    of its rank's columns."""
    Q, C, R = plan
    S, D = q.shape[0], feats.shape[-1]
    dims = [3 + D, *(w.shape[0] for w, _ in layers)]
    dec, _ = _decode(_build.pack_tf32(torch_layers(layers), torch.device("cpu")), dims,
                        chain=False)
    idx = slots(xyz, q, r, K, scan_chunk(xyz.shape[0]))
    cout = dims[-1]
    out = torch.full((S, cout), float("nan"))
    for q0 in range(0, S, Q):
        cen = [min(q0 + i, S - 1) for i in range(Q)]
        rows = np.concatenate([idx[c] for c in cen])
        qrow = np.repeat(np.array(cen), K)
        best = torch.full((Q, cout), -float("inf"))
        for r0 in range(0, Q * K, R):
            nr = min(R, Q * K - r0)
            rr = -(-nr // 16) * 16
            h = torch.full((rr, -(-dims[0] // 8) * 8), float("nan"))
            j, c = rows[r0:r0 + nr], qrow[r0:r0 + nr]
            h[:nr] = 0.0
            h[:nr, :3] = torch.from_numpy(xyz[j] - q[c])
            h[:nr, 3:3 + D] = torch.from_numpy(feats[j])
            for (hi, lo, b), cin_, co in zip(dec, dims[:-1], dims[1:]):
                nt = -(-co // 8)
                y = torch.empty(rr, hi.shape[1])
                ahi, alo = _build.tf32_split(h)
                for rank in range(C):
                    cols = slice(8 * (rank * nt // C), 8 * ((rank + 1) * nt // C))
                    whi, wlo = torch.from_numpy(hi[:, cols]), torch.from_numpy(lo[:, cols])
                    y[:, cols] = torch.relu(ahi @ whi + (ahi @ wlo + alo @ whi)
                                            + torch.from_numpy(b[cols]))
                h = y
            for i in range(nr):
                qi = (r0 + i) // K
                best[qi] = torch.maximum(best[qi], h[i, :cout])
        n = min(Q, S - q0)
        out[q0:q0 + n] = best[:n]
    assert not torch.isnan(out).any()
    return out[None]


@pytest.mark.parametrize("chunked", ["plan", "cluster", "chunked"])
@pytest.mark.parametrize("name", sorted(STAGES))
def test_emulated_tile_matches_plain_and_jax(name, chunked, jax_outputs):
    """The tiles' dataflow (the launch's plan, the cluster tile's plan, a
    plan of many chunks) against the plain version and JAX's Pallas kernel
    (interpret mode), within TOL of the output's largest magnitude
    (absolute and relative)."""
    _, _, _, _, K, r, _, _ = STAGES[name]
    xyz, feats, q, layers = stage_inputs(name)
    plan = {"plan": PLANS, "cluster": CLUSTER_PLANS}.get(chunked, {name: CHUNKED})[name]
    got = emulate(xyz[0], feats[0], q[0], r, K, layers, plan)
    T = torch.from_numpy
    plain = setconv_cuda.setconv_plain(T(xyz), T(feats), T(q), r, K, torch_layers(layers))
    top = plain.abs().max().item()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL, atol=TOL * top)
    np.testing.assert_allclose(got.numpy(), jax_outputs[name], rtol=TOL, atol=TOL * top)


@pytest.mark.parametrize("kc", [None, 128, 64], ids=["plan", "128", "64"])
def test_slots_match_the_plain_ball_query(kc):
    """The emulated scan's slots (the stage's chunk, and chunks of 128 and
    64 keys, so that balls take hits from several chunks and slices) equal
    the plain version's (``ball_plain(empty="first")``) at every stage:
    full, short and empty balls; and the three-FMA mark is a superset of
    the keys within the radius."""
    from pci_tpu_torch.ops.cuda_kernels.ball_cuda import ball_plain

    kinds = set()
    for name, (N, _, _, _, K, r, _, _) in STAGES.items():
        xyz, _, q, _ = stage_inputs(name)
        inside = sq3(xyz[0][None], q[0][:, None]) <= np.float32(r) ** 2
        assert (marks(xyz[0], q[0], r) | ~inside).all()
        got = slots(xyz[0], q[0], r, K, kc or scan_chunk(N))
        (want,) = ball_plain(torch.from_numpy(xyz), torch.from_numpy(q), [r], [K], empty="first")
        np.testing.assert_array_equal(got, want[0].numpy())
        kinds |= {"full" if len(set(row)) == K else "short" for row in got}
    assert kinds == {"full", "short"}


def test_kernel_route_limits():
    """The wrapper launches for 1 <= nsample <= 128 (the JAX package's
    gate) and chains of 1-8 layers of at most 1,024 channels; FlowNet3D's
    four stages all take the kernel."""
    ok = setconv_cuda.kernel_route_ok
    for _, D, widths, _, K, _, _, _ in STAGES.values():
        assert ok(K, [3 + D, *widths])
    assert ok(128, [6, 32]) and not ok(129, [6, 32]) and not ok(0, [6, 32])
    assert ok(16, [6, 1024, 64]) and not ok(16, [6, 1025, 64])
    assert ok(16, [6] + [8] * 8) and not ok(16, [6] + [8] * 9) and not ok(16, [6])
