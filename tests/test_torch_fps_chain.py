"""The selection rules of the FPS chains of pci_tpu_torch/csrc/stages.cuh held
on the CPU: the one-warp chain (fps_warp_chain, the FlowNet3D encoder
megakernel's FPS and csrc/fps.cu's exact chains of at most 1,024 points)
and the W-warp chain (fps_group_chain, csrc/fps.cu's interleaved chains).

A torch emulation of the warp's arithmetic: lane l holds points l, l + 32,
... (fp32 distances relaxed with (dx*dx + dy*dy) + dz*dz, each op rounded on
its own); each lane keeps its first maximum; the warp takes the largest
distance by its bits read as an integer (a non-negative fp32 orders as its
bits) and the lowest index among the lanes at it.  Its picks must equal the
plain version's (``fps_cuda.fps_plain``) and the JAX package's exact
``pci_tpu.ops.fps`` bit for bit, from index 0: on seeded clouds, a cloud
whose size is not a multiple of 32, a grid cloud with duplicate points and
exact distance ties, and more picks than points (index 0 again once every
distance is 0).

The W-warp chain: thread g of the group holds points g, g + 32 W, ...; each
thread keeps its first maximum, each warp reduces as the one-warp chain
does, and the W warps' (bits, index) pairs reduce the same way again (every
warp reads the W slots).  Its picks over each strided subset s, s + P, ...
from ``start // P`` (clamped) must equal ``fps_plain``'s interleaved chains
and the JAX package's exact FPS over that subset: chains of 2,000, 2,048
and 8,192 points, W = 1, 4 (and 16, the kernel's width at 8,192), random
starts, a cloud with 10% exact duplicates and a grid with exact ties.
chip_smoke.py holds the kernels' picks to the plain version's on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pci_tpu import ops as jops
from pci_tpu_torch.ops.cuda_kernels.fps_cuda import fps_plain

INT_MAX = 0x7FFFFFFF


def warp_chain(xyz: np.ndarray, npick: int) -> np.ndarray:
    """fps_warp_chain's picks over ``xyz [L, 3]`` (L <= 1,024) from index 0."""
    L = xyz.shape[0]
    ppl = -(-L // 32)
    pts = torch.from_numpy(xyz)
    j = torch.arange(32)[:, None] + 32 * torch.arange(ppl)[None, :]  # [lane, t]
    valid = j < L
    jc = j.clamp(max=L - 1)
    px, py, pz = pts[jc, 0], pts[jc, 1], pts[jc, 2]
    dist = torch.full((32, ppl), float("inf"))
    lanes = torch.arange(32)
    far, picks = 0, []
    for _ in range(npick):
        picks.append(far)
        c = pts[far]
        dx, dy, dz = px - c[0], py - c[1], pz - c[2]
        d = (dx * dx + dy * dy) + dz * dz
        dist = torch.where(valid, torch.minimum(dist, d), dist)
        lane_d = torch.where(valid, dist, torch.tensor(-1.0))
        t = torch.argmax(lane_d, dim=1)  # the lane's first maximum
        bd, bi = lane_d[lanes, t], j[lanes, t]
        bits = torch.where(bd < 0, 0, bd.view(torch.int32))  # a lane with no point: 0
        bi = torch.where(bd < 0, INT_MAX, bi)
        far = int(bi[bits == bits.max()].min())
    return np.array(picks, np.int32)


def group_chain(xyz: np.ndarray, npick: int, far: int, W: int) -> np.ndarray:
    """fps_group_chain's picks over ``xyz [L, 3]`` from local index ``far``
    by a group of W warps."""
    L = xyz.shape[0]
    stride = 32 * W
    ppl = -(-L // stride)
    pts = torch.from_numpy(xyz)
    j = torch.arange(stride)[:, None] + stride * torch.arange(ppl)[None, :]  # [g, t]
    valid = j < L
    jc = j.clamp(max=L - 1)
    px, py, pz = pts[jc, 0], pts[jc, 1], pts[jc, 2]
    dist = torch.where(valid, float("inf"), -1.0)
    rows = torch.arange(stride)
    picks = []
    for _ in range(npick):
        picks.append(far)
        c = pts[far]
        dx, dy, dz = px - c[0], py - c[1], pz - c[2]
        dist = torch.minimum(dist, (dx * dx + dy * dy) + dz * dz)  # -1 stays -1
        t = torch.argmax(dist, dim=1)  # each thread's first maximum
        bd, bi = dist[rows, t], j[rows, t]
        bits = torch.where(bd < 0, 0, bd.view(torch.int32)).reshape(W, 32)
        bi = torch.where(bd < 0, INT_MAX, bi).reshape(W, 32)
        top = bits.max(1, keepdim=True).values  # the warp max over the bits
        win = torch.where(bits == top, bi, INT_MAX).min(1).values  # the warp min
        top = top[:, 0]  # the W slots, reduced the same way
        far = int(win[top == top.max()].min())
    return np.array(picks, np.int32)


def _gaussian(seed, n):
    return (np.random.default_rng(seed).standard_normal((n, 3)) * 10).astype(np.float32)


def _grid_with_duplicates(seed):
    """An 8 x 8 x 8 grid of unit spacing (exact ties in every distance),
    then 200 copies of grid points, shuffled."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(8.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pts = np.concatenate([g, g[rng.integers(0, len(g), 200)]])
    return pts[rng.permutation(len(pts))].astype(np.float32)


CLOUDS = {  # name -> (cloud, picks)
    "gaussian_1024_256": (_gaussian(0, 1024), 256),
    "gaussian_1000_256": (_gaussian(1, 1000), 256),
    "grid_ties_duplicates_712_256": (_grid_with_duplicates(2), 256),
    "more_picks_than_points_40_64": (_gaussian(3, 40), 64),
}


@pytest.fixture(scope="module")
def jax_picks():
    """JAX's exact FPS from index 0 for every cloud (one jit a shape)."""
    return {name: np.asarray(jops.fps(jnp.asarray(x[None]), n, 0, True))[0]
            for name, (x, n) in CLOUDS.items()}


@pytest.mark.parametrize("name", list(CLOUDS))
def test_warp_chain_picks(name, jax_picks):
    xyz, npick = CLOUDS[name]
    got = warp_chain(xyz, npick)
    plain = fps_plain(torch.from_numpy(xyz)[None], npick, torch.zeros(1, dtype=torch.long), 1)
    np.testing.assert_array_equal(got, plain[0].numpy())
    np.testing.assert_array_equal(got, jax_picks[name])
    if npick > xyz.shape[0]:  # every distance 0 after L picks: index 0 again
        assert (got[xyz.shape[0]:] == 0).all()


def _with_duplicates(seed, n):
    """A gaussian cloud whose last 10% of points are exact copies of others."""
    x = _gaussian(seed, n)
    rng = np.random.default_rng(seed + 100)
    k = n // 10
    x[n - k:] = x[rng.integers(0, n - k, k)]
    return x


def _grid(seed, n):
    """Points of an integer grid (exact distance ties), shuffled, with repeats."""
    rng = np.random.default_rng(seed)
    side = int(round(n ** (1 / 3))) + 1
    g = np.stack(np.meshgrid(*[np.arange(float(side))] * 3, indexing="ij"), -1).reshape(-1, 3)
    return g[rng.integers(0, len(g), n)].astype(np.float32)


GROUP_CASES = {  # name -> (cloud [N, 3], npoint, P, start, W)
    "L2048_W1": (_gaussian(10, 16384), 1024, 8, 16383, 1),
    "L2048_W4": (_gaussian(10, 16384), 1024, 8, 16383, 4),
    "L2000_W1_start": (_gaussian(11, 16000), 1024, 8, 12345, 1),
    "L2000_W4_start": (_gaussian(11, 16000), 1024, 8, 12345, 4),
    "L8192_W4_dups": (_with_duplicates(12, 65536), 1024, 8, 777, 4),
    "L8192_W16_dups": (_with_duplicates(12, 65536), 1024, 8, 777, 16),
    "grid_ties_W4_clamped": (_grid(13, 16383), 1024, 8, 16382, 4),
}


@pytest.fixture(scope="module")
def group_jax_picks():
    """JAX's exact FPS over strided subset 3 of each cloud (one jit a
    shape), from that chain's clamped start."""
    out = {}
    for name, (x, npoint, P, start, _) in GROUP_CASES.items():
        sub = x[3::P]
        far = min(start // P, len(sub) - 1)
        out[name] = np.asarray(jops.fps(jnp.asarray(sub[None]), npoint // P, far, True))[0]
    return out


@pytest.mark.parametrize("name", list(GROUP_CASES))
def test_group_chain_picks(name, group_jax_picks):
    """The W-warp chain over every strided subset gives fps_plain's
    interleaved picks, and chain 3 JAX's exact FPS over its subset."""
    x, npoint, P, start, W = GROUP_CASES[name]
    N = x.shape[0]
    plain = fps_plain(torch.from_numpy(x)[None], npoint, torch.tensor([start]), P)[0].numpy()
    for s in range(P):
        sub = x[s::P]
        got = group_chain(sub, npoint // P, min(start // P, len(sub) - 1), W)
        np.testing.assert_array_equal(got * P + s, plain[s::P])
        if s == 3:
            np.testing.assert_array_equal(got, group_jax_picks[name])
    if name.endswith("clamped"):  # chain 7 is one point short: its start is clamped
        assert N % P and start // P > len(x[P - 1::P]) - 1
