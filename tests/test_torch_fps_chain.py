"""The selection rule of the one-warp FPS chain (pci_tpu_torch/csrc/stages.cuh:
fps_warp_chain, the FlowNet3D encoder megakernel's FPS) held on the CPU.

A torch emulation of the warp's arithmetic: lane l holds points l, l + 32,
... (fp32 distances relaxed with (dx*dx + dy*dy) + dz*dz, each op rounded on
its own); each lane keeps its first maximum; the warp takes the largest
distance by its bits read as an integer (a non-negative fp32 orders as its
bits) and the lowest index among the lanes at it.  Its picks must equal the
plain version's (``fps_cuda.fps_plain``) and the JAX package's exact
``pci_tpu.ops.fps`` bit for bit, from index 0: on seeded clouds, a cloud
whose size is not a multiple of 32, a grid cloud with duplicate points and
exact distance ties, and more picks than points (index 0 again once every
distance is 0).  chip_smoke.py holds the kernel's picks (flowenc's
centres2) to the plain version's on the card."""

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
