"""The port's EMD (``pci_tpu_torch/ops/emd.py`` and
``ops/cuda_kernels/auction_cuda.py``) against the JAX package, on CPU.

- ``auction`` (the plain versions of the Gauss-Seidel pass and chase)
  against JAX's ``emd_auction_tpu`` in interpret mode at 256 points: both
  converge, and each total cost is within ``n * eps * d_scale`` of scipy's
  optimum (costs, not assignments: near-tied bids part the assignments).
- The auction's certificate on clouds with 10% exact duplicates: the
  final prices' dual bound is within ``n * (1.0001 eps + 1e-5)`` of the
  matching's cost.
- The dense route of ``emd_assignment_dist`` against JAX's at 64 points;
  identical clouds; ``emd``'s x36 scale; ``sinkhorn_emd`` (1e-4
  relative); ``emd_assignment_sparse`` against scipy at 1,024 points; the
  fixed-assignment gradient against ``jax.grad``.

Inputs come from numpy with a fixed seed per test.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import jax
import jax.numpy as jnp

from pci_tpu import ops as jops
from pci_tpu.ops.pallas_kernels.auction_tpu import emd_auction_tpu
from pci_tpu_torch import ops
from pci_tpu_torch.ops.cuda_kernels import auction_cuda

torch.set_num_threads(2)

J, T = jnp.asarray, torch.from_numpy
EPS = 1e-3


def pair(seed, n, shift=0.2, dup=0.0):
    """Two seeded ``[n, 3]`` clouds; ``dup`` of each cloud's rows repeat
    earlier rows exactly."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, 3)).astype(np.float32)
    b = (rng.standard_normal((n, 3)) + shift).astype(np.float32)
    k = int(dup * n)
    if k:
        for x in (a, b):
            x[n - k:] = x[rng.integers(0, n - k, k)]
    return a, b


def optimum(a, b) -> float:
    d = ((a[:, None, :].astype(np.float64) - b[None]) ** 2).sum(-1)
    r, c = linear_sum_assignment(d)
    return float(d[r, c].sum())


def d_scale(a, b) -> float:
    return 2.0 * float((a * a).sum(-1).max() + (b * b).sum(-1).max())


def is_permutation(idx) -> bool:
    return len(set(np.asarray(idx).tolist())) == len(idx)


def test_auction_plain_converges_near_optimum_like_jax():
    """The plain Gauss-Seidel auction and JAX's Pallas kernel (interpret
    mode) at 256 points, max_passes=128 (tests/test_layers.py's case)."""
    n = 256
    a, b = pair(41, n)
    jd, ji, jc = emd_auction_tpu(J(a), J(b), eps=EPS, max_passes=128)
    td, ti, tc = auction_cuda.auction(T(a), T(b), EPS, 128)
    opt, bound = optimum(a, b), n * EPS * d_scale(a, b)
    assert bool(jc) and bool(tc)
    assert is_permutation(ji) and is_permutation(ti)
    for cost in (float(np.asarray(jd, np.float64).sum()), float(td.double().sum())):
        assert opt - 1e-3 <= cost <= opt + bound, (cost, opt, bound)


@pytest.mark.parametrize("seed,n", [(42, 256), (43, 512)])
def test_auction_certificate_with_duplicates(seed, n):
    """10% exact duplicates in both clouds (real LiDAR's share): the run
    converges and its prices certify it (primal minus the dual bound
    within n (1.0001 eps + 1e-5), in normalised costs); the cost is
    within that bound times d_scale of scipy's optimum."""
    a, b = pair(seed, n, shift=0.1, dup=0.1)
    dist, assign, conv, price, info = auction_cuda.auction(T(a), T(b), EPS, 256,
                                                           return_prices=True)
    assert bool(conv) and info["eps"] == float(np.float32(EPS)) and is_permutation(assign)
    bound = n * (1.0001 * EPS + 1e-5)
    gap = auction_cuda.duality_gap(T(a), T(b), assign, price)
    assert -1e-6 <= gap <= bound, (gap, bound)
    cost = float(dist.double().sum())
    assert optimum(a, b) - 1e-3 <= cost <= optimum(a, b) + bound * d_scale(a, b)


def test_auction_pass_and_chase_keep_state_consistent():
    """One pass then one chase from the empty state: every owner's row holds its
    column, prices only rose, and the chase leaves no row both unflagged
    and unheld."""
    a, b = pair(44, 300)
    q, k, _ = auction_cuda.normalise(T(a), T(b))
    price = torch.zeros(300)
    assign = torch.full((300,), -1, dtype=torch.int32)
    owner = torch.full((300,), -1, dtype=torch.int32)
    bidders = auction_cuda.auction_pass(q, k, price, assign, owner, 0.25)
    assert int(bidders) == 300  # every row starts unassigned
    hops = auction_cuda.auction_chase(q, k, price, assign, owner, 0.25)
    assert 0 <= int(hops) <= auction_cuda.CHASE_HOPS
    held = owner >= 0
    assert torch.equal(assign[owner[held].long()], torch.nonzero(held)[:, 0].int())
    assert (price >= 0).all()
    if int(hops) < auction_cuda.CHASE_HOPS:  # the chase ran out of flags
        assert bool((assign >= 0).all()) and is_permutation(assign)


def test_dense_route_matches_jax():
    """n=64 (the dense Jacobi route on both): converged alike, each cost
    within n * eps * max D of the optimum, permutations."""
    n = 64
    a, b = pair(45, n, shift=0.0)
    jd, ji, jc = jops.emd_assignment_dist(J(a), J(b), eps=EPS, iters=2048)
    td, ti, tc = ops.emd_assignment_dist(T(a), T(b), EPS, 2048)
    assert bool(jc) == bool(tc) is True
    assert is_permutation(ji) and is_permutation(ti) and ti.dtype == torch.int64
    opt = optimum(a, b)
    max_d = float(((a[:, None] - b[None]) ** 2).sum(-1).max())
    for cost in (float(np.asarray(jd, np.float64).sum()), float(td.double().sum())):
        assert opt - 1e-3 <= cost <= opt + n * EPS * max_d


def test_identical_clouds_give_zero():
    a, _ = pair(46, 32)
    dist, assign, _ = ops.emd_assignment_dist(T(a), T(a), 1e-5, 4096)
    assert float(dist.sum()) == pytest.approx(0.0, abs=1e-4)
    assert float(ops.emd(T(a)[None], T(a)[None], 1e-5, 1024)) == pytest.approx(0.0, abs=1e-3)


def test_emd_metric_scale_matches_jax():
    """``emd`` over a batch of two: 36 x the mean assigned distance; the
    two packages' values within 36 eps max D (each near-optimal)."""
    rng = np.random.default_rng(47)
    pc1 = rng.standard_normal((2, 48, 3)).astype(np.float32)
    pc2 = (pc1 + 0.3 * rng.standard_normal((2, 48, 3))).astype(np.float32)
    got = float(ops.emd(T(pc1), T(pc2), EPS, 2048))
    want = float(jops.emd(J(pc1), J(pc2), EPS, 2048))
    opt = 36.0 * np.mean([optimum(x, y) / 48 for x, y in zip(pc1, pc2)])
    max_d = max(float(((x[:, None] - y[None]) ** 2).sum(-1).max()) for x, y in zip(pc1, pc2))
    assert opt - 1e-3 <= got <= opt + 36.0 * EPS * max_d
    assert abs(got - want) <= 36.0 * EPS * max_d


def test_sinkhorn_matches_jax():
    rng = np.random.default_rng(48)
    pc1 = rng.standard_normal((2, 96, 3)).astype(np.float32)
    pc2 = (pc1 + 0.1 * rng.standard_normal((2, 96, 3))).astype(np.float32)
    got, (lo, hi) = ops.sinkhorn_emd(T(pc1), T(pc2), return_bounds=True)
    want, (jlo, jhi) = jops.sinkhorn_emd(J(pc1), J(pc2), 0.05, 500, True)
    for g, w in ((got, want), (lo, jlo), (hi, jhi)):
        assert float(g) == pytest.approx(float(w), rel=1e-4)
    assert float(lo) <= float(got) <= float(hi)


def test_sparse_matches_scipy_at_1024():
    """The kNN-restricted auction (k=16) on a drifted 1,024-point pair:
    converged, a permutation, the cost within 3% of scipy's optimum."""
    rng = np.random.default_rng(49)
    a = rng.standard_normal((1024, 3)).astype(np.float32)
    b = (a + 0.05 * rng.standard_normal((1024, 3))).astype(np.float32)
    dist, assign, conv = ops.emd_assignment_sparse(T(a), T(b), 1e-5, 16384, 16)
    opt = optimum(a, b)
    cost = float(dist.double().sum())
    assert bool(conv) and is_permutation(assign)
    assert opt - 1e-3 <= cost <= opt * 1.03 + 1e-3


def test_fixed_assignment_gradient_matches_jax():
    """d/dx1 sum(dist) = 2 (x1 - x2[assign]), zero into x2, against
    jax.grad of JAX's function (both find scipy's optimum at n=16)."""
    a, b = pair(50, 16, shift=0.0)
    x1 = T(a).requires_grad_()
    x2 = T(b).requires_grad_()
    dist, assign, _ = ops.emd_assignment_dist(x1, x2, 1e-5, 4096)
    dist.sum().backward()
    _, jassign, _ = jops.emd_assignment_dist(J(a), J(b), 1e-5, 4096)
    jg = jax.grad(lambda x: jnp.sum(jops.emd_assignment_dist(x, J(b), 1e-5, 4096)[0]))(J(a))
    np.testing.assert_array_equal(assign.numpy(), np.asarray(jassign))
    np.testing.assert_allclose(x1.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    assert torch.equal(x2.grad, torch.zeros_like(x2))
