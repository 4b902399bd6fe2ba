"""The box-pruned exact kNN (``pci_tpu_torch/csrc/knn_cells.cu`` on
``ops/cuda_kernels/knn_cuda.py:knn_cells_plan``) held on the CPU.

- A numpy emulation of the kernel's tile walk on the port's own plan (each
  tile of sorted queries walks its chunks in ascending tile bound, stops
  once the tile bound exceeds every query's k-th distance with the
  kernel's margin, a query skips a chunk by its round-down box bound, and
  candidates enter each list in (distance, index) order) gives the plain
  version's indices and distances bit for bit, with small chunks and tiles
  (64 keys, 32 queries) so that there are many chunks: on a gaussian cloud,
  a clustered flow-like cloud with duplicates, a cloud almost all in one
  Morton cell, and a cross cloud (S != N), at k = 1, 3, 16 and 40.
- The plan equals a direct computation: the Morton sort, the chunk and
  tile boxes by ``ops/cells.py`` and each tile's chunk order by ``box_lb``.
- The route's gate is false for CPU tensors, for ``valid_n`` and below the
  key threshold; on the CPU ``knn`` takes the plain version.
- At 1,024 points the exact distances are never farther, rank by rank,
  than those of the JAX package's approximate ``knn_cells`` in interpret
  mode.

Inputs come from numpy with a fixed seed per case.  chip_smoke.py holds the
kernel itself to the plain version on the card.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pci_tpu.ops.pallas_kernels import knn_cells_tpu as jcells
from pci_tpu_torch.ops import cells
from pci_tpu_torch.ops.cuda_kernels import knn_cuda

torch.set_num_threads(2)

F32, F64 = np.float32, np.float64
IMAX = 0x7FFFFFFF
CHUNK, TILE = 64, 32


def rd32(x):
    """float64 values rounded down to float32 (CUDA's __f*_rd): the float64
    sum, difference or product of two float32 values here is exact."""
    x = np.asarray(x, F64)
    with np.errstate(over="ignore", invalid="ignore"):
        r = x.astype(F32)
    up = r.astype(F64) > x
    r[up] = np.nextafter(r[up], F32(-np.inf))
    return r


def box_bound_rd(lo, hi, q):
    """cells.cuh:box_bound_rd for queries ``q [n, 3]``."""
    g = np.maximum(F32(0), np.maximum(rd32(lo.astype(F64) - q), rd32(q.astype(F64) - hi)))
    sq = rd32(g.astype(F64) * g)
    return rd32(rd32(sq[:, 0].astype(F64) + sq[:, 1]).astype(F64) + sq[:, 2])


def emulate(query, points, k, chunk=CHUNK, tile=TILE):
    """The kernel's walk for one batch row -> (dist [S, k], idx [S, k],
    pairs scanned)."""
    q_t, p_t = torch.from_numpy(query)[None], torch.from_numpy(points)[None]
    self_knn = query is points
    keys, qry, boxes, order, lbs = (t[0].numpy() for t in knn_cuda.knn_cells_plan(
        p_t if self_knn else q_t, p_t, self_knn, chunk, tile))
    S = query.shape[0]
    kxyz, kid = keys[:, :3], keys[:, 3].view(np.int32).astype(np.int64)
    qxyz, qid = qry[:, :3], qry[:, 3].view(np.int32)
    out_d = np.zeros((S, k), F32)
    out_i = np.zeros((S, k), np.int64)
    scanned = 0
    for t in range(order.shape[0]):
        rows = np.arange(t * tile, (t + 1) * tile)
        real = qid[rows] < S
        q = qxyz[rows]
        dl = np.full((tile, k), np.inf, F32)
        il = np.full((tile, k), IMAX, np.int64)
        for m in range(order.shape[1]):
            thd = dl[:, -1]
            done = ~real | (lbs[t, m] > thd * F32(1.00001) + F32(1e-30))
            if done.all():
                break
            c = order[t, m]
            need = ~done & (box_bound_rd(boxes[c, 0, :3], boxes[c, 1, :3], q) <= thd)
            if not need.any():
                continue
            scanned += int(need.sum()) * chunk
            kx = kxyz[c * chunk:(c + 1) * chunk]
            d = [kx[None, :, j] - q[need][:, None, j] for j in range(3)]
            d = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
            ids = np.broadcast_to(kid[c * chunk:(c + 1) * chunk], d.shape)
            pad = np.isnan(d)  # a NaN pad row never enters a list
            dc = np.concatenate([dl[need], np.where(pad, np.inf, d)], 1)
            ic = np.concatenate([il[need], np.where(pad, IMAX, ids)], 1)
            o = np.lexsort((ic, dc), axis=1)[:, :k]
            dl[need] = np.take_along_axis(dc, o, 1)
            il[need] = np.take_along_axis(ic, o, 1)
        out_d[qid[rows][real]] = dl[real]
        out_i[qid[rows][real]] = il[real]
    return out_d, out_i, scanned


def flow_like(rng, n):
    """Four noisy copies of a smooth planar velocity field over the same
    points (ISAPCInet's flow cloud stacks 4 flows a point), with exact
    duplicates."""
    a = rng.standard_normal((n // 4, 3)) * 10
    v = 0.05 * np.stack([-a[:, 1], a[:, 0], np.zeros(n // 4)], 1) + [0.3, 0.1, 0.0]
    x = np.concatenate([v + 1e-3 * rng.standard_normal(v.shape) for _ in range(4)])
    x[n // 2:n // 2 + n // 10] = x[:n // 10]
    return x.astype(F32)


def one_cell(rng, n):
    """90% of the points in one cell of the 1024^3 Morton grid, a third of
    those exact duplicates; the rest over the unit cube."""
    x = rng.random((n, 3))
    m = 9 * n // 10
    x[:m] = 0.5 + 1e-4 * rng.random((m, 3))
    x[m // 3:2 * m // 3] = x[:m // 3]
    return x[rng.permutation(n)].astype(F32)


def case(name, seed):
    """(query, points) of a named case; the same array twice for a self case."""
    rng = np.random.default_rng(seed)
    if name == "gaussian":
        x = (rng.standard_normal((2000, 3)) * 10).astype(F32)
        return x, x
    if name == "flow_like":
        x = flow_like(rng, 2048)
        return x, x
    if name == "one_cell":
        x = one_cell(rng, 1500)
        return x, x
    if name == "cross":
        return ((rng.standard_normal((700, 3)) * 10).astype(F32),
                (rng.standard_normal((1800, 3)) * 10).astype(F32))
    raise ValueError(name)


CASES = ["gaussian", "flow_like", "one_cell", "cross"]


@pytest.mark.parametrize("k", [1, 3, 16, 40])
@pytest.mark.parametrize("name", CASES)
def test_emulated_walk_gives_plain_neighbours(name, k):
    """Indices and distances bit-equal to knn_plain; where the cloud allows
    pruning the walk scanned a fraction of the pairs."""
    query, points = case(name, 700 + CASES.index(name))
    got_d, got_i, scanned = emulate(query, points, k)
    q_t = torch.from_numpy(query)[None]
    p_t = q_t if query is points else torch.from_numpy(points)[None]
    want_d, want_i = knn_cuda.knn_plain(q_t, p_t, k)
    np.testing.assert_array_equal(got_i, want_i[0].numpy())
    np.testing.assert_array_equal(got_d, want_d[0].numpy())
    frac = scanned / (query.shape[0] * points.shape[0])
    print(f"{name} k={k}: {frac:.3f} of the pairs scanned")
    if name in ("gaussian", "flow_like", "cross") and k <= 16:
        assert frac < 0.5


def expected_order_keys(lb, qlo, qhi, lo, hi, self_knn, C, TQ):
    """The sort keys knn_cells_plan orders each tile's chunks by: the box
    bounds, and below 0 for the chunks of bound 0, nearest first (by the
    chunk's place in the sorted order from the tile's own chunk in the self
    case, by box centres in the cross case)."""
    if self_knn:
        own = torch.arange(lb.shape[1])[:, None] // (C // TQ)
        near = -1.0 / (1.0 + (torch.arange(lb.shape[2])[None, :] - own).abs().float())
    else:
        g = ((qlo + qhi) * 0.5)[..., :, None, :] - ((lo + hi) * 0.5)[..., None, :, :]
        near = -1.0 / ((g * g).sum(-1) + 1e-30)
    return torch.where(lb > 0, lb, near)


@pytest.mark.parametrize("n", [1000, 1024])
@pytest.mark.parametrize("self_knn", [True, False])
def test_plan_equals_direct_computation(self_knn, n):
    """keys/qry rows, chunk boxes and each tile's chunk order and sort keys
    equal a direct computation by ops/cells.py and box_lb (with pad rows
    and without); pad keys are NaN rows and pad queries carry an index >=
    S; every order is ascending in the box bound (a key below 0 stands for
    a bound of 0)."""
    rng = np.random.default_rng(720 + self_knn + n)
    B, N, S, C, TQ = 2, n, 333, CHUNK, TILE
    p = torch.from_numpy((rng.standard_normal((B, N, 3)) * 3).astype(F32))
    q = p if self_knn else torch.from_numpy((rng.standard_normal((B, S, 3)) * 3).astype(F32))
    S = q.shape[1]
    plan = knn_cuda.knn_cells_plan(q, p, self_knn, C, TQ)
    assert all(t.is_contiguous() for t in plan)
    keys, qry, boxes, order, lbs = plan
    pts, perm = cells.sort_by_morton(p, (-N) % C)
    qs, qperm = (pts, perm) if self_knn else cells.sort_by_morton(q, (-S) % TQ)
    valid = perm < N
    torch.testing.assert_close(keys[..., :3][valid], pts[valid], atol=0, rtol=0)
    assert torch.isnan(keys[..., :3][~valid]).all() and int((~valid).sum()) == B * ((-N) % C)
    assert torch.equal(keys[..., 3].view(torch.int32), perm)
    assert torch.equal(qry[..., 3].view(torch.int32), qperm)
    if self_knn:
        assert qry is keys
    else:
        assert torch.equal(qry[..., :3], qs)
    lo, hi = cells.chunk_boxes(pts, C, valid)
    assert torch.equal(boxes[:, :, 0, :3], lo) and torch.equal(boxes[:, :, 1, :3], hi)
    assert boxes.shape == (B, -(-N // C), 2, 4) and order.dtype == torch.int32
    qlo, qhi = cells.chunk_boxes(qs, TQ, qperm < S)
    lb = cells.box_lb(qlo, qhi, lo, hi)
    want = expected_order_keys(lb, qlo, qhi, lo, hi, self_knn, C, TQ)
    want_lbs, want_order = torch.sort(want, dim=-1)
    assert torch.equal(lbs, want_lbs) and torch.equal(order, want_order.to(torch.int32))
    walked = torch.gather(lb, -1, order.long())
    assert (walked[..., 1:] >= walked[..., :-1]).all()


def test_route_gate():
    """The pruned kernel: CUDA clouds of >= CELLS_MIN_KEYS keys, no
    valid_n, 2 <= k <= 64; k <= 3 with more queries than keys (PointNet++'s
    many-query 3-NN) from CELLS_MIN_KEYS_FEW keys; never a CPU tensor (knn
    on the CPU is the plain version, whatever the size)."""
    n, nf = knn_cuda.CELLS_MIN_KEYS, knn_cuda.CELLS_MIN_KEYS_FEW
    cloud = lambda m: types.SimpleNamespace(is_cuda=True, shape=(1, m, 3))  # noqa: E731
    big, small, many = cloud(n), cloud(n - 1), cloud(64000)
    gate = knn_cuda.cells_route_ok
    assert gate(big, big, 16) and gate(big, big, 2) and gate(big, big, 64)
    assert gate(big, big, 3) and gate(small, big, 3) and gate(many, big, 4)
    assert not gate(big, big, 1) and not gate(big, big, 65) and not gate(big, small, 16)
    assert not gate(many, big, 3) and not gate(many, big, 2)
    assert not gate(many, cloud(nf - 1), 3) and gate(many, cloud(nf), 3)
    assert not gate(big, big, 16, torch.tensor([n]))
    assert not gate(torch.zeros(1, n, 3), torch.zeros(1, n, 3), 16)


def test_cpu_knn_takes_the_plain_version(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a kernel was launched for CPU tensors")

    monkeypatch.setattr(knn_cuda, "knn_cells_kernel", refuse)
    monkeypatch.setattr(knn_cuda, "knn_kernel", refuse)
    x = torch.from_numpy(np.random.default_rng(730).standard_normal((1, 4096, 3)).astype(F32))
    d, i = knn_cuda.knn(x, x, 4)
    assert i.shape == (1, 4096, 4) and (i[0, :, 0] == torch.arange(4096)).all()
    assert (d[..., 0] == 0).all()


def test_exact_distances_never_farther_than_jax_knn_cells(capsys):
    """At 1,024 points (chunks of 128, 4 chunks a tile of 128, JAX's
    approximate kernel in interpret mode): for every query and rank, the
    exact r-th nearest distance is at most the r-th of JAX's neighbours
    (their distances recomputed exactly); prints the id recall."""
    rng = np.random.default_rng(740)
    x = (rng.standard_normal((1, 1024, 3)) * 3).astype(F32)
    k = 16
    xj = jnp.asarray(x)
    _, jidx = jcells.knn_cells(xj, xj, k, chunk=128, m_chunks=4, tile=128, interpret=True)
    jidx = np.asarray(jidx)[0]
    td, ti = knn_cuda.knn_plain(torch.from_numpy(x), torch.from_numpy(x), k)
    td, ti = td[0].numpy(), ti[0].numpy()
    diff = x[0][jidx] - x[0][:, None, :]
    jd = np.sort((diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
                 + diff[..., 2] * diff[..., 2], axis=1)
    assert (td <= jd).all()
    recall = np.mean([len(set(jidx[q]) & set(ti[q])) / k for q in range(x.shape[1])])
    with capsys.disabled():
        print(f"\nJAX knn_cells id recall against the exact neighbours: {recall:.4f}")
