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
- The segment form (``key_valid``, per-row budgets, ``emit_resi``): the
  emulated walk on the masked plan (invalid keys NaN rows, boxes over the
  valid keys, empty chunks sorted last with a NaN sort key and ending the
  tile's walk, a list of the row's budget) gives ``knn_cells_plain`` bit
  for bit, a starved mask included, and never scans an empty chunk; the F
  masked passes written into their slots give ``fusion_resi_plain`` (the
  fusion's F-segment residual kNN) bit for bit, idx and residuals; the
  masked plan equals a direct computation; ``knn_cells_plain`` with a mask
  is never farther than JAX's ``knn_cells(key_valid=, emit_resi=True)`` in
  interpret mode, and its residuals are ``points[idx] - query``.

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
from pci_tpu_torch.ops.cuda_kernels import fusion_cells_cuda, fusion_knn_cuda, knn_cuda

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


def emulate(query, points, k, chunk=CHUNK, tile=TILE, key_valid=None, budget=None):
    """The kernel's walk for one batch row -> (dist [S, kq], idx [S, kq],
    pairs scanned, empty chunks scanned), kq = k or the row's ``budget``.
    With ``key_valid [N]`` or a budget, the segment form: the masked plan,
    a NaN sort key ends the walk, and a slot with no valid key left is the
    query's own row at distance SENTINEL."""
    q_t, p_t = torch.from_numpy(query)[None], torch.from_numpy(points)[None]
    self_knn = query is points
    seg = key_valid is not None or budget is not None
    kv = None if key_valid is None else torch.from_numpy(key_valid)[None]
    keys, qry, boxes, order, lbs = (t[0].numpy() for t in knn_cuda.knn_cells_plan(
        p_t if self_knn else q_t, p_t, self_knn, chunk, tile, key_valid=kv))
    k = k if budget is None else min(budget, k)
    S = query.shape[0]
    kxyz, kid = keys[:, :3], keys[:, 3].view(np.int32).astype(np.int64)
    qxyz, qid = qry[:, :3], qry[:, 3].view(np.int32)
    out_d = np.zeros((S, k), F32)
    out_i = np.zeros((S, k), np.int64)
    scanned = empty = 0
    if k == 0:  # a budget of 0: the row returns at once
        return out_d, out_i, scanned, empty
    for t in range(order.shape[0]):
        rows = np.arange(t * tile, (t + 1) * tile)
        real = qid[rows] < S
        q = qxyz[rows]
        dl = np.full((tile, k), np.inf, F32)
        il = np.full((tile, k), IMAX, np.int64)
        for m in range(order.shape[1]):
            thd = dl[:, -1]
            done = ~real | (lbs[t, m] > thd * F32(1.00001) + F32(1e-30))
            if seg:
                done |= np.isnan(lbs[t, m])
            if done.all():
                break
            c = order[t, m]
            need = ~done & (box_bound_rd(boxes[c, 0, :3], boxes[c, 1, :3], q) <= thd)
            if not need.any():
                continue
            scanned += int(need.sum()) * chunk
            empty += int(np.isnan(kxyz[c * chunk:(c + 1) * chunk]).all())
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
        if seg:  # no valid key left: the query's own row
            none = il == IMAX
            dl = np.where(none, F32(knn_cuda.SENTINEL), dl)
            il = np.where(none, qid[rows].astype(np.int64)[:, None], il)
        out_d[qid[rows][real]] = dl[real]
        out_i[qid[rows][real]] = il[real]
    return out_d, out_i, scanned, empty


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
    got_d, got_i, scanned, _ = emulate(query, points, k)
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


# ---- the segment form: key_valid, budgets, emit_resi -----------------------------


def key_mask(name, n, seed):
    """A ``[n]`` key mask: ``half`` random, ``segment`` a contiguous 30% of
    the original rows (a fusion segment), ``starved`` 10 keys."""
    rng = np.random.default_rng(seed)
    if name == "half":
        return rng.random(n) < 0.5
    if name == "segment":
        m = np.zeros(n, bool)
        m[n // 5:n // 5 + 3 * n // 10] = True
        return m
    m = np.zeros(n, bool)
    m[rng.choice(n, 10, replace=False)] = True
    return m


@pytest.mark.parametrize("budget", [None, 5])
@pytest.mark.parametrize("mask", ["half", "segment", "starved"])
@pytest.mark.parametrize("name", ["gaussian", "flow_like", "one_cell"])
def test_emulated_masked_walk_gives_plain_neighbours(name, mask, budget):
    """On the masked plan, with k = 16 or a row budget of 5: indices and
    distances bit-equal to knn_cells_plain over the valid keys (the
    starved mask's slots past its 10 keys are the query's own row at
    SENTINEL); no chunk without a valid key is ever scanned, and a segment
    mask scans a fraction of the pairs."""
    query, points = case(name, 760 + ["gaussian", "flow_like", "one_cell"].index(name))
    kv = key_mask(mask, points.shape[0], 770 + len(mask))
    k = 16
    got_d, got_i, scanned, empty = emulate(query, points, k, key_valid=kv, budget=budget)
    x = torch.from_numpy(points)[None]
    want_d, want_i = knn_cuda.knn_cells_plain(x, x, k if budget is None else budget,
                                              torch.from_numpy(kv)[None])
    np.testing.assert_array_equal(got_i, want_i[0].numpy())
    np.testing.assert_array_equal(got_d, want_d[0].numpy())
    assert empty == 0
    if mask == "starved":
        assert (got_d[:, 10:] == F32(knn_cuda.SENTINEL)).all()
        assert (got_i[:, 10:] == np.arange(len(points))[:, None]).all()
    frac = scanned / (query.shape[0] * points.shape[0])
    print(f"{name} {mask} budget={budget}: {frac:.3f} of the pairs scanned")
    if mask == "segment" and name != "one_cell":
        assert frac < 0.5


def emulate_segments(x, ends, budgets, k):
    """csrc/knn_cells.cu's F masked passes of one row written into their
    slots, as ``fusion_cells_multi_knn`` launches them -> (idx [N, k],
    resi [N, k, 3]): pass f over the keys of rows [end_{f-1}, end_f),
    pruned against its capped budget, into slots [col0_f, col0_f + cap_f);
    the last pass fills the slots past every budget with the row itself."""
    N = x.shape[0]
    caps, col0 = (t[0].numpy() for t in fusion_cells_cuda.segment_slots(
        torch.tensor([budgets]), k))
    idx = np.full((N, k), -1, np.int64)
    start = 0
    for f, end in enumerate(ends):
        kv = (np.arange(N) >= start) & (np.arange(N) < end)
        _, i, _, empty = emulate(x, x, k, key_valid=kv, budget=int(caps[f]))
        assert empty == 0
        idx[:, col0[f]:col0[f] + caps[f]] = i
        start = max(start, end)
    idx[:, int(col0[-1] + caps[-1]):] = np.arange(N)[:, None]
    assert (idx >= 0).all()
    return idx, x[idx] - x[:, None, :]


SEGMENTS = {  # (ends, budgets) at k = 64 on 2,048 points
    "wnet": ([192, 384, 2048], [5, 5, 54]),
    "starved": ([40, 1024, 2048], [54, 0, 10]),
    "zero_first": ([0, 1024, 2048], [0, 32, 32]),
    "even": ([704, 1376, 2048], [21, 21, 22]),
}


@pytest.mark.parametrize("name", list(SEGMENTS))
def test_emulated_segment_passes_give_the_residual_knn(name):
    """The F = 3 masked passes with emit_resi, each at its own budget and
    written into its slots, equal fusion_resi_plain's idx and residuals bit
    for bit: Wnet-like budgets (5/5/54), a segment of 40 keys under a
    budget of 54 with a budget of 0 beside it, an empty first segment, and
    even budgets."""
    rng = np.random.default_rng(780 + list(SEGMENTS).index(name))
    x = (rng.standard_normal((2048, 3)) * 5).astype(F32)
    ends, budgets = SEGMENTS[name]
    got_i, got_r = emulate_segments(x, ends, budgets, 64)
    want_i, want_r = fusion_knn_cuda.fusion_resi_plain(
        torch.from_numpy(x)[None], torch.tensor([ends]), torch.tensor([budgets]), 64)
    np.testing.assert_array_equal(got_i, want_i[0].numpy())
    np.testing.assert_array_equal(got_r, want_r[0].numpy())
    # on the CPU the route is the plain version, the same function
    for g, w in zip(fusion_cells_cuda.fusion_cells_multi_knn(
            torch.from_numpy(x)[None], torch.tensor([ends]), torch.tensor([budgets]), 64),
            (want_i, want_r)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [1000, 1024])
def test_masked_plan_equals_direct_computation(n):
    """The masked self plan: invalid keys are NaN rows (their ids kept),
    qry keeps every query's coordinates, the chunk boxes cover the valid
    keys only, the tiles' boxes every real query, and each tile's order is
    the sort of the box bounds (nearest first below 0) with the chunks that
    hold no valid key last, their sort key NaN."""
    rng = np.random.default_rng(790 + n)
    B, N, C, TQ = 2, n, CHUNK, TILE
    p = torch.from_numpy((rng.standard_normal((B, N, 3)) * 3).astype(F32))
    kv = torch.zeros(B, N, dtype=torch.bool)
    kv[0, 100:400] = True  # a segment
    kv[1] = torch.from_numpy(rng.random(N) < 0.05)
    keys, qry, boxes, order, lbs = knn_cuda.knn_cells_plan(p, p, True, C, TQ, key_valid=kv)
    pts, perm = cells.sort_by_morton(p, (-N) % C)
    real = perm < N
    valid = real & torch.gather(kv, 1, perm.clamp(max=N - 1).long())
    assert torch.equal(keys[..., :3][valid], pts[valid]) and torch.isnan(keys[..., :3][~valid]).all()
    assert torch.equal(keys[..., 3].view(torch.int32), perm)
    assert qry is not keys and torch.equal(qry[..., :3], pts)
    assert torch.equal(qry[..., 3].view(torch.int32), perm)
    lo, hi = cells.chunk_boxes(pts, C, valid)
    assert torch.equal(boxes[:, :, 0, :3], lo) and torch.equal(boxes[:, :, 1, :3], hi)
    qlo, qhi = cells.chunk_boxes(pts, TQ, real if N % C else None)
    lb = cells.box_lb(qlo, qhi, lo, hi)
    own = torch.arange(lb.shape[1])[:, None] // (C // TQ)
    near = -1.0 / (1.0 + (torch.arange(lb.shape[2])[None, :] - own).abs().float())
    empty = ~valid.reshape(B, -1, C).any(-1)
    want = torch.where(empty[:, None, :], float("nan"), torch.where(lb > 0, lb, near))
    want_lbs, want_order = torch.sort(want, dim=-1)
    assert torch.equal(order, want_order.to(torch.int32))
    torch.testing.assert_close(lbs, want_lbs, atol=0, rtol=0, equal_nan=True)
    n_empty = int(empty.sum(-1)[1])
    assert n_empty > 0 and torch.isnan(lbs[1, :, -n_empty:]).all()


def test_masked_distances_never_farther_than_jax_knn_cells():
    """At 1,024 points with a segment mask (JAX's key_valid, emit_resi,
    interpret mode, chunks of 128, 4 a tile of 128): the exact masked
    distances are never farther, slot by slot, than JAX's (recomputed
    exactly from its indices) where JAX found a valid key, every exact
    neighbour is valid, the residuals equal points[idx] - query, and
    where the segment holds fewer keys than k both give sentinels."""
    rng = np.random.default_rng(795)
    x = (rng.standard_normal((1, 1024, 3)) * 3).astype(F32)
    k = 16
    for lo, hi in ((300, 700), (1000, 1010)):
        kv = np.zeros((1, 1024), bool)
        kv[0, lo:hi] = True
        xj = jnp.asarray(x)
        jd, jidx, jres = jcells.knn_cells(xj, xj, k, chunk=128, m_chunks=4, tile=128,
                                          emit_resi=True, key_valid=jnp.asarray(kv),
                                          interpret=True)
        jd, jidx = np.asarray(jd)[0], np.asarray(jidx)[0]
        xt = torch.from_numpy(x)
        td, ti, tr = (t[0].numpy() for t in knn_cuda.knn_cells_plain(
            xt, xt, k, torch.from_numpy(kv), emit_resi=True))
        np.testing.assert_array_equal(tr, x[0][ti] - x[0][:, None, :])
        sent = td == F32(knn_cuda.SENTINEL)
        assert kv[0][ti[~sent]].all()
        assert (jd[sent] > 1e29).all()
        jfound = jd <= 1e29
        diff = x[0][jidx] - x[0][:, None, :]
        jexact = np.where(jfound, (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
                          + diff[..., 2] * diff[..., 2], np.inf)
        jexact = np.sort(jexact, axis=1)
        assert (td[~sent] <= jexact[~sent]).all()
        if hi - lo < k:
            assert sent[:, hi - lo:].all() and not sent[:, :hi - lo].any()


def test_knn_self_resi_and_the_transformer_route_equal_the_gather(monkeypatch):
    """ops.knn_self_resi on its box-pruned branch (eligibility patched on
    for the CPU cloud; the kernel's plain version here) gives the indices
    and residuals of knn and the gather bit for bit, and TransformerLayer's
    large-cloud route (delta = -resi) gives the gather route's rows bit for
    bit; under a gradient into xyz the layer keeps the gather."""
    import importlib

    from pci_tpu_torch import ops
    from pci_tpu_torch.nn import transformer as ttr

    mknn = importlib.import_module("pci_tpu_torch.ops.knn")
    rng = np.random.default_rng(798)
    x = torch.from_numpy(flow_like(rng, 2048))[None]
    feats = torch.from_numpy(rng.standard_normal((1, 2048, 8)).astype(F32))
    k = 16
    _, want_i = knn_cuda.knn(x, x, k)
    want_r = ops.index_points(x, want_i) - x[:, :, None, :]
    torch.manual_seed(799)
    layer = ttr.TransformerLayer(8, 16, k).eval()
    with torch.no_grad():
        want_out, _ = layer(x, feats)
    calls = []
    monkeypatch.setattr(mknn, "cells_eligible", lambda p, kk: True)
    monkeypatch.setattr(ttr, "cells_eligible", lambda p, kk: True)
    monkeypatch.setattr(ttr, "knn_self_resi", lambda p, kk: calls.append(kk) or
                        mknn.knn_self_resi(p, kk))
    got_i, got_r = ops.knn_self_resi(x, k)
    assert torch.equal(got_i, want_i) and torch.equal(got_r, want_r)
    assert torch.equal(-got_r, x[:, :, None, :] - ops.index_points(x, want_i))
    with torch.no_grad():
        got_out, _ = layer(x, feats)
    assert calls == [k] and torch.equal(got_out, want_out)
    xg = x.clone().requires_grad_()
    out, _ = layer(xg, feats)
    out.sum().backward()
    assert calls == [k] and xg.grad is not None
