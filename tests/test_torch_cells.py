"""The port's cell-pruned fusion (``pci_tpu_torch/ops/cells.py`` and
``ops/cuda_kernels/fusion_cells_cuda.py``) against the JAX package, on CPU.

- The Morton codes, the sort permutation, the chunk boxes and the box
  bounds equal ``pci_tpu/ops/pallas_kernels/knn_cells_tpu.py``'s exactly,
  pad rows included.
- A numpy emulation of csrc/fusion_cells.cu's scan (each query walks its
  tile's chunk order, stops on the tile bound, skips a chunk by its
  round-down box bound) gives the plain version's neighbours exactly, and
  skips chunks.
- The port's ``PointsFusion`` on the cells route (its gate patched on, the
  plain versions on the CPU) against JAX's ``PointsFusion`` (its exact XLA
  route on the CPU) with the same permutations, each mode reaching its
  cells entry point: 1e-5 in eval; in training (fused rows, and gradients
  into both clouds) as close to JAX as the flat route is.
- Against JAX's own cells kernel in interpret mode at its test config: the
  port's exact distances are never farther, slot by slot.

Inputs come from numpy with a fixed seed per test.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pci_tpu.nn.fusion as jfusion
import pci_tpu_torch.nn.fusion as tfusion
from pci_tpu.ops.pallas_kernels import knn_cells_tpu as jcells
from pci_tpu.ops.pallas_kernels.fusion_cells_tpu import knn_fusion_cells
from pci_tpu_torch.convert import flax_to_state_dict
from pci_tpu_torch.nn import PointsFusion
from pci_tpu_torch.ops import cells
from pci_tpu_torch.ops.cuda_kernels import fusion_cells_cuda, fusion_knn_cuda

torch.set_num_threads(2)

J, T = jnp.asarray, torch.from_numpy
F64, F32 = np.float64, np.float32
IMAX = 0x7FFFFFFF


def cloud(rng, b, n, scale=1.0):
    return (rng.standard_normal((b, n, 3)) * scale).astype(F32)


# ---- the Morton sort and the boxes -----------------------------------------


@pytest.mark.parametrize("n,chunk,tile", [(1000, 128, 64), (2048, 256, 64), (777, 128, 128)])
def test_morton_sort_and_boxes_equal_jax(n, chunk, tile):
    """Codes, stable sort (pads at +1e15 with id N), per-segment chunk
    boxes with the valid mask, tile boxes and their bounds: bit-equal."""
    rng = np.random.default_rng(600 + n)
    x = cloud(rng, 2, n, 3.0)
    x[0, :7] = x[0, 40:47]  # duplicates: equal codes keep their order
    np.testing.assert_array_equal(cells.morton_codes(T(x)).numpy(),
                                  np.asarray(jcells.morton_codes(J(x))))
    pad = (-n) % chunk
    jp, jperm = jcells._sort_by_morton(J(x), pad)
    tp, tperm = cells.sort_by_morton(T(x), pad)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    perm = np.asarray(jperm)
    split = np.array([n // 3, n // 2])[:, None]
    for valid in (perm < n, (perm < split), (perm >= split) & (perm < n)):
        jlo, jhi = jcells._chunk_boxes(jp, chunk, J(valid))
        tlo, thi = cells.chunk_boxes(tp, chunk, T(valid))
        np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
        jq = jcells._chunk_boxes(jp, tile, J(perm < n))
        tq = cells.chunk_boxes(tp, tile, T(perm < n))
        np.testing.assert_array_equal(cells.box_lb(*tq, tlo, thi).numpy(),
                                      np.asarray(jcells._box_lb(*jq, jlo, jhi)))


# ---- the kernel's scan, emulated -------------------------------------------


def rd32(x):
    """float64 values rounded down to float32 (CUDA's __f*_rd): the float64
    sum, difference or product of two float32 values here is exact."""
    x = np.asarray(x, F64)
    with np.errstate(over="ignore"):  # an empty box's 1e60 rounds down to FLT_MAX
        r = x.astype(F32)
    up = r.astype(F64) > x
    r[up] = np.nextafter(r[up], F32(-np.inf))
    return r


def box_bound_rd(lo, hi, q):
    """csrc/fusion_cells.cu:box_bound_rd for queries ``q [n, 3]``."""
    g = np.maximum(F32(0), np.maximum(rd32(lo.astype(F64) - q), rd32(q.astype(F64) - hi)))
    sq = rd32(g.astype(F64) * g)
    return rd32(rd32(sq[:, 0].astype(F64) + sq[:, 1]).astype(F64) + sq[:, 2])


def sqd(keys, q):
    """sqdist3: (dx*dx + dy*dy) + dz*dz, each op rounded, ``[n, C]``."""
    d = [keys[None, :, c] - q[:, None, c] for c in range(3)]
    return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]


def merge(dl, il, d, i, cap):
    """Keep the ``cap`` least (distance, index) of the list and candidates."""
    dc, ic = np.concatenate([dl, d], 1), np.concatenate([il, i], 1)
    o = np.lexsort((ic, dc), axis=1)[:, :cap]
    return np.take_along_axis(dc, o, 1), np.take_along_axis(ic, o, 1)


def emulate(x, split, k1, k2, chunk, tile):
    """The kernel's scan for one batch row ``x [N, 3]`` -> (idx [N, k1 + k2]
    by original row, unfilled slots the row itself; chunks skipped inside
    the stop bound; pairs scanned)."""
    N = x.shape[0]
    keys, ids, boxes, order, lbs = (t[0].numpy() for t in fusion_cells_cuda.cells_plan(
        T(x)[None], torch.tensor([split]), chunk, tile))
    Np = keys.shape[1]
    out = np.zeros((N, k1 + k2), np.int64)
    skipped = scanned = 0
    for t in range(Np // tile):
        s = np.arange(t * tile, (t + 1) * tile)
        s = s[ids[s] < N]
        if not len(s):
            continue
        q = keys[:, s].T
        lists = [[np.full((len(s), kk), np.inf, F32), np.full((len(s), kk), IMAX, np.int64)]
                 for kk in (k1, k2)]
        live = np.ones(len(s), bool)
        for m in range(order.shape[1]):
            thd = [lst[0][:, -1] if kk else np.full(len(s), -np.inf, F32)
                   for lst, kk in zip(lists, (k1, k2))]
            T_ = np.maximum(thd[0], thd[1])
            live &= ~(lbs[t, m] > T_ * F32(1.00001) + F32(1e-30))
            c = order[t, m]
            need = []
            for seg, kk in ((0, k1), (1, k2)):
                lo, hi = boxes[c, 2 * seg, :3], boxes[c, 2 * seg + 1, :3]
                need.append(live & (kk > 0) & (lo[0] <= hi[0])
                            & (box_bound_rd(lo, hi, q) <= thd[seg]))
            skipped += int((live & ~need[0] & ~need[1]).sum())
            scan = need[0] | need[1]
            scanned += int(scan.sum()) * chunk
            kid = ids[c * chunk:(c + 1) * chunk].astype(np.int64)
            d = sqd(keys[:, c * chunk:(c + 1) * chunk].T, q)
            for seg, kk in ((0, k1), (1, k2)):
                if not kk:
                    continue
                inseg = (kid < split) if seg == 0 else (kid >= split) & (kid < N)
                ok = need[seg][:, None] & inseg[None, :]
                lists[seg] = merge(*lists[seg], np.where(ok, d, np.inf),
                                   np.where(ok, kid[None, :], IMAX), kk)
        il = np.concatenate([lists[0][1], lists[1][1]], 1)
        own = ids[s].astype(np.int64)[:, None]
        out[ids[s]] = np.where(il == IMAX, own, il)
    return out, skipped, scanned


def grid16(x):
    return (np.round(x * 16) / 16).astype(F32)


def case(name, seed):
    """(cloud [N, 3], split, k1, k2) of a named case, from its own seed."""
    rng = np.random.default_rng(seed)
    if name == "gauss":
        return cloud(rng, 1, 2048, 10.0)[0], 1024, 16, 16
    if name == "gauss_t02":
        return cloud(rng, 1, 2048, 10.0)[0], 1632, 26, 6
    if name == "far_tiny_b":  # tests/test_layers.py:1147-1171
        x = cloud(rng, 1, 1024, 2.0)[0]
        x[960:] = x[960:] * 0.1 + 80.0
        return x, 960, 5, 3
    if name == "split_0":
        return cloud(rng, 1, 1024, 3.0)[0], 0, 0, 32
    if name == "split_n":
        return cloud(rng, 1, 1024, 3.0)[0], 1024, 32, 0
    if name == "duplicates":
        x = cloud(rng, 1, 2048, 3.0)[0]
        x[1024:] = x[:1024]
        x[100:164] = x[0]
        return x, 1024, 16, 16
    if name == "grid16":
        return grid16(cloud(rng, 1, 1536, 0.6)[0]), 768, 20, 12
    # k = 64 (the kernel's k <= 64 instantiation: the list pairs (32, 32),
    # (64, 16), (48, 32), (32, 48), (16, 64) by the budgets)
    if name == "gauss_k64":
        return cloud(rng, 1, 2048, 10.0)[0], 1024, 32, 32
    if name == "gauss_k64_t02":
        return cloud(rng, 1, 2048, 10.0)[0], 1632, 52, 12
    if name == "grid16_k64":
        return grid16(cloud(rng, 1, 1536, 0.6)[0]), 384, 20, 44
    if name == "far_tiny_b_k64":
        x = cloud(rng, 1, 1024, 2.0)[0]
        x[960:] = x[960:] * 0.1 + 80.0
        return x, 960, 58, 6
    raise ValueError(name)


CASES = ["gauss", "gauss_t02", "far_tiny_b", "split_0", "split_n", "duplicates", "grid16",
         "gauss_k64", "gauss_k64_t02", "grid16_k64", "far_tiny_b_k64"]


@pytest.mark.parametrize("chunk,tile", [(fusion_cells_cuda.CHUNK, fusion_cells_cuda.TILE),
                                        (64, 32)])
@pytest.mark.parametrize("name", CASES)
def test_emulated_scan_gives_plain_neighbours(name, chunk, tile):
    """The emulated scan's slots equal the plain version's exactly; where
    the budgets are not starved it skipped chunks inside its stop bound
    and scanned a fraction of the pairs."""
    seed = 610 + CASES.index(name)
    x, split, k1, k2 = case(name, seed)
    N = x.shape[0]
    got, skipped, scanned = emulate(x, split, k1, k2, chunk, tile)
    want, _ = fusion_cells_cuda.fusion_cells_plain(
        T(x)[None], torch.tensor([[split, N]]), torch.tensor([[k1, k2]]), k1 + k2)
    np.testing.assert_array_equal(got, want[0].numpy())
    print(f"{name} chunk={chunk}: {skipped} chunks skipped, {scanned / N / N:.3f} of the pairs")
    if name in ("gauss", "gauss_t02", "grid16", "gauss_k64", "gauss_k64_t02") and chunk == 64:
        assert skipped > 0 and scanned < 0.6 * N * N


# ---- PointsFusion on the cells route against JAX's -------------------------


def jax_fusion(monkeypatch, rng, N, t, train):
    """JAX PointsFusion at N with its draws replaced by numpy permutations;
    returns (variables, inputs, perms, apply(p1, p2) -> (out, new state))."""
    a = cloud(rng, 1, N, 2.0)
    b = a + 0.2 * cloud(rng, 1, N)
    perms = [rng.permutation(N)[None].astype(np.int32) for _ in range(2)]
    tt = np.array([t], F32)
    jmod = jfusion.PointsFusion((64, 64, 128))
    v = jmod.init({"params": jax.random.key(0), "sample": jax.random.key(1)},
                  J(a), J(b), 32, J(tt))
    v = jax.tree_util.tree_map(  # non-trivial BatchNorm statistics
        lambda x: x + 0.01 * jnp.arange(x.size, dtype=x.dtype) if x.ndim == 1 else x, v)

    def apply(p1, p2, k=32):
        draws = iter([J(p) for p in perms])
        monkeypatch.setattr(jfusion, "_random_perms", lambda key, B, n: next(draws))
        kw = dict(train=True, mutable=["batch_stats"]) if train else {}
        return jmod.apply(v, p1, p2, k, J(tt), rngs={"sample": jax.random.key(2)}, **kw)

    # one compiled call a use (the draws are its constants)
    return v, (a, b, tt), perms, jax.jit(apply, static_argnums=2)

    return v, (a, b, tt), perms, apply


@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("t", [0.2, 0.5])
@pytest.mark.parametrize("mode", ["eval_oneshot", "eval_two_kernels", "train"])
def test_points_fusion_cells_route_matches_jax(monkeypatch, mode, t, k):
    """``PointsFusion.forward``'s cells branches (the one-shot entry point
    in eval; the residual entry point, then the attention tail in eval or
    the BatchNorm head in training) reach the cells wrappers and compose
    their output into JAX's rows, at k = 32 and 64 (PointINet2's rings, the
    cells route's k <= 64 since it matches the JAX gate).  Eval: fused rows
    within 1e-5 of JAX's.
    Training (BatchNorm on the batch's statistics), also the gradients of
    a fixed random projection of the rows into both clouds: within 1e-4
    (rows) and 2e-3 of the largest gradient of JAX's, the flat route's own
    distance from JAX in training (the batch statistics of 32,768 rows sum
    in another order: rows 5.5e-5 apart, gradients up to 5.9e-4 of the
    largest, at these seeds)."""
    monkeypatch.setattr(tfusion, "_cells_route_ok", lambda points, k, train, n_seg=2: True)
    monkeypatch.setattr(tfusion, "_fusion_oneshot_ok",
                        lambda train, x: mode == "eval_oneshot" and not train)
    reached = []
    for name in ("fusion_cells_attention", "fusion_cells_resi_knn"):
        fn = getattr(tfusion, name)
        monkeypatch.setattr(tfusion, name, lambda *a, _fn=fn, _name=name, **kw:
                            reached.append(_name) or _fn(*a, **kw))
    rng = np.random.default_rng(630 + int(10 * t) + 3 * ["eval_oneshot", "eval_two_kernels",
                                                         "train"].index(mode) + (k > 32) * 20)
    N = 1024
    v, (a, b, tt), perms, apply = jax_fusion(monkeypatch, rng, N, t, mode == "train")
    mod = PointsFusion()
    mod.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, v)))
    tp = tuple(T(p) for p in perms)
    entry = "fusion_cells_attention" if mode == "eval_oneshot" else "fusion_cells_resi_knn"
    if mode != "train":
        want = np.asarray(apply(J(a), J(b), k))
        with torch.inference_mode():
            got = mod.eval()(T(a), T(b), k, T(tt), perms=tp).numpy()
        assert reached == [entry]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        return
    G = cloud(rng, 1, N)
    loss = lambda p1, p2: jnp.sum(apply(p1, p2, k)[0] * J(G))  # noqa: E731
    want = [np.asarray(apply(J(a), J(b), k)[0]),
            *map(np.asarray, jax.jit(jax.grad(loss, argnums=(0, 1)))(J(a), J(b)))]
    ta, tb = T(a).requires_grad_(), T(b).requires_grad_()
    got = mod.train()(ta, tb, k, T(tt), perms=tp)
    (got * T(G)).sum().backward()
    assert reached == [entry]
    np.testing.assert_allclose(got.detach().numpy(), want[0], atol=1e-4, rtol=0)
    for g, w in zip((ta.grad.numpy(), tb.grad.numpy()), want[1:]):
        np.testing.assert_allclose(g, w, atol=2e-3 * np.abs(w).max(), rtol=0)


@pytest.mark.parametrize("B", [1, 2])
def test_cells_plan_layout(B):
    """The plan the kernel reads by raw pointer: contiguous tensors of the
    documented shapes and types, boxes row by row (lo A, hi A, lo B, hi B)
    equal to chunk_boxes over each segment's keys."""
    rng = np.random.default_rng(660 + B)
    N = 1000
    x = T(cloud(rng, B, N, 2.0))
    split = torch.tensor([400, 700][:B])
    plan = fusion_cells_cuda.cells_plan(x, split)
    keys, ids, boxes, order, lbs = plan
    Np, C = 1024, fusion_cells_cuda.CHUNK
    assert all(t.is_contiguous() for t in plan)
    assert keys.shape == (B, 3, Np) and ids.shape == (B, Np) and ids.dtype == torch.int32
    assert boxes.shape == (B, Np // C, 4, 4)
    assert order.shape == lbs.shape == (B, Np // fusion_cells_cuda.TILE, Np // C)
    assert order.dtype == torch.int32
    pts = keys.transpose(1, 2)
    for b in range(B):
        a = (ids[b] < split[b])
        for row, valid in ((0, a), (2, ~a & (ids[b] < N))):
            lo, hi = cells.chunk_boxes(pts[b:b + 1], C, valid[None])
            torch.testing.assert_close(boxes[b, :, row, :3], lo[0], atol=0, rtol=0)
            torch.testing.assert_close(boxes[b, :, row + 1, :3], hi[0], atol=0, rtol=0)


def test_cells_route_gate():
    """The cells route: a CUDA tensor of >= 32,768 points, k <= 64 (the
    JAX gate, pci_tpu/nn/fusion.py:167-173); in training two segments only;
    never a CPU tensor."""
    import types

    big = types.SimpleNamespace(is_cuda=True, shape=(1, 32768, 3))
    small = types.SimpleNamespace(is_cuda=True, shape=(1, 32767, 3))
    gate = tfusion._cells_route_ok
    assert gate(big, 32, False) and gate(big, 32, True)
    assert gate(big, 33, False) and gate(big, 64, False) and gate(big, 64, True)
    assert not gate(small, 32, False) and not gate(big, 65, False)
    assert gate(big, 32, False, n_seg=3) and not gate(big, 32, True, n_seg=3)
    assert gate(big, 64, False, n_seg=3) and not gate(big, 64, True, n_seg=3)
    assert not gate(torch.zeros(1, 32768, 3), 32, False)


# ---- against JAX's approximate cells kernel --------------------------------


def test_exact_distances_never_farther_than_jax_cells_kernel(capsys):
    """At JAX's own test config (N=512, chunk 128, m_chunks 4, bucket 2,
    winners 2, tile 128): within each segment's block, the port's k-th
    nearest distance is at most JAX's k-th (its kernel picks from a subset
    of the keys), + 1e-6 for JAX's packed-key order; prints the id recall."""
    rng = np.random.default_rng(640)
    N, k = 512, 8
    x = cloud(rng, 1, N, 3.0)
    recalls = []
    for split, k1 in ((256, 5), (384, 3), (0, 0), (N, k)):
        jidx, jresi = knn_fusion_cells(J(x), J(np.array([split], np.int32)),
                                       J(np.array([k1], np.int32)), k, 128, 4, 2, 2, 128,
                                       True, True)
        tidx, tresi = fusion_cells_cuda.fusion_cells_resi_knn(
            T(x), torch.tensor([[split, N]]), torch.tensor([[k1, k - k1]]), k)
        jd = (np.asarray(jresi)[0] ** 2).sum(-1)
        td = (tresi[0].numpy() ** 2).sum(-1)
        for lo, hi in ((0, k1), (k1, k)):
            assert (td[:, lo:hi] <= np.sort(jd[:, lo:hi], 1).astype(F64) + 1e-6).all()
        ji, ti = np.asarray(jidx)[0], tidx[0].numpy()
        recalls.append(np.mean([len(set(ji[q]) & set(ti[q])) / k for q in range(N)]))
    with capsys.disabled():
        print(f"\nJAX cells kernel id recall against the exact neighbours: {recalls}")


def test_cells_plain_is_the_flat_function():
    """fusion_cells_plain and the two entry points compute the flat
    versions' function (one-shot rows and the residual kNN)."""
    rng = np.random.default_rng(650)
    x = T(cloud(rng, 1, 700, 2.0))
    seg, bud = torch.tensor([[300, 700]]), torch.tensor([[20, 12]])
    layers = [(torch.from_numpy((rng.standard_normal((o, i)) / np.sqrt(i)).astype(F32)),
               torch.from_numpy((0.1 * rng.standard_normal(o)).astype(F32)))
              for i, o in ((4, 64), (64, 64), (64, 128))]
    with torch.no_grad():
        torch.testing.assert_close(
            fusion_cells_cuda.fusion_cells_attention(x, seg, bud, layers, 32),
            fusion_knn_cuda.knn_fusion_attention(x, seg, bud, layers, 32), atol=0, rtol=0)
    for got, want in zip(fusion_cells_cuda.fusion_cells_resi_knn(x, seg, bud, 32),
                         fusion_knn_cuda.fusion_resi_knn(x, seg, bud, 32)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
