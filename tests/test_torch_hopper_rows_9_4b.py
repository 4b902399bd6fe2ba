"""The redesigned ball query (csrc/ball.cu) and residual fusion kNN
(csrc/fusion_knn.cu ``fusion_resi_kernel``) held on the CPU, where neither
kernel runs: the rules their designs rest on, and their wrappers.

- A numpy emulation of the ball query's two phases (one scan a query over
  the first PREFIX keys; the queries still short of K as tasks of RANGE
  keys, each keeping at most K - (prefix hits) of its own range's hits,
  taken in any order; the merge, in range order, by whoever finishes a
  query's last task) gives ``ball_plain``'s indices exactly, and JAX's
  ``ball_query_multi``'s on grid clouds (exact distances by both
  formulas), with outliers, empty balls and N ragged against the phases.
- A numpy emulation of the residual kernel's scan (the segments one after
  another; a segment's keys split over 1, 2 or 4 parts that advance 32
  keys at a time, each marking keys below its own k-th and at most the
  other parts' published k-th by the kernel's three-FMA form with its
  margin, checked to be a superset of the exact test at every batch,
  inserting with a strict ``<``; part 0
  merging the other lists by (distance, index)) gives
  ``fusion_resi_plain``'s idx and resi exactly, and the JAX package's
  exact XLA route (``tests/test_torch_train.py:jax_resi_route``), at F = 1
  to 4, a budget past 16, a segment shorter than its budget and duplicated
  points.
- Both wrappers on a stub kernel library (the CUDA route forced): their
  launch arguments, their scratch and stamps, and the outputs the stub
  writes assembled into the returned tensors.

chip_smoke.py holds the kernels themselves against their plain versions on
the card."""

from __future__ import annotations

import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pci_tpu import ops as jops
from pci_tpu_torch.ops.cuda_kernels import _build, ball_cuda, fusion_knn_cuda
from tests.test_torch_train import jax_resi_route

F32 = np.float32
T, J = torch.from_numpy, jnp.asarray


def sqd(keys: np.ndarray, q: np.ndarray) -> np.ndarray:
    """``(dx*dx + dy*dy) + dz*dz`` in fp32, every operation rounded on its
    own (csrc/common.cuh sqdist3)."""
    d = (keys - q).astype(F32)
    return ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]).astype(F32)


def grid_cloud(rng, b, n, scale=1.0):
    """Coordinates on a 1/64 grid: squared distances are exact in fp32 by
    both the direct and the JAX package's expanded formula."""
    return (np.round(rng.standard_normal((b, n, 3)) * scale * 64) / 64).astype(F32)


# ---- row 9: the ball query's prefix, tasks and merge ------------------------------


def emulate_ball(xyz, q, radii, ks, prefix, span, seed):
    """The two phases of csrc/ball.cu with a prefix of ``prefix`` keys and
    tasks of ``span`` keys, the tasks run in a random order; returns one
    ``[B, S, K]`` int64 array a scale and the listed queries."""
    B, N, _ = xyz.shape
    S = q.shape[1]
    r2 = [F32(float(r) ** 2) for r in radii]
    outs = [np.full((B, S, K), -7, np.int64) for K in ks]
    n0 = min(prefix, N)
    listed = []  # (b, s, prefix hits a scale)
    for b in range(B):
        for s in range(S):
            d = sqd(xyz[b, :n0], q[b, s])
            c0 = []
            for out, r, K in zip(outs, r2, ks):
                hits = np.nonzero(d <= r)[0][:K]
                out[b, s, :len(hits)] = hits
                c0.append(len(hits))
            if all(c >= K for c, K in zip(c0, ks)):
                continue
            if N <= prefix:
                for out, c, K in zip(outs, c0, ks):
                    out[b, s, c:] = out[b, s, 0] if c else N - 1
            else:
                listed.append((b, s, c0))
    nr = -(-(N - prefix) // span) if N > prefix else 0
    rec = {}
    arrivals = [0] * len(listed)
    tasks = [(u, r) for u in range(len(listed)) for r in range(nr)]
    for i in np.random.default_rng(seed).permutation(len(tasks)):
        u, r = tasks[i]
        b, s, c0 = listed[u]
        lo = prefix + r * span
        d = sqd(xyz[b, lo:min(N, lo + span)], q[b, s])
        # a range keeps at most what any merge can take from it
        rec[u, r] = [lo + np.nonzero(d <= r2_)[0][:K - c] for r2_, K, c in zip(r2, ks, c0)]
        arrivals[u] += 1
        if arrivals[u] == nr:  # the query's last task merges it
            for si, (out, K) in enumerate(zip(outs, ks)):
                c = c0[si]
                for rr in range(nr):
                    take = rec[u, rr][si][:K - c]
                    out[b, s, c:c + len(take)] = take
                    c += len(take)
                out[b, s, c:] = out[b, s, 0] if c else N - 1
    return outs, listed


BALL_CASES = {
    # name: (B, N, S, radii, ks, prefix, span)
    "small_phases": (2, 700, 40, (0.3, 0.6), (16, 32), 64, 48),
    "ragged": (1, 333, 9, (0.25, 0.5, 0.75), (4, 8, 24), 100, 37),
    "kernel_phases": (1, 5001, 6, (0.2, 0.5), (16, 32), ball_cuda.PREFIX, ball_cuda.RANGE),
}


@pytest.mark.parametrize("name", list(BALL_CASES))
def test_emulated_ball_phases_give_plain_and_jax_indices(name):
    """Outliers (20 sigma out) and a query far from every key: the
    emulation equals ball_plain and JAX's ball_query_multi exactly, and
    some queries go to tasks, some never fill, one row is empty."""
    B, N, S, radii, ks, prefix, span = BALL_CASES[name]
    rng = np.random.default_rng(1310 + N)
    xyz = grid_cloud(rng, B, N, 0.4)
    xyz[:, rng.random(N) < 0.05] *= 20.0
    q = xyz[:, rng.integers(0, N, S)].copy()
    q[:, : S // 3] *= 8.0
    q[:, -1] = 50.0  # an empty ball
    got, listed = emulate_ball(xyz, q, radii, ks, prefix, span, seed=N)
    want = ball_cuda.ball_plain(T(xyz), T(q), radii, ks, empty="last")
    jw = jops.ball_query_multi(list(radii), list(ks), J(xyz), J(q))
    for g, w, j in zip(got, want, jw):
        np.testing.assert_array_equal(g, w.numpy())
        np.testing.assert_array_equal(g, np.asarray(j))
    assert listed and (got[0][:, -1] == N - 1).all()
    d = sqd(xyz[:, None, :, :], q[:, :, None, :])
    short = (d <= F32(radii[-1] ** 2)).sum(-1) < ks[-1]
    assert short.sum() > 1  # queries whose scans walk every range


# ---- row 4b: the residual kNN's split, segment-sequential scan --------------------


def norms(x):
    """|x|^2 in fp32, the kernel's packing: (x*x + y*y) + z*z."""
    return ((x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]).astype(F32)


def fma32(a, b, c):
    """fp32 fused multiply-add: the product of two fp32 is exact in fp64."""
    return (a.astype(np.float64) * b + c).astype(F32)


def fma_mark(keys, q, bound, kmax):
    """``[Q, n]`` the residual kernel's mark of ``keys [n, 3]`` for the
    queries ``q [Q, 3]`` (csrc/fusion_knn.cu mark32, common.cuh mark_limit):
    |k|^2 - 2 q.k in three fp32 FMAs below (bound - |q|^2) + 32u (bound +
    (sqrt(kmax) + |q|)^2)."""
    kk = norms(keys)[None]
    q2 = (-2 * q).astype(F32)[:, None]
    a = fma32(q2[..., 0], keys[None, :, 0],
              fma32(q2[..., 1], keys[None, :, 1], fma32(q2[..., 2], keys[None, :, 2], kk)))
    qq = norms(q)
    r2 = ((np.sqrt(F32(kmax)) + np.sqrt(qq)).astype(F32) ** 2).astype(F32)
    with np.errstate(invalid="ignore"):
        lim = np.where(np.isfinite(bound),
                       ((bound - qq).astype(F32) + F32(2.0 ** -19) * (bound + r2).astype(F32)),
                       np.inf).astype(F32)
    return a < lim[:, None]


def insert_rows(ld, li, d, i, strict):
    """Each row's sorted list (``ld`` [R, KM] distances, ``li`` indices)
    with (d, i) inserted and its last entry dropped: after every entry of
    distance <= d (``strict``, keys in index order), or by (distance,
    index)."""
    d, i = np.broadcast_to(d, ld.shape[:1]), np.broadcast_to(i, ld.shape[:1])
    before = ld <= d[:, None] if strict else (ld < d[:, None]) | (
        (ld == d[:, None]) & (li < i[:, None]))
    pos = before.sum(1)[:, None]
    j = np.arange(ld.shape[1])[None]
    sd = np.concatenate([ld[:, :1], ld[:, :-1]], 1)
    si = np.concatenate([li[:, :1], li[:, :-1]], 1)
    return (np.where(j < pos, ld, np.where(j == pos, d[:, None], sd)),
            np.where(j < pos, li, np.where(j == pos, i[:, None], si)))


def emulate_resi(x, ends, buds, k, parts, share=True):
    """csrc/fusion_knn.cu's residual kernel on ``x [B, N, 3]``: for each
    segment, ``parts`` parts over contiguous key ranges (multiples of 4
    keys) advance 32 keys a round, part by part; a part marks the keys
    below min(its k-th, the other parts' published k-th one ulp up) as its
    list stood at the batch's start, then inserts the marked ones that are
    still below its k-th (strict: equal distances keep the lower index);
    part 0 then inserts the other parts' lists in order by (distance,
    index), stopping at each list's first entry that does not enter.  The
    mark is the kernel's (fma_mark), asserted a superset of ``d < bound``.
    Lists of 16 or 32 entries start with KM - cap entries at -inf.
    ``share=False`` leaves the other parts' k-th out of the mark.  Returns
    (idx int64, resi fp32) and the inserts a query."""
    B, N, _ = x.shape
    idx = np.empty((B, N, k), np.int64)
    inserts = 0
    for b in range(B):
        slots = np.full((N, k), -1, np.int64)
        q = x[b]
        used = start = 0
        for end, bud in zip(ends[b], buds[b]):
            cap = max(0, min(int(bud), k - used))
            if cap:
                KM = 32 if cap > 16 else 16
                length = max(0, int(end) - start)
                chunk = -(-(-(-length // parts)) // 4) * 4
                rng_ = [(start + min(p * chunk, length), start + min((p + 1) * chunk, length))
                        for p in range(parts)]
                lists_d = np.full((parts, N, KM), np.inf, F32)
                lists_i = np.full((parts, N, KM), -1, np.int64)
                lists_d[:, :, :KM - cap] = -np.inf
                pub = np.full((parts, N), np.inf, F32)
                rounds = max(-(-(e - a) // 32) for a, e in rng_)
                for r in range(rounds):
                    for p, (a, e) in enumerate(rng_):
                        lo = a + 32 * r
                        if lo >= e:
                            continue
                        keys = q[lo:min(e, lo + 32)]
                        d = sqd(keys[None], q[:, None])  # [N, n]
                        others = np.full(N, np.inf, F32)
                        for o in range(parts):
                            if o != p and share:
                                others = np.minimum(others, pub[o])
                        up = np.where(np.isfinite(others),
                                      np.nextafter(others, np.float32(np.inf)), others)
                        bound = np.minimum(lists_d[p, :, -1], up)
                        t0 = a + (lo - a) // 256 * 256  # the staged tile's largest |k|^2
                        marked = fma_mark(keys, q, bound, norms(q[t0:min(e, t0 + 256)]).max())
                        # the mark is a superset of the exact test
                        assert not ((d < bound[:, None]) & ~marked).any()
                        for u in range(keys.shape[0]):
                            m = marked[:, u] & (d[:, u] < lists_d[p, :, -1])
                            inserts += int(m.sum())
                            lists_d[p, m], lists_i[p, m] = insert_rows(
                                lists_d[p, m], lists_i[p, m], d[m, u], lo + u, strict=True)
                        pub[p] = lists_d[p, :, -1]
                ld, li = lists_d[0], lists_i[0]
                for o in range(1, parts):
                    live = np.ones(N, bool)  # a row stops at its first entry that stays out
                    for i in range(KM - cap, KM):
                        dd, ii = lists_d[o, :, i], lists_i[o, :, i]
                        live &= (ii >= 0) & ((dd < ld[:, -1]) | ((dd == ld[:, -1]) & (ii < li[:, -1])))
                        inserts += int(live.sum())
                        ld[live], li[live] = insert_rows(ld[live], li[live], dd[live], ii[live],
                                                         strict=False)
                slots[:, used:used + cap] = li[:, KM - cap:]
            used += cap
            start = max(start, int(end))
        own = np.arange(N)[:, None]
        idx[b] = np.where(slots >= 0, slots, own)
    resi = (np.take_along_axis(x, idx.reshape(B, -1)[..., None], 1).reshape(B, N, k, 3)
            - x[:, :, None, :]).astype(F32)
    return idx, resi, inserts / (B * N)


RESI_CASES = {
    # name: (B, N, ends, budgets, k); the cases JAX holds share one shape
    "f1": (2, 288, [[288], [288]], [[32], [32]], 32),
    "f2_t05": (2, 288, [[160, 288], [192, 288]], [[16, 16], [23, 9]], 32),
    "f2_wide": (2, 288, [[256, 288], [64, 288]], [[29, 3], [4, 28]], 32),
    "dups": (2, 288, [[128, 288], [96, 288]], [[16, 16], [24, 8]], 32),
    "f3": (2, 288, [[96, 192, 288], [96, 160, 288]], [[12, 10, 10], [8, 16, 8]], 32),
    "f4": (2, 288, [[60, 130, 200, 288], [30, 100, 250, 288]], [[8, 8, 8, 8], [4, 12, 6, 10]],
           32),
    "short": (1, 200, [[5, 200]], [[12, 20]], 32),
    "far": (1, 256, [[128, 256]], [[16, 16]], 32),  # 300 m from the origin
}


@functools.lru_cache(maxsize=None)
def resi_case(name):
    """The case's cloud, the plain version's (idx, resi) and, but for a
    segment shorter than its budget (JAX's knn_prefix takes at most the
    segment's rows) and the cloud 300 m out (JAX's |a|^2 + |b|^2 - 2 a.b
    cancels there), the JAX route's."""
    B, N, ends, buds, k = RESI_CASES[name]
    rng = np.random.default_rng(1320 + N)
    x = (rng.standard_normal((B, N, 3)) * 2).astype(F32)
    if name == "dups":
        x[:, N // 2:] = x[:, rng.integers(0, N // 2, N - N // 2)]
    if name == "far":  # the mark's cancellation at its largest
        x = (x * 0.05 + F32(300.0)).astype(F32)
    plain = [t.numpy() for t in fusion_knn_cuda.fusion_resi_plain(
        T(x), torch.tensor(ends), torch.tensor(buds), k)]
    jax = None
    if name not in ("short", "far"):  # far: JAX's expanded distances lose the order
        jax = [np.asarray(t) for t in jax_resi_route(J(x), J(np.int32(ends)),
                                                     J(np.int32(buds)), k)]
    return x, plain, jax


@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("name", list(RESI_CASES))
def test_emulated_resi_scan_gives_plain_and_jax(name, parts):
    """The emulation at 1, 2 and 4 parts equals fusion_resi_plain's idx and
    resi bit for bit, and the JAX route's idx (resi within 1e-6, its own
    test's tolerance); splitting with the shared filter inserts about as
    few keys a query as one part."""
    _, _, ends, buds, k = RESI_CASES[name]
    x, (want_i, want_r), jax = resi_case(name)
    idx, resi, _ = emulate_resi(x, ends, buds, k, parts)
    np.testing.assert_array_equal(idx, want_i)
    np.testing.assert_array_equal(resi, want_r)
    if jax is not None:
        np.testing.assert_array_equal(idx, jax[0])
        np.testing.assert_allclose(resi, jax[1], atol=1e-6, rtol=0)


def test_emulated_resi_filter_keeps_inserts_low():
    """At 4 parts the shared filter cuts the inserts a query against the
    same split without it (155, 337 and 475 a query at one part, four with
    and four without it, at this seed: each part's bound is the k-th of
    its own quarter of the keys scanned, the filter the lowest of four),
    and the slots stay the same either way."""
    rng = np.random.default_rng(1330)
    x = (rng.standard_normal((1, 1536, 3)) * 2).astype(F32)
    ends, buds = [[768, 1536]], [[16, 16]]
    i1, _, one = emulate_resi(x, ends, buds, 32, 1)
    i4, _, four = emulate_resi(x, ends, buds, 32, 4)
    i4n, _, alone = emulate_resi(x, ends, buds, 32, 4, share=False)
    assert np.array_equal(i1, i4) and np.array_equal(i1, i4n)
    assert one < four < 0.8 * alone, (one, four, alone)


# ---- both wrappers on a stub library -------------------------------------------


class StubLibrary:
    def __init__(self, **impl):
        self.calls = []
        self.impl = impl

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            if name not in self.impl:
                raise AssertionError(f"unexpected launch of {name}")
            self.impl[name](*args)
            return 0
        return entry

    def named(self, name):
        return [args for n, args in self.calls if n == name]


def write(ptr: int, t: torch.Tensor) -> None:
    t = t.contiguous()
    ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())


@pytest.fixture
def cuda_route(monkeypatch):
    monkeypatch.setattr(_build, "use_kernel", lambda t: not _build._PLAIN.get())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)

    def install(stub):
        monkeypatch.setattr(_build, "library", lambda: stub)
        return stub
    return install


@pytest.mark.parametrize("N", [1500, 5000])
def test_ball_wrapper_launch_arguments(cuda_route, N):
    """ball_query_multi on the forced CUDA route: one pci_ball launch with
    the squared radii as fp32 bits then the budgets, a scratch of
    scratch_ints only when keys lie past the prefix, no stamps unless
    given; the stub's rows come back as the scales' [B, S, K] tensors."""
    rng = np.random.default_rng(1340 + N)
    B, S, radii, ks = 2, 30, (0.2, 0.4), (16, 32)
    xyz, q = T(grid_cloud(rng, B, N, 0.5)), T(grid_cloud(rng, B, S, 0.5))
    want = ball_cuda.ball_plain(xyz, q, radii, ks, empty="last")

    def run(xp, qp, out, scales, n, B_, N_, S_, scratch, stamps, stream):
        assert (xp, qp, n, B_, N_, S_) == (xyz.data_ptr(), q.data_ptr(), 2, B, N, S)
        r2 = np.float32([r * r for r in radii]).view(np.int32).tolist()
        assert list(scales)[:4] == r2 + list(ks)
        assert (scratch is not None) == (N > ball_cuda.PREFIX) and stamps is None
        write(out, torch.cat([w.reshape(-1) for w in want]))

    stub = cuda_route(StubLibrary(pci_ball=run))
    before = ball_cuda.ball_kernel.launches
    got = ball_cuda.ball_query_multi(radii, ks, xyz, q)
    assert len(stub.named("pci_ball")) == 1 and ball_cuda.ball_kernel.launches - before == 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    nr = -(-(N - ball_cuda.PREFIX) // ball_cuda.RANGE) if N > ball_cuda.PREFIX else 0
    assert ball_cuda.scratch_ints(B, N, S, ks) == (
        2 + B * S * ball_cuda.INFO + B * S * nr * (2 + 48) if nr else 0)


@pytest.mark.parametrize("parts", [0, 4])
def test_fusion_resi_wrapper_launch_arguments(cuda_route, parts):
    """fusion_resi_knn on the forced CUDA route launches pci_fusion_resi
    once with int32 [B, F] ends and budgets, F, k, the parts asked for (0:
    the kernel's choice) and no stamps unless given; the stub's idx and
    resi come back unchanged, and the fixed-neighbour backward runs on
    them."""
    rng = np.random.default_rng(1350 + parts)
    B, N, k = 2, 500, 32
    x = T((rng.standard_normal((B, N, 3)) * 2).astype(F32)).requires_grad_()
    ends, buds = torch.tensor([[100, 300, N], [250, 260, N]]), torch.tensor([[8, 16, 8],
                                                                            [20, 4, 8]])
    want = fusion_knn_cuda.fusion_resi_plain(x, ends, buds, k)
    stamps = torch.zeros((B * -(-N // fusion_knn_cuda.RESI_ITEM), fusion_knn_cuda.RESI_STAMPS),
                         dtype=torch.int64)

    def run(pts, e, bu, F, oi, orr, B_, N_, k_, parts_, st, stream):
        assert (F, B_, N_, k_, parts_) == (3, B, N, k, parts)
        assert ctypes.c_int32.from_address(e + 4 * 4).value == 260
        assert ctypes.c_int32.from_address(bu + 4).value == 16
        assert st == (stamps.data_ptr() if parts else None)
        write(oi, want[0])
        write(orr, want[1])

    stub = cuda_route(StubLibrary(pci_fusion_resi=run))
    if parts:
        with torch.no_grad():
            got = fusion_knn_cuda.fusion_resi_kernel(x.detach(), ends, buds, k, parts=parts,
                                                     stamps=stamps)
    else:
        got = fusion_knn_cuda.fusion_resi_knn(x, ends, buds, k)
        got[1].sum().backward()
        assert x.grad is not None
    assert len(stub.named("pci_fusion_resi")) == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1].detach(), want[1])
    with pytest.raises(ValueError):
        fusion_knn_cuda.fusion_resi_kernel(x.detach(), ends, buds, k, parts=3)
