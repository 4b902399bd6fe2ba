"""The dataflow of ``csrc/auction.cu``'s redesigned kernels, emulated in
numpy and torch on the CPU, against the plain versions
(``ops/cuda_kernels/auction_cuda.py``) bit for bit.  The CUDA kernels run
only on the card (``chip_smoke.py`` holds them there); these tests hold
the order of their arithmetic.

- The cluster chase (``auction_chase_cluster_kernel``): columns dealt
  over C CTAs (C = 8 and 16; column j to CTA j % C at l = j // C), each
  CTA's over its 8 scanning warps (l to thread l % 256); each warp's exact
  top-2 (the kernel's three-reduction form) with ``owner[i1]`` as it
  stood before the hop; the partials merged with ``top2_merge`` in (CTA,
  warp) order, as each warp of every CTA merges them; ``assign``
  and the flag bitmap with its summary level replicated once a CTA, every
  replica updated alike; the next row taken as the kernel takes it (the
  evicted owner when it is below r2, else r2, the lowest flagged row above
  r by the two-level search), never by a full search.  Inputs: the state
  after one ``auction_pass_plain`` at eps 0.25 on 300 and 1,100 points
  with 10% exact duplicates (m a multiple of neither C nor 32), a run cut
  at 37 hops, and two annealed states (a pass and chase at eps 0.25, then
  passes at finer eps) whose chains evict owners above and below r2.
- The pass's scan (``auction_pass_kernel``'s ``scan_pair``): 512 threads,
  thread t scanning columns t, t + 512, ... in runs of 8 whose prices
  load together, columns past the end pushed as +inf with a clamped key,
  the staged keys first and the rest after (a split at 700 of 1,100
  columns), the warps' reduction and the 16 warps' partials merged by one
  warp, against ``_top2`` over duplicated keys.
- The chase's route by size (``chase_cluster_ok``).

Each case has its own fixed seed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pci_tpu_torch.ops.cuda_kernels import auction_cuda as A
from pci_tpu_torch.ops.distance import square_distance

torch.set_num_threads(2)

WARPS = 8  # the cluster chase's scanning warps a CTA
SCAN = 32 * WARPS
PASS_THREADS, PASS_PB = 512, 8
NO_ROW = 0x7FFFFFFF
INF = float("inf")


def dup_pair(seed: int, n: int):
    """Two seeded clouds; the last 10% of the second repeat earlier points
    exactly (``chip_smoke.dup_pair``'s share)."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((n, 3)) * 10).astype(np.float32)
    b = a + 0.5 * rng.standard_normal((n, 3)).astype(np.float32)
    k = n // 10
    b[n - k:] = b[rng.integers(0, n - k, k)]
    return torch.from_numpy(a), torch.from_numpy(b)


def top2_merge(t, w1, j1, w2):
    """csrc/auction.cu top2_merge on python floats (exact copies of fp32)."""
    v1, i1, v2 = t
    if w1 < v1 or (w1 == v1 and j1 < i1):
        return (w1, j1, min(v1, w2))
    return (v1, i1, min(v2, w1))


def top2_push(t, v, j):
    v1, i1, v2 = t
    if v < v1:
        return (v, j, v1)
    return (v1, i1, min(v2, v))


def warp_reduce(parts):
    """top2_warp over 32 lanes' (v1, i1, v2) of disjoint column sets: the
    least v1 (V >= 0, so its fp32 bits order as the value), the lowest i1
    among the lanes that hold it, and v2 the least of that lane's v2 and
    every other lane's v1 (three integer reductions in the kernel)."""
    b1 = min(v1 for v1, _, _ in parts)
    k1 = min(i1 for v1, i1, _ in parts if v1 == b1)
    b2 = min(v2 if i1 == k1 else v1 for v1, i1, v2 in parts)
    return (b1, k1, b2)


class Flags:
    """One CTA's replica of the flag bitmap: 32-bit words and a summary of
    32 words, one bit a word (csrc/auction.cu flag_search / flag_set /
    flag_clear)."""

    def __init__(self, flagged: np.ndarray):
        n = flagged.shape[0]
        self.n = n
        self.words = np.zeros((n + 31) // 32, dtype=np.uint64)
        for r in np.nonzero(flagged)[0]:
            self.words[r >> 5] |= np.uint64(1 << (r & 31))
        self.summ = np.zeros(32, dtype=np.uint64)
        for w in np.nonzero(self.words)[0]:
            self.summ[w >> 5] |= np.uint64(1 << (w & 31))

    def search(self, after: int) -> int:
        """The lowest flagged row above ``after``: the word of after + 1
        masked, else the summary's lowest set bit among later words."""
        a = after + 1
        if a >= self.n:
            return NO_ROW
        w0 = a >> 5
        f0 = int(self.words[w0]) & (0xFFFFFFFF << (a & 31)) & 0xFFFFFFFF
        if f0:
            return (w0 << 5) + lowest_bit(f0)
        w1 = w0 + 1
        sw = w1 >> 5
        lanes = self.summ.copy()  # lane l holds summary word l, masked to words >= w1
        lanes[:min(sw, 32)] = 0
        if sw < 32:
            lanes[sw] &= np.uint64((0xFFFFFFFF << (w1 & 31)) & 0xFFFFFFFF)
        busy = np.nonzero(lanes)[0]  # the ballot
        if busy.size == 0:
            return NO_ROW
        w = (int(busy[0]) << 5) + lowest_bit(int(lanes[busy[0]]))
        return (w << 5) + lowest_bit(int(self.words[w]))

    def set(self, r: int):
        self.words[r >> 5] |= np.uint64(1 << (r & 31))
        self.summ[r >> 10] |= np.uint64(1 << ((r >> 5) & 31))

    def clear(self, r: int):
        self.words[r >> 5] &= ~np.uint64(1 << (r & 31))
        if self.words[r >> 5] == 0:
            self.summ[r >> 10] &= ~np.uint64(1 << ((r >> 5) & 31))

    def state(self):
        return self.words.tobytes() + self.summ.tobytes()


def lowest_bit(x: int) -> int:
    return (x & -x).bit_length() - 1


def warp_groups(m: int, C: int):
    """Column indices of each (CTA, warp), padded with -1: ``[C * WARPS,
    L]`` in slot order c * WARPS + w.  Column j lives in CTA j % C at
    local index l = j // C, scanned by thread l % 256."""
    groups = []
    for c in range(C):
        cols = np.arange(c, m, C)
        local = cols // C
        for w in range(WARPS):
            groups.append(cols[(local % SCAN) // 32 == w])
    width = max(1, max(len(g) for g in groups))
    idx = np.full((len(groups), width), -1, dtype=np.int64)
    for s, g in enumerate(groups):
        idx[s, :len(g)] = g
    return torch.from_numpy(idx)


def chase_cluster_emulated(q, k, price, assign, owner, eps, C, max_hops=A.CHASE_HOPS):
    """The cluster chase's dataflow, in place; returns the hops made."""
    n, m = q.shape[0], k.shape[0]
    idx = warp_groups(m, C)
    valid = idx >= 0
    rows = torch.arange(n)
    held = (assign >= 0) & (owner[assign.clamp_min(0).long()] == rows)
    replicas = [(assign.clone(), Flags((~held).numpy())) for _ in range(C)]
    r = replicas[0][1].search(-1)
    hops = 0
    while hops < max_hops and r != NO_ROW:
        r2 = replicas[0][1].search(r)  # the helper warp, in every CTA alike
        V = (square_distance(q[r:r + 1], k) + price)[0]
        Vg = torch.where(valid, V[idx.clamp_min(0)], INF)
        v1 = Vg.amin(1)
        i1 = torch.where(valid & (Vg == v1[:, None]), idx, NO_ROW).amin(1)
        v2 = torch.where(idx == i1[:, None], INF, Vg).amin(1)
        parts = [(float(a), int(b), float(c)) for a, b, c in zip(v1, i1, v2)]
        olds = [int(owner[j]) if j != NO_ROW else -1 for j in i1.tolist()]
        g = (INF, NO_ROW, INF)
        for p in parts:  # (CTA, warp) order
            g = top2_merge(g, *p)
        j1 = g[1]
        cw, l1 = j1 % C, j1 // C
        old = olds[cw * WARPS + (l1 % SCAN) // 32]
        assert old == int(owner[j1])
        evict = old >= 0 and old != r and int(replicas[0][0][old]) == j1
        incr = A._incr(torch.tensor(g[0]), torch.tensor(g[2]), eps)
        price[j1] = price[j1] + incr
        owner[j1] = r
        for a, f in replicas:
            a[r] = j1
            if evict:
                f.set(old)
            f.clear(r)
        hops += 1
        r = old if evict and old < r2 else r2
        assert r == replicas[0][1].search(-1)  # the kernel's next row is the lowest flagged
    assert all(torch.equal(a, replicas[0][0]) for a, _ in replicas)
    assert len({f.state() for _, f in replicas}) == 1
    assign.copy_(replicas[0][0])
    return hops


def before_chase(n: int, seed: int, eps: tuple):
    """The state a chase starts from after passes at ``eps`` (each but the
    last followed by its chase), from the empty state."""
    q, k, _ = A.normalise(*dup_pair(seed, n))
    state = [torch.zeros(n), torch.full((n,), -1, dtype=torch.int32),
             torch.full((n,), -1, dtype=torch.int32)]
    for e in eps[:-1]:
        A.auction_pass_plain(q, k, *state, e)
        A.auction_chase_plain(q, k, *state, e)
    A.auction_pass_plain(q, k, *state, eps[-1])
    return q, k, state


@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("n,seed,eps,max_hops", [
    (300, 61, (A.EPS0,), A.CHASE_HOPS),
    (1100, 62, (A.EPS0,), A.CHASE_HOPS),
    (1100, 63, (A.EPS0,), 37),
    # annealed: chains that evict owners above and below r2
    (300, 64, (A.EPS0, A.EPS0 / 4, A.EPS0 / 16), 500),
    (1100, 65, (A.EPS0, A.EPS0 / 4), 400),
])
def test_cluster_chase_emulation_matches_plain(C, n, seed, eps, max_hops):
    """The emulated cluster chase and ``auction_chase_plain`` from the same
    state: prices, assignments, owners and hops equal."""
    q, k, state = before_chase(n, seed, eps)
    mine = [t.clone() for t in state]
    want = int(A.auction_chase_plain(q, k, *state, eps[-1], max_hops))
    got = chase_cluster_emulated(q, k, *mine, eps[-1], C, max_hops)
    assert want > 0 and (max_hops == A.CHASE_HOPS or want == max_hops)
    assert got == want
    for a, b in zip(mine, state):
        assert torch.equal(a, b)


def pass_scan_emulated(V: torch.Tensor, staged: int):
    """One row's (v1, i1, v2) by the pass kernel's order: per thread the
    staged columns then the rest, AUC_PB a run, +inf past each end; the
    warps' shuffles; the 16 warps' partials merged by one warp."""
    m = V.shape[0]
    threads = [(INF, NO_ROW, INF)] * PASS_THREADS
    vals = V.tolist()
    for j0, j1 in ((0, staged), (staged, m)):
        for t in range(PASS_THREADS):
            st = threads[t]
            jb = j0 + t
            while jb < j1:
                for i in range(PASS_PB):
                    j = jb + i * PASS_THREADS
                    st = top2_push(st, vals[j] if j < j1 else INF, j)
                jb += PASS_PB * PASS_THREADS
            threads[t] = st
    warps = [warp_reduce(threads[w * 32:(w + 1) * 32]) for w in range(PASS_THREADS // 32)]
    empty = (INF, NO_ROW, INF)
    return warp_reduce(warps + [empty] * (32 - len(warps)))


@pytest.mark.parametrize("m,staged,seed", [(300, 300, 71), (1100, 1100, 72), (1100, 700, 73)])
def test_pass_scan_emulation_matches_top2(m, staged, seed):
    """The pass's scan order gives ``_top2``'s exact (v1, lowest i1, v2) on
    row 0 and two rows whose least V is tied (keys with 10% exact
    duplicates)."""
    q, k, _ = A.normalise(*dup_pair(seed, m))
    price = torch.zeros(m)
    price[::7] = 0.01  # a few raised prices, as after a pass
    V = square_distance(q, k) + price
    v1, i1, v2 = A._top2(V)
    ties = torch.nonzero(v1 == v2)[:, 0][:2].tolist()  # the least V twice
    assert len(ties) == 2
    for row in [0] + ties:
        got = pass_scan_emulated(V[row], staged)
        assert got == (float(v1[row]), int(i1[row]), float(v2[row]))


@pytest.mark.parametrize("n,cluster", [(1024, True), (4099, True), (16000, True), (16384, True),
                                       (32768, True), (32769, False), (65536, False)])
def test_chase_route_by_size(n, cluster):
    """The chase's route is decided from the sizes before the launch: every
    eval size (1,024-16,384) and up to 32,768 points take the cluster
    kernel, larger clouds the one-block kernel."""
    assert A.chase_cluster_ok(n, n) is cluster
