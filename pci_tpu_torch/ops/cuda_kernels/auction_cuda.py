"""The annealed Gauss-Seidel auction of the EMD assignment: the CUDA
kernels (csrc/auction.cu), their plain PyTorch versions and the host loop
that drives either, :func:`auction`.

Replaces ``pci_tpu/ops/pallas_kernels/auction_tpu.py:emd_auction_tpu``
(``_auction_pass``, ``_auction_chase``, driven by ``_auction_impl``).  The
kernels compute what the TPU kernels compute, exactly: the TPU pass packs
low mantissa bits of ``V`` and of the bid with an index to select in one
reduction; here every selection is exact (the least ``V``, ties to the
lowest column; the highest bid, ties to the lowest row), so kernel and
plain version agree bit for bit, after one pass and over a whole run.
The plain version is the same blocked function: a Python loop over query
tiles of 256 rows, vectorised inside a tile, and a hop loop for the
chase.  The chase kernel is a thread-block cluster up to
``CHASE_CLUSTER_MAX_N`` points and one block above (:func:`chase_cluster_ok`).

Both update ``price``, ``assign`` and ``owner`` in place (the TPU kernels
return new arrays).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..distance import square_distance
from . import _build

TQ = 256  # query rows a tile: tile t + 1 bids against tile t's prices
CHASE_HOPS = 4096  # the chase's hop budget a pass (the TPU kernel's)
CHASE_CLUSTER_MAX_N = 32768  # the cluster chase's largest n and m (csrc/auction.cu)
PASS_STAMPS = 5  # a pass block's phase sums (ns): scan, merge + bid, barrier, C, barrier
# the cluster chase's (ns, over its hops): scan, publish, cluster barrier and
# partials, merge and update (thread 0 of CTA 0); the helper warp's search
# and fetch, its merge
CHASE_STAMPS = 6
EPS0 = 0.25  # the anneal's first eps
_BIG = 1e30
_CHECK_EVERY = 32  # the plain chase reads "anything flagged?" every 32 hops


def cs_slack(eps: float) -> float:
    """``1.0001 * eps`` rounded once in fp32: the complementary-slackness
    test is ``V[assigned] > (v1 + cs_slack(eps)) + 1e-5``."""
    return float(np.float32(1.0001) * np.float32(eps))


def normalise(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """``(q, k, d_scale)``: both clouds times ``rsqrt(d_scale)``, with
    ``d_scale = max(2 (max|x1|^2 + max|x2|^2), 1e-12)``, an upper bound of
    every squared distance, so normalised costs are <= 1 and ``eps`` is
    relative to the cloud's scale."""
    x1, x2 = xyz1.detach().float(), xyz2.detach().float()
    r1 = (x1 * x1).sum(-1).amax()
    r2 = (x2 * x2).sum(-1).amax()
    d_scale = torch.clamp_min(2.0 * (r1 + r2), 1e-12)
    inv = torch.rsqrt(d_scale)
    return (x1 * inv).contiguous(), (x2 * inv).contiguous(), d_scale


def auction_pass(q, k, price, assign, owner, eps: float) -> torch.Tensor:
    """One bidding pass over every row, in place; returns the number of
    rows that bid (a 0-d tensor).  The kernel on a CUDA tensor."""
    if _build.use_kernel(q):
        return auction_pass_kernel(q, k, price, assign, owner, eps)
    return auction_pass_plain(q, k, price, assign, owner, eps)


def auction_chase(q, k, price, assign, owner, eps: float,
                  max_hops: int = CHASE_HOPS) -> torch.Tensor:
    """The displacement chain after a pass, in place; returns the hops made
    (a 0-d tensor).  The kernel on a CUDA tensor."""
    if _build.use_kernel(q):
        return auction_chase_kernel(q, k, price, assign, owner, eps, max_hops)
    return auction_chase_plain(q, k, price, assign, owner, eps, max_hops)


def _check_state(q, k, price, assign, owner):
    dev = q.device
    _build.require(q, "q", torch.float32, 2, dev)
    _build.require(k, "k", torch.float32, 2, dev)
    _build.require(price, "price", torch.float32, 1, dev)
    _build.require(assign, "assign", torch.int32, 1, dev)
    _build.require(owner, "owner", torch.int32, 1, dev)
    n, m = q.shape[0], k.shape[0]
    if q.shape[1] != 3 or k.shape[1] != 3 or assign.shape[0] != n \
            or price.shape[0] != m or owner.shape[0] != m:
        raise ValueError("auction kernels take q [n, 3], k [m, 3], price and owner [m], "
                         "assign [n]")
    if n < 1 or m < 2:
        raise ValueError(f"auction kernels need n >= 1 and m >= 2, got {n}, {m}")
    return n, m


def _stamps_ptr(stamps, shape):
    if stamps is None:
        return None
    _build.require(stamps, "stamps", torch.int64, len(shape), stamps.device)
    if tuple(stamps.shape) != shape:
        raise ValueError(f"stamps must be {shape}, got {tuple(stamps.shape)}")
    return stamps.data_ptr()


def auction_pass_kernel(q, k, price, assign, owner, eps, stamps=None):
    """Launch csrc/auction.cu's pass: one cooperative launch.  ``stamps``
    (a measurement launch only): a zeroed int64 ``[128, PASS_STAMPS]``
    CUDA tensor that gets each block's phase sums over the tiles
    (``%globaltimer`` ns)."""
    n, m = _check_state(q, k, price, assign, owner)
    dev = q.device
    best = torch.zeros(2 * m, dtype=torch.int64, device=dev)  # left zero by the kernel
    counters = torch.zeros(2, dtype=torch.int32, device=dev)  # barrier, bidders
    err = _build.library().pci_auction_pass(
        q.data_ptr(), k.data_ptr(), price.data_ptr(), assign.data_ptr(),
        owner.data_ptr(), best.data_ptr(), counters.data_ptr(),
        _stamps_ptr(stamps, (TQ // 2, PASS_STAMPS)), n, m,
        float(eps), cs_slack(eps), _build.stream_ptr(dev),
    )
    _build.check_launch("auction_pass", err)
    auction_pass_kernel.launches += 1
    return counters[1]


auction_pass_kernel.launches = 0


def chase_cluster_ok(n: int, m: int) -> bool:
    """The chase's route by size, decided before the launch: the cluster
    kernel up to ``CHASE_CLUSTER_MAX_N`` rows and columns (every size the
    eval CLIs use), the one-block kernel above."""
    return n <= CHASE_CLUSTER_MAX_N and m <= CHASE_CLUSTER_MAX_N


def cluster_shape(n: int, m: int) -> dict:
    """The cluster chase's launch shape at ``n`` rows and ``m`` columns:
    ``{"C": CTAs a cluster, "smem": dynamic shared bytes a CTA,
    "clusters": clusters of that shape the card can hold}``; raises where
    the card can schedule neither 16 nor 8 CTAs."""
    out = (ctypes.c_int * 3)()
    _build.check_launch("auction_cluster_shape",
                        _build.library().pci_auction_cluster_shape(n, m, out))
    return dict(zip(("C", "smem", "clusters"), out))


def auction_chase_kernel(q, k, price, assign, owner, eps, max_hops=CHASE_HOPS, stamps=None):
    """Launch csrc/auction.cu's chase: one thread-block cluster where
    :func:`chase_cluster_ok`, else one block.  A cluster the card refuses
    raises.  ``stamps`` (a measurement launch of the cluster kernel only):
    a zeroed int64 ``[CHASE_STAMPS]`` CUDA tensor that gets CTA 0's phase
    sums over the hops (``%globaltimer`` ns)."""
    n, m = _check_state(q, k, price, assign, owner)
    dev = q.device
    hops = torch.empty(1, dtype=torch.int32, device=dev)
    lib = _build.library()
    if chase_cluster_ok(n, m):
        err = lib.pci_auction_chase_cluster(
            q.data_ptr(), k.data_ptr(), price.data_ptr(), assign.data_ptr(),
            owner.data_ptr(), hops.data_ptr(), _stamps_ptr(stamps, (CHASE_STAMPS,)), n, m,
            float(eps), int(max_hops), _build.stream_ptr(dev),
        )
    else:
        if stamps is not None:
            raise ValueError("auction_chase: stamps are the cluster kernel's")
        err = lib.pci_auction_chase(
            q.data_ptr(), k.data_ptr(), price.data_ptr(), assign.data_ptr(),
            owner.data_ptr(), hops.data_ptr(), n, m, float(eps), int(max_hops),
            _build.stream_ptr(dev),
        )
    _build.check_launch("auction_chase", err)
    auction_chase_kernel.launches += 1
    return hops[0]


auction_chase_kernel.launches = 0


def _top2(V: torch.Tensor):
    """Row-wise exact ``(v1, i1, v2)`` of ``V [..., m]``: the least value,
    its lowest column, the least value over the other columns."""
    m = V.shape[-1]
    cols = torch.arange(m, device=V.device)
    v1 = V.amin(-1, keepdim=True)
    i1 = torch.where(V == v1, cols, m).amin(-1, keepdim=True)
    v2 = torch.where(cols == i1, torch.inf, V).amin(-1)
    return v1[..., 0], i1[..., 0], v2


def _incr(v1, v2, eps):
    return (v2 - v1).clamp_max(_BIG) + eps


def auction_pass_plain(q, k, price, assign, owner, eps):
    """The pass as tiles of ``TQ`` rows in order, each vectorised: exact
    top-2, the bidding mask (unassigned, evicted or violating
    eps-complementary slackness), each column's highest bid (ties to the
    lowest row) by ``scatter_reduce``, then prices, owners and the tile's
    assignments."""
    n, m = q.shape[0], k.shape[0]
    dev = q.device
    cs = cs_slack(eps)
    bidders = torch.zeros((), dtype=torch.int64, device=dev)
    for r0 in range(0, n, TQ):
        rows = torch.arange(r0, min(r0 + TQ, n), device=dev)
        V = square_distance(q[r0:r0 + TQ], k) + price
        v1, i1, v2 = _top2(V)
        a = assign[r0:r0 + TQ]
        ac = a.clamp_min(0).long()
        v_a = V.gather(1, ac[:, None])[:, 0]
        held = (a >= 0) & (owner[ac] == rows)
        bidding = ~held | (v_a > (v1 + cs) + 1e-5)
        bidders += bidding.sum()
        incr = _incr(v1, v2, eps)
        top = torch.full((m,), -torch.inf, device=dev).scatter_reduce(
            0, i1, torch.where(bidding, incr, -torch.inf), "amax")
        cand = bidding & (incr == top[i1])
        win = torch.full((m,), n, dtype=torch.int64, device=dev).scatter_reduce(
            0, i1, torch.where(cand, rows, n), "amin")
        has = win < n
        won = cand & (win[i1] == rows)
        price.copy_(torch.where(has, price + top, price))
        owner.copy_(torch.where(has, win, owner.long()))
        assign[r0:r0 + TQ] = torch.where(won, i1, torch.where(bidding, -1, a.long())).int()
    return bidders


def auction_chase_plain(q, k, price, assign, owner, eps, max_hops=CHASE_HOPS):
    """The chase as a hop loop: the lowest flagged row bids on its exact
    argmin column, takes it, and flags the previous owner only if that row
    is still assigned to the column.  One-element index tensors keep the
    loop free of host syncs but one every ``_CHECK_EVERY`` hops (a hop with
    nothing flagged changes nothing)."""
    n, m = q.shape[0], k.shape[0]
    dev = q.device
    rows = torch.arange(n, device=dev)
    held = (assign >= 0) & (owner[assign.clamp_min(0).long()] == rows)
    flags = ~held
    hops = torch.zeros((), dtype=torch.int64, device=dev)
    for h in range(max_hops):
        if h % _CHECK_EVERY == 0 and not bool(flags.any()):
            break
        r = torch.where(flags, rows, n).amin().reshape(1)
        act = r < n
        rc = r.clamp_max(n - 1)
        V = square_distance(q.index_select(0, rc), k) + price  # [1, m]
        v1, j1, v2 = _top2(V)
        p_old = price.index_select(0, j1)
        price.index_copy_(0, j1, torch.where(act, p_old + _incr(v1, v2, eps), p_old))
        old = owner.index_select(0, j1).long()
        owner.index_copy_(0, j1, torch.where(act, r, old).int())
        a_old = assign.index_select(0, rc)
        assign.index_copy_(0, rc, torch.where(act, j1.int(), a_old))
        oc = old.clamp_min(0)
        evict = act & (old >= 0) & (old != r) & (assign.index_select(0, oc).long() == j1)
        flags.index_copy_(0, oc, flags.index_select(0, oc) | evict)
        flags.index_copy_(0, rc, flags.index_select(0, rc) & ~act)
        hops += act.sum()
    return hops


def auction(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 1e-3,
            max_passes: int = 512, return_prices: bool = False):
    """Annealed Gauss-Seidel auction assignment of ``xyz1 [n, 3]`` to
    ``xyz2 [n, 3]`` (``_auction_impl``).

    Costs are normalised (:func:`normalise`), so ``eps`` is relative: on
    ``converged`` the total cost is within ``n * (1.0001 eps + 1e-5) *
    d_scale`` of the optimum.  eps starts at 0.25 and quarters towards
    ``eps`` whenever a pass ends complete with no bidder; nothing is
    reopened (rows that violate the finer eps rebid).  Each pass is one
    bidding pass then the chase; one host sync a pass reads the bidder
    count, the hops and completeness.  When ``max_passes`` run out, the
    last complete matching is returned with ``converged`` False.

    Returns ``(dist [n], assign [n] int64, converged)``: the squared
    distance of each point of ``xyz1`` to its partner, the partner, a 0-d
    bool.  ``return_prices=True`` (a test hook) also returns the final
    prices (normalised units) and ``{"passes", "hops", "eps"}``.
    The kernels on a CUDA tensor, the plain versions on a CPU one.
    """
    xyz1, xyz2 = xyz1.detach().float(), xyz2.detach().float()
    if xyz1.dim() != 2 or xyz1.shape[-1] != 3 or xyz2.shape != xyz1.shape:
        raise ValueError(f"auction needs two [n, 3] clouds of one size, got "
                         f"{tuple(xyz1.shape)} and {tuple(xyz2.shape)}")
    n = xyz1.shape[0]
    dev = xyz1.device
    q, k, _ = normalise(xyz1, xyz2)
    price = torch.zeros(n, dtype=torch.float32, device=dev)
    assign = torch.full((n,), -1, dtype=torch.int32, device=dev)
    owner = torch.full((n,), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)
    eps_t = float(np.float32(eps))
    eps_cur = EPS0
    snap = assign.clone()
    done, passes, hops = False, 0, 0
    while passes < max_passes and not done:
        bidders = auction_pass(q, k, price, assign, owner, eps_cur)
        made = auction_chase(q, k, price, assign, owner, eps_cur)
        held = (assign >= 0) & (owner[assign.clamp_min(0).long()] == rows)
        nbid, nhop, complete = torch.stack(
            [bidders.long(), made.long(), held.all().long()]).tolist()
        passes += 1
        hops += nhop
        if complete:
            snap = assign.clone()
        settled = complete and nbid == 0
        done = settled and eps_cur <= eps_t
        if settled and not done:
            eps_cur = max(eps_cur * 0.25, eps_t)
    final = assign if done else snap
    safe = final.clamp(0, n - 1).long()
    dist = ((xyz1 - xyz2[safe]) ** 2).sum(-1)
    converged = torch.tensor(done and bool((final >= 0).all()), device=dev)
    if return_prices:
        return dist, safe, converged, price, {"passes": passes, "hops": hops, "eps": eps_cur}
    return dist, safe, converged


def duality_gap(xyz1, xyz2, assign, price, chunk: int = 1024) -> float:
    """The auction's certificate on a permutation ``assign`` with prices
    ``price`` (normalised units): ``primal - (sum_i min_j (c_ij + p_j) -
    sum_j p_j)`` in normalised costs, summed in fp64 from one chunked
    dense pass.  The second term lower-bounds the optimum (the prices are
    a feasible dual), so the gap bounds the matching's excess cost; after a
    converged run it is at most ``n * (1.0001 eps + 1e-5)``."""
    q, k, _ = normalise(xyz1, xyz2)
    primal = ((q - k[assign.long()]) ** 2).sum(-1).double().sum()
    lower = -price.double().sum()
    for s in range(0, q.shape[0], chunk):
        lower = lower + (square_distance(q[s:s + chunk], k) + price).amin(-1).double().sum()
    return float(primal - lower)
