"""Exact k-nearest neighbours: the CUDA kernels (csrc/knn.cu, flat, and
csrc/knn_cells.cu, box-pruned) and their plain PyTorch version, behind one
wrapper, :func:`knn`.

It replaces two TPU kernels with the EXACT function that
``pci_tpu.ops.knn(..., exact=True)`` and ``pci_tpu.ops.knn_prefix(...,
exact=True)`` define: the ``k`` least fp32 squared distances ``(dx*dx +
dy*dy) + dz*dz``, ascending, ties to the lower key index (a stable sort;
``torch.topk`` leaves the order of ties unspecified), over the first
``valid_n[b]`` keys when ``valid_n`` is given.  Keys at or past
``valid_n`` have the sentinel distance 1e30, so when ``valid_n < k`` the
surplus slots hold 1e30 and the indices ``valid_n, valid_n + 1, ...``.

- ``pci_tpu/ops/pallas_kernels/knn_cells_tpu.py:knn_cells`` (the
  transformer's self-kNN, and the small cross-cloud kNNs), approximate on
  the TPU (recall about 0.97): on clouds of at least ``CELLS_MIN_KEYS``
  keys (every key valid, ``2 <= k``, :func:`cells_route_ok`) the box-pruned kernel over
  Morton-sorted chunks (:func:`knn_cells_kernel`, counted in its
  ``launches``), else the flat kernel's k-list forms, counted in
  ``knn_kernel.launches``.
- ``pci_tpu/ops/pallas_kernels/knn_tpu.py:knn_pallas`` (the chamfer loss's
  nearest neighbour, k=1, and ``valid_n`` prefixes): at k = 1 the
  split-range kernel on a thread-block cluster (:func:`nearest_kernel`,
  counted in ``nearest_launches.launches``), at k >= 2 the flat kernel's
  list.  The TPU kernel takes k <= 128 and buckets its keys; these are
  exact and take k <= 128 (above 64 the list lives in local memory).

Route (:func:`kernel_route_ok`, decided by shape before any launch, as
``pci_tpu/ops/knn.py:_use_pallas`` decides): xyz clouds with ``1 <= k <=
min(FLAT_MAX_K, N)`` take a kernel; anything else (``C != 3``, ``k > 128``,
``k > N``) takes :func:`knn_plain`, the counterpart of the JAX op's XLA
branch, on any device.

Distances and indices carry no gradient: the inputs are detached, as
``knn_pallas`` stop-gradients them.

:func:`knn_cells` is ``knn_cells_tpu.knn_cells``' own signature, with its
``key_valid`` mask and ``emit_resi`` residuals, on the box-pruned kernel's
segment form (``csrc/knn_cells.cu:knn_cells_seg_kernel``, counted in
``knn_cells_kernel.launches``): only keys where ``key_valid`` holds can be
neighbours, a slot with no valid key left is the query's own row with the
distance ``SENTINEL`` and a zero residual, and the residuals are the exact
fp32 ``points[idx] - query``.  The fusion's F-segment route and
``ops.knn_self_resi`` call it; ``cells_route_ok`` still refuses a mask for
:func:`knn`.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import types

import torch

from ..cells import box_lb, chunk_boxes, sort_by_morton
from ..distance import square_distance
from . import _build

MAX_K = 64  # the box-pruned kernel keeps the top list in registers
FLAT_MAX_K = 128  # the flat kernel: in registers up to 64, in local memory above
SENTINEL = 1e30  # the distance of a key outside the prefix
# the plain version sorts [rows, N] blocks: about 2**27 elements a block
# (distances, sorted values and int64 indices: ~2 GB) whatever N is
_PLAIN_BLOCK = 1 << 27
# the box-pruned route (each choice measured on the card, PERF.md): keys a
# chunk, sorted queries a tile, and the least key count it takes (the
# crossing with the flat kernel); a search for k <= 3 neighbours with more
# queries than keys takes it from CELLS_MIN_KEYS_FEW keys
CELLS_CHUNK = 256
CELLS_TILE = 64
CELLS_MIN_KEYS = 4096
CELLS_MIN_KEYS_FEW = 16384
STAMPS = 5  # a tile's stamps: start, end (%globaltimer ns), chunks walked, inserts, pairs


def knn(query: torch.Tensor, points: torch.Tensor, k: int,
        valid_n: torch.Tensor | None = None):
    """``query [B, S, C]``, ``points [B, N, C]``, ``valid_n [B]`` int or
    None (every key) -> ``(sq_dists [B, S, k]`` fp32, ``idx [B, S, k]``
    int64), ascending by distance.  A kernel on a CUDA tensor where
    :func:`kernel_route_ok` says so, else the plain version."""
    self_knn = query is points  # decided here, outside any compiled region
    query, points = query.detach(), points.detach()
    if _build.use_kernel(points) and kernel_route_ok(query, points, k):
        query, points = query.float().contiguous(), points.float().contiguous()
        if cells_route_ok(query, points, k, valid_n):
            return knn_cells_kernel(points if self_knn else query, points, k)
        return knn_kernel(query, points, k, valid_n)
    return knn_plain(query, points, k, valid_n)


def kernel_route_ok(query: torch.Tensor, points: torch.Tensor, k: int) -> bool:
    """The kernels' shapes: ``[B, S, 3]`` queries and ``[B, N, 3]`` keys
    with ``1 <= k <= min(FLAT_MAX_K, N)``.  Another shape takes the plain
    version, as the JAX op takes XLA outside its kernel's (xyz, ``k <=
    128``) shapes."""
    N = points.shape[1]
    return points.shape[-1] == 3 and query.shape[-1] == 3 and 1 <= k <= min(FLAT_MAX_K, N)


def cells_route_ok(query: torch.Tensor, points: torch.Tensor, k: int, valid_n=None) -> bool:
    """The box-pruned kernel's gate: a CUDA cloud of at least
    ``CELLS_MIN_KEYS`` keys, every key valid, ``2 <= k <= MAX_K`` (k = 1,
    the chamfer's nearest neighbour, keeps the flat kernel's running
    minimum); a few-neighbour search with more queries than keys (``k <=
    3``, ``S > N``) needs ``CELLS_MIN_KEYS_FEW`` keys (on the H100 the flat
    kernel won the 64,000-query 3-NN at 1,024 and 4,096 keys and lost it at
    16,384, PERF.md).  False for a CPU tensor."""
    N = points.shape[1]
    few = k <= 3 and query.shape[1] > N
    return (points.is_cuda and valid_n is None and 2 <= k <= MAX_K
            and N >= (CELLS_MIN_KEYS_FEW if few else CELLS_MIN_KEYS))


def knn_cells_plan(query: torch.Tensor, points: torch.Tensor, self_knn: bool,
                   chunk: int = CELLS_CHUNK, tile: int = CELLS_TILE,
                   key_valid: torch.Tensor | None = None):
    """The pruned kernel's inputs besides k: ``(keys [B, Np, 4]`` Morton-
    sorted rows (x, y, z, original index as int32 bits; pad rows NaN),
    ``qry [B, Sp, 4]`` the sorted queries likewise (pad rows with index
    >= S; the same tensor as ``keys`` when ``self_knn`` with no mask: one
    shared sort), ``boxes [B, nc, 2, 4]`` each chunk's (lo, hi) over its
    real keys, ``order [B, nt, nc]`` int32 each tile of ``tile`` sorted
    queries' chunks by ascending sort key, ``lbs [B, nt, nc]`` those keys:
    the tile's box bound, and for the chunks of bound 0 a key below 0 that
    puts the nearest first (the tile's own chunk, then its neighbours in the
    sorted order in the self case; by box centres in the cross case), so
    that a tile's list fills from its nearest keys).

    ``key_valid [B, N]`` bool (the segment form only): an invalid key's row
    is NaN in ``keys`` (it rides the sort; no comparison passes), the chunk
    boxes cover the valid keys only, and a chunk with none has the sort key
    NaN, sorted last; ``qry`` keeps every query's coordinates (a query
    whose own key is invalid is still a query), its tiles' boxes over them."""
    B, N, _ = points.shape
    S = query.shape[1]
    if self_knn and chunk % tile:
        raise ValueError(f"knn_cells plan: the shared sort needs tile={tile} to divide "
                         f"chunk={chunk}")
    pts, perm = sort_by_morton(points, (-N) % chunk)
    valid = perm < N if N % chunk else None  # None: no pad row
    kvalid = valid
    if key_valid is not None:
        kv = torch.gather(key_valid.to(pts.device, torch.bool), 1, perm.clamp(max=N - 1).long())
        kvalid = kv if valid is None else kv & valid
    if self_knn:
        qs, qperm, qvalid = pts, perm, valid
    else:
        qs, qperm = sort_by_morton(query, (-S) % tile)
        qvalid = qperm < S if S % tile else None
    qlo, qhi = chunk_boxes(qs, tile, qvalid)
    if self_knn and key_valid is None:  # a chunk's box is its tiles' box
        r = (B, -1, chunk // tile, 3)
        lo, hi = qlo.reshape(r).amin(dim=2), qhi.reshape(r).amax(dim=2)
    else:
        lo, hi = chunk_boxes(pts, chunk, kvalid)
    if self_knn:
        near = _own_chunk_keys(qlo.shape[1], lo.shape[1], chunk // tile, lo.device)
    else:
        g = ((qlo + qhi) * 0.5)[..., :, None, :] - ((lo + hi) * 0.5)[..., None, :, :]
        near = -1.0 / ((g * g).sum(-1) + 1e-30)
    lbs = box_lb(qlo, qhi, lo, hi)
    lbs = torch.where(lbs > 0, lbs, near)
    if key_valid is not None:  # a chunk with no valid key: last, and the walk's end
        empty = ~kvalid.reshape(B, -1, chunk).any(-1)
        lbs = torch.where(empty[:, None, :], float("nan"), lbs)
    lbs, order = torch.sort(lbs, dim=-1)
    rows = pts if kvalid is None else torch.where(kvalid[..., None], pts, float("nan"))
    keys = torch.cat([rows, perm[..., None].view(torch.float32)], -1)
    if self_knn and key_valid is None:
        qry = keys
    else:
        qry = torch.cat([qs, qperm[..., None].view(torch.float32)], -1)
    boxes = torch.nn.functional.pad(torch.stack([lo, hi], dim=2), (0, 1))
    return keys, qry, boxes, order.to(torch.int32), lbs


@functools.cache
def _own_chunk_keys(nt: int, nc: int, tiles_a_chunk: int, device: torch.device) -> torch.Tensor:
    """``[nt, nc]`` sort keys below 0, ascending in the distance in the
    sorted order between chunk c and tile t's own chunk."""
    own = torch.arange(nt, device=device)[:, None] // tiles_a_chunk
    gap = (torch.arange(nc, device=device)[None, :] - own).abs().float()
    return -1.0 / (1.0 + gap)


# (device, shapes, self) -> the prep's CUDA graph, its inputs and its plan,
# the most recently used last; at most PLAN_GRAPHS shapes keep their graph
_PLAN_GRAPHS: collections.OrderedDict = collections.OrderedDict()
PLAN_GRAPHS = 4


def knn_cells_plan_graphed(query, points, self_knn: bool, key_valid=None):
    """:func:`knn_cells_plan` of CUDA tensors, replayed from a CUDA graph
    captured once a shape (``_build.graph_replay``): the clouds are copied
    into the graph's inputs and the prep's ~35 small launches run as one,
    so the host's launch time leaves the call.

    The plan's tensors are the graph's own: the next call of the same shape
    overwrites them, so a plan must be consumed (its kernel launched)
    before that call.  Stream order makes this hold, so every call of a
    shape must come on the stream its graph was captured for: another
    stream raises, as does a call while the stream is being captured.  The
    first call of a shape captures, which synchronizes the device; the
    ``PLAN_GRAPHS`` most recently used shapes keep their graph and its
    memory, an older one is dropped.  ``key_valid`` (the self case): the
    mask is one more graph input."""
    key = (points.device, tuple(query.shape), tuple(points.shape), self_knn,
           key_valid is not None)
    if key_valid is not None:
        if not self_knn:
            raise ValueError("knn_cells plan: a key mask in the self case only")
        return _build.graph_replay(
            _PLAN_GRAPHS, PLAN_GRAPHS, key, "knn_cells plan",
            lambda p, v: knn_cells_plan(p, p, True, key_valid=v), points,
            key_valid.to(points.device, torch.bool).contiguous())
    if self_knn:
        return _build.graph_replay(_PLAN_GRAPHS, PLAN_GRAPHS, key, "knn_cells plan",
                                   lambda p: knn_cells_plan(p, p, True), points)
    return _build.graph_replay(_PLAN_GRAPHS, PLAN_GRAPHS, key, "knn_cells plan",
                               lambda q, p: knn_cells_plan(q, p, False), query, points)


def knn_cells_launch(query, points, k, plan, scanned=None, stamps=None):
    """One launch of csrc/knn_cells.cu on a :func:`knn_cells_plan` plan
    (counted in ``knn_cells_kernel.launches``).  ``scanned``: an int64 ``[1]``
    CUDA tensor that gains the (query, key) pairs the kernel scanned;
    ``stamps``: a zeroed int64 ``[B, nt, STAMPS]`` CUDA tensor that takes
    each tile's start and end (``%globaltimer`` ns), chunks walked, list
    inserts and pairs scanned."""
    dev = points.device
    B, N, _ = points.shape
    S = query.shape[1]
    if not 1 <= k <= min(MAX_K, N):
        raise ValueError(f"knn_cells kernel: k={k} needs 1 <= k <= min({MAX_K}, N={N})")
    keys, qry, boxes, order, lbs = plan
    for name, t in zip(("keys", "qry", "boxes", "order", "lbs"), plan):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"knn_cells kernel: the plan's {name} must be contiguous on {dev}")
    if scanned is not None:
        _build.require(scanned, "scanned", torch.int64, 1, dev)
    if stamps is not None:
        _build.require(stamps, "stamps", torch.int64, 3, dev)
        if stamps.shape != (*order.shape[:2], STAMPS):
            raise ValueError(f"knn_cells kernel: stamps must be {(*order.shape[:2], STAMPS)}")
    Np, Sp, nc = keys.shape[1], qry.shape[1], boxes.shape[1]
    dist = torch.empty((B, S, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, S, k), dtype=torch.int64, device=dev)
    err = _build.library().pci_knn_cells(
        keys.data_ptr(), qry.data_ptr(), boxes.data_ptr(), order.data_ptr(), lbs.data_ptr(),
        dist.data_ptr(), idx.data_ptr(), scanned.data_ptr() if scanned is not None else None,
        stamps.data_ptr() if stamps is not None else None,
        B, S, Np, Sp, Np // nc, Sp // order.shape[1], k, _build.stream_ptr(dev),
    )
    _build.check_launch("knn_cells", err)
    knn_cells_kernel.launches += 1
    return dist, idx


def knn_cells_kernel(query, points, k, scanned=None):
    """The box-pruned kNN, prep (:func:`knn_cells_plan_graphed`) and launch:
    :func:`knn`'s function with ``valid_n=None``.  Pass the same tensor as
    ``query`` and ``points`` for the self case (one shared sort)."""
    dev = points.device
    for name, t in (("query", query), ("points", points)):
        _build.require(t, name, torch.float32, 3, dev)
    if points.shape[-1] != 3 or query.shape[-1] != 3 or query.shape[0] != points.shape[0]:
        raise ValueError("knn_cells kernel takes [B, S, 3] queries and [B, N, 3] keys")
    plan = knn_cells_plan_graphed(query, points, query is points)
    return knn_cells_launch(query, points, k, plan, scanned)


knn_cells_kernel.launches = 0


def knn_cells(query: torch.Tensor, points: torch.Tensor, k: int,
              key_valid: torch.Tensor | None = None, emit_resi: bool = False):
    """``pci_tpu/ops/pallas_kernels/knn_cells_tpu.py:knn_cells``' function,
    exact: ``(sq_dists [B, S, k], idx [B, S, k] int64[, resi [B, S, k,
    3]])``, ascending, ties to the lower key index, over the keys where
    ``key_valid [B, N]`` holds (every key for None; a mask in the self
    case only: pass the same tensor as ``query`` and ``points``).  A slot
    with no valid key left is the query's own row, distance ``SENTINEL``,
    residual 0.  ``emit_resi``: the exact fp32 ``points[idx] - query``.
    On a CUDA tensor the segment form of csrc/knn_cells.cu (1 <= k <=
    min(MAX_K, N), xyz clouds), else :func:`knn_cells_plain`."""
    self_knn = query is points
    if key_valid is not None and not self_knn:
        raise ValueError("knn_cells: key_valid in the self case only (query is points)")
    query, points = query.detach(), points.detach()
    if not _build.use_kernel(points):
        return knn_cells_plain(query, points, k, key_valid, emit_resi)
    points = points.float().contiguous()
    query = points if self_knn else query.float().contiguous()
    dev = points.device
    for name, t in (("query", query), ("points", points)):
        _build.require(t, name, torch.float32, 3, dev)
    B, N, C = points.shape
    S = query.shape[1]
    if C != 3 or query.shape[-1] != 3 or query.shape[0] != B:
        raise ValueError("knn_cells kernel takes [B, S, 3] queries and [B, N, 3] keys")
    if not 1 <= k <= min(MAX_K, N):
        raise ValueError(f"knn_cells kernel: k={k} needs 1 <= k <= min({MAX_K}, N={N})")
    if key_valid is not None and key_valid.shape != (B, N):
        raise ValueError(f"knn_cells kernel: key_valid must be {(B, N)}")
    plan = knn_cells_plan_graphed(query, points, self_knn, key_valid)
    dist = torch.empty((B, S, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, S, k), dtype=torch.int64, device=dev)
    resi = torch.empty((B, S, k, 3), dtype=torch.float32, device=dev) if emit_resi else None
    knn_cells_seg_launch(query, points, k, plan, out_d=dist, out_i=idx, out_r=resi)
    return (dist, idx, resi) if emit_resi else (dist, idx)


def knn_cells_seg_launch(query, points, k, plan, *, budgets=None, col0=None, ks=None,
                         fill=False, out_d=None, out_i=None, out_r=None, scanned=None):
    """One launch of csrc/knn_cells.cu's segment form on a
    :func:`knn_cells_plan` plan (counted in ``knn_cells_kernel.launches``):
    it writes each query row's slots ``[col0[b], col0[b] + min(budgets[b],
    k))`` of ``out_i [B, S, ks]`` int64 (required), ``out_d [B, S, ks]``
    and ``out_r [B, S, ks, 3]`` (each optional; ``out_r`` takes the
    residuals from ``points``), and with ``fill`` the row's slots past its
    budget as unfilled (the query's own row).  ``budgets``/``col0``: ``[B]``
    int32 CUDA tensors, or None (k, 0).  ``scanned`` as
    :func:`knn_cells_launch`'s."""
    dev = points.device
    B, N, _ = points.shape
    S = query.shape[1]
    ks = k if ks is None else ks
    if not 1 <= k <= min(MAX_K, ks):
        raise ValueError(f"knn_cells kernel: k={k} needs 1 <= k <= min({MAX_K}, ks={ks})")
    keys, qry, boxes, order, lbs = plan
    for name, t in zip(("keys", "qry", "boxes", "order", "lbs"), plan):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"knn_cells kernel: the plan's {name} must be contiguous on {dev}")
    _build.require(out_i, "out_i", torch.int64, 3, dev)
    if out_i.shape != (B, S, ks):
        raise ValueError(f"knn_cells kernel: out_i must be {(B, S, ks)}")
    for name, t, shape in (("out_d", out_d, (B, S, ks)), ("out_r", out_r, (B, S, ks, 3))):
        if t is not None:
            _build.require(t, name, torch.float32, len(shape), dev)
            if t.shape != shape:
                raise ValueError(f"knn_cells kernel: {name} must be {shape}")
    for name, t in (("budgets", budgets), ("col0", col0)):
        if t is not None:
            _build.require(t, name, torch.int32, 1, dev)
            if t.shape != (B,):
                raise ValueError(f"knn_cells kernel: {name} must be [B]")
    if scanned is not None:
        _build.require(scanned, "scanned", torch.int64, 1, dev)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    Np, Sp, nc = keys.shape[1], qry.shape[1], boxes.shape[1]
    err = _build.library().pci_knn_cells_seg(
        keys.data_ptr(), qry.data_ptr(), boxes.data_ptr(), order.data_ptr(), lbs.data_ptr(),
        points.data_ptr(), ptr(budgets), ptr(col0), ptr(out_d), out_i.data_ptr(), ptr(out_r),
        ptr(scanned), B, S, N, Np, Sp, Np // nc, Sp // order.shape[1], k, ks,
        int(fill), _build.stream_ptr(dev),
    )
    _build.check_launch("knn_cells", err)
    knn_cells_kernel.launches += 1


def knn_cells_plain(query, points, k, key_valid=None, emit_resi=False):
    """:func:`knn_cells`' function by PyTorch ops: the exact kNN over the
    valid keys (an invalid key's distance NaN, which a stable sort puts
    after every number), then each slot that took an invalid key becomes
    the query's own row with distance ``SENTINEL``; residuals by the picked
    indices.  Query blocks of bounded size, as :func:`knn_plain`."""
    query, points = query.detach().float(), points.detach().float()
    B, S = query.shape[:2]
    N = points.shape[1]
    if not 1 <= k <= N:
        raise ValueError(f"knn_cells: k={k} needs 1 <= k <= N={N}")
    rows = max(1, _PLAIN_BLOCK // max(1, B * N))
    valid = None if key_valid is None else key_valid.to(points.device, torch.bool)
    dists, idxs = [], []
    for s in range(0, S, rows):
        d = square_distance(query[:, s:s + rows], points)
        if valid is not None:
            d = torch.where(valid[:, None, :], d, float("nan"))
        d, i = select_min_k(d, k)
        if valid is not None:
            none = ~torch.gather(valid, 1, i.reshape(B, -1)).reshape(i.shape)
            own = torch.arange(s, s + i.shape[1], device=i.device)[None, :, None]
            d = torch.where(none, SENTINEL, d)
            i = torch.where(none, own, i)
        dists.append(d)
        idxs.append(i)
    dist, idx = torch.cat(dists, 1), torch.cat(idxs, 1)
    if not emit_resi:
        return dist, idx
    resi = torch.gather(points, 1, idx.reshape(B, -1, 1).expand(-1, -1, 3)).reshape(
        B, S, k, 3) - query[:, :, None, :]
    return dist, idx, resi


def _launch(query, points, k, valid_n):
    dev = points.device
    for name, t in (("query", query), ("points", points)):
        _build.require(t, name, torch.float32, 3, dev)
    B, N, C = points.shape
    S = query.shape[1]
    if C != 3 or query.shape[-1] != 3 or query.shape[0] != B:
        raise ValueError("knn kernel takes [B, S, 3] queries and [B, N, 3] keys")
    if not 1 <= k <= min(FLAT_MAX_K, N):
        raise ValueError(f"knn kernel: k={k} needs 1 <= k <= min({FLAT_MAX_K}, N={N})")
    if valid_n is not None:
        valid_n = valid_n.to(dev, torch.int32).reshape(B).contiguous()
    dist = torch.empty((B, S, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, S, k), dtype=torch.int64, device=dev)
    err = _build.library().pci_knn(
        query.data_ptr(), points.data_ptr(),
        None if valid_n is None else valid_n.data_ptr(),
        dist.data_ptr(), idx.data_ptr(), B, N, S, k, _build.stream_ptr(dev),
    )
    _build.check_launch("knn", err)
    return dist, idx


def knn_kernel(query, points, k, valid_n=None):
    """Launch csrc/knn.cu: at k = 1 :func:`nearest_kernel` (counted in
    ``nearest_launches``), else the list kernel (``knn_kernel.launches``)."""
    if k == 1:
        return nearest_kernel(query, points, valid_n)
    out = _launch(query, points, k, valid_n)
    knn_kernel.launches += 1
    return out


knn_kernel.launches = 0
nearest_launches = types.SimpleNamespace(launches=0)


def nearest_shape(B: int, N: int, S: int):
    """The k = 1 kernel's launch at these sizes: ``(C`` CTAs a cluster,
    CTAs in the grid, the card's SMs``)``."""
    out = (ctypes.c_int * 3)()
    _build.check_launch("nearest shape", _build.library().pci_nearest_shape(B, N, S, out))
    return tuple(out)


def nearest_kernel(query, points, valid_n=None, marked=None, stamps=None):
    """One launch of csrc/knn.cu's k = 1 kernel (the keys split over the
    CTAs of a cluster, merged in range order): :func:`knn`'s function at
    k = 1.  ``marked``: a zeroed int64 ``[1]`` CUDA tensor that gains the
    pairs the three-FMA mark sent to the exact test; ``stamps``: a zeroed
    int64 ``[CTAs, 2]`` tensor (:func:`nearest_shape`) taking each CTA's
    start and end (``%globaltimer`` ns); both or neither (measurement
    only)."""
    dev = points.device
    for name, t in (("query", query), ("points", points)):
        _build.require(t, name, torch.float32, 3, dev)
    B, N, C = points.shape
    S = query.shape[1]
    if C != 3 or query.shape[-1] != 3 or query.shape[0] != B or N < 1:
        raise ValueError("nearest kernel takes [B, S, 3] queries and [B, N >= 1, 3] keys")
    if (marked is None) != (stamps is None):
        raise ValueError("nearest kernel: marked and stamps go together")
    if marked is not None:
        _build.require(marked, "marked", torch.int64, 1, dev)
        _build.require(stamps, "stamps", torch.int64, 2, dev)
        if stamps.shape != (nearest_shape(B, N, S)[1], 2):
            raise ValueError(f"nearest kernel: stamps must be {(nearest_shape(B, N, S)[1], 2)}")
    if valid_n is not None:
        valid_n = valid_n.to(dev, torch.int32).reshape(B).contiguous()
    dist = torch.empty((B, S, 1), dtype=torch.float32, device=dev)
    idx = torch.empty((B, S, 1), dtype=torch.int64, device=dev)
    err = _build.library().pci_nearest(
        query.data_ptr(), points.data_ptr(),
        None if valid_n is None else valid_n.data_ptr(), dist.data_ptr(), idx.data_ptr(),
        B, N, S, None if marked is None else marked.data_ptr(),
        None if stamps is None else stamps.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check_launch("nearest", err)
    nearest_launches.launches += 1
    return dist, idx


def select_min_k(d: torch.Tensor, k: int):
    """Row-wise ``k`` least of ``d [..., N]`` by a stable sort (copies:
    a slice would keep the whole sorted block alive)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].contiguous()


def knn_plain(query, points, k, valid_n=None):
    """Query blocks of bounded size: one ``[rows, N]`` distance matrix,
    masked past ``valid_n``, and its stable sort at a time."""
    query, points = query.detach(), points.detach()
    B, S = query.shape[:2]
    N = points.shape[1]
    rows = max(1, _PLAIN_BLOCK // max(1, B * N))
    mask = None
    if valid_n is not None:
        pos = torch.arange(N, device=points.device)
        mask = pos[None, None, :] < valid_n.to(points.device).reshape(B)[:, None, None]
    parts = []
    for s in range(0, S, rows):
        d = square_distance(query[:, s:s + rows], points)
        if mask is not None:
            d = torch.where(mask, d, torch.tensor(SENTINEL, device=d.device))
        parts.append(select_min_k(d, k))
    return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)
