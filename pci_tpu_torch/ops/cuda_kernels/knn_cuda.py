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
                   chunk: int = CELLS_CHUNK, tile: int = CELLS_TILE):
    """The pruned kernel's inputs besides k: ``(keys [B, Np, 4]`` Morton-
    sorted rows (x, y, z, original index as int32 bits; pad rows NaN),
    ``qry [B, Sp, 4]`` the sorted queries likewise (pad rows with index
    >= S; the same tensor as ``keys`` when ``self_knn``: one shared sort),
    ``boxes [B, nc, 2, 4]`` each chunk's (lo, hi) over its real keys,
    ``order [B, nt, nc]`` int32 each tile of ``tile`` sorted queries' chunks
    by ascending sort key, ``lbs [B, nt, nc]`` those keys: the tile's box
    bound, and for the chunks of bound 0 a key below 0 that puts the
    nearest first (the tile's own chunk, then its neighbours in the sorted
    order in the self case; by box centres in the cross case), so that a
    tile's list fills from its nearest keys)."""
    B, N, _ = points.shape
    S = query.shape[1]
    if self_knn and chunk % tile:
        raise ValueError(f"knn_cells plan: the shared sort needs tile={tile} to divide "
                         f"chunk={chunk}")
    pts, perm = sort_by_morton(points, (-N) % chunk)
    valid = perm < N if N % chunk else None  # None: no pad row
    if self_knn:
        qs, qvalid = pts, valid
    else:
        qs, qperm = sort_by_morton(query, (-S) % tile)
        qvalid = qperm < S if S % tile else None
    qlo, qhi = chunk_boxes(qs, tile, qvalid)
    if self_knn:  # a chunk's box is its tiles' box
        r = (B, -1, chunk // tile, 3)
        lo, hi = qlo.reshape(r).amin(dim=2), qhi.reshape(r).amax(dim=2)
        near = _own_chunk_keys(qlo.shape[1], lo.shape[1], chunk // tile, lo.device)
    else:
        lo, hi = chunk_boxes(pts, chunk, valid)
        g = ((qlo + qhi) * 0.5)[..., :, None, :] - ((lo + hi) * 0.5)[..., None, :, :]
        near = -1.0 / ((g * g).sum(-1) + 1e-30)
    lbs = box_lb(qlo, qhi, lo, hi)
    lbs, order = torch.sort(torch.where(lbs > 0, lbs, near), dim=-1)
    rows = pts if valid is None else torch.where(valid[..., None], pts, float("nan"))
    keys = torch.cat([rows, perm[..., None].view(torch.float32)], -1)
    qry = keys if self_knn else torch.cat([qs, qperm[..., None].view(torch.float32)], -1)
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


def knn_cells_plan_graphed(query, points, self_knn: bool):
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
    memory, an older one is dropped."""
    key = (points.device, tuple(query.shape), tuple(points.shape), self_knn)
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
