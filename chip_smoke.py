#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pci_tpu_torch) of PointINet and ISAPCInet
(field=2) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit, torch and CUDA versions;
     TF32 off for matmuls and convolutions (the plain versions run fp32).
  2. build: the seven CUDA kernels from pci_tpu_torch/csrc with nvcc.
  3. kernels: each kernel against its plain PyTorch version on the card at
     every PointINet shape, recorded from one plain forward of a
     16,384-point request (plus FPS with P=1 at 16,384 and fusion at
     t=0.2); the times are medians of CUDA-event timings.
  4. serving: Interpolator.pointinet(npoints=16384) with the trained weights
     answers five requests (t=0.5, then upsample(factor=5)); the launch
     counters must rise by 8 FPS, 8 set-conv, 10 kNN-conv and 1 fusion a
     request, every frame must be [16384, 3] and finite, and one frame must
     match the same forward through the plain versions.
  5. ISAPCInet field=2 at 16,384 points a frame (a seeded six-frame window;
     flow and fusion weights from the trained PointINet, the rest from a
     seeded init): every kernel against its plain version at every shape
     of one plain request (ball query, kNN and FPS indices equal, kNN
     distances bit-equal, the rest within 1e-4), then five served requests
     with the launch counts of PER_REQUEST_ISAPCI each, the frame against
     the plain versions, latency and the device's busy share; one request
     at the default 16,000 points.
Then the kernels JSON line, the card line, and {"ok": true, ...} last.
Exits non-zero, with no result line, when CUDA is missing or a phase fails.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

NPOINTS = 16384
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
KERNEL_INFO = {  # name -> (source, TPU kernel it replaces)
    "fps": ("pci_tpu_torch/csrc/fps.cu",
            "pci_tpu/ops/pallas_kernels/fps_tpu.py:117"),
    "setconv": ("pci_tpu_torch/csrc/setconv.cu",
                "pci_tpu/ops/pallas_kernels/setconv_tpu.py:162"),
    "knnconv": ("pci_tpu_torch/csrc/knnconv.cu",
                "pci_tpu/ops/pallas_kernels/knnconv_tpu.py:161"),
    "fusion": ("pci_tpu_torch/csrc/fusion_knn.cu",
               "pci_tpu/ops/pallas_kernels/fusion_knn_tpu.py:555"),
    "ball": ("pci_tpu_torch/csrc/ball.cu",
             "pci_tpu/ops/pallas_kernels/ball_tpu.py:132"),
    "knn": ("pci_tpu_torch/csrc/knn.cu",
            "pci_tpu/ops/pallas_kernels/knn_cells_tpu.py:242"),
    "attention": ("pci_tpu_torch/csrc/attention.cu",
                  "pci_tpu/ops/pallas_kernels/attention_tpu.py:85"),
}
PER_REQUEST = {"fps": 8, "setconv": 8, "knnconv": 10, "fusion": 1,
               "ball": 0, "knn": 0, "attention": 0}
# ISAPCInet field=2: 6 encodings (2 set-convs, 2 FPS each) and 8 decodes
# (2 set-convs, 2 FPS, 5 kNN-convs each) of FlowNet3D, two PointNet++
# passes (4 FPS, 4 ball queries, 4 FP interpolations each), two
# transformers (1 kNN, 1 attention tail each), one fusion
PER_REQUEST_ISAPCI = {"fps": 36, "setconv": 28, "knnconv": 48, "fusion": 1,
                      "ball": 8, "knn": 2, "attention": 2}
FIELD = 2


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed calls,
    after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def record_calls(calls: list):
    """Record the arguments of every kernel dispatch the model makes."""
    mods = {name: importlib.import_module(f"pci_tpu_torch.{name}")
            for name in ("nn.fusion", "nn.layers", "nn.pointnet2",
                         "nn.transformer", "ops.fps")}  # ops.fps: the module
    sites = [(mods["ops.fps"], "fps_index", "fps"),
             (mods["nn.layers"], "setconv_fused", "setconv"),
             (mods["nn.layers"], "knnconv_fused", "knnconv"),
             (mods["nn.fusion"], "knn_fusion_attention", "fusion"),
             (mods["nn.pointnet2"], "ball_query_multi", "ball"),
             (mods["nn.pointnet2"], "knnconv_fused", "knnconv"),
             (mods["nn.transformer"], "knn", "knn"),
             (mods["nn.transformer"], "vector_attention", "attention")]
    saved = [getattr(mod, attr) for mod, attr, _ in sites]
    for (mod, attr, name), fn in zip(sites, saved):
        def rec(*args, _fn=fn, _name=name, **kw):
            calls.append((_name, _fn, args, kw))
            return _fn(*args, **kw)
        setattr(mod, attr, rec)
    try:
        yield
    finally:
        for (mod, attr, _), fn in zip(sites, saved):
            setattr(mod, attr, fn)


def mlp_flops(layers, rows: int) -> float:
    return rows * sum(2.0 * w.shape[0] * w.shape[1] + 2.0 * w.shape[0]
                      for w, _ in layers)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def scanned_keys(queries, keys, radii, ks) -> float:
    """Keys a first-K-in-index-order ball scan reads: each query's scan
    stops at the key where every scale holds its K hits."""
    from pci_tpu_torch.ops import square_distance

    N = keys.shape[1]
    d = square_distance(queries, keys)
    stop = None
    for r, K in zip(radii, ks):
        hits = (d <= float(r) ** 2).int().cumsum(-1)
        full = hits[..., -1] >= K
        at = torch.where(full, (hits < K).sum(-1) + 1, N)
        stop = at if stop is None else torch.maximum(stop, at)
    return float(stop.sum().item())


def work(name, args, kw, out):
    """(bytes, operations) the function needs on these inputs: each input
    read once, each output written once; data-dependent loops counted as
    this run's data needs them."""
    if name == "fps":
        xyz, npoint, _, P = args
        B, N, _ = xyz.shape
        return nbytes(xyz, out), 10.0 * B * npoint * N / P
    if name == "setconv":
        xyz, feats, new_xyz, radius, K, layers = args
        B = xyz.shape[0]
        S = new_xyz.shape[1]
        scanned = scanned_keys(new_xyz, xyz, [radius], [K])
        w = [t for wb in layers for t in wb]
        ops = 9.0 * scanned + mlp_flops(layers, B * S * K) + B * S * K * layers[-1][0].shape[0]
        return nbytes(xyz, feats, new_xyz, out, *w), ops
    if name == "knnconv":
        q_xyz, k_xyz, k_feats, q_feats, skip, k, mlp1, mlp2 = args[:8]
        interp = kw.get("interp", False)
        B, S, _ = q_xyz.shape
        N = k_xyz.shape[1]
        w = [t for wb in list(mlp1) + list(mlp2) for t in wb]
        ops = 8.0 * B * S * N + mlp_flops(mlp1, B * S * k) + mlp_flops(mlp2, B * S)
        if interp:
            ops += 2.0 * B * S * k * k_feats.shape[-1]
        return nbytes(q_xyz, k_xyz, k_feats, q_feats, skip, out, *w), ops
    if name == "ball":
        radii, ks, xyz, new_xyz = args
        # 8 flops a distance and one compare a scale, per key scanned
        ops = (8.0 + len(ks)) * scanned_keys(new_xyz, xyz, radii, ks)
        return nbytes(xyz, new_xyz, *out), ops
    if name == "knn":
        query, points, k = args
        B, S, _ = query.shape
        return nbytes(query, points, *out), 8.0 * B * S * points.shape[1]
    if name == "attention":
        q, g, delta, tail = args
        B, N, d = q.shape
        k = g.shape[2]
        w = [t for wb in tail for t in wb]
        # four dense layers a slot, then q - K + pos, V + pos, the softmax
        # and the weighted sum: about 8 more operations a (slot, channel)
        ops = 2.0 * B * N * k * (3 * d + 3 * d * d) + 8.0 * B * N * k * d
        return nbytes(q, g, delta, out, *w), ops
    combined, seg_ends, budgets, layers, k = args
    B, N, _ = combined.shape
    w = [t for wb in layers for t in wb]
    ops = 8.0 * B * N * N + mlp_flops(layers, B * N * k) + 6.0 * B * N * k
    return nbytes(combined, seg_ends, budgets, out, *w), ops


def label(name, args, kw) -> str:
    if name == "fps":
        return f"N={args[0].shape[1]} npoint={args[1]} P={args[3]}"
    if name == "setconv":
        return f"N={args[0].shape[1]} S={args[2].shape[1]} K={args[4]} C_in={3 + args[1].shape[-1]}"
    if name == "knnconv":
        interp = kw.get("interp", False)
        mode = f" interp {kw.get('recip', 'clamp')} D={args[2].shape[-1]}" if interp else ""
        return f"S={args[0].shape[1]} N={args[1].shape[1]} k={args[5]}{mode}"
    if name == "ball":
        return f"N={args[2].shape[1]} S={args[3].shape[1]} r={list(args[0])} K={list(args[1])}"
    if name == "knn":
        return f"S={args[0].shape[1]} N={args[1].shape[1]} k={args[2]}"
    if name == "attention":
        return f"N={args[0].shape[1]} k={args[1].shape[2]} d={args[0].shape[2]}"
    return f"N={args[0].shape[1]} k={args[4]} budgets={args[2].tolist()}"


def compare(name, got, want, where: str) -> float:
    """Hold a kernel's result against its plain version's; returns the
    max abs error (0 for exact index results)."""
    if name == "fps":
        check(torch.equal(got, want), f"fps {where}: indices differ")
        return 0.0
    if name == "ball":
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"ball {where}: indices differ")
        return 0.0
    if name == "knn":
        check(torch.equal(got[1], want[1]), f"knn {where}: indices differ")
        check(torch.equal(got[0], want[0]), f"knn {where}: distances not bit-equal")
        return 0.0
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, atol=1e-4, rtol=1e-4)
    check(ok, f"{name} {where}: max |kernel - plain| {err}")
    return err


def new_totals():
    return {n: {"ms": 0.0, "plain_ms": 0.0, "err": 0.0, "bytes_ms": 0.0,
                "ops_ms": 0.0} for n in KERNEL_INFO}


def hold_kernels(calls, request: int, expected: dict, totals: dict, path: str):
    """Each recorded call: kernel vs plain on the card, timed; the first
    ``request`` calls are one request's launches.  Prints the path's sums
    a request and adds them to ``totals`` (both paths' requests)."""
    from pci_tpu_torch.ops.cuda_kernels import plain_versions

    own = new_totals()
    counts = {n: sum(1 for c in calls[:request] if c[0] == n) for n in KERNEL_INFO}
    check(counts == expected, f"{path} dispatches {counts} a request, expected {expected}")
    with torch.inference_mode():
        for i, (name, fn, args, kw) in enumerate(calls):
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            with plain_versions():
                want = fn(*args, **kw)
            torch.cuda.synchronize()
            err = compare(name, got, want, label(name, args, kw))
            ms = cuda_ms(lambda: fn(*args, **kw), 10)
            with plain_versions():
                plain_ms = cuda_ms(lambda: fn(*args, **kw), 3)
            nb, ops = work(name, args, kw, got)
            bytes_ms, ops_ms = nb / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
            print(f"kernel {name:9s} {label(name, args, kw):52s} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={max(bytes_ms, ops_ms):.6f} "
                  f"({'bytes' if bytes_ms > ops_ms else 'operations'}) "
                  f"max_abs_err={err:.3g}")
            t = own[name]
            t["err"] = max(t["err"], err)
            if i < request:  # one request's worth of launches
                t["ms"] += ms
                t["plain_ms"] += plain_ms
                t["bytes_ms"] += bytes_ms
                t["ops_ms"] += ops_ms
    for name in KERNEL_INFO:
        for key, val in own[name].items():
            totals[name][key] = max(totals[name][key], val) if key == "err" \
                else totals[name][key] + val
        if counts[name]:
            t = own[name]
            print(f"{path} kernel {name}: {counts[name]} launches a request, "
                  f"{t['ms']:.4f} ms a request (plain {t['plain_ms']:.4f} ms, bound "
                  f"{max(t['bytes_ms'], t['ops_ms']):.6f} ms by "
                  f"{'bytes' if t['bytes_ms'] > t['ops_ms'] else 'operations'}), "
                  f"max_abs_err {t['err']:.3g}")


def phase_kernels(model, a, b, totals):
    """PointINet's recorded main-path calls: kernel vs plain on the card."""
    from pci_tpu_torch.ops.cuda_kernels import plain_versions
    from pci_tpu_torch.ops.cuda_kernels.fps_cuda import fps_index

    dev = a.device
    z = torch.zeros_like(a)
    n = a.shape[1]
    perms = tuple(torch.randperm(n, generator=torch.Generator().manual_seed(s))[None].to(dev)
                  for s in (1, 2))
    calls = []
    with torch.inference_mode(), plain_versions(), record_calls(calls):
        model(a, b, z, z, torch.tensor([0.5], device=dev), perms=perms)
        request = len(calls)
        model(a, b, z, z, torch.tensor([0.2], device=dev), perms=perms)
    calls = calls[:request] + [c for c in calls[request:] if c[0] == "fusion"]
    calls.append(("fps", fps_index, (a, 1024, torch.zeros(1, dtype=torch.long, device=dev), 1), {}))
    hold_kernels(calls, request, PER_REQUEST, totals, "pointinet")
    return perms


def device_share(serve, requests: int = 5):
    """torch.profiler over a few requests: device time by kernel name and
    the share of the window the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(requests):
            serve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms in rows)
    if busy_ms == 0:
        print("device busy share: not measured (the profiler saw no device time)")
        return
    print(f"device busy {busy_ms / requests:.3f} ms of {wall_ms / requests:.3f} ms a "
          f"request ({100 * busy_ms / wall_ms:.1f}% busy, "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% idle), top device time per request:")
    for key, ms in rows[:10]:
        print(f"  {ms / requests:8.4f} ms  {key[:90]}")


def latency(serve, card: str, path: str) -> None:
    """Steady-state latency: CUDA events around 20 requests."""
    ev_ms, host_ms = [], []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        serve()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        ev_ms.append(start.elapsed_time(end))
    print(f"{path} serving latency on {card}: {statistics.median(ev_ms):.3f} ms/frame "
          f"(CUDA events, median of 20), host clock median "
          f"{statistics.median(host_ms):.3f} ms/frame")


def agreement(got, want, what: str):
    """Per-point max error of a served frame against its plain twin."""
    err = np.abs(got - want).max(axis=1)
    p999 = float(np.quantile(err, 0.999))
    print(f"{what}: max {err.max():.3g} m, p99.9 {p999:.3g} m, median "
          f"{np.median(err):.3g} m, points over 1e-3 m: {(err > 1e-3).sum()}")
    return p999, float(err.max())


def serve_counts(serve_all, expected: dict, path: str):
    """Counts set to 0, five requests served, counts read: each kernel of
    the path launched its per-request count, no other kernel launched."""
    from pci_tpu_torch.ops.cuda_kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    frames = serve_all()
    counts = launch_counts()
    n_req = len(frames)
    print(f"{path} serving: {n_req} requests, launches {counts}")
    check(n_req == 5, f"{n_req} frames served")
    check(counts == {k: v * n_req for k, v in expected.items()},
          f"{path} launch counts {counts} != {expected} x {n_req}")
    for f in frames:
        check(f.shape == (NPOINTS, 3) and np.isfinite(f).all(), f"{path}: bad frame")
    return counts


def synthetic_pair():
    """Seeded synthetic 16,384-point pair (bench.py's fallback clouds)."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((NPOINTS, 3)) * 10).astype(np.float32)
    b = a + 0.5 * rng.standard_normal((NPOINTS, 3)).astype(np.float32)
    return a, b


def synthetic_window(n: int = NPOINTS):
    """Seeded six-frame window ``frame_i = a + i * v + 0.05 noise`` at
    times -2, -1 (the forward context, nearest first), 0, 1 (the key
    pair), 2, 3 (the backward context): ``a`` as in synthetic_pair, ``v``
    a per-point velocity of 0.5 m a frame that turns with the position
    (a slow rotation plus a drift), so the flows spread over a metre."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((n, 3)) * 10).astype(np.float32)
    v = 0.05 * np.stack([-a[:, 1], a[:, 0], np.zeros(n, np.float32)], 1) + np.float32([0.3, 0.1, 0.0])
    frame = {i: (a + i * v + 0.05 * rng.standard_normal((n, 3))).astype(np.float32)
             for i in range(-FIELD, FIELD + 2)}
    fwd = [frame[-1 - j] for j in range(FIELD)]
    bwd = [frame[2 + j] for j in range(FIELD)]
    return fwd, (frame[0], frame[1]), bwd


def phase_isapci(card: str, totals: dict) -> dict:
    """ISAPCInet field=2: kernels at every shape of one plain request, then
    serving, agreement with the plain versions, latency, busy share."""
    from pci_tpu_torch.ops.cuda_kernels import plain_versions
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS, Interpolator

    interp = Interpolator.isapci(field=FIELD, npoints=NPOINTS, weights=DEFAULT_WEIGHTS,
                                 device="cuda")
    model = interp.model
    fwd, (k0, k1), bwd = synthetic_window()
    context = (fwd, bwd)
    dev = torch.device("cuda")
    T = lambda x: torch.from_numpy(x)[None].to(dev)  # noqa: E731
    fwd_t, keys_t, bwd_t = [T(x) for x in fwd], [T(k0), T(k1)], [T(x) for x in bwd]
    z = torch.zeros_like(keys_t[0])
    tt = torch.tensor([0.5], device=dev)
    perms = tuple(torch.randperm(NPOINTS, generator=torch.Generator().manual_seed(s))[None].to(dev)
                  for s in (3, 4))

    calls = []
    with torch.inference_mode(), plain_versions(), record_calls(calls):
        model(fwd_t, keys_t, bwd_t, tt, z, perms=perms)
    hold_kernels(calls, len(calls), PER_REQUEST_ISAPCI, totals, "isapci")

    interp(k0, k1, 0.5, context=context)  # warm-up
    counts = serve_counts(
        lambda: [interp(k0, k1, 0.5, context=context)]
        + interp.upsample(k0, k1, factor=5, context=context),
        PER_REQUEST_ISAPCI, "isapci")

    # the flows through the kernels and through the plain versions
    with torch.inference_mode():
        flows = model.window_flows(fwd_t, keys_t, bwd_t, z)
        with plain_versions():
            flows_plain = model.window_flows(fwd_t, keys_t, bwd_t, z)
        flow_err = max((f - g).abs().max().item() for f, g in zip(flows, flows_plain))
        print(f"isapci flows vs plain: max {flow_err:.3g} m over "
              f"{2 * flows[0].numel() // 3} flow vectors")
        check(flow_err <= 1e-3, "isapci: kernel flows disagree with the plain flows")
        # the rest of the forward from the same flows: PointNet++ and the
        # transformer select (FPS, ball, kNN) over the flow cloud, so a
        # 1e-6 flow difference may flip a pick; given the same flows,
        # kernels and plain versions must give the same frame
        got = model.from_flows(*flows, keys_t, tt, perms=perms)[0].cpu().numpy()
        with plain_versions():
            want = model.from_flows(*flows, keys_t, tt, perms=perms)[0].cpu().numpy()
    p999, mx = agreement(got, want, "isapci frame vs plain, same flows")
    check(p999 <= 1e-3 and mx <= 0.25, "isapci frame disagrees with the plain forward")
    served = interp(k0, k1, 0.5, context=context, perms=perms)
    with plain_versions():
        plain = interp(k0, k1, 0.5, context=context, perms=perms)
    agreement(served, plain, "isapci frame vs the whole plain forward (flows included)")

    latency(lambda: interp(k0, k1, 0.5, context=context), card, "isapci")
    device_share(lambda: interp(k0, k1, 0.5, context=context))

    default = Interpolator.isapci(field=FIELD, weights=DEFAULT_WEIGHTS, device="cuda")
    frame = default(k0, k1, 0.5, context=context)  # resampled to 16,000
    check(frame.shape == (16000, 3) and np.isfinite(frame).all(),
          "isapci at the default 16,000 points: bad frame")
    print(f"isapci at npoints=16000: frame {frame.shape}, finite")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pci_tpu_torch.ops.cuda_kernels import build_seconds, plain_versions
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS, Interpolator

    # 1. device
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {card} | torch {torch.__version__} | cuda {torch.version.cuda} "
          f"| count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    print(f"build: {build_seconds():.1f} s (nvcc, sm_90a, {len(KERNEL_INFO)} kernels)")

    # 3. kernels at PointINet's shapes
    totals = new_totals()
    interp = Interpolator.pointinet(npoints=NPOINTS, weights=DEFAULT_WEIGHTS, device="cuda")
    a_np, b_np = synthetic_pair()
    a = torch.from_numpy(a_np)[None].cuda()
    b = torch.from_numpy(b_np)[None].cuda()
    perms = phase_kernels(interp.model, a, b, totals)

    # 4. serving: warm up, then count the launches of five requests
    interp(a_np, b_np, 0.5)
    counts = serve_counts(lambda: [interp(a_np, b_np, 0.5)]
                          + interp.upsample(a_np, b_np, factor=5),
                          PER_REQUEST, "pointinet")
    got = interp(a_np, b_np, 0.5, perms=perms)
    with plain_versions():
        want = interp(a_np, b_np, 0.5, perms=perms)
    # a 1e-6 difference in the flows can swap a near-tied 32nd neighbour
    p999, mx = agreement(got, want, "pointinet frame vs plain")
    check(p999 <= 1e-3 and mx <= 0.25, "served frame disagrees with the plain forward")
    latency(lambda: interp(a_np, b_np, 0.5), card, "pointinet")
    device_share(lambda: interp(a_np, b_np, 0.5))

    # 5. ISAPCInet field=2
    counts_isapci = phase_isapci(card, totals)

    kernels = []
    for kname, (source, replaces) in KERNEL_INFO.items():
        t = totals[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": counts[kname] + counts_isapci[kname],
            "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(t["bytes_ms"], t["ops_ms"]),
            "bound_by": "bytes" if t["bytes_ms"] > t["ops_ms"] else "operations",
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
