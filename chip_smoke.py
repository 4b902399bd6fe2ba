#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pci_tpu_torch) of PointINet on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit, torch and CUDA versions;
     TF32 off for matmuls and convolutions (the plain versions run fp32).
  2. build: the four CUDA kernels from pci_tpu_torch/csrc with nvcc.
  3. kernels: each kernel against its plain PyTorch version on the card at
     every main-path shape, recorded from one plain forward of a 16,384-point
     request (plus FPS with P=1 at 16,384 and fusion at t=0.2); the times
     are medians of CUDA-event timings.
  4. serving: Interpolator.pointinet(npoints=16384) with the trained weights
     answers five requests (t=0.5, then upsample(factor=5)); the launch
     counters must rise by 8 FPS, 8 set-conv, 10 kNN-conv and 1 fusion a
     request, every frame must be [16384, 3] and finite, and one frame must
     match the same forward through the plain versions.
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
}
PER_REQUEST = {"fps": 8, "setconv": 8, "knnconv": 10, "fusion": 1}


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
    fusion_mod = importlib.import_module("pci_tpu_torch.nn.fusion")
    layers_mod = importlib.import_module("pci_tpu_torch.nn.layers")
    fps_mod = importlib.import_module("pci_tpu_torch.ops.fps")  # not ops.fps()
    sites = [(fps_mod, "fps_index", "fps"),
             (layers_mod, "setconv_fused", "setconv"),
             (layers_mod, "knnconv_fused", "knnconv"),
             (fusion_mod, "knn_fusion_attention", "fusion")]
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


def work(name, args, kw, out):
    """(bytes, operations) the function needs on these inputs: each input
    read once, each output written once; data-dependent loops counted as
    this run's data needs them."""
    from pci_tpu_torch.ops import square_distance

    if name == "fps":
        xyz, npoint, _, P = args
        B, N, _ = xyz.shape
        return nbytes(xyz, out), 10.0 * B * npoint * N / P
    if name == "setconv":
        xyz, feats, new_xyz, radius, K, layers = args
        B, N, _ = xyz.shape
        S = new_xyz.shape[1]
        hits = (square_distance(new_xyz, xyz) <= float(radius) ** 2).int().cumsum(-1)
        full = hits[..., -1] >= K
        scanned = torch.where(full, (hits < K).sum(-1) + 1, N).sum().item()
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
        return (f"S={args[0].shape[1]} N={args[1].shape[1]} k={args[5]}"
                f"{' interp' if interp else ''}")
    return f"N={args[0].shape[1]} k={args[4]} budgets={args[2].tolist()}"


def phase_kernels(model, a, b):
    """Each recorded main-path call: kernel vs plain on the card."""
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

    totals = {n: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0,
                  "bytes_ms": 0.0, "ops_ms": 0.0} for n in KERNEL_INFO}
    with torch.inference_mode():
        for i, (name, fn, args, kw) in enumerate(calls):
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            with plain_versions():
                want = fn(*args, **kw)
            torch.cuda.synchronize()
            if name == "fps":
                check(torch.equal(got, want), f"fps {label(name, args, kw)}: indices differ")
                err = 0.0
            else:
                err = (got - want).abs().max().item()
                ok = torch.allclose(got, want, atol=1e-4, rtol=1e-4)
                check(ok, f"{name} {label(name, args, kw)}: max |kernel - plain| {err}")
            ms = cuda_ms(lambda: fn(*args, **kw), 10)
            with plain_versions():
                plain_ms = cuda_ms(lambda: fn(*args, **kw), 3)
            nb, ops = work(name, args, kw, got)
            bytes_ms, ops_ms = nb / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
            print(f"kernel {name:8s} {label(name, args, kw):44s} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={max(bytes_ms, ops_ms):.6f} "
                  f"({'bytes' if bytes_ms > ops_ms else 'operations'}) "
                  f"max_abs_err={err:.3g}")
            t = totals[name]
            t["err"] = max(t["err"], err)
            if i < request:  # one request's worth of launches
                t["ms"] += ms
                t["plain_ms"] += plain_ms
                t["bytes_ms"] += bytes_ms
                t["ops_ms"] += ops_ms
    counts = {n: sum(1 for c in calls[:request] if c[0] == n) for n in KERNEL_INFO}
    check(counts == PER_REQUEST, f"main path dispatches {counts}, expected {PER_REQUEST}")
    for name, t in totals.items():
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = "bytes" if t["bytes_ms"] > t["ops_ms"] else "operations"
        print(f"kernel {name}: {counts[name]} launches a request, {t['ms']:.4f} ms a "
              f"request (plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
              f"by {t['bound_by']}), max_abs_err {t['err']:.3g}")
    return totals, perms


def device_share(interp, a_np, b_np, requests: int = 5):
    """torch.profiler over a few requests: device time by kernel name and
    the share of the window the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(requests):
            interp(a_np, b_np, 0.5)
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
    for key, ms in rows[:8]:
        print(f"  {ms / requests:8.4f} ms  {key[:90]}")


def synthetic_pair():
    """Seeded synthetic 16,384-point pair (bench.py's fallback clouds)."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((NPOINTS, 3)) * 10).astype(np.float32)
    b = a + 0.5 * rng.standard_normal((NPOINTS, 3)).astype(np.float32)
    return a, b


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pci_tpu_torch.ops.cuda_kernels import (
        build_seconds,
        launch_counts,
        plain_versions,
        reset_launch_counts,
    )
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS, Interpolator

    # 1. device
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {card} | torch {torch.__version__} | cuda {torch.version.cuda} "
          f"| count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    print(f"build: {build_seconds():.1f} s (nvcc, sm_90a, all four kernels)")

    # 3. kernels
    interp = Interpolator.pointinet(npoints=NPOINTS, weights=DEFAULT_WEIGHTS, device="cuda")
    a_np, b_np = synthetic_pair()
    a = torch.from_numpy(a_np)[None].cuda()
    b = torch.from_numpy(b_np)[None].cuda()
    totals, perms = phase_kernels(interp.model, a, b)

    # 4. serving: warm up, then count the launches of five requests
    interp(a_np, b_np, 0.5)
    torch.cuda.synchronize()
    reset_launch_counts()
    frames = [interp(a_np, b_np, 0.5)] + interp.upsample(a_np, b_np, factor=5)
    counts = launch_counts()
    n_req = len(frames)
    print(f"serving: {n_req} requests, launches {counts}")
    check(n_req == 5, f"{n_req} frames served")
    check(counts == {k: v * n_req for k, v in PER_REQUEST.items()},
          f"launch counts {counts} != {PER_REQUEST} x {n_req}")
    for f in frames:
        check(f.shape == (NPOINTS, 3) and np.isfinite(f).all(), "bad frame")

    # the same forward through the plain versions, same permutations
    got = interp(a_np, b_np, 0.5, perms=perms)
    with plain_versions():
        want = interp(a_np, b_np, 0.5, perms=perms)
    err = np.abs(got - want).max(axis=1)
    p999 = float(np.quantile(err, 0.999))
    print(f"serving vs plain: max {err.max():.3g} m, p99.9 {p999:.3g} m, "
          f"median {np.median(err):.3g} m, points over 1e-3 m: {(err > 1e-3).sum()}")
    # a 1e-6 difference in the flows can swap a near-tied 32nd neighbour
    check(p999 <= 1e-3 and err.max() <= 0.25, "served frame disagrees with the plain forward")

    # steady-state latency: CUDA events around 20 requests at t=0.5
    ev_ms, host_ms = [], []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        interp(a_np, b_np, 0.5)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        ev_ms.append(start.elapsed_time(end))
    print(f"serving latency on {card}: {statistics.median(ev_ms):.3f} ms/frame "
          f"(CUDA events, median of 20), host clock median "
          f"{statistics.median(host_ms):.3f} ms/frame")
    device_share(interp, a_np, b_np)

    kernels = []
    for kname, (source, replaces) in KERNEL_INFO.items():
        t = totals[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[kname],
            "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
