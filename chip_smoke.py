#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pci_tpu_torch) of PointINet and ISAPCInet
(field=2, served and trained) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit, torch and CUDA versions;
     TF32 off for matmuls and convolutions (the plain versions run fp32).
  2. build: the CUDA kernels from pci_tpu_torch/csrc with nvcc.
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
  6. ISAPCInet field=2 training (the trainer's defaults: 16,000 points,
     batch 2, t = 0.5 and 0.3, Adam lr 0.01, BN momentum 0.5, the flow
     frozen; two seeded synthetic windows): every kernel against its plain
     version at every shape of one plain training step (the attention
     backward at the gradient that step gives it; the residual kNN also
     at three segments, PointsFusionMulti's form, and the chamfer's kNN
     over key prefixes, knn_pallas's valid_n), then one step's loss
     and gradients through the kernels against the plain versions from the
     same flows, permutations and FPS starts, then five steps with the
     launch counts of PER_STEP each, finite losses, the flow bit-unchanged
     and every other parameter moved; ms/step, peak memory, busy share.
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
    "fusion_resi": ("pci_tpu_torch/csrc/fusion_knn.cu",
                    "pci_tpu/ops/pallas_kernels/fusion_knn_tpu.py:489"),
    "nearest": ("pci_tpu_torch/csrc/knn.cu",  # the kNN kernel's k=1 form
                "pci_tpu/ops/pallas_kernels/knn_tpu.py:132"),
    "attention_bwd": ("pci_tpu_torch/csrc/attention_bwd.cu",
                      "pci_tpu/ops/pallas_kernels/attention_tpu.py:358"),
}


def per(**counts) -> dict:
    """Launch counts by kernel, 0 for each kernel not named."""
    return {name: counts.get(name, 0) for name in KERNEL_INFO}


PER_REQUEST = per(fps=8, setconv=8, knnconv=10, fusion=1)
# ISAPCInet field=2: 6 encodings (2 set-convs, 2 FPS each) and 8 decodes
# (2 set-convs, 2 FPS, 5 kNN-convs each) of FlowNet3D, two PointNet++
# passes (4 FPS, 4 ball queries, 4 FP interpolations each), two
# transformers (1 kNN, 1 attention tail each), one fusion
PER_REQUEST_ISAPCI = per(fps=36, setconv=28, knnconv=48, fusion=1, ball=8, knn=2,
                         attention=2)
# ISAPCInet field=2, one training step: the frozen flows as at eval (28
# FPS, 28 set-conv, 40 kNN-conv: 6 encodings x (2 set-convs, 2 FPS), 8
# decodes x (2 set-convs, 2 FPS, 5 kNN-convs)); PointNet++ twice (4 FPS
# with random starts, 4 ball queries, and 4 FP interpolations under
# autograd whose 3-NN runs on the kNN kernel, not on kNN-conv); the
# transformers (2 kNNs, 2 attention forwards, 2 attention backwards); the
# fusion's residual kNN; the chamfer loss's two directions on the kNN
# kernel's k=1 form; the one-shot fusion is eval only
PER_STEP = per(fps=28 + 8, setconv=28, knnconv=40, ball=8, knn=8 + 2, attention=2,
               attention_bwd=2, fusion_resi=1, nearest=2)
FIELD = 2
TRAIN_N, TRAIN_T = 16000, (0.5, 0.3)  # the trainer's npoints; t a sample
TRAIN_LR, TRAIN_MOMENTUM = 0.01, 0.5  # init_lr; bn_momentum_schedule(epoch 0)
STEPS_PER_EPOCH = 1000  # nominal: the lr schedule steps by epoch


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
    """Record the arguments of every kernel dispatch the model makes, and of
    the trainable attention's backward (at the gradient it receives)."""
    from pci_tpu_torch.ops.cuda_kernels import attention_bwd

    mods = {name: importlib.import_module(f"pci_tpu_torch.{name}")
            for name in ("nn.fusion", "nn.layers", "nn.pointnet2",
                         "nn.transformer", "ops.fps", "ops.chamfer",
                         "ops.interpolate")}  # ops.fps: the module
    sites = [(mods["ops.fps"], "fps_index", "fps"),
             (mods["nn.layers"], "setconv_fused", "setconv"),
             (mods["nn.layers"], "knnconv_fused", "knnconv"),
             (mods["nn.fusion"], "knn_fusion_attention", "fusion"),
             (mods["nn.fusion"], "fusion_resi_knn", "fusion_resi"),
             (mods["nn.pointnet2"], "ball_query_multi", "ball"),
             (mods["nn.pointnet2"], "knnconv_fused", "knnconv"),
             (mods["ops.interpolate"], "knn", "knn"),
             (mods["nn.transformer"], "knn", "knn"),
             (mods["nn.transformer"], "vector_attention", "attention"),
             (mods["nn.transformer"], "vector_attention_trainable", "attention"),
             (mods["ops.chamfer"], "knn", "nearest")]
    saved = [getattr(mod, attr) for mod, attr, _ in sites]
    depth = [0]  # a plain version's own dispatches are not the model's
    for (mod, attr, name), fn in zip(sites, saved):
        def rec(*args, _fn=fn, _name=name, _attr=attr, **kw):
            if depth[0]:
                return _fn(*args, **kw)
            calls.append((_name, _fn, args, kw))
            depth[0] += 1
            try:
                out = _fn(*args, **kw)
            finally:
                depth[0] -= 1
            if _attr == "vector_attention_trainable" and out.requires_grad:
                out.register_hook(lambda gout, a=args: calls.append(
                    ("attention_bwd", attention_bwd, (*a, gout.contiguous()), {})))
            return out
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
    if name in ("knn", "nearest"):
        query, points, k = args[:3]
        B, S, _ = query.shape
        valid = args[3] if len(args) > 3 and args[3] is not None else None
        keys = float(valid.clamp(max=points.shape[1]).sum()) if valid is not None \
            else B * points.shape[1]
        return nbytes(query, points, valid, *out), 8.0 * S * keys
    if name == "fusion_resi":
        combined, seg_ends, budgets, k = args
        B, N, _ = combined.shape
        # every (row, key) distance, then a subtraction a slot coordinate
        return nbytes(combined, seg_ends, budgets, *out), 8.0 * B * N * N + 3.0 * B * N * k
    if name == "attention_bwd":
        q, g, delta, tail, gout = args
        B, N, d = q.shape
        R = B * N * g.shape[2]
        w = [t for wb in tail for t in wb]
        # the recomputed forward, then six [R, d] x [d, d] products (three
        # for the inputs' gradients, three for the weights'), the 3-wide
        # ones, and ~20 elementwise operations a (row, channel)
        ops = 2.0 * R * (3 * d + 3 * d * d) + 2.0 * R * (6 * d * d + 6 * d) + 20.0 * R * d
        return nbytes(q, g, delta, gout, *w, *out), ops
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
    if name in ("knn", "nearest"):
        valid = f" valid_n={args[3].tolist()}" if len(args) > 3 and args[3] is not None else ""
        return f"B={args[0].shape[0]} S={args[0].shape[1]} N={args[1].shape[1]} k={args[2]}{valid}"
    if name in ("attention", "attention_bwd"):
        return f"B={args[0].shape[0]} N={args[0].shape[1]} k={args[1].shape[2]} d={args[0].shape[2]}"
    if name == "fusion_resi":
        return f"B={args[0].shape[0]} N={args[0].shape[1]} k={args[3]} ends={args[1].tolist()} " \
               f"budgets={args[2].tolist()}"
    return f"N={args[0].shape[1]} k={args[4]} budgets={args[2].tolist()}"


def relu_gates(q, g, delta, tail, rel: float = 1e-6, chunk: int = 4096):
    """``[M]`` bool: the queries of the attention tail with a hidden
    pre-activation (either ReLU, any slot and channel) within ``rel`` of
    its layer's largest magnitude of 0, where two summation orders can
    round the gate apart; the plain forward in chunks of queries."""
    lin = torch.nn.functional.linear
    (wd0, bd0), (wd1, bd1), (wg0, bg0), _ = tail
    d = q.shape[-1]
    qf, gf, df = q.reshape(-1, d), g.reshape(q.shape[0] * q.shape[1], -1, 2 * d), \
        delta.reshape(q.shape[0] * q.shape[1], -1, 3)
    mins, top = [], [0.0, 0.0]
    with torch.no_grad():
        for s in range(0, qf.shape[0], chunk):
            pre1 = lin(df[s:s + chunk], wd0, bd0)
            pos = lin(torch.relu(pre1), wd1, bd1)
            pre2 = lin(qf[s:s + chunk, None, :] - gf[s:s + chunk, :, :d] + pos, wg0, bg0)
            mins.append(torch.stack([pre1.abs().amin(dim=(1, 2)), pre2.abs().amin(dim=(1, 2))]))
            top = [max(top[0], pre1.abs().max().item()), max(top[1], pre2.abs().max().item())]
    m = torch.cat(mins, 1)
    return (m[0] < rel * top[0]) | (m[1] < rel * top[1])


def compare_attention_bwd(got, want, args, where: str) -> float:
    """dq, dg, ddelta within 1e-4 of their largest magnitude, on the
    queries whose ReLU gates no rounding can flip (a flipped gate is a
    jump in the derivative, not a rounding error: a query has 2 k d
    pre-activations, so 1-2% of them hold one within 1e-6 of the largest;
    they are counted, at most 5% of the queries); the eight weight and bias gradients within 1e-3 of their
    layer's largest weight or bias gradient (each sums ~2M (query, slot)
    rows, in blocks on the card and in chunks in the plain version; the
    last bias's gradient is zero in exact arithmetic, the softmax over k
    cancelling it, so its own magnitude is rounding noise)."""
    q = args[0]
    M = q.shape[0] * q.shape[1]
    gate = relu_gates(*args[:4])
    keep = ~gate
    check(int(gate.sum()) <= 0.05 * M, f"attention_bwd {where}: {int(gate.sum())} of {M} "
                                       f"queries at a ReLU gate")
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if i < 3:
            e = (g.reshape(M, -1)[keep] - w.reshape(M, -1)[keep]).abs().max().item()
            tol = 1e-4 * w.abs().max().item()
        else:
            e = (g - w).abs().max().item()
            layer = want[3 + 2 * ((i - 3) // 2):5 + 2 * ((i - 3) // 2)]
            tol = 1e-3 * max(t.abs().max().item() for t in layer)
        check(e <= tol, f"attention_bwd {where}: output {i} max |kernel - plain| {e} > {tol}")
        err = max(err, e)
    print(f"attention_bwd {where}: {int(gate.sum())} of {M} queries at a ReLU gate left out "
          f"of dq/dg/ddelta; max |kernel - plain| over all queries "
          f"{max((g - w).abs().max().item() for g, w in zip(got[:3], want[:3])):.3g}")
    return err


def compare(name, got, want, where: str, args=()) -> float:
    """Hold a kernel's result against its plain version's; returns the
    max abs error (0 for exact index results)."""
    if name == "fps":
        check(torch.equal(got, want), f"fps {where}: indices differ")
        return 0.0
    if name == "ball":
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"ball {where}: indices differ")
        return 0.0
    if name in ("knn", "nearest"):
        check(torch.equal(got[1], want[1]), f"{name} {where}: indices differ")
        check(torch.equal(got[0], want[0]), f"{name} {where}: distances not bit-equal")
        return 0.0
    if name == "fusion_resi":
        check(torch.equal(got[0], want[0]), f"fusion_resi {where}: indices differ")
        check(torch.equal(got[1], want[1]), f"fusion_resi {where}: residuals not bit-equal")
        return 0.0
    if name == "attention_bwd":
        return compare_attention_bwd(got, want, args, where)
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, atol=1e-4, rtol=1e-4)
    check(ok, f"{name} {where}: max |kernel - plain| {err}")
    return err


def library_call(name, args):
    """One PyTorch call computing the kernel's function on the same
    inputs, where there is one (timed only; the port never uses it):
    ``torch.cdist(...).argmin`` for the nearest neighbour over all keys."""
    if name == "nearest" and args[2] == 1 and (len(args) < 4 or args[3] is None):
        query, points = args[0], args[1]
        return lambda: torch.cdist(query, points).argmin(-1)
    return None


def new_totals():
    return {n: {"ms": 0.0, "plain_ms": 0.0, "err": 0.0, "bytes_ms": 0.0,
                "ops_ms": 0.0, "library_ms": None} for n in KERNEL_INFO}


def hold_kernels(calls, request: int, expected: dict, totals: dict, path: str,
                 unit: str = "request"):
    """Each recorded call: kernel vs plain on the card, timed; the first
    ``request`` calls are one request's (or step's) launches.  Prints the
    path's sums a request and adds them to ``totals`` (every path's)."""
    from pci_tpu_torch.ops.cuda_kernels import plain_versions

    own = new_totals()
    counts = {n: sum(1 for c in calls[:request] if c[0] == n) for n in KERNEL_INFO}
    check(counts == expected, f"{path} dispatches {counts} a {unit}, expected {expected}")
    with torch.inference_mode():
        for i, (name, fn, args, kw) in enumerate(calls):
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            with plain_versions():
                want = fn(*args, **kw)
            torch.cuda.synchronize()
            err = compare(name, got, want, label(name, args, kw), args)
            ms = cuda_ms(lambda: fn(*args, **kw), 10)
            with plain_versions():
                plain_ms = cuda_ms(lambda: fn(*args, **kw), 3)
            lib = library_call(name, args)
            lib_ms = cuda_ms(lib, 3) if lib is not None else None
            nb, ops = work(name, args, kw, got)
            bytes_ms, ops_ms = nb / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
            print(f"kernel {name:9s} {label(name, args, kw):52s} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={max(bytes_ms, ops_ms):.6f} "
                  f"({'bytes' if bytes_ms > ops_ms else 'operations'}) "
                  f"max_abs_err={err:.3g}"
                  + (f" library_ms={lib_ms:.4f}" if lib_ms is not None else ""))
            t = own[name]
            t["err"] = max(t["err"], err)
            if i < request:  # one request's worth of launches
                t["ms"] += ms
                t["plain_ms"] += plain_ms
                t["bytes_ms"] += bytes_ms
                t["ops_ms"] += ops_ms
                if lib_ms is not None:
                    t["library_ms"] = (t["library_ms"] or 0.0) + lib_ms
    for name in KERNEL_INFO:
        for key, val in own[name].items():
            if key == "err":
                totals[name][key] = max(totals[name][key], val)
            elif key == "library_ms":
                if val is not None:
                    totals[name][key] = (totals[name][key] or 0.0) + val
            else:
                totals[name][key] += val
        if counts[name]:
            t = own[name]
            lib = f", library {t['library_ms']:.4f} ms" if t["library_ms"] is not None else ""
            print(f"{path} kernel {name}: {counts[name]} launches a {unit}, "
                  f"{t['ms']:.4f} ms a {unit} (plain {t['plain_ms']:.4f} ms, bound "
                  f"{max(t['bytes_ms'], t['ops_ms']):.6f} ms by "
                  f"{'bytes' if t['bytes_ms'] > t['ops_ms'] else 'operations'}{lib}), "
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


def device_share(serve, requests: int = 5, unit: str = "request"):
    """torch.profiler over a few requests (or steps): device time by
    kernel name and the share of the window the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(requests):
            serve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the device's own events (kernels, copies, fills): a CPU-side op row
    # carries the time of the kernels it launched again, and so does a
    # record_function range's device-side copy (same name as its CPU row)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type != cuda}
    rows = [(e.key, e.self_device_time_total / 1e3) for e in events
            if e.device_type == cuda and e.key not in host]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms in rows)
    if busy_ms == 0:
        print("device busy share: not measured (the profiler saw no device time)")
        return
    print(f"device busy {busy_ms / requests:.3f} ms of {wall_ms / requests:.3f} ms a "
          f"{unit} ({100 * busy_ms / wall_ms:.1f}% busy, "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% idle), top device time per {unit}:")
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


def synthetic_window(n: int = NPOINTS, seed: int = 0, t: float = 0.5):
    """Seeded six-frame window ``frame_i = a + i * v + 0.05 noise`` at
    times -2, -1 (the forward context, nearest first), 0, 1 (the key
    pair), 2, 3 (the backward context): ``a`` as in synthetic_pair (for
    seed 0), ``v`` a per-point velocity of 0.5 m a frame that turns with
    the position (a slow rotation plus a drift), so the flows spread over
    a metre; then the ground truth, the same formula at time ``t``."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((n, 3)) * 10).astype(np.float32)
    v = 0.05 * np.stack([-a[:, 1], a[:, 0], np.zeros(n, np.float32)], 1) + np.float32([0.3, 0.1, 0.0])
    frame = {i: (a + i * v + 0.05 * rng.standard_normal((n, 3))).astype(np.float32)
             for i in range(-FIELD, FIELD + 2)}
    fwd = [frame[-1 - j] for j in range(FIELD)]
    bwd = [frame[2 + j] for j in range(FIELD)]
    gt = (a + np.float32(t) * v + 0.05 * rng.standard_normal((n, 3))).astype(np.float32)
    return fwd, (frame[0], frame[1]), bwd, gt


def phase_isapci(card: str, totals: dict) -> dict:
    """ISAPCInet field=2: kernels at every shape of one plain request, then
    serving, agreement with the plain versions, latency, busy share."""
    from pci_tpu_torch.ops.cuda_kernels import plain_versions
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS, Interpolator

    interp = Interpolator.isapci(field=FIELD, npoints=NPOINTS, weights=DEFAULT_WEIGHTS,
                                 device="cuda")
    model = interp.model
    fwd, (k0, k1), bwd, _ = synthetic_window()
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


def train_batch(dev):
    """The trainer's batch of two: sample b is synthetic_window(TRAIN_N,
    seed=b) with its ground truth at t = TRAIN_T[b]."""
    wins = [synthetic_window(TRAIN_N, seed=b, t=t) for b, t in enumerate(TRAIN_T)]
    stack = lambda xs: torch.from_numpy(np.stack(xs)).to(dev)  # noqa: E731
    return {"forward": [stack([w[0][j] for w in wins]) for j in range(FIELD)],
            "keys": [stack([w[1][j] for w in wins]) for j in range(2)],
            "backward": [stack([w[2][j] for w in wins]) for j in range(FIELD)],
            "t": torch.tensor(TRAIN_T, dtype=torch.float32, device=dev),
            "gt": stack([w[3] for w in wins]),
            "ini": torch.zeros((len(wins), TRAIN_N, 3), device=dev)}


def compare_grads(got: dict, want: dict) -> None:
    """Each trainable gradient through the kernels against the plain
    step's: within 1e-2 of its largest magnitude, plus 1e-5 of the largest
    gradient magnitude in the model G, and with cosine >= 0.999 where its
    magnitude exceeds 1e-3 G (a fusion neighbour can still swap on a 1e-6
    tie, and the attention backward sums ~2M rows in another order).  The
    floor is for gradients that are zero in exact arithmetic and rounding
    noise on both sides: the Dense biases before a train-mode BatchNorm
    (the batch mean cancels them) and the last attention bias (the softmax
    over k cancels it)."""
    G = max(w.abs().max().item() for w in want.values())
    worst, worst_cos, held = (0.0, ""), (1.0, ""), 0
    for name, w in want.items():
        g = got[name]
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        check(err <= 1e-2 * scale + 1e-5 * G,
              f"train: gradient of {name} differs by {err:.3g}, its max {scale:.3g}")
        worst = max(worst, (err / max(scale, 1e-30), name))
        if scale > 1e-3 * G:
            g64, w64 = g.flatten().double(), w.flatten().double()
            cos = (g64 @ w64 / (g64.norm() * w64.norm())).item()
            check(cos >= 0.999, f"train: gradient of {name} has cosine {cos:.6f}")
            worst_cos = min(worst_cos, (cos, name))
            held += 1
    print(f"train step kernels vs plain, same flows/permutations/FPS starts: "
          f"{len(want)} gradients (largest magnitude {G:.4g}), worst max|diff|/max|g| "
          f"{worst[0]:.3g} ({worst[1]}), least cosine {worst_cos[0]:.8f} "
          f"({worst_cos[1]}) over the {held} above 1e-3 of it")


def phase_train(card: str, totals: dict) -> dict:
    """ISAPCInet field=2 training at the trainer's defaults: kernels at
    every shape of one plain step, one step kernels vs plain, five steps
    with their launch counts, ms/step, peak memory, busy share."""
    import copy

    from pci_tpu_torch.convert import load_npz_tree, load_subtrees
    from pci_tpu_torch.models import ISAPCInet
    from pci_tpu_torch.ops.cuda_kernels import (
        launch_counts, plain_versions, reset_launch_counts)
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS, init_weights
    from pci_tpu_torch.train import (
        bn_momentum_schedule, clipped_step_lr, make_interp_train_step, make_optimizer)

    dev = torch.device("cuda")
    batch = train_batch(dev)
    # ISAPCInet(field=2, ff_out_c=64, tr_out_c=64, Tnet, frozen flow): a
    # seeded init, then the flow and fusion of the trained PointINet
    base = ISAPCInet(FIELD)
    init_weights(base, 0)
    load_subtrees(base, load_npz_tree(DEFAULT_WEIGHTS))
    base = base.to(dev)
    lr_sched = clipped_step_lr(TRAIN_LR, 100, 0.9, 1e-6)
    momentum = bn_momentum_schedule(0.5, 0.5, 100, 0.01)(0)
    check(momentum == TRAIN_MOMENTUM, f"bn momentum {momentum} at epoch 0")

    def trainer():
        model = copy.deepcopy(base)
        opt = make_optimizer(lambda step: lr_sched(step // STEPS_PER_EPOCH), model, ("flow",))
        return model, make_interp_train_step(model, opt, ("flow",))

    def draws():  # the permutations and FPS starts of a step
        return torch.Generator(device=dev).manual_seed(7)

    # every kernel at every shape of one plain step
    calls = []
    _, step = trainer()
    with plain_versions(), record_calls(calls):
        step(batch, draws(), momentum)
    request = len(calls)
    # and the residual kNN at three segments, PointsFusionMulti's form
    name, fn, (combined, _, _, k), _ = next(c for c in calls if c[0] == "fusion_resi")
    B, N = combined.shape[:2]
    calls.append((name, fn, (combined, torch.tensor([[N // 3, 2 * N // 3, N]] * B),
                             torch.tensor([[12, 10, 10], [8, 16, 8]][:B]), k), {}))
    # and the chamfer's kNN over key prefixes (knn_pallas's valid_n), at
    # k=1 and at k=8 with one prefix shorter than k
    name, fn, (a, b, _), _ = next(c for c in calls if c[0] == "nearest")
    calls.append((name, fn, (a, b, 1, torch.tensor([N // 2, N - 5][:B], device=dev)), {}))
    calls.append(("knn", fn, (a, b, 8, torch.tensor([5, N][:B], device=dev)), {}))
    hold_kernels(calls, request, PER_STEP, totals, "train", unit="step")
    del calls

    # one step through the kernels against one through the plain versions,
    # from the same flows, permutations and FPS starts
    with torch.no_grad():
        flows = base.window_flows(batch["forward"], batch["keys"], batch["backward"],
                                  batch["ini"])
    losses, grads = [], []
    for plain in (False, True):
        model, step = trainer()
        model.window_flows = lambda *a, f=flows: f
        with plain_versions() if plain else contextlib.nullcontext():
            losses.append(step(batch, draws(), momentum).item())
        grads.append({n: p.grad for n, p in model.named_parameters() if p.requires_grad})
        del model, step
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    print(f"train step loss: kernels {losses[0]!r}, plain {losses[1]!r} (rel {rel:.3g})")
    check(rel <= 1e-4, "train: the step's loss disagrees with the plain step's")
    compare_grads(*grads)
    del grads

    # five steps on the card: launch counts, losses, the frozen flow
    model, step = trainer()
    gen = torch.Generator(device=dev).manual_seed(11)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    flow_before = {k: v.clone() for k, v in model.flow.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    marks, out = [], []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out.append(step(batch, gen, momentum))
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in marks]
    losses = [float(x) for x in out]
    print(f"train: 5 steps, losses {losses}, launches {counts}")
    check(all(np.isfinite(losses)), "train: a loss is not finite")
    check(counts == {k: v * 5 for k, v in PER_STEP.items()},
          f"train launch counts {counts} != {PER_STEP} x 5")
    for k, v in model.flow.state_dict().items():
        check(torch.equal(v, flow_before[k]), f"train: the frozen flow's {k} changed")
    for n, p in model.named_parameters():
        if n.startswith("flow."):
            check(not p.requires_grad and torch.equal(p, before[n]), f"train: {n} trained")
        else:
            check(not torch.equal(p, before[n]), f"train: {n} did not move")
    print(f"train step on {card}: {statistics.median(step_ms[1:]):.3f} ms/step (CUDA events, "
          f"median of steps 2-5; step 1 {step_ms[0]:.3f} ms), peak memory "
          f"{peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)")
    device_share(lambda: step(batch, gen, momentum), requests=3, unit="step")
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
    sources = len({source for source, _ in KERNEL_INFO.values()})
    print(f"build: {build_seconds():.1f} s (nvcc, sm_90a, {sources} sources)")

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

    # 6. ISAPCInet field=2 training
    counts_train = phase_train(card, totals)

    kernels = []
    for kname, (source, replaces) in KERNEL_INFO.items():
        t = totals[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": counts[kname] + counts_isapci[kname] + counts_train[kname],
            "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(t["bytes_ms"], t["ops_ms"]),
            "bound_by": "bytes" if t["bytes_ms"] > t["ops_ms"] else "operations",
            "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
