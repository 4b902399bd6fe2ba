"""Build, load and bind the hand-written CUDA kernels of ``pci_tpu_torch``.

Every source in ``pci_tpu_torch/csrc`` compiles at first use, one
``nvcc`` process a source, all started together, and one more ``nvcc``
links the objects into a shared library with a plain C interface
(``build/libpci_kernels_<hash>.so`` at the repository root, keyed by a
hash of the sources and flags), loaded with :mod:`ctypes`.  Nothing is
built or loaded when a module is imported: the CPU tests import every
module and run the plain versions.

Routing rule for every wrapper: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes the plain PyTorch version.  Inside
:func:`plain_versions` every wrapper takes its plain version on any
device: that is the reference run a kernel is held against on the card.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC") + ARCH_FLAGS

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_FP = ctypes.POINTER(ctypes.c_float)
# C entry points: name -> argtypes (every function returns cudaGetLastError)
_SIGNATURES = {
    "pci_fps": [_P, _P, _P, _I, _I, _I, _I, _P],
    "pci_fps_long": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "pci_setconv": [_P, _P, _P, _P, _IP, _I, _P, _I, _I, _I, _I, _F, _I, _P, _P],
    "pci_setconv_plan": [_IP, _I, _I, _I, _I, _I, _I, _IP],
    "pci_setconv_attrs": [_IP],
    "pci_setconv_ball_attrs": [_IP],
    "pci_knnconv": [_P, _P, _P, _P, _P, _P, _P, _IP, _I, _IP, _I, _P] + [_I] * 10 + [_P],
    "pci_knnconv_attrs": [_IP],
    "pci_fusion": [_P, _P, _P, _I, _I, _I, _P, _I, _P, _I, _I, _P],
    "pci_fusion64": [_P, _P, _P, _I, _I, _I, _P, _I, _P, _I, _I, _P],
    "pci_fusion_attrs": [_IP],
    "pci_fusion_payload_attrs": [_IP],
    "pci_fusion64_attrs": [_IP],
    "pci_fusion64_payload_attrs": [_IP],
    "pci_fusion128": [_P, _P, _P, _I, _I, _I, _P, _I, _P, _I, _I, _P],
    "pci_fusion128_attrs": [_IP],
    "pci_fusion128_payload_attrs": [_IP],
    "pci_flowenc_attrs": [_IP],
    "pci_flowmid_attrs": [_IP],
    "pci_ball": [_P, _P, _P, _IP, _I, _I, _I, _I, _P, _P, _P],
    "pci_ball_stamp_rows": [_I, _I],
    "pci_knn": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "pci_nearest": [_P] * 5 + [_I] * 3 + [_P] * 3,
    "pci_nearest_shape": [_I, _I, _I, _IP],
    "pci_nearest_attrs": [_IP],
    "pci_knn_cells": [_P] * 9 + [_I] * 7 + [_P],
    "pci_knn_cells_seg": [_P] * 12 + [_I] * 10 + [_P],
    "pci_knn_cells_attrs": [_IP],
    "pci_knn_cells_seg_attrs": [_IP],
    "pci_attention": [_P] * 7 + [_I, _I, _I, _P],
    "pci_attention_attrs": [_IP],
    "pci_attention_wide_attrs": [_IP],
    "pci_attention_bwd_attrs": [_IP],
    "pci_attention_bwd_wide_attrs": [_IP],
    "pci_fusion_resi": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P],
    "pci_fusion_resi_attrs": [_IP],
    "pci_fusion_resi64_attrs": [_IP],
    "pci_fusion_resi128_attrs": [_IP],
    "pci_attention_bwd": [_P] * 11 + [_I, _I, _I, _I, _P],
    "pci_flowenc": [_P, _P, _P, _P, _IP, _I, _P, _IP, _I, _P, _P, _P, _P, _P, _I, _I,
                    _I, _I, _I, _F, _I, _F, _I, _P],
    "pci_flowmid": [_P] * 6 + [ctypes.POINTER(_P), _IP, _IP, _IP] + [_P] * 9
                   + [_I] * 8 + [_F, _I, _F, _I, _I, _P],
    "pci_fusion_tail": [_P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _P],
    "pci_fusion_tail_attrs": [_IP],
    "pci_fusion_tail64_attrs": [_IP],
    "pci_fusion_tail_stream_attrs": [_IP],
    "pci_fusion_cells": [_P] * 8 + [_I] * 3 + [_P, _I] + [_P] * 6 + [_I] * 6 + [_P],
    "pci_fusion_cells_attrs": [_IP],
    "pci_fusion_cells_payload_attrs": [_IP],
    "pci_fusion_cells64_attrs": [_IP],
    "pci_fusion_cells64_payload_attrs": [_IP],
    "pci_fusion_cells_resi_attrs": [_IP],
    "pci_fusion_cells_resi64_attrs": [_IP],
    "pci_pn2mid_scratch": [_IP, _IP, _IP, _I, _I, _I, _IP, _IP, _FP,
                           ctypes.POINTER(ctypes.c_longlong)],
    "pci_pn2mid": [_P, _P, _P, _IP, _IP, _IP, _P, _P, _P, _P, _I, _I, _I, _IP, _IP, _FP,
                   _P, _P, _P],
    "pci_pn2mid_attrs": [_IP],
    "pci_auction_pass": [_P] * 8 + [_I, _I, _F, _F, _P],
    "pci_auction_chase": [_P] * 6 + [_I, _I, _F, _I, _P],
    "pci_auction_chase_cluster": [_P] * 7 + [_I, _I, _F, _I, _P],
    "pci_auction_cluster_shape": [_I, _I, _IP],
    "pci_auction_pass_attrs": [_IP],
    "pci_auction_chase_attrs": [_IP],
}

_PLAIN = contextvars.ContextVar("pci_tpu_torch_plain", default=False)


@contextlib.contextmanager
def plain_versions():
    """Route every kernel wrapper to its plain PyTorch version, on any
    device, for the duration of the ``with`` block."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def use_kernel(t: torch.Tensor) -> bool:
    """True when ``t``'s device routes to the CUDA kernel."""
    if _PLAIN.get() or t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain route for device {t.device}")


def needs_grad(*items) -> bool:
    """Whether a gradient could flow through an eval call: grad mode on,
    and a tensor among ``items`` (or inside a list or tuple of them), or a
    parameter of an ``nn.Module`` among them, requires grad.  The
    counterpart of the JAX package's ``ops.has_tangents``: where it holds,
    an eval layer computes its eval function by differentiable ops
    (unfolded, BatchNorm on its running statistics) instead of an eval-only
    kernel, whose wrapper would refuse the call (:func:`check_eval_only`).
    Served paths run under ``torch.inference_mode()``, where it is false."""
    if not torch.is_grad_enabled():
        return False
    stack = list(items)
    while stack:
        it = stack.pop()
        if isinstance(it, torch.Tensor):
            if it.requires_grad:
                return True
        elif isinstance(it, torch.nn.Module):
            if any(p.requires_grad for p in it.parameters()):
                return True
        elif isinstance(it, (list, tuple)):
            stack.extend(it)
    return False


def check_eval_only(name: str, *tensors) -> None:
    """An eval kernel of differentiable values defines no backward: refuse
    a call that could need one."""
    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{name} is an eval-only kernel with no backward; call it under "
            "torch.no_grad() or torch.inference_mode()"
        )


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libpci_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cu, _ = _sources()
        objs = [tmp.with_name(f"{tmp.stem}.{src.stem}.o") for src in cu]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(cu, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for c in cmds]
        results = []
        for c, p in zip(cmds, procs):
            so, se = p.communicate()  # waits: no nvcc outlives the build
            results.append((c, p.returncode, so, se))
        link = [_nvcc(), "-shared", *ARCH_FLAGS, "-o", str(tmp), *map(str, objs)]
        if all(r[1] == 0 for r in results):
            res = subprocess.run(link, capture_output=True, text=True)
            results.append((link, res.returncode, res.stdout, res.stderr))
        for obj in objs:
            obj.unlink(missing_ok=True)
        failed = [r for r in results if r[1] != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"({rc}) {' '.join(c)}\n{so}\n{se}" for c, rc, so, se in failed))
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_seconds() -> float:
    """Build and load the library; returns the seconds it took (0 when
    already loaded in this process)."""
    t0 = time.perf_counter()
    library()
    return time.perf_counter() - t0


ATTR_KEYS = ("registers", "static_smem", "dynamic_smem", "blocks_per_sm", "threads",
             "local_bytes")


def kernel_attrs(entry: str) -> dict:
    """A kernel's resources from its C entry ``entry`` (``pci_fusion_attrs``,
    ``pci_flowmid_attrs``, ...): registers a thread, static and dynamic
    shared bytes, resident blocks an SM, threads a block, local bytes a
    thread."""
    out = (ctypes.c_int * len(ATTR_KEYS))()
    check_launch(entry, getattr(library(), entry)(out))
    return dict(zip(ATTR_KEYS, out))


def int_array(values) -> ctypes.Array:
    values = [int(v) for v in values]
    return (ctypes.c_int * max(len(values), 1))(*values)


def float_array(values) -> ctypes.Array:
    values = [float(v) for v in values]
    return (ctypes.c_float * max(len(values), 1))(*values)


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {err}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            device: torch.device) -> None:
    """Wrapper-side input check: device, dtype, rank and contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected rank {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class PackedLayers(list):
    """Folded layers ``[(W, b), ...]`` that also carry their kernel-layout
    buffer, so a module packs its weights once and not on every launch;
    the tensor-core kernels' split buffers are made at first use and kept
    (:meth:`tf32`)."""

    def __init__(self, layers):
        super().__init__(layers)
        device = self[0][0].device if self else torch.device("cpu")
        self.buf, self.dims = _pack(self, device)
        self._tf32 = {}

    def tf32(self, chain: bool = False) -> torch.Tensor:
        """The layers split in TF32 hi/lo fragments for csrc/mma_tf32.cuh
        (:func:`pack_tf32`), built once per layout and kept."""
        if chain not in self._tf32:
            self._tf32[chain] = _tf32_pack(self, self.buf.device, chain)
        return self._tf32[chain]


def layer_widths(layers) -> list:
    """``[cin_0, cout_0, cout_1, ...]`` of folded ``[(W [cout, cin], b),
    ...]`` (``[]`` for none)."""
    if isinstance(layers, PackedLayers):
        return layers.dims
    return [layers[0][0].shape[1], *(w.shape[0] for w, _ in layers)] if layers else []


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the host: fp32 rounded to TF32's 10 mantissa
    bits, to nearest with ties away from zero, the 13 low bits zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """``(hi, lo)`` with ``hi = tf32(x)``, ``lo = tf32(x - hi)``: the
    3xTF32 split of csrc/mma_tf32.cuh."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def pack_tf32(layers, device: torch.device, chain: bool = False) -> torch.Tensor:
    """Folded ``[(W [cout, cin], b [cout]), ...]`` -> one fp32 buffer in
    csrc/mma_tf32.cuh's layout (kept on a :class:`PackedLayers`)."""
    if isinstance(layers, PackedLayers) and layers.buf.device == device:
        return layers.tf32(chain)
    return _tf32_pack(layers, device, chain)


def _tf32_pack(layers, device: torch.device, chain: bool) -> torch.Tensor:
    """For each layer: ``W.T`` padded with zeros to ``[K8, N8]`` and split,
    laid out as the mma's B fragments (k-step major, then n-tile, then the
    32 lanes' float4 ``(hi[k0][n], hi[k1][n], lo[k0][n], lo[k1][n])`` with
    ``n = 8 nt + lane // 4``, ``k0 = 8 kt + lane % 4``, ``k1 = k0 + 4``; a
    layer after the first of a ``chain`` takes ``k0 = 8 kt + 2 (lane %
    4)``, ``k1 = k0 + 1``, the previous layer's accumulator columns); then
    the bias padded to ``N8``."""
    if not layers:  # no tensors (and no device work) for an empty chain
        return torch.empty(0, device=device, dtype=torch.float32)
    parts = []
    lane = torch.arange(32, device=device)
    g, t = lane // 4, lane % 4
    for i, (w, b) in enumerate(layers):
        cout, cin = w.shape
        if i and cin != layers[i - 1][0].shape[0]:
            raise ValueError(f"layer widths do not chain at layer {i}: {tuple(w.shape)}")
        k8, n8 = -(-cin // 8) * 8, -(-cout // 8) * 8
        wt = torch.zeros(k8, n8, dtype=torch.float32, device=device)
        wt[:cin, :cout] = w.detach().float().t()
        hi, lo = tf32_split(wt)
        k0, k1 = (2 * t, 2 * t + 1) if chain and i else (t, t + 4)
        kt = torch.arange(k8 // 8, device=device)[:, None, None] * 8
        col = torch.arange(n8 // 8, device=device)[None, :, None] * 8 + g
        r0, r1 = kt + k0, kt + k1
        frag = torch.stack([hi[r0, col], hi[r1, col], lo[r0, col], lo[r1, col]], -1)
        bias = torch.zeros(n8, dtype=torch.float32, device=device)
        bias[:cout] = b.detach().float()
        parts += [frag.reshape(-1), bias]
    return torch.cat(parts).contiguous()


def _pack(layers, device: torch.device):
    parts, dims = [], []
    for w, b in layers:
        if not dims:
            dims.append(w.shape[1])
        elif w.shape[1] != dims[-1]:
            raise ValueError(f"layer widths do not chain: {dims} then {tuple(w.shape)}")
        dims.append(w.shape[0])
        parts += [w.t().reshape(-1), b.reshape(-1)]
    if not parts:
        return torch.empty(0, device=device, dtype=torch.float32), []
    buf = torch.cat(parts).to(device=device, dtype=torch.float32).contiguous()
    return buf, dims


def graph_replay(cache, limit: int, key, what: str, fn, *inputs):
    """``fn(*inputs)`` of CUDA tensors, replayed from a CUDA graph captured
    once per ``key`` into ``cache`` (an ``OrderedDict``; the ``limit`` most
    recently used keys keep their graph and its memory): the inputs are
    copied into the graph's own (a tensor passed twice is one there) and
    the graph replays, so the host launches once.  The outputs are the
    graph's tensors, overwritten by the next call of the same key: every
    call of a key must come on the stream its graph was captured for
    (another stream raises, as does a call during a capture).  The first
    call of a key captures, which synchronizes the device."""
    dev = inputs[0].device
    stream = torch.cuda.current_stream(dev)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what}: cannot be replayed inside a CUDA graph capture")
    entry = cache.get(key)
    if entry is not None and entry[0].cuda_stream != stream.cuda_stream:
        raise RuntimeError(f"{what}: the graph for {key[1:]} was captured for stream "
                           f"{entry[0]}, called on {stream}")
    if entry is None:
        with torch.inference_mode(False), torch.no_grad():
            clones = {}
            slots = [clones.setdefault(id(t), t.clone()) for t in inputs]
            side = torch.cuda.Stream(dev)
            side.wait_stream(stream)
            with torch.cuda.stream(side):  # the caches and allocations, before capture
                fn(*slots)
            stream.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn(*slots)
        entry = cache[key] = (stream, graph, slots, out)
        if len(cache) > limit:
            cache.popitem(last=False)
    cache.move_to_end(key)
    _, graph, slots, out = entry
    for slot, t in zip(slots, inputs):
        slot.copy_(t)
    graph.replay()
    return out


def mlp_plain(h: torch.Tensor, layers, n_final: int = 0) -> torch.Tensor:
    """Plain folded MLP chain: ``relu(h @ W.T + b)`` per layer, the last
    ``n_final`` layers linear.  ``layers`` may also be a module computing
    the chain unfolded (an eval-mode ``PointMLP``, whose BatchNorms take
    their running statistics): the differentiable eval route of
    :func:`needs_grad` (``n_final`` 0)."""
    if isinstance(layers, torch.nn.Module):
        return layers(h)
    for i, (w, b) in enumerate(layers):
        h = torch.nn.functional.linear(h, w, b)
        if i < len(layers) - n_final:
            h = torch.relu(h)
    return h
