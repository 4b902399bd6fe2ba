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
    "pci_setconv": [_P, _P, _P, _P, _IP, _I, _P, _I, _I, _I, _I, _F, _I, _I,
                    _I, _P],
    "pci_knnconv": [_P, _P, _P, _P, _P, _P, _IP, _I, _IP, _I, _P, _I, _I, _I,
                    _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "pci_fusion": [_P, _P, _P, _I, _I, _I, _P, _I, _I, _P],
    "pci_ball": [_P, _P, _P, _FP, _IP, _I, _I, _I, _I, _P],
    "pci_knn": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "pci_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "pci_fusion_resi": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _P],
    "pci_attention_bwd": [_P] * 10 + [_I, _I, _I, _I, _P],
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
    buffer, so a module packs its weights once and not on every launch."""

    def __init__(self, layers):
        super().__init__(layers)
        device = self[0][0].device if self else torch.device("cpu")
        self.buf, self.dims = _pack(self, device)


def pack_layers(layers, device: torch.device):
    """Folded ``[(W [cout, cin], b [cout]), ...]`` -> (one contiguous float
    buffer of ``W.T`` then ``b`` per layer, widths ``[cin_0, cout_0, ...]``)
    in the csrc/common.cuh layout."""
    if isinstance(layers, PackedLayers) and layers.buf.device == device:
        return layers.buf, layers.dims
    return _pack(layers, device)


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


def mlp_plain(h: torch.Tensor, layers) -> torch.Tensor:
    """Plain folded MLP chain: ``relu(h @ W.T + b)`` per layer."""
    for w, b in layers:
        h = torch.relu(torch.nn.functional.linear(h, w, b))
    return h
