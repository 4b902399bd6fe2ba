"""ctypes bridge to the repository's native host-side kernels
(``native/pci_native.cpp``, the same library the JAX package loads).

Loads ``native/libpci_native.so``; when it is missing, builds it from the
source into ``build/`` at first use.  Falls back to numpy (same
semantics, slower) when there is no library and no compiler, or the
library does not load on this host.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_LIB = None
_LOCK = threading.Lock()
_ROOT = Path(__file__).resolve().parents[2]
_NATIVE_DIR = _ROOT / "native"
_BUILT = _ROOT / "build" / "libpci_native.so"


def _library_file() -> Path | None:
    so = _NATIVE_DIR / "libpci_native.so"
    if so.exists():
        return so
    if _BUILT.exists():
        return _BUILT
    src = _NATIVE_DIR / "pci_native.cpp"
    if not src.exists():
        return None
    _BUILT.parent.mkdir(parents=True, exist_ok=True)
    tmp = _BUILT.with_suffix(f".{os.getpid()}.tmp.so")
    try:
        subprocess.run(
            ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp),
             str(src)],
            check=True, capture_output=True,
        )
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    os.replace(tmp, _BUILT)
    return _BUILT


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = _library_file()
        try:
            lib = ctypes.CDLL(str(so)) if so is not None else None
        except OSError:
            lib = None
        if lib is None:
            _LIB = False
            return _LIB
        lib.pci_fps_indices.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.pci_load_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_float),
        ]
        lib.pci_load_scan.restype = ctypes.c_int64
        _LIB = lib
        return _LIB


def fps_indices(points: np.ndarray, npoint: int, start: int = 0) -> np.ndarray:
    """Greedy FPS over ``[N, >=3]`` float32 points -> ``[npoint]`` int32."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    n, stride = pts.shape
    lib = _load()
    if lib:
        out = np.empty(npoint, dtype=np.int32)
        lib.pci_fps_indices(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, stride, npoint, start,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out
    # numpy fallback (identical greedy semantics)
    dist = np.full(n, np.inf, dtype=np.float32)
    out = np.empty(npoint, dtype=np.int32)
    farthest = start % n
    xyz = pts[:, :3]
    for i in range(npoint):
        out[i] = farthest
        d = np.sum((xyz - xyz[farthest]) ** 2, axis=-1)
        np.minimum(dist, d, out=dist)
        farthest = int(np.argmax(dist))
    return out


def load_scan(path: str, width: int, npoints: int, seed: int) -> np.ndarray | None:
    """Read a float32 ``.bin`` scan and random-subsample it to ``npoints``
    rows without replacement (wrap-pad when short) in one native call.
    Deterministic per ``seed``.  Returns ``[npoints, width]`` float32, or
    ``None`` when the native library or the file is unavailable (callers
    fall back to ``np.fromfile`` + ``lidar.random_subsample``)."""
    lib = _load()
    if not lib:
        return None
    out = np.empty((npoints, width), dtype=np.float32)
    n = lib.pci_load_scan(
        os.fsencode(path), width, npoints, ctypes.c_uint64(seed & (2**64 - 1)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if n < 0:
        return None
    return out
