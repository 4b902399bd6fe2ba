"""LiDAR scan readers and host-side samplers (a copy of
``pci_tpu/data/lidar.py``: the same sampling streams for a seed, and the
same ``PCI_TPU_NATIVE_IO`` variable; the JAX package's FPS index cache,
which serves its training CLIs, is not copied).

Data formats (verified against the reference's shipped demo data,
SURVEY.md section 2.5): KITTI ``.bin`` = float32 x4 (x, y, z, intensity);
nuScenes ``.bin`` = float32 x5.  Layout here is channels-last ``[N, C]``.
"""

from __future__ import annotations

import os

import numpy as np

from . import native

# Opt-in native IO: the fused mmap-load + Fisher-Yates subsample skips the
# full-scan numpy materialization + fancy-index round trip of the python
# path.  Default OFF so seeded sampling streams (goldens, accuracy gates)
# stay bit-stable; enable with PCI_TPU_NATIVE_IO=1.
def _native_io() -> bool:
    return os.environ.get("PCI_TPU_NATIVE_IO", "0") == "1"


def read_kitti_bin(path: str) -> np.ndarray:
    """KITTI velodyne scan -> ``[N, 4]`` float32 (xyz + intensity)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_nuscenes_bin(path: str) -> np.ndarray:
    """nuScenes LIDAR_TOP scan -> ``[N, 5]`` float32."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 5)


def read_result_bin(path: str, channels: int = 3) -> np.ndarray:
    """Saved interpolation result (float32 x3, or x4 with intensity)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, channels)


def read_subsample(
    path: str,
    width: int,
    npoints: int,
    rng: np.random.Generator,
    channels: int | None = None,
) -> np.ndarray:
    """Load a float32 scan and random-subsample to ``npoints`` rows (the
    dataset ``__getitem__`` hot pattern, reference
    Dataset/InterpolationData.py:60-77) — one native call when
    ``PCI_TPU_NATIVE_IO=1`` (C++ mmap + partial Fisher-Yates + OpenMP
    copy, native/pci_native.cpp), numpy otherwise.  ``channels`` keeps
    the leading columns after load.  Deterministic given ``rng`` state on
    both paths (the native path consumes one draw as its seed)."""
    if _native_io():
        out = native.load_scan(path, width, npoints, int(rng.integers(2**63)))
        if out is not None:
            return out if channels is None else out[:, :channels]
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, width)
    if channels is not None:
        pts = pts[:, :channels]
    return random_subsample(pts, npoints, rng)


def random_subsample(
    points: np.ndarray, npoints: int, rng: np.random.Generator
) -> np.ndarray:
    """Sample without replacement; pad with replacement if short
    (the reference's protocol, e.g. interpolation_data.py:66-77)."""
    n = points.shape[0]
    if n >= npoints:
        idx = rng.choice(n, npoints, replace=False)
    else:
        idx = np.concatenate(
            [np.arange(n), rng.choice(n, npoints - n, replace=True)]
        )
    return points[idx]


def fps_subsample(points: np.ndarray, npoints: int, start: int = 0) -> np.ndarray:
    """Farthest-point downsample via the native kernel (the reference used
    Open3D's C++ FPS, Dataset/InterpolationData.py:144-147)."""
    return points[native.fps_indices(points, npoints, start)]


def subsample(
    points: np.ndarray,
    npoints: int,
    method: str = "random",
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    if method == "random":
        assert rng is not None
        return random_subsample(points, npoints, rng)
    if method == "fps":
        if points.shape[0] < npoints:
            assert rng is not None
            return random_subsample(points, npoints, rng)
        return fps_subsample(points, npoints)
    raise ValueError(f"unknown subsample method {method!r}")
