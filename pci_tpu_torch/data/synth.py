"""Synthetic LiDAR-like scene generator (nuScenes split layout); a copy of
``pci_tpu/data/synth.py``'s ``generate_scenes``, so a seed writes the same
scenes through either package.

No nuScenes or KITTI archive ships with the repository, so its scenes
are generated, with learnable, non-trivial frame-to-frame motion:

* a "world" of randomly placed box/sphere/plane point clusters (LiDAR-ish
  structure rather than a gaussian blob),
* smooth ego-motion: constant-velocity translation + yaw rate with small
  random accelerations, applied to the whole scene per frame,
* a few independently moving clusters (cars) with their own velocities.

The identity baseline (predict key1 for any t) therefore carries real
chamfer error that interpolation can beat, and motion is polynomial-ish
in time so both flow-warp models and PolyPCI have signal to learn.

Layout written (the protocol NuscenesInterpolationDataset /
NuscenesTripletDataset consume, mirroring the reference's scene-split
library, Dataset/Nuscenes.py):

  root/lidar/<scene>_frame_<i>.bin   float32 [N, 5] (xyz, intensity, ring)
  root/split/<scene>.txt             "<filename> <timestamp>" per line
  root/scenes.txt                    scene names, one per line
"""

from __future__ import annotations

import os

import numpy as np


def _cluster(rng, kind: str, n: int) -> np.ndarray:
    if kind == "plane":  # ground patch
        xy = rng.uniform(-1, 1, (n, 2))
        z = rng.normal(0, 0.02, (n, 1))
        return np.concatenate([xy, z], axis=1)
    if kind == "box":  # building/car shell: points on faces
        face = rng.integers(0, 3, n)
        u = rng.uniform(-1, 1, (n, 3))
        u[np.arange(n), face] = np.sign(u[np.arange(n), face])
        return u
    # sphere shell (vegetation blobs)
    v = rng.normal(size=(n, 3))
    return v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)


def _make_world(rng, npts: int):
    """Static world + a few movers; returns (static [S,3], movers list of
    ([M,3], velocity [3]))."""
    parts = []
    n_clusters = int(rng.integers(14, 22))
    for _ in range(n_clusters):
        kind = ["plane", "box", "sphere"][int(rng.integers(0, 3))]
        n = int(rng.integers(200, 900))
        scale = rng.uniform(0.5, 4.0, 3)
        center = np.asarray(
            [rng.uniform(-25, 25), rng.uniform(-25, 25), rng.uniform(0, 4)]
        )
        parts.append(_cluster(rng, kind, n) * scale + center)
    ground = _cluster(rng, "plane", npts // 3) * np.asarray([30.0, 30.0, 1.0])
    parts.append(ground)
    static = np.concatenate(parts, axis=0)

    movers = []
    for _ in range(int(rng.integers(2, 5))):
        n = int(rng.integers(150, 500))
        body = _cluster(rng, "box", n) * rng.uniform(0.6, 1.5, 3)
        center = np.asarray(
            [rng.uniform(-18, 18), rng.uniform(-18, 18), rng.uniform(0.5, 1.5)]
        )
        vel = np.asarray([rng.uniform(-1.2, 1.2), rng.uniform(-1.2, 1.2), 0.0])
        movers.append((body + center, vel))
    return static.astype(np.float32), movers


def _rigid(points, yaw, trans):
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    return points @ R.T + trans.astype(np.float32)


def generate_scenes(
    root: str,
    n_scenes: int = 8,
    n_frames: int = 40,
    npts: int = 24000,
    dt: float = 0.05,
    seed: int = 0,
    prefix: str = "synth",
) -> list[str]:
    """Write ``n_scenes`` synthetic scenes; returns the scene names.

    ``npts`` is the nominal raw cloud size (the dataset layer re-samples
    to its own ``npoints`` anyway); frames are ``dt`` seconds apart.
    """
    rng = np.random.default_rng(seed)
    lidar = os.path.join(root, "lidar")
    split = os.path.join(root, "split")
    os.makedirs(lidar, exist_ok=True)
    os.makedirs(split, exist_ok=True)

    names = []
    for s in range(n_scenes):
        scene = f"{prefix}-{s:04d}"
        names.append(scene)
        static, movers = _make_world(rng, npts)
        # ego motion: velocity + yaw rate with mild random acceleration
        vel = np.asarray([rng.uniform(-3, 3), rng.uniform(-3, 3), 0.0])
        yaw_rate = rng.uniform(-0.15, 0.15)
        acc = np.asarray([rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5), 0.0])

        lines = []
        for i in range(n_frames):
            t = i * dt
            ego_T = vel * t + 0.5 * acc * t * t
            ego_yaw = yaw_rate * t
            world = [_rigid(static, ego_yaw, ego_T)]
            for body, v in movers:
                world.append(_rigid(body + v * t, ego_yaw, ego_T))
            xyz = np.concatenate(world, axis=0)
            # per-frame resample to npts + sensor noise: consecutive frames
            # never share exact points, like real scans
            sel = rng.choice(len(xyz), npts, replace=len(xyz) < npts)
            xyz = xyz[sel] + rng.normal(0, 0.01, (npts, 3)).astype(np.float32)
            extra = np.concatenate(
                [
                    rng.uniform(0, 1, (npts, 1)).astype(np.float32),  # intensity
                    np.zeros((npts, 1), np.float32),  # ring
                ],
                axis=1,
            )
            fn = f"{scene}_frame_{i:03d}.bin"
            np.concatenate([xyz.astype(np.float32), extra], axis=1).tofile(
                os.path.join(lidar, fn)
            )
            lines.append(f"{fn} {t:.6f}")
        with open(os.path.join(split, f"{scene}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")

    with open(os.path.join(root, "scenes.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return names
