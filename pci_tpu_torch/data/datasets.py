"""Interpolation window samplers (numpy; a copy of the
``pci_tpu/data/datasets.py`` samplers the eval CLIs read, so a seed gives
the same samples through either package).

  * NuscenesInterpolationDataset - ISAPCI key-pair protocol
    (Dataset/InterpolationData.py:13-176)
  * KittiInterpolationDataset / NuscenesTripletDataset - PointINet
    triplets (PointINet20230424/data/interpolation_data.py)

Every sampler yields channels-last numpy float32 with a fixed ``npoints``.
Samplers are plain indexable objects; batching lives in ``pipeline.py``.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .lidar import read_nuscenes_bin, read_subsample, subsample


def read_scene_list(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def load_scene_split(scenes: list[str], scene_split_lib: str):
    """Read per-scene '<frame_name> <timestamp>' listings."""
    timestamp_list, fns_list = [], []
    for scene in scenes:
        times, fns = [], []
        with open(os.path.join(scene_split_lib, scene + ".txt")) as f:
            for line in f:
                parts = line.strip("\n").split(" ")
                if len(parts) < 2:
                    continue
                fns.append(parts[0])
                times.append(float(parts[1]))
        timestamp_list.append(times)
        fns_list.append(fns)
    return timestamp_list, fns_list


class NuscenesInterpolationDataset:
    """ISAPCI protocol: interval-strided key pairs with `field` context
    frames each side; t normalized between the key timestamps."""

    def __init__(
        self,
        root: str,
        scenes_list: str,
        scene_split_lib: str,
        field: int = 1,
        npoints: int = 16000,
        interval: int = 5,
        if_random: bool = False,
        random_times: int = 1,
        sample_method: str = "fps",
        seed: int = 0,
    ):
        self.root = root
        self.field = field
        self.npoints = npoints
        self.interval = interval
        self.sample_method = sample_method
        self.rng = np.random.default_rng(seed)
        scenes = read_scene_list(scenes_list)
        self.timestamps, self.fns = load_scene_split(scenes, scene_split_lib)
        self.windows = self._make_windows(if_random, random_times)

    def _make_windows(self, if_random, random_times):
        windows = []
        f, itv = self.field, self.interval
        for times, fns in zip(self.timestamps, self.fns):
            max_ind = len(times)
            front = f * itv
            back = front + itv
            while back + f * itv < max_ind:
                biases = (
                    self.rng.integers(1, itv, random_times)
                    if if_random
                    else range(1, itv)
                )
                for bias in biases:
                    forw = [fns[front - itv * j] for j in range(1, f + 1)]
                    backw = [fns[back + itv * j] for j in range(1, f + 1)]
                    keys = [fns[front], fns[back]]
                    t = (times[front + bias] - times[front]) / (
                        times[back] - times[front]
                    )
                    windows.append((forw, keys, backw, float(t), fns[front + bias]))
                front = back
                back = back + itv
        return windows

    def _get_lidar(self, fn):
        pts = read_nuscenes_bin(os.path.join(self.root, fn))[:, :3]
        return subsample(pts, self.npoints, self.sample_method, self.rng).astype(
            np.float32
        )

    def __len__(self):
        return len(self.windows)

    def __getitem__(self, index):
        forw, keys, backw, t, gt_fn = self.windows[index]
        return {
            "forward": [self._get_lidar(fn) for fn in forw],
            "keys": [self._get_lidar(fn) for fn in keys],
            "backward": [self._get_lidar(fn) for fn in backw],
            "t": np.float32(t),
            "gt": self._get_lidar(gt_fn),
            "ini": np.zeros((self.npoints, 3), np.float32),
        }


class KittiInterpolationDataset:
    """PointINet triplet protocol over a KITTI odometry sequence dir
    (velodyne/*.bin + times.txt)."""

    def __init__(
        self,
        root: str,
        npoints: int = 16384,
        interval: int = 5,
        train: bool = True,
        use_intensity: bool = True,
        seed: int = 0,
    ):
        self.npoints = npoints
        self.use_intensity = use_intensity
        self.rng = np.random.default_rng(seed)
        with open(os.path.join(root, "times.txt")) as f:
            self.times = [float(line.strip()) for line in f if line.strip()]
        self.paths = sorted(glob.glob(os.path.join(root, "velodyne", "*.bin")))
        self.triples = []
        ini = 0
        max_ind = len(self.paths)
        while ini < max_ind - interval:
            end = ini + interval
            if train:
                mid = int(self.rng.integers(1, interval)) + ini
                self.triples.append((ini, mid, end))
            else:
                for bias in range(1, interval):
                    self.triples.append((ini, ini + bias, end))
            ini = end

    def _cloud(self, idx):
        pc = read_subsample(self.paths[idx], 4, self.npoints, self.rng)
        return pc if self.use_intensity else pc[:, :3]

    def __len__(self):
        return len(self.triples)

    def __getitem__(self, index):
        i, m, e = self.triples[index]
        t = (self.times[m] - self.times[i]) / (self.times[e] - self.times[i])
        return {
            "ini_pc": self._cloud(i).astype(np.float32),
            "mid_pc": self._cloud(m).astype(np.float32),
            "end_pc": self._cloud(e).astype(np.float32),
            "color": np.zeros((self.npoints, 3), np.float32),
            "t": np.float32(t),
        }


class NuscenesTripletDataset:
    """PointINet triplet protocol from a nuScenes scene split."""

    def __init__(
        self,
        root: str,
        scenes_list: str,
        scene_split_lib: str,
        npoints: int = 16384,
        interval: int = 5,
        train: bool = True,
        use_intensity: bool = True,
        seed: int = 0,
    ):
        self.root = root
        self.npoints = npoints
        self.use_intensity = use_intensity
        self.rng = np.random.default_rng(seed)
        scenes = read_scene_list(scenes_list)
        self.timestamps, self.fns = load_scene_split(scenes, scene_split_lib)
        self.triples = []
        for times, fns in zip(self.timestamps, self.fns):
            ini = 0
            while ini < len(fns) - interval:
                end = ini + interval
                if train:
                    mid = int(self.rng.integers(1, interval)) + ini
                    self.triples.append(
                        ((fns[ini], fns[mid], fns[end]), (times[ini], times[mid], times[end]))
                    )
                else:
                    for bias in range(1, interval):
                        mid = ini + bias
                        self.triples.append(
                            ((fns[ini], fns[mid], fns[end]), (times[ini], times[mid], times[end]))
                        )
                ini = end

    def _cloud(self, fn):
        pc = read_subsample(
            os.path.join(self.root, fn), 5, self.npoints, self.rng,
            channels=4,
        )
        return pc if self.use_intensity else pc[:, :3]

    def __len__(self):
        return len(self.triples)

    def __getitem__(self, index):
        (f_i, f_m, f_e), (t_i, t_m, t_e) = self.triples[index]
        t = (t_m - t_i) / (t_e - t_i)
        return {
            "ini_pc": self._cloud(f_i).astype(np.float32),
            "mid_pc": self._cloud(f_m).astype(np.float32),
            "end_pc": self._cloud(f_e).astype(np.float32),
            "color": np.zeros((self.npoints, 3), np.float32),
            "t": np.float32(t),
        }
