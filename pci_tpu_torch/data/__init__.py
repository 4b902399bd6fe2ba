"""Data pipeline of the port (counterpart of ``pci_tpu.data``): LiDAR
readers, the eval CLIs' window samplers, batching, the copy to the
device, and the synthetic scene generator."""

from .datasets import (
    KittiInterpolationDataset,
    NuscenesInterpolationDataset,
    NuscenesTripletDataset,
    load_scene_split,
    read_scene_list,
)
from .lidar import (
    fps_subsample,
    random_subsample,
    read_kitti_bin,
    read_nuscenes_bin,
    read_result_bin,
    subsample,
)
from .pipeline import Loader, collate, to_device
from .synth import generate_scenes

__all__ = [
    "KittiInterpolationDataset",
    "Loader",
    "NuscenesInterpolationDataset",
    "NuscenesTripletDataset",
    "collate",
    "fps_subsample",
    "generate_scenes",
    "load_scene_split",
    "random_subsample",
    "read_kitti_bin",
    "read_nuscenes_bin",
    "read_result_bin",
    "read_scene_list",
    "subsample",
    "to_device",
]
