"""Layers of the port (counterpart of ``pci_tpu.nn``)."""

from .fusion import PointsFusion, PointsFusionMulti, PointsFusionWithFeatures
from .heads import Outputer, Tnet, Wnet
from .layers import (
    Classifier,
    FeaturePropagation,
    FlowEmbedding,
    SetConv,
    SetUpConv,
    fold_pointmlp_vars,
    fps_start,
    gather_split,
)
from .mlp import PointMLP
from .norm import BatchNorm, GroupNorm
from .pointnet2 import (
    FeaturePropagationP2,
    Pointnet2FeatureAbstract,
    SetAbstractionMsg,
)
from .transformer import TransformerLayer

__all__ = [
    "BatchNorm",
    "Classifier",
    "FeaturePropagation",
    "FeaturePropagationP2",
    "FlowEmbedding",
    "GroupNorm",
    "Outputer",
    "PointMLP",
    "Pointnet2FeatureAbstract",
    "PointsFusion",
    "PointsFusionMulti",
    "PointsFusionWithFeatures",
    "SetAbstractionMsg",
    "SetConv",
    "SetUpConv",
    "Tnet",
    "TransformerLayer",
    "Wnet",
    "fold_pointmlp_vars",
    "fps_start",
    "gather_split",
]
