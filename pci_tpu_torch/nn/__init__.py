"""Layers of the port (counterpart of ``pci_tpu.nn``)."""

from .fusion import PointsFusion
from .layers import (
    Classifier,
    FeaturePropagation,
    FlowEmbedding,
    SetConv,
    SetUpConv,
    fold_pointmlp_vars,
)
from .mlp import PointMLP
from .norm import BatchNorm

__all__ = [
    "BatchNorm",
    "Classifier",
    "FeaturePropagation",
    "FlowEmbedding",
    "PointMLP",
    "PointsFusion",
    "SetConv",
    "SetUpConv",
    "fold_pointmlp_vars",
]
