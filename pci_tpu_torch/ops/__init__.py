"""Point-cloud ops of the port (counterpart of ``pci_tpu.ops``)."""

from .ball import ball_query, ball_query_multi
from .chamfer import (
    chamfer_distance,
    chamfer_loss_cf,
    chamfer_per_sample,
    min_sqdist,
    nearest_neighbor_idx,
)
from .distance import square_distance
from .emd import emd, emd_assignment_dist, emd_assignment_sparse, sinkhorn_emd
from .fps import fps, fps_points
from .gather import index_points, knn_gather, scatter_add_rows
from .interpolate import three_nn_interpolate
from .knn import cells_eligible, knn, knn_self_resi

__all__ = [
    "ball_query",
    "ball_query_multi",
    "cells_eligible",
    "chamfer_distance",
    "chamfer_loss_cf",
    "chamfer_per_sample",
    "emd",
    "emd_assignment_dist",
    "emd_assignment_sparse",
    "fps",
    "fps_points",
    "index_points",
    "knn",
    "knn_gather",
    "knn_self_resi",
    "min_sqdist",
    "nearest_neighbor_idx",
    "scatter_add_rows",
    "sinkhorn_emd",
    "square_distance",
    "three_nn_interpolate",
]
