"""Point-cloud ops of the port (counterpart of ``pci_tpu.ops``)."""

from .ball import ball_query, ball_query_multi
from .distance import square_distance
from .fps import fps, fps_points
from .gather import index_points
from .interpolate import three_nn_interpolate
from .knn import knn, knn_prefix

__all__ = [
    "ball_query",
    "ball_query_multi",
    "fps",
    "fps_points",
    "index_points",
    "knn",
    "knn_prefix",
    "square_distance",
    "three_nn_interpolate",
]
