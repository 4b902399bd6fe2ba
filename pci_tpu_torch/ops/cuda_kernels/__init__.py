"""Hand-written CUDA kernels for Hopper (``sm_90a``), one per TPU kernel of
the port's paths (PointINet and ISAPCInet eval on the JAX package's default
route and with its gates off, PointINet at 32,768 points and more on the
cell-pruned fusion, ISAPCInet training, the eval CLIs' EMD auction), each
beside its plain PyTorch version.

Every kernel wrapper (``*_kernel``) counts its launches in a
``launches`` attribute (the flat kNN kernel's k=1 form in
``nearest_launches``).  Nothing here builds or loads a kernel when it is
imported: :func:`_build.library` does, at the first launch.
"""

from ._build import build_seconds, plain_versions
from .attention_cuda import (
    attention_bwd,
    attention_bwd_kernel,
    attention_kernel,
    vector_attention,
    vector_attention_trainable,
)
from .auction_cuda import auction, auction_chase_kernel, auction_pass_kernel
from .ball_cuda import ball_kernel, ball_query_multi
from .flowenc_cuda import flowenc_fused, flowenc_kernel
from .flowmid_cuda import flowmid_fused, flowmid_kernel
from .fps_cuda import fps_kernel
from .fusion_cells_cuda import (
    fusion_cells_attention,
    fusion_cells_kernel,
    fusion_cells_multi_knn,
    fusion_cells_resi_knn,
)
from .fusion_knn_cuda import (
    fusion_kernel,
    fusion_resi_kernel,
    fusion_resi_knn,
    knn_fusion_attention,
)
from .fusion_tail_cuda import fusion_attention_tail, fusion_tail_kernel
from .knn_cuda import knn, knn_cells, knn_cells_kernel, knn_kernel, nearest_launches
from .knnconv_cuda import knnconv_fused, knnconv_kernel
from .pn2mid_cuda import pn2mid_fused, pn2mid_kernel
from .setconv_cuda import fold_bn_layers, setconv_fused, setconv_kernel

KERNELS = {
    "fps": fps_kernel,
    "setconv": setconv_kernel,
    "knnconv": knnconv_kernel,
    "fusion": fusion_kernel,
    "ball": ball_kernel,
    "knn": knn_kernel,
    "knn_cells": knn_cells_kernel,
    "attention": attention_kernel,
    "fusion_resi": fusion_resi_kernel,
    "nearest": nearest_launches,
    "attention_bwd": attention_bwd_kernel,
    "flowenc": flowenc_kernel,
    "flowmid": flowmid_kernel,
    "fusion_tail": fusion_tail_kernel,
    "fusion_cells": fusion_cells_kernel,
    "pn2mid": pn2mid_kernel,
    "auction_pass": auction_pass_kernel,
    "auction_chase": auction_chase_kernel,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "KERNELS",
    "attention_bwd",
    "attention_bwd_kernel",
    "attention_kernel",
    "auction",
    "auction_chase_kernel",
    "auction_pass_kernel",
    "ball_kernel",
    "ball_query_multi",
    "build_seconds",
    "flowenc_fused",
    "flowenc_kernel",
    "flowmid_fused",
    "flowmid_kernel",
    "fold_bn_layers",
    "fps_kernel",
    "fusion_attention_tail",
    "fusion_cells_attention",
    "fusion_cells_kernel",
    "fusion_cells_multi_knn",
    "fusion_cells_resi_knn",
    "fusion_kernel",
    "fusion_resi_kernel",
    "fusion_resi_knn",
    "fusion_tail_kernel",
    "knn",
    "knn_cells",
    "knn_cells_kernel",
    "knn_fusion_attention",
    "knn_kernel",
    "knnconv_fused",
    "knnconv_kernel",
    "launch_counts",
    "nearest_launches",
    "plain_versions",
    "pn2mid_fused",
    "pn2mid_kernel",
    "reset_launch_counts",
    "setconv_fused",
    "setconv_kernel",
    "vector_attention",
    "vector_attention_trainable",
]
