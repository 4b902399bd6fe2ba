"""Hand-written CUDA kernels for Hopper (``sm_90a``), one per TPU kernel of
the port's eval paths (PointINet and ISAPCInet), each beside its plain
PyTorch version.

Every kernel wrapper (``*_kernel``) counts its launches in a
``launches`` attribute.  Nothing here builds or loads a kernel when it is
imported: :func:`_build.library` does, at the first launch.
"""

from ._build import build_seconds, plain_versions
from .attention_cuda import attention_kernel, vector_attention
from .ball_cuda import ball_kernel, ball_query_multi
from .fps_cuda import fps_kernel
from .fusion_knn_cuda import fusion_kernel, knn_fusion_attention
from .knn_cuda import knn, knn_kernel
from .knnconv_cuda import knnconv_fused, knnconv_kernel
from .setconv_cuda import fold_bn_layers, setconv_fused, setconv_kernel

KERNELS = {
    "fps": fps_kernel,
    "setconv": setconv_kernel,
    "knnconv": knnconv_kernel,
    "fusion": fusion_kernel,
    "ball": ball_kernel,
    "knn": knn_kernel,
    "attention": attention_kernel,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "KERNELS",
    "attention_kernel",
    "ball_kernel",
    "ball_query_multi",
    "build_seconds",
    "fold_bn_layers",
    "fps_kernel",
    "fusion_kernel",
    "knn",
    "knn_fusion_attention",
    "knn_kernel",
    "knnconv_fused",
    "knnconv_kernel",
    "launch_counts",
    "plain_versions",
    "reset_launch_counts",
    "setconv_fused",
    "setconv_kernel",
    "vector_attention",
]
