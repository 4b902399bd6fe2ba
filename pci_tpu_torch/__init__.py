"""pci_tpu_torch: the PyTorch/CUDA port of ``pci_tpu`` for NVIDIA Hopper.

Eval-path PointINet (bidirectional FlowNet3D -> linear warp -> adaptive
attentive fusion) and ISAPCInet (a window of flows -> Tnet, PointNet++ and
a point transformer over the flow cloud -> warp -> fusion), with
hand-written CUDA kernels for FPS, set-conv, kNN-conv, the one-shot fusion
head, the multi-scale ball query, the exact kNN and the vector-attention
tail (``ops.cuda_kernels``).  Imports PyTorch only; the JAX package is its
reference, never a dependency.
"""

from .serving import Interpolator

__all__ = ["Interpolator"]
