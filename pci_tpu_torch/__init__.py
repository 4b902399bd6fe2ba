"""pci_tpu_torch: the PyTorch/CUDA port of ``pci_tpu`` for NVIDIA Hopper.

PointINet (bidirectional FlowNet3D -> linear warp -> adaptive attentive
fusion), served one request or a batch of streams at a time, and ISAPCInet
(a window of flows -> Tnet, PointNet++ and a point transformer over the
flow cloud -> warp -> fusion), served and trained with the flow frozen,
with hand-written CUDA kernels (``ops.cuda_kernels``): FPS, FlowNet3D's
encoder and decode megakernels, set-conv, kNN-conv, the fusion's one-shot
head, residual kNN and attention tail, the multi-scale ball query, the
exact kNN, the vector-attention tail and its backward, and the EMD's
Gauss-Seidel auction under the eval CLIs (``pci_tpu_torch.cli``).
Imports PyTorch only; the JAX package is its reference, never a
dependency.
"""

from .serving import Interpolator

__all__ = ["Interpolator"]
