"""pci_tpu_torch: the PyTorch/CUDA port of ``pci_tpu`` for NVIDIA Hopper.

Eval-path PointINet (bidirectional FlowNet3D -> linear warp -> adaptive
attentive fusion) with hand-written CUDA kernels for FPS, set-conv,
kNN-conv and the one-shot fusion head (``ops.cuda_kernels``).  Imports
PyTorch only; the JAX package is its reference, never a dependency.
"""

from .serving import Interpolator

__all__ = ["Interpolator"]
