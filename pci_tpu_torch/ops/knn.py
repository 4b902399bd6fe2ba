"""Exact k-nearest-neighbour search (counterpart of ``pci_tpu/ops/knn.py``
``knn`` and, with ``valid_n``, ``knn_prefix``).

Selection is a stable sort of the fp32 squared distances, so ties go to
the lower key index (``torch.topk`` leaves the order of ties unspecified).
On a CUDA tensor ``knn`` launches the kNN kernel (``cuda_kernels.knn_cuda``).
"""

from __future__ import annotations

from .cuda_kernels.knn_cuda import knn

__all__ = ["knn"]
