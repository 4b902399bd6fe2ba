"""Models of the port (counterpart of ``pci_tpu.models``)."""

from .flownet3d import FlowNet3D
from .isapci import ISAPCInet, PointINet2
from .pointinet import PointINet

__all__ = ["FlowNet3D", "ISAPCInet", "PointINet", "PointINet2"]
