"""Command-line entry points of the port (counterpart of ``pci_tpu.cli``):
``python -m pci_tpu_torch.cli.test`` (ISAPCInet eval) and ``python -m
pci_tpu_torch.cli.test_pointinet`` (PointINet eval).  Each ``main(argv,
device=None)`` runs on the CUDA device unless ``device`` says otherwise."""
