"""Inference API of the port (counterpart of ``pci_tpu/serving.py``):
build PointINet once, then synthesize frames at any ``t``.

Example::

    interp = Interpolator.pointinet(npoints=16384, weights=DEFAULT_WEIGHTS)
    mid = interp(cloud_a, cloud_b, t=0.5)                  # [N, 3] numpy
    frames = interp.upsample(cloud_a, cloud_b, factor=5)   # 4 in-betweens

Runs on CUDA unless the caller passes ``device="cpu"``; with no CUDA
device and no ``device`` given it raises.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from .convert import flax_to_state_dict, load_npz_tree
from .models import PointINet

DEFAULT_WEIGHTS = Path(__file__).resolve().parent / "assets" / "pointinet_synth16k.npz"


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device, raising when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain versions"
            )
        return torch.device("cuda")
    return torch.device(device)


def random_subsample(points: np.ndarray, npoints: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Sample without replacement; pad with replacement if short (copy of
    ``pci_tpu/data/lidar.py:random_subsample``)."""
    n = points.shape[0]
    if n >= npoints:
        idx = rng.choice(n, npoints, replace=False)
    else:
        idx = np.concatenate(
            [np.arange(n), rng.choice(n, npoints - n, replace=True)]
        )
    return points[idx]


def init_weights(model: torch.nn.Module, seed: int) -> None:
    """The JAX package's init, drawn from a CPU generator: xavier-uniform
    Dense kernels and zero biases; BatchNorm keeps (1, 0, 0, 1)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Linear):
                bound = math.sqrt(6.0 / (mod.in_features + mod.out_features))
                w = torch.empty(mod.weight.shape).uniform_(-bound, bound, generator=g)
                mod.weight.copy_(w)
                mod.bias.zero_()


class Interpolator:
    """Frame-interpolation engine around the port's PointINet."""

    def __init__(self, model: PointINet, npoints: int, seed: int,
                 device: torch.device):
        self.model = model.eval()
        self.npoints = npoints
        self.device = device
        self._rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=device).manual_seed(seed + 1)

    @classmethod
    def pointinet(cls, npoints: int = 16384, weights=None, seed: int = 0,
                  device=None) -> "Interpolator":
        """PointINet with ``weights`` (an npz of flat flax keys, such as
        :data:`DEFAULT_WEIGHTS`) or, for None, a random init from ``seed``."""
        device = resolve_device(device)
        model = PointINet()
        if weights is not None:
            model.load_state_dict(flax_to_state_dict(load_npz_tree(weights)))
        else:
            init_weights(model, seed)
        return cls(model.to(device), npoints, seed, device)

    def _prep(self, cloud) -> torch.Tensor:
        pts = np.asarray(cloud, np.float32)[..., :3]
        if pts.shape[0] != self.npoints:
            pts = random_subsample(pts, self.npoints, self._rng)
        return torch.from_numpy(np.ascontiguousarray(pts))[None].to(self.device)

    def __call__(self, cloud_a, cloud_b, t: float, perms=None) -> np.ndarray:
        """The frame at ``t`` between two ``[N, >=3]`` scans (resampled to
        ``npoints``) -> ``[npoints, 3]`` numpy.  ``perms``: optional fusion
        permutations ``(perm1, perm2)`` ``[1, npoints]``."""
        a, b = self._prep(cloud_a), self._prep(cloud_b)
        z = torch.zeros_like(a)
        tt = torch.tensor([float(t)], dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            out = self.model(a, b, z, z, tt, perms=perms, generator=self.generator)
        return out[0].cpu().numpy()

    def upsample(self, cloud_a, cloud_b, factor: int = 5):
        """``factor - 1`` in-between frames at ``t = i / factor``."""
        return [self(cloud_a, cloud_b, i / factor) for i in range(1, factor)]
