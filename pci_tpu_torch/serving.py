"""Inference API of the port (counterpart of ``pci_tpu/serving.py``):
build PointINet or ISAPCInet once, then synthesize frames at any ``t``.

Example::

    interp = Interpolator.pointinet(npoints=16384, weights=DEFAULT_WEIGHTS)
    mid = interp(cloud_a, cloud_b, t=0.5)                  # [N, 3] numpy
    frames = interp.upsample(cloud_a, cloud_b, factor=5)   # 4 in-betweens

    # B independent streams in one forward, each at its own t
    frames = interp.stream_batch([(a0, b0), (a1, b1)], [0.5, 0.3])

    # ISAPCInet field=2: two context frames on each side of the key pair
    interp = Interpolator.isapci(field=2, weights=DEFAULT_WEIGHTS)
    mid = interp(cloud_a, cloud_b, 0.5, context=([f1, f2], [b1, b2]))

Runs on CUDA unless the caller passes ``device="cpu"``; with no CUDA
device and no ``device`` given it raises.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from .convert import flax_to_state_dict, load_npz_tree, load_subtrees
from .data.lidar import random_subsample
from .models import ISAPCInet, PointINet

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


def init_weights(model: torch.nn.Module, seed: int) -> None:
    """The JAX package's init, drawn from a CPU generator: xavier-uniform
    Dense kernels and zero biases; BatchNorm keeps (1, 0, 0, 1), GroupNorm
    (1, 0)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Linear):
                bound = math.sqrt(6.0 / (mod.in_features + mod.out_features))
                w = torch.empty(mod.weight.shape).uniform_(-bound, bound, generator=g)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.zero_()


class Interpolator:
    """Frame-interpolation engine around the port's PointINet (a pair of
    scans) or ISAPCInet (a window: ``field`` context frames each side)."""

    def __init__(self, model: torch.nn.Module, npoints: int, seed: int,
                 device: torch.device, field: int | None = None):
        self.model = model.eval()
        self.npoints = npoints
        self.field = field
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

    @classmethod
    def isapci(cls, field: int = 2, npoints: int = 16000, weights=None,
               seed: int = 0, device=None, **model_kw) -> "Interpolator":
        """ISAPCInet (``model_kw``: ``ff_out_c``, ``tr_out_c``,
        ``use_tnet``; the published variants: noT_96 is ``use_tnet=False,
        ff_out_c=96, tr_out_c=96``, field 0 and 1 run at 128) with a
        random init from ``seed``, over
        which ``weights`` (an npz of flat flax keys) loads whole sub-trees:
        a full ISAPCInet tree, or a PointINet one such as
        :data:`DEFAULT_WEIGHTS`, whose ``flow`` and ``fusion`` have
        ISAPCInet's names and shapes (the JAX ``ckpt`` / ``flow_ckpt``)."""
        device = resolve_device(device)
        model = ISAPCInet(field=field, **model_kw)
        init_weights(model, seed)
        if weights is not None:
            load_subtrees(model, load_npz_tree(weights))
        return cls(model.to(device), npoints, seed, device, field=field)

    def _prep(self, cloud) -> torch.Tensor:
        """A ``[N, >=3]`` scan resampled to ``npoints`` -> ``[1, npoints,
        3]``; a pre-batched ``[1, N, 3]`` cloud passes through as it is."""
        pts = np.asarray(cloud, np.float32)[..., :3]
        if pts.ndim == 2:
            if pts.shape[0] != self.npoints:
                pts = random_subsample(pts, self.npoints, self._rng)
            pts = pts[None]
        return torch.from_numpy(np.ascontiguousarray(pts)).to(self.device)

    def __call__(self, cloud_a, cloud_b, t: float, context=None,
                 perms=None) -> np.ndarray:
        """The frame at ``t`` between two ``[N, >=3]`` scans (each resampled
        to ``npoints``) -> ``[npoints, 3]`` numpy.  ``context``: for
        ISAPCInet, ``(forward_frames, backward_frames)``, ``field`` scans
        each (before the key pair, nearest first; after it, nearest
        first).  ``perms``: optional fusion permutations ``(perm1, perm2)``
        ``[1, npoints]``."""
        a, b = self._prep(cloud_a), self._prep(cloud_b)
        z = torch.zeros_like(a)
        tt = torch.tensor([float(t)], dtype=torch.float32, device=self.device)
        if self.field is None:
            if context is not None:
                raise ValueError("PointINet takes no context frames")
            args = (a, b, z, z, tt)
        else:
            fwd, bwd = context if context is not None else ([], [])
            if len(fwd) != self.field or len(bwd) != self.field:
                raise ValueError(
                    f"ISAPCInet field={self.field} needs {self.field} context "
                    "frames each side via context=(forward, backward)")
            args = ([self._prep(c) for c in fwd], [a, b],
                    [self._prep(c) for c in bwd], tt, z)
        with torch.inference_mode():
            out = self.model(*args, perms=perms, generator=self.generator)
        return out[0].cpu().numpy()

    def stream_batch(self, pairs, ts, mesh=None, perms=None) -> list:
        """One forward for B independent ``(cloud_a, cloud_b)`` streams at
        per-stream times ``ts``: the throughput serving shape, each kernel
        launched once for all B streams.  Pair mode (PointINet) only.
        ``perms``: optional fusion permutations ``(perm1, perm2)``, ``[B,
        npoints]`` each.  Returns a list of B ``[npoints, 3]`` numpy
        frames.  ``mesh`` (the JAX package's data-axis sharding) is not
        ported: the port serves on one device."""
        if mesh is not None:
            raise NotImplementedError("stream_batch: sharding over a mesh is not ported")
        if self.field is not None:
            raise ValueError("stream_batch is pair-mode (PointINet) only")
        if not pairs or len(pairs) != len(ts):
            raise ValueError(f"stream_batch: {len(pairs)} pairs and {len(ts)} times")
        a = torch.cat([self._prep(x) for x, _ in pairs])
        b = torch.cat([self._prep(y) for _, y in pairs])
        z = torch.zeros_like(a)
        t = torch.tensor([float(v) for v in ts], dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            out = self.model(a, b, z, z, t, perms=perms, generator=self.generator)
        return list(out.cpu().numpy())

    def upsample(self, cloud_a, cloud_b, factor: int = 5, context=None):
        """``factor - 1`` in-between frames at ``t = i / factor``."""
        return [self(cloud_a, cloud_b, i / factor, context)
                for i in range(1, factor)]
