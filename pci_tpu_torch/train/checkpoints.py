"""Model weights on disk (counterpart of ``pci_tpu/train/checkpoints.py``),
with the reference's compose-at-load semantics: a pretrained FlowNet3D
grafted into a model's ``flow``, then optionally a whole model on top,
and the best epoch kept under a loss-stamped name.

Two formats load: the JAX package's variable tree as a flat npz
(``params/...`` and ``batch_stats/...`` keys, the layout of
``assets/pointinet_synth16k.npz``; through :mod:`..convert`), and the
port's own ``torch.save`` of a ``state_dict``.  An orbax checkpoint
directory (the JAX package's own format) is refused: reading it needs
orbax, which imports JAX.
"""

from __future__ import annotations

import os
import re
import zipfile

import torch

from ..convert import flax_to_state_dict, load_npz_tree


def _is_npz(path: str) -> bool:
    with zipfile.ZipFile(path) as z:
        return any(name.endswith(".npy") for name in z.namelist())


def _read_state(path: str) -> dict:
    """``{name: tensor}`` from an npz of a JAX variable tree (converted)
    or a torch ``state_dict`` file."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint): the port reads an npz of the "
            "JAX variable tree or its own torch file; export the tree to npz")
    if zipfile.is_zipfile(path) and _is_npz(path):
        return flax_to_state_dict(load_npz_tree(path))
    return torch.load(path, map_location="cpu", weights_only=True)


def load_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a whole model's weights into ``model`` (every key, every
    shape); returns ``model``."""
    model.load_state_dict(_read_state(path))
    return model


def load_flow_into(model: torch.nn.Module, flow_ckpt_path: str) -> torch.nn.Module:
    """Graft FlowNet3D weights into ``model.flow``: a FlowNet3D-only file,
    or the ``flow`` sub-tree of a whole model's (such as the trained
    PointINet's npz); returns ``model``."""
    state = _read_state(flow_ckpt_path)
    if any(k.startswith("flow.") for k in state):
        state = {k[len("flow."):]: v for k, v in state.items() if k.startswith("flow.")}
    model.flow.load_state_dict(state)
    return model


def save_params(directory: str, model: torch.nn.Module, step: int = 0) -> str:
    """``torch.save`` of ``model.state_dict()`` as ``<directory>/params_<step>``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(os.path.abspath(directory), f"params_{step}")
    torch.save(model.state_dict(), path)
    return path


class BestKeeper:
    """Tracks the best epoch loss and saves the model under
    ``<prefix>_<loss:.6f>`` whenever it improves (the reference's
    best-checkpoint-with-loss-in-the-name convention)."""

    def __init__(self, directory: str, prefix: str = "model"):
        self.directory = directory
        self.prefix = prefix
        self.best = float("inf")

    def update(self, model: torch.nn.Module, epoch: int, loss: float) -> str | None:
        if loss >= self.best:
            return None
        self.best = loss
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(os.path.abspath(self.directory), f"{self.prefix}_{loss:.6f}")
        torch.save(model.state_dict(), path)
        return path

    @staticmethod
    def best_path(directory: str, prefix: str = "model") -> str | None:
        if not os.path.isdir(directory):
            return None
        best, best_loss = None, float("inf")
        for name in os.listdir(directory):
            m = re.fullmatch(rf"{re.escape(prefix)}_([0-9.]+)", name)
            if m:
                loss = float(m.group(1))
                if loss < best_loss:
                    best, best_loss = os.path.join(directory, name), loss
        return best
