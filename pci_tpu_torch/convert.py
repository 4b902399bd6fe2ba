"""Flax variables -> the port's ``state_dict``.

The JAX package's models keep ``{"params": ..., "batch_stats": ...}``
trees; the port's modules mirror their names with three renames:
``PointMLP_0`` -> ``mlp``, ``Dense_i`` -> ``dense.i``, ``BatchNorm_i`` ->
``bn.i`` (SetUpConv's ``conv1`` / ``conv2`` keep theirs).  Dense
``kernel [in, out]`` becomes ``weight [out, in]``; BatchNorm ``scale`` /
``bias`` / ``mean`` / ``var`` become ``weight`` / ``bias`` /
``running_mean`` / ``running_var``.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _module_name(part: str) -> str:
    if part == "PointMLP_0":
        return "mlp"
    m = re.fullmatch(r"(Dense|BatchNorm)_(\d+)", part)
    if m:
        return f"{'dense' if m.group(1) == 'Dense' else 'bn'}.{m.group(2)}"
    return part


def _leaves(tree, path=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, path + (key,))
        else:
            yield path + (key,), val


def flax_to_state_dict(variables: dict) -> dict:
    """``{"params": tree, "batch_stats": tree}`` of numpy arrays ->
    ``{name: torch.Tensor}`` (fp32)."""
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, val in _leaves(variables.get(collection, {})):
            *mods, leaf = path
            arr = np.array(val, np.float32)
            if leaf == "kernel":
                arr = arr.T
            name = ".".join([_module_name(m) for m in mods]
                            + [_LEAF[(collection, leaf)]])
            sd[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def load_npz_tree(path: str | Path) -> dict:
    """A flat ``/``-joined npz (``params/flow/.../kernel``) -> nested dict."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parts, leaf = key.split("/")
            for p in parts:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree
