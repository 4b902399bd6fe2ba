"""Flax variables -> the port's ``state_dict``.

The JAX package's models keep ``{"params": ..., "batch_stats": ...}``
trees; the port's modules mirror their names with four renames:
``PointMLP_0`` -> ``mlp``, ``Dense_i`` -> ``dense.i``, ``BatchNorm_i`` ->
``bn.i``, ``GroupNorm_i`` -> ``gn.i`` (named modules such as SetUpConv's
``conv1``, PointNet++'s ``scale0`` or the transformer's ``w_qs`` keep
theirs).  Dense ``kernel [in, out]`` becomes ``weight [out, in]``;
BatchNorm ``scale`` / ``bias`` / ``mean`` / ``var`` become ``weight`` /
``bias`` / ``running_mean`` / ``running_var``; GroupNorm ``scale`` /
``bias`` become ``weight`` / ``bias``.
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
    m = re.fullmatch(r"(Dense|BatchNorm|GroupNorm)_(\d+)", part)
    if m:
        short = {"Dense": "dense", "BatchNorm": "bn", "GroupNorm": "gn"}[m.group(1)]
        return f"{short}.{m.group(2)}"
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


def load_subtrees(model: torch.nn.Module, variables: dict) -> list:
    """Load flax ``variables`` into ``model``, whole top-level sub-trees at
    a time, and return the names of the sub-trees loaded.

    Every key must name a tensor of ``model`` of the same shape, and each
    top-level module the variables touch must be covered completely, so a
    PointINet tree (``flow`` and ``fusion``) loads into ISAPCInet's
    ``flow`` and ``fusion`` and leaves the rest as it was.  A tree with
    ``tnet_forward`` / ``tnet_backward`` loaded into an ISAPCInet built
    without Tnet (``use_tnet=False``) raises: its Tnet is not dropped.
    """
    sd = flax_to_state_dict(variables)
    own = model.state_dict()
    unknown = sorted(set(sd) - set(own))
    if unknown:
        raise KeyError(f"weights the model does not have: {unknown[:5]}")
    tops = sorted({key.split(".")[0] for key in sd})
    missing = sorted(k for k in own if k.split(".")[0] in tops and k not in sd)
    if missing:
        raise KeyError(f"sub-trees {tops} lack {missing[:5]}")
    bad = [k for k, v in sd.items() if tuple(v.shape) != tuple(own[k].shape)]
    if bad:
        raise ValueError(f"shapes differ for {bad[:5]}")
    model.load_state_dict(sd, strict=False)
    return tops
