"""Shared CLI plumbing of the eval entry points (counterpart of the parts of
``pci_tpu/cli/common.py`` that eval needs): the flag sets, ISAPCInet built
with its checkpoints composed as the reference does (flow first, then the
whole model), and batches on the device."""

from __future__ import annotations

import argparse

import torch

from ..data import collate, to_device
from ..models import ISAPCInet
from ..serving import init_weights
from ..train import load_flow_into, load_params


def add_nuscenes_flags(p: argparse.ArgumentParser):
    p.add_argument("--root", type=str, required=True)
    p.add_argument("--scenes_list", type=str, required=True)
    p.add_argument("--scene_split_lib", type=str, required=True)
    p.add_argument("--field", type=int, default=2)
    p.add_argument("--npoints", type=int, default=16000)
    p.add_argument("--interval", type=int, default=5)
    p.add_argument("--if_random", action="store_true", default=False)
    p.add_argument("--random_times", type=int, default=1)
    p.add_argument("--sample_method", type=str, default="fps", choices=["fps", "random"])


def add_model_flags(p: argparse.ArgumentParser):
    p.add_argument("--freeze", type=int, default=1,
                   help="accepted; the port's ISAPCInet always freezes its flow")
    p.add_argument("--ff_out_c", type=int, default=64)
    p.add_argument("--tr_out_c", type=int, default=64)
    p.add_argument("--use_tnet", type=int, default=1)
    p.add_argument("--pretrained_flow_model", type=str, default=None)
    p.add_argument("--pretrained_self_model", type=str, default=None)
    p.add_argument("--save_dir", type=str, default="./result_models")
    p.add_argument("--resume", action="store_true")


batch_to_device = to_device  # the JAX CLIs' name for the copy to the device


def example_from_loader(dataset, device) -> dict:
    """The dataset's first sample as a batch of one on ``device``."""
    return batch_to_device(collate([dataset[0]]), device)


def build_isapci(args, batch_example: dict, device) -> ISAPCInet:
    """ISAPCInet for ``args`` (``--use_tnet 0``: no Tnet, the noT_96
    variant) on ``device`` in eval mode: a seeded init, then
    ``--pretrained_flow_model`` into its flow, then
    ``--pretrained_self_model`` over the whole model.  ``batch_example``
    must hold ``field`` context frames each side of the key pair."""
    for side in ("forward", "backward"):
        if len(batch_example[side]) != args.field:
            raise ValueError(f"the window holds {len(batch_example[side])} {side} frames, "
                             f"--field is {args.field}")
    model = ISAPCInet(field=args.field, ff_out_c=args.ff_out_c, tr_out_c=args.tr_out_c,
                      use_tnet=bool(args.use_tnet))
    init_weights(model, args.seed)
    if args.pretrained_flow_model:
        load_flow_into(model, args.pretrained_flow_model)
    if args.pretrained_self_model:
        load_params(args.pretrained_self_model, model)
    return model.to(torch.device(device)).eval()
