"""Evaluate PointINet CD and EMD on interpolation triplets (counterpart of
``pci_tpu/cli/test_pointinet.py``, the reference's
PointINet20230424/test.py:27-87).

  python -m pci_tpu_torch.cli.test_pointinet --dataset_name nuscenes \
      --root ... --scenes_list ... --scene_split_lib ... \
      --pretrained_interp_model pci_tpu_torch/assets/pointinet_synth16k.npz

Runs on the CUDA device; ``main(argv, device="cpu")`` runs the plain
versions on the CPU.  ``--use_intensity 1`` (the default) feeds ``[N, 4]``
clouds (xyz + intensity): the fused frame carries the intensity, and CD
and EMD are taken on its xyz, as the JAX CLI takes them;
``--use_intensity 0`` feeds xyz clouds.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import ops
from ..data import KittiInterpolationDataset, Loader, NuscenesTripletDataset
from ..models import PointINet
from ..serving import init_weights, resolve_device
from ..train import MetricLogger, load_flow_into, load_params
from .common import batch_to_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Eval PointINet (pci_tpu_torch)")
    p.add_argument("--dataset_name", type=str, default="kitti", choices=["kitti", "nuscenes"])
    p.add_argument("--root", type=str, required=True)
    p.add_argument("--scenes_list", type=str, default=None)
    p.add_argument("--scene_split_lib", type=str, default=None)
    p.add_argument("--npoints", type=int, default=16384)
    p.add_argument("--interval", type=int, default=5)
    p.add_argument("--use_intensity", type=int, default=1)
    p.add_argument("--pretrained_flow_model", type=str, default=None)
    p.add_argument("--pretrained_interp_model", type=str, default=None)
    p.add_argument("--no_emd", action="store_true")
    p.add_argument("--emd_method", type=str, default="auction", choices=["auction", "sinkhorn"])
    p.add_argument("--log_dir", type=str, default="./logs")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None, device=None):
    args = parse_args(argv)
    device = resolve_device(device)
    if args.dataset_name == "kitti":
        dataset = KittiInterpolationDataset(
            args.root, npoints=args.npoints, interval=args.interval,
            train=False, use_intensity=bool(args.use_intensity), seed=args.seed,
        )
    else:
        dataset = NuscenesTripletDataset(
            args.root, args.scenes_list, args.scene_split_lib,
            npoints=args.npoints, interval=args.interval, train=False,
            use_intensity=bool(args.use_intensity), seed=args.seed,
        )

    # the JAX CLI draws one sample to initialise its model: draw it too, so
    # the windows below take the same samples from the dataset's stream
    dataset[0]
    model = PointINet()
    init_weights(model, args.seed)
    # the reference composes two checkpoints at load (test.py:42-43)
    if args.pretrained_interp_model:
        load_params(args.pretrained_interp_model, model)
    if args.pretrained_flow_model:
        load_flow_into(model, args.pretrained_flow_model)
    model = model.to(device).eval()

    logger = MetricLogger(args.log_dir, use_wandb=args.use_wandb)
    loader = Loader(dataset, 1, shuffle=False, drop_last=False)
    cds, emds = [], []
    generator = torch.Generator(device=device).manual_seed(args.seed)
    for i, batch in enumerate(loader):
        batch = batch_to_device(batch, device)
        with torch.inference_mode():
            out = model(batch["ini_pc"], batch["end_pc"], batch["color"], batch["color"],
                        batch["t"], generator=generator)
            cd = float(ops.chamfer_distance(out[..., :3], batch["mid_pc"][..., :3]))
            cds.append(cd)
            rec = {"cd": cd}
            if not args.no_emd:
                emd_fn = ops.sinkhorn_emd if args.emd_method == "sinkhorn" else ops.emd
                e = float(emd_fn(out[..., :3], batch["mid_pc"][..., :3]))
                emds.append(e)
                rec["emd"] = e
        logger.log(rec, step=i)
        print(f"[{i + 1}/{len(loader)}] CD {cd:.6f}"
              + (f"  EMD {rec['emd']:.3f}" if not args.no_emd else ""))
    print(f"Mean CD: {np.mean(cds):.6f}")
    if emds:
        print(f"Mean EMD: {np.mean(emds):.4f}")
    logger.close()


if __name__ == "__main__":
    main()
