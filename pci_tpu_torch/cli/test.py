"""Evaluate ISAPCInet: mean chamfer distance (optionally EMD) over a
held-out scene list (counterpart of ``pci_tpu/cli/test.py``, the
reference's test.py:34-94).

  python -m pci_tpu_torch.cli.test --root ... --scenes_list ... \
      --scene_split_lib ... --pretrained_flow_model <npz> [--emd]

Runs on the CUDA device; ``main(argv, device="cpu")`` runs the plain
versions on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import ops
from ..data import Loader, NuscenesInterpolationDataset
from ..serving import resolve_device
from ..train import MetricLogger, make_interp_eval_step
from .common import (
    add_model_flags,
    add_nuscenes_flags,
    batch_to_device,
    build_isapci,
    example_from_loader,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Eval ISAPCInet (pci_tpu_torch)")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--log_dir", type=str, default="./logs")
    p.add_argument("--emd", action="store_true", help="also compute EMD (x36 scale)")
    p.add_argument("--emd_method", type=str, default="auction", choices=["auction", "sinkhorn"])
    add_nuscenes_flags(p)
    add_model_flags(p)
    return p.parse_args(argv)


def main(argv=None, device=None):
    args = parse_args(argv)
    device = resolve_device(device)
    dataset = NuscenesInterpolationDataset(
        root=args.root, scenes_list=args.scenes_list,
        scene_split_lib=args.scene_split_lib, field=args.field,
        npoints=args.npoints, interval=args.interval,
        if_random=False, sample_method=args.sample_method, seed=args.seed,
    )
    model = build_isapci(args, example_from_loader(dataset, device), device)
    eval_step = make_interp_eval_step(model)
    logger = MetricLogger(args.log_dir, use_wandb=args.use_wandb)

    loader = Loader(dataset, args.batch_size, shuffle=False, drop_last=False)
    cds, emds = [], []
    generator = torch.Generator(device=device).manual_seed(args.seed)
    for i, batch in enumerate(loader):
        batch = batch_to_device(batch, device)
        cd, out = eval_step(batch, generator)
        cds.extend(cd.tolist())
        rec = {"cd": float(cd.mean()), "t": float(batch["t"][0])}
        if args.emd:
            emd_fn = ops.sinkhorn_emd if args.emd_method == "sinkhorn" else ops.emd
            with torch.inference_mode():
                e = float(emd_fn(out, batch["gt"]))
            emds.append(e)
            rec["emd"] = e
        logger.log(rec, step=i)
        print(f"[{i + 1}/{len(loader)}] CD {rec['cd']:.6f}"
              + (f"  EMD {rec.get('emd', 0):.3f}" if args.emd else ""))
    print(f"Mean CD: {np.mean(cds):.6f}")
    if emds:
        print(f"Mean EMD: {np.mean(emds):.4f}")
    logger.close()
    return float(np.mean(cds))


if __name__ == "__main__":
    main()
