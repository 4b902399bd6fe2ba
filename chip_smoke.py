#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pci_tpu_torch) of PointINet (at 16,384,
32,768 and 65,536 points, on xyz clouds and with the intensity channel),
ISAPCInet (field=2, served and trained; its published width variants
noT_96 and field 1 at 128), PointINet2 (field=2, at eval), and both eval
CLIs with the EMD metric, on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Every path takes the JAX package's default eval route (its gates
PCI_TPU_ENC_KERNEL, PCI_TPU_MID_KERNEL, PCI_TPU_FUSION_ONESHOT and
PCI_TPU_PN2_KERNEL at "1"): FlowNet3D's encoder and decode megakernels,
kNN-conv with the classifier inside, the one-shot fusion (on the
cell-pruned kernel from 32,768 points on), PointNet++'s mid-section in one
launch; phases 3, 5, 6 and 8 also serve routes with gates off.  Phases,
each printing its own lines:
  1. device: the card's name and power limit, torch and CUDA versions;
     TF32 off for matmuls and convolutions (the plain versions run fp32).
  2. build: the CUDA kernels from pci_tpu_torch/csrc with nvcc.
  3. kernels: each kernel against its plain PyTorch version on the card at
     every PointINet shape, recorded from one plain forward of a
     16,384-point request (plus FPS with P=1 at 16,384 and fusion at
     t=0.2), and again with all three gates off (set-conv and the
     per-stage kNN-conv at every FlowNet3D shape, the residual kNN and the
     attention tail); the times are medians of CUDA-event timings.  Then
     the `stages` lines: flowenc's FPS chain, set_conv1's and set_conv2's
     tiles at one request's and one 8-stream call's shapes, from its
     %globaltimer stage stamps, beside the ball scan alone (csrc/ball.cu);
     the FeaturePropagation's kNN-conv whole and without its MLP2.  Row 2
     (the per-stage set-conv) at FlowNet3D's four stages at 16,384 and
     65,536 points and in an 8-stream call (hold_setconv: against its plain version, and against
     the call in fp64 within SETCONV_FP64_LIMIT and below the 1xTF32
     control), with a `stages setconv` line each (events, device and host
     enqueue; the stamped plan and scan / gather / MLP / pool shares).
     Then
     FPS against its plain version at every shape its paths use
     (FPS_HOLDS: random starts, a start clamped to a shorter chain, 10%
     duplicate points), timed a launch and a greedy iteration, and the
     box-pruned kNN on a cloud almost all in one Morton cell, with
     duplicates, a cross cloud and the route's crossing shapes
     (KNN_CROSSING; indices and distances equal), timed beside the flat
     kernel.  FPS_HOLDS include the long-chain route (exact FPS at 32,768
     points, interleaved chains of 16,385 points at 131,073).  ops.knn's
     route by shape: a 4-channel cloud takes the plain version with no
     launch, k = 96 the flat kernel (hold_knn_routes).  The attention
     kernels at ATTENTION_HOLDS (ragged N, k = 7 with d = 40 and 24, the
     block-wide forward and the wide backward at d = 72, 96 and 128, and
     the forward's scalar route at k = 32 and d = 64 and 128), the backward
     also run twice for the same bits.  The ball query at BALL_HOLDS (far
     outliers whose scans become whole-range tasks, an empty ball, N ragged
     against the prefix, the task range and the ring stage, S < 8, eight
     scales; indices equal), the residual fusion kNN at FUSION_RESI_HOLDS
     (three and four segments, a segment shorter than its budget, a budget
     past 16, duplicates, a cloud 300 m out; at 1, 2 and 4 key parts,
     indices identical and residuals bit-equal), and PointsFusion at k =
     160, past the flat kernels, at eval (one tail launch, no kNN launch,
     within 1e-4 of the plain route) and in training (no kernel launched,
     bit-equal to the plain route).  Rows 4, 4b and 7 at k = 48 and 64, their k <= 64
     instantiations, at FUSION64_HOLDS and FUSION64_MULTI_HOLDS (t near 0
     and 1, a segment shorter than its budget, payloads, three segments
     with a cloud the budgets' clamp leaves empty): row 4b bit-equal at
     every part count, rows 4 and 7 within 1e-4 and their weighted sums
     against fp64 within TAIL_SUM_LIMIT, then their resources.
     TransformerLayer at ATTENTION_ROUTE_HOLDS (d_model 20 and 256 at eval,
     256 in training): no attention launch, equal to the plain route.
     The k = 1 kNN (csrc/knn.cu nearest_kernel) at NEAREST_HOLDS
     (the eval windows' shapes, a cluster edge, prefixes of 0 and past N,
     duplicates tied across the ranks; indices and distances equal) and
     the attention tail at FUSION_TAIL_HOLDS (k = 7-32, payloads of 0-5
     channels), and its weighted sums alone against fp64 beside a single
     TF32 product's.  The one-shot kernels with a payload (rows 4 and 12,
     the intensity of PointsFusionWithFeatures) at FUSION_PAYLOAD_HOLDS
     (16,384 points at t = 0.5 and 0.2 with one channel; 0, 2 and 5
     channels at smaller N; a segment shorter than its budget, whose
     unfilled slots carry the row's own payload; the cells kernel at
     65,536 and 32,768): xyz within 1e-4 of the plain version, the payload
     sums against fp64 within TAIL_SUM_LIMIT beside a single TF32
     product's, the cells kernel within 1e-6 m of the flat
     one on the same cloud and payload; both kernels' resources with the
     payload.  The `stages fusion_resi` line of the all-gates-off request's
     residual kNN: its time at 1, 2 and 4 parts and its items' scan, merge
     and write from their %globaltimer stamps; its `stages fusion_tail`
     line.
  4. serving: Interpolator.pointinet(npoints=16384) with the trained weights
     answers five requests (t=0.5, then upsample(factor=5)); the launch
     counters must rise by PER_REQUEST a request (2 FPS, 2 flowenc, 2
     flowmid, 2 kNN-conv, 1 fusion), every frame must be [16384, 3] and
     finite, and one frame must match the same forward through the plain
     versions.
  5. stream serving: Interpolator.stream_batch, 8 streams x 16,384 points
     at eight distinct t: every kernel against its plain version at every
     shape of one 8-stream call (the attention tail also with a payload
     channel; `stages fusion_resi` of its one-shot-off residual kNN,
     `stages fusion_tail` of its tails), the fused FlowNet3D route against the per-stage one on the
     same pairs (p99.9 <= 1e-4 m), five calls with PER_STREAM_CALL
     launches each, each stream's frame against a single request with the
     same permutations, ms per call, frames/s, busy share, peak memory;
     then PointINet served five requests on each route (all gates off:
     PER_REQUEST_ALL_OFF; one-shot off: PER_REQUEST_ONESHOT_OFF) and each
     route's ms/frame beside the default's.
  6. ISAPCInet field=2 at 16,384 points a frame (a seeded six-frame window;
     flow and fusion weights from the trained PointINet, the rest from a
     seeded init): every kernel against its plain version at every shape
     of one plain request on each PointNet++ route (ball query, kNN and
     FPS indices equal, kNN distances bit-equal, the rest within 1e-4; the
     pn2mid route and, with PCI_TPU_PN2_KERNEL=0, the per-stage one's
     sa2-fp2 FPS, ball queries and 3-NN; the transformer's kNN on the
     box-pruned kernel, with its `stages knn` lines: the torch prep, the
     kernel, the pairs it scanned, its tiles; the `stages ball` lines of
     sa1's two ball queries: each query's stop key, the queries the prefix
     leaves short of K, their tasks, the phases' spans from %globaltimer
     stamps, the call by events, device and host time; pn2mid at a batch of 17 in
     two launches against its plain version; the `stages attention`
     lines at the request's shape), then five served requests
     with the launch counts of PER_REQUEST_ISAPCI each, the frame against
     the plain versions, latency and the device's busy share; then with
     PCI_TPU_PN2_KERNEL=0 (PointNet++ stage by stage): five requests with
     PER_REQUEST_ISAPCI_PN2_OFF each, its frame against the default's,
     both routes' ms/frame; one request at the default 16,000 points.
  7. ISAPCInet field=2 training (the trainer's defaults: 16,000 points,
     batch 2, t = 0.5 and 0.3, Adam lr 0.01, BN momentum 0.5, the flow
     frozen; two seeded synthetic windows): every kernel against its plain
     version at every shape of one plain training step (the attention
     backward at the gradient that step gives it; the residual kNN also
     at three segments, PointsFusionMulti's form, and the chamfer's kNN
     over key prefixes, knn_pallas's valid_n; `stages knn` for the
     transformers' box-pruned kNNs; `stages attention`: the forward's and
     the backward's %globaltimer stage split at the step's shape; `stages
     ball` of the step's eight ball queries, `stages fusion_resi` of its
     residual kNN and `stages nearest` of the chamfer's two k = 1 kNNs:
     events, device and stamped ms, the cluster, the share of pairs
     measured exactly), then one step's loss
     and gradients through the kernels against the plain versions from the
     same flows, permutations and FPS starts, then five steps with the
     launch counts of PER_STEP each, finite losses, the flow bit-unchanged
     and every other parameter moved; ms/step, peak memory, busy share.
  8. PointINet at 65,536 and 32,768 points (paper Table 6's other rows; the
     fusion on the cell-pruned kernel): at each size every kernel against
     its plain version at every shape of one request (t=0.5, the fusion
     also at t=0.2) and of one one-shot-off request (the residual mode and
     the tail, with its `stages fusion_tail` line); the cell-pruned kernel
     against the flat one on the same combined cloud (indices identical,
     one-shot rows within 1e-6 m of the flat one-shot kernel's and of the
     flat residual kNN + tail's) with the share of pairs it scanned; five requests with PER_REQUEST_CELLS
     each, the frame against the plain forward, ms/frame (median of 20);
     five with one-shot off (PER_REQUEST_CELLS_ONESHOT_OFF) in the same
     process, its frame against the default's; busy share at 65,536; at
     32,768 the residual mode's gradient into the cloud through the kernel
     and the plain version (equal bit for bit, deterministic scatter).
  9. the eval CLIs with the EMD metric, on seeded synthetic scenes
     (generate_scenes, 24,000 points a frame, --sample_method random so
     the host's FPS stays out of the time): python -m
     pci_tpu_torch.cli.test --field 2 --npoints 16000 --emd over four
     windows (the flow from the trained PointINet, the rest a seeded init)
     and cli.test_pointinet --dataset_name nuscenes --npoints 16384
     over four triplets (the trained PointINet), at --use_intensity 0 and
     at its default --use_intensity 1 ([N, 4] clouds), each
     with the launch counts set to 0 just before: PER_WINDOW_ISAPCI /
     PER_TRIPLET a window, one auction pass and chase a pass of each EMD;
     mean CD and EMD, each EMD's converged flag, passes, hops and ms, the
     seconds a window.  Then the auction kernels against their plain
     versions: at 1,024 points (a seeded pair with 10% duplicates) bit for
     bit after the first two passes and chases and over the whole run, and
     the cost within the certificate of scipy's optimum; at the first EMD
     of each CLI (16,000 and 16,384 points, its frame against its ground
     truth) after the first two passes and chases, and at 16,384 over the
     whole run, with the device's busy share over one EMD; the certificate
     (primal minus the prices' dual bound within n (1.0001 eps + 1e-5))
     at all three on a converged run; the first two passes and chases bit
     for bit on two more seeded pairs with 10% duplicates: 4,099 points (a
     column count that is a multiple of neither C nor 32) and 33,000,
     above the cluster chase's limit, where the chase takes the one-block
     kernel (the route by size is checked at both).  Last the `stages
     auction` line of the 16,384-point EMD: the cluster chase's C and
     shared memory a CTA, the chase's device time a hop and the pass's a
     tile, and both kernels' %globaltimer phase split.
 10. PointINet with its intensity channel ([1, N, 4] clouds: the synthetic
     pair and a seeded intensity in [0, 1]) at 16,384 and 65,536 points,
     through PointINet.forward as the eval CLI calls it: one plain
     request's dispatches on the default route and with one-shot off
     (PER_REQUEST / PER_REQUEST_CELLS and their one-shot-off counts: the
     payload rides the same launch), the one-shot call with its payload
     and the tail with its extra channel against their plain versions
     (the payload channel against the call in fp64, PAYLOAD_LIMIT),
     the `stages fusion_payload` line (the one-shot kernel without and
     with the payload on the request's cloud, CUDA events and device
     time); five requests on each route with those launch counts, [N, 4]
     finite frames, the frame against the plain forward and one-shot
     off's against the default's, ms/frame beside the xyz request's
     through the same model.
 11. PointINet2 field=2 at eval (flows and the key fusion from the trained
     PointINet, Wnet and the k = 64 fusions a seeded init): one
     16,384-point request through the model's forward and
     make_interp_eval_step at the trainer's 16,000 points, batch 2: one
     plain call's dispatches against PER_REQUEST_POINTINET2 (and one-shot
     off's, PER_REQUEST_POINTINET2_ONESHOT_OFF; the step's,
     PER_EVAL_STEP_POINTINET2), its fusion kernels (rows 4, 4b and 7 at k
     = 32 and 64) against their plain versions at these shapes, then five
     requests (steps) on each route with those counts, the frames against
     the plain forward, one-shot off's against the default's, finite
     chamfers, ms a request (step) and the busy share.  Then one request at
     65,536 points (B = 1, the paper's 128-beam row) on the cell-pruned
     routes: the key fusion and the rings on row 12 (k = 32 and 64),
     fusion2 as three masked passes of row 10 (PER_REQUEST_POINTINET2_LARGE;
     one-shot off: row 12's residual mode and the tail,
     PER_REQUEST_POINTINET2_LARGE_ONESHOT_OFF), its fusion calls against
     their plain versions, five requests on each route, the frames against
     the plain forward, ms a request, the busy share, and the same call on
     the parent's route (the flat rows 4 and 4b at k = 64) for comparison.
     Then the kernel holds at 32,768 and 65,536 points: row 12 at k = 48
     and 64 (CELLS64_HOLDS, both modes, a one-channel payload; residuals
     bit-equal, rows within 1e-4, the weighted sums against fp64), row 10's
     masked passes at MASKED_HOLDS (F = 3, Wnet-like budgets, a segment
     shorter than its budget beside a budget of 0; idx and resi bit-equal;
     each pass's scanned pairs beside the flat scan's), each timed beside
     the flat kernels, then their resources beside the k <= 32 ones.
 12. ISAPCInet's published width variants (VARIANTS; seeded weights, the
     flow and fusion of the trained PointINet): noT_96 (field 2 without
     Tnet, ff/tr 96) and field 1 at 128, one 16,384-point request each
     (phase 6's seeded window at the variant's field): one plain request's
     dispatches against PER_REQUEST_NOT96 / PER_REQUEST_FIELD1 and its
     attention calls against their plain versions, five requests with those
     counts, the frame against the plain forward from the same flows (phase
     6's limits), ms/frame and the busy share; field 1 at 128's training
     step (phase 7's batch at field 1): a plain step's dispatches against
     PER_STEP_FIELD1 and its attention forward and backward against their
     plain versions, one step against the plain step (phase 7's limits),
     five steps with their counts, ms/step and peak memory; cli.test
     --field 2 --use_tnet 0 --ff_out_c 96 --tr_out_c 96 over phase 9's scene
     (chamfer only; PER_WINDOW_ISAPCI a record); the attention at the
     variants' widths (ATTENTION_WIDTHS: the request's 65,536 queries at d
     = 96 and 32,768 at 128, the step's 64,000 at 128) against its plain
     versions, timed beside them and its bound; the wide instantiations'
     resources.
 13. The fusion at k in 65-128 (rows 4, 4b and 7 on their k <= 128
     kernels, four slots a lane; row 7's streaming kernel past k = 64):
     the kernel holds at FUSION128_HOLDS / FUSION128_MULTI_HOLDS (k = 65,
     96 and 128 at 16,384 and 65,536 points, t near 0 and 1, segments
     shorter than their budgets, payloads of 1 and 2 channels, F = 3 and
     4; as phase 3's k <= 64 holds, timed) and row 7 at k = 160
     (TAIL_K160_HOLDS), the new
     kernels' resources; then requests through the models' constructors:
     PointINet(fusion_k=128) at 16,384 and 65,536 points, xyz and with an
     intensity channel (PER_REQUEST_K128), at 16,384 xyz also with
     one-shot off (PER_REQUEST_K128_ONESHOT_OFF), PointINet2(field=2,
     fusion_k=128) at 16,384 (PER_REQUEST_POINTINET2_K128) and
     ISAPCInet(field=2, fusion_k=96, fusion_sampling="fps") at 16,384
     (PER_REQUEST_ISAPCI_FPS): a plain request's dispatches against the
     counts, its fusion calls (and the FPS orders over all points) against
     their plain versions with `stages fusion128` lines, five requests with
     the counts set to 0 before, the frame against the plain forward (with
     the same permutations; ISAPCInet's from the same flows on the FPS
     orders its kernel route took, its warped clouds within 1e-5 m),
     ms/frame.
     FPS at npoint = N (16,384 and 65,536 points, 10% duplicates) is among
     phase 3's FPS_HOLDS.
Each phase prints the seconds since the start when it ends.
Then a resources line for each kernel whose dense products run on the
tensor cores (the one-shot fusion, the attention tail, flowmid, kNN-conv,
flowenc and the attention pair, 3xTF32; kNN-conv's at the
FeaturePropagation's plan), for the auction's pass
and cluster chase (at their last launch's shared memory), for the
residual fusion kNN (4 parts, k = 32) and the k = 1 kNN: registers a thread,
static and dynamic shared bytes, resident blocks an SM, its max error
against its plain version relative to the output's largest magnitude; the
kernels JSON line, the card line, and {"ok": true, ...} last.  A kernel's
bound_ms is the larger of its bytes over HBM_BYTES_PER_S and its
operations over FP32_FLOPS, where a tensor-core kernel's dense products
count apart, at 3 x FLOP over TF32_FLOPS.
Exits non-zero, with no result line, when CUDA is missing or a phase fails.

`python3 chip_smoke.py --stages [kinds]` prints only the `stages` lines;
`--setconv` only row 2's holds and `stages setconv` lines (hold_setconv,
which loaded by path from an older tree's root times that tree's kernel);
`python3 chip_smoke.py --ptxas [csrc directory]` only the ptxas lines of
PTXAS_SOURCES (this tree's, or an older tree's unpacked by `git archive`);
`--variants` runs phase 12 alone; `--k128` phase 13 alone (with the FPS
holds); `--attention` the attention holds, the
route holds and the variants' widths (attention_widths, which loaded by
path from an older tree's root times that tree's routes).
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

NPOINTS = 16384
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM dense TF32 on the tensor cores
# kernels whose dense products run on the tensor cores in 3xTF32 (three TF32
# products a multiply-add, csrc/mma_tf32.cuh): their bound counts those
# products apart, at 3 x FLOP / TF32_FLOPS, beside the scalar work
TENSOR_KERNELS = {"setconv": "pci_setconv_attrs", "fusion": "pci_fusion_attrs",
                  "flowmid": "pci_flowmid_attrs",
                  "knnconv": "pci_knnconv_attrs", "flowenc": "pci_flowenc_attrs",
                  "attention": "pci_attention_attrs",
                  "attention_bwd": "pci_attention_bwd_attrs",
                  "fusion_cells": "pci_fusion_cells_attrs", "pn2mid": "pci_pn2mid_attrs",
                  "fusion_tail": "pci_fusion_tail_attrs"}
# the bound of these rows' earlier scalar ports is printed beside theirs
# (scalar_bound_ms: every operation at FP32_FLOPS)
SCALAR_BOUND_KERNELS = ("setconv", "attention", "attention_bwd", "fusion_cells", "pn2mid",
                        "fusion_tail")
# kernels whose resources print on the `kernel resources` lines (C entry)
RESOURCE_KERNELS = {**TENSOR_KERNELS, "auction_pass": "pci_auction_pass_attrs",
                    "auction_chase": "pci_auction_chase_attrs",
                    "fusion_resi": "pci_fusion_resi_attrs", "nearest": "pci_nearest_attrs"}
KERNEL_INFO = {  # name -> (source, TPU kernel it replaces)
    "fps": ("pci_tpu_torch/csrc/fps.cu",
            "pci_tpu/ops/pallas_kernels/fps_tpu.py:117"),
    "setconv": ("pci_tpu_torch/csrc/setconv.cu",
                "pci_tpu/ops/pallas_kernels/setconv_tpu.py:162"),
    "knnconv": ("pci_tpu_torch/csrc/knnconv.cu",
                "pci_tpu/ops/pallas_kernels/knnconv_tpu.py:161"),
    "fusion": ("pci_tpu_torch/csrc/fusion_knn.cu",
               "pci_tpu/ops/pallas_kernels/fusion_knn_tpu.py:555"),
    "ball": ("pci_tpu_torch/csrc/ball.cu",
             "pci_tpu/ops/pallas_kernels/ball_tpu.py:132"),
    "knn": ("pci_tpu_torch/csrc/knn.cu",
            "pci_tpu/ops/pallas_kernels/knn_cells_tpu.py:242"),
    "knn_cells": ("pci_tpu_torch/csrc/knn_cells.cu",  # the box-pruned route
                  "pci_tpu/ops/pallas_kernels/knn_cells_tpu.py:305"),
    "attention": ("pci_tpu_torch/csrc/attention.cu",
                  "pci_tpu/ops/pallas_kernels/attention_tpu.py:85"),
    "fusion_resi": ("pci_tpu_torch/csrc/fusion_knn.cu",
                    "pci_tpu/ops/pallas_kernels/fusion_knn_tpu.py:489"),
    "nearest": ("pci_tpu_torch/csrc/knn.cu",  # the kNN kernel's k=1 form
                "pci_tpu/ops/pallas_kernels/knn_tpu.py:132"),
    "attention_bwd": ("pci_tpu_torch/csrc/attention_bwd.cu",
                      "pci_tpu/ops/pallas_kernels/attention_tpu.py:358"),
    "flowenc": ("pci_tpu_torch/csrc/flowenc.cu",
                "pci_tpu/ops/pallas_kernels/flowenc_tpu.py:171"),
    "flowmid": ("pci_tpu_torch/csrc/flowmid.cu",
                "pci_tpu/ops/pallas_kernels/flowmid_tpu.py:241"),
    "fusion_tail": ("pci_tpu_torch/csrc/fusion_tail.cu",
                    "pci_tpu/ops/pallas_kernels/fusion_tail_tpu.py:95"),
    "fusion_cells": ("pci_tpu_torch/csrc/fusion_cells.cu",
                     "pci_tpu/ops/pallas_kernels/fusion_cells_tpu.py:255"),
    "pn2mid": ("pci_tpu_torch/csrc/pn2mid.cu",
               "pci_tpu/ops/pallas_kernels/pn2mid_tpu.py:266"),
    "auction_pass": ("pci_tpu_torch/csrc/auction.cu",
                     "pci_tpu/ops/pallas_kernels/auction_tpu.py:201"),
    "auction_chase": ("pci_tpu_torch/csrc/auction.cu",
                      "pci_tpu/ops/pallas_kernels/auction_tpu.py:323"),
}
# the JAX package's route gates, read at call time by both packages
GATES = ("PCI_TPU_ENC_KERNEL", "PCI_TPU_MID_KERNEL", "PCI_TPU_FUSION_ONESHOT",
         "PCI_TPU_PN2_KERNEL")
ALL_OFF = dict.fromkeys(GATES, "0")
ONESHOT_OFF = {"PCI_TPU_FUSION_ONESHOT": "0"}
PN2_OFF = {"PCI_TPU_PN2_KERNEL": "0"}


def per(**counts) -> dict:
    """Launch counts by kernel, 0 for each kernel not named."""
    return {name: counts.get(name, 0) for name in KERNEL_INFO}


# PointINet, one request on the default route: 2 encodings (FPS of
# set_conv1's centres, then flowenc) and 2 decodes (flowmid, then kNN-conv
# with the classifier), the one-shot fusion; an 8-stream call launches the
# same, each kernel once for all streams
PER_REQUEST = per(fps=2, flowenc=2, flowmid=2, knnconv=2, fusion=1)
PER_STREAM_CALL = PER_REQUEST
# the per-stage route (all gates off): 2 set-convs and 2 FPS an encoding,
# 2 set-convs, 2 FPS and 5 kNN-convs a decode; the residual kNN and the tail
PER_REQUEST_ALL_OFF = per(fps=8, setconv=8, knnconv=10, fusion_resi=1, fusion_tail=1)
PER_REQUEST_ONESHOT_OFF = per(fps=2, flowenc=2, flowmid=2, knnconv=2, fusion_resi=1,
                              fusion_tail=1)
# ISAPCInet field=2: 6 encodings and 8 decodes of FlowNet3D as above, two
# PointNet++ passes (sa1's FPS and ball query, the mid-section in one
# launch, fp1's interpolation each), two transformers (1 kNN over the
# 65,536 flow vectors, on the box-pruned kernel, and 1 attention tail
# each), one fusion (16,384 points: the flat kernel)
PER_REQUEST_ISAPCI = per(fps=6 + 2, flowenc=6, flowmid=8, knnconv=8 + 2, fusion=1, ball=2,
                         knn_cells=2, attention=2, pn2mid=2)
# with PCI_TPU_PN2_KERNEL=0: PointNet++ stage by stage (4 FPS, 4 ball
# queries, 4 FP interpolations a pass)
PER_REQUEST_ISAPCI_PN2_OFF = per(fps=6 + 8, flowenc=6, flowmid=8, knnconv=8 + 8, fusion=1,
                                 ball=8, knn_cells=2, attention=2)
# PointINet at 32,768 points and more: the fusion on the cell-pruned kernel
PER_REQUEST_CELLS = per(fps=2, flowenc=2, flowmid=2, knnconv=2, fusion_cells=1)
PER_REQUEST_CELLS_ONESHOT_OFF = per(fps=2, flowenc=2, flowmid=2, knnconv=2, fusion_cells=1,
                                    fusion_tail=1)
LARGE_N = (65536, 32768)  # paper Table 6's other protocol rows
# ISAPCInet field=2, one training step: the frozen flows as at eval (6 FPS,
# 6 flowenc, 8 flowmid, 8 kNN-convs); PointNet++ twice (4 FPS with random
# starts, 4 ball queries, and 4 FP interpolations under autograd whose 3-NN
# runs on the flat kNN kernel, not on kNN-conv); the transformers (2
# box-pruned kNNs, 2 attention forwards, 2 attention backwards); the
# fusion's residual kNN; the chamfer loss's two directions on the flat kNN
# kernel's k=1 form; the one-shot fusion is eval only
PER_STEP = per(fps=6 + 8, flowenc=6, flowmid=8, knnconv=8, ball=8, knn=8, knn_cells=2,
               attention=2, attention_bwd=2, fusion_resi=1, nearest=2)
# PointINet2 field=2 (phase 11), one request: the key PointINet (2
# encodings and 2 decodes of FlowNet3D, its one-shot fusion at k = 32), the
# ring flows from one FlowNet3D.multi over the 6 frames (6 encodings, 4
# decodes), the two ring fusions at k = 64 (the one-shot kernel's k <= 64
# instantiation), fusion2's residual kNN over 3 segments at k = 64 (its
# GroupNorm head is PyTorch's); with one-shot off each PointsFusion is the
# residual kNN and the tail; its eval step adds the chamfer's two k = 1 kNNs
PER_REQUEST_POINTINET2 = per(fps=2 + 6, flowenc=2 + 6, flowmid=2 + 4, knnconv=2 + 4,
                             fusion=1 + 2, fusion_resi=1)
PER_REQUEST_POINTINET2_ONESHOT_OFF = per(fps=2 + 6, flowenc=2 + 6, flowmid=2 + 4,
                                         knnconv=2 + 4, fusion_resi=3 + 1, fusion_tail=3)
PER_EVAL_STEP_POINTINET2 = per(**{**PER_REQUEST_POINTINET2, "nearest": 2})
# PointINet2 field=2 at 65,536 points (the cell-pruned routes, k <= 64): the
# same flows at that size, the key fusion (k = 32) and the two rings (k =
# 64) on the cells kernel (row 12), fusion2 as three masked passes of the
# box-pruned kNN (row 10, fusion_cells_multi_knn); with one-shot off each
# PointsFusion is row 12's residual mode and the tail
POINTINET2_LARGE_N = 65536
PER_REQUEST_POINTINET2_LARGE = per(fps=2 + 6, flowenc=2 + 6, flowmid=2 + 4, knnconv=2 + 4,
                                   fusion_cells=1 + 2, knn_cells=3)
PER_REQUEST_POINTINET2_LARGE_ONESHOT_OFF = per(fps=2 + 6, flowenc=2 + 6, flowmid=2 + 4,
                                               knnconv=2 + 4, fusion_cells=1 + 2,
                                               knn_cells=3, fusion_tail=3)
# ISAPCInet's published width variants (phase 12), one request each at
# 16,384 points: noT_96 (field 2, no Tnet, ff/tr 96) launches field 2's
# kernels (Tnet is PyTorch's); field 1 at 128 encodes 4 distinct frames and
# decodes 4 pairs, its transformers over the 32,768-point flow cloud (the
# attention on the block-wide tensor-core kernel at d = 96 and 128)
PER_REQUEST_NOT96 = PER_REQUEST_ISAPCI
PER_REQUEST_FIELD1 = per(fps=4 + 2, flowenc=4, flowmid=4, knnconv=4 + 2, fusion=1, ball=2,
                         knn_cells=2, attention=2, pn2mid=2)
# field 1 at 128, one training step (16,000 points, batch 2): phase 7's
# step with 4 encodings and 4 decodes; the attention backward on its wide
# kernel, 64,000 queries a launch at d = 128
PER_STEP_FIELD1 = per(fps=4 + 8, flowenc=4, flowmid=4, knnconv=4, ball=8, knn=8, knn_cells=2,
                      attention=2, attention_bwd=2, fusion_resi=1, nearest=2)
VARIANTS = (("noT_96", dict(field=2, use_tnet=False, ff_out_c=96, tr_out_c=96),
             PER_REQUEST_NOT96),
            ("field 1 at 128", dict(field=1, ff_out_c=128, tr_out_c=128), PER_REQUEST_FIELD1))
# phase 13, the fusion past k = 64 through the models' fusion_k and
# fusion_sampling: PointINet(fusion_k=128) launches PointINet's kernels, its
# one-shot fusion on the k <= 128 kernel (pci_fusion128) at every N (the
# cells route stops at k = 64), with one-shot off the residual kNN's k > 64
# kernel and the tail's streaming kernel; PointINet2(field=2, fusion_k=128) phase 11's
# launches, its rings and fusion2 at k = 128; ISAPCInet(field=2,
# fusion_k=96, fusion_sampling="fps") phase 6's and the fusion's two exact
# FPS orders over all 16,384 points
PER_REQUEST_K128 = PER_REQUEST
PER_REQUEST_K128_ONESHOT_OFF = PER_REQUEST_ONESHOT_OFF  # rows 4b and 7 at k = 128
PER_REQUEST_POINTINET2_K128 = PER_REQUEST_POINTINET2
PER_REQUEST_ISAPCI_FPS = per(**{**PER_REQUEST_ISAPCI, "fps": PER_REQUEST_ISAPCI["fps"] + 2})
FUSION_KINDS = ("fusion", "fusion_resi", "fusion_tail")
LARGE_FUSION_KINDS = ("fusion_cells", "knn_cells_multi", "fusion_tail")
STREAMS = 8
STREAM_T = tuple((i + 1) / (STREAMS + 1) for i in range(STREAMS))
FIELD = 2
TRAIN_N, TRAIN_T = 16000, (0.5, 0.3)  # the trainer's npoints; t a sample
TRAIN_LR, TRAIN_MOMENTUM = 0.01, 0.5  # init_lr; bn_momentum_schedule(epoch 0)
STEPS_PER_EPOCH = 1000  # nominal: the lr schedule steps by epoch
# the eval CLIs (phase 9): ISAPCInet field=2 at its 16,000 points over four
# windows of a 26-frame scene; PointINet at 16,384 over four triplets of a
# 6-frame scene; besides the auction, a window launches one request's
# kernels and the chamfer's two nearest-neighbour searches
PER_WINDOW_ISAPCI = per(**{**PER_REQUEST_ISAPCI, "nearest": 2})
PER_TRIPLET = per(**{**PER_REQUEST, "nearest": 2})
EVAL_WINDOWS = 4
EMD_EPS = 1e-3  # ops.emd's defaults: eps 1e-3, iters 2048 -> 256 passes at most
# eps is relative to d_scale = 2 (max|x1|^2 + max|x2|^2), so the auction's
# cost may exceed the optimum: by 12% on the 1,024-point pair (H100, 700 W).
# A random permutation or a greedy nearest-neighbour matching of that pair
# costs several times the optimum
COST_OVER_OPTIMUM = 1.2
AUCTION = ("auction_pass", "auction_chase")


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


@contextlib.contextmanager
def gates(values: dict):
    """The route gates' environment variables set to ``values`` for the
    block (the models read them at call time)."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed calls,
    after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def self_resi_call(query, points, k):
    """The box-pruned kernel call ``ops.knn_self_resi`` makes on a large
    cloud (its plain version under plain_versions()): ``(sq_dists, idx,
    resi)``."""
    from pci_tpu_torch.ops.cuda_kernels.knn_cuda import knn_cells

    return knn_cells(points, points, k, emit_resi=True)


def call_launches(call) -> tuple:
    """(kernel, launches) of a recorded call: the F-segment fusion route
    (``knn_cells_multi``) launches the box-pruned kNN once a segment."""
    name, _, args, _ = call
    if name == "knn_cells_multi":
        return "knn_cells", args[1].shape[1]
    return name, 1


def dispatch_counts(calls) -> dict:
    """Launches by kernel of recorded calls."""
    counts = dict.fromkeys(KERNEL_INFO, 0)
    for c in calls:
        kind, n = call_launches(c)
        counts[kind] += n
    return counts


@contextlib.contextmanager
def record_calls(calls: list):
    """Record the arguments of every kernel dispatch the model makes, and of
    the trainable attention's backward (at the gradient it receives).  A
    kNN dispatch is recorded under the kernel its route takes on the card
    (``knn_cells`` where ``knn_cuda.cells_route_ok``, else ``knn``; the
    transformer's ``knn_self_resi`` as the ``knn_cells`` call it makes);
    the fusion's F-segment route as ``knn_cells_multi`` (F launches of
    ``knn_cells``, call_launches)."""
    from pci_tpu_torch.ops.cuda_kernels import attention_bwd
    from pci_tpu_torch.ops.cuda_kernels.knn_cuda import cells_route_ok

    mods = {name: importlib.import_module(f"pci_tpu_torch.{name}")
            for name in ("models.flownet3d", "nn.fusion", "nn.layers", "nn.pointnet2",
                         "nn.transformer", "ops.fps", "ops.chamfer",
                         "ops.interpolate")}  # ops.fps: the module
    sites = [(mods["ops.fps"], "fps_index", "fps"),
             (mods["models.flownet3d"], "flowenc_fused", "flowenc"),
             (mods["models.flownet3d"], "flowmid_fused", "flowmid"),
             (mods["models.flownet3d"], "knnconv_fused", "knnconv"),
             (mods["nn.fusion"], "fusion_attention_tail", "fusion_tail"),
             (mods["nn.layers"], "setconv_fused", "setconv"),
             (mods["nn.layers"], "knnconv_fused", "knnconv"),
             (mods["nn.fusion"], "knn_fusion_attention", "fusion"),
             (mods["nn.fusion"], "fusion_resi_knn", "fusion_resi"),
             (mods["nn.fusion"], "fusion_cells_attention", "fusion_cells"),
             (mods["nn.fusion"], "fusion_cells_resi_knn", "fusion_cells"),
             (mods["nn.fusion"], "fusion_cells_multi_knn", "knn_cells_multi"),
             (mods["nn.transformer"], "knn_self_resi", "knn_cells"),
             (mods["nn.pointnet2"], "pn2mid_fused", "pn2mid"),
             (mods["nn.pointnet2"], "ball_query_multi", "ball"),
             (mods["nn.pointnet2"], "knnconv_fused", "knnconv"),
             (mods["ops.interpolate"], "knn", "knn"),
             (mods["nn.transformer"], "knn", "knn"),
             (mods["nn.transformer"], "vector_attention", "attention"),
             (mods["nn.transformer"], "vector_attention_trainable", "attention"),
             (mods["ops.chamfer"], "knn", "nearest")]
    saved = [getattr(mod, attr) for mod, attr, _ in sites]
    depth = [0]  # a plain version's own dispatches are not the model's
    for (mod, attr, name), fn in zip(sites, saved):
        def rec(*args, _fn=fn, _name=name, _attr=attr, **kw):
            if depth[0]:
                return _fn(*args, **kw)
            name = _name
            if _name == "knn" and cells_route_ok(args[0], args[1], args[2], kw.get(
                    "valid_n", args[3] if len(args) > 3 else None)):
                name = "knn_cells"
            if _attr == "knn_self_resi":  # held as the kernel call it makes
                calls.append((name, self_resi_call, (args[0], args[0], args[1]), {}))
            else:
                calls.append((name, _fn, args, kw))
            depth[0] += 1
            try:
                out = _fn(*args, **kw)
            finally:
                depth[0] -= 1
            if _attr == "vector_attention_trainable" and out.requires_grad:
                out.register_hook(lambda gout, a=args: calls.append(
                    ("attention_bwd", attention_bwd, (*a, gout.contiguous()), {})))
            return out
        setattr(mod, attr, rec)
    try:
        yield
    finally:
        for (mod, attr, _), fn in zip(sites, saved):
            setattr(mod, attr, fn)


def mlp_flops(layers, rows: int) -> float:
    return rows * sum(2.0 * w.shape[0] * w.shape[1] + 2.0 * w.shape[0]
                      for w, _ in layers)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def ball_stop(queries, keys, radii, ks) -> torch.Tensor:
    """``[B, S]`` the keys a first-K-in-index-order ball scan reads for
    each query: up to the key where every scale holds its K hits (N for a
    query whose balls never hold K)."""
    from pci_tpu_torch.ops import square_distance

    N = keys.shape[1]
    d = square_distance(queries, keys)
    stop = None
    for r, K in zip(radii, ks):
        hits = (d <= float(r) ** 2).int().cumsum(-1)
        full = hits[..., -1] >= K
        at = torch.where(full, (hits < K).sum(-1) + 1, N)
        stop = at if stop is None else torch.maximum(stop, at)
    return stop


def scanned_keys(queries, keys, radii, ks) -> float:
    """Keys a first-K-in-index-order ball scan reads: each query's scan
    stops at the key where every scale holds its K hits."""
    return float(ball_stop(queries, keys, radii, ks).sum().item())


def sqdist(d: torch.Tensor) -> torch.Tensor:
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def cells_pairs(combined, seg_ends, budgets, k) -> float:
    """(query, key) pairs an exact cell-pruned scan must touch on these
    inputs: for each query, every key of each chunk in which one segment's
    box lies no farther than that query's final k_s-th distance (its
    exact neighbours, from the plain version)."""
    from pci_tpu_torch.ops.cuda_kernels.fusion_cells_cuda import (
        CHUNK, cells_plan, fusion_cells_plain)

    dev = combined.device
    idx, _ = fusion_cells_plain(combined, seg_ends, budgets, k)
    _, _, boxes, _, _ = cells_plan(combined, seg_ends[:, 0].to(dev))
    total = 0.0
    for b in range(combined.shape[0]):
        x = combined[b].float()
        d = sqdist(x[idx[b]] - x[:, None, :])  # [N, k], unfilled slots 0
        k1 = min(int(budgets[b, 0]), k)
        k2 = min(int(budgets[b, 1]), k - k1)
        thr = [d[:, :k1].amax(-1) if k1 else None, d[:, k1:k1 + k2].amax(-1) if k2 else None]
        for q0 in range(0, x.shape[0], 8192):
            q = x[q0:q0 + 8192, None, :]
            need = torch.zeros(q.shape[0], boxes.shape[1], dtype=torch.bool, device=dev)
            for seg in range(2):
                if thr[seg] is None:
                    continue
                lo, hi = boxes[b, :, 2 * seg, :3], boxes[b, :, 2 * seg + 1, :3]
                gap = torch.clamp_min(torch.maximum(lo - q, q - hi), 0.0)
                need |= (lo[:, 0] <= hi[:, 0]) & (sqdist(gap) <= thr[seg][q0:q0 + 8192, None])
            total += float(need.sum()) * CHUNK
    return total


def multi_work(combined, seg_ends, budgets, k, out):
    """The F-segment route's (bytes, operations): its cloud, budgets and
    output read or written once, each pass's plan (the torch prep), and for
    each pass the pairs an exact box-pruned scan of the segment's keys must
    touch at that pass's final k-th distance (every key of the segment
    where it holds fewer keys than the budget), 8 operations a pair, then 3
    a residual slot."""
    from pci_tpu_torch.ops.cuda_kernels.fusion_cells_cuda import segment_slots
    from pci_tpu_torch.ops.cuda_kernels.knn_cuda import CELLS_CHUNK, knn_cells_plan

    idx, resi = out
    B, N, _ = combined.shape
    F = seg_ends.shape[1]
    caps, col0 = (t.cpu() for t in segment_slots(budgets.cpu(), k))
    ends = seg_ends.cpu().tolist()
    d = sqdist(resi)  # [B, N, k]
    plan_bytes, pairs = 0.0, 0.0
    pos = torch.arange(N, device=combined.device)
    for f in range(F):
        for b in range(B):
            lo, hi = (0 if f == 0 else max(ends[b][:f])), ends[b][f]
            cap, c0 = int(caps[b, f]), int(col0[b, f])
            if cap == 0 or hi <= lo:
                continue
            if hi - lo < cap:
                kth = torch.full((1, N), float("inf"), device=combined.device)
            else:
                kth = d[b:b + 1, :, c0:c0 + cap].amax(-1)
            pairs += knn_cells_pairs(combined[b:b + 1], combined[b:b + 1, lo:hi], kth,
                                     CELLS_CHUNK)
        valid = pos[None, :] < seg_ends[:, f:f + 1].to(combined.device)
        plan_bytes += nbytes(*knn_cells_plan(combined, combined, True, key_valid=valid))
    return (nbytes(combined, seg_ends, budgets, idx, resi) + plan_bytes,
            8.0 * pairs + 3.0 * B * N * k)


def knn_cells_pairs(query, points, kth, chunk: int) -> float:
    """(query, key) pairs an exact box-pruned kNN must touch on these
    inputs: for each query, every key of each chunk of ``chunk``
    Morton-sorted keys whose box lies no farther than that query's final
    k-th distance ``kth [B, S]`` (cells_pairs' rule for one segment)."""
    from pci_tpu_torch.ops.cells import chunk_boxes, sort_by_morton

    B, N, _ = points.shape
    pts, perm = sort_by_morton(points, (-N) % chunk)
    lo, hi = chunk_boxes(pts, chunk, perm < N)
    total = 0.0
    for b in range(B):
        for q0 in range(0, query.shape[1], 4096):
            q = query[b, q0:q0 + 4096, None, :].float()
            gap = torch.clamp_min(torch.maximum(lo[b] - q, q - hi[b]), 0.0)
            total += float((sqdist(gap) <= kth[b, q0:q0 + 4096, None]).sum()) * chunk
    return total


def pn2mid_work(l1x, l1f, groups, out):
    """pn2mid's stages as work() counts their per-stage kernels: the FPS
    (10 operations a point a pick), the ball scans, ~8 operations a value
    for the bias, the GroupNorm and the ReLU, the slot max, and the 3-NN (8
    a pair) with its interpolation; every dense layer's product (2 a
    multiply-add) apart, on the tensor cores."""
    from pci_tpu_torch.ops import index_points
    from pci_tpu_torch.ops.cuda_kernels.fps_cuda import fps_plain
    from pci_tpu_torch.ops.cuda_kernels.pn2mid_cuda import KS, RADII, S_LIST

    B, N1 = l1x.shape[:2]
    start = torch.zeros(1, dtype=torch.long, device=l1x.device)
    cs, src = [], l1x.float()
    for n in S_LIST:
        cs.append(index_points(src, fps_plain(src, n, start, 1)))
        src = cs[-1]
    keys = [l1x.float(), cs[0], cs[1]]
    ops = 10.0 * B * (S_LIST[0] * N1 + S_LIST[1] * S_LIST[0] + S_LIST[2] * S_LIST[1])
    rows = []
    for lv in range(3):
        ops += 10.0 * scanned_keys(cs[lv], keys[lv], RADII[lv], KS[lv])
        rows += [B * S_LIST[lv] * K for K in KS[lv]]
    out_w = [g[-1][0].shape[1] for g in groups]
    skip_w = {2: out_w[2] + out_w[3], 1: out_w[0] + out_w[1], 0: l1f.shape[-1]}
    for lv, nq in ((2, S_LIST[1]), (1, S_LIST[0]), (0, N1)):  # fp4, fp3, fp2
        cf = groups[6 + (2 - lv)][0][0].shape[0] - skip_w[lv]  # the interpolated width
        ops += 8.0 * B * nq * S_LIST[lv] + 6.0 * B * nq * cf
        rows.append(B * nq)
    tensor = 0.0
    for g, r in zip(groups, rows):
        for w, _ in g:
            tensor += r * 2.0 * w.shape[0] * w.shape[1]
            ops += r * 8.0 * w.shape[1]
        ops += r * g[-1][0].shape[1]  # the slot max (FP: the copy out)
    w = [t for g in groups for wa in g for t in wa]
    return nbytes(l1x, l1f, out, *w), ops, tensor


def work(name, args, kw, out):
    """(bytes, operations[, tensor FLOP]) the function needs on these
    inputs: each input read once, each output written once; data-dependent
    loops counted as this run's data needs them; for TENSOR_KERNELS the
    dense products' FLOP apart (bound_terms() counts them as 3xTF32)."""
    if name == "fusion_cells":
        combined, seg_ends, budgets = args[:3]
        B, N, _ = combined.shape
        k = args[-1]
        ops = 8.0 * cells_pairs(combined, seg_ends, budgets, k)
        if len(args) == 5:  # one-shot: the score MLP a slot (on the tensor cores,
            layers = args[3]  # counted apart), the softmax and sums, a payload's sums
            payload = kw.get("payload")
            ops += (6.0 + 2.0 * payload_width(payload)) * B * N * k
            w = [t for wb in layers for t in wb]
            return (nbytes(combined, seg_ends, budgets, payload, out, *w), ops,
                    mlp_flops(layers, B * N * k))
        return nbytes(combined, seg_ends, budgets, *out), ops + 3.0 * B * N * k
    if name == "pn2mid":
        return pn2mid_work(*args[:3], out)
    if name == "fps":
        xyz, npoint, _, P = args
        B, N, _ = xyz.shape
        return nbytes(xyz, out), 10.0 * B * npoint * N / P
    if name == "setconv":
        xyz, feats, new_xyz, radius, K, layers = args
        B = xyz.shape[0]
        S = new_xyz.shape[1]
        scanned = scanned_keys(new_xyz, xyz, [radius], [K])
        w = [t for wb in layers for t in wb]
        # the ball scan and a max a slot channel; the MLP over every slot on
        # the tensor cores, counted apart
        ops = 9.0 * scanned + B * S * K * layers[-1][0].shape[0]
        return nbytes(xyz, feats, new_xyz, out, *w), ops, mlp_flops(layers, B * S * K)
    if name == "flowenc":
        xyz, feats, c1, l1, l2, s2, r1, k1, r2, k2 = args
        B, S1 = c1.shape[:2]
        f1, f2, c2 = out
        w = [t for wb in list(l1) + list(l2) for t in wb]
        # two ball scans, a max a slot channel and the FPS of set_conv2's
        # centres (10 operations a point a pick); the MLPs over every slot on
        # the tensor cores, counted apart
        ops = (9.0 * (scanned_keys(c1, xyz, [r1], [k1]) + scanned_keys(c2, c1, [r2], [k2]))
               + B * S1 * k1 * f1.shape[-1] + B * s2 * k2 * f2.shape[-1] + 10.0 * B * s2 * S1)
        tensor = mlp_flops(l1, B * S1 * k1) + mlp_flops(l2, B * s2 * k2)
        return nbytes(xyz, feats, c1, f1, f2, c2, *w), ops, tensor
    if name == "flowmid":
        from pci_tpu_torch.ops import index_points
        from pci_tpu_torch.ops.cuda_kernels.fps_cuda import fps_plain

        pa1, fa1, pa2, fa2, pb2, fb2, groups, s3, s4, k_fe, r3, ns3, r4, ns4, k_up = args
        B, N1 = pa1.shape[:2]
        N2 = pa2.shape[1]
        fe, sc3, sc4, su1, su2a, su2b, su3a, su3b = groups
        start = torch.zeros(1, dtype=torch.long, device=pa2.device)
        x3 = index_points(pa2, fps_plain(pa2, s3, start, 1))
        x4 = index_points(x3, fps_plain(x3, s4, start, 1))
        w = [t for g in groups for wb in g for t in wb]
        # the in-kernel FPS, then each stage as work() counts kNN-conv (8
        # operations a query-key pair) and set-conv (the ball scans)
        # (the MLPs on the tensor cores, counted apart)
        ops = (10.0 * B * (s3 * N2 + s4 * s3) + 8.0 * B * N2 * N2
               + 9.0 * scanned_keys(x3, pa2, [r3], [ns3]) + 9.0 * scanned_keys(x4, x3, [r4], [ns4])
               + 8.0 * B * s3 * s4 + 8.0 * B * N2 * s3 + 8.0 * B * N1 * N2)
        tensor = (mlp_flops(fe, B * N2 * k_fe) + mlp_flops(sc3, B * s3 * ns3)
                  + mlp_flops(sc4, B * s4 * ns4) + mlp_flops(su1, B * s3)
                  + mlp_flops(su2a, B * N2 * k_up) + mlp_flops(su2b, B * N2)
                  + mlp_flops(su3a, B * N1 * k_up) + mlp_flops(su3b, B * N1))
        return nbytes(pa1, fa1, pa2, fa2, pb2, fb2, out, *w), ops, tensor
    if name == "fusion_tail":
        combined, resi, extra, layers = args
        B, N, k, _ = resi.shape
        w = [t for wb in layers for t in wb]
        # the score MLP a slot on the tensor cores (counted apart), then the
        # norm, max, exp and weighted sums
        return nbytes(combined, resi, extra, out, *w), 12.0 * B * N * k, mlp_flops(layers, B * N * k)
    if name == "knnconv":
        q_xyz, k_xyz, k_feats, q_feats, skip, k, mlp1, mlp2 = args[:8]
        interp = kw.get("interp", False)
        B, S, _ = q_xyz.shape
        N = k_xyz.shape[1]
        w = [t for wb in list(mlp1) + list(mlp2) for t in wb]
        # the distances (8 operations a pair), then the interp weights and
        # sums (2 a slot channel) or the max over slots (1 a slot channel);
        # the MLPs on the tensor cores, counted apart
        D = k_feats.shape[-1]
        c1 = q_feats.shape[-1] if q_feats is not None else 0
        cm = mlp1[-1][0].shape[0] if mlp1 else 3 + D + c1
        ops = 8.0 * B * S * N + (2.0 * B * S * k * D if interp else 1.0 * B * S * k * cm)
        tensor = mlp_flops(mlp1, B * S * k) + mlp_flops(mlp2, B * S)
        return (nbytes(q_xyz, k_xyz, k_feats, q_feats, skip, out, *w), ops) \
            + ((tensor,) if tensor else ())
    if name == "ball":
        radii, ks, xyz, new_xyz = args
        # 8 flops a distance and one compare a scale, per key scanned
        ops = (8.0 + len(ks)) * scanned_keys(new_xyz, xyz, radii, ks)
        return nbytes(xyz, new_xyz, *out), ops
    if name == "knn_cells":
        from pci_tpu_torch.ops.cuda_kernels.knn_cuda import CELLS_CHUNK, knn_cells_plan

        # 8 operations a pair the pruned scan must touch; the bytes of the
        # inputs, the outputs and the torch prep's plan
        query, points = args[:2]
        plan = {id(t): t for t in knn_cells_plan(query, points, query is points)}
        pairs = knn_cells_pairs(query, points, out[0][..., -1], CELLS_CHUNK)
        resi = 3.0 * out[2].shape[:-1].numel() if len(out) > 2 else 0.0  # the residuals
        return nbytes(query, points, *out, *plan.values()), 8.0 * pairs + resi
    if name == "knn_cells_multi":
        return multi_work(*args, out)
    if name in ("knn", "nearest"):
        query, points, k = args[:3]
        B, S, _ = query.shape
        valid = args[3] if len(args) > 3 and args[3] is not None else None
        keys = float(valid.clamp(max=points.shape[1]).sum()) if valid is not None \
            else B * points.shape[1]
        return nbytes(query, points, valid, *out), 8.0 * S * keys
    if name == "fusion_resi":
        combined, seg_ends, budgets, k = args
        B, N, _ = combined.shape
        # every (row, key) distance, then a subtraction a slot coordinate
        return nbytes(combined, seg_ends, budgets, *out), 8.0 * B * N * N + 3.0 * B * N * k
    if name == "attention_bwd":
        q, g, delta, tail, gout = args
        B, N, d = q.shape
        R = B * N * g.shape[2]
        w = [t for wb in tail for t in wb]
        # the recomputed forward, then six [R, d] x [d, d] products (three
        # for the inputs' gradients, three for the weights') and the 3-wide
        # ones, the dense products on the tensor cores, counted apart; ~20
        # elementwise operations a (row, channel)
        tensor = 2.0 * R * (3 * d + 3 * d * d) + 2.0 * R * (6 * d * d + 6 * d)
        return nbytes(q, g, delta, gout, *w, *out), 20.0 * R * d, tensor
    if name == "attention":
        q, g, delta, tail = args
        B, N, d = q.shape
        k = g.shape[2]
        w = [t for wb in tail for t in wb]
        # four dense layers a slot (on the tensor cores, counted apart),
        # then q - K + pos, V + pos, the softmax and the weighted sum: about
        # 8 operations a (slot, channel)
        tensor = 2.0 * B * N * k * (3 * d + 3 * d * d)
        return nbytes(q, g, delta, out, *w), 8.0 * B * N * k * d, tensor
    combined, seg_ends, budgets, layers, k = args
    B, N, _ = combined.shape
    w = [t for wb in layers for t in wb]
    payload = kw.get("payload")
    # the distances, the softmax and sums, a payload's sums (a multiply-add a
    # slot and channel); the score MLP on the tensor cores
    ops = 8.0 * B * N * N + (6.0 + 2.0 * payload_width(payload)) * B * N * k
    return (nbytes(combined, seg_ends, budgets, payload, out, *w), ops,
            mlp_flops(layers, B * N * k))


def payload_width(payload) -> int:
    """The channels of a one-shot fusion call's payload (0 for none)."""
    return 0 if payload is None else payload.shape[-1]


def bound_terms(nb: float, ops: float, tensor: float = 0.0):
    """(bytes term, operations term) in ms: bytes over HBM_BYTES_PER_S;
    scalar operations over FP32_FLOPS plus, for a tensor-core kernel, its
    dense products at 3 x FLOP over TF32_FLOPS (the split's three
    products)."""
    return nb / HBM_BYTES_PER_S * 1e3, (ops / FP32_FLOPS + 3.0 * tensor / TF32_FLOPS) * 1e3


def label(name, args, kw) -> str:
    if name == "fps":
        return f"B={args[0].shape[0]} N={args[0].shape[1]} npoint={args[1]} P={args[3]}"
    if name == "setconv":
        return (f"B={args[0].shape[0]} N={args[0].shape[1]} S={args[2].shape[1]} K={args[4]} "
                f"C_in={3 + args[1].shape[-1]}")
    if name == "knnconv":
        interp = kw.get("interp", False)
        mode = f" interp {kw.get('recip', 'clamp')} D={args[2].shape[-1]}" if interp else ""
        tail = f" n_final={kw['n_final']}" if kw.get("n_final") else ""
        return f"B={args[0].shape[0]} S={args[0].shape[1]} N={args[1].shape[1]} k={args[5]}{mode}{tail}"
    if name == "flowenc":
        return f"B={args[0].shape[0]} N={args[0].shape[1]} S1={args[2].shape[1]} S2={args[5]}"
    if name == "flowmid":
        return f"B={args[0].shape[0]} N1={args[0].shape[1]} N2={args[2].shape[1]}"
    if name == "fusion_tail":
        ce = args[2].shape[-1] if args[2] is not None else 0
        return f"B={args[1].shape[0]} N={args[1].shape[1]} k={args[1].shape[2]} Ce={ce}"
    if name == "ball":
        return f"N={args[2].shape[1]} S={args[3].shape[1]} r={list(args[0])} K={list(args[1])}"
    if name in ("knn", "knn_cells", "nearest"):
        valid = f" valid_n={args[3].tolist()}" if len(args) > 3 and args[3] is not None else ""
        return f"B={args[0].shape[0]} S={args[0].shape[1]} N={args[1].shape[1]} k={args[2]}{valid}"
    if name in ("attention", "attention_bwd"):
        return f"B={args[0].shape[0]} N={args[0].shape[1]} k={args[1].shape[2]} d={args[0].shape[2]}"
    if name in ("fusion_resi", "knn_cells_multi"):
        return f"B={args[0].shape[0]} N={args[0].shape[1]} k={args[3]} ends={args[1].tolist()} " \
               f"budgets={args[2].tolist()}"
    if name == "fusion_cells":
        mode = "one-shot" if len(args) == 5 else "residual"
        cp = f" Cp={payload_width(kw.get('payload'))}" if len(args) == 5 else ""
        return f"{mode} N={args[0].shape[1]} k={args[-1]} budgets={args[2].tolist()}{cp}"
    if name == "pn2mid":
        return f"B={args[0].shape[0]} N1={args[0].shape[1]} C1={args[1].shape[-1]}"
    return (f"N={args[0].shape[1]} k={args[4]} budgets={args[2].tolist()} "
            f"Cp={payload_width(kw.get('payload'))}")


def relu_gates(q, g, delta, tail, rel: float = 1e-6, chunk: int = 4096):
    """``[M]`` bool: the queries of the attention tail with a hidden
    pre-activation (either ReLU, any slot and channel) within ``rel`` of
    its layer's largest magnitude of 0, where two summation orders can
    round the gate apart; the plain forward in chunks of queries."""
    lin = torch.nn.functional.linear
    (wd0, bd0), (wd1, bd1), (wg0, bg0), _ = tail
    d = q.shape[-1]
    qf, gf, df = q.reshape(-1, d), g.reshape(q.shape[0] * q.shape[1], -1, 2 * d), \
        delta.reshape(q.shape[0] * q.shape[1], -1, 3)
    mins, top = [], [0.0, 0.0]
    with torch.no_grad():
        for s in range(0, qf.shape[0], chunk):
            pre1 = lin(df[s:s + chunk], wd0, bd0)
            pos = lin(torch.relu(pre1), wd1, bd1)
            pre2 = lin(qf[s:s + chunk, None, :] - gf[s:s + chunk, :, :d] + pos, wg0, bg0)
            mins.append(torch.stack([pre1.abs().amin(dim=(1, 2)), pre2.abs().amin(dim=(1, 2))]))
            top = [max(top[0], pre1.abs().max().item()), max(top[1], pre2.abs().max().item())]
    m = torch.cat(mins, 1)
    return (m[0] < rel * top[0]) | (m[1] < rel * top[1])


def compare_attention_bwd(got, want, args, where: str) -> float:
    """dq, dg, ddelta within 1e-4 of their largest magnitude, on the
    queries whose ReLU gates no rounding can flip (a flipped gate is a
    jump in the derivative, not a rounding error: a query has 2 k d
    pre-activations, so 1-2% of them hold one within 1e-6 of the largest;
    they are counted, at most 5% of the queries); the eight weight and bias gradients within 1e-3 of their
    layer's largest weight or bias gradient (each sums ~2M (query, slot)
    rows, in blocks on the card and in chunks in the plain version; the
    last bias's gradient is zero in exact arithmetic, the softmax over k
    cancelling it, so its own magnitude is rounding noise)."""
    q = args[0]
    M = q.shape[0] * q.shape[1]
    gate = relu_gates(*args[:4])
    keep = ~gate
    check(int(gate.sum()) <= 0.05 * M, f"attention_bwd {where}: {int(gate.sum())} of {M} "
                                       f"queries at a ReLU gate")
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if i < 3:
            e = (g.reshape(M, -1)[keep] - w.reshape(M, -1)[keep]).abs().max().item()
            tol = 1e-4 * w.abs().max().item()
        else:
            e = (g - w).abs().max().item()
            layer = want[3 + 2 * ((i - 3) // 2):5 + 2 * ((i - 3) // 2)]
            tol = 1e-3 * max(t.abs().max().item() for t in layer)
        check(e <= tol, f"attention_bwd {where}: output {i} max |kernel - plain| {e} > {tol}")
        err = max(err, e)
    print(f"attention_bwd {where}: {int(gate.sum())} of {M} queries at a ReLU gate left out "
          f"of dq/dg/ddelta; max |kernel - plain| over all queries "
          f"{max((g - w).abs().max().item() for g, w in zip(got[:3], want[:3])):.3g}")
    return err


def compare(name, got, want, where: str, args=(), kw=None) -> float:
    """Hold a kernel's result against its plain version's; returns the
    max abs error (0 for exact index results).  ``args`` / ``kw``: the
    call's, where a hold needs them (the attention backward's inputs, a
    one-shot fusion's payload held against the call in fp64)."""
    if name == "fps":
        check(torch.equal(got, want), f"fps {where}: indices differ")
        return 0.0
    if name == "ball":
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"ball {where}: indices differ")
        return 0.0
    if name in ("knn", "knn_cells", "nearest"):
        check(torch.equal(got[1], want[1]), f"{name} {where}: indices differ")
        check(torch.equal(got[0], want[0]), f"{name} {where}: distances not bit-equal")
        if len(got) > 2:  # emit_resi
            check(torch.equal(got[2], want[2]), f"{name} {where}: residuals not bit-equal")
        return 0.0
    if name in ("fusion_resi", "fusion_cells", "knn_cells_multi") and isinstance(got, tuple):
        check(torch.equal(got[0], want[0]), f"{name} {where}: indices differ")
        check(torch.equal(got[1], want[1]), f"{name} {where}: residuals not bit-equal")
        return 0.0
    if name == "pn2mid":
        err, top = (got - want).abs().max().item(), want.abs().max().item()
        print(f"pn2mid {where}: max |kernel - plain| {err:.3g}, {err / top:.3g} of the "
              f"output's largest magnitude {top:.4g}")
        check(err <= 1e-3 * top, f"pn2mid {where}: max |kernel - plain| {err} > 1e-3 x {top}")
        return err
    if name == "attention_bwd":
        return compare_attention_bwd(got, want, args, where)
    if name == "flowenc":
        check(torch.equal(got[2], want[2]), f"flowenc {where}: set_conv2's centres differ")
        return max(compare("setconv", g, w, where) for g, w in zip(got[:2], want[:2]))
    if name in ("fusion", "fusion_cells") and got.shape[-1] > 3 and args:
        # a payload's channels, its weighted sums alone, against the call in
        # fp64 at every k, beside the plain fp32 and 1xTF32 controls (the
        # seeded holds pass no args and hold them within TAIL_SUM_LIMIT)
        call = dict(zip(("combined", "seg_ends", "budgets", "layers", "k", "payload"), args),
                    **(kw or {}))
        e_k, e_32, e_tf = payload_sum_errors(got, **call)
        print(f"{name} {where}: payload channels max |kernel - fp64| {e_k:.3g} (<= "
              f"{PAYLOAD_LIMIT:g}), |plain fp32 - fp64| {e_32:.3g}, |plain 1xTF32 - fp64| "
              f"{e_tf:.3g}")
        check(e_k <= PAYLOAD_LIMIT and e_k < e_tf,
              f"{name} {where}: payload channels {e_k} from fp64 (limit {PAYLOAD_LIMIT}, one "
              f"TF32 product {e_tf})")
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, atol=1e-4, rtol=1e-4)
    check(ok, f"{name} {where}: max |kernel - plain| {err}")
    return err


def fusion_fp64(combined, seg_ends, budgets, layers, k, payload=None) -> torch.Tensor:
    """A one-shot fusion call in fp64 on the plain version's neighbours:
    ``[B, N, 3 + Cp]``."""
    from pci_tpu_torch.ops import index_points
    from pci_tpu_torch.ops.cuda_kernels import _build
    from pci_tpu_torch.ops.cuda_kernels.fusion_knn_cuda import fusion_head, fusion_resi_plain

    layers64 = [(w.double(), b.double()) for w, b in layers]
    with torch.inference_mode():
        idx, resi = fusion_resi_plain(combined, seg_ends, budgets, k)
        extra = None if payload is None else index_points(payload, idx).double()
        return fusion_head(combined.double(), resi.double(),
                           lambda h: _build.mlp_plain(h, layers64), extra)


def cdist_topk(query, points, k, chunk: int = 2048):
    """``torch.topk(torch.cdist(q, p), k, largest=False)`` over chunks of
    queries (the whole [S, N] matrix of a 65,536-point cloud is 17 GB)."""
    return [torch.topk(torch.cdist(query[:, s:s + chunk], points), k, largest=False)
            for s in range(0, query.shape[1], chunk)]


def library_call(name, args):
    """One PyTorch call computing the kernel's function on the same
    inputs, where there is one (timed only; the port never uses it):
    ``torch.cdist(...).argmin`` for the nearest neighbour over all keys,
    ``torch.topk(torch.cdist(...), k, largest=False)`` for the kNN over all
    keys, and for the residual fusion kNNs (flat and cell-pruned) the same
    per segment (chunked over queries; the flat one batched over B at each
    segment's largest budget, or row by row where the rows' segments
    differ)."""
    valid = len(args) > 3 and args[3] is not None
    if name == "nearest" and args[2] == 1 and not valid:
        query, points = args[0], args[1]
        return lambda: torch.cdist(query, points).argmin(-1)
    if name in ("knn", "knn_cells") and not valid:
        query, points, k = args[:3]
        return lambda: cdist_topk(query, points, k)
    if name in ("fusion_resi", "knn_cells_multi"):
        combined, seg_ends, budgets, k = args
        ends = seg_ends.tolist()
        # segment s spans [ends[s-1], ends[s]); its budget capped as the kernel caps it
        caps, used = [], torch.zeros(budgets.shape[0], dtype=torch.long)
        for s in range(budgets.shape[1]):
            cap = torch.minimum(budgets[:, s].cpu().long(), k - used)
            caps.append(cap)
            used += cap
        if all(e == ends[0] for e in ends):  # one batched call a segment
            rows = [(slice(None), ends[0], [int(c.max()) for c in caps])]
        else:  # segments that differ by row: a call a row and segment
            rows = [(slice(b, b + 1), ends[b], [int(c[b]) for c in caps])
                    for b in range(len(ends))]
        segs = [(r, lo, hi, c) for r, e, cs in rows for lo, hi, c in zip([0] + e[:-1], e, cs)
                if c > 0]
        return lambda: [cdist_topk(combined[r], combined[r, lo:hi], c) for r, lo, hi, c in segs]
    if name == "fusion_cells" and len(args) == 4:
        combined, seg_ends, budgets, k = args
        n1, k1 = int(seg_ends[0, 0]), min(int(budgets[0, 0]), k)
        if combined.shape[0] != 1 or not 0 < k1 < k:
            return None
        return lambda: (cdist_topk(combined, combined[:, :n1], k1),
                        cdist_topk(combined, combined[:, n1:], k - k1))
    return None


def new_totals():
    return {n: {"ms": 0.0, "plain_ms": 0.0, "err": 0.0, "bytes_ms": 0.0,
                "ops_ms": 0.0, "library_ms": None, "rel": 0.0} for n in KERNEL_INFO}


def hold_kernels(calls, request: int, expected: dict, totals: dict, path: str,
                 unit: str = "request"):
    """Each recorded call: kernel vs plain on the card, timed; the first
    ``request`` calls are one request's (or step's) launches.  Prints the
    path's sums a request and adds them to ``totals`` (every path's)."""
    from pci_tpu_torch.ops.cuda_kernels import plain_versions

    own = new_totals()
    counts = dispatch_counts(calls[:request])
    check(counts == expected, f"{path} dispatches {counts} a {unit}, expected {expected}")
    with torch.inference_mode():
        for i, (name, fn, args, kw) in enumerate(calls):
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            with plain_versions():
                want = fn(*args, **kw)
            torch.cuda.synchronize()
            err = compare(name, got, want, label(name, args, kw), args, kw)
            rel = 0.0
            if name in TENSOR_KERNELS and not isinstance(got, tuple) or name in (
                    "flowenc", "attention_bwd"):  # flowenc: relative to f_1's and f_2's largest
                outs = {"flowenc": want[:2], "attention_bwd": want[:3]}.get(name, [want])
                top = max(w.abs().max().item() for w in outs)
                rel = err / max(top, 1e-30)
            ms = cuda_ms(lambda: fn(*args, **kw), 10)
            with plain_versions():
                plain_ms = cuda_ms(lambda: fn(*args, **kw), 3)
            lib = library_call(name, args)
            lib_ms = cuda_ms(lib, 3) if lib is not None else None
            nb, ops, *tensor = work(name, args, kw, got)
            bytes_ms, ops_ms = bound_terms(nb, ops, *tensor)
            basis = "bytes" if bytes_ms > ops_ms else ("ops, tensor" if tensor else "operations")
            # the bound of rows 7 and 11-13 before their products moved to
            # the tensor cores: every operation at FP32_FLOPS
            scalar = (f" scalar_bound_ms={max(bytes_ms, (ops + sum(tensor)) / FP32_FLOPS * 1e3):.6f}"
                      if name in SCALAR_BOUND_KERNELS else "")
            print(f"kernel {name:9s} {label(name, args, kw):52s} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={max(bytes_ms, ops_ms):.6f} "
                  f"({basis}){scalar} max_abs_err={err:.3g}"
                  + (f" rel_err={rel:.3g}" if name in TENSOR_KERNELS else "")
                  + (f" library_ms={lib_ms:.4f}" if lib_ms is not None else ""))
            t = own[call_launches((name, fn, args, kw))[0]]
            t["err"] = max(t["err"], err)
            t["rel"] = max(t["rel"], rel)
            if i < request:  # one request's worth of launches
                t["ms"] += ms
                t["plain_ms"] += plain_ms
                t["bytes_ms"] += bytes_ms
                t["ops_ms"] += ops_ms
                if lib_ms is not None:
                    t["library_ms"] = (t["library_ms"] or 0.0) + lib_ms
    for name in KERNEL_INFO:
        for key, val in own[name].items():
            if key in ("err", "rel"):
                totals[name][key] = max(totals[name][key], val)
            elif key == "library_ms":
                if val is not None:
                    totals[name][key] = (totals[name][key] or 0.0) + val
            else:
                totals[name][key] += val
        if counts[name]:
            t = own[name]
            lib = f", library {t['library_ms']:.4f} ms" if t["library_ms"] is not None else ""
            print(f"{path} kernel {name}: {counts[name]} launches a {unit}, "
                  f"{t['ms']:.4f} ms a {unit} (plain {t['plain_ms']:.4f} ms, bound "
                  f"{max(t['bytes_ms'], t['ops_ms']):.6f} ms by "
                  f"{'bytes' if t['bytes_ms'] > t['ops_ms'] else 'operations'}{lib}), "
                  f"max_abs_err {t['err']:.3g}")


# FPS at every shape its paths give it, and its edge cases: (B, N, npoint,
# P, start, cloud); start "random" draws one a batch row, "last" is N - 1
# (clamped to a shorter chain's end); cloud "dups" has 10% exact duplicates
FPS_HOLDS = (
    (1, 16384, 1024, 8, "zero", "gauss"), (8, 16384, 1024, 8, "zero", "gauss"),
    (1, 32768, 1024, 8, "zero", "gauss"), (1, 65536, 1024, 8, "zero", "gauss"),
    (1, 1024, 256, 1, "zero", "gauss"), (1, 256, 64, 1, "zero", "gauss"),
    (1, 64, 16, 1, "zero", "gauss"), (2, 1024, 256, 1, "zero", "gauss"),
    (2, 16000, 1024, 8, "random", "gauss"), (2, 64000, 1024, 8, "random", "gauss"),
    (1, 16384, 1024, 1, "zero", "gauss"), (1, 16383, 1024, 8, "last", "gauss"),
    (2, 16384, 1024, 8, "random", "dups"), (1, 1000, 256, 1, "random", "dups"),
    # the long-chain route (over 16,384 points a chain): ops.fps exact at
    # 32,768 points, and exact=False (P = 8) at 131,073
    (1, 32768, 1024, 1, "random", "gauss"), (1, 131073, 1024, 8, "random", "gauss"),
    # fusion_sampling="fps": every point ordered (npoint = N, exact), the
    # chain ending on picks at distance 0 among the duplicates
    (1, 16384, 16384, 1, "zero", "dups"), (1, 65536, 65536, 1, "random", "dups"),
)


def hold_fps(card: str) -> None:
    """The FPS kernel against its plain version at FPS_HOLDS: picks equal;
    each shape's time a launch (CUDA events, and device time) and a greedy
    iteration (device ms / (npoint / P))."""
    from pci_tpu_torch.ops.cuda_kernels.fps_cuda import CHAIN_MAX, fps_kernel, fps_plain

    dev = torch.device("cuda")
    for B, N, npoint, P, start_kind, cloud in FPS_HOLDS:
        pairs = [dup_pair(B * N + i, N)[1] if cloud == "dups" else synthetic_pair(B * N + i, N)[0]
                 for i in range(B)]
        xyz = torch.from_numpy(np.stack(pairs)).to(dev)
        g = torch.Generator().manual_seed(N)
        start = {"zero": torch.zeros(B), "last": torch.full((B,), N - 1),
                 "random": torch.randint(0, N, (B,), generator=g)}[start_kind]
        start = start.to(dev, torch.int32)  # as the kernel reads it: no cast in its time
        with torch.inference_mode():
            got = fps_kernel(xyz, npoint, start, P)
            want = fps_plain(xyz, npoint, start, P)
            ms = cuda_ms(lambda: fps_kernel(xyz, npoint, start, P), 10)
            dev_ms = device_ms(lambda: fps_kernel(xyz, npoint, start, P))
        what = (f"B={B} N={N} npoint={npoint} P={P} start={start_kind} cloud={cloud}"
                + (" (long chain)" if -(-N // P) > CHAIN_MAX else ""))
        check(torch.equal(got, want), f"fps {what}: picks differ from the plain version's")
        print(f"fps hold {what}: picks equal to the plain version's; {ms:.4f} ms (CUDA "
              f"events), device {dev_ms:.4f} ms, {1e3 * dev_ms / (npoint // P):.3f} us an "
              f"iteration on {card}")


def one_cell_cloud(n: int, seed: int) -> np.ndarray:
    """``[n, 3]``: 90% of the points in one cell of the 1024^3 Morton grid
    (a 1e-4 m cube in a 1 m cloud), a third of those exact duplicates."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, 3))
    m = 9 * n // 10
    x[:m] = 0.5 + 1e-4 * rng.random((m, 3))
    x[m // 3:2 * m // 3] = x[:m // 3]
    return x[rng.permutation(n)].astype(np.float32)


# the kNN routes' crossing: (B, S, N, k), self clouds where S is None
KNN_CROSSING = ((1, None, 1024, 16), (1, None, 2048, 16), (1, None, 4096, 16),
                (1, None, 16384, 16), (1, None, 65536, 16), (2, 64000, 1024, 3),
                (2, 64000, 4096, 3), (2, 64000, 16384, 3), (2, 64000, 65536, 3))


def hold_knn_cells(card: str) -> None:
    """The box-pruned kNN against the plain version, indices and distances
    equal: a cloud almost all in one Morton cell, with duplicates (self),
    a cross cloud (S != N), and the KNN_CROSSING shapes (seeded LiDAR-like
    clouds), where its whole call (prep included) is timed beside the flat
    kernel's with the route `knn_cuda.cells_route_ok` takes."""
    from pci_tpu_torch.ops.cuda_kernels.knn_cuda import (
        cells_route_ok, knn_cells_kernel, knn_kernel, knn_plain)

    dev = torch.device("cuda")
    x = torch.from_numpy(one_cell_cloud(16384, 3))[None].to(dev)
    q = torch.from_numpy(synthetic_pair(4, 5000)[0])[None].to(dev)
    keys = torch.from_numpy(synthetic_pair(5, 20000)[0])[None].to(dev)
    cases = [("one Morton cell, duplicates, 16,384", x, x, 16),
             ("cross 5,000 x 20,000", q, keys, 16)]
    for B, S, N, k in KNN_CROSSING:
        pts = torch.from_numpy(np.stack([synthetic_pair(N + b, N)[0] for b in range(B)])).to(dev)
        qry = pts if S is None else torch.from_numpy(
            np.stack([synthetic_pair(S + b, S)[1] for b in range(B)])).to(dev)
        cases.append((f"crossing B={B} S={qry.shape[1]} N={N}", qry, pts, k))
    for what, query, points, k in cases:
        want = knn_plain(query, points, k)
        with torch.inference_mode():
            got = knn_cells_kernel(query, points, k)
            ms = cuda_ms(lambda: knn_cells_kernel(query, points, k), 10)
            flat = cuda_ms(lambda: knn_kernel(query, points, k), 5)
        check(torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]),
              f"knn_cells {what}: differs from the plain version")
        route = "pruned" if cells_route_ok(query, points, k) else "flat"
        print(f"knn_cells hold {what} k={k}: indices and distances equal to the plain "
              f"version's; pruned {ms:.4f} ms (prep included), flat {flat:.4f} ms (CUDA "
              f"events), the route takes the {route} kernel, on {card}")


def hold_knn_routes(card: str) -> None:
    """ops.knn's route by shape on the card (pci_tpu.ops.knn's: a kernel
    for xyz clouds with k <= 128, XLA otherwise): 4-channel clouds take
    the plain version and launch nothing; k = 96 on xyz clouds takes the
    flat kernel's local-memory list.  Both against knn_plain, indices and
    distances equal."""
    from pci_tpu_torch.ops import knn
    from pci_tpu_torch.ops.cuda_kernels.knn_cuda import knn_kernel, knn_plain

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(11)
    cases = (("C=4", torch.randn(1, 3000, 4, generator=g), torch.randn(1, 6000, 4, generator=g),
              16, 0),
             ("k=96", torch.from_numpy(synthetic_pair(6, 4096)[0])[None],
              torch.from_numpy(synthetic_pair(7, 8192)[0])[None], 96, 1))
    for what, qc, pc, k, launches in cases:
        query, points = qc.to(dev), pc.to(dev)
        before = knn_kernel.launches
        with torch.inference_mode():
            got = knn(query, points, k)
            torch.cuda.synchronize()
            ran = knn_kernel.launches - before
            ms = cuda_ms(lambda: knn(query, points, k), 5)
        want = knn_plain(query, points, k)
        check(ran == launches, f"knn {what}: {ran} kernel launches, expected {launches}")
        check(torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]),
              f"knn {what}: differs from the plain version")
        print(f"knn route hold {what} S={query.shape[1]} N={points.shape[1]} k={k}: "
              f"{'the flat kernel' if launches else 'the plain version (no launch)'}, indices "
              f"and distances equal to knn_plain's; {ms:.4f} ms (CUDA events) on {card}")


# the nearest-neighbour kernel's holds beyond a training step's calls: (what,
# B, S, N, valid_n or None, cloud): the eval windows' chamfer shapes; a key
# count that is no multiple of a rank's range with a prefix ending inside
# the last range; prefixes of 0 and past N; "dups", a cloud of 1,024 points
# repeated 8 times (every distance tied across the ranges) with queries on
# some of its points
NEAREST_HOLDS = (("eval isapci", 1, 16000, 16000, None, "pair"),
                 ("eval pointinet", 1, 16384, 16384, None, "pair"),
                 ("cluster edge", 2, 5000, 16001, (15300, 16001), "pair"),
                 ("prefix 0 and past N", 2, 700, 1500, (0, 4000), "pair"),
                 ("duplicates", 1, 3000, 8192, None, "dups"))


def nearest_cloud(B: int, S: int, N: int, cloud: str, seed: int, dev):
    """Seeded queries [B, S, 3] and keys [B, N, 3] for NEAREST_HOLDS."""
    if cloud == "pair":
        q = np.stack([synthetic_pair(seed + b, S)[0] for b in range(B)])
        k = np.stack([synthetic_pair(seed + 100 + b, N)[1] for b in range(B)])
    else:
        rng = np.random.default_rng(seed)
        base = (rng.standard_normal((B, N // 8, 3)) * 10).astype(np.float32)
        k = np.concatenate([base] * 8, axis=1)
        q = (base[:, rng.integers(0, N // 8, S)]
             + (rng.random((B, S, 1)) < 0.5) * rng.standard_normal((B, S, 3)) * 0.3)
    return (torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev) for x in (q, k))


def hold_nearest(card: str) -> None:
    """The k = 1 kernel (csrc/knn.cu nearest_kernel) against knn_plain at
    NEAREST_HOLDS, through ops.knn's route: indices and distances equal;
    each case's launch, the cluster size and CTAs, and its time."""
    from pci_tpu_torch.ops import knn
    from pci_tpu_torch.ops.cuda_kernels.knn_cuda import knn_plain, nearest_launches, nearest_shape

    dev = torch.device("cuda")
    for i, (what, B, S, N, valid, cloud) in enumerate(NEAREST_HOLDS):
        query, points = nearest_cloud(B, S, N, cloud, 1500 + 10 * i, dev)
        vn = torch.tensor(valid, device=dev) if valid is not None else None
        before = nearest_launches.launches
        with torch.inference_mode():
            got = knn(query, points, 1, vn)
            torch.cuda.synchronize()
            ran = nearest_launches.launches - before
            ms = cuda_ms(lambda: knn(query, points, 1, vn), 10)
        want = knn_plain(query, points, 1, vn)
        check(ran == 1, f"nearest hold {what}: {ran} launches of the k = 1 kernel")
        check(torch.equal(got[1], want[1]), f"nearest hold {what}: indices differ")
        check(torch.equal(got[0], want[0]), f"nearest hold {what}: distances not bit-equal")
        C, ctas, _ = nearest_shape(B, N, S)
        print(f"nearest hold {what} B={B} S={S} N={N}"
              + (f" valid_n={list(valid)}" if valid is not None else "")
              + f": indices and distances equal to knn_plain's; C={C}, {ctas} CTAs; "
              f"{ms:.4f} ms (CUDA events) on {card}")


# the attention tail's holds beyond the paths' shapes: (B, N, k, Ce); N
# ragged against the grid's warps, k <= 16 (one 16-slot tile), payloads of
# 1, 2 and 5 channels
FUSION_TAIL_HOLDS = ((1, 1001, 7, 0), (2, 3000, 16, 2), (1, 5000, 32, 1), (1, 777, 20, 5))
# the weighted sums' error against fp64 that the 3xTF32 head must keep
# within, at FUSION_TAIL_HOLDS with combined = 0 (unit-normal residuals):
# on an H100 the kernel read 1.24e-7 to 1.76e-7 there, the plain version in
# fp32 1.27e-7 to 1.86e-7 and with one TF32 product a layer 1.2e-4 to 3.2e-4
TAIL_SUM_LIMIT = 1e-6


def seeded_score_mlp(g: torch.Generator, dev) -> list:
    """A seeded fusion score MLP (4 -> 64 -> 64 -> 128) at the init scale
    of a Dense layer, BatchNorm-free, on ``dev``."""
    layers = []
    for cin, cout in zip((4, 64, 64), (64, 64, 128)):
        s = cin ** -0.5
        layers.append(((torch.rand(cout, cin, generator=g) * 2 - 1) * s,
                       (torch.rand(cout, generator=g) * 2 - 1) * s))
    return [(w.to(dev), b.to(dev)) for w, b in layers]


def tail_sum_errors(resi, extra, layers) -> tuple:
    """The weighted sums alone (``combined`` = 0, so no rounding of the
    sum into ``combined`` hides them) against fp64: the max abs error of
    the kernel, of the plain version in fp32 and of the plain version with
    one TF32 product a layer (cuBLAS with TF32 allowed)."""
    from pci_tpu_torch.ops.cuda_kernels import _build
    from pci_tpu_torch.ops.cuda_kernels.fusion_knn_cuda import fusion_head
    from pci_tpu_torch.ops.cuda_kernels.fusion_tail_cuda import fusion_tail_kernel, fusion_tail_plain

    zero = torch.zeros(resi.shape[:2] + (3,), device=resi.device)
    layers64 = [(w.double(), b.double()) for w, b in layers]
    with torch.inference_mode():
        ref = fusion_head(zero.double(), resi.double(),
                          lambda h: _build.mlp_plain(h, layers64),
                          None if extra is None else extra.double())
        got = fusion_tail_kernel(zero, resi, extra, layers)
        fp32 = fusion_tail_plain(zero, resi, extra, layers)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = fusion_tail_plain(zero, resi, extra, layers)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    return tuple((t.double() - ref).abs().max().item() for t in (got, fp32, tf32))


def hold_fusion_tail(card: str) -> None:
    """The attention tail against fusion_tail_plain at FUSION_TAIL_HOLDS
    (seeded residuals and a seeded score MLP at the init scale of a Dense
    layer, BatchNorm-free): within the kernel holds' 1e-4.  Then its
    weighted sums alone against fp64, within TAIL_SUM_LIMIT and below a
    single TF32 product's error on the same inputs, which the 1e-4 hold of
    rows near 10-40 m cannot tell from 3xTF32."""
    from pci_tpu_torch.ops.cuda_kernels.fusion_tail_cuda import fusion_tail_kernel, fusion_tail_plain

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1600)
    layers = seeded_score_mlp(g, dev)
    for B, N, k, Ce in FUSION_TAIL_HOLDS:
        combined = (torch.randn(B, N, 3, generator=g) * 10).to(dev)
        resi = torch.randn(B, N, k, 3, generator=g).to(dev)
        resi[:, ::7, k // 2:] = 0.0  # unfilled slots: zero residuals, still active
        extra = torch.randn(B, N, k, Ce, generator=g).to(dev) if Ce else None
        with torch.inference_mode():
            got = fusion_tail_kernel(combined, resi, extra, layers)
            torch.cuda.synchronize()
            want = fusion_tail_plain(combined, resi, extra, layers)
        err = compare("fusion_tail", got, want, f"hold B={B} N={N} k={k} Ce={Ce}")
        print(f"fusion_tail hold B={B} N={N} k={k} Ce={Ce}: max |kernel - plain| {err:.3g} "
              f"(<= 1e-4) on {card}")
        e_k, e_32, e_tf = tail_sum_errors(resi, extra, layers)
        print(f"fusion_tail hold B={B} N={N} k={k} Ce={Ce}: weighted sums vs fp64: kernel "
              f"{e_k:.3g} (<= {TAIL_SUM_LIMIT:g}), plain fp32 {e_32:.3g}, plain 1xTF32 "
              f"{e_tf:.3g} on {card}")
        check(e_k <= TAIL_SUM_LIMIT and e_k < e_tf,
              f"fusion_tail hold B={B} N={N} k={k} Ce={Ce}: weighted sums {e_k} from fp64 "
              f"(limit {TAIL_SUM_LIMIT}, one TF32 product {e_tf})")

# the one-shot kernels with a payload (rows 4 and 12; the intensity of
# PointsFusionWithFeatures): (kernel, N, Cp, t), k = 32; t gives the
# fusion's own budgets (nn.fusion._adaptive_budgets), a tuple (N1, k1, k2) a
# segment shorter than its budget (its unfilled slots carry the row's own
# payload)
FUSION_PAYLOAD_HOLDS = (("fusion", 16384, 1, 0.5), ("fusion", 16384, 1, 0.2),
                        ("fusion", 3000, 0, 0.5), ("fusion", 3000, 2, 0.3),
                        ("fusion", 5000, 5, 0.7), ("fusion", 2048, 1, (10, 20, 12)),
                        ("fusion_cells", 65536, 1, 0.5), ("fusion_cells", 32768, 1, 0.5))
# a payload channel (intensity in [0, 1]) of a model's one-shot call against
# the call in fp64 (compare(); PERF.md, the k <= 128 findings, says why 1e-5)
PAYLOAD_LIMIT = 1e-5


def payload_sum_errors(got, combined, seg_ends, budgets, layers, k, payload) -> tuple:
    """A one-shot kernel's payload channels, its weighted payload sums alone
    (no cloud value enters them), against fp64 on the same neighbours and
    residuals: the max abs error of the kernel, of the plain version in
    fp32 and of the plain version with one TF32 product a layer (cuBLAS
    with TF32 allowed)."""
    from pci_tpu_torch.ops.cuda_kernels.fusion_knn_cuda import fusion_plain

    ref = fusion_fp64(combined, seg_ends, budgets, layers, k, payload)[..., 3:]
    with torch.inference_mode():
        fp32 = fusion_plain(combined, seg_ends, budgets, layers, k, payload)[..., 3:]
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = fusion_plain(combined, seg_ends, budgets, layers, k, payload)[..., 3:]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    return tuple((t.double() - ref).abs().max().item() for t in (got[..., 3:], fp32, tf32))


def hold_fusion_payload(card: str) -> None:
    """Rows 4 and 12 with a payload at FUSION_PAYLOAD_HOLDS, on a seeded
    cloud (sigma 10 m) with a seeded payload in [0, 1] and a seeded score
    MLP at the init scale (hold_fusion_tail's; phase 10 holds both kernels
    with the trained one): against the plain version, the xyz within the
    kernel holds' 1e-4; the payload channels against fp64 within
    TAIL_SUM_LIMIT and below a single TF32 product's error;
    row 12 against row 4 on the same cloud and payload within 1e-6 m (the
    same head on the same neighbours).  Then both kernels' resources with
    the payload."""
    from pci_tpu_torch.nn.fusion import _adaptive_budgets
    from pci_tpu_torch.ops.cuda_kernels import fusion_cells_cuda as FC
    from pci_tpu_torch.ops.cuda_kernels import fusion_knn_cuda as F
    from pci_tpu_torch.ops.cuda_kernels._build import kernel_attrs

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1500)
    layers = seeded_score_mlp(g, dev)
    k = 32
    for name, N, Cp, t in FUSION_PAYLOAD_HOLDS:
        combined = (torch.randn(1, N, 3, generator=g) * 10).to(dev)
        payload = torch.rand(1, N, Cp, generator=g).to(dev) if Cp else None
        if isinstance(t, tuple):
            seg_ends, budgets = torch.tensor([[t[0], N]]), torch.tensor([t[1:]])
        else:
            N1, _, k1, k2 = _adaptive_budgets(N, k, torch.tensor([t]))
            seg_ends = torch.stack([N1, torch.full_like(N1, N)], 1)
            budgets = torch.stack([k1, k2], 1)
        where = (f"{name} payload hold N={N} Cp={Cp} N1={int(seg_ends[0, 0])} "
                 f"budgets={budgets.tolist()}")
        with torch.inference_mode():
            if name == "fusion":
                got = F.fusion_kernel(combined, seg_ends, budgets, layers, k, payload)
            else:
                got = FC.fusion_cells_kernel(combined, seg_ends, budgets, k, layers,
                                             payload=payload)
            torch.cuda.synchronize()
            want = F.fusion_plain(combined, seg_ends, budgets, layers, k, payload)
        check(got.shape == (1, N, 3 + Cp), f"{where}: rows {tuple(got.shape)}")
        e_xyz = (got[..., :3] - want[..., :3]).abs().max().item()
        line, checks = f"{where}: max |kernel - plain| xyz {e_xyz:.3g} (<= 1e-4)", []
        if Cp:
            e_pay = (got[..., 3:] - want[..., 3:]).abs().max().item()
            e_k, e_32, e_tf = payload_sum_errors(got, combined, seg_ends, budgets, layers, k,
                                                 payload)
            line += (f", payload {e_pay:.3g}; payload sums vs fp64: "
                     f"kernel {e_k:.3g} (<= {TAIL_SUM_LIMIT:g}), plain fp32 {e_32:.3g}, plain "
                     f"1xTF32 {e_tf:.3g}")
            checks.append((e_k <= TAIL_SUM_LIMIT and e_k < e_tf,
                           f"{where}: payload sums {e_k} from fp64 (limit {TAIL_SUM_LIMIT}, one "
                           f"TF32 product {e_tf})"))
        if name == "fusion_cells":
            with torch.inference_mode():
                flat = F.fusion_kernel(combined, seg_ends, budgets, layers, k, payload)
                torch.cuda.synchronize()
            e_flat = (got - flat).abs().max().item()
            line += f"; against the flat one-shot kernel {e_flat:.3g} (<= 1e-6)"
            checks.append((e_flat <= 1e-6, f"{where}: rows differ from the flat one-shot "
                                           "kernel's"))
        print(line + f" on {card}", flush=True)
        compare(name, got, want, where)
        for ok, msg in checks:
            check(ok, msg)
    for kname, entry in (("fusion", "pci_fusion_payload_attrs"),
                         ("fusion_cells", "pci_fusion_cells_payload_attrs")):
        print(f"kernel resources {kname} with a payload: {resources_text(kernel_attrs(entry))}")


def resources_text(at: dict) -> str:
    """A kernel's resources (``_build.kernel_attrs``) as the `kernel
    resources` lines print them."""
    return (f"{at['registers']} registers a thread, {at['static_smem']} static + "
            f"{at['dynamic_smem']} dynamic shared bytes a block, {at['blocks_per_sm']} blocks "
            f"of {at['threads']} threads ({at['blocks_per_sm'] * at['threads'] // 32} warps) an "
            f"SM, {at['local_bytes']} local bytes a thread")


def fusion_payload_stages_line(name, args, card: str, path: str, payload=None) -> None:
    """The `stages fusion_payload` line of a recorded one-shot fusion call
    (row 4, ``fusion``, or row 12, ``fusion_cells``, its prep included):
    the call by CUDA events (median of 20) and its device time
    (torch.profiler, 20 calls) without a payload and, where this tree's
    kernel takes one, with ``payload`` (a seeded one-channel payload in [0,
    1] when None) on the same cloud, so the same neighbours."""
    import inspect

    from pci_tpu_torch.ops.cuda_kernels import fusion_cells_cuda as FC
    from pci_tpu_torch.ops.cuda_kernels import fusion_knn_cuda as F

    combined, seg_ends, budgets, layers, k = args[:5]
    combined = combined.float().contiguous()
    kern = F.fusion_kernel if name == "fusion" else FC.fusion_cells_kernel
    takes = "payload" in inspect.signature(kern).parameters
    if payload is None:
        payload = torch.rand(*combined.shape[:2], 1, generator=torch.Generator().manual_seed(7))
    parts = []
    for pay in (None, payload.to(combined.device).float().contiguous()) if takes else (None,):
        kw = {} if pay is None else {"payload": pay}
        if name == "fusion":
            call = lambda kw=kw: F.fusion_kernel(combined, seg_ends, budgets, layers, k, **kw)  # noqa: E731
        else:
            call = lambda kw=kw: FC.fusion_cells_kernel(combined, seg_ends, budgets, k, layers, **kw)  # noqa: E731
        with torch.inference_mode():
            parts.append(f"Cp={payload_width(pay)} {cuda_ms(call, 20):.4f} ms (CUDA events), "
                         f"device {device_ms(call, 20):.4f} ms")
    print(f"stages fusion_payload {path} {name} N={combined.shape[1]} k={k} "
          f"budgets={budgets.tolist()} on {card}: " + "; ".join(parts)
          + ("" if takes else "; no payload in this kernel"))


def nearest_stages_line(args, card: str, path: str) -> None:
    """The `stages nearest` line of a recorded k = 1 kNN: the call by CUDA
    events and device time (torch.profiler); for this tree's kernel also
    its span from the CTAs' %globaltimer stamps (the last end less the
    first start, median of 5 launches), the cluster size, the grid's CTAs
    an SM and the resident limit at its registers, and the share of the
    pairs that the three-FMA mark sent to the exact test (a range's first
    block, whose limit is still infinite, among them).  An older tree's
    kernel prints its times only."""
    from pci_tpu_torch.ops.cuda_kernels import knn_cuda as K
    from pci_tpu_torch.ops.cuda_kernels._build import kernel_attrs

    query, points = (t.detach().float().contiguous() for t in args[:2])
    valid = args[3] if len(args) > 3 else None
    with torch.inference_mode():
        call = lambda: K.knn_kernel(query, points, 1, valid)  # noqa: E731
        head = (f"stages nearest {path} {label('nearest', args, {})} on {card}: call "
                f"{cuda_ms(call, 20):.4f} ms (CUDA events), device {device_ms(call, 20):.4f} ms")
        if not hasattr(K, "nearest_kernel"):
            print(head + "; no stamps in this kernel")
            return
        B, N = points.shape[:2]
        S = query.shape[1]
        C, ctas, sms = K.nearest_shape(B, N, S)
        marked = torch.zeros(1, dtype=torch.int64, device=points.device)
        spans = []
        for _ in range(5):
            stamps = torch.zeros((ctas, 2), dtype=torch.int64, device=points.device)
            marked.zero_()
            K.nearest_kernel(query, points, valid, marked, stamps)
            torch.cuda.synchronize()
            t = stamps.cpu()
            spans.append(float(t[:, 1].max() - t[:, 0].min()) * 1e-6)
    at = kernel_attrs("pci_nearest_attrs")
    keys = float(valid.clamp(max=N).sum()) if valid is not None else float(B * N)
    print(head + f"; stamped span {statistics.median(spans):.4f} ms (median of 5); C={C}, "
          f"{ctas} CTAs of {at['threads'] // 32} warps ({ctas / sms:.2f} an SM; "
          f"{at['blocks_per_sm']} resident an SM at {at['registers']} registers); pairs "
          f"marked and measured exactly {int(marked.item())} of {S * keys:.0f} "
          f"({marked.item() / (S * keys):.5f})")


def fusion_tail_stages_line(args, card: str, path: str) -> None:
    """The `stages fusion_tail` line of a recorded attention tail: the call
    by CUDA events and device time (torch.profiler, 20 launches)."""
    from pci_tpu_torch.ops.cuda_kernels.fusion_tail_cuda import fusion_tail_kernel

    args = [None if t is None else t.float().contiguous() for t in args[:3]] + [args[3]]
    with torch.inference_mode():
        call = lambda: fusion_tail_kernel(*args)  # noqa: E731
        print(f"stages fusion_tail {path} {label('fusion_tail', args, {})} on {card}: call "
              f"{cuda_ms(call, 20):.4f} ms (CUDA events), device {device_ms(call, 20):.4f} ms")


# the attention tail's holds beyond the paths' shapes: (B, N, k, d, backward
# too); the forward's scalar route at k = 32 and at d = 128
ATTENTION_HOLDS = ((1, 1000, 7, 40, False), (1, 1000, 7, 24, True), (1, 1000, 16, 64, True),
                   (1, 1000, 32, 64, True), (1, 1000, 16, 128, False),
                   # the wide tensor-core forward and the wide backward (ISAPCInet's
                   # widths 96 and 128) at ragged N, a k below 16, and the
                   # scalar route at k = 32 and d = 128
                   (1, 1001, 16, 96, True), (1, 997, 16, 128, True), (2, 515, 11, 72, True),
                   (1, 1000, 32, 128, False))


def attention_inputs(B: int, N: int, k: int, d: int, seed: int, dev):
    """Seeded inputs of the attention tail: q, g, delta, the four layers at
    nn.Linear's init scale, gout."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape, s=1.0: (s * torch.randn(*shape, generator=g)).to(dev)  # noqa: E731
    tail = [(r(d, 3, s=3 ** -0.5), r(d, s=0.1)), (r(d, d, s=d ** -0.5), r(d, s=0.1)),
            (r(d, d, s=d ** -0.5), r(d, s=0.1)), (r(d, d, s=d ** -0.5), r(d, s=0.1))]
    return r(B, N, d), r(B, N, k, 2 * d), r(B, N, k, 3, s=0.3), tail, r(B, N, d)


def attention_route(d: int, k: int) -> str:
    """The forward route csrc/attention.cu takes at (d, k)."""
    from pci_tpu_torch.ops.cuda_kernels.attention_cuda import tc_route_ok

    if not tc_route_ok(d, k):
        return "scalar"
    return "tensor cores, per warp" if d <= 64 else "tensor cores, block-wide"


def hold_attention(card: str) -> None:
    """The attention kernels against their plain versions at ATTENTION_HOLDS
    (ragged N, k < 16, d not a multiple of 16, the block-wide forward and
    the wide backward at d = 72, 96 and 128, and the forward's scalar
    route), the forward within 1e-4 (compare), the backward by
    compare_attention_bwd and bit-equal on a second run; each timed beside
    its plain version."""
    from pci_tpu_torch.ops.cuda_kernels.attention_cuda import (
        attention_bwd_kernel, attention_bwd_plain, attention_kernel, attention_plain)

    dev = torch.device("cuda")
    for i, (B, N, k, d, bwd) in enumerate(ATTENTION_HOLDS):
        q, g, delta, tail, gout = attention_inputs(B, N, k, d, 20 + i, dev)
        where = f"B={B} N={N} k={k} d={d}"
        route = attention_route(d, k)
        with torch.inference_mode():
            got = attention_kernel(q, g, delta, tail)
            torch.cuda.synchronize()
            err = compare("attention", got, attention_plain(q, g, delta, tail), where)
            ms = cuda_ms(lambda: attention_kernel(q, g, delta, tail), 10)
            plain_ms = cuda_ms(lambda: attention_plain(q, g, delta, tail), 3)
        print(f"attention hold {where} ({route} route): max |kernel - plain| {err:.3g}; "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events) on {card}")
        if not bwd:
            continue
        args = (q, g, delta, tail, gout)
        with torch.inference_mode():
            got = attention_bwd_kernel(*args)
            torch.cuda.synchronize()
            err = compare_attention_bwd(got, attention_bwd_plain(*args), args, where)
            again = attention_bwd_kernel(*args)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"attention_bwd {where}: a second run gives other bits")
            ms = cuda_ms(lambda: attention_bwd_kernel(*args), 10)
            plain_ms = cuda_ms(lambda: attention_bwd_plain(*args), 3)
        print(f"attention_bwd hold {where}: max |kernel - plain| {err:.3g}, a second run "
              f"bit-equal; {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events) on {card}")


# TransformerLayer shapes outside the attention kernels (d_points, d_model,
# mode): d_model 20 (not a multiple of 8) and 256 (past both kernels' 128)
# at eval and in training
ATTENTION_ROUTE_HOLDS = ((64, 20, "eval"), (64, 256, "eval"), (64, 256, "train"))
# the variants' attention shapes (queries, k, d, path): the served noT_96
# request's 65,536 flow vectors at d = 96 and field 1's 32,768 at d = 128,
# and the field-1 training step's 64,000 (batch 2) at d = 128
ATTENTION_WIDTHS = ((65536, 16, 96, "noT_96 request"), (32768, 16, 128, "field 1 request"),
                    (64000, 16, 128, "field 1 step"))


def attention_widths(card: str) -> None:
    """The attention tail at ATTENTION_WIDTHS on the route this tree takes
    there: the forward kernel (its route named) and the backward kernel
    where the tree's bwd_route_ok takes it, each held against its plain
    version (the forward within 1e-4, the backward by
    compare_attention_bwd, its output gradient zeroed at the queries at a
    ReLU gate) and timed (CUDA events, median of 5, and queued_ms; in a
    long process torch.profiler read these kernels as 0 ms) beside the
    plain versions and each kernel's bound
    (work, bound_terms).  Loaded by path from an older tree's root it times
    that tree's routes (the parent's: the scalar forward, the plain
    backward)."""
    from pci_tpu_torch.ops.cuda_kernels.attention_cuda import (
        attention_bwd_kernel, attention_bwd_plain, attention_kernel, attention_plain,
        bwd_route_ok, kernel_route_ok, tc_route_ok)

    dev = torch.device("cuda")
    for i, (n, k, d, path) in enumerate(ATTENTION_WIDTHS):
        q, g, delta, tail, gout = attention_inputs(1, n, k, d, 40 + i, dev)
        where = f"{path} N={n} k={k} d={d}"
        fwd_args, bwd_args = (q, g, delta, tail), (q, g, delta, tail, gout)
        with torch.inference_mode():
            plain_ms = cuda_ms(lambda: attention_plain(*fwd_args), 5)
            line = f"attention widths {where} on {card}: forward plain {plain_ms:.4f} ms"
            if kernel_route_ok(d, k):
                route = ("tensor cores" if tc_route_ok(d, k) else "scalar") + (
                    ", block-wide" if tc_route_ok(d, k) and d > 64 else "")
                err = compare("attention", attention_kernel(*fwd_args),
                              attention_plain(*fwd_args), where)
                ms = cuda_ms(lambda: attention_kernel(*fwd_args), 5)
                qms = queued_ms(lambda: attention_kernel(*fwd_args))
                bound = max(bound_terms(*work("attention", fwd_args, {}, q)))
                line += (f", kernel ({route}) {ms:.4f} ms, queued {qms:.4f} ms, bound "
                         f"{bound:.4f} ms, max |kernel - plain| {err:.3g}")
            if "step" in path:
                # a ReLU gate that rounding flips moves a weight gradient by a
                # whole row's product (O(1e-2) of 20 here, at 1M rows): the
                # gated queries get no output gradient, so no row of theirs
                # enters any gradient, in either version
                gout[relu_gates(q, g, delta, tail).view(1, n)] = 0.0
                bplain_ms = cuda_ms(lambda: attention_bwd_plain(*bwd_args), 3)
                line += f"; backward plain {bplain_ms:.4f} ms"
                if bwd_route_ok(d, k):
                    got = attention_bwd_kernel(*bwd_args)
                    err = compare_attention_bwd(got, attention_bwd_plain(*bwd_args), bwd_args,
                                                where)
                    again = attention_bwd_kernel(*bwd_args)
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"attention_bwd {where}: a second run gives other bits")
                    del got, again
                    ms = cuda_ms(lambda: attention_bwd_kernel(*bwd_args), 5)
                    qms = queued_ms(lambda: attention_bwd_kernel(*bwd_args), 5)
                    bound = max(bound_terms(*work("attention_bwd", bwd_args, {}, (
                        q, g, delta, *[t for wb in tail for t in wb]))))
                    line += (f", kernel {ms:.4f} ms, queued {qms:.4f} ms, bound {bound:.4f} "
                             f"ms, max |kernel - plain| {err:.3g}, a second run bit-equal")
                else:
                    line += " (this tree's route: the plain backward)"
        print(line)
        if tc_route_ok(d, k) and bwd_route_ok(d, k) and "step" in path:
            attention_stages_line(bwd_args, card, f"widths {path}")
        del q, g, delta, tail, gout
        torch.cuda.empty_cache()


def hold_attention_routes(card: str) -> None:
    """TransformerLayer (k = 16, 4,096 points, seeded weights) at
    ATTENTION_ROUTE_HOLDS on the card: the attention tail takes its plain
    version by shape before any launch (training: both directions decided
    at the forward), so neither attention kernel launches; the rows (and in
    training every gradient) against the same call through the plain
    versions, within 1e-5 of their largest magnitude (the kNN's
    index_points backward adds by atomics)."""
    from pci_tpu_torch.nn import TransformerLayer
    from pci_tpu_torch.ops.cuda_kernels import launch_counts, plain_versions, reset_launch_counts
    from pci_tpu_torch.serving import init_weights

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1660)
    for d_points, d_model, mode in ATTENTION_ROUTE_HOLDS:
        base = TransformerLayer(d_points, d_model, 16)
        init_weights(base, 1661)
        base = base.to(dev).train(mode == "train")
        xyz = torch.randn(1, 4096, 3, generator=g).to(dev)
        feats = torch.randn(1, 4096, d_points, generator=g).to(dev)
        G = torch.randn(1, 4096, d_points, generator=g).to(dev)
        outs, fired = [], {}
        for plain in (False, True):
            layer = copy.deepcopy(base)
            f = feats.clone().requires_grad_(mode == "train")
            reset_launch_counts()
            with plain_versions() if plain else contextlib.nullcontext():
                if mode == "eval":
                    with torch.inference_mode():
                        outs.append([layer(xyz, f)[0]])
                else:
                    out = layer(xyz, f)[0]
                    (out * G).sum().backward()
                    outs.append([out.detach(), f.grad] + [p.grad for p in layer.parameters()])
            torch.cuda.synchronize()
            if not plain:
                fired = {n: c for n, c in launch_counts().items() if c}
        where = f"attention route hold TransformerLayer({d_points}, {d_model}, 16) {mode}"
        check(not fired.get("attention") and not fired.get("attention_bwd"),
              f"{where}: launched {fired}")
        err = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                  for a, b in zip(*outs))
        check(err <= 1e-5, f"{where}: {err} of the largest magnitude from the plain route")
        print(f"{where} on {card}: launches {fired} (no attention kernel); rows"
              f"{' and gradients' if mode == 'train' else ''} within {err:.3g} of their largest "
              f"magnitude of the plain route's")


def attention_stages_line(args, card: str, path: str) -> None:
    """The `stages attention` lines: the forward's and the backward's
    %globaltimer stage split (attention_cuda.attention_stages) at a path's
    recorded shape, beside each kernel's time (CUDA events, median of 10;
    torch.profiler's device sums of these kernels came out short in some
    runs, where the stamps and the events agreed)."""
    from pci_tpu_torch.ops.cuda_kernels.attention_cuda import (
        attention_bwd_kernel, attention_kernel, attention_stages)

    q, g, delta = (t.detach().float().contiguous() for t in args[:3])
    tail = [(w.detach(), b.detach()) for w, b in args[3]]
    gout = args[4].detach().contiguous() if len(args) > 4 else torch.ones_like(q)
    with torch.inference_mode():
        st = attention_stages(q, g, delta, tail, gout)
        fwd_ms = cuda_ms(lambda: attention_kernel(q, g, delta, tail), 10)
        bwd_ms = cuda_ms(lambda: attention_bwd_kernel(q, g, delta, tail, gout), 10)
    for name, ms in (("forward", fwd_ms), ("backward", bwd_ms)):
        t = st[name]
        shares = ", ".join(f"{k} {v:.3f}" for k, v in t.items()
                           if k not in ("span_ms", "units_mean", "units_max"))
        unit = ("tiles a block" if name == "backward" or args[0].shape[-1] > 64
                else "queries a warp")
        print(f"stages attention {path} {name} {label('attention', args, {})} on {card}: "
              f"{ms:.4f} ms (CUDA events); stage shares of the summed "
              f"%globaltimer time: {shares}; longest warp/block {t['span_ms']:.4f} ms; {unit} "
              f"mean {t['units_mean']:.1f} max {t['units_max']:.0f}")


# (points, streams) of row 2's holds: a request at 16,384 and 65,536
# points, and an 8-stream call (its layers take more n-tiles a block than
# warps: the slabs' groups)
SETCONV_HOLDS = ((16384, 1), (65536, 1), (16384, STREAMS))
SETCONV_FP64_LIMIT = 1e-5  # row 2 against fp64, of the output's largest magnitude


def setconv_fp64(xyz, feats, new_xyz, radius, K, layers, tf32: bool = False):
    """A set-conv call on the plain version's slots in fp64 (``tf32``: each
    product's operands rounded to TF32 once and fp32 sums, one TF32
    product's error: the control the kernel's 3xTF32 must beat)."""
    from pci_tpu_torch.ops import index_points
    from pci_tpu_torch.ops.cuda_kernels._build import tf32_round
    from pci_tpu_torch.ops.cuda_kernels.ball_cuda import ball_plain

    (idx,) = ball_plain(xyz, new_xyz, [radius], [K], empty="first")
    h = torch.cat([index_points(xyz, idx) - new_xyz[:, :, None, :],
                   index_points(feats.float(), idx)], dim=-1)
    h = h.float() if tf32 else h.double()
    for w, b in layers:
        if tf32:
            h = torch.relu(tf32_round(h) @ tf32_round(w.float()).t() + b.float())
        else:
            h = torch.relu(h @ w.double().t() + b.double())
    return h.amax(dim=2)


def setconv_calls(n: int, streams: int = 1) -> list:
    """The first call of each of FlowNet3D's four set-conv stages in a
    PointINet call of ``streams`` streams at ``n`` points with all gates
    off (the per-stage route), recorded on the plain versions (both clouds'
    encodings come first, then each direction's set_conv3 and set_conv4)."""
    from pci_tpu_torch.ops.cuda_kernels import plain_versions
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS, Interpolator

    dev = torch.device("cuda")
    model = Interpolator.pointinet(npoints=n, weights=DEFAULT_WEIGHTS, device="cuda").model
    pairs = [synthetic_pair(seed, n) for seed in range(streams)]
    a, b = (torch.from_numpy(np.stack(x)).to(dev) for x in zip(*pairs))
    z = torch.zeros_like(a)
    calls = []
    with torch.inference_mode(), plain_versions(), record_calls(calls), gates(ALL_OFF):
        model.flow.bidirectional(a, b, z, z)
    stages = {}
    for c in calls:
        if c[0] == "setconv":
            stages.setdefault(c[2][1].shape[-1], c)  # by the stage's feature width
    return list(stages.values())


def hold_setconv(card: str, path: str = "", holds: bool = True) -> None:
    """Row 2 at FlowNet3D's four set-conv stages of one direction, at
    SETCONV_HOLDS' points and streams: against its plain version (compare's limit)
    and, its pooled rows, against the call in fp64 within
    SETCONV_FP64_LIMIT of the output's largest magnitude and below the
    1xTF32 control (``holds``); then the `stages setconv` line of each:
    the call by CUDA events (median of 10, host launch included), device
    time (torch.profiler) and host enqueue, the plan (the tile, Q centres
    a tile, C blocks a cluster, R rows a chunk, blocks) and, where the
    cluster tile runs, from its %globaltimer stamps the scan's, gather's,
    MLP's and pool's shares of the blocks' summed time, the longest and
    the mean block; then both tiles' resources.  Loaded by path from an
    older tree's root, it times that tree's kernel (``holds=False``; no
    stamps where its kernel takes none)."""
    from pci_tpu_torch.ops.cuda_kernels import setconv_cuda

    stamped = hasattr(setconv_cuda, "setconv_stages")
    for n, streams in SETCONV_HOLDS:
        for i, (_, _, args, _) in enumerate(setconv_calls(n, streams)):
            xyz, feats, new_xyz, radius, K, layers = args
            where = f"set_conv{i + 1} {label('setconv', args, {})}"
            call = lambda: setconv_cuda.setconv_kernel(*args)  # noqa: E731
            with torch.inference_mode():
                if holds:
                    got = call()
                    torch.cuda.synchronize()
                    want = setconv_cuda.setconv_plain(*args)
                    err = compare("setconv", got, want, f"hold {where}")
                    ref = setconv_fp64(*args)
                    top = ref.abs().max().item()
                    e_k = (got.double() - ref).abs().max().item() / top
                    e_32 = (want.double() - ref).abs().max().item() / top
                    e_tf = (setconv_fp64(*args, tf32=True).double() - ref).abs().max().item() / top
                    print(f"setconv hold {where} on {card}: max |kernel - plain| {err:.3g}; "
                          f"of the output's largest magnitude {top:.4g}: |kernel - fp64| "
                          f"{e_k:.3g} (<= {SETCONV_FP64_LIMIT:g}), |plain fp32 - fp64| "
                          f"{e_32:.3g}, |plain 1xTF32 - fp64| {e_tf:.3g}")
                    check(e_k <= SETCONV_FP64_LIMIT and e_k < e_tf,
                          f"setconv {where}: {e_k} of the largest magnitude from fp64 (limit "
                          f"{SETCONV_FP64_LIMIT}, one TF32 product {e_tf})")
                ev = cuda_ms(call, 10)
                dev_ms = device_ms(call)
                for _ in range(2):  # torch.profiler at times reads a whole kernel as 0 ms
                    dev_ms = dev_ms or device_ms(call)
                host = host_us(call)
            line = (f"stages setconv {path}{where} on {card}: call {ev:.4f} ms (CUDA events), "
                    f"device {dev_ms:.4f} ms, host {host:.1f} us (enqueue)")
            if not stamped:
                print(line + "; no stamps in this kernel")
                continue
            with torch.inference_mode():
                runs = [setconv_cuda.setconv_stages(*args) for _ in range(5)]
            st = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
            line += (f"; {'cluster tile' if st['cluster'] else 'ball_conv_tile'} Q={st['Q']} "
                     f"C={st['C']} R={st['R']} blocks={st['blocks']}")
            if st["cluster"]:
                line += (f": scan {st['scan']:.3f}, gather {st['gather']:.3f}, mlp "
                         f"{st['mlp']:.3f}, pool {st['pool']:.3f} of the summed block time, "
                         f"longest block {st['span_ms']:.4f} ms, mean {st['block_ms']:.4f} ms")
            print(line)
    if stamped:
        from pci_tpu_torch.ops.cuda_kernels._build import kernel_attrs

        print(f"kernel resources setconv tiles on {card}: cluster tile "
              f"{resources_text(kernel_attrs('pci_setconv_attrs'))}; ball_conv_tile "
              f"{resources_text(kernel_attrs('pci_setconv_ball_attrs'))}")


def hold_pn2mid_batch(args, card: str) -> None:
    """pn2mid_fused at a batch of 17, over the kernel's 16 samples a
    launch: the recorded request's l1 cloud and features, each sample
    shifted by a seeded offset, against pn2mid_plain (1e-3 of the output's
    largest magnitude, compare's pn2mid limit), in two launches."""
    from pci_tpu_torch.ops.cuda_kernels import pn2mid_fused
    from pci_tpu_torch.ops.cuda_kernels.pn2mid_cuda import pn2mid_kernel, pn2mid_plain

    l1x, l1f, groups = args[:3]
    B = 17
    off = torch.randn(B, 1, 3, generator=torch.Generator().manual_seed(17)).to(l1x.device)
    x = (l1x[:1] + 0.05 * off).contiguous()
    f = l1f[:1].expand(B, -1, -1).contiguous()
    before = pn2mid_kernel.launches
    with torch.inference_mode():
        got = pn2mid_fused(x, f, groups)
        torch.cuda.synchronize()
        launches = pn2mid_kernel.launches - before
        ms = cuda_ms(lambda: pn2mid_fused(x, f, groups), 5)
        want = pn2mid_plain(x, f, groups)
    check(launches == 2, f"pn2mid B={B}: {launches} launches, expected 2")
    err = compare("pn2mid", got, want, f"B={B} N1={x.shape[1]} (two launches)")
    print(f"pn2mid batch hold B={B} N1={x.shape[1]}: 2 launches, max |kernel - plain| "
          f"{err:.3g}; {ms:.4f} ms (CUDA events) on {card}")


def pn2mid_stages_line(args, card: str, path: str, reps: int = 5) -> None:
    """The `stages pn2mid` line at a recorded request's shape: the launch's
    time (CUDA events and device time), then each phase of the kernel
    (pn2mid_cuda.PHASES, each ended by a grid barrier) from the blocks'
    %globaltimer stamps, the median of ``reps`` stamped launches: the
    phase's span (the last block leaving its barrier minus the last leaving
    the one before), the busiest block's work in it (its arrival at the
    barrier minus its leaving the one before) and the blocks' mean wait at
    the barrier, and where the kernel stamps its items' parts
    (pn2mid_cuda.STAMP_PARTS), the busiest block's time in each and its
    items.  A kernel without stamps prints its times only."""
    from pci_tpu_torch.ops.cuda_kernels import pn2mid_cuda as P

    x, f = (t.float().contiguous() for t in args[:2])
    groups = args[2]
    run = lambda **kw: P.pn2mid_kernel(x, f, groups, P.S_LIST, P.RADII, P.KS, **kw)  # noqa: E731
    with torch.inference_mode():
        ms = cuda_ms(run, 10)
        dev = device_ms(run)
        phases = getattr(P, "PHASES", None)
        head = (f"stages pn2mid {path} B={x.shape[0]} N1={x.shape[1]} C1={f.shape[-1]} on "
                f"{card}: {ms:.4f} ms a launch (CUDA events), {dev:.4f} ms device time")
        if phases is None:
            print(head + "; no stamps in this kernel")
            return
        parts = getattr(P, "STAMP_PARTS", ())
        runs = []
        for _ in range(reps):
            st = torch.zeros((4096, len(phases), getattr(P, "STAMPS", 2)), dtype=torch.int64,
                             device=x.device)
            run(stamps=st)
            torch.cuda.synchronize()
            t = st.cpu().double()
            t = t[t[:, 0, 1] > 0]  # the launch's blocks
            leave = t[:, :, 1].amax(0)
            span = (leave[1:] - leave[:-1]) * 1e-6
            work = t[:, 1:, 0] - t[:, :-1, 1]
            busy = work.argmax(0)  # each phase's busiest block
            wait = (t[:, 1:, 1] - t[:, 1:, 0]).mean(0) * 1e-6
            split = t[busy, torch.arange(1, len(phases)), 2:] * 1e-3  # its parts (us), items
            runs.append((span, work.amax(0) * 1e-6, wait, split,
                         float(leave[-1] - t[:, 0, 1].min()) * 1e-6, t.shape[0]))
    med = [torch.stack([r[i] for r in runs]).median(0).values for i in range(4)]
    total = statistics.median(r[4] for r in runs)
    cells = []
    for i, name in enumerate(phases[1:]):
        cell = f"{name} {med[0][i]:.4f} ({med[1][i]:.4f}, {med[2][i]:.4f}"
        sp = med[3][i]
        if parts and sp[-1] > 0:  # the busiest block's items
            cell += "; " + " ".join(f"{p_} {v:.1f}" for p_, v in zip(parts, sp[:-1].tolist())) \
                + f" us, {sp[-1] * 1e3:.0f} items"
        cells.append(cell + ")")
    print(head + f"; {runs[0][5]} blocks; stamped span {total:.4f} ms; phase: span ms "
          "(busiest block's work, mean barrier wait[; the busiest block's parts]): "
          + ", ".join(cells))


def fusion_cells_stages_line(args, card: str, path: str, reps: int = 10) -> None:
    """The `stages fusion_cells` line at a recorded call's shape (one-shot
    when the call carries the score MLP, else residual): the call (CUDA
    events, prep included), the torch prep alone (CUDA events: from its
    CUDA graph where the wrapper has one, and eager), the kernel's device
    time, and, where the kernel takes stamps, its tiles' walk and head
    (%globaltimer stamps: each tile's start, walk end and end, the chunks
    it walked, the pairs it scanned, its list inserts and its warps' chunk
    scans lane by lane and needer by needer).  A kernel without a separate launch prints the
    call's device time less the eager prep's."""
    from pci_tpu_torch.ops.cuda_kernels import fusion_cells_cuda as F

    combined, seg_ends, budgets = args[:3]
    k = args[-1]
    layers = args[3] if len(args) == 5 else None
    mode = "one-shot" if layers is not None else "residual"
    B, N = combined.shape[:2]
    seg = torch.cat([seg_ends, budgets], 1).to(combined.device, torch.int32).contiguous()
    with torch.inference_mode():
        call = cuda_ms(lambda: F.fusion_cells_kernel(combined, seg_ends, budgets, k, layers),
                       reps)
        head = f"stages fusion_cells {path} {mode} B={B} N={N} k={k} on {card}: call " \
               f"{call:.4f} ms (prep included; CUDA events)"
        launch = getattr(F, "fusion_cells_launch", None)
        if launch is None:
            eager = cuda_ms(lambda: F.cells_plan(combined, seg[:, 0]), reps)
            whole = device_ms(lambda: F.fusion_cells_kernel(combined, seg_ends, budgets, k,
                                                            layers))
            prep_dev = device_ms(lambda: F.cells_plan(combined, seg[:, 0]))
            print(head + f", prep {eager:.4f} ms (eager; CUDA events), kernel "
                  f"{whole - prep_dev:.4f} ms (device time of the call {whole:.4f} less the "
                  f"prep's {prep_dev:.4f}); no stamps in this kernel")
            return
        prep = cuda_ms(lambda: F.kernel_plan_graphed(combined, seg[:, 0]), reps)
        eager = cuda_ms(lambda: F.kernel_plan(combined, seg[:, 0]), reps)
        plan = F.kernel_plan(combined, seg[:, 0])
        kern = device_ms(lambda: launch(combined, seg, k, plan, layers))
        stamps = torch.zeros((*plan[2].shape[:2], F.STAMPS), dtype=torch.int64,
                             device=combined.device)
        launch(combined, seg, k, plan, layers, stamps=stamps)
        torch.cuda.synchronize()
    t = stamps.reshape(-1, F.STAMPS).cpu().double()
    t = t[t[:, 0] > 0]  # tiles with a real query
    walk, tail, whole = (t[:, 1] - t[:, 0]) * 1e-6, (t[:, 2] - t[:, 1]) * 1e-6, \
        (t[:, 2] - t[:, 0]) * 1e-6
    slow = int(whole.argmax())
    print(head + f", prep {prep:.4f} ms (CUDA graph replay; eager {eager:.4f}; CUDA events), "
          f"kernel {kern:.4f} ms (device time; {float(t[:, 2].max() - t[:, 0].min()) * 1e-6:.4f}"
          f" ms first tile start to last tile end); {t.shape[0]} tiles: walk "
          f"{float(walk.sum() / whole.sum()):.3f} and {'head' if layers is not None else 'write'}"
          f" {float(tail.sum() / whole.sum()):.3f} of the summed tile time, a tile mean "
          f"{float(whole.mean()):.4f} ms max {float(whole.max()):.4f} (walk max "
          f"{float(walk.max()):.4f}), chunks walked mean {float(t[:, 3].mean()):.1f} max "
          f"{float(t[:, 3].max()):.0f} of {plan[2].shape[2]}, pairs scanned a tile mean "
          f"{float(t[:, 4].mean()):.0f}, the slowest tile's {float(t[int(whole.argmax()), 4]):.0f} "
          f"in {float(t[int(whole.argmax()), 3]):.0f} chunks, started "
          f"{float(t[int(whole.argmax()), 0] - t[:, 0].min()) * 1e-6:.4f} ms in; list inserts "
          f"a tile mean {float(t[:, 5].mean()):.0f} (slowest {float(t[slow, 5]):.0f}), warp-chunk "
          f"scans lane by lane {float(t[:, 6].mean()):.1f} ({float(t[slow, 6]):.0f}) and needer "
          f"by needer {float(t[:, 7].mean()):.1f} ({float(t[slow, 7]):.0f})")


STAGE_KINDS = ("fusion_cells", "pn2mid", "ball", "fusion_resi", "fusion_tail", "nearest",
               "fusion_payload")


# the source the row 2 slice changed, and rows 5 and 6, whose set-conv tile
# (stages.cuh:ball_conv_tile) it left as it was
PTXAS_SOURCES = ("setconv.cu", "flowenc.cu", "flowmid.cu")


def ptxas_lines(csrc: str, sources=PTXAS_SOURCES) -> None:
    """``ptxas`` lines for each kernel of ``sources`` under ``csrc`` (this
    tree's ``pci_tpu_torch/csrc``, or an older tree's unpacked by ``git
    archive``), compiled with the build's flags and ``-Xptxas -v`` into a
    temporary directory: registers, stack frame, spill stores and loads."""
    import re
    import tempfile

    from pci_tpu_torch.ops.cuda_kernels import _build

    with tempfile.TemporaryDirectory() as tmp:
        for src in sources:
            out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                                  os.path.join(csrc, src), "-o", os.path.join(tmp, "k.o")],
                                 capture_output=True, text=True, check=True).stderr
            for name, stack, stores, loads, regs in re.findall(
                    r"entry function '(\w+)'.*?(\d+) bytes stack frame, (\d+) bytes spill "
                    r"stores, (\d+) bytes spill loads.*?Used (\d+) registers", out, re.S):
                print(f"ptxas {csrc}/{src} {name}: {regs} registers, {stack} bytes stack, "
                      f"{stores} bytes spill stores, {loads} bytes spill loads")


def stages_only(kinds=STAGE_KINDS) -> None:
    """`python3 chip_smoke.py --stages`: the `stages fusion_cells` and
    `stages fusion_tail` lines of one PointINet request at 65,536 and 32,768
    points on the default route and with one-shot off (the kernels' own
    route, recorded), the `stages pn2mid` and `stages ball` lines of one
    ISAPCInet request, the `stages fusion_resi` and `stages fusion_tail`
    lines of one PointINet request and one 8-stream call with one-shot off,
    and the `stages ball`, `stages fusion_resi` and `stages nearest` lines
    of one training step, the `stages fusion_payload` lines of one
    PointINet request's one-shot fusion at 16,384 and 65,536 points; no
    holds.  ``kinds``: the lines to print (the
    phases that feed none of them are skipped).  Also loaded by path from
    an older tree's root to print the same lines for its kernels."""
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS, Interpolator

    card = card_line()
    dev = torch.device("cuda")
    for n in LARGE_N if {"fusion_cells", "fusion_tail"} & set(kinds) else ():
        model = Interpolator.pointinet(npoints=n, weights=DEFAULT_WEIGHTS, device="cuda").model
        a_np, b_np = synthetic_pair(0, n)
        a, b = (torch.from_numpy(x)[None].to(dev) for x in (a_np, b_np))
        z = torch.zeros_like(a)
        perms = tuple(torch.randperm(n, generator=torch.Generator().manual_seed(s))[None].to(dev)
                      for s in (1, 2))
        calls = []
        with torch.inference_mode(), record_calls(calls):
            model(a, b, z, z, torch.tensor([0.5], device=dev), perms=perms)
            with gates(ONESHOT_OFF):
                model(a, b, z, z, torch.tensor([0.5], device=dev), perms=perms)
        for name, _, args, _ in calls:
            if name == "fusion_cells" and "fusion_cells" in kinds:
                fusion_cells_stages_line(args, card, f"pointinet {n}")
            if name == "fusion_tail" and "fusion_tail" in kinds:
                fusion_tail_stages_line(args, card, f"pointinet {n}, one-shot off")
        del model, calls
        torch.cuda.empty_cache()
    if {"pn2mid", "ball"} & set(kinds):
        interp = Interpolator.isapci(field=FIELD, npoints=NPOINTS, weights=DEFAULT_WEIGHTS,
                                     device="cuda")
        fwd, (k0, k1), bwd, _ = synthetic_window()
        T = lambda x: torch.from_numpy(x)[None].to(dev)  # noqa: E731
        keys_t = [T(k0), T(k1)]
        z = torch.zeros_like(keys_t[0])
        perms = tuple(torch.randperm(NPOINTS, generator=torch.Generator().manual_seed(s))[None]
                      .to(dev) for s in (3, 4))
        calls = []
        with torch.inference_mode(), record_calls(calls):
            interp.model([T(x) for x in fwd], keys_t, [T(x) for x in bwd],
                         torch.tensor([0.5], device=dev), z, perms=perms)
        if "pn2mid" in kinds:
            pn2mid_stages_line(next(c[2] for c in calls if c[0] == "pn2mid"), card, "isapci")
        for _, _, args, _ in (c for c in calls if c[0] == "ball" and "ball" in kinds):
            ball_stages_line(args, card, "isapci")
        del calls, interp
    # PointINet's one-shot-off shapes: one request, one 8-stream call
    if {"fusion_resi", "fusion_tail"} & set(kinds):
        model = Interpolator.pointinet(npoints=NPOINTS, weights=DEFAULT_WEIGHTS,
                                       device="cuda").model
        pairs = [synthetic_pair(seed) for seed in range(STREAMS)]
        for B, t in ((1, [0.5]), (STREAMS, list(STREAM_T))):
            a = torch.from_numpy(np.stack([x for x, _ in pairs[:B]])).to(dev)
            b = torch.from_numpy(np.stack([y for _, y in pairs[:B]])).to(dev)
            z = torch.zeros_like(a)
            calls = []
            with torch.inference_mode(), record_calls(calls), gates(ONESHOT_OFF):
                model(a, b, z, z, torch.tensor(t, device=dev))
            path = f"pointinet B={B}, one-shot off"
            if "fusion_resi" in kinds:
                fusion_resi_stages_line(next(c[2] for c in calls if c[0] == "fusion_resi"),
                                        card, path)
            if "fusion_tail" in kinds:
                fusion_tail_stages_line(next(c[2] for c in calls if c[0] == "fusion_tail"),
                                        card, path)
        del model
    # and one training step's ball queries, residual kNN and nearest neighbours
    if {"ball", "fusion_resi", "nearest"} & set(kinds):
        calls = []
        with record_calls(calls):
            train_step_once(dev)
        for name, _, args, _ in calls:
            if name == "ball" and "ball" in kinds:
                ball_stages_line(args, card, "train")
            if name == "nearest" and "nearest" in kinds:
                nearest_stages_line(args, card, "train")
        if "fusion_resi" in kinds:
            fusion_resi_stages_line(next(c[2] for c in calls if c[0] == "fusion_resi"), card,
                                    "train")
    # rows 4 and 12 without and with a payload, on a request's own cloud
    for n in (NPOINTS, 65536) if "fusion_payload" in kinds else ():
        model = Interpolator.pointinet(npoints=n, weights=DEFAULT_WEIGHTS, device="cuda").model
        a, b = (torch.from_numpy(x)[None].to(dev) for x in synthetic_pair(0, n))
        z = torch.zeros_like(a)
        calls = []
        with torch.inference_mode(), record_calls(calls):
            model(a, b, z, z, torch.tensor([0.5], device=dev))
        name, _, args, _ = next(c for c in calls if c[0] in ("fusion", "fusion_cells"))
        fusion_payload_stages_line(name, args, card, f"pointinet {n}")
        del model, calls
        torch.cuda.empty_cache()


def train_step_once(dev) -> None:
    """One training step of phase 7's model, optimizer and batch (for the
    `stages` lines of --stages)."""
    from pci_tpu_torch.convert import load_npz_tree, load_subtrees
    from pci_tpu_torch.models import ISAPCInet
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS, init_weights
    from pci_tpu_torch.train import make_interp_train_step, make_optimizer

    model = ISAPCInet(FIELD)
    init_weights(model, 0)
    load_subtrees(model, load_npz_tree(DEFAULT_WEIGHTS))
    model = model.to(dev)
    step = make_interp_train_step(model, make_optimizer(TRAIN_LR, model, ("flow",)), ("flow",))
    step(train_batch(dev), torch.Generator(device=dev).manual_seed(7), TRAIN_MOMENTUM)


def host_us(fn, reps: int = 20) -> float:
    """Median host microseconds to enqueue one call of ``fn`` (the card
    idle before each; no synchronisation inside the timed span)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def ball_cloud(kind: str, B: int, N: int, S: int, seed: int):
    """Keys ``[B, N, 3]`` and queries ``[B, S, 3]`` for a ball hold:
    "gauss" (the queries are keys), "outliers" (2% of the keys and a
    quarter of the queries 20 sigma out, so their balls stay short of K and
    their scans become whole-range tasks), "empty" (the last query far from
    every key: N - 1 in every slot)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    if kind == "outliers":
        x[rng.random((B, N)) < 0.02] *= 20.0
    q = x[:, rng.integers(0, N, S)].copy()
    if kind == "outliers":
        q[:, : S // 4] *= 20.0
    if kind == "empty":
        q[:, -1] = 1e3
    dev = torch.device("cuda")
    return torch.from_numpy(x).to(dev), torch.from_numpy(q).to(dev)


# ball query holds beyond the served shapes: (cloud, B, N, S, radii, ks);
# N ragged against the prefix, the task range and the ring stage; S < 8;
# eight scales
BALL_HOLDS = (
    ("outliers", 1, 65536, 1024, (0.1, 0.2), (16, 32)),
    ("outliers", 2, 9000, 300, (0.05, 0.1, 0.2), (8, 16, 64)),
    ("empty", 1, 5001, 5, (0.2,), (32,)),
    ("gauss", 2, 4099, 7, (0.3, 0.5), (16, 32)),
    ("gauss", 1, 1000, 37, (0.2, 0.4), (16, 32)),
    ("outliers", 1, 20000, 100, (0.02, 0.04, 0.06, 0.08, 0.1, 0.15, 0.2, 0.3),
     (4, 8, 8, 16, 16, 32, 32, 64)),
)


def hold_ball(card: str) -> None:
    """The ball kernel against its plain version at BALL_HOLDS: indices
    equal; the queries whose scan passes the prefix, those that never fill,
    the empty rows, and the time a call (CUDA events)."""
    from pci_tpu_torch.ops.cuda_kernels.ball_cuda import PREFIX, ball_kernel, ball_plain

    for i, (kind, B, N, S, radii, ks) in enumerate(BALL_HOLDS):
        xyz, q = ball_cloud(kind, B, N, S, 1300 + i)
        with torch.inference_mode():
            got = ball_kernel(xyz, q, radii, ks)
            torch.cuda.synchronize()
            want = ball_plain(xyz, q, radii, ks, empty="last")
            ms = cuda_ms(lambda: ball_kernel(xyz, q, radii, ks), 10)
            stop = ball_stop(q, xyz, radii, ks)
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"ball hold {kind} B={B} N={N} S={S}: indices differ")
        empty = int(sum((w == N - 1).all(-1).sum().item() for w in want))
        print(f"ball hold {kind} B={B} N={N} S={S} r={list(radii)} K={list(ks)}: indices equal "
              f"to the plain version's; queries whose scan passes the prefix "
              f"{int((stop > PREFIX).sum())} of {B * S} (never full {int((stop >= N).sum())}), "
              f"empty rows {empty}; {ms:.4f} ms (CUDA events) on {card}")


def ball_stages_line(args, card: str, path: str) -> None:
    """The `stages ball` line of a recorded ball query: the distribution of
    each query's stop key (ball_stop: mean, p99, max), the queries that
    never fill, the call's time by CUDA events, by device time and on the
    host (enqueue); then the queries the prefix left short of K, their
    tasks, and the prefix's and the tasks' spans from the kernel's
    %globaltimer stamps.  A tree whose kernel takes no stamps prints the
    first part only."""
    from pci_tpu_torch.ops.cuda_kernels import _build, ball_cuda

    radii, ks, xyz, q = args
    B, N = xyz.shape[:2]
    S = q.shape[1]
    call = lambda: ball_cuda.ball_query_multi(radii, ks, xyz, q)  # noqa: E731
    with torch.inference_mode():
        stop = ball_stop(q, xyz, radii, ks).float()
        ev = cuda_ms(call, 10)
        dev_ms = device_ms(call)
        host = host_us(call)
    head = (f"stages ball {path} B={B} N={N} S={S} r={list(radii)} K={list(ks)} on {card}: "
            f"stop key mean {stop.mean().item():.1f} p99 {torch.quantile(stop, 0.99).item():.0f} "
            f"max {stop.max().item():.0f} of {N}, never full {int((stop >= N).sum())} of {B * S}; "
            f"call {ev:.4f} ms (CUDA events), device {dev_ms:.4f} ms, host {host:.1f} us "
            f"(enqueue)")
    if not hasattr(ball_cuda, "scratch_ints"):
        print(head + "; no stamps in this kernel")
        return
    need = ball_cuda.scratch_ints(B, N, S, tuple(int(k) for k in ks))
    rows = _build.library().pci_ball_stamp_rows(B, S)
    with torch.inference_mode():
        scratch = torch.zeros(max(need, 2), dtype=torch.int32, device=xyz.device)
        stamps = torch.zeros((rows, ball_cuda.STAMPS), dtype=torch.int64, device=xyz.device)
        ball_cuda.ball_kernel(xyz, q, radii, ks, stamps=stamps, scratch=scratch if need else None)
        torch.cuda.synchronize()
    t = stamps.cpu().double()
    nb = -(-S // 8) * B
    pre, task = t[:nb], t[nb:]
    task = task[task[:, 0] > 0]
    line = (f"; prefix ({ball_cuda.PREFIX} keys, {nb} blocks) span "
            f"{float(pre[:, 1].max() - pre[:, 0].min()) * 1e-6:.4f} ms, a block mean "
            f"{float((pre[:, 1] - pre[:, 0]).mean()) * 1e-6:.4f} max "
            f"{float((pre[:, 1] - pre[:, 0]).max()) * 1e-6:.4f}; queries short of K after it "
            f"{int(scratch[0].item()) if need else 0}")
    if need and len(task):
        line += (f", tasks {int(task[:, 2].sum())} of {ball_cuda.RANGE} keys, merges "
                 f"{int(task[:, 3].sum())}, task span "
                 f"{float(task[:, 1].max() - task[:, 0].min()) * 1e-6:.4f} ms (the prefix's "
                 f"last block to the last task "
                 f"{float(task[:, 1].max() - pre[:, 1].max()) * 1e-6:.4f}), busiest warp "
                 f"{int(task[:, 2].max())} tasks")
    print(head + line)


def fusion_resi_case(kind: str, seed: int):
    """(combined [2, N, 3], seg_ends, budgets, k) for a residual-kNN hold:
    "f3" (three segments, PointsFusionMulti's form), "f4" (four), "short"
    (a segment with fewer keys than its budget), "wide" (a budget past 16
    in one segment), "dups" (a third of the points exact duplicates), "far"
    (the cloud 300 m from the origin, where the kernel's three-FMA mark
    cancels most)."""
    rng = np.random.default_rng(seed)
    N = {"f3": 3000, "f4": 4100, "short": 2000, "wide": 5000, "dups": 4096, "far": 4096}[kind]
    x = (rng.standard_normal((2, N, 3)) * 5).astype(np.float32)
    if kind == "dups":
        x[:, 2 * N // 3:] = x[:, rng.integers(0, 2 * N // 3, N - 2 * N // 3)]
    if kind == "far":
        x += np.float32(300.0)
    ends, buds = {
        "f3": ([[N // 3, 2 * N // 3, N], [1000, 2500, N]], [[12, 10, 10], [8, 16, 8]]),
        "f4": ([[1000, 2001, 3003, N], [500, 1500, 3000, N]], [[8, 8, 8, 8], [4, 12, 6, 10]]),
        "short": ([[10, N], [N - 5, N]], [[16, 16], [20, 12]]),
        "wide": ([[4000, N], [900, N]], [[29, 3], [4, 28]]),
        "dups": ([[2048, N], [1024, N]], [[16, 16], [24, 8]]),
        "far": ([[2048, N], [3000, N]], [[16, 16], [23, 9]]),
    }[kind]
    return torch.from_numpy(x).cuda(), torch.tensor(ends), torch.tensor(buds), 32


FUSION_RESI_HOLDS = ("f3", "f4", "short", "wide", "dups", "far")


def hold_fusion_resi(card: str) -> None:
    """The residual fusion kNN against its plain version at
    FUSION_RESI_HOLDS, its key ranges split over 1, 2 and 4 parts and by
    the kernel's own choice: indices identical, residuals bit-equal."""
    from pci_tpu_torch.ops.cuda_kernels.fusion_knn_cuda import fusion_resi_kernel, fusion_resi_plain

    for i, kind in enumerate(FUSION_RESI_HOLDS):
        combined, ends, buds, k = fusion_resi_case(kind, 1400 + i)
        with torch.inference_mode():
            want = fusion_resi_plain(combined, ends, buds, k)
            for parts in (0, 1, 2, 4):
                got = fusion_resi_kernel(combined, ends, buds, k, parts=parts)
                torch.cuda.synchronize()
                check(torch.equal(got[0], want[0]),
                      f"fusion_resi hold {kind} parts={parts}: indices differ")
                check(torch.equal(got[1], want[1]),
                      f"fusion_resi hold {kind} parts={parts}: residuals not bit-equal")
        print(f"fusion_resi hold {kind} B={combined.shape[0]} N={combined.shape[1]} k={k} "
              f"ends={ends.tolist()} budgets={buds.tolist()}: indices identical and residuals "
              f"bit-equal to the plain version's at 1, 2 and 4 parts and the kernel's choice "
              f"on {card}")


def fusion_resi_stages_line(args, card: str, path: str) -> None:
    """The `stages fusion_resi` line of a recorded residual kNN: the call
    by CUDA events and device time on the kernel's own choice of parts,
    then with its key ranges split over 1, 2 and 4 parts (each held to the
    plain version), and, from the chosen launch's per-item %globaltimer
    stamps, the scan's, the merge's and the write's shares of the summed
    item time, the items' mean and longest time, and the list inserts a
    query.  A tree whose kernel takes no parts prints the call's times
    only."""
    import inspect

    from pci_tpu_torch.ops.cuda_kernels import fusion_knn_cuda as FK

    combined, seg_ends, budgets, k = args
    B, N = combined.shape[:2]
    with torch.inference_mode():
        call = lambda: FK.fusion_resi_kernel(combined, seg_ends, budgets, k)  # noqa: E731
        head = (f"stages fusion_resi {path} B={B} N={N} k={k} budgets={budgets.tolist()} on "
                f"{card}: call {cuda_ms(call, 10):.4f} ms (CUDA events), device "
                f"{device_ms(call):.4f} ms")
        if "parts" not in inspect.signature(FK.fusion_resi_kernel).parameters:
            print(head + "; no parts or stamps in this kernel")
            return
        want = FK.fusion_resi_plain(combined, seg_ends, budgets, k)
        split = []
        for parts in (1, 2, 4):
            fn = lambda p=parts: FK.fusion_resi_kernel(combined, seg_ends, budgets, k, parts=p)  # noqa: E731
            got = fn()
            torch.cuda.synchronize()
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"fusion_resi {path} parts={parts}: differs from the plain version")
            split.append(f"{parts} {cuda_ms(fn, 10):.4f} / {device_ms(fn):.4f}")
        stamps = torch.zeros((B * -(-N // FK.RESI_ITEM), FK.RESI_STAMPS), dtype=torch.int64,
                             device=combined.device)
        FK.fusion_resi_kernel(combined, seg_ends, budgets, k, stamps=stamps)
        torch.cuda.synchronize()
    t = stamps.cpu().double()
    whole = t[:, 1] - t[:, 0]
    tot = float(whole.sum())
    print(head + " (the kernel's choice of parts); by parts, events / device ms: "
          + ", ".join(split) + f"; {t.shape[0]} items of {FK.RESI_ITEM} queries: scan "
          f"{float(t[:, 2].sum()) / tot:.3f}, merge {float(t[:, 3].sum()) / tot:.3f}, write "
          f"{float(t[:, 4].sum()) / tot:.3f} of the summed item time, an item mean "
          f"{float(whole.mean()) * 1e-6:.4f} ms max {float(whole.max()) * 1e-6:.4f}, span "
          f"{float(t[:, 1].max() - t[:, 0].min()) * 1e-6:.4f} ms; list inserts "
          f"{float(t[:, 5].sum()) / (B * N):.1f} a query")


def hold_fusion_k160(card: str) -> None:
    """PointsFusion at k = 160 on the card (the flat fusion kernels take k
    <= 128, the tail any k): at eval the kNN's plain version and one launch
    of the tail (the TPU's XLA kNN, then its tail kernel), the rows within
    the kernel holds' 1e-4 of the plain route's; in training no kernel
    launches and the rows and the gradients into both clouds are bit-equal
    to the plain route's."""
    import copy

    from pci_tpu_torch.nn import PointsFusion
    from pci_tpu_torch.ops.cuda_kernels import launch_counts, plain_versions, reset_launch_counts
    from pci_tpu_torch.serving import init_weights

    dev = torch.device("cuda")
    n, k = 4096, 160
    a_np, b_np = synthetic_pair(17, n)
    a, b = (torch.from_numpy(x)[None].to(dev) for x in (a_np, b_np))
    g = torch.Generator().manual_seed(18)
    perms = tuple(torch.randperm(n, generator=g)[None].to(dev) for _ in range(2))
    t = torch.tensor([0.3], device=dev)
    base = PointsFusion()
    init_weights(base, 19)
    base = base.to(dev)
    G = torch.randn(1, n, 3, generator=g).to(dev)
    was = torch.are_deterministic_algorithms_enabled()
    # the backward's index_add_ in one order (warn_only: the head's matmuls
    # have no cuBLAS workspace setting here, and run alike on both routes)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for mode in ("eval", "train"):
            outs = []
            for plain in (False, True):
                mod = copy.deepcopy(base).train(mode == "train")
                x1 = a.clone().requires_grad_(mode == "train")
                x2 = b.clone().requires_grad_(mode == "train")
                reset_launch_counts()
                with plain_versions() if plain else contextlib.nullcontext():
                    if mode == "eval":
                        with torch.inference_mode():
                            outs.append([mod(x1, x2, k, t, perms=perms)])
                    else:
                        out = mod(x1, x2, k, t, perms=perms)
                        (out * G).sum().backward()
                        outs.append([out.detach(), x1.grad, x2.grad])
                torch.cuda.synchronize()
                fired = {name: c for name, c in launch_counts().items() if c}
                want = {"fusion_tail": 1} if mode == "eval" and not plain else {}
                check(fired == want, f"fusion k={k} {mode}: launched {fired}, expected {want}")
            if mode == "eval":
                err = compare("fusion_tail", outs[0][0], outs[1][0], f"k={k} eval route")
                print(f"fusion k={k} eval at {n} points on {card}: one fusion_tail launch, no "
                      f"kNN launch; rows {err:.3g} from the plain route's (<= 1e-4)")
                continue
            for got, want in zip(*outs):
                check(torch.equal(got, want), f"fusion k={k} {mode}: differs from the plain route")
            print(f"fusion k={k} train at {n} points on {card}: no kernel launched; rows and "
                  f"both gradients bit-equal to the plain route's")
    finally:
        torch.use_deterministic_algorithms(was)


# rows 4, 4b and 7 past k = 32 (their k <= 64 instantiations, two slots a
# lane): (N, k, t, Cp); t gives PointsFusion's budgets
# (nn.fusion._adaptive_budgets), t near 0 and 1 a segment's budget past 32,
# a tuple (N1, k1, k2) a segment shorter than its budget; Cp a payload's
# channels for row 4 (row 7 takes them as its extra)
FUSION64_HOLDS = ((16384, 64, 0.5, 0), (16384, 48, 0.3, 0), (4096, 64, 0.02, 0),
                  (4096, 64, 0.98, 1), (2048, 64, (10, 40, 24), 0), (3000, 48, (700, 30, 18), 2),
                  (5000, 64, 0.5, 1))
# PointsFusionMulti's residual kNN (row 4b at F = 3): (N, k, w) with w
# Wnet's first two weights (nn.fusion._multi_budgets): PointINet2's usual
# split, one past 32 in a cloud, and a cloud the cumulative clamp leaves
# with 0 points and 0 slots
FUSION64_MULTI_HOLDS = ((16384, 64, (0.08, 0.09)), (16000, 48, (0.6, 0.1)),
                        (4096, 64, (0.99, 0.004)))


def fusion_sum_errors(got, combined, seg_ends, budgets, layers, k) -> tuple:
    """A one-shot kernel's weighted residual sums ``got - combined`` (on a
    cloud near the origin, where that difference rounds below 1e-7) against
    fp64 on the plain version's neighbours: the max abs error of the
    kernel, of the plain version in fp32 and of the plain version with one
    TF32 product a layer."""
    from pci_tpu_torch.ops.cuda_kernels import _build
    from pci_tpu_torch.ops.cuda_kernels.fusion_knn_cuda import fusion_head, fusion_plain, \
        fusion_resi_plain

    layers64 = [(w.double(), b.double()) for w, b in layers]
    with torch.inference_mode():
        _, resi = fusion_resi_plain(combined, seg_ends, budgets, k)
        zero = torch.zeros_like(combined, dtype=torch.float64)
        ref = fusion_head(zero, resi.double(), lambda h: _build.mlp_plain(h, layers64))
        fp32 = fusion_plain(combined, seg_ends, budgets, layers, k)[..., :3]
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = fusion_plain(combined, seg_ends, budgets, layers, k)[..., :3]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    return tuple(((t[..., :3] - combined).double() - ref).abs().max().item()
                 for t in (got, fp32, tf32))


def hold_fusion_k64(card: str) -> None:
    """Rows 4, 4b and 7 at k = 48 and 64 (their k <= 64 instantiations) at
    FUSION64_HOLDS and FUSION64_MULTI_HOLDS (hold_fusion_rows, row 4b at
    1, 2 and 4 parts and the kernel's choice).  Then the k <= 64
    instantiations' resources."""
    from pci_tpu_torch.ops.cuda_kernels._build import kernel_attrs

    hold_fusion_rows(card, "k64", FUSION64_HOLDS, FUSION64_MULTI_HOLDS, 1650, (0, 1, 2, 4))
    for kname, entry in (("fusion", "pci_fusion64_attrs"),
                         ("fusion", "pci_fusion64_payload_attrs"),
                         ("fusion_resi", "pci_fusion_resi64_attrs"),
                         ("fusion_tail", "pci_fusion_tail64_attrs")):
        print(f"kernel resources {kname} at k <= 64 ({entry}): "
              f"{resources_text(kernel_attrs(entry))}")


def hold_fusion_rows(card: str, tag: str, holds, multi_holds, seed: int, parts,
                     timed: bool = False) -> None:
    """Rows 4, 4b and 7 at ``holds`` ((N, k, t, Cp): t gives PointsFusion's
    budgets, a tuple (N1, k1, k2) a segment shorter than its budget) and
    ``multi_holds`` ((N, k, w): PointsFusionMulti's F = len(w) + 1
    segments), on seeded clouds (sigma 1 m) with hold_fusion_tail's seeded
    score MLP: row 4b's indices identical and residuals bit-equal to the
    plain version's at each of ``parts``; row 4 and row 7 (on row 4b's
    residuals, with the payload gathered by its indices as extra) within
    1e-4 of their plain versions, and their weighted sums (payload
    channels too) against fp64 within TAIL_SUM_LIMIT and below
    one TF32 product's error (row 4 on its residual sums, row 7 with
    combined = 0, the payloads' sums alone).  ``timed``: each kernel's and
    plain version's ms (CUDA events) on the hold's line."""
    from pci_tpu_torch.nn.fusion import _adaptive_budgets, _multi_budgets
    from pci_tpu_torch.ops import index_points
    from pci_tpu_torch.ops.cuda_kernels import fusion_knn_cuda as F
    from pci_tpu_torch.ops.cuda_kernels import fusion_tail_cuda as T

    from pci_tpu_torch.ops.cuda_kernels._build import PackedLayers

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    # packed once, as a module's folded layers are: no split a launch
    layers = PackedLayers(seeded_score_mlp(g, dev))
    cases = []
    for N, k, t, Cp in holds:
        if isinstance(t, tuple):
            seg_ends, budgets = torch.tensor([[t[0], N]]), torch.tensor([t[1:]])
        else:
            N1, _, k1, k2 = _adaptive_budgets(N, k, torch.tensor([t]))
            seg_ends = torch.stack([N1, torch.full_like(N1, N)], 1)
            budgets = torch.stack([k1, k2], 1)
        cases.append((N, k, seg_ends, budgets, Cp))
    for N, k, w in multi_holds:
        n_all, k_all = _multi_budgets(N, k, torch.tensor([w]))
        cases.append((N, k, torch.cumsum(n_all, 1), k_all, 0))

    def times(kernel, plain) -> str:
        return (f" ({cuda_ms(kernel, 5):.4f} ms, plain {cuda_ms(plain, 1):.4f} ms)"
                if timed else "")

    for N, k, seg_ends, budgets, Cp in cases:
        combined = torch.randn(1, N, 3, generator=g).to(dev)
        payload = torch.rand(1, N, Cp, generator=g).to(dev) if Cp else None
        where = f"N={N} k={k} ends={seg_ends.tolist()} budgets={budgets.tolist()} Cp={Cp}"
        with torch.inference_mode():
            want = F.fusion_resi_plain(combined, seg_ends, budgets, k)
            for p in parts:
                got = F.fusion_resi_kernel(combined, seg_ends, budgets, k, parts=p)
                torch.cuda.synchronize()
                check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                      f"fusion_resi {tag} hold {where} parts={p}: differs from the plain "
                      "version")
            spent = times(lambda: F.fusion_resi_kernel(combined, seg_ends, budgets, k),
                          lambda: F.fusion_resi_plain(combined, seg_ends, budgets, k))
        del got
        line = (f"fusion {tag} hold {where}: fusion_resi indices identical and residuals "
                f"bit-equal at parts {', '.join(map(str, parts))} (0: the kernel's choice)"
                + spent)
        idx, resi = want
        extra = index_points(payload, idx) if Cp else None
        with torch.inference_mode():
            got = T.fusion_tail_kernel(combined, resi, extra, layers)
            torch.cuda.synchronize()
            plain = T.fusion_tail_plain(combined, resi, extra, layers)
            spent = times(lambda: T.fusion_tail_kernel(combined, resi, extra, layers),
                          lambda: T.fusion_tail_plain(combined, resi, extra, layers))
        e = compare("fusion_tail", got, plain, f"{tag} hold {where}")
        e_k, e_32, e_tf = tail_sum_errors(resi, extra, layers)
        line += (f"; fusion_tail {e:.3g} from plain, sums vs fp64 {e_k:.3g} (plain fp32 "
                 f"{e_32:.3g}, 1xTF32 {e_tf:.3g}){spent}")
        check(e_k <= TAIL_SUM_LIMIT and e_k < e_tf,
              f"fusion_tail {tag} hold {where}: weighted sums {e_k} from fp64")
        del want, idx, resi, extra, got, plain
        if seg_ends.shape[1] == 2:
            with torch.inference_mode():
                got = F.fusion_kernel(combined, seg_ends, budgets, layers, k, payload)
                torch.cuda.synchronize()
                plain = F.fusion_plain(combined, seg_ends, budgets, layers, k, payload)
                spent = times(lambda: F.fusion_kernel(combined, seg_ends, budgets, layers, k,
                                                      payload),
                              lambda: F.fusion_plain(combined, seg_ends, budgets, layers, k,
                                                     payload))
            check(got.shape == (1, N, 3 + Cp), f"fusion {tag} hold {where}: rows "
                                               f"{tuple(got.shape)}")
            e = compare("fusion", got, plain, f"{tag} hold {where}")
            e_k, e_32, e_tf = fusion_sum_errors(got, combined, seg_ends, budgets, layers, k)
            line += (f"; fusion {e:.3g} from plain, residual sums vs fp64 {e_k:.3g} (plain fp32 "
                     f"{e_32:.3g}, 1xTF32 {e_tf:.3g}){spent}")
            check(e_k <= TAIL_SUM_LIMIT and e_k < e_tf,
                  f"fusion {tag} hold {where}: weighted sums {e_k} from fp64")
            if Cp:
                p_k, p_32, p_tf = payload_sum_errors(got, combined, seg_ends, budgets, layers, k,
                                                     payload)
                line += f", payload sums vs fp64 {p_k:.3g} (1xTF32 {p_tf:.3g})"
                check(p_k <= TAIL_SUM_LIMIT and p_k < p_tf,
                      f"fusion {tag} hold {where}: payload sums {p_k} from fp64")
            del got, plain
        torch.cuda.empty_cache()
        print(line + f" on {card}", flush=True)


def knn_walk_pairs(points, kth, chunk: int, tile: int) -> float:
    """(query, key) pairs a self kNN's tile walk touches: for each tile of
    ``tile`` Morton-sorted queries, every key of each chunk of ``chunk``
    keys whose box bound from the tile's box lies within the tile's largest
    final k-th distance (``kth [B, N]``, in the cloud's order)."""
    from pci_tpu_torch.ops.cells import box_lb, chunk_boxes, sort_by_morton

    N = points.shape[1]
    pts, perm = sort_by_morton(points, (-N) % max(chunk, tile))
    valid = perm < N
    lo, hi = chunk_boxes(pts, chunk, valid)
    qlo, qhi = chunk_boxes(pts, tile, valid)
    th = torch.where(valid, torch.gather(kth, 1, perm.clamp_max(N - 1).long()), -1.0)
    top = th.reshape(th.shape[0], -1, tile).amax(-1)  # [B, nt]
    return float((box_lb(qlo, qhi, lo, hi) <= top[..., None]).sum()) * chunk * tile


def knn_stages(calls, card: str, path: str) -> None:
    """The `stages knn` lines: for each recorded box-pruned kNN, the whole
    call (prep included) beside the flat kernel on the same input, the
    torch prep alone (CUDA events; as the route replays it from a CUDA
    graph, and eager), the kernel alone (device time), the pairs it scanned
    against all pairs, and its tiles' times, chunk walks and list inserts
    from their %globaltimer stamps, with the slowest tile run again alone
    (every other query a pad row).  For a self kNN also the pairs an exact
    scan must touch at other chunk and tile sizes: per query (every key of
    each chunk within the query's final k-th distance, knn_cells_pairs) and
    per tile walk (knn_walk_pairs)."""
    from pci_tpu_torch.ops.cuda_kernels import knn_cuda

    for name, _, args, _ in calls:
        if name != "knn_cells":
            continue
        query, points, k = args[:3]
        self_knn = query is points
        with torch.inference_mode():
            call = cuda_ms(lambda: knn_cuda.knn_cells_kernel(query, points, k), 10)
            resi_call = cuda_ms(lambda: knn_cuda.knn_cells(points, points, k, emit_resi=True),
                                10) if self_knn else None
            flat = cuda_ms(lambda: knn_cuda.knn_kernel(query, points, k), 5)
            plan = knn_cuda.knn_cells_plan(query, points, self_knn)
            prep = cuda_ms(lambda: knn_cuda.knn_cells_plan_graphed(query, points, self_knn), 10)
            eager = cuda_ms(lambda: knn_cuda.knn_cells_plan(query, points, self_knn), 10)
            kern = device_ms(lambda: knn_cuda.knn_cells_launch(query, points, k, plan))
            scanned = torch.zeros(1, dtype=torch.int64, device=points.device)
            stamps = torch.zeros((*plan[3].shape[:2], knn_cuda.STAMPS), dtype=torch.int64,
                                 device=points.device)
            dist, _ = knn_cuda.knn_cells_launch(query, points, k, plan, scanned, stamps=stamps)
            t = stamps.reshape(-1, knn_cuda.STAMPS).cpu().double()
            b, tt = divmod(int((t[:, 1] - t[:, 0]).argmax()), plan[3].shape[1])
            TQ = plan[1].shape[1] // plan[3].shape[1]
            qry = plan[1].clone()
            ids = qry[..., 3].view(torch.int32)
            keep = torch.zeros_like(ids, dtype=torch.bool)
            keep[b, tt * TQ:(tt + 1) * TQ] = True
            ids[~keep] = query.shape[1]  # a pad row: its tile stops at once
            alone = torch.zeros_like(stamps)
            knn_cuda.knn_cells_launch(query, points, k, (plan[0], qry, *plan[2:]), stamps=alone)
        tile_ms = (t[:, 1] - t[:, 0]) * 1e-6
        B, S, N = points.shape[0], query.shape[1], points.shape[1]
        span = float(t[:, 1].max() - t[:, 0].min()) * 1e-6
        slow = b * plan[3].shape[1] + tt
        seg = (f"; the segment form with emit_resi, knn_self_resi's: {resi_call:.4f} ms"
               if resi_call is not None else "")
        print(f"stages knn {path} B={B} S={S} N={N} k={k} on {card}: call {call:.4f} ms (prep "
              f"included; flat kernel {flat:.4f} ms{seg}; CUDA events), prep {prep:.4f} ms (CUDA "
              f"graph replay; eager {eager:.4f} ms; CUDA events, median of 10), kernel "
              f"{kern:.4f} ms (device time; {span:.4f} ms first tile start to last tile end "
              f"in the stamped launch), pairs scanned "
              f"{scanned.item()} of {B * S * N} ({scanned.item() / (B * S * N):.5f}); tiles "
              f"(chunks of {knn_cuda.CELLS_CHUNK}, {knn_cuda.CELLS_TILE} queries): ms mean "
              f"{tile_ms.mean():.4f} max {tile_ms.max():.4f} (that tile alone "
              f"{float(alone[b, tt, 1] - alone[b, tt, 0]) * 1e-6:.4f}), "
              f"chunks walked mean {t[:, 2].mean():.1f} max {t[:, 2].max():.0f} (slowest "
              f"{t[slow, 2]:.0f}) of {plan[3].shape[2]}, list inserts "
              f"{t[:, 3].sum() / B / S:.1f} a query")
        if not self_knn:
            continue
        kth, total = dist[..., -1], float(B * S * N)
        per_query = {c: knn_cells_pairs(points, points, kth, c) / total for c in (128, 256, 512)}
        walk = {(c, tq): knn_walk_pairs(points, kth, c, tq) / total
                for c in (128, 256, 512) for tq in (32, 64, 128)}
        print(f"stages knn {path} pairs an exact scan must touch (fractions of all pairs): per "
              f"query " + ", ".join(f"chunk {c} {f:.5f}" for c, f in per_query.items())
              + "; tile walk " + ", ".join(f"{c}/{tq} {f:.5f}" for (c, tq), f in walk.items())
              + " (chunk/tile)")


def phase_kernels(model, a, b, totals, card: str):
    """PointINet's recorded main-path calls, kernel vs plain on the card: on
    the default route, then with all gates off."""
    from pci_tpu_torch.ops.cuda_kernels import plain_versions
    from pci_tpu_torch.ops.cuda_kernels.fps_cuda import fps_index

    dev = a.device
    z = torch.zeros_like(a)
    n = a.shape[1]
    perms = tuple(torch.randperm(n, generator=torch.Generator().manual_seed(s))[None].to(dev)
                  for s in (1, 2))
    calls = []
    with torch.inference_mode(), plain_versions(), record_calls(calls):
        model(a, b, z, z, torch.tensor([0.5], device=dev), perms=perms)
        request = len(calls)
        model(a, b, z, z, torch.tensor([0.2], device=dev), perms=perms)
    calls = calls[:request] + [c for c in calls[request:] if c[0] == "fusion"]
    calls.append(("fps", fps_index, (a, 1024, torch.zeros(1, dtype=torch.long, device=dev), 1), {}))
    hold_kernels(calls, request, PER_REQUEST, totals, "pointinet")
    calls = []
    with torch.inference_mode(), plain_versions(), record_calls(calls), gates(ALL_OFF):
        model(a, b, z, z, torch.tensor([0.5], device=dev), perms=perms)
    hold_kernels(calls, len(calls), PER_REQUEST_ALL_OFF, totals, "pointinet, all gates off")
    fusion_resi_stages_line(next(c[2] for c in calls if c[0] == "fusion_resi"), card,
                            "pointinet, all gates off")
    fusion_tail_stages_line(next(c[2] for c in calls if c[0] == "fusion_tail"), card,
                            "pointinet, all gates off")
    return perms


def device_ms(fn, reps: int = 10) -> float:
    """Device milliseconds a call of ``fn``: its kernels' own time under
    torch.profiler over ``reps`` calls, after two warm-up calls (CUDA
    events around one call also count the host's time to launch it)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type != cuda}
    return sum(e.self_device_time_total for e in events
               if e.device_type == cuda and e.key not in host) / 1e3 / reps


def phase_stages(model, card: str) -> None:
    """The card's split of flowenc's and kNN-conv's time at one request's
    (B = 1) and one 8-stream call's (B = 8) shapes: flowenc's FPS chain,
    set_conv1's tiles and set_conv2's tiles from its %globaltimer stage
    stamps (flowenc_cuda.flowenc_stages), beside the ball scan alone at each
    set-conv's shape (csrc/ball.cu); the FeaturePropagation's kNN-conv whole
    and with no MLP2 (the 3-NN scan, the pooling and the [pooled | skip]
    write), the difference being its MLP chain (device time)."""
    from pci_tpu_torch.ops.cuda_kernels import (ball_query_multi, flowenc_fused,
                                                knnconv_fused)
    from pci_tpu_torch.ops.cuda_kernels.flowenc_cuda import flowenc_stages

    dev = torch.device("cuda")
    for B in (1, STREAMS):
        pairs = [synthetic_pair(seed) for seed in range(B)]
        a = torch.from_numpy(np.stack([x for x, _ in pairs])).to(dev)
        b = torch.from_numpy(np.stack([y for _, y in pairs])).to(dev)
        z = torch.zeros_like(a)
        calls = []
        with torch.inference_mode(), record_calls(calls):
            model.flow.bidirectional(a, b, z, z)
        enc = next(args for name, _, args, _ in calls if name == "flowenc")
        xyz, _, c1, _, _, s2, r1, k1, r2, k2 = enc
        with torch.inference_mode():
            runs = [flowenc_stages(*enc) for _ in range(10)]
            c2 = flowenc_fused(*enc)[2]
        med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        scan1 = device_ms(lambda: ball_query_multi([r1], [k1], xyz, c1))
        scan2 = device_ms(lambda: ball_query_multi([r2], [k2], c1, c2))
        print(f"stages flowenc B={B} on {card}: FPS chain {med['fps']:.4f} ms, set_conv1 "
              f"tiles {med['set_conv1']:.4f} ms (busiest block), stage 1 {med['stage1']:.4f} "
              f"ms, set_conv2 tiles {med['set_conv2']:.4f} ms, kernel {med['kernel']:.4f} ms "
              f"(%globaltimer stamps, median of 10 launches); the ball scan alone "
              f"(csrc/ball.cu, device time): set_conv1's {scan1:.4f} ms, set_conv2's "
              f"{scan2:.4f} ms")
        if B == 1:
            fp = next(c for c in calls if c[0] == "knnconv" and c[3].get("n_final"))
            _, fn, (q, k, kf, _, skip, kk, _, tail), kw = fp
            with torch.inference_mode():
                whole = device_ms(lambda: fn(*fp[2], **kw))
                bare = device_ms(lambda: knnconv_fused(q, k, kf, None, skip, kk, [], [],
                                                       interp=True))
            print(f"stages knnconv {label('knnconv', fp[2], kw)} on {card}: whole "
                  f"{whole:.4f} ms, 3-NN + pooling alone (no MLP2) {bare:.4f} ms, "
                  f"MLP chain {whole - bare:.4f} ms (device time, torch.profiler, "
                  f"10 launches)")


def device_share(serve, requests: int = 5, unit: str = "request"):
    """torch.profiler over a few requests (or steps): device time by
    kernel name and the share of the window the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(requests):
            serve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the device's own events (kernels, copies, fills): a CPU-side op row
    # carries the time of the kernels it launched again, and so does a
    # record_function range's device-side copy (same name as its CPU row)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type != cuda}
    rows = [(e.key, e.self_device_time_total / 1e3) for e in events
            if e.device_type == cuda and e.key not in host]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms in rows)
    if busy_ms == 0:
        print("device busy share: not measured (the profiler saw no device time)")
        return
    print(f"device busy {busy_ms / requests:.3f} ms of {wall_ms / requests:.3f} ms a "
          f"{unit} ({100 * busy_ms / wall_ms:.1f}% busy, "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% idle), top device time per {unit}:")
    for key, ms in rows[:10]:
        print(f"  {ms / requests:8.4f} ms  {key[:90]}")


def latency(serve, card: str, path: str) -> None:
    """Steady-state latency: CUDA events around 20 requests."""
    ev_ms, host_ms = [], []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        serve()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        ev_ms.append(start.elapsed_time(end))
    print(f"{path} serving latency on {card}: {statistics.median(ev_ms):.3f} ms/frame "
          f"(CUDA events, median of 20), host clock median "
          f"{statistics.median(host_ms):.3f} ms/frame")


def agreement(got, want, what: str):
    """Per-point max error of a served frame against its plain twin."""
    err = np.abs(got - want).max(axis=1)
    p999 = float(np.quantile(err, 0.999))
    print(f"{what}: max {err.max():.3g} m, p99.9 {p999:.3g} m, median "
          f"{np.median(err):.3g} m, points over 1e-3 m: {(err > 1e-3).sum()}")
    return p999, float(err.max())


def serve_counts(serve_all, expected: dict, path: str, frames_a_call: int = 1,
                 npoints: int = NPOINTS, width: int = 3):
    """Counts set to 0, five requests (calls) served, counts read: each
    kernel of the path launched its per-request count, no other kernel
    launched; every frame ``[npoints, width]`` and finite."""
    from pci_tpu_torch.ops.cuda_kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    frames = serve_all()
    counts = launch_counts()
    n_req = len(frames) // frames_a_call
    print(f"{path} serving: {n_req} calls, {len(frames)} frames, launches {counts}")
    check(len(frames) == 5 * frames_a_call, f"{len(frames)} frames served")
    check(counts == {k: v * n_req for k, v in expected.items()},
          f"{path} launch counts {counts} != {expected} x {n_req}")
    for f in frames:
        check(f.shape == (npoints, width) and np.isfinite(f).all(), f"{path}: bad frame")
    return counts


def synthetic_pair(seed: int = 0, n: int = NPOINTS):
    """Seeded synthetic ``n``-point pair (bench.py's fallback clouds)."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((n, 3)) * 10).astype(np.float32)
    b = a + 0.5 * rng.standard_normal((n, 3)).astype(np.float32)
    return a, b


def phase_streams(interp, card: str, totals: dict):
    """Stream serving, 8 streams x 16,384 points: kernels vs plain at one
    call's shapes, the fused FlowNet3D route vs the per-stage one, five
    calls with their launch counts, frames vs single requests, ms per call,
    frames/s, busy share, peak memory; then PointINet served on the routes
    with gates off, and each route's ms/frame."""
    from pci_tpu_torch.ops.cuda_kernels import plain_versions

    dev = torch.device("cuda")
    model = interp.model
    pairs = [synthetic_pair(seed) for seed in range(STREAMS)]
    a = torch.from_numpy(np.stack([x for x, _ in pairs])).to(dev)
    b = torch.from_numpy(np.stack([y for _, y in pairs])).to(dev)
    z = torch.zeros_like(a)
    t = torch.tensor(STREAM_T, device=dev)
    g = torch.Generator().manual_seed(5)
    perms = tuple(torch.stack([torch.randperm(NPOINTS, generator=g) for _ in pairs]).to(dev)
                  for _ in range(2))

    # every kernel at every shape of one call; the residual kNN and the
    # tail (also with a payload channel) at the call's one-shot-off shape
    calls = []
    with torch.inference_mode(), plain_versions(), record_calls(calls):
        model(a, b, z, z, t, perms=perms)
        request = len(calls)
        with gates(ONESHOT_OFF):
            model(a, b, z, z, t, perms=perms)
    calls = calls[:request] + [c for c in calls[request:] if c[0] in ("fusion_resi", "fusion_tail")]
    name, fn, (combined, resi, _, layers), kw = next(c for c in calls if c[0] == "fusion_tail")
    extra = torch.randn(*resi.shape[:3], 1, generator=torch.Generator().manual_seed(6)).to(dev)
    calls.append((name, fn, (combined, resi, extra, layers), kw))
    hold_kernels(calls, request, PER_STREAM_CALL, totals, f"stream x{STREAMS}", unit="call")
    fusion_resi_stages_line(next(c[2] for c in calls if c[0] == "fusion_resi"), card,
                            f"stream x{STREAMS}, one-shot off")
    for _, _, args, _ in (c for c in calls if c[0] == "fusion_tail"):  # Ce = 0, then 1
        fusion_tail_stages_line(args, card, f"stream x{STREAMS}, one-shot off")
    del calls, combined, resi, extra

    # the fused FlowNet3D route against the per-stage route, same pairs
    with torch.inference_mode():
        fused = model.flow.bidirectional(a, b, z, z)
        with gates(ALL_OFF):
            staged = model.flow.bidirectional(a, b, z, z)
    err = torch.cat([(f - s).abs().amax(-1).flatten() for f, s in zip(fused, staged)])
    p999 = torch.quantile(err, 0.999).item()
    print(f"flownet3d fused vs per-stage route, {STREAMS} pairs both ways: max "
          f"{err.max().item():.3g} m, p99.9 {p999:.3g} m, bit-equal points "
          f"{(err == 0).float().mean().item():.4f}")
    check(p999 <= 1e-4, "flownet3d: the fused route disagrees with the per-stage route")

    interp.stream_batch(pairs, STREAM_T)  # warm-up
    counts = serve_counts(lambda: [f for _ in range(5) for f in interp.stream_batch(pairs, STREAM_T)],
                          PER_STREAM_CALL, f"stream x{STREAMS}", frames_a_call=STREAMS)
    frames = interp.stream_batch(pairs, STREAM_T, perms=perms)
    worst, same = 0.0, True
    for i, ((x, y), ti) in enumerate(zip(pairs, STREAM_T)):
        single = interp(x, y, ti, perms=(perms[0][i:i + 1], perms[1][i:i + 1]))
        worst = max(worst, float(np.abs(frames[i] - single).max()))
        same &= bool(np.array_equal(frames[i], single))
    print(f"stream frames vs single requests, same permutations: max |diff| {worst:.3g} m, "
          f"bit-equal {same}")
    check(worst <= 1e-5, "stream_batch: a stream's frame differs from its single request")

    ms = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        interp.stream_batch(pairs, STREAM_T)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    torch.cuda.reset_peak_memory_stats()
    interp.stream_batch(pairs, STREAM_T)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    call_ms = statistics.median(ms)
    print(f"stream serving on {card}: {call_ms:.3f} ms per call of {STREAMS} streams x "
          f"{NPOINTS} points (CUDA events, median of 10), {1e3 * STREAMS / call_ms:.1f} "
          f"frames/s, peak memory {peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)")
    device_share(lambda: interp.stream_batch(pairs, STREAM_T), requests=3, unit="call")

    # PointINet on the routes with gates off: launches, frames, ms/frame
    x, y = pairs[0]
    one = (perms[0][:1], perms[1][:1])
    base = interp(x, y, 0.5, perms=one)
    route_counts = []
    for route, env, expected in (("all gates off", ALL_OFF, PER_REQUEST_ALL_OFF),
                                 ("one-shot off", ONESHOT_OFF, PER_REQUEST_ONESHOT_OFF)):
        with gates(env):
            interp(x, y, 0.5)  # warm-up
            route_counts.append(serve_counts(
                lambda: [interp(x, y, 0.5)] + interp.upsample(x, y, factor=5), expected,
                f"pointinet, {route}"))
            p, mx = agreement(interp(x, y, 0.5, perms=one), base,
                              f"pointinet frame, {route} vs the default route")
            check(p <= 1e-3 and mx <= 0.25, f"pointinet, {route}: frame disagrees")
    for route, env in (("default", {}), ("one-shot off", ONESHOT_OFF), ("all gates off", ALL_OFF)):
        with gates(env):
            latency(lambda: interp(x, y, 0.5), card, f"pointinet route {route}")
    return counts, route_counts


def synthetic_window(n: int = NPOINTS, seed: int = 0, t: float = 0.5, field: int = FIELD):
    """Seeded six-frame window ``frame_i = a + i * v + 0.05 noise`` at
    times -2, -1 (the forward context, nearest first), 0, 1 (the key
    pair), 2, 3 (the backward context): ``a`` as in synthetic_pair (for
    seed 0), ``v`` a per-point velocity of 0.5 m a frame that turns with
    the position (a slow rotation plus a drift), so the flows spread over
    a metre; then the ground truth, the same formula at time ``t``.  At
    another ``field``, ``field`` context frames each side."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((n, 3)) * 10).astype(np.float32)
    v = 0.05 * np.stack([-a[:, 1], a[:, 0], np.zeros(n, np.float32)], 1) + np.float32([0.3, 0.1, 0.0])
    frame = {i: (a + i * v + 0.05 * rng.standard_normal((n, 3))).astype(np.float32)
             for i in range(-field, field + 2)}
    fwd = [frame[-1 - j] for j in range(field)]
    bwd = [frame[2 + j] for j in range(field)]
    gt = (a + np.float32(t) * v + 0.05 * rng.standard_normal((n, 3))).astype(np.float32)
    return fwd, (frame[0], frame[1]), bwd, gt


def phase_isapci(card: str, totals: dict) -> dict:
    """ISAPCInet field=2: kernels at every shape of one plain request, then
    serving, agreement with the plain versions, latency, busy share."""
    from pci_tpu_torch.ops.cuda_kernels import plain_versions
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS, Interpolator

    interp = Interpolator.isapci(field=FIELD, npoints=NPOINTS, weights=DEFAULT_WEIGHTS,
                                 device="cuda")
    model = interp.model
    fwd, (k0, k1), bwd, _ = synthetic_window()
    context = (fwd, bwd)
    dev = torch.device("cuda")
    T = lambda x: torch.from_numpy(x)[None].to(dev)  # noqa: E731
    fwd_t, keys_t, bwd_t = [T(x) for x in fwd], [T(k0), T(k1)], [T(x) for x in bwd]
    z = torch.zeros_like(keys_t[0])
    tt = torch.tensor([0.5], device=dev)
    perms = tuple(torch.randperm(NPOINTS, generator=torch.Generator().manual_seed(s))[None].to(dev)
                  for s in (3, 4))

    calls = []
    with torch.inference_mode(), plain_versions(), record_calls(calls):
        model(fwd_t, keys_t, bwd_t, tt, z, perms=perms)
    hold_kernels(calls, len(calls), PER_REQUEST_ISAPCI, totals, "isapci")
    hold_knn_self_resi(calls)
    knn_stages(calls, card, "isapci")
    for _, _, args, _ in (c for c in calls if c[0] == "ball"):
        ball_stages_line(args, card, "isapci")
    hold_pn2mid_batch(next(c[2] for c in calls if c[0] == "pn2mid"), card)
    pn2mid_stages_line(next(c[2] for c in calls if c[0] == "pn2mid"), card, "isapci")
    attention_stages_line(next(c[2] for c in calls if c[0] == "attention"), card, "isapci")
    calls = []
    with torch.inference_mode(), plain_versions(), record_calls(calls), gates(PN2_OFF):
        model(fwd_t, keys_t, bwd_t, tt, z, perms=perms)
    hold_kernels(calls, len(calls), PER_REQUEST_ISAPCI_PN2_OFF, totals, "isapci, pn2mid off")
    del calls

    interp(k0, k1, 0.5, context=context)  # warm-up
    counts = serve_counts(
        lambda: [interp(k0, k1, 0.5, context=context)]
        + interp.upsample(k0, k1, factor=5, context=context),
        PER_REQUEST_ISAPCI, "isapci")

    # the flows through the kernels and through the plain versions
    with torch.inference_mode():
        flows = model.window_flows(fwd_t, keys_t, bwd_t, z)
        with plain_versions():
            flows_plain = model.window_flows(fwd_t, keys_t, bwd_t, z)
        flow_err = max((f - g).abs().max().item() for f, g in zip(flows, flows_plain))
        print(f"isapci flows vs plain: max {flow_err:.3g} m over "
              f"{2 * flows[0].numel() // 3} flow vectors")
        check(flow_err <= 1e-3, "isapci: kernel flows disagree with the plain flows")
        # the rest of the forward from the same flows: PointNet++ and the
        # transformer select (FPS, ball, kNN) over the flow cloud, so a
        # 1e-6 flow difference may flip a pick; given the same flows,
        # kernels and plain versions must give the same frame
        got = model.from_flows(*flows, keys_t, tt, perms=perms)[0].cpu().numpy()
        with plain_versions():
            want = model.from_flows(*flows, keys_t, tt, perms=perms)[0].cpu().numpy()
    p999, mx = agreement(got, want, "isapci frame vs plain, same flows")
    check(p999 <= 1e-3 and mx <= 0.25, "isapci frame disagrees with the plain forward")
    served = interp(k0, k1, 0.5, context=context, perms=perms)
    with plain_versions():
        plain = interp(k0, k1, 0.5, context=context, perms=perms)
    agreement(served, plain, "isapci frame vs the whole plain forward (flows included)")

    latency(lambda: interp(k0, k1, 0.5, context=context), card, "isapci")
    device_share(lambda: interp(k0, k1, 0.5, context=context))

    # PointNet++ stage by stage (PCI_TPU_PN2_KERNEL=0) in the same process
    with gates(PN2_OFF):
        interp(k0, k1, 0.5, context=context)  # warm-up
        counts_off = serve_counts(
            lambda: [interp(k0, k1, 0.5, context=context)]
            + interp.upsample(k0, k1, factor=5, context=context),
            PER_REQUEST_ISAPCI_PN2_OFF, "isapci, pn2mid off")
        off = interp(k0, k1, 0.5, context=context, perms=perms)
    p999, mx = agreement(served, off, "isapci frame, pn2mid on vs off (same permutations)")
    check(p999 <= 1e-3 and mx <= 0.25, "isapci: the pn2mid route's frame disagrees with "
                                       "the per-stage route's")
    for route, env in (("pn2mid on", {}), ("pn2mid off", PN2_OFF)):
        with gates(env):
            latency(lambda: interp(k0, k1, 0.5, context=context), card, f"isapci, {route}")
    with gates(ALL_OFF):  # the per-stage route in the same process, for the A/B
        interp(k0, k1, 0.5, context=context)
        latency(lambda: interp(k0, k1, 0.5, context=context), card, "isapci, all gates off")

    default = Interpolator.isapci(field=FIELD, weights=DEFAULT_WEIGHTS, device="cuda")
    frame = default(k0, k1, 0.5, context=context)  # resampled to 16,000
    check(frame.shape == (16000, 3) and np.isfinite(frame).all(),
          "isapci at the default 16,000 points: bad frame")
    print(f"isapci at npoints=16000: frame {frame.shape}, finite")
    return counts, counts_off


def train_batch(dev, field: int = FIELD):
    """The trainer's batch of two: sample b is synthetic_window(TRAIN_N,
    seed=b) with its ground truth at t = TRAIN_T[b]."""
    wins = [synthetic_window(TRAIN_N, seed=b, t=t, field=field)
            for b, t in enumerate(TRAIN_T)]
    stack = lambda xs: torch.from_numpy(np.stack(xs)).to(dev)  # noqa: E731
    return {"forward": [stack([w[0][j] for w in wins]) for j in range(field)],
            "keys": [stack([w[1][j] for w in wins]) for j in range(2)],
            "backward": [stack([w[2][j] for w in wins]) for j in range(field)],
            "t": torch.tensor(TRAIN_T, dtype=torch.float32, device=dev),
            "gt": stack([w[3] for w in wins]),
            "ini": torch.zeros((len(wins), TRAIN_N, 3), device=dev)}


def compare_grads(got: dict, want: dict) -> None:
    """Each trainable gradient through the kernels against the plain
    step's: within 1e-2 of its largest magnitude, plus 1e-5 of the largest
    gradient magnitude in the model G, and with cosine >= 0.999 where its
    magnitude exceeds 1e-3 G (a fusion neighbour can still swap on a 1e-6
    tie, and the attention backward sums ~2M rows in another order).  The
    floor is for gradients that are zero in exact arithmetic and rounding
    noise on both sides: the Dense biases before a train-mode BatchNorm
    (the batch mean cancels them) and the last attention bias (the softmax
    over k cancels it)."""
    G = max(w.abs().max().item() for w in want.values())
    worst, worst_cos, held = (0.0, ""), (1.0, ""), 0
    for name, w in want.items():
        g = got[name]
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        check(err <= 1e-2 * scale + 1e-5 * G,
              f"train: gradient of {name} differs by {err:.3g}, its max {scale:.3g}")
        worst = max(worst, (err / max(scale, 1e-30), name))
        if scale > 1e-3 * G:
            g64, w64 = g.flatten().double(), w.flatten().double()
            cos = (g64 @ w64 / (g64.norm() * w64.norm())).item()
            check(cos >= 0.999, f"train: gradient of {name} has cosine {cos:.6f}")
            worst_cos = min(worst_cos, (cos, name))
            held += 1
    print(f"train step kernels vs plain, same flows/permutations/FPS starts: "
          f"{len(want)} gradients (largest magnitude {G:.4g}), worst max|diff|/max|g| "
          f"{worst[0]:.3g} ({worst[1]}), least cosine {worst_cos[0]:.8f} "
          f"({worst_cos[1]}) over the {held} above 1e-3 of it")


def phase_train(card: str, totals: dict) -> dict:
    """ISAPCInet field=2 training at the trainer's defaults: kernels at
    every shape of one plain step, one step kernels vs plain, five steps
    with their launch counts, ms/step, peak memory, busy share."""
    import copy

    from pci_tpu_torch.convert import load_npz_tree, load_subtrees
    from pci_tpu_torch.models import ISAPCInet
    from pci_tpu_torch.ops.cuda_kernels import (
        launch_counts, plain_versions, reset_launch_counts)
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS, init_weights
    from pci_tpu_torch.train import (
        bn_momentum_schedule, clipped_step_lr, make_interp_train_step, make_optimizer)

    dev = torch.device("cuda")
    batch = train_batch(dev)
    # ISAPCInet(field=2, ff_out_c=64, tr_out_c=64, Tnet, frozen flow): a
    # seeded init, then the flow and fusion of the trained PointINet
    base = ISAPCInet(FIELD)
    init_weights(base, 0)
    load_subtrees(base, load_npz_tree(DEFAULT_WEIGHTS))
    base = base.to(dev)
    lr_sched = clipped_step_lr(TRAIN_LR, 100, 0.9, 1e-6)
    momentum = bn_momentum_schedule(0.5, 0.5, 100, 0.01)(0)
    check(momentum == TRAIN_MOMENTUM, f"bn momentum {momentum} at epoch 0")

    def trainer():
        model = copy.deepcopy(base)
        opt = make_optimizer(lambda step: lr_sched(step // STEPS_PER_EPOCH), model, ("flow",))
        return model, make_interp_train_step(model, opt, ("flow",))

    def draws():  # the permutations and FPS starts of a step
        return torch.Generator(device=dev).manual_seed(7)

    # every kernel at every shape of one plain step
    calls = []
    _, step = trainer()
    with plain_versions(), record_calls(calls):
        step(batch, draws(), momentum)
    request = len(calls)
    # and the residual kNN at three segments, PointsFusionMulti's form
    name, fn, (combined, _, _, k), _ = next(c for c in calls if c[0] == "fusion_resi")
    B, N = combined.shape[:2]
    calls.append((name, fn, (combined, torch.tensor([[N // 3, 2 * N // 3, N]] * B),
                             torch.tensor([[12, 10, 10], [8, 16, 8]][:B]), k), {}))
    # and the chamfer's kNN over key prefixes (knn_pallas's valid_n), at
    # k=1 and at k=8 with one prefix shorter than k
    name, fn, (a, b, _), _ = next(c for c in calls if c[0] == "nearest")
    calls.append((name, fn, (a, b, 1, torch.tensor([N // 2, N - 5][:B], device=dev)), {}))
    calls.append(("knn", fn, (a, b, 8, torch.tensor([5, N][:B], device=dev)), {}))
    hold_kernels(calls, request, PER_STEP, totals, "train", unit="step")
    knn_stages(calls[:request], card, "train")
    for _, _, args, _ in (c for c in calls[:request] if c[0] == "ball"):
        ball_stages_line(args, card, "train")
    fusion_resi_stages_line(next(c[2] for c in calls if c[0] == "fusion_resi"), card, "train")
    for _, _, args, _ in (c for c in calls[:request] if c[0] == "nearest"):
        nearest_stages_line(args, card, "train")
    attention_stages_line(next(c[2] for c in calls if c[0] == "attention_bwd"), card, "train")
    del calls

    # one step through the kernels against one through the plain versions,
    # from the same flows, permutations and FPS starts
    with torch.no_grad():
        flows = base.window_flows(batch["forward"], batch["keys"], batch["backward"],
                                  batch["ini"])
    losses, grads = [], []
    for plain in (False, True):
        model, step = trainer()
        model.window_flows = lambda *a, f=flows: f
        with plain_versions() if plain else contextlib.nullcontext():
            losses.append(step(batch, draws(), momentum).item())
        grads.append({n: p.grad for n, p in model.named_parameters() if p.requires_grad})
        del model, step
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    print(f"train step loss: kernels {losses[0]!r}, plain {losses[1]!r} (rel {rel:.3g})")
    check(rel <= 1e-4, "train: the step's loss disagrees with the plain step's")
    compare_grads(*grads)
    del grads

    # five steps on the card: launch counts, losses, the frozen flow
    model, step = trainer()
    gen = torch.Generator(device=dev).manual_seed(11)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    flow_before = {k: v.clone() for k, v in model.flow.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    marks, out = [], []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out.append(step(batch, gen, momentum))
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in marks]
    losses = [float(x) for x in out]
    print(f"train: 5 steps, losses {losses}, launches {counts}")
    check(all(np.isfinite(losses)), "train: a loss is not finite")
    check(counts == {k: v * 5 for k, v in PER_STEP.items()},
          f"train launch counts {counts} != {PER_STEP} x 5")
    for k, v in model.flow.state_dict().items():
        check(torch.equal(v, flow_before[k]), f"train: the frozen flow's {k} changed")
    for n, p in model.named_parameters():
        if n.startswith("flow."):
            check(not p.requires_grad and torch.equal(p, before[n]), f"train: {n} trained")
        else:
            check(not torch.equal(p, before[n]), f"train: {n} did not move")
    print(f"train step on {card}: {statistics.median(step_ms[1:]):.3f} ms/step (CUDA events, "
          f"median of steps 2-5; step 1 {step_ms[0]:.3f} ms), peak memory "
          f"{peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)")
    device_share(lambda: step(batch, gen, momentum), requests=3, unit="step")
    return counts


def cells_vs_flat(combined, seg_ends, budgets, layers, k: int, n: int) -> None:
    """The cell-pruned kernel against the flat ones on one combined cloud:
    residual-mode indices (and residuals) identical; one-shot rows within
    1e-6 m of the flat one-shot kernel's and of the flat residual kNN's
    neighbours through the attention tail (all three run the same
    tensor-core head, csrc/fusion_head.cuh, on the same neighbours, and the
    residuals are bit-equal; until the tail took that head its scalar MLP
    summed in another order and was held at the kernel holds' 1e-4);
    prints the share of pairs each scanned and the kernels' ms."""
    from pci_tpu_torch.ops.cuda_kernels.fusion_cells_cuda import fusion_cells_kernel
    from pci_tpu_torch.ops.cuda_kernels.fusion_knn_cuda import fusion_kernel, fusion_resi_kernel
    from pci_tpu_torch.ops.cuda_kernels.fusion_tail_cuda import fusion_tail_kernel

    B, N = combined.shape[:2]
    with torch.inference_mode():
        scanned = torch.zeros(1, dtype=torch.int64, device=combined.device)
        ci, cr = fusion_cells_kernel(combined, seg_ends, budgets, k, scanned=scanned)
        fi, fr = fusion_resi_kernel(combined, seg_ends, budgets, k)
        co = fusion_cells_kernel(combined, seg_ends, budgets, k, layers)
        fo = fusion_kernel(combined, seg_ends, budgets, layers, k)
        ft = fusion_tail_kernel(combined, fr, None, layers)
        torch.cuda.synchronize()
        check(torch.equal(ci, fi), f"fusion_cells at {n}: indices differ from the flat kernel's")
        check(torch.equal(cr, fr), f"fusion_cells at {n}: residuals differ from the flat kernel's")
        err = (co - fo).abs().max().item()
        err_tail = (co - ft).abs().max().item()
        print(f"fusion_cells vs flat at {n} points, budgets {budgets.tolist()}: indices "
              f"identical, residuals bit-equal, one-shot rows max |diff| {err:.3g} m against "
              f"the flat one-shot kernel, {err_tail:.3g} m against the flat residual kNN + "
              f"tail; pairs scanned {scanned.item()} of {B * N * N} "
              f"({scanned.item() / (B * N * N):.4f}; the flat kernels scan all)")
        check(err <= 1e-6, f"fusion_cells at {n}: one-shot rows differ from the flat one-shot "
                           "kernel's")
        check(err_tail <= 1e-6, f"fusion_cells at {n}: one-shot rows differ from the flat "
                                "residual kNN + tail")
        times = {name: cuda_ms(fn, 3) for name, fn in (
            ("cells residual", lambda: fusion_cells_kernel(combined, seg_ends, budgets, k)),
            ("flat residual", lambda: fusion_resi_kernel(combined, seg_ends, budgets, k)),
            ("cells one-shot", lambda: fusion_cells_kernel(combined, seg_ends, budgets, k, layers)),
            ("flat one-shot", lambda: fusion_kernel(combined, seg_ends, budgets, layers, k)))}
        print(f"fusion kernels at {n} points (ms, median of 3): "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in times.items()))


def cells_grad_check(combined, seg_ends, budgets, k: int) -> None:
    """The residual mode's gradient into the cloud, by autograd through the
    kernel and through the plain version: equal bit for bit (the scatter
    of the fixed-neighbour backward made deterministic for both)."""
    from pci_tpu_torch.ops.cuda_kernels import fusion_cells_resi_knn, plain_versions

    g = torch.randn(*combined.shape[:2], k, 3, generator=torch.Generator().manual_seed(9))
    g = g.to(combined.device)
    grads = []
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for plain in (False, True):
            x = combined.detach().clone().requires_grad_()
            with plain_versions() if plain else contextlib.nullcontext():
                _, resi = fusion_cells_resi_knn(x, seg_ends, budgets, k)
            (resi * g).sum().backward()
            grads.append(x.grad)
    finally:
        torch.use_deterministic_algorithms(was)
    print(f"fusion_cells residual-mode gradient at {combined.shape[1]} points, kernel vs "
          f"plain: bit-equal {torch.equal(*grads)}, max |diff| "
          f"{(grads[0] - grads[1]).abs().max().item():.3g}, max |g| "
          f"{grads[1].abs().max().item():.4g}")
    check(torch.equal(*grads), "fusion_cells: the residual mode's gradient differs from "
                               "the plain version's")


def phase_large(card: str, totals: dict) -> list:
    """PointINet at 65,536 and 32,768 points on the cell-pruned fusion:
    every kernel against its plain version at every shape of one request,
    of the t=0.2 fusion and of one one-shot-off request; the cells kernel
    against the flat one; five requests with their launch counts on the
    default route and with one-shot off, the frames against the plain
    forward and each other, ms/frame; busy share at 65,536; the residual
    mode's gradient at 32,768."""
    from pci_tpu_torch.ops.cuda_kernels import plain_versions
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS, Interpolator

    dev = torch.device("cuda")
    paths = []
    for n in LARGE_N:
        interp = Interpolator.pointinet(npoints=n, weights=DEFAULT_WEIGHTS, device="cuda")
        model = interp.model
        a_np, b_np = synthetic_pair(0, n)
        a = torch.from_numpy(a_np)[None].to(dev)
        b = torch.from_numpy(b_np)[None].to(dev)
        z = torch.zeros_like(a)
        perms = tuple(torch.randperm(n, generator=torch.Generator().manual_seed(s))[None].to(dev)
                      for s in (1, 2))
        calls = []
        with torch.inference_mode(), plain_versions(), record_calls(calls):
            model(a, b, z, z, torch.tensor([0.5], device=dev), perms=perms)
            request = len(calls)
            model(a, b, z, z, torch.tensor([0.2], device=dev), perms=perms)
            second = len(calls)
            with gates(ONESHOT_OFF):
                model(a, b, z, z, torch.tensor([0.5], device=dev), perms=perms)
        off = dispatch_counts(calls[second:])
        check(off == PER_REQUEST_CELLS_ONESHOT_OFF,
              f"pointinet at {n}, one-shot off: dispatches {off}, expected "
              f"{PER_REQUEST_CELLS_ONESHOT_OFF}")
        fusion = [c for c in calls if c[0] == "fusion_cells"]
        check(len(fusion) == 3 and not any(c[0] == "fusion" for c in calls),
              f"pointinet at {n}: the fusion did not take the cell-pruned kernel")
        layers = model.fusion.mlp.folded()
        for _, _, args, _ in fusion[:2]:
            cells_vs_flat(args[0], args[1], args[2], layers, args[-1], n)
        for _, _, args, _ in (fusion[0], fusion[2]):  # one-shot, residual
            fusion_cells_stages_line(args, card, f"pointinet {n}")
        fusion_tail_stages_line(next(c[2] for c in calls[second:] if c[0] == "fusion_tail"),
                                card, f"pointinet {n}, one-shot off")
        # the request, the t=0.2 fusion, and the whole one-shot-off request
        calls = (calls[:request] + [c for c in calls[request:second] if c[0] == "fusion_cells"]
                 + calls[second:])
        hold_kernels(calls, request, PER_REQUEST_CELLS, totals, f"pointinet {n}")
        if n == 32768:
            cells_grad_check(*fusion[0][2][:3], fusion[0][2][-1])
        del calls, fusion

        interp(a_np, b_np, 0.5)  # warm-up
        paths.append(serve_counts(lambda: [interp(a_np, b_np, 0.5)]
                                  + interp.upsample(a_np, b_np, factor=5),
                                  PER_REQUEST_CELLS, f"pointinet {n}", npoints=n))
        got = interp(a_np, b_np, 0.5, perms=perms)
        with plain_versions():
            want = interp(a_np, b_np, 0.5, perms=perms)
        p999, mx = agreement(got, want, f"pointinet {n} frame vs plain")
        check(p999 <= 1e-3 and mx <= 0.25, f"pointinet {n}: frame disagrees with the plain forward")
        latency(lambda: interp(a_np, b_np, 0.5), card, f"pointinet {n}")
        if n == 65536:
            device_share(lambda: interp(a_np, b_np, 0.5))
        with gates(ONESHOT_OFF):
            interp(a_np, b_np, 0.5)  # warm-up
            paths.append(serve_counts(lambda: [interp(a_np, b_np, 0.5)]
                                      + interp.upsample(a_np, b_np, factor=5),
                                      PER_REQUEST_CELLS_ONESHOT_OFF,
                                      f"pointinet {n}, one-shot off", npoints=n))
            p999, mx = agreement(interp(a_np, b_np, 0.5, perms=perms), got,
                                 f"pointinet {n} frame, one-shot off vs default")
            check(p999 <= 1e-3 and mx <= 0.25, f"pointinet {n}, one-shot off: frame "
                                               "disagrees")
            latency(lambda: interp(a_np, b_np, 0.5), card, f"pointinet {n}, one-shot off")
        del interp, model
        torch.cuda.empty_cache()
    return paths


def intensity_pair(n: int, seed: int = 0):
    """:func:`synthetic_pair` with a seeded intensity channel in [0, 1]:
    two ``[n, 4]`` clouds."""
    rng = np.random.default_rng(seed + 100)
    return tuple(np.concatenate([x, rng.random((n, 1)).astype(np.float32)], 1)
                 for x in synthetic_pair(seed, n))


def phase_intensity(card: str, totals: dict, model16) -> list:
    """PointINet on ``[1, N, 4]`` clouds (xyz and a seeded intensity in [0,
    1]) at 16,384 and 65,536 points, through ``PointINet.forward`` as the
    eval CLI calls it (``Interpolator`` serves xyz): one plain request's
    dispatches on the default route and with one-shot off (the payload on
    the one-shot call, the tail's ``extra``), those two kernels against
    their plain versions (`stages fusion_payload`: the one-shot call without
    and with the payload), then five requests on each route with the launch
    counts of the xyz path's (the payload rides the same launch), ``[N,
    4]`` frames, the default route's frame against the plain forward and
    one-shot off's against the default's, ms/frame beside the xyz path's
    through the same model.  ``model16``: the 16,384-point model."""
    from pci_tpu_torch.ops.cuda_kernels import plain_versions
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS, Interpolator

    dev = torch.device("cuda")
    paths = []
    for n, oneshot, per_req, per_off in (
            (NPOINTS, "fusion", PER_REQUEST, PER_REQUEST_ONESHOT_OFF),
            (LARGE_N[0], "fusion_cells", PER_REQUEST_CELLS, PER_REQUEST_CELLS_ONESHOT_OFF)):
        model = model16 if n == NPOINTS else Interpolator.pointinet(
            npoints=n, weights=DEFAULT_WEIGHTS, device="cuda").model
        a, b = (torch.from_numpy(x)[None].to(dev) for x in intensity_pair(n))
        z = torch.zeros(1, n, 3, device=dev)
        t = torch.tensor([0.5], device=dev)
        perms = tuple(torch.randperm(n, generator=torch.Generator().manual_seed(s))[None].to(dev)
                      for s in (1, 2))
        path = f"pointinet {n} intensity"
        calls = []
        with torch.inference_mode(), plain_versions(), record_calls(calls):
            model(a, b, z, z, t, perms=perms)
            request = len(calls)
            with gates(ONESHOT_OFF):
                model(a, b, z, z, t, perms=perms)
        for part, want in ((calls[:request], per_req), (calls[request:], per_off)):
            got = dispatch_counts(part)
            check(got == want, f"{path}: dispatches {got}, expected {want}")
        fusion = next(c for c in calls[:request] if c[0] == oneshot)
        tail = next(c for c in calls[request:] if c[0] == "fusion_tail")
        check(payload_width(fusion[3].get("payload")) == 1 and tail[2][2] is not None
              and tail[2][2].shape[-1] == 1, f"{path}: the intensity is not the payload")
        # the flow's kernels are phase 3's and 8's at these shapes: hold the
        # two that take the intensity
        hold_kernels([fusion, tail], 1, per(**{oneshot: 1}), totals, path)
        fusion_payload_stages_line(oneshot, fusion[2], card, path, fusion[3]["payload"])
        del calls

        def serve(x1=a, x2=b):
            with torch.inference_mode():
                return model(x1, x2, z, z, t)[0].cpu().numpy()

        def frame():
            with torch.inference_mode():
                return model(a, b, z, z, t, perms=perms)[0].cpu().numpy()

        serve()  # warm-up
        paths.append(serve_counts(lambda: [serve() for _ in range(5)], per_req, path,
                                  npoints=n, width=4))
        got = frame()
        with plain_versions():
            want = frame()
        p999, mx = agreement(got, want, f"{path} frame vs plain")
        check(p999 <= 1e-3 and mx <= 0.25, f"{path}: frame disagrees with the plain forward")
        latency(serve, card, f"{path} (model call)")
        latency(lambda: serve(a[..., :3], b[..., :3]), card, f"pointinet {n} xyz (model call)")
        with gates(ONESHOT_OFF):
            serve()  # warm-up
            paths.append(serve_counts(lambda: [serve() for _ in range(5)], per_off,
                                      f"{path}, one-shot off", npoints=n, width=4))
            p999, mx = agreement(frame(), got, f"{path} frame, one-shot off vs default")
            check(p999 <= 1e-3 and mx <= 0.25, f"{path}, one-shot off: frame disagrees")
            latency(serve, card, f"{path}, one-shot off (model call)")
        del model
        torch.cuda.empty_cache()
    return paths


def fusion_k(name, args) -> int:
    """The k of a recorded fusion call (rows 4, 4b, 7)."""
    return args[1].shape[2] if name == "fusion_tail" else args[-1]


def queued_ms(fn, reps: int = 20) -> float:
    """Milliseconds a call of ``fn`` takes in a run of ``reps`` calls
    queued back to back between two CUDA events, after two warm-up calls:
    the device's time a call wherever the host enqueues a call faster than
    the device runs it (no profiler: in a long process torch.profiler has
    read kernels as 0 ms)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fusion_stages_lines(calls, card: str, path: str, kind: str, past: int) -> None:
    """The `stages <kind>` line (`fusion64` past k = 32, `fusion128` past 64)
    of each recorded fusion call (rows 4, 4b and 7) past k = ``past``: CUDA
    events around one call (median of 10,
    the host's launch included) and a call's share of 20 queued back to
    back (the device's time)."""
    with torch.inference_mode():
        for name, fn, args, kw in calls:
            if name not in FUSION_KINDS or fusion_k(name, args) <= past:
                continue
            call = lambda: fn(*args, **kw)  # noqa: E731
            print(f"stages {kind} {path} {name} {label(name, args, kw)} on {card}: "
                  f"{cuda_ms(call, 10):.4f} ms (CUDA events, one call), {queued_ms(call):.4f} "
                  f"ms a call of 20 queued")


def pointinet2_model(dev, fusion_k: int = 64):
    """PointINet2 field=2 on ``dev``, eval, its rings and fusion2 at
    ``fusion_k``: the trained PointINet (assets/pointinet_synth16k.npz) as
    its key PointINet (flow and fusion) and as its ring flow; Wnet, the ring
    fusions and fusion2 a seeded init."""
    from pci_tpu_torch.convert import flax_to_state_dict, load_npz_tree
    from pci_tpu_torch.models import PointINet2
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS, init_weights

    model = PointINet2(FIELD, fusion_k=fusion_k)
    init_weights(model, 1100)
    trained = flax_to_state_dict(load_npz_tree(DEFAULT_WEIGHTS))
    own = {f"pointinet.{k}": v for k, v in trained.items()}
    own.update({k: v for k, v in trained.items() if k.startswith("flow.")})
    missing, unexpected = model.load_state_dict(own, strict=False)
    check(not unexpected and not any(k.startswith(("flow.", "pointinet.")) for k in missing),
          f"pointinet2 weights: missing {missing[:5]}, unexpected {unexpected[:5]}")
    return model.to(dev).eval()


def phase_pointinet2(card: str, totals: dict) -> list:
    """PointINet2 field=2 at eval (its ring and multi-cloud fusions at k =
    64): one 16,384-point request (a seeded six-frame window, B = 1)
    through the model's forward, and ``make_interp_eval_step`` at the
    trainer's 16,000 points, B = 2 (train_batch's windows).  For each: one
    plain call's dispatches on the default route (and for the request with
    one-shot off) against their counts, its fusion kernels (rows 4, 4b and
    7, at k = 32 and 64) against their plain versions at these shapes;
    then five requests (steps) with the counts set to 0 before, the frames
    against the plain forward on the same permutations, one-shot off's
    against the default's, ms a request (step) by CUDA events, and the
    device's busy share."""
    from pci_tpu_torch.ops.cuda_kernels import launch_counts, plain_versions, reset_launch_counts
    from pci_tpu_torch.train import make_interp_eval_step

    dev = torch.device("cuda")
    model = pointinet2_model(dev)
    paths = []
    fwd, (k0, k1), bwd, _ = synthetic_window()
    T = lambda x: torch.from_numpy(x)[None].to(dev)  # noqa: E731
    args = ([T(x) for x in fwd], [T(k0), T(k1)], [T(x) for x in bwd],
            torch.tensor([0.5], device=dev), torch.zeros(1, NPOINTS, 3, device=dev))
    g = torch.Generator().manual_seed(1101)
    perms = [torch.randperm(NPOINTS, generator=g)[None].to(dev)
             for _ in range(2 + 2 * FIELD + FIELD + 1)]
    path = f"pointinet2 {NPOINTS}"
    calls = []
    with torch.inference_mode(), plain_versions(), record_calls(calls):
        model(*args, perms=perms)
        request = len(calls)
        with gates(ONESHOT_OFF):
            model(*args, perms=perms)
    for part, want, route in ((calls[:request], PER_REQUEST_POINTINET2, "default"),
                              (calls[request:], PER_REQUEST_POINTINET2_ONESHOT_OFF,
                               "one-shot off")):
        got = dispatch_counts(part)
        check(got == want, f"{path} {route}: dispatches {got}, expected {want}")
        # the flow's kernels are phase 3's at these shapes: hold the fusion's
        fus = [c for c in part if c[0] in FUSION_KINDS]
        hold_kernels(fus, len(fus), per(**{n: want[n] for n in FUSION_KINDS}), totals,
                     f"{path} {route}")
        fusion_stages_lines(fus, card, f"{path} {route}", "fusion64", 32)
    del calls

    def serve(p=None):
        with torch.inference_mode():
            return model(*args, perms=p)[0].cpu().numpy()

    for route, want, values in (("default", PER_REQUEST_POINTINET2, {}),
                                ("one-shot off", PER_REQUEST_POINTINET2_ONESHOT_OFF,
                                 ONESHOT_OFF)):
        with gates(values):
            serve()  # warm-up
            paths.append(serve_counts(lambda: [serve() for _ in range(5)], want,
                                      f"{path} {route}"))
            got = serve(perms)
            with plain_versions():
                plain = serve(perms)
            p999, mx = agreement(got, plain, f"{path} {route} frame vs plain")
            check(p999 <= 1e-3 and mx <= 0.25, f"{path} {route}: frame disagrees with the plain "
                                               "forward")
            if route == "default":
                default = got
            else:
                p999, mx = agreement(got, default, f"{path} frame, one-shot off vs default")
                check(p999 <= 1e-3 and mx <= 0.25, f"{path}: one-shot off disagrees")
            latency(serve, card, f"{path} {route} (model call)")
            if route == "default":
                device_share(serve)

    # the eval step at the trainer's shape
    batch = train_batch(dev)
    step = make_interp_eval_step(model)
    draws = lambda: torch.Generator(device=dev).manual_seed(1102)  # noqa: E731
    path = f"pointinet2 eval step {TRAIN_N} x {len(TRAIN_T)}"
    calls = []
    with plain_versions(), record_calls(calls):
        _, plain = step(batch, draws())
    got = dispatch_counts(calls)
    check(got == PER_EVAL_STEP_POINTINET2, f"{path}: dispatches {got}, expected "
                                           f"{PER_EVAL_STEP_POINTINET2}")
    fus = [c for c in calls if c[0] in FUSION_KINDS]
    hold_kernels(fus, len(fus), per(**{n: PER_EVAL_STEP_POINTINET2[n] for n in FUSION_KINDS}),
                 totals, path)
    fusion_stages_lines(fus, card, path, "fusion64", 32)
    del calls
    step(batch, draws())  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = [step(batch, draws()) for _ in range(5)]
    counts = launch_counts()
    print(f"{path}: 5 steps, launches {counts}")
    check(counts == {k: 5 * v for k, v in PER_EVAL_STEP_POINTINET2.items()},
          f"{path} launch counts {counts} != {PER_EVAL_STEP_POINTINET2} x 5")
    for cd, frame in outs:
        check(cd.shape == (len(TRAIN_T),) and bool(torch.isfinite(cd).all())
              and frame.shape == (len(TRAIN_T), TRAIN_N, 3) and bool(torch.isfinite(frame).all()),
              f"{path}: chamfer {cd} or frames not finite")
    print(f"{path}: chamfer a sample {[round(float(c), 6) for c in outs[0][0]]}")
    for b in range(len(TRAIN_T)):
        p999, mx = agreement(outs[0][1][b].cpu().numpy(), plain[b].cpu().numpy(),
                             f"{path} sample {b} frame vs plain")
        check(p999 <= 1e-3 and mx <= 0.25, f"{path}: frame {b} disagrees with the plain forward")
    paths.append(per(**{k: 5 * v for k, v in PER_EVAL_STEP_POINTINET2.items()}))
    latency(lambda: step(batch, draws()), card, f"{path} (a step, {len(TRAIN_T)} frames)")
    device_share(lambda: step(batch, draws()), requests=3, unit="step")
    del model
    torch.cuda.empty_cache()
    return paths


def hold_knn_self_resi(calls) -> None:
    """ops.knn_self_resi on each large self cloud the request gave the
    transformer (its box-pruned residual route) against ops.knn (the
    kernel) and the gather: indices and residuals bit-equal."""
    from pci_tpu_torch.ops import index_points, knn, knn_self_resi

    for name, fn, args, _ in calls:
        if fn is not self_resi_call:
            continue
        points, k = args[1], args[2]
        with torch.inference_mode():
            idx, resi = knn_self_resi(points, k)
            _, want = knn(points, points, k)
            gathered = index_points(points, want) - points[:, :, None, :]
        check(torch.equal(idx, want) and torch.equal(resi, gathered),
              f"knn_self_resi N={points.shape[1]} k={k}: differs from knn and the gather")
        print(f"knn_self_resi hold N={points.shape[1]} k={k}: indices and residuals bit-equal "
              "to knn (the kernel) and the gather")


def parent_cells_gate(fn):
    """The parent tree's cells gate: k <= 32, two segments (the rings at
    k = 64 and fusion2 took the flat rows 4 and 4b at every size)."""
    return lambda points, k, train, n_seg=2: fn(points, k, train, n_seg) and k <= 32 \
        and n_seg == 2


def phase_pointinet2_large(card: str, totals: dict) -> list:
    """PointINet2 field=2 at eval on one POINTINET2_LARGE_N-point request
    (a seeded six-frame window, B = 1; phase 11's weights): the cell-pruned
    routes (the rings on row 12 at k = 64, fusion2 on row 10's masked
    passes).  One plain call's dispatches on the default route and with
    one-shot off against their counts, its fusion calls against their
    plain versions, their `stages fusion64` lines; five requests on each
    route with those counts, the frames against the plain forward (and
    one-shot off's against the default's), ms a request and the busy
    share; then the parent's route for the same call
    (the flat rows 4 and 4b at k = 64: rings and fusion2), ms a request."""
    import pci_tpu_torch.nn.fusion as tfusion
    from pci_tpu_torch.ops.cuda_kernels import plain_versions

    dev = torch.device("cuda")
    n = POINTINET2_LARGE_N
    model = pointinet2_model(dev)
    fwd, (k0, k1), bwd, _ = synthetic_window(n)
    T = lambda x: torch.from_numpy(x)[None].to(dev)  # noqa: E731
    args = ([T(x) for x in fwd], [T(k0), T(k1)], [T(x) for x in bwd],
            torch.tensor([0.5], device=dev), torch.zeros(1, n, 3, device=dev))
    g = torch.Generator().manual_seed(1103)
    perms = [torch.randperm(n, generator=g)[None].to(dev)
             for _ in range(2 + 2 * FIELD + FIELD + 1)]
    path = f"pointinet2 {n}"
    routes = (("default", PER_REQUEST_POINTINET2_LARGE, {}),
              ("one-shot off", PER_REQUEST_POINTINET2_LARGE_ONESHOT_OFF, ONESHOT_OFF))
    for route, want, values in routes:
        calls = []
        with torch.inference_mode(), plain_versions(), record_calls(calls), gates(values):
            model(*args, perms=perms)
        got = dispatch_counts(calls)
        check(got == want, f"{path} {route}: dispatches {got}, expected {want}")
        fus = [c for c in calls if c[0] in LARGE_FUSION_KINDS]
        hold_kernels(fus, len(fus), per(**{kind: want[kind] for kind in (
            "fusion_cells", "knn_cells", "fusion_tail")}), totals, f"{path} {route}")
        fusion_stages_lines(fus, card, f"{path} {route}", "fusion64", 32)
    del calls, fus

    def serve(p=None):
        with torch.inference_mode():
            return model(*args, perms=p)[0].cpu().numpy()

    with plain_versions():
        plain = serve(perms)
    paths = []
    for route, want, values in routes:
        with gates(values):
            serve()  # warm-up
            paths.append(serve_counts(lambda: [serve() for _ in range(5)], want,
                                      f"{path} {route}", npoints=n))
            got = serve(perms)
            p999, mx = agreement(got, plain, f"{path} {route} frame vs plain")
            check(p999 <= 1e-3 and mx <= 0.25, f"{path} {route}: frame disagrees with the "
                                               "plain forward")
            if route == "default":
                default = got
            else:
                p999, mx = agreement(got, default, f"{path} frame, one-shot off vs default")
                check(p999 <= 1e-3 and mx <= 0.25, f"{path}: one-shot off disagrees")
            latency(serve, card, f"{path} {route} (model call)")
            if route == "default":
                device_share(serve)
    gate = tfusion._cells_route_ok
    tfusion._cells_route_ok = parent_cells_gate(gate)
    try:
        serve()  # warm-up
        latency(serve, card, f"{path} parent's route (flat rows 4 and 4b at k = 64; "
                             "model call)")
    finally:
        tfusion._cells_route_ok = gate
    del model
    torch.cuda.empty_cache()
    return paths


# row 12 at k <= 64: (N, k, t), both modes and a one-channel payload
CELLS64_HOLDS = tuple((N, k, t) for N in LARGE_N for k in (48, 64)
                      for t in (0.02, 0.2, 0.5, 0.98))
# row 10's masked passes, F = 3 at k = 64, N points: (ends, budgets) from
# _multi_budgets' weights (Wnet-like, 5/5/54; even), and by hand: a 40-key
# segment under a budget of 54 beside a budget of 0
MASKED_HOLDS = (("wnet", (0.09, 0.09)), ("even", (0.33, 0.33)),
                ("starved", lambda N: ([[40, N - 5000, N]], [[54, 0, 10]])))


def head_sum_errors(got, combined, resi, extra, layers) -> tuple:
    """A one-shot kernel's weighted sums (residual sums ``got - combined``
    on a cloud near the origin, and the payload channels) against fp64 on
    the plain neighbours' residuals: the max abs error of the kernel, of
    the plain head in fp32 and with one TF32 product a layer."""
    from pci_tpu_torch.ops.cuda_kernels import _build
    from pci_tpu_torch.ops.cuda_kernels.fusion_knn_cuda import fusion_head

    zero = torch.zeros_like(combined)
    layers64 = [(w.double(), b.double()) for w, b in layers]
    with torch.inference_mode():
        ref = fusion_head(zero.double(), resi.double(), lambda h: _build.mlp_plain(h, layers64),
                          extra.double())
        fp32 = fusion_head(zero, resi, lambda h: _build.mlp_plain(h, layers), extra)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = fusion_head(zero, resi, lambda h: _build.mlp_plain(h, layers), extra)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    mine = torch.cat([got[..., :3] - combined, got[..., 3:]], -1)
    return tuple((t.double() - ref).abs().max().item() for t in (mine, fp32, tf32))


def hold_cells_k64(card: str) -> None:
    """Row 12 at k = 48 and 64 (its k <= 64 instantiation) at CELLS64_HOLDS
    on seeded clouds (sigma 1 m) with hold_fusion_tail's seeded score MLP
    and a one-channel payload: the residual mode's indices and residuals
    bit-equal to the plain version's; the one-shot rows within 1e-4 of
    the plain version's, the weighted sums (the payload channel too)
    against fp64 within TAIL_SUM_LIMIT and below one TF32
    product's; each mode timed by CUDA events beside the flat kernels
    (rows 4 and 4b, the parent's route at k > 32) on the same inputs.  Then
    row 10's masked passes at MASKED_HOLDS (fusion_cells_multi_knn against
    fusion_resi_plain, idx and resi bit-equal; the pairs each pass scanned
    beside the flat scan's; timed beside row 4b), a masked knn_cells with a
    starved mask, and the resources of the new instantiations beside the
    k <= 32 ones."""
    from pci_tpu_torch.nn.fusion import _adaptive_budgets, _multi_budgets
    from pci_tpu_torch.ops import index_points
    from pci_tpu_torch.ops.cuda_kernels import _build, knn_cuda
    from pci_tpu_torch.ops.cuda_kernels import fusion_cells_cuda as FC
    from pci_tpu_torch.ops.cuda_kernels import fusion_knn_cuda as F

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1700)
    layers = seeded_score_mlp(g, dev)
    clouds = {N: torch.randn(1, N, 3, generator=g).to(dev) for N in LARGE_N}
    payloads = {N: torch.rand(1, N, 1, generator=g).to(dev) for N in LARGE_N}
    for N, k, t in CELLS64_HOLDS:
        x, pay = clouds[N], payloads[N]
        N1, _, k1, k2 = _adaptive_budgets(N, k, torch.tensor([t]))
        seg_ends = torch.stack([N1, torch.full_like(N1, N)], 1).to(dev)
        budgets = torch.stack([k1, k2], 1).to(dev)
        where = f"N={N} k={k} t={t} budgets={budgets.tolist()}"
        with torch.inference_mode():
            idx, resi = F.fusion_resi_plain(x, seg_ends, budgets, k)
            got = FC.fusion_cells_kernel(x, seg_ends, budgets, k)
            torch.cuda.synchronize()
            check(torch.equal(got[0], idx) and torch.equal(got[1], resi),
                  f"fusion_cells k64 hold {where}: residual mode differs from the plain version")
            extra = index_points(pay, idx)
            plain = F.fusion_head(x, resi, lambda h: _build.mlp_plain(h, layers), extra)
            got = FC.fusion_cells_kernel(x, seg_ends, budgets, k, layers, payload=pay)
            torch.cuda.synchronize()
        e = compare("fusion_cells", got, plain, f"k64 hold {where}")
        e_k, e_32, e_tf = head_sum_errors(got, x, resi, extra, layers)
        check(e_k <= TAIL_SUM_LIMIT and e_k < e_tf,
              f"fusion_cells k64 hold {where}: weighted sums {e_k} from fp64")
        with torch.inference_mode():
            ms = {name: cuda_ms(fn, 5) for name, fn in (
                ("cells one-shot", lambda: FC.fusion_cells_kernel(x, seg_ends, budgets, k, layers,
                                                                  payload=pay)),
                ("flat one-shot", lambda: F.fusion_kernel(x, seg_ends, budgets, layers, k, pay)),
                ("cells residual", lambda: FC.fusion_cells_kernel(x, seg_ends, budgets, k)),
                ("flat residual", lambda: F.fusion_resi_kernel(x, seg_ends, budgets, k)))}
        print(f"fusion_cells k64 hold {where} Cp=1 on {card}: residual mode indices identical "
              f"and residuals bit-equal; one-shot {e:.3g} from plain, sums vs fp64 {e_k:.3g} "
              f"(plain fp32 {e_32:.3g}, 1xTF32 {e_tf:.3g}); ms by CUDA events (median of 5, "
              "the prep included): " + ", ".join(f"{n} {v:.4f}" for n, v in ms.items()),
              flush=True)
    for N in LARGE_N:
        x = clouds[N]
        for name, spec in MASKED_HOLDS:
            if callable(spec):
                ends, buds = (torch.tensor(t, dtype=torch.int32) for t in spec(N))
            else:
                n_all, buds = _multi_budgets(N, 64, torch.tensor([spec]))
                ends = torch.cumsum(n_all, 1)
            ends, buds = ends.to(dev), buds.to(dev)
            where = f"N={N} {name} ends={ends.tolist()} budgets={buds.tolist()}"
            scanned = torch.zeros(3, dtype=torch.int64, device=dev)
            with torch.inference_mode():
                got = FC.fusion_cells_multi_knn(x, ends, buds, 64, scanned=scanned)
                torch.cuda.synchronize()
                want = F.fusion_resi_plain(x, ends, buds, 64)
                check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                      f"knn_cells masked hold {where}: differs from fusion_resi_plain")
                ms = cuda_ms(lambda: FC.fusion_cells_multi_knn(x, ends, buds, 64), 5)
                flat = cuda_ms(lambda: F.fusion_resi_kernel(x, ends, buds, 64), 5)
            sizes = torch.diff(ends[0].cpu(), prepend=torch.zeros(1, dtype=ends.dtype)).tolist()
            print(f"knn_cells masked hold {where} F=3 emit_resi on {card}: idx and resi "
                  f"bit-equal to fusion_resi_plain; pairs scanned by pass "
                  + ", ".join(f"{int(v)} of {N * m}" for v, m in zip(scanned.tolist(), sizes))
                  + f" (flat scan {N * N}); ms by CUDA events {ms:.4f} (3 passes, preps "
                  f"included; flat row 4b {flat:.4f})", flush=True)
        kv = torch.zeros(1, N, dtype=torch.bool, device=dev)
        kv[0, torch.randperm(N, generator=g)[:20].to(dev)] = True
        with torch.inference_mode():
            got = knn_cuda.knn_cells(x, x, 54, key_valid=kv, emit_resi=True)
            torch.cuda.synchronize()
            want = knn_cuda.knn_cells_plain(x, x, 54, kv, emit_resi=True)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"knn_cells masked N={N} starved (20 keys, k=54): differs from its plain version")
        print(f"knn_cells masked hold N={N} 20 valid keys k=54: distances, indices and "
              "residuals bit-equal (34 sentinel slots a query)")
    for kname, entry in (("fusion_cells", "pci_fusion_cells_attrs"),
                         ("fusion_cells", "pci_fusion_cells_payload_attrs"),
                         ("fusion_cells", "pci_fusion_cells_resi_attrs"),
                         ("fusion_cells", "pci_fusion_cells64_attrs"),
                         ("fusion_cells", "pci_fusion_cells64_payload_attrs"),
                         ("fusion_cells", "pci_fusion_cells_resi64_attrs"),
                         ("knn_cells", "pci_knn_cells_attrs"),
                         ("knn_cells", "pci_knn_cells_seg_attrs")):
        print(f"kernel resources {kname} ({entry}): "
              f"{resources_text(_build.kernel_attrs(entry))}")


def phase_variants(card: str) -> list:
    """ISAPCInet's published width variants (VARIANTS): each served at
    16,384 points (seeded weights, the flow and fusion of the trained
    PointINet): one plain request's dispatches against its PER_REQUEST_*
    and its attention calls against their plain versions; five requests
    with those launch counts, the frame against the plain forward from the
    same flows, ms/frame, the busy share.  Then field 1 at 128's training
    step (phase 7's), one cli.test run of noT_96 (chamfer only), the
    attention at the variants' widths (attention_widths) and the wide
    instantiations' resources."""
    from pci_tpu_torch.ops.cuda_kernels import plain_versions
    from pci_tpu_torch.ops.cuda_kernels._build import kernel_attrs
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS, Interpolator

    dev = torch.device("cuda")
    T = lambda x: torch.from_numpy(x)[None].to(dev)  # noqa: E731
    tt = torch.tensor([0.5], device=dev)
    perms = tuple(torch.randperm(NPOINTS, generator=torch.Generator().manual_seed(s))[None].to(dev)
                  for s in (3, 4))
    out = []
    for name, kw, expected in VARIANTS:
        interp = Interpolator.isapci(npoints=NPOINTS, weights=DEFAULT_WEIGHTS, device="cuda", **kw)
        model = interp.model
        fwd, (k0, k1), bwd, _ = synthetic_window(field=kw["field"])
        context = (fwd, bwd)
        fwd_t, keys_t, bwd_t = [T(x) for x in fwd], [T(k0), T(k1)], [T(x) for x in bwd]
        z = torch.zeros_like(keys_t[0])
        calls = []
        with torch.inference_mode(), plain_versions(), record_calls(calls):
            model(fwd_t, keys_t, bwd_t, tt, z, perms=perms)
        counts = dispatch_counts(calls)
        check(counts == expected, f"{name} dispatches {counts} a request, expected {expected}")
        att = [c for c in calls if c[0] == "attention"]
        hold_kernels(att, len(att), per(attention=len(att)), new_totals(), name)
        del calls, att
        interp(k0, k1, 0.5, context=context)  # warm-up
        out.append(serve_counts(
            lambda: [interp(k0, k1, 0.5, context=context)]
            + interp.upsample(k0, k1, factor=5, context=context), expected, name))
        with torch.inference_mode():  # the frame from the same flows (phase 6)
            flows = model.window_flows(fwd_t, keys_t, bwd_t, z)
            got = model.from_flows(*flows, keys_t, tt, perms=perms)[0].cpu().numpy()
            with plain_versions():
                want = model.from_flows(*flows, keys_t, tt, perms=perms)[0].cpu().numpy()
        p999, mx = agreement(got, want, f"{name} frame vs plain, same flows")
        check(p999 <= 1e-3 and mx <= 0.25, f"{name}: frame disagrees with the plain forward")
        latency(lambda: interp(k0, k1, 0.5, context=context), card, name)
        device_share(lambda: interp(k0, k1, 0.5, context=context))
        del interp, model, flows
    out.append(variant_train(card))
    out.append(variant_cli())
    attention_widths(card)
    for kname, entry in (("attention_wide", "pci_attention_wide_attrs"),
                         ("attention_bwd_wide", "pci_attention_bwd_wide_attrs")):
        print(f"kernel resources {kname} (d = 128): {resources_text(kernel_attrs(entry))}")
    return out


def variant_train(card: str) -> dict:
    """ISAPCInet field 1 at 128 (Tnet, the flow frozen) training at the
    trainer's defaults (phase 7's batch at field 1): one plain step's
    dispatches against PER_STEP_FIELD1 and its attention calls (forward and
    backward) against their plain versions; one step through the kernels
    against the plain step from the same flows, permutations and FPS starts
    (phase 7's limits); five steps with their launch counts, ms/step, peak
    memory."""
    from pci_tpu_torch.convert import load_npz_tree, load_subtrees
    from pci_tpu_torch.models import ISAPCInet
    from pci_tpu_torch.ops.cuda_kernels import launch_counts, plain_versions, reset_launch_counts
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS, init_weights
    from pci_tpu_torch.train import make_interp_train_step, make_optimizer

    dev = torch.device("cuda")
    batch = train_batch(dev, field=1)
    base = ISAPCInet(1, ff_out_c=128, tr_out_c=128)
    init_weights(base, 0)
    load_subtrees(base, load_npz_tree(DEFAULT_WEIGHTS))
    base = base.to(dev)

    def trainer():
        model = copy.deepcopy(base)
        opt = make_optimizer(TRAIN_LR, model, ("flow",))
        return model, make_interp_train_step(model, opt, ("flow",))

    def draws():
        return torch.Generator(device=dev).manual_seed(7)

    calls = []
    _, step = trainer()
    with plain_versions(), record_calls(calls):
        step(batch, draws(), TRAIN_MOMENTUM)
    counts = dispatch_counts(calls)
    check(counts == PER_STEP_FIELD1, f"field 1 at 128 step dispatches {counts}, expected "
                                     f"{PER_STEP_FIELD1}")
    att = [c for c in calls if c[0] in ("attention", "attention_bwd")]
    hold_kernels(att, len(att), per(attention=2, attention_bwd=2), new_totals(),
                 "field 1 at 128 train", unit="step")
    del calls, att
    with torch.no_grad():
        flows = base.window_flows(batch["forward"], batch["keys"], batch["backward"],
                                  batch["ini"])
    losses, grads = [], []
    for plain in (False, True):
        model, step = trainer()
        model.window_flows = lambda *a, f=flows: f
        with plain_versions() if plain else contextlib.nullcontext():
            losses.append(step(batch, draws(), TRAIN_MOMENTUM).item())
        grads.append({n: p.grad for n, p in model.named_parameters() if p.requires_grad})
        del model, step
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    print(f"field 1 at 128 train step loss: kernels {losses[0]!r}, plain {losses[1]!r} "
          f"(rel {rel:.3g})")
    check(rel <= 1e-4, "field 1 at 128: the step's loss disagrees with the plain step's")
    compare_grads(*grads)
    del grads
    model, step = trainer()
    gen = torch.Generator(device=dev).manual_seed(11)
    step(batch, gen, TRAIN_MOMENTUM)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    marks, out = [], []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out.append(step(batch, gen, TRAIN_MOMENTUM))
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    counts = launch_counts()
    losses = [float(x) for x in out]
    check(all(np.isfinite(losses)), "field 1 at 128 train: a loss is not finite")
    check(counts == {k: v * 5 for k, v in PER_STEP_FIELD1.items()},
          f"field 1 at 128 train launch counts {counts} != {PER_STEP_FIELD1} x 5")
    step_ms = [a.elapsed_time(b) for a, b in marks]
    print(f"field 1 at 128 train: 5 steps, losses {losses}, launches {counts}; on {card}: "
          f"{statistics.median(step_ms):.3f} ms/step (CUDA events, median of 5 after a "
          f"warm-up step), peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    device_share(lambda: step(batch, gen, TRAIN_MOMENTUM), requests=3, unit="step")
    return counts


def variant_cli() -> dict:
    """python -m pci_tpu_torch.cli.test --field 2 --use_tnet 0 --ff_out_c
    96 --tr_out_c 96 (noT_96, chamfer only) over phase 9's scene (26
    frames of 24,000 points, seed 0: one window at interval 5, its four
    times), with the launch counts set to 0 just before: PER_WINDOW_ISAPCI a
    record, every CD finite; the seconds a record."""
    import tempfile
    from pathlib import Path

    from pci_tpu_torch.cli import test as isapci_cli
    from pci_tpu_torch.data import generate_scenes
    from pci_tpu_torch.ops.cuda_kernels import launch_counts, reset_launch_counts
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        generate_scenes(str(root / "window"), n_scenes=1, n_frames=26, npts=24000, seed=0)
        argv = ["--root", str(root / "window" / "lidar"),
                "--scenes_list", str(root / "window" / "scenes.txt"),
                "--scene_split_lib", str(root / "window" / "split"), "--field", "2",
                "--use_tnet", "0", "--ff_out_c", "96", "--tr_out_c", "96", "--npoints", "16000",
                "--interval", "5", "--sample_method", "random", "--pretrained_flow_model",
                str(DEFAULT_WEIGHTS), "--log_dir", str(root / "log")]
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        isapci_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        with open(root / "log" / "metrics.jsonl") as f:
            recs = [json.loads(line) for line in f if line.strip()]
    check(len(recs) == EVAL_WINDOWS and all(np.isfinite(r["cd"]) for r in recs),
          f"noT_96 cli: {len(recs)} records {recs}")
    want = {k: v * len(recs) for k, v in PER_WINDOW_ISAPCI.items()}
    check(counts == want, f"noT_96 cli launch counts {counts} != {want}")
    steps = [b["time"] - a["time"] for a, b in zip(recs, recs[1:])]
    print(f"eval cli noT_96 (cli.test --field 2 --use_tnet 0 --ff_out_c 96 --tr_out_c 96): "
          f"{len(recs)} records, mean CD {np.mean([r['cd'] for r in recs]):.6f}, "
          f"{statistics.median(steps):.3f} s a record (median of records 2-{len(recs)}), "
          f"{wall:.3f} s the whole run; launches {counts}")
    return counts


@contextlib.contextmanager
def emd_calls(calls: list):
    """Record every EMD the eval CLIs compute: CUDA events around each
    ``ops.emd`` call, and each auction's inputs, passes, hops and
    ``converged`` (through the auction's ``return_prices`` hook)."""
    emd_mod = importlib.import_module("pci_tpu_torch.ops.emd")
    ops_pkg = importlib.import_module("pci_tpu_torch.ops")
    real_auction, real_emd = emd_mod.auction, ops_pkg.emd

    def auction(xyz1, xyz2, eps, max_passes):
        dist, assign, conv, _, info = real_auction(xyz1, xyz2, eps, max_passes,
                                                   return_prices=True)
        calls[-1]["auctions"].append({"xyz1": xyz1.detach().clone(), "xyz2": xyz2.detach().clone(),
                                      "converged": bool(conv), **info})
        return dist, assign, conv

    def emd(*args, **kw):
        calls.append({"auctions": []})
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_emd(*args, **kw)
        end.record()
        end.synchronize()
        calls[-1]["ms"] = start.elapsed_time(end)
        return out

    emd_mod.auction, ops_pkg.emd = auction, emd
    try:
        yield
    finally:
        emd_mod.auction, ops_pkg.emd = real_auction, real_emd


def run_cli(name: str, main_fn, argv: list, per_window: dict, log_dir) -> tuple:
    """One eval CLI run on the card, as a user runs it, with the launch
    counts set to 0 just before and read just after: every window's CD and
    EMD finite, the model's kernels launched ``per_window`` times a window,
    the auction's pass and chase once a pass of each EMD (at least once
    each).  Prints the means, each EMD's converged flag, passes, hops and
    ms, the seconds a window and the launches."""
    from pci_tpu_torch.ops.cuda_kernels import launch_counts, reset_launch_counts

    calls = []
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with emd_calls(calls):
        main_fn(argv + ["--log_dir", str(log_dir)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    with open(log_dir / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f if line.strip()]
    auctions = [a for c in calls for a in c["auctions"]]
    check(len(recs) == EVAL_WINDOWS and len(calls) == EVAL_WINDOWS
          and len(auctions) == EVAL_WINDOWS, f"{name}: {len(recs)} records, {len(calls)} EMDs, "
                                             f"{len(auctions)} auctions")
    check(all(np.isfinite(r["cd"]) and np.isfinite(r["emd"]) for r in recs), f"{name}: a metric "
                                                                           "is not finite")
    model = {k: v for k, v in counts.items() if k not in AUCTION}
    want = {k: v * EVAL_WINDOWS for k, v in per_window.items() if k not in AUCTION}
    check(model == want, f"{name} launch counts {model} != {want}")
    passes = [a["passes"] for a in auctions]
    check(all(p >= 1 for p in passes) and counts["auction_pass"] == sum(passes)
          and counts["auction_chase"] == sum(passes),
          f"{name}: auction launches {counts['auction_pass']}/{counts['auction_chase']} for "
          f"passes {passes}")
    steps = [b["time"] - a["time"] for a, b in zip(recs, recs[1:])]
    print(f"eval cli {name}: {len(recs)} windows, mean CD {np.mean([r['cd'] for r in recs]):.6f}, "
          f"mean EMD {np.mean([r['emd'] for r in recs]):.4f}; per EMD: converged "
          f"{[a['converged'] for a in auctions]}, passes {passes}, hops "
          f"{[a['hops'] for a in auctions]}, ms {[round(c['ms'], 3) for c in calls]} (CUDA "
          f"events); {statistics.median(steps):.3f} s a window (median of windows 2-"
          f"{len(recs)}), {wall:.3f} s the whole run; launches {counts}")
    return counts, auctions


@contextlib.contextmanager
def timed_steps(times: dict):
    """CUDA events around each pass and each chase the auction's host loop
    dispatches (to the kernels, or to the plain versions)."""
    from pci_tpu_torch.ops.cuda_kernels import auction_cuda

    real = {name: getattr(auction_cuda, name) for name in AUCTION}

    def timed(name):
        def step(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real[name](*args, **kw)
            end.record()
            times[name].append((start, end))
            return out
        return step

    for name in AUCTION:
        setattr(auction_cuda, name, timed(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(auction_cuda, name, fn)


def timed_auction(x1, x2, plain: bool):
    """One whole auction (ops.emd's eps and pass budget) with each step
    timed: ``(dist, assign, converged, prices, info, {step: ms summed})``."""
    from pci_tpu_torch.ops.cuda_kernels import auction_cuda, plain_versions

    times = {name: [] for name in AUCTION}
    with plain_versions() if plain else contextlib.nullcontext(), timed_steps(times):
        out = auction_cuda.auction(x1, x2, EMD_EPS, 256, return_prices=True)
    torch.cuda.synchronize()
    return (*out, {name: sum(s.elapsed_time(e) for s, e in ts) for name, ts in times.items()})


def fresh_state(n: int, dev) -> list:
    """The auction's state before its first pass: prices, assignment, owners."""
    return [torch.zeros(n, device=dev), torch.full((n,), -1, dtype=torch.int32, device=dev),
            torch.full((n,), -1, dtype=torch.int32, device=dev)]


def hold_steps(x1, x2, where: str) -> list:
    """The auction kernels against their plain versions on one pair, bit
    for bit (prices, assignments, owners, bidder and hop counts), after
    each of the first two passes and chases from the empty state at eps
    0.25; returns the bidder and hop counts."""
    from pci_tpu_torch.ops.cuda_kernels import auction_cuda as A

    q, k, _ = A.normalise(x1, x2)
    with torch.inference_mode():
        sk, sp = fresh_state(x1.shape[0], x1.device), fresh_state(x1.shape[0], x1.device)
        counts = []
        for r in range(2):
            for step in AUCTION:
                got = getattr(A, f"{step}_kernel")(q, k, *sk, A.EPS0)
                want = getattr(A, f"{step}_plain")(q, k, *sp, A.EPS0)
                torch.cuda.synchronize()
                counts.append(int(want))
                check(int(got) == int(want) and all(torch.equal(a, b) for a, b in zip(sk, sp)),
                      f"{step} at {where}, round {r + 1}: the kernel's state differs from the "
                      "plain version's")
    return counts


def stages_auction(x1, x2, where: str, card: str) -> None:
    """The `stages auction` line of one whole auction (ops.emd's eps and
    pass budget) at the main path's shape: the cluster chase's C and
    shared memory a CTA; the chase's and the pass's device time (their
    kernels under torch.profiler) over the hops and the tiles; then the
    same run with the kernels' %globaltimer stamps on, every launch's
    summed: a hop's scan (thread 0 of CTA 0, warp reduction included),
    publishing its partials, the cluster barrier with the partials' wait,
    the merge and update, and the helper warp's search and point fetch
    beside them; a pass tile's scan, block merge and bids, two grid
    barriers and phase C (block means)."""
    from torch.profiler import ProfilerActivity, profile

    from pci_tpu_torch.ops.cuda_kernels import auction_cuda as A

    n = x1.shape[0]
    check(A.chase_cluster_ok(n, n), f"stages auction at {where}: n = {n} is not on the cluster "
                                    "route")
    shape = A.cluster_shape(n, n)
    tiles = -(-n // A.TQ)
    with torch.inference_mode():
        A.auction(x1, x2, EMD_EPS, 256)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, _, _, _, info = A.auction(x1, x2, EMD_EPS, 256, return_prices=True)
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        dev_ms = {"pass": 0.0, "chase": 0.0}
        for e in prof.key_averages():
            if e.device_type == cuda and "auction_pass_kernel" in e.key:
                dev_ms["pass"] += e.self_device_time_total / 1e3
            if e.device_type == cuda and "auction_chase_cluster_kernel" in e.key:
                dev_ms["chase"] += e.self_device_time_total / 1e3
        pass_st = torch.zeros((A.TQ // 2, A.PASS_STAMPS), dtype=torch.int64, device=x1.device)
        chase_st = torch.zeros(A.CHASE_STAMPS, dtype=torch.int64, device=x1.device)
        real = A.auction_pass, A.auction_chase  # the host loop's dispatch

        def stamped_pass(*args):
            st = torch.zeros_like(pass_st)
            out = A.auction_pass_kernel(*args, stamps=st)
            pass_st.add_(st)
            return out

        def stamped_chase(*args):
            st = torch.zeros_like(chase_st)
            out = A.auction_chase_kernel(*args, stamps=st)
            chase_st.add_(st)
            return out

        A.auction_pass, A.auction_chase = stamped_pass, stamped_chase
        try:
            _, _, _, _, info_st = A.auction(x1, x2, EMD_EPS, 256, return_prices=True)
        finally:
            A.auction_pass, A.auction_chase = real
        torch.cuda.synchronize()
    check(info_st == info, f"stages auction at {where}: the stamped run differs {info_st} {info}")
    hops, passes = max(info["hops"], 1), info["passes"]
    hop = [float(v) / hops / 1e3 for v in chase_st.cpu()]
    tile = (pass_st.double().cpu() / (passes * tiles) / 1e3).mean(0).tolist()
    if not dev_ms["chase"]:
        print(f"stages auction at {where}: device time not measured (the profiler saw no "
              "auction kernel)")
    print(f"stages auction at {where} ({card}): chase on a cluster of C={shape['C']} CTAs, "
          f"{shape['smem']} dynamic shared bytes a CTA ({shape['clusters']} such clusters fit); "
          f"{passes} passes, {info['hops']} hops; device: chase {dev_ms['chase']:.3f} ms = "
          f"{1e3 * dev_ms['chase'] / hops:.4f} us a hop, pass {dev_ms['pass']:.3f} ms = "
          f"{1e3 * dev_ms['pass'] / (passes * tiles):.4f} us a tile ({tiles} tiles a pass); "
          f"%globaltimer split, us a hop: scan {hop[0]:.4f}, publish {hop[1]:.4f}, cluster "
          f"barrier and partials {hop[2]:.4f}, merge and update {hop[3]:.4f} (the merge "
          f"{hop[5]:.4f}); helper search and fetch {hop[4]:.4f}; us a tile: scan {tile[0]:.4f}, "
          f"merge and bids {tile[1]:.4f}, barrier {tile[2]:.4f}, C {tile[3]:.4f}, barrier "
          f"{tile[4]:.4f}")


def hold_auction(x1, x2, where: str, whole: bool, totals: dict | None = None,
                 scipy_optimum: bool = False) -> None:
    """The auction kernels against their plain versions on one pair: bit
    for bit (prices, assignments, owners, bidder and hop counts) after each
    of the run's first two passes and chases; over the whole run when
    ``whole`` (distances, assignment, prices, passes, hops, converged);
    the certificate (primal minus the prices' dual bound within
    n (1.0001 eps + 1e-5), printed beside the primal, both normalised by
    d_scale) on a converged run.  The certificate is loose where the
    normalised primal is below its bound, as at 1,024 points, so at
    ``scipy_optimum`` the cost is also held within ``COST_OVER_OPTIMUM`` of
    scipy's optimum, which a wrong assignment fails.  Adds the kernels'
    and plain versions' step times and bounds to ``totals``."""
    from pci_tpu_torch.ops.cuda_kernels import auction_cuda as A

    n = x1.shape[0]
    counts = hold_steps(x1, x2, where)
    _, _, d_scale = A.normalise(x1, x2)
    with torch.inference_mode():
        dk, ak, ck, pk, ik, ms = timed_auction(x1, x2, plain=False)
        gap = A.duality_gap(x1, x2, ak, pk)
    bound = n * (1.0001 * EMD_EPS + 1e-5)
    converged = bool(ck)
    cost = float(dk.double().sum())
    print(f"auction at {where}: kernel = plain bit for bit after each of the first 2 passes and "
          f"chases (bidders, hops {counts}); kernel run: converged {converged}, "
          f"{ik['passes']} passes, {ik['hops']} hops, final eps {ik['eps']:.6g}, pass "
          f"{ms['auction_pass']:.3f} ms + chase {ms['auction_chase']:.3f} ms (CUDA events), "
          f"cost {cost:.6g}; normalised by d_scale {float(d_scale):.6g}: primal "
          f"{cost / float(d_scale):.6g}, certificate gap {gap:.6g} of bound {bound:.6g}")
    if converged:
        check(gap <= bound and len(set(ak.tolist())) == n,
              f"auction at {where}: certificate gap {gap} > {bound}")
    if scipy_optimum:
        from scipy.optimize import linear_sum_assignment

        a, b = x1.double().cpu().numpy(), x2.double().cpu().numpy()
        dm = ((a[:, None, :] - b[None]) ** 2).sum(-1)
        rows, cols = linear_sum_assignment(dm)
        opt = float(dm[rows, cols].sum())
        slack = bound * float(d_scale)
        print(f"auction at {where}: cost {cost:.6g}, scipy optimum {opt:.6g} (x{cost / opt:.4f}, "
              f"held to x{COST_OVER_OPTIMUM}), certificate {slack:.6g}")
        check(opt - 1e-3 <= cost <= min(opt + slack, COST_OVER_OPTIMUM * opt),
              f"auction at {where}: cost {cost} not within x{COST_OVER_OPTIMUM} nor {slack} of "
              f"the optimum {opt}")
    plain_ms = None
    if whole:
        with torch.inference_mode():
            dp, ap, cp, pp, ip, plain_ms = timed_auction(x1, x2, plain=True)
        same = (torch.equal(dk, dp) and torch.equal(ak, ap) and torch.equal(pk, pp)
                and converged == bool(cp) and ik == ip)
        print(f"auction at {where}: whole run kernel = plain bit for bit {same}; plain pass "
              f"{plain_ms['auction_pass']:.3f} ms + chase {plain_ms['auction_chase']:.3f} ms")
        check(same, f"auction at {where}: the whole run differs from the plain version's")
    if totals is not None:  # the main path's shape: the device's busy share over one EMD
        device_share(lambda: A.auction(x1, x2, EMD_EPS, 256), requests=1, unit="EMD")
    # the bound: 8 operations a (row, column) pair a pass, 8 a key a hop;
    # bytes: the two clouds read, prices / assignment / owners read and
    # written, once a launch
    work_ = {"auction_pass": (48.0 * n * ik["passes"], 8.0 * n * n * ik["passes"]),
             "auction_chase": (48.0 * n * ik["passes"], 8.0 * n * ik["hops"])}
    for name, (nb, ops) in work_.items():
        bytes_ms, ops_ms = bound_terms(nb, ops)
        print(f"kernel {name:13s} n={n} passes={ik['passes']} hops={ik['hops']} "
              f"ms={ms[name]:.4f} plain_ms="
              + (f"{plain_ms[name]:.4f}" if plain_ms else "not run")
              + f" bound_ms={max(bytes_ms, ops_ms):.6f} "
              f"({'bytes' if bytes_ms > ops_ms else 'operations'}) max_abs_err=0 library_ms=none")
        if totals is not None:
            t = totals[name]
            t["ms"] += ms[name]
            t["plain_ms"] += plain_ms[name]
            t["bytes_ms"] += bytes_ms
            t["ops_ms"] += ops_ms


def dup_pair(seed: int, n: int):
    """synthetic_pair with 10% of the second cloud's points exact
    duplicates of others (the share of duplicates in real LiDAR scans)."""
    a, b = synthetic_pair(seed, n)
    rng = np.random.default_rng(seed + 100)
    k = n // 10
    b[n - k:] = b[rng.integers(0, n - k, k)]
    return a, b


def phase_eval(totals: dict) -> list:
    """The eval CLIs with the EMD metric, run as a user runs them on
    seeded synthetic scenes; then the auction kernels held against their
    plain versions at 1,024 points (a seeded pair) and at each CLI's first
    EMD (its frame against its ground truth)."""
    import tempfile
    from pathlib import Path

    from pci_tpu_torch.cli import test as isapci_cli
    from pci_tpu_torch.cli import test_pointinet as pointinet_cli
    from pci_tpu_torch.data import generate_scenes
    from pci_tpu_torch.ops.cuda_kernels import auction_cuda as A
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        paths = {}
        for name, frames, seed in (("window", 26, 0), ("triplet", 6, 1)):
            generate_scenes(str(root / name), n_scenes=1, n_frames=frames, npts=24000, seed=seed)
            paths[name] = ["--root", str(root / name / "lidar"),
                           "--scenes_list", str(root / name / "scenes.txt"),
                           "--scene_split_lib", str(root / name / "split")]
        for log in ("log_isapci", "log_pointinet", "log_pointinet_intensity"):
            (root / log).mkdir()
        isapci = run_cli("isapci field=2 (cli.test --emd)", isapci_cli.main,
                         paths["window"] + ["--field", "2", "--npoints", "16000", "--interval",
                                            "5", "--sample_method", "random", "--emd",
                                            "--pretrained_flow_model", str(DEFAULT_WEIGHTS)],
                         PER_WINDOW_ISAPCI, root / "log_isapci")
        pointinet = run_cli("pointinet (cli.test_pointinet)", pointinet_cli.main,
                            ["--dataset_name", "nuscenes"] + paths["triplet"]
                            + ["--npoints", "16384", "--interval", "5", "--use_intensity", "0",
                               "--pretrained_interp_model", str(DEFAULT_WEIGHTS)],
                            PER_TRIPLET, root / "log_pointinet")
        # the CLI at its default, --use_intensity 1: [N, 4] clouds
        intensity = run_cli("pointinet intensity (cli.test_pointinet, its default "
                            "--use_intensity 1)", pointinet_cli.main,
                            ["--dataset_name", "nuscenes"] + paths["triplet"]
                            + ["--npoints", "16384", "--interval", "5",
                               "--pretrained_interp_model", str(DEFAULT_WEIGHTS)],
                            PER_TRIPLET, root / "log_pointinet_intensity")
    dev = torch.device("cuda")
    a, b = (torch.from_numpy(x).to(dev) for x in dup_pair(3, 1024))
    hold_auction(a, b, "1,024 (seeded pair, 10% duplicates)", whole=True, scipy_optimum=True)
    first = isapci[1][0]
    hold_auction(first["xyz1"], first["xyz2"], "16,000 (isapci window 1 vs its ground truth)",
                 whole=False)
    for n, seed, want in ((4099, 5, "cluster"), (A.CHASE_CLUSTER_MAX_N + 232, 9, "one block")):
        a, b = (torch.from_numpy(x).to(dev) for x in dup_pair(seed, n))
        route = "cluster" if A.chase_cluster_ok(n, n) else "one block"
        check(route == want, f"auction at {n}: the chase's route is {route}, not {want}")
        counts = hold_steps(a, b, f"{n:,} (seeded pair, 10% duplicates)")
        print(f"auction at {n:,} (seeded pair, 10% duplicates; the chase on {route}): "
              f"kernel = plain bit for bit after each of the first 2 passes and chases "
              f"(bidders, hops {counts})")
    first = pointinet[1][0]  # last: the resources lines read the last launch's shape
    hold_auction(first["xyz1"], first["xyz2"], "16,384 (pointinet triplet 1 vs its ground "
                 "truth)", whole=True, totals=totals)
    stages_auction(first["xyz1"], first["xyz2"], "16,384 (pointinet triplet 1)", card_line())
    return [isapci[0], pointinet[0], intensity[0]]


# rows 4, 4b and 7 past k = 64 (their k <= 128 kernels, four slots a lane;
# row 7's streaming kernel): (N, k, t, Cp) as FUSION64_HOLDS, at k = 65, 96
# and 128 at the requests' 16,384 and 65,536 points, t near 0 and 1 (a
# segment's budget past 64), segments shorter than their budgets, payloads
# of 1 and 2 channels; row 4b at F = 3 and 4 (PointsFusionMulti's weights)
FUSION128_HOLDS = ((16384, 65, 0.5, 0), (16384, 96, 0.3, 1), (16384, 128, 0.6, 2),
                   (65536, 65, 0.4, 0), (65536, 96, 0.5, 1), (65536, 128, 0.7, 0),
                   (4096, 128, 0.02, 0), (4096, 128, 0.98, 1), (2048, 128, (20, 100, 28), 0),
                   (3000, 96, (2950, 30, 66), 2))
FUSION128_MULTI_HOLDS = ((16384, 128, (0.3, 0.2)), (16384, 96, (0.2, 0.3, 0.1)),
                         (4096, 128, (0.6, 0.1, 0.1)))
# row 7 at k = 160, past the flat kernels (PointsFusion's eval tail after the
# kNN's plain version): (B, N, k, Ce)
TAIL_K160_HOLDS = ((1, 16384, 160, 0), (1, 4096, 160, 1))


def hold_fusion_k128(card: str) -> None:
    """Rows 4, 4b and 7 at FUSION128_HOLDS / FUSION128_MULTI_HOLDS
    (hold_fusion_rows, timed; row 4b's k > 64 kernel takes no parts), row
    7 at TAIL_K160_HOLDS as
    hold_fusion_tail holds it, then the new kernels' resources."""
    from pci_tpu_torch.ops.cuda_kernels._build import kernel_attrs
    from pci_tpu_torch.ops.cuda_kernels.fusion_tail_cuda import fusion_tail_kernel, fusion_tail_plain

    from pci_tpu_torch.ops.cuda_kernels._build import PackedLayers

    hold_fusion_rows(card, "k128", FUSION128_HOLDS, FUSION128_MULTI_HOLDS, 1900, (0,), timed=True)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1901)
    layers = PackedLayers(seeded_score_mlp(g, dev))
    for B, N, k, Ce in TAIL_K160_HOLDS:
        combined = (torch.randn(B, N, 3, generator=g) * 10).to(dev)
        resi = torch.randn(B, N, k, 3, generator=g).to(dev)
        resi[:, ::7, k // 2:] = 0.0  # unfilled slots: zero residuals, still active
        extra = torch.randn(B, N, k, Ce, generator=g).to(dev) if Ce else None
        where = f"B={B} N={N} k={k} Ce={Ce}"
        with torch.inference_mode():
            got = fusion_tail_kernel(combined, resi, extra, layers)
            torch.cuda.synchronize()
            want = fusion_tail_plain(combined, resi, extra, layers)
            ms = cuda_ms(lambda: fusion_tail_kernel(combined, resi, extra, layers), 5)
            plain_ms = cuda_ms(lambda: fusion_tail_plain(combined, resi, extra, layers), 1)
        err = compare("fusion_tail", got, want, f"hold {where}")
        e_k, e_32, e_tf = tail_sum_errors(resi, extra, layers)
        print(f"fusion_tail hold {where}: max |kernel - plain| {err:.3g} (<= 1e-4); weighted "
              f"sums vs fp64: kernel {e_k:.3g} (<= {TAIL_SUM_LIMIT:g}), plain fp32 {e_32:.3g}, "
              f"plain 1xTF32 {e_tf:.3g}; {ms:.4f} ms (plain {plain_ms:.4f} ms) on {card}")
        check(e_k <= TAIL_SUM_LIMIT and e_k < e_tf,
              f"fusion_tail hold {where}: weighted sums {e_k} from fp64")
    for kname, entry in (("fusion", "pci_fusion128_attrs"),
                         ("fusion", "pci_fusion128_payload_attrs"),
                         ("fusion_resi", "pci_fusion_resi128_attrs"),
                         ("fusion_tail", "pci_fusion_tail_stream_attrs")):
        print(f"kernel resources {kname} at k <= 128 ({entry}): "
              f"{resources_text(kernel_attrs(entry))}")


def fusion_request(card: str, totals: dict, path: str, model, args, kw, expected: dict,
                   kinds, width: int, n: int) -> dict:
    """One model's request through its forward: a plain call's dispatches
    against ``expected``, its calls of ``kinds`` held against their plain
    versions (timed, their bounds; `stages fusion128` lines for the fusion
    calls past k = 64); then five requests with the counts set to 0 before
    and read after, the frame against the plain forward with the same
    ``kw`` (permutations), ms a frame by CUDA events."""
    from pci_tpu_torch.ops.cuda_kernels import plain_versions

    calls = []
    with torch.inference_mode(), plain_versions(), record_calls(calls):
        model(*args, **kw)
    got = dispatch_counts(calls)
    check(got == expected, f"{path}: dispatches {got}, expected {expected}")
    held = [c for c in calls if c[0] in kinds]
    hold_kernels(held, len(held), per(**{k_: expected[k_] for k_ in kinds}), totals, path)
    fusion_stages_lines(held, card, path, "fusion128", 64)
    del calls, held

    def serve(**kw_):
        with torch.inference_mode():
            return model(*args, **kw_)[0].cpu().numpy()

    serve()  # warm-up
    counts = serve_counts(lambda: [serve() for _ in range(5)], expected, path, npoints=n,
                          width=width)
    got = serve(**kw)
    with plain_versions():
        want = serve(**kw)
    p999, mx = agreement(got, want, f"{path} frame vs plain")
    check(p999 <= 1e-3 and mx <= 0.25, f"{path}: frame disagrees with the plain forward")
    latency(serve, card, f"{path} (model call)")
    return counts


def phase_fusion_k128(card: str, totals: dict) -> list:
    """The fusion at k in 65-128 through the models' fields (phase 13):
    the kernel holds (hold_fusion_k128), then requests on the default route
    (fusion_request): PointINet(fusion_k=128) at 16,384 and 65,536 points,
    xyz and with a seeded intensity channel, at 16,384 xyz also with
    one-shot off (rows 4b and 7 past k = 64); PointINet2(field=2,
    fusion_k=128) at 16,384; ISAPCInet(field=2, fusion_k=96,
    fusion_sampling="fps") at 16,384 (its FPS orders over all points held
    too; from the same flows, as phase 6 holds it, its warped clouds
    against the plain route's and its fusion on the same warped clouds
    against the plain route, since FPS over warped clouds that differ by
    rounding may order a point elsewhere)."""
    from pci_tpu_torch.convert import flax_to_state_dict, load_npz_tree
    from pci_tpu_torch.models import PointINet
    from pci_tpu_torch.ops.cuda_kernels import plain_versions
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS, Interpolator

    hold_fusion_k128(card)
    dev = torch.device("cuda")
    paths = []
    tree = flax_to_state_dict(load_npz_tree(DEFAULT_WEIGHTS))
    for n in (NPOINTS, LARGE_N[0]):
        model = PointINet(fusion_k=128)
        model.load_state_dict(tree)
        model = model.to(dev).eval()
        perms = tuple(torch.randperm(n, generator=torch.Generator().manual_seed(s))[None].to(dev)
                      for s in (1, 2))
        z = torch.zeros(1, n, 3, device=dev)
        t = torch.tensor([0.5], device=dev)
        for width in (3, 4):
            a, b = (torch.from_numpy(x[:, :width].copy())[None].to(dev)
                    for x in intensity_pair(n))
            path = f"pointinet k=128 {n} {'xyz' if width == 3 else 'intensity'}"
            paths.append(fusion_request(card, totals, path, model, (a, b, z, z, t),
                                        {"perms": perms}, PER_REQUEST_K128, ("fusion",), width,
                                        n))
            if n == NPOINTS and width == 3:  # rows 4b and 7 past k = 64 on a request
                with gates(ONESHOT_OFF):
                    paths.append(fusion_request(
                        card, totals, f"{path}, one-shot off", model, (a, b, z, z, t),
                        {"perms": perms}, PER_REQUEST_K128_ONESHOT_OFF,
                        ("fusion_resi", "fusion_tail"), width, n))
        del model
        torch.cuda.empty_cache()

    model = pointinet2_model(dev, fusion_k=128)
    fwd, (k0, k1), bwd, _ = synthetic_window(NPOINTS)
    T = lambda x: torch.from_numpy(x)[None].to(dev)  # noqa: E731
    args = ([T(x) for x in fwd], [T(k0), T(k1)], [T(x) for x in bwd],
            torch.tensor([0.5], device=dev), torch.zeros(1, NPOINTS, 3, device=dev))
    g = torch.Generator().manual_seed(1301)
    perms = [torch.randperm(NPOINTS, generator=g)[None].to(dev)
             for _ in range(2 + 2 * FIELD + FIELD + 1)]
    paths.append(fusion_request(card, totals, f"pointinet2 k=128 {NPOINTS}", model, args,
                                {"perms": perms}, PER_REQUEST_POINTINET2_K128, FUSION_KINDS, 3,
                                NPOINTS))
    del model
    torch.cuda.empty_cache()

    model = Interpolator.isapci(field=FIELD, npoints=NPOINTS, weights=DEFAULT_WEIGHTS,
                                device="cuda", fusion_k=96, fusion_sampling="fps").model
    path = f"isapci k=96 fps {NPOINTS}"
    calls = []
    with torch.inference_mode(), plain_versions(), record_calls(calls):
        model(*args)
    got = dispatch_counts(calls)
    check(got == PER_REQUEST_ISAPCI_FPS, f"{path}: dispatches {got}, expected "
                                         f"{PER_REQUEST_ISAPCI_FPS}")
    # the fusion's FPS orders (npoint = N) and its one-shot call
    held = [c for c in calls if c[0] == "fusion" or c[0] == "fps" and c[2][1] == NPOINTS]
    check(len(held) == 3, f"{path}: {len(held)} FPS-over-all-points and fusion calls")
    hold_kernels(held, len(held), per(fps=2, fusion=1), totals, path)
    fusion_stages_lines(held, card, path, "fusion128", 64)
    del calls, held

    def serve():
        with torch.inference_mode():
            return model(*args)[0].cpu().numpy()

    serve()  # warm-up
    paths.append(serve_counts(lambda: [serve() for _ in range(5)], PER_REQUEST_ISAPCI_FPS, path))
    # the request's flows, then the rest of its forward on the kernel route
    # with the fusion's FPS orders and warped clouds recorded, and the plain
    # versions' from the same flows on those orders: FPS over all points
    # may order a near-tied point of a warped cloud elsewhere on rounding
    # alone, which moves it across the cloud's sampled prefix (and
    # PointNet++'s picks over the flow cloud flip as phase 4 says)
    orders, warped = [], []
    fps_orders = model.fusion._orders
    model.fusion._orders = lambda *a: orders.append(fps_orders(*a)) or orders[-1]
    hook = model.fusion.register_forward_pre_hook(lambda mod, a: warped.append(a))
    try:
        with torch.inference_mode():
            flows = model.window_flows(*args[:3], args[4])
            got = model.from_flows(*flows, args[1], args[3])[0].cpu().numpy()
            with plain_versions():
                want = model.from_flows(*flows, args[1], args[3],
                                        perms=orders[0])[0].cpu().numpy()
                whole = model(*args, perms=orders[0])[0].cpu().numpy()
    finally:
        hook.remove()
        del model.fusion._orders
    check(len(orders) == 1 and len(warped) == 3, f"{path}: {len(orders)} FPS orders taken, "
                                                 f"{len(warped)} fusion calls")
    (w1, w2, _, _), (p1, p2, _, _) = warped[:2]
    err = max((w1 - p1).abs().max().item(), (w2 - p2).abs().max().item())
    print(f"{path} warped clouds vs plain, same flows: max {err:.3g} m")
    check(err <= 1e-5, f"{path}: the warped clouds disagree with the plain route's by {err} m")
    p999, mx = agreement(got, want, f"{path} frame vs plain, same flows and FPS orders")
    check(p999 <= 1e-3 and mx <= 0.25, f"{path}: frame disagrees with the plain forward")
    agreement(got, whole, f"{path} frame vs the whole plain forward on its FPS orders "
                          "(flows included)")
    latency(serve, card, f"{path} (model call)")
    del model
    torch.cuda.empty_cache()
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--stages"]:
        stages_only(sys.argv[2].split(",") if len(sys.argv) > 2 else STAGE_KINDS)
        return 0
    if sys.argv[1:2] == ["--ptxas"]:  # [csrc directory]: the changed sources' ptxas lines
        ptxas_lines(sys.argv[2] if len(sys.argv) > 2 else "pci_tpu_torch/csrc")
        return 0
    if sys.argv[1:2] == ["--variants"]:  # phase 12 alone
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase_variants(card_line())
        return 0
    if sys.argv[1:2] == ["--k128"]:  # phase 13 alone, with the FPS holds
        card = card_line()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        hold_fps(card)
        hold_fusion_k160(card)
        phase_fusion_k128(card, new_totals())
        return 0
    if sys.argv[1:2] == ["--setconv"]:  # row 2's holds and stages lines only
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        hold_setconv(card_line())
        return 0
    if sys.argv[1:2] == ["--attention"]:  # the attention holds and the variants' widths only
        card = card_line()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        hold_attention(card)
        hold_attention_routes(card)
        attention_widths(card)
        return 0
    from pci_tpu_torch.ops.cuda_kernels import build_seconds, plain_versions
    from pci_tpu_torch.ops.cuda_kernels._build import kernel_attrs
    from pci_tpu_torch.serving import DEFAULT_WEIGHTS, Interpolator

    start = time.perf_counter()

    def phase_time(name: str) -> None:
        print(f"phase {name} done: {time.perf_counter() - start:.1f} s since the start")

    # 1. device
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {card} | torch {torch.__version__} | cuda {torch.version.cuda} "
          f"| count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    sources = len({source for source, _ in KERNEL_INFO.values()})
    print(f"build: {build_seconds():.1f} s (nvcc, sm_90a, {sources} sources)")
    phase_time("2. build")

    # 3. kernels at PointINet's shapes
    totals = new_totals()
    interp = Interpolator.pointinet(npoints=NPOINTS, weights=DEFAULT_WEIGHTS, device="cuda")
    a_np, b_np = synthetic_pair()
    a = torch.from_numpy(a_np)[None].cuda()
    b = torch.from_numpy(b_np)[None].cuda()
    perms = phase_kernels(interp.model, a, b, totals, card)
    phase_stages(interp.model, card)
    hold_setconv(card)
    hold_fps(card)
    hold_knn_cells(card)
    hold_knn_routes(card)
    hold_nearest(card)
    hold_attention(card)
    hold_attention_routes(card)
    hold_ball(card)
    hold_fusion_resi(card)
    hold_fusion_tail(card)
    hold_fusion_k160(card)
    hold_fusion_k64(card)
    hold_fusion_payload(card)
    phase_time("3. kernels")

    # 4. serving: warm up, then count the launches of five requests
    interp(a_np, b_np, 0.5)
    counts = serve_counts(lambda: [interp(a_np, b_np, 0.5)]
                          + interp.upsample(a_np, b_np, factor=5),
                          PER_REQUEST, "pointinet")
    got = interp(a_np, b_np, 0.5, perms=perms)
    with plain_versions():
        want = interp(a_np, b_np, 0.5, perms=perms)
    # a 1e-6 difference in the flows can swap a near-tied 32nd neighbour
    p999, mx = agreement(got, want, "pointinet frame vs plain")
    check(p999 <= 1e-3 and mx <= 0.25, "served frame disagrees with the plain forward")
    latency(lambda: interp(a_np, b_np, 0.5), card, "pointinet")
    device_share(lambda: interp(a_np, b_np, 0.5))
    phase_time("4. serving")

    # 5. stream serving, and PointINet's routes with gates off
    counts_stream, counts_routes = phase_streams(interp, card, totals)
    phase_time("5. streams and routes")

    # 6. ISAPCInet field=2
    counts_isapci = phase_isapci(card, totals)
    phase_time("6. isapci")

    # 7. ISAPCInet field=2 training
    counts_train = phase_train(card, totals)
    phase_time("7. training")

    # 8. PointINet at 65,536 and 32,768 points
    counts_large = phase_large(card, totals)
    phase_time("8. large")

    # 9. the eval CLIs with the EMD metric
    counts_eval = phase_eval(totals)
    phase_time("9. eval CLIs")

    # 10. PointINet with its intensity channel, at 16,384 and 65,536 points
    counts_intensity = phase_intensity(card, totals, interp.model)
    phase_time("10. intensity")

    # 11. PointINet2 field=2 at eval: a request and the eval step, then a
    # request at 65,536 points on the cell-pruned routes and their holds
    counts_pointinet2 = phase_pointinet2(card, totals)
    counts_pointinet2 += phase_pointinet2_large(card, totals)
    hold_cells_k64(card)
    phase_time("11. pointinet2")

    # 12. ISAPCInet's published width variants: noT_96 and field 1 at 128
    counts_variants = phase_variants(card)
    phase_time("12. isapci variants")

    # 13. the fusion at k in 65-128 through the models' fusion_k and
    # fusion_sampling
    counts_k128 = phase_fusion_k128(card, totals)
    phase_time("13. fusion k128")

    paths = [counts, counts_stream, *counts_routes, *counts_isapci, counts_train, *counts_large,
             *counts_eval, *counts_intensity, *counts_pointinet2, *counts_variants,
             *counts_k128]
    for kname, entry in RESOURCE_KERNELS.items():  # the tensor-core and auction kernels
        t = totals[kname]
        print(f"kernel resources {kname}: {resources_text(kernel_attrs(entry))}; max |kernel - "
              f"plain| {t['err']:.3g}, {t['rel']:.3g} of the output's largest magnitude")
    kernels = []
    for kname, (source, replaces) in KERNEL_INFO.items():
        t = totals[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(c[kname] for c in paths),
            "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(t["bytes_ms"], t["ops_ms"]),
            "bound_by": "bytes" if t["bytes_ms"] > t["ops_ms"] else "operations",
            "library_ms": t["library_ms"],
        })
    idle = [k["name"] for k in kernels if not k["launches"]]
    check(not idle, f"kernels no served path launched: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
