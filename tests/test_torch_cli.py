"""The port's eval CLIs (``pci_tpu_torch/cli``), checkpoints and metrics log
against the JAX package's, on CPU at the tiny sizes of
``tests/test_cli.py`` (64 points, interval 3, field 1, widths 32).

- ``cli.test`` (ISAPCInet, ``--emd``) and ``cli.test_pointinet``
  (PointINet, nuScenes triplets, at ``--use_intensity 0`` and at its
  default ``--use_intensity 1``, xyz + intensity clouds) run end to end
  with ``device="cpu"`` beside the JAX CLIs, on the same weights (the
  JAX ISAPCInet's seeded init exported to npz; the trained PointINet)
  and the same fusion permutations: their ``metrics.jsonl`` records carry
  the JAX CLIs' keys, each window's CD and EMD agree with the JAX CLI's
  within 1e-3 relative, and
  each CD equals ``chamfer_per_sample`` of the port's own forward.
- ``--use_tnet 0`` over a checkpoint that holds a Tnet is refused.
- ``load_params`` / ``load_flow_into`` from the JAX variable tree as npz
  equal ``convert``'s conversion; the port's own files round-trip; an
  orbax directory is refused; ``BestKeeper.best_path`` picks the lowest
  loss; ``metrics_to_csv`` takes the union of the keys.
"""

from __future__ import annotations

import itertools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pci_tpu.nn.fusion as jfusion
import pci_tpu_torch.nn.fusion as tfusion
from pci_tpu.cli import test as jtest_cli
from pci_tpu.cli.common import build_isapci as jbuild_isapci
from pci_tpu.cli import test_pointinet as jpointinet_cli
from pci_tpu_torch.cli import test as test_cli
from pci_tpu_torch.cli import test_pointinet as pointinet_cli
from pci_tpu_torch.cli.common import build_isapci, example_from_loader
from pci_tpu_torch.convert import flax_to_state_dict, load_npz_tree
from pci_tpu_torch.data import (
    Loader,
    NuscenesInterpolationDataset,
    NuscenesTripletDataset,
    to_device,
)
from pci_tpu_torch.models import ISAPCInet, PointINet
from pci_tpu_torch.ops import chamfer_per_sample
from pci_tpu_torch.serving import DEFAULT_WEIGHTS, init_weights
from pci_tpu_torch.train import (
    BestKeeper,
    MetricLogger,
    load_flow_into,
    load_params,
    metrics_to_csv,
    save_params,
)
from tests.test_cli import make_scene
from tests.test_torch_shared import shared_result

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Ten frames: two ISAPCInet windows at field 1, six PointINet triplets."""
    p = tmp_path_factory.mktemp("scene")
    make_scene(p, n_frames=10)
    return p


def window_args(scene, extra=()):
    return ["--root", str(scene / "lidar"), "--scenes_list", str(scene / "scenes.txt"),
            "--scene_split_lib", str(scene / "split"), "--npoints", "64", "--interval", "3",
            "--field", "1", "--sample_method", "random", "--ff_out_c", "32",
            "--tr_out_c", "32", *extra]


def triplet_args(scene, extra=(), intensity: int = 0):
    return ["--dataset_name", "nuscenes", "--root", str(scene / "lidar"),
            "--scenes_list", str(scene / "scenes.txt"), "--scene_split_lib",
            str(scene / "split"), "--npoints", "64", "--interval", "3",
            "--use_intensity", str(intensity), *extra]


def records(log_dir):
    with open(log_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f if line.strip()]


# the trained PointINet: the JAX CLI reads the orbax checkpoint, the port its
# npz export (equal key for key, tests/test_torch_pointinet.py)
JAX_WEIGHTS = ["--pretrained_interp_model",
               str(Path(__file__).resolve().parents[1] / "results" / "checkpoints"
                   / "pointinet_synth16k")]
WEIGHTS = ["--pretrained_interp_model", str(DEFAULT_WEIGHTS)]
# the fusion's two permutations of the 64 points, the same in both packages
PERMS = [np.random.default_rng(70 + i).permutation(64)[None] for i in range(2)]


def fixed_perms(mp):
    """Both packages' fusion draws return ``PERMS`` in turn: each forward
    draws two, and the jitted JAX forward draws them once, when traced."""
    jdraws, tdraws = itertools.cycle(PERMS), itertools.cycle(PERMS)
    mp.setattr(jfusion, "_random_perms",
               lambda key, B, n: jnp.asarray(next(jdraws), jnp.int32))
    mp.setattr(tfusion, "random_perms",
               lambda B, N, generator, device: torch.from_numpy(next(tdraws)).to(device))


def save_npz_tree(variables, path) -> str:
    """A JAX variable tree as the flat ``/``-joined npz the port loads."""
    flat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(x)
            for kp, x in jax.tree_util.tree_flatten_with_path(variables)[0]}
    np.savez(path, **flat)
    return str(path)


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """Each CLI run once on the CPU, the JAX CLI first, on the same weights
    and fusion permutations: ``{cli: (port records, JAX records, the
    port's argv)}``, once a test run (``shared_result``).  ISAPCInet takes
    the JAX CLI's seeded init, exported to npz, as the port's
    ``--pretrained_self_model``; PointINet the trained weights, at
    ``--use_intensity 0`` and 1."""
    return shared_result("cli_runs", lambda: run_clis(scene, tmp_path_factory),
                         tmp_path_factory)


def run_clis(scene, tmp_path_factory):
    recorded = {}

    def build_and_record(args, example):
        model, variables = jbuild_isapci(args, example)
        recorded["isapci"] = variables
        return model, variables

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        fixed_perms(mp)
        mp.setattr(jtest_cli, "build_isapci", build_and_record)
        for name, jmain, main, jargs, args in (
                ("isapci", jtest_cli.main, test_cli.main, window_args(scene, ["--emd"]),
                 None),
                ("pointinet", jpointinet_cli.main, pointinet_cli.main,
                 triplet_args(scene, JAX_WEIGHTS), triplet_args(scene, WEIGHTS)),
                ("pointinet_intensity", jpointinet_cli.main, pointinet_cli.main,
                 triplet_args(scene, JAX_WEIGHTS, 1), triplet_args(scene, WEIGHTS, 1))):
            jlog = tmp_path_factory.mktemp(f"{name}_jax")
            jmain(jargs + ["--log_dir", str(jlog)])
            if args is None:
                npz = save_npz_tree(recorded["isapci"], jlog / "isapci_init.npz")
                args = jargs + ["--pretrained_self_model", npz]
            log = tmp_path_factory.mktemp(f"{name}_port")
            main(args + ["--log_dir", str(log)], device="cpu")
            out[name] = records(log), records(jlog), args
    return out


def test_cli_records_have_the_jax_keys(runs):
    """Both CLIs' records against the JAX CLIs' on the same scene and
    flags: the same keys, finite CD and EMD, one record a window."""
    for port, want, _ in runs.values():
        assert len(port) == len(want) >= 2
        for r, w in zip(port, want):
            assert r.keys() == w.keys() and "emd" in r
            assert np.isfinite(r["cd"]) and np.isfinite(r["emd"]) and r["emd"] > 0
        assert [r["step"] for r in port] == list(range(len(port)))


@pytest.mark.parametrize("cli", ["isapci", "pointinet", "pointinet_intensity"])
def test_cli_windows_match_the_jax_clis(runs, cli):
    """Each window's CD and EMD against the JAX CLI's on the same weights,
    samples and fusion permutations, both within the model-parity
    tolerance, 1e-3 relative (the outputs agree to ~1e-5; the two dense
    auctions, each within eps = 1e-3 of max D of the optimum, part by at
    most 1.3e-4 relative here)."""
    port, want, _ = runs[cli]
    for r, w in zip(port, want, strict=True):
        assert r.get("t") == w.get("t")
        assert r["cd"] == pytest.approx(w["cd"], rel=1e-3)
        assert r["emd"] == pytest.approx(w["emd"], rel=1e-3)


@pytest.mark.parametrize("cli", ["isapci", "pointinet", "pointinet_intensity"])
def test_cli_cd_is_the_forwards_chamfer(runs, scene, monkeypatch, cli):
    """Each window's logged CD is ``chamfer_per_sample`` of the model the
    CLI builds, on the dataset's window, with the run's permutations (with
    intensity: the ``[1, N, 4]`` frame's xyz against the ground truth's)."""
    fixed_perms(monkeypatch)
    if cli == "isapci":
        args = test_cli.parse_args(runs[cli][2])
        ds = NuscenesInterpolationDataset(
            args.root, args.scenes_list, args.scene_split_lib, field=1, npoints=64,
            interval=3, sample_method="random", seed=args.seed)
        model = build_isapci(args, example_from_loader(ds, "cpu"), "cpu")
    else:
        ds = NuscenesTripletDataset(str(scene / "lidar"), str(scene / "scenes.txt"),
                                    str(scene / "split"), npoints=64, interval=3,
                                    train=False, use_intensity=cli == "pointinet_intensity",
                                    seed=0)
        ds[0]  # the CLI's draw before its windows
        model = PointINet()
        init_weights(model, 0)
        load_params(str(DEFAULT_WEIGHTS), model).eval()
    got = []
    with torch.inference_mode():
        for batch in Loader(ds, 1, shuffle=False, drop_last=False):
            b = to_device(batch, "cpu")
            if cli == "isapci":
                out = model(b["forward"], b["keys"], b["backward"], b["t"], b["ini"])
                gt = b["gt"]
            else:
                out = model(b["ini_pc"], b["end_pc"], b["color"], b["color"], b["t"])
                gt = b["mid_pc"]
                assert out.shape[-1] == gt.shape[-1] == (4 if cli == "pointinet_intensity" else 3)
            got.append(float(chamfer_per_sample(out[..., :3], gt[..., :3]).mean()))
    assert got == [r["cd"] for r in runs[cli][0]]


@pytest.mark.parametrize("cli,flag", [("isapci", ["--use_tnet", "0"])])
def test_unported_options_are_refused(scene, tmp_path, cli, flag):
    """``--use_tnet 0`` builds ISAPCInet without Tnet (the noT_96 variant,
    held against the JAX CLI in tests/test_torch_variants.py); over a
    ``--pretrained_self_model`` whose weights hold a Tnet it is refused,
    not served with that Tnet dropped."""
    with_tnet = save_params(str(tmp_path / "ckpt"), ISAPCInet(field=1, ff_out_c=32,
                                                                tr_out_c=32))
    with pytest.raises(RuntimeError, match="tnet_forward"):
        test_cli.main(window_args(scene, flag + ["--pretrained_self_model", with_tnet,
                                                 "--log_dir", str(tmp_path)]), device="cpu")


def test_checkpoint_formats(tmp_path):
    """The JAX tree as npz loads as ``convert`` converts it (whole model,
    and its flow sub-tree into ISAPCInet's flow); the port's own file
    round-trips; an orbax directory is refused."""
    want = flax_to_state_dict(load_npz_tree(DEFAULT_WEIGHTS))
    model = load_params(str(DEFAULT_WEIGHTS), PointINet())
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    isapci = load_flow_into(ISAPCInet(field=1, ff_out_c=16, tr_out_c=16), str(DEFAULT_WEIGHTS))
    flow = isapci.flow.state_dict()
    assert flow.keys() == {k[5:] for k in want if k.startswith("flow.")}
    for k, v in flow.items():
        assert torch.equal(v, want["flow." + k]), k
    path = save_params(str(tmp_path / "saved"), model, step=3)
    again = load_params(path, PointINet())
    for k, v in again.state_dict().items():
        assert torch.equal(v, want[k]), k
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        load_params(str(tmp_path / "orbax_dir"), PointINet())


def test_best_keeper_and_metrics_csv(tmp_path):
    model = torch.nn.Linear(2, 2)
    keeper = BestKeeper(str(tmp_path / "ckpt"), prefix="field_1")
    saved = [keeper.update(model, epoch, loss) for epoch, loss in enumerate((0.5, 0.25, 0.4))]
    assert saved[0] and saved[1] and saved[2] is None
    assert BestKeeper.best_path(str(tmp_path / "ckpt"), prefix="field_1") == saved[1]
    assert saved[1].endswith("field_1_0.250000")
    log = MetricLogger(str(tmp_path))
    log.log({"cd": 0.5, "t": 0.2}, step=0)
    log.log({"loss": 1.0}, step=1)
    log.close()
    head = open(metrics_to_csv(str(tmp_path / "metrics.jsonl"))).readline().strip()
    assert head.split(",") == ["time", "cd", "t", "step", "loss"]
