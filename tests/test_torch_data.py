"""The port's data pipeline (``pci_tpu_torch/data``) against ``pci_tpu.data``,
on CPU: the synthetic scene generator writes the same bytes, the three
eval samplers give the same samples bit for bit on the same seed, and
``collate`` / ``Loader`` give the same batches, which ``to_device`` turns
into equal tensors.  Scenes are written to ``tmp_path``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pci_tpu import data as jdata
from pci_tpu_torch import data as tdata


def write_kitti(root, n_frames=12, npts=150):
    """A KITTI odometry sequence: velodyne/*.bin (float32 x4) + times.txt."""
    rng = np.random.default_rng(7)
    (root / "velodyne").mkdir(parents=True)
    base = (rng.standard_normal((npts, 4)) * 3).astype(np.float32)
    for i in range(n_frames):
        (base + np.float32([0.1 * i, 0, 0, 0])).tofile(root / "velodyne" / f"{i:06d}.bin")
    (root / "times.txt").write_text("\n".join(f"{0.1 * i:.6f}" for i in range(n_frames)) + "\n")
    return root


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two synthetic nuScenes-layout scenes (through the port's generator)
    and a KITTI sequence."""
    root = tmp_path_factory.mktemp("synth")
    tdata.generate_scenes(str(root), n_scenes=2, n_frames=16, npts=300, seed=5)
    return root, write_kitti(tmp_path_factory.mktemp("kitti"))


def assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_generate_scenes_writes_the_same_bytes(tmp_path):
    names = [pkg.generate_scenes(str(tmp_path / name), n_scenes=2, n_frames=4, npts=200, seed=3)
             for pkg, name in ((jdata, "jax"), (tdata, "torch"))]
    assert names[0] == names[1]
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert len(files) == 2 * 4 + 2 + 1
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "torch" / f).read_bytes()


def nuscenes_kw(root):
    return dict(root=str(root / "lidar"), scenes_list=str(root / "scenes.txt"),
                scene_split_lib=str(root / "split"))


@pytest.mark.parametrize("method,field", [("random", 1), ("fps", 2)])
def test_interpolation_windows_equal_jax(scenes, method, field):
    root, _ = scenes
    kw = dict(nuscenes_kw(root), field=field, npoints=128, interval=3,
              sample_method=method, seed=11)
    want = jdata.NuscenesInterpolationDataset(**kw)
    got = tdata.NuscenesInterpolationDataset(**kw)
    assert got.windows == want.windows and len(got) > 0
    for i in range(len(got)):
        assert_same(got[i], want[i])


@pytest.mark.parametrize("train", [False, True])
def test_triplets_equal_jax(scenes, train):
    root, kitti = scenes
    for cls in ("NuscenesTripletDataset", "KittiInterpolationDataset"):
        if cls == "NuscenesTripletDataset":
            args = (str(root / "lidar"), str(root / "scenes.txt"), str(root / "split"))
        else:
            args = (str(kitti),)
        kw = dict(npoints=100, interval=4, train=train, use_intensity=False, seed=12)
        want = getattr(jdata, cls)(*args, **kw)
        got = getattr(tdata, cls)(*args, **kw)
        assert len(got) == len(want) > 0
        for i in range(len(got)):
            assert_same(got[i], want[i])


def test_collate_loader_and_to_device(scenes):
    """Batches of two (one worker, so the shared sampling stream is drawn in
    order) and the ragged last batch: equal to JAX's; ``to_device`` on the
    CPU gives tensors equal to the numpy batch, frame lists kept."""
    root, _ = scenes
    kw = dict(nuscenes_kw(root), field=1, npoints=64, interval=3, sample_method="random",
              seed=13)
    loaders = [pkg.Loader(pkg.NuscenesInterpolationDataset(**kw), 2, shuffle=True,
                          drop_last=False, num_workers=1, seed=4)
               for pkg in (jdata, tdata)]
    want, got = list(loaders[0]), list(loaders[1])
    assert len(got) == len(loaders[1]) == len(want) >= 2
    for g, w in zip(got, want):
        assert_same(g, w)
    assert_same(tdata.collate([{"a": np.ones(2), "f": [np.zeros(3)]}] * 2),
                jdata.collate([{"a": np.ones(2), "f": [np.zeros(3)]}] * 2))
    dev = tdata.to_device(got[0], "cpu")
    assert isinstance(dev["forward"], list) and dev["forward"][0].device.type == "cpu"
    assert_same({k: [t.numpy() for t in v] if isinstance(v, list) else v.numpy()
                 for k, v in dev.items()}, got[0])
    assert dev["gt"].dtype == torch.float32 and dev["gt"].shape == (2, 64, 3)
