"""The port's KITTI/ScanNet data modules (``tcsfm_torch.data.{kitti_io,
preprocess,eigen,scannet}``) against the JAX package's.

They are numpy copies, so everything is held bit for bit: the parsers on a
fake KITTI tree, each of ``preprocess``'s four subcommands run through both
packages' ``main`` on fake KITTI odometry, KITTI raw and ScanNet trees (the
index arrays equal, the written images byte for byte equal, paths equal
after the output root), and the ``EigenDataset`` and
``ScanNetTestDataset`` items, with and without the training transform.
"""

import os
import pickle

import numpy as np
import pytest
from PIL import Image

from tcsfm.data import eigen as jax_eigen
from tcsfm.data import kitti_io as jax_kitti_io
from tcsfm.data import preprocess as jax_preprocess
from tcsfm.data import scannet as jax_scannet
from tcsfm.data import transforms as jax_transforms
from tcsfm.data.dataset import SequenceData as JaxSequenceData
from tcsfm_torch.data import eigen, kitti_io, preprocess, scannet, transforms
from tcsfm_torch.data.dataset import SequenceData
from tcsfm_torch.data.synthetic import make_synthetic_sequence
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_FRAMES = 8
SRC_H, SRC_W = 64, 208
DATE = "2011_09_26"
DRIVE = f"{DATE}/{DATE}_drive_0001_sync"


def write_rgb(path, rng, h=SRC_H, w=SRC_W):
    Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(path)


@pytest.fixture(scope="module")
def fake_odometry(tmp_path_factory):
    """KITTI odometry: sequences/00/{image_2,image_3,calib.txt,times.txt}
    and poses/00.txt (as ``tests/test_preprocess.py`` builds it)."""
    root = tmp_path_factory.mktemp("kitti_odom")
    seq_dir = root / "sequences" / "00"
    rng = np.random.RandomState(0)
    for cam in ("image_2", "image_3"):
        (seq_dir / cam).mkdir(parents=True)
        for i in range(N_FRAMES):
            write_rgb(seq_dir / cam / f"{i:06d}.png", rng)
    (seq_dir / "calib.txt").write_text(
        f"P2: 100.0 0 {SRC_W / 2} 0  0 100.0 {SRC_H / 2} 0  0 0 1 0\n"
        f"P3: 100.0 0 {SRC_W / 2} -38.0  0 100.0 {SRC_H / 2} 0  0 0 1 0\n")
    (seq_dir / "times.txt").write_text(
        "".join(f"{0.1 * i:.6f}\n" for i in range(N_FRAMES)))
    (root / "poses").mkdir()
    lines = []
    for i in range(N_FRAMES):
        T = np.eye(4)
        T[2, 3] = 0.8 * i
        T[0, 3] = 0.01 * i * i
        lines.append(" ".join(f"{v:.6f}" for v in T[:3].reshape(-1)))
    (root / "poses" / "00.txt").write_text("\n".join(lines) + "\n")
    return root


@pytest.fixture(scope="module")
def fake_raw(tmp_path_factory):
    """KITTI raw: a date dir's three calib files, one drive's oxts packets,
    image_02 frames and velodyne scans, and the Eigen split files."""
    root = tmp_path_factory.mktemp("kitti_raw")
    date_dir = root / DATE
    drive = root / DRIVE
    rng = np.random.RandomState(1)
    for sub in ("oxts/data", "image_02/data", "velodyne_points/data"):
        (drive / sub).mkdir(parents=True)
    (date_dir / "calib_cam_to_cam.txt").write_text(
        "calib_time: 09-Jan-2012 13:57:47\n"
        "S_rect_02: 1.242000e+03 3.750000e+02\n"
        "R_rect_00: 0.9999 0.0098 -0.0074 -0.0098 0.9999 -0.0043 0.0074 "
        "0.0044 0.9999\n"
        "P_rect_02: 721.5 0 609.5 44.8 0 721.5 172.8 0.2 0 0 1 0.0027\n"
        "P_rect_03: 721.5 0 609.5 -339.5 0 721.5 172.8 2.2 0 0 1 0.0027\n")
    (date_dir / "calib_velo_to_cam.txt").write_text(
        "R: 7.5e-03 -9.9e-01 -6.1e-04 1.4e-02 7.2e-04 -9.9e-01 9.9e-01 "
        "7.5e-03 1.4e-02\nT: -4.0e-03 -7.6e-02 -2.7e-01\n")
    (date_dir / "calib_imu_to_velo.txt").write_text(
        "R: 1.0 0.0007 -0.002 -0.0008 0.9999 -0.0148 0.002 0.0148 0.9999\n"
        "T: -0.808 0.319 -0.799\n")
    for i in range(N_FRAMES):
        oxts = np.concatenate([[49.01 + 1e-5 * i, 8.43 + 2e-5 * i, 112.8,
                                0.01, 0.002 * i, 1.2 + 0.01 * i],
                               rng.rand(24)])
        np.savetxt(drive / "oxts" / "data" / f"{i:010d}.txt", oxts[None])
        write_rgb(drive / "image_02" / "data" / f"{i:010d}.png", rng,
                  h=75, w=248)
        pts = np.concatenate([rng.uniform(2, 40, (400, 1)),
                              rng.uniform(-10, 10, (400, 1)),
                              rng.uniform(-2, 1, (400, 1)),
                              rng.rand(400, 1)], 1).astype(np.float32)
        pts.tofile(drive / "velodyne_points" / "data" / f"{i:010d}.bin")
    split = root / "splits"
    split.mkdir()
    (split / "test_files.txt").write_text(
        "".join(f"{DRIVE} {i} l\n" for i in (1, 2, 3, 5)))
    (split / "train_files.txt").write_text(
        "".join(f"{DRIVE} {i} l\n" for i in (0, 4, 6, 7)))
    return root


@pytest.fixture(scope="module")
def fake_scannet(tmp_path_factory):
    """A ScanNet scene export: color/*.jpg, depth/*.png (uint16 mm),
    pose/*.txt (one NaN pose, filtered out), intrinsic/intrinsic_color.txt."""
    root = tmp_path_factory.mktemp("scannet")
    scene = root / "scene0000_00"
    rng = np.random.RandomState(2)
    for sub in ("color", "depth", "pose", "intrinsic"):
        (scene / sub).mkdir(parents=True)
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 580.0, 580.0, 320.0, 240.0
    np.savetxt(scene / "intrinsic" / "intrinsic_color.txt", K)
    for i in range(12):
        write_rgb(scene / "color" / f"{i}.jpg", rng, h=96, w=128)
        Image.fromarray((rng.rand(48, 64) * 4000 + 500).astype(np.uint16)
                        ).save(scene / "depth" / f"{i}.png")
        T = np.eye(4)
        T[:3, 3] = [0.05 * i, 0.0, 0.1 * i]
        if i == 4:
            T[0, 0] = np.nan
        np.savetxt(scene / "pose" / f"{i}.txt", T)
    return root


def assert_npz_equal(ours, theirs, out_ours, out_theirs):
    a, b = np.load(ours, allow_pickle=True), np.load(theirs, allow_pickle=True)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        x, y = a[k], b[k]
        if x.dtype.kind in "UO":
            x = np.asarray([str(v).replace(str(out_ours), "") for v in
                            np.atleast_1d(x)])
            y = np.asarray([str(v).replace(str(out_theirs), "") for v in
                            np.atleast_1d(y)])
        np.testing.assert_array_equal(x, y, err_msg=k)


def assert_trees_equal(ours, theirs):
    """Every file under ``ours`` exists under ``theirs``; images and npz
    indices equal."""
    names = sorted(os.path.relpath(os.path.join(d, f), ours)
                   for d, _, fs in os.walk(ours) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), theirs)
                           for d, _, fs in os.walk(theirs) for f in fs)
    assert names
    for n in names:
        a, b = os.path.join(ours, n), os.path.join(theirs, n)
        if n.endswith(".npz"):
            assert_npz_equal(a, b, ours, theirs)
        elif n.endswith(".pkl"):
            with open(a, "rb") as f, open(b, "rb") as g:
                x, y = pickle.load(f), pickle.load(g)
            assert sorted(x) == sorted(y)
            for k in x:
                xs = np.asarray([str(v).replace(str(ours), "") for v in
                                 np.ravel(x[k])]) if k == "cam_02" else x[k]
                ys = np.asarray([str(v).replace(str(theirs), "") for v in
                                 np.ravel(y[k])]) if k == "cam_02" else y[k]
                np.testing.assert_array_equal(xs, ys, err_msg=k)
        else:
            with open(a, "rb") as f, open(b, "rb") as g:
                assert f.read() == g.read(), n


def test_kitti_io_parsers_equal(fake_odometry, fake_raw):
    seq_dir = str(fake_odometry / "sequences" / "00")
    for k, v in jax_kitti_io.odometry_intrinsics(seq_dir).items():
        np.testing.assert_array_equal(kitti_io.odometry_intrinsics(seq_dir)[k],
                                      v)
    np.testing.assert_array_equal(kitti_io.read_odometry_times(seq_dir),
                                  jax_kitti_io.read_odometry_times(seq_dir))
    poses = str(fake_odometry / "poses" / "00.txt")
    np.testing.assert_array_equal(kitti_io.read_odometry_poses(poses),
                                  jax_kitti_io.read_odometry_poses(poses))
    drive = str(fake_raw / DRIVE)
    np.testing.assert_array_equal(kitti_io.load_oxts_poses(drive),
                                  jax_kitti_io.load_oxts_poses(drive))
    calib = kitti_io.raw_cam_calib(str(fake_raw / DATE))
    ref = jax_kitti_io.raw_cam_calib(str(fake_raw / DATE))
    assert sorted(calib) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(calib[k], ref[k], err_msg=k)
    velo = str(fake_raw / DRIVE / "velodyne_points" / "data" / "0000000003.bin")
    depth = kitti_io.velodyne_to_depth(velo, calib, 375, 1242)
    assert (depth > 0).sum() > 50
    np.testing.assert_array_equal(
        depth, jax_kitti_io.velodyne_to_depth(velo, ref, 375, 1242))


@pytest.mark.parametrize("extra", [[], ["--remove_static", "--reference_pkl"]])
def test_preprocess_odometry_equal(fake_odometry, tmp_path, extra):
    outs = []
    for name, mod in (("port", preprocess), ("jax", jax_preprocess)):
        out = tmp_path / name
        mod.main(["odometry", "--source_dir", str(fake_odometry),
                  "--target_dir", str(out), "--resolution", "low_res",
                  "--sequences", "00"] + extra)
        outs.append(str(out))
    assert_trees_equal(*outs)
    seq = SequenceData.from_npz(os.path.join(outs[0], "low_res", "00_02",
                                             "sequence_data.npz"))
    assert len(seq) == N_FRAMES
    assert Image.open(seq.image_files[0]).size == (448, 128)


def test_preprocess_eigen_and_gt_depth_equal(fake_raw, tmp_path):
    outs = []
    for name, mod in (("port", preprocess), ("jax", jax_preprocess)):
        out = tmp_path / name
        mod.main(["eigen", "--raw_dir", str(fake_raw), "--target_dir",
                  str(out), "--split_dir", str(fake_raw / "splits"),
                  "--resolution", "low_res"])
        mod.main(["eigen_gt_depth", "--raw_dir", str(fake_raw),
                  "--split_file", str(fake_raw / "splits" / "test_files.txt"),
                  "--out", str(out / "gt_depths.npz")])
        outs.append(str(out))
    assert_trees_equal(*outs)
    gt = np.load(os.path.join(outs[0], "gt_depths.npz"),
                 allow_pickle=True)["data"]
    assert len(gt) == 4 and gt[0].shape == (375, 1242)


def test_preprocess_scannet_equal(fake_scannet, tmp_path):
    outs = []
    for name, mod in (("port", preprocess), ("jax", jax_preprocess)):
        out = tmp_path / name
        mod.main(["scannet", "--source_dir", str(fake_scannet),
                  "--target_dir", str(out), "--scenes", "scene0000_00",
                  "--frame_skip", "2"])
        outs.append(str(out))
    assert_trees_equal(*outs)
    seq = SequenceData.from_npz(os.path.join(outs[0], "scene0000_00.npz"))
    assert len(seq) == 5 and seq.depths.shape == (5, 192, 640)   # 4 is NaN


def items_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("jitter", [False, True])
def test_eigen_dataset_items_equal(fake_raw, tmp_path, jitter):
    preprocess.main(["eigen", "--raw_dir", str(fake_raw), "--target_dir",
                     str(tmp_path), "--split_dir", str(fake_raw / "splits"),
                     "--resolution", "low_res"])
    data_dir = str(tmp_path / "low_res")
    kw = {}
    if jitter:
        kw = [dict(transform=m.WindowTransform(jitter=True, flip_prob=0.5),
                   seed=3) for m in (transforms, jax_transforms)]
    ours = eigen.EigenDataset(data_dir, mode="test", **(kw[0] if kw else {}))
    ref = jax_eigen.EigenDataset(data_dir, mode="test",
                                 **(kw[1] if kw else {}))
    assert len(ours) == len(ref) == 4
    assert ours.sources == ref.sources
    for i in range(len(ref)):
        items_equal(ours[i], ref[i])


@pytest.mark.parametrize("jitter", [False, True])
def test_scannet_dataset_items_equal(jitter):
    seq = make_synthetic_sequence(20, (32, 64), seed=7)
    kw = [{}, {}]
    if jitter:
        kw = [dict(transform=m.WindowTransform(jitter=True, flip_prob=0.5),
                   seed=4) for m in (transforms, jax_transforms)]
    ref_seq = JaxSequenceData(**{k: getattr(seq, k) for k in (
        "name", "intrinsics", "gt_poses", "vo_poses", "timestamps",
        "images", "depths")})
    ours = scannet.ScanNetTestDataset([seq], frame_gap=4, **kw[0])
    ref = jax_scannet.ScanNetTestDataset([ref_seq], frame_gap=4, **kw[1])
    assert len(ours) == len(ref) == 12
    for i in range(len(ref)):
        items_equal(ours[i], ref[i])
