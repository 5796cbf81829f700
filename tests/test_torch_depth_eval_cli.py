"""The port's depth-evaluation CLIs (``tcsfm_torch.cli.evaluate_depth_eigen``,
``tcsfm_torch.cli.evaluate_scannet``) on the CPU against the JAX package's,
one JAX CLI call each, on one checkpoint the port wrote from seeded nets
with trained-like conditioning (f32 does not resolve the coupled forward at
the raw init, ROADMAP §3), read by both through ``--model_dir``.

The JAX CLIs run with cv2 hidden, so both packages resize by the same
numpy code (``tests/test_torch_depth_metrics.py``); each JAX call is cached
per module.

Held:
* Eigen (6 frames at 64x96 as PNGs, GT depth nearest-resized to 120x372):
  the flip-merged scaled disparities within ``DISP_TOL`` = 1e-5 of the
  sigmoid's range (1/min_depth - 1/max_depth = 16.29), the sigmoid's 1e-5
  of ``tests/test_torch_coupled.py``; ``--save_pred_disps`` then
  ``--pred_disps`` replays the metrics bit for bit; the metrics within
  ``METRIC_TOL`` = 1e-4 relative.
* ScanNet (a 21-frame 64x96 scene, frame gap 4: 13 windows, batches of 4
  with a short last one, 8 iterations): the target disparities as Eigen's;
  the fused pose vectors (translations back at the solver's 1/30 scale)
  within ``POSE_TOL`` = 1e-5; the metrics within ``METRIC_TOL``.
The tests print what they read (``-s``).
"""

import builtins
import os

import jax  # noqa: F401  (keeps JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from tcsfm_torch.cli import evaluate_depth_eigen, evaluate_scannet
from tcsfm_torch.cli.common import load_nets
from tcsfm_torch.config import Config
from tcsfm_torch.data.synthetic import make_synthetic_sequence
from tcsfm_torch.eval.trajectory import np_se3_log
from tcsfm_torch.infer import build_models
from tcsfm_torch.train.checkpoint import save_checkpoint
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = Config(compute_dtype="float32", iterations=2, img_resolution="low")
DISP_RANGE = 1.0 / CFG.min_depth - 1.0 / CFG.max_depth
DISP_TOL = 1e-5 * DISP_RANGE
POSE_TOL = 1e-5
METRIC_TOL = 1e-4
GT_SHAPE = (120, 372)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("depth_eval_model"))
    depth_net, pose_net = build_models(
        CFG, device="cpu", generator=torch.Generator().manual_seed(4))
    chip_smoke.condition_like_trained(depth_net, torch)
    save_checkpoint(d, (depth_net, pose_net), epoch=1, best_val_loss=1.0,
                    cfg=CFG, is_best=True)
    return d


@pytest.fixture(scope="module")
def hidden_cv2():
    """cv2 hidden from imports for the module's JAX calls."""
    mp = pytest.MonkeyPatch()
    real_import = builtins.__import__

    def hide(name, *a, **k):
        if name == "cv2":
            raise ImportError("hidden: the numpy resize path")
        return real_import(name, *a, **k)

    mp.setattr(builtins, "__import__", hide)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def eigen_data(tmp_path_factory):
    """Six frames in the Eigen index layout, and their GT depths (metric:
    the synthetic depth x30) nearest-resized to ``GT_SHAPE``."""
    root = tmp_path_factory.mktemp("eigen")
    seq = make_synthetic_sequence(6, (64, 96), seed=8)
    files = []
    for i in range(6):
        p = str(root / f"{i:010d}.png")
        Image.fromarray((seq.images[i] * 255).astype(np.uint8)).save(p)
        files.append(p)
    np.savez(root / "eigen_info_test.npz", files=np.asarray(files),
             K=seq.intrinsics, poses=seq.gt_poses,
             folders=np.asarray(["drive0"] * 6), idxs=np.arange(6))
    gt = np.empty(6, object)
    for i in range(6):
        gt[i] = np.asarray(Image.fromarray(seq.depths[i] * 30.0).resize(
            (GT_SHAPE[1], GT_SHAPE[0]), Image.NEAREST))
    np.savez(root / "gt_depths.npz", data=gt)
    return str(root)


@pytest.fixture(scope="module")
def jax_eigen(model_dir, eigen_data, hidden_cv2, tmp_path_factory):
    from tcsfm.cli.evaluate_depth_eigen import main

    npy = str(tmp_path_factory.mktemp("jax_eigen") / "disps.npy")
    metrics = main(["--model_dir", model_dir, "--data_dir", eigen_data,
                    "--gt_depths", os.path.join(eigen_data, "gt_depths.npz"),
                    "--save_pred_disps", npy])
    return metrics, np.load(npy)


def assert_metrics_close(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        rel = abs(ours[k] - ref[k]) / max(abs(ref[k]), 1e-12)
        print(f"  {k}: port {ours[k]:.6g}, JAX {ref[k]:.6g}, rel {rel:.2e}")
        assert rel <= METRIC_TOL, k


def test_eigen_cli_matches_jax_and_replays(model_dir, eigen_data, jax_eigen,
                                           tmp_path):
    ref_metrics, ref_disps = jax_eigen
    npy = str(tmp_path / "disps.npy")
    gt = os.path.join(eigen_data, "gt_depths.npz")
    ours = evaluate_depth_eigen.main(
        ["--model_dir", model_dir, "--data_dir", eigen_data, "--gt_depths",
         gt, "--save_pred_disps", npy, "--device", "cpu", "--batch", "4"])
    disps = np.load(npy)
    assert disps.shape == ref_disps.shape == (6, 64, 96)
    err = np.abs(disps - ref_disps).max()
    print(f"Eigen disparity: max |port - JAX| {err:.3e} (limit "
          f"{DISP_TOL:.3e})")
    assert err <= DISP_TOL
    assert_metrics_close(ours, ref_metrics)
    replay = evaluate_depth_eigen.main(["--gt_depths", gt,
                                        "--pred_disps", npy])
    assert replay == ours


@pytest.mark.parametrize("post_process", [True, False])
def test_eigen_flip_merge_is_the_merged_pair(model_dir, post_process):
    """The batch and its width-mirror through one forward, merged; without
    post-processing the plain disparity."""
    from tcsfm_torch.utils.helpers import disp_to_depth, post_process_disparity

    depth_net, _ = load_nets(model_dir, "cpu")
    imgs = torch.from_numpy(
        make_synthetic_sequence(3, (64, 96), seed=1).images)
    got = evaluate_depth_eigen.scaled_disparity(depth_net, imgs, CFG,
                                                post_process)
    with torch.no_grad():
        plain = disp_to_depth(depth_net(imgs)[0][..., 0], CFG.min_depth,
                              CFG.max_depth)[0]
        flipped = disp_to_depth(depth_net(imgs.flip(2))[0][..., 0],
                                CFG.min_depth, CFG.max_depth)[0]
    want = (post_process_disparity(plain, flipped.flip(2)) if post_process
            else plain)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def scannet_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("scannet")
    make_synthetic_sequence(21, (64, 96), seed=7).save_npz(
        str(root / "scene0.npz"))
    return str(root)


SCANNET_ARGS = ["--scenes", "scene0", "--frame_gap", "4", "--batch", "4"]


@pytest.fixture(scope="module")
def jax_scannet(model_dir, scannet_data, hidden_cv2):
    """JAX's CLI with its per-window metric inputs recorded: the target
    disparities (``_resize_bilinear``'s input) and the fused pose matrices
    (``compute_pose_errors_deepv2d``'s)."""
    from tcsfm.cli.evaluate_scannet import main
    from tcsfm.eval import depth_metrics

    disps, mats = [], []
    mp = pytest.MonkeyPatch()
    resize, pose_errors = (depth_metrics._resize_bilinear,
                           depth_metrics.compute_pose_errors_deepv2d)

    def record_resize(img, h, w):
        disps.append(np.array(img))
        return resize(img, h, w)

    def record_pose(gt, pr):
        mats.append(np.array(pr))
        return pose_errors(gt, pr)

    mp.setattr(depth_metrics, "_resize_bilinear", record_resize)
    mp.setattr(depth_metrics, "compute_pose_errors_deepv2d", record_pose)
    try:
        out = main(["--model_dir", model_dir, "--data_dir", scannet_data]
                   + SCANNET_ARGS)
    finally:
        mp.undo()
    return out, np.stack(disps), np.stack(mats)


def pose_vecs(mats):
    v = np.stack([np_se3_log(np.asarray(m, np.float64)) for m in mats])
    v[:, :3] /= 30.0
    return v


def test_scannet_cli_matches_jax(model_dir, scannet_data, jax_scannet):
    ref, ref_disps, ref_mats = jax_scannet
    args = evaluate_scannet.parse_args(
        ["--model_dir", model_dir, "--data_dir", scannet_data, "--device",
         "cpu"] + SCANNET_ARGS)
    assert args.iterations == 8
    depth_net, pose_net = load_nets(model_dir, "cpu")
    gt_depths, disps, mats, gt_mats = evaluate_scannet.predict(
        args, depth_net, pose_net, "cpu")
    assert len(disps) == len(mats) == len(gt_mats) == 13 == len(ref_mats)
    err = np.abs(np.stack(disps) - ref_disps).max()
    pose_err = np.abs(pose_vecs(mats) - pose_vecs(ref_mats)).max()
    print(f"ScanNet: disparity max |port - JAX| {err:.3e} (limit "
          f"{DISP_TOL:.3e}); fused pose vectors, 8 iterations, {pose_err:.3e} "
          f"(limit {POSE_TOL})")
    assert err <= DISP_TOL
    assert pose_err <= POSE_TOL
    ours = evaluate_scannet.metrics(gt_depths, disps, mats, gt_mats)
    for part in ("depth", "pose"):
        print(part)
        assert_metrics_close(ours[part], ref[part])
    assert evaluate_scannet.main(
        ["--model_dir", model_dir, "--data_dir", scannet_data, "--device",
         "cpu"] + SCANNET_ARGS) == ours


def test_clis_want_the_card_by_default(model_dir, eigen_data):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_depth_eigen.main(["--model_dir", model_dir, "--data_dir",
                                   eigen_data, "--gt_depths", "x.npz"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_scannet.main(["--model_dir", model_dir, "--scenes", "s"])
