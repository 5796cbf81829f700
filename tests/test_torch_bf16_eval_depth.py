"""The depth evaluations in bfloat16: ``evaluate_depth_eigen`` and
``evaluate_scannet`` from a bfloat16 model directory against the JAX
package's CLIs on the same directory, on the CPU
(``test_torch_bf16_eval.py`` holds the VO path). JAX's CLIs jit their
forwards with the weights closed over, which XLA constant-folds
(ScanNet's JAX run: 95 s cold on an x86 CPU, 25 s with the weights as
arguments); they run here under ``bf16_eval_harness.weights_as_arguments``,
which passes what a jitted function closes over to the program as
arguments: the same operations on the same values, compiled without the
weights in them.

The directory, the rule and the one-ulp runs are ``bf16_eval_harness.py``'s
(``FRACTION`` = 3 x the larger of JAX's bfloat16-vs-float32 gap and the
port's one-ulp spread; the port's float32 run stands in for JAX's, which
``test_torch_depth_eval_cli.py`` holds within 1e-5). Relative L2 (parity /
gap / spread measured on an x86 CPU), each with a planted fault that fails
it:

* Eigen (``test_torch_depth_eval_cli.py``'s six frames, JAX with cv2
  hidden, in one batch): the flip-merged scaled disparities (float32 in
  both packages: ``post_process_disparity``'s float32 ramp promotes the
  bfloat16 disparity, and the ``--save_pred_disps`` file is float32 in
  both), 4.63e-3 / 4.14e-3 / 0 (the depth net rounds its input to bfloat16, so one
  f32 ulp on it moves nothing: Eigen has no spread), and each metric
  (relative, against the gap and spread of that metric: 0.04-1.12 x).
  Planted faults:
  the disparity not flip-merged; each metric off by a factor 10
  (``hold_metrics``);
* ScanNet, on ``test_torch_depth_eval_cli.py``'s 21-frame scene (13
  windows in batches of 4, 8 iterations): the target disparities
  4.52e-3 / 4.13e-3 / 3.19e-3 (planted fault: 5% too large), the fused pose vectors
  0.614 / 0.628 / 0.617 (at 8 iterations the bfloat16 pose chain is noise at this
  size; planted fault: the metric x30 applied twice), and each metric
  against its own gap and spread (0.23-1.38 x; planted fault: each off
  by a factor 10).
"""

import os

import jax  # noqa: F401  (keeps JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest
import torch

import bf16_eval_harness as eh
from tcsfm_torch.cli import evaluate_depth_eigen, evaluate_scannet
from tcsfm_torch.cli.common import load_config, load_nets
from tcsfm_torch.config import Config
from test_torch_depth_eval_cli import (SCANNET_ARGS, eigen_data,  # noqa: F401
                                       hidden_cv2, pose_vecs, scannet_data)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return eh.write_model_dirs(tmp_path_factory.mktemp("bf16_model"))


@pytest.fixture(scope="module")
def scannet_runs(dirs, scannet_data, hidden_cv2):  # noqa: F811
    from tcsfm.cli.evaluate_scannet import main as jax_main
    from tcsfm.eval import depth_metrics

    disps, mats = [], []
    resize, pose_errors = (depth_metrics._resize_bilinear,
                           depth_metrics.compute_pose_errors_deepv2d)

    def record_resize(img, h, w):
        disps.append(np.array(img))
        return resize(img, h, w)

    def record_pose(gt, pr):
        mats.append(np.array(pr))
        return pose_errors(gt, pr)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(depth_metrics, "_resize_bilinear", record_resize)
        mp.setattr(depth_metrics, "compute_pose_errors_deepv2d", record_pose)
        with eh.weights_as_arguments():
            ref = jax_main(["--model_dir", dirs["bfloat16"], "--data_dir",
                            scannet_data] + SCANNET_ARGS)

    def port(dtype):
        args = evaluate_scannet.parse_args(
            ["--model_dir", dirs[dtype], "--data_dir", scannet_data,
             "--device", "cpu"] + SCANNET_ARGS)
        pred = evaluate_scannet.predict(args, *load_nets(dirs[dtype], "cpu"),
                                        "cpu")
        return pred, evaluate_scannet.metrics(*pred)

    runs = {"jax": (ref, np.stack(disps), np.stack(mats)),
            "bfloat16": port("bfloat16"), "float32": port("float32")}
    runs["moved"] = []
    for d in eh.DIRECTIONS:
        with eh.nudged(d):
            runs["moved"].append(port("bfloat16"))
    return runs


def test_scannet_matches_jax(scannet_runs):
    ref, ref_disps, ref_mats = scannet_runs["jax"]
    (_, disps, mats, _), ours = scannet_runs["bfloat16"]
    (_, disps32, mats32, _), ours32 = scannet_runs["float32"]
    moved = scannet_runs["moved"]
    assert len(mats) == len(ref_mats) == 13
    eh.hold(np.stack(disps), ref_disps, np.stack(disps32),
            [np.stack(m[0][1]) for m in moved], "ScanNet disparities",
            fault=np.stack(disps) * 1.05)
    vecs = pose_vecs(mats)
    metric_twice = vecs.copy()
    metric_twice[:, :3] *= 30.0
    eh.hold(vecs, pose_vecs(ref_mats), pose_vecs(mats32),
            [pose_vecs(m[0][2]) for m in moved], "ScanNet pose vectors",
            fault=metric_twice)
    for part in ("depth", "pose"):
        eh.hold_metrics(ours[part], ref[part], ours32[part],
                      [m[1][part] for m in moved], f"ScanNet {part}")


def _eigen_args(model_dir, data, npy):
    return ["--model_dir", model_dir, "--data_dir", data, "--gt_depths",
            os.path.join(data, "gt_depths.npz"), "--save_pred_disps", npy]


@pytest.fixture(scope="module")
def eigen_runs(dirs, eigen_data, hidden_cv2, tmp_path_factory):  # noqa: F811
    from tcsfm.cli.evaluate_depth_eigen import main as jax_main

    root = tmp_path_factory.mktemp("eigen_runs")

    def port(dtype, name, **kw):
        npy = str(root / f"{name}.npy")
        metrics = evaluate_depth_eigen.main(
            _eigen_args(dirs[dtype], eigen_data, npy)
            + ["--device", "cpu", "--batch", "4"])
        return metrics, np.load(npy)

    npy = str(root / "jax.npy")
    with eh.weights_as_arguments():
        ref = jax_main(_eigen_args(dirs["bfloat16"], eigen_data, npy)
                       + ["--batch", "6"])
    runs = {"jax": (ref, np.load(npy)),
            "bfloat16": port("bfloat16", "port"),
            "float32": port("float32", "port32")}
    runs["moved"] = []
    for i, d in enumerate(eh.DIRECTIONS):
        with eh.nudged(d):
            runs["moved"].append(port("bfloat16", f"moved{i}"))
    return runs


def test_eigen_matches_jax(dirs, eigen_runs, eigen_data):  # noqa: F811
    (ref, ref_disps), (ours, disps) = eigen_runs["jax"], eigen_runs["bfloat16"]
    assert ref_disps.dtype == disps.dtype == np.float32
    assert disps.shape == ref_disps.shape == (6, 64, 96)
    depth_net, _ = load_nets(dirs["bfloat16"], "cpu")
    from tcsfm_torch.data.eigen import EigenDataset

    imgs = torch.from_numpy(np.stack([
        EigenDataset(eigen_data, mode="test")[i]["target_img"]
        for i in range(6)]))
    with torch.no_grad():
        plain = evaluate_depth_eigen.scaled_disparity(
            depth_net, imgs, load_config(dirs["bfloat16"], Config()),
            post_process=False).float().numpy()
    eh.hold(disps, ref_disps, eigen_runs["float32"][1],
            [m[1] for m in eigen_runs["moved"]], "Eigen disparities",
            fault=plain)
    eh.hold_metrics(ours, ref, eigen_runs["float32"][0],
                  [m[0] for m in eigen_runs["moved"]], "Eigen")
