"""The port's paper-experiment CLI (``tcsfm_torch.cli.experiments``) on
the CPU, on a checkpoint the port wrote (seeded nets, trained-like
conditioning, 2 iterations) and an 8-frame sequence read through
``--data_dir``.

The coupled solver under it, perturbations included, is held against the
JAX package's by ``test_torch_coupled.py``; the JAX CLI itself is not run
here (its ``depth_scaling --synthetic`` alone takes ~50 s on an x86 CPU,
most of it XLA compile). Held, bit for bit: ``depth_scaling`` equals
``depth_scaling_response`` on the same batch; ``frame_skip``'s stride k
is the VO evaluator's unscaled trajectory on the sequence cut to every
k-th frame, and ``perturbation``'s clean run is stride 1; its perturbed
run is the JAX CLI's loop written out with the port's solver, and the
perturbations move the trajectory.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from tcsfm_torch.cli import experiments
from tcsfm_torch.cli.common import load_nets
from tcsfm_torch.config import Config
from tcsfm_torch.data.dataset import SfMWindowDataset
from tcsfm_torch.data.loader import BatchLoader
from tcsfm_torch.data.synthetic import make_synthetic_sequence
from tcsfm_torch.data.transforms import WindowTransform
from tcsfm_torch.eval.experiments import depth_scaling_response
from tcsfm_torch.eval.trajectory import compute_trajectory
from tcsfm_torch.eval.vo import VOEvaluator
from tcsfm_torch.infer import build_models
from tcsfm_torch.solver.coupled import solve_pose_iteratively
from tcsfm_torch.train.checkpoint import save_checkpoint
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("exp_model"))
    cfg = Config(iterations=2)
    depth_net, pose_net = build_models(
        cfg, device="cpu", generator=torch.Generator().manual_seed(8))
    chip_smoke.condition_like_trained(depth_net, torch)
    save_checkpoint(d, (depth_net, pose_net), epoch=1, best_val_loss=1.0,
                    cfg=cfg, is_best=True)
    return d


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """An 8-frame synthetic sequence as ``<dir>/seq8/sequence_data.npz``."""
    d = tmp_path_factory.mktemp("exp_data")
    (d / "seq8").mkdir()
    make_synthetic_sequence(8, (64, 96), seed=17).save_npz(
        str(d / "seq8" / "sequence_data.npz"))
    return str(d)


def cli(model_dir, data_dir, cmd, *extra):
    return experiments.main([cmd, "--model_dir", model_dir, "--data_dir",
                             data_dir, "--seq", "seq8", "--device", "cpu"]
                            + list(extra))


def test_depth_scaling_is_the_library_sweep(model_dir, data_dir):
    out = cli(model_dir, data_dir, "depth_scaling", "--batch", "2")
    seq = make_synthetic_sequence(8, (64, 96), seed=17)
    ds = SfMWindowDataset([seq], seq_len=3,
                          transform=WindowTransform(jitter=False,
                                                    flip_prob=None))
    batch = next(iter(BatchLoader(ds, 2, shuffle=False)))
    tgt, src, K = (torch.from_numpy(batch[k]) for k in
                   ("target_img", "source_imgs", "intrinsics"))
    depth_net, pose_net = load_nets(model_dir, "cpu")
    cfg = Config(iterations=2)
    depths = experiments._depths(cfg, depth_net, tgt, src)
    want = depth_scaling_response(2, depths, pose_net, tgt, src, K,
                                  out["scales"])
    assert out["trans_norms"] == want.tolist()
    assert out["relative"][out["scales"].index(1.0)] == 1.0


def decimated(seq, k):
    """``seq`` with every ``k``-th frame (and its pose, intrinsics, time)."""
    return dataclasses.replace(
        seq, intrinsics=seq.intrinsics[::k], gt_poses=seq.gt_poses[::k],
        vo_poses=seq.vo_poses[::k], timestamps=seq.timestamps[::k],
        images=seq.images[::k])


def test_perturbation_and_frame_skip(model_dir, data_dir):
    """Stride k is the evaluator on the sequence cut to every k-th frame;
    the perturbed run is the JAX CLI's pair-wise loop (the perturbation
    added to every initial pose, fwd/inv fused, x30) written out here with
    the port's solver."""
    pert = cli(model_dir, data_dir, "perturbation")
    skip = cli(model_dir, data_dir, "frame_skip")
    depth_net, pose_net = load_nets(model_dir, "cpu")
    cfg = Config(iterations=2)
    vo = VOEvaluator(cfg, depth_net, pose_net, device="cpu")
    seq = make_synthetic_sequence(8, (64, 96), seed=17)
    assert sorted(skip) == ["skip_1", "skip_2", "skip_3"]
    for k in (1, 2, 3):
        res = vo.run_sequence(decimated(seq, k), verbose=False)
        np.testing.assert_array_equal(
            skip[f"skip_{k}"], [float(e) for e in res["errors_unscaled"]])
    np.testing.assert_array_equal(pert["clean"], skip["skip_1"])

    ds = SfMWindowDataset([seq], seq_len=2,
                          transform=WindowTransform(jitter=False,
                                                    flip_prob=None))
    b = next(iter(BatchLoader(ds, len(ds), shuffle=False)))
    tgt, src, K = (torch.from_numpy(b[k]) for k in
                   ("target_img", "source_imgs", "intrinsics"))
    full = torch.full((2 * len(ds),), 1.0)
    with torch.no_grad():
        poses, poses_inv, _ = solve_pose_iteratively(
            2, experiments._depths(cfg, depth_net, tgt, src), pose_net, tgt,
            src, K, trans_pert=0.05 * full, yaw_pert=0.0875 * full)
    fused = ((poses[0] - poses_inv[0]) / 2.0).numpy()
    fused[:, :3] *= 30.0
    want = compute_trajectory(fused, seq.gt_poses, method="both",
                              compute_seg_err=True)[2]
    np.testing.assert_array_equal(pert["both"], [float(e) for e in want])
    for k in ("trans", "yaw", "both"):
        assert np.isfinite(pert[k][:2]).all() and pert[k] != pert["clean"]
