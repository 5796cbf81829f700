"""VO evaluation over whole sequences (counterpart of ``tcsfm/eval/vo.py``).

Pair-wise (target, source) coupled inference along a sequence: the depth
net over both frames, the coupled pose solver at ``cfg.iterations`` (the
one-shot pose at 1, which with ``flow_type='classical'`` also reads the
Farneback flow pair of each window, computed on the evaluator's device
by ``ops.flow.pose_flows``), and the DNet ground-plane scale of each sample's
target depth. Then the shared metric tail: the fwd/inv fusion
``(fwd - inv) / 2``, and the unscaled, DNet-scaled and GT mean-norm-scaled
trajectories with their errors.

The JAX package pads the last batch to keep one compiled program and
keeps a dispatch queue two deep; neither is needed here, and no result
depends on the batch split (the depth net runs in eval mode and the scale
is per sample). The loader's thread loads batch k+1 while the card
computes batch k; the results stay on the device and are gathered once at
the end, so no per-batch copy to the host holds the loop back. Per batch
the sampler's value kernel launches ``cfg.iterations - 1`` times.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from tcsfm_torch.config import Config
from tcsfm_torch.data.dataset import SequenceData, SfMWindowDataset
from tcsfm_torch.data.loader import BatchLoader
from tcsfm_torch.data.transforms import WindowTransform
from tcsfm_torch.eval.scale_recovery import scale_recovery_per_sample
from tcsfm_torch.eval.trajectory import ResultsLogger, compute_trajectory
from tcsfm_torch.geom.warp import Sampler
from tcsfm_torch.models.depth import DepthNet
from tcsfm_torch.models.pose import PoseNet
from tcsfm_torch.ops.flow import pose_flows
from tcsfm_torch.ops.grid_sample import grid_sample
from tcsfm_torch.solver.coupled import solve_pose, solve_pose_iteratively
from tcsfm_torch.utils.helpers import (disp_to_depth, resolve_device,
                                       to_device, to_numpy)

METRIC_SCALE = 30.0


class VOEvaluator:
    """Coupled inference over a sequence's pair windows with ``depth_net``
    and ``pose_net`` (which set the device); ``device`` None is the card.
    ``sampler`` is the warps' sampler (``ops.grid_sample.grid_sample``: the
    CUDA kernel on the card; ``grid_sample_plain``: the plain version)."""

    def __init__(self, cfg: Config, depth_net: DepthNet, pose_net: PoseNet,
                 dnet_rescaling: bool = True,
                 cam_height: Optional[float] = None, device=None,
                 sampler: Sampler = grid_sample):
        self.cfg = cfg
        self.depth_net = depth_net.eval()
        self.pose_net = pose_net.eval()
        self.dnet = dnet_rescaling
        self.cam_height = (cam_height if cam_height is not None
                           else cfg.camera_height)
        self.device = resolve_device(device)
        self.sampler = sampler
        for net in (depth_net, pose_net):
            p = next(net.parameters()).device
            if p.type != self.device.type:
                raise ValueError(f"model on {p}, evaluation asked on "
                                 f"{self.device}")

    @torch.no_grad()
    def infer(self, target_img: torch.Tensor, source_imgs: torch.Tensor,
              K: torch.Tensor, trans_pert: float = 0.0,
              yaw_pert: float = 0.0):
        """(poses [S,B,6], poses_inv [S,B,6], DNet scale [B]) of a batch;
        ``trans_pert``/``yaw_pert`` are added to every initial pose's tz/ry
        (the perturbation experiment), on the iterative solver, which
        refuses a pose net that takes flow channels."""
        cfg = self.cfg
        S, b = source_imgs.shape[0], target_img.shape[0]
        imgs = torch.cat([target_img, source_imgs.reshape(
            (S * b,) + source_imgs.shape[2:])])
        depth_all = disp_to_depth(self.depth_net(imgs)[0], cfg.min_depth,
                                  cfg.max_depth)[1]
        depths = depth_all.reshape((S + 1, b) + depth_all.shape[1:])
        if cfg.iterations == 1 and not (trans_pert or yaw_pert):
            flows = (pose_flows(target_img, source_imgs)
                     if cfg.flow_type == "classical" else None)
            poses, poses_inv = solve_pose(self.pose_net, target_img,
                                          source_imgs, flows)
        else:
            def pert(v):
                return (torch.full((2 * S * b,), v, device=target_img.device)
                        if v else None)

            poses, poses_inv, _ = solve_pose_iteratively(
                cfg.iterations, depths, self.pose_net, target_img,
                source_imgs, K, trans_pert=pert(trans_pert),
                yaw_pert=pert(yaw_pert), sampler=self.sampler)
        scale = torch.ones(b, device=target_img.device)
        if self.dnet:
            # metric depth for the ground-plane height
            scale = scale_recovery_per_sample(METRIC_SCALE * depths[0], K,
                                              self.cam_height)
        return poses, poses_inv, scale

    def run_sequence(self, seq: SequenceData, batch_size: int = 8,
                     verbose: bool = True,
                     logger: Optional[ResultsLogger] = None,
                     trans_pert: float = 0.0, yaw_pert: float = 0.0,
                     correction_rate: int = 1) -> Dict:
        """Full-sequence VO: pair windows (seq_len 2) of every
        ``correction_rate``-th frame, scored against the GT trajectory at
        the same stride; the perturbations go to ``infer``."""
        ds = SfMWindowDataset(
            [seq], seq_len=2,
            transform=WindowTransform(jitter=False, flip_prob=None),
            correction_rate=correction_rate)
        loader = BatchLoader(ds, batch_size, shuffle=False, drop_last=False,
                             prefetch=2)
        fwd, inv, scales, gts = [], [], [], []
        for batch in loader:
            x = to_device(batch, ("target_img", "source_imgs", "intrinsics"),
                          self.device)
            poses, poses_inv, scale = self.infer(
                x["target_img"], x["source_imgs"], x["intrinsics"],
                trans_pert, yaw_pert)
            fwd.append(poses[0])
            inv.append(poses_inv[0])
            scales.append(scale)
            gts.append(batch["gt_lie_alg"][0])
        fwd = torch.cat(fwd).cpu().numpy()
        inv = torch.cat(inv).cpu().numpy()
        scales = to_numpy(torch.cat(scales)).reshape(-1, 1)
        gts = np.concatenate(gts)

        fwd[:, 0:3] *= METRIC_SCALE
        inv[:, 0:3] *= METRIC_SCALE
        return metrics_from_pose_vecs(seq.name,
                                      seq.gt_poses[::correction_rate], fwd,
                                      inv, gts, scales, dnet=self.dnet,
                                      verbose=verbose, logger=logger)


def metrics_from_pose_vecs(seq_name: str, gt_traj, fwd: np.ndarray,
                           inv: np.ndarray, gts: np.ndarray,
                           scales: Optional[np.ndarray], dnet: bool = True,
                           verbose: bool = True,
                           logger: Optional[ResultsLogger] = None) -> Dict:
    """Trajectory metrics from (already metric-scaled) fwd/inv pose vecs:
    the fwd/inv fusion and the DNet and GT scaling variants, shared with
    the replay of saved predictions."""
    unscaled = (fwd - inv) / 2.0

    results = {"fwd_pose_vec": fwd, "inv_pose_vec": inv,
               "gt_pose_vec": gts, "dnet_scale_factor": scales,
               "gt_traj": np.asarray(gt_traj), "est_trajs": {}}
    logger = logger if logger is not None else ResultsLogger()

    est, _, errors, _ = compute_trajectory(
        unscaled, gt_traj, method="unscaled", compute_seg_err=True,
        verbose=verbose)
    logger.log(seq_name, "unscaled", *errors)
    results["errors_unscaled"] = errors
    results["est_trajs"]["unscaled"] = est

    if dnet and scales is not None:
        scaled_dnet = unscaled.copy()
        scaled_dnet[:, 0:3] *= scales
        est, _, errors, _ = compute_trajectory(
            scaled_dnet, gt_traj, method="scaled (dnet)",
            compute_seg_err=True, verbose=verbose)
        logger.log(seq_name, "dnet scaled", *errors)
        results["errors_dnet"] = errors
        results["est_trajs"]["dnet"] = est

    # GT mean-norm scaling
    gt_scale = (
        np.mean(np.linalg.norm(gts[:, 0:3], axis=1))
        / max(np.mean(np.linalg.norm(unscaled[:, 0:3], axis=1)), 1e-12)
    )
    scaled_gt = unscaled.copy()
    scaled_gt[:, 0:3] *= gt_scale
    est, _, errors, _ = compute_trajectory(
        scaled_gt, gt_traj, method="scaled (gt)", compute_seg_err=True,
        verbose=verbose)
    logger.log(seq_name, "gt scaled", *errors)
    results["errors_gt_scaled"] = errors
    results["est_trajs"]["gt"] = est
    results["gt_scale"] = gt_scale
    results["logger"] = logger.results
    return results


def save_predictions(path: str, results: Dict) -> None:
    """A ``run_sequence`` result's pose vectors and DNet scales, as npz,
    for later replay."""
    np.savez(
        path,
        fwd_pose_vec=results["fwd_pose_vec"],
        inv_pose_vec=results["inv_pose_vec"],
        gt_pose_vec=results["gt_pose_vec"],
        dnet_scale_factor=np.asarray(results["dnet_scale_factor"]),
    )


def evaluate_saved_predictions(path: str, seq: SequenceData,
                               dnet: bool = True,
                               verbose: bool = True,
                               logger: Optional[ResultsLogger] = None) -> Dict:
    """VO metrics replayed from saved predictions, without the networks."""
    d = np.load(path)
    scales = (d["dnet_scale_factor"].reshape(-1, 1)
              if "dnet_scale_factor" in d.files else None)
    return metrics_from_pose_vecs(
        seq.name, seq.gt_poses, d["fwd_pose_vec"], d["inv_pose_vec"],
        d["gt_pose_vec"], scales, dnet=dnet, verbose=verbose, logger=logger)
