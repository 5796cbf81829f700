"""Training-time validation (counterpart of ``tcsfm/train/validate.py``):
visual panels and trajectory evaluation.

``depth_and_reconstruction_panels`` samples a few windows and forms the
panels the training CLI logs (reconstruction triplets, disparities,
automask and depth-consistency mask, the reconstructed disparity);
``trajectory_eval`` integrates the poses of every window of one test
sequence into trajectory errors. Both take the port's networks, put them
in eval mode and run under ``torch.no_grad()`` on the networks' device:
on the card the warps go through the sampler's CUDA kernel. The JAX
functions' ``use_mxu_warp`` and band arguments pick its TPU sampler's
modes and have no counterpart. With ``flow_type="classical"`` at
``iterations == 1`` both pass the Farneback flow pair
(``ops.flow.pose_flows``) to the one-shot pose; at more iterations the
solver refuses the 8-channel pose net, as the JAX package's raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from tcsfm_torch.config import Config
from tcsfm_torch.data.loader import BatchLoader
from tcsfm_torch.eval.trajectory import compute_trajectory
from tcsfm_torch.eval.vo import METRIC_SCALE, VOEvaluator
from tcsfm_torch.geom.warp import Sampler, inverse_warp2
from tcsfm_torch.models.depth import DepthNet
from tcsfm_torch.models.pose import PoseNet
from tcsfm_torch.ops.flow import pose_flows
from tcsfm_torch.ops.grid_sample import grid_sample
from tcsfm_torch.solver.coupled import (solve_disp, solve_pose,
                                        solve_pose_iteratively)
from tcsfm_torch.utils.helpers import (depth_to_disp, disp_to_depth,
                                       to_device, to_numpy)


def _device_of(net: torch.nn.Module) -> torch.device:
    return next(net.parameters()).device


@torch.no_grad()
def depth_and_reconstruction_panels(cfg: Config, depth_net: DepthNet,
                                    pose_net: PoseNet, dataset,
                                    n_samples: int = 5, source_idx: int = 0,
                                    sampler: Sampler = grid_sample
                                    ) -> Dict[str, np.ndarray]:
    """The panels of ~``n_samples`` windows of ``dataset`` spread over it
    (``tcsfm/train/validate.py:49-111``): triplets [N, 3, H, W, 3] (source,
    reconstruction, target), disparities, exp_masks, depth_masks and
    reconstructed_disps [N, H, W]."""
    depth_net.eval()
    pose_net.eval()
    device = _device_of(depth_net)
    idxs = np.arange(0, len(dataset),
                     max(int(len(dataset) / n_samples) - 1, 1))[:n_samples]

    triplets, disps, masks, d_masks, rec_disps = [], [], [], [], []
    for i in idxs:
        x = to_device({k: v[None] for k, v in dataset[int(i)].items()},
                      ("target_img_aug", "source_imgs_aug",
                       "intrinsics_aug"), device)
        tgt, K = x["target_img_aug"], x["intrinsics_aug"]
        src = x["source_imgs_aug"].transpose(0, 1).contiguous()  # [S,1,..]

        disparities = solve_disp(depth_net, tgt, src)
        depths = torch.stack([
            disp_to_depth(d[0], cfg.min_depth, cfg.max_depth)[1]
            for d in disparities])
        if cfg.iterations == 1:
            flows = (pose_flows(tgt, src) if cfg.flow_type == "classical"
                     else None)
            poses, _ = solve_pose(pose_net, tgt, src, flows)
        else:
            poses, _, _ = solve_pose_iteratively(
                cfg.iterations, depths, pose_net, tgt, src, K,
                sampler=sampler)

        source = src[source_idx]
        rec, valid, proj_depth, comp_depth = inverse_warp2(
            source, depths[0], depths[1 + source_idx], -poses[source_idx], K,
            sampler=sampler)
        # the reference compares the reconstruction with the source here
        diff = (source - rec).abs().clamp(0, 1)
        auto = (diff.mean(-1, keepdim=True)
                < (tgt - source).abs().mean(-1, keepdim=True)
                ).float() * valid
        auto = auto * (rec.mean(-1, keepdim=True) != 0)
        d_loss = ((comp_depth - proj_depth).abs()
                  / (comp_depth + proj_depth)).clamp(0, 1)

        triplets.append(torch.stack([source[0], rec[0], tgt[0]]))
        disps.append(disparities[0][0][0, ..., 0])
        masks.append(auto[0, ..., 0])
        d_masks.append(1.0 - d_loss[0, ..., 0])
        rec_disps.append(depth_to_disp(proj_depth[0, ..., 0], cfg.min_depth,
                                       cfg.max_depth).clamp(0, 1))

    def stack(xs):
        return to_numpy(torch.stack(xs))

    return {"triplets": stack(triplets), "disparities": stack(disps),
            "exp_masks": stack(masks), "depth_masks": stack(d_masks),
            "reconstructed_disps": stack(rec_disps)}


def trajectory_eval(cfg: Config, depth_net: DepthNet, pose_net: PoseNet,
                    dataset, gt_traj: np.ndarray, batch_size: int = 8,
                    verbose: bool = True, sampler: Sampler = grid_sample
                    ) -> Tuple[np.ndarray, np.ndarray, tuple]:
    """The trajectory of one test sequence during training
    (``tcsfm/train/validate.py:114-161``): ``dataset`` yields the windows of
    ONE sequence in order; the first source's pose of each, scaled to
    metres. Returns (est_poses [N, 6], gt_lie [N, 6], errors). The last
    batch stays short (the JAX package pads it for its compiled program)."""
    evaluator = VOEvaluator(cfg, depth_net, pose_net, dnet_rescaling=False,
                            device=_device_of(depth_net), sampler=sampler)
    loader = BatchLoader(dataset, batch_size, shuffle=False, drop_last=False)
    est, gts = [], []
    for batch in loader:
        x = to_device(batch, ("target_img", "source_imgs", "intrinsics"),
                      evaluator.device)
        poses, _, _ = evaluator.infer(x["target_img"], x["source_imgs"],
                                      x["intrinsics"])
        est.append(poses[0])
        gts.append(batch["gt_lie_alg"][0])
    est_scaled = to_numpy(torch.cat(est))
    est_scaled[:, 0:3] *= METRIC_SCALE
    gts = np.concatenate(gts)
    _, _, errors, _ = compute_trajectory(
        est_scaled, gt_traj, method="est", compute_seg_err=True,
        verbose=verbose)
    return est_scaled, gts, errors
