"""The paper's self-validating experiments as library functions
(counterpart of ``tcsfm/eval/experiments.py``).

  * loss surface: photometric error vs translation/yaw offsets around the
    estimate; the estimate should sit at the minimum;
  * pose perturbation: trans/yaw noise injected into the coupled
    iterations; multi-iteration models pull the pose back;
  * depth scaling: depth scaled by a factor; for coupled models the
    translation norm tracks the factor ~linearly.

The sweeps are Python loops over the offsets or scales, one warp or one
coupled solve each, where JAX vmaps them. Tensors stay where they are
given; ``sampler`` is the warps' (``ops.grid_sample.grid_sample``: the
CUDA kernels on the card).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from tcsfm_torch.geom.warp import Sampler, inverse_warp2
from tcsfm_torch.ops.grid_sample import grid_sample
from tcsfm_torch.solver.coupled import blend_error, solve_pose_iteratively
from tcsfm_torch.utils.helpers import to_numpy


def photometric_error(target_img, source_img, target_depth, source_depth,
                      pose, K, automask: bool = True,
                      sampler: Sampler = grid_sample) -> torch.Tensor:
    """Masked SSIM+L1 photometric error for one pose hypothesis. Returns
    [B]; NaN where no pixel is left (the reference's 0/0 at degenerate
    poses).

    ``automask=False`` drops the stationarity mask: useful for loss
    surfaces, where the shrinking automask at bad poses creates spurious
    low-error dips.
    """
    img_rec, valid_mask, _, _ = inverse_warp2(
        source_img, target_depth, source_depth, -pose, K,
        sample_depth=False, sampler=sampler)
    tgt = target_img.detach()
    diff = blend_error(tgt, img_rec)
    mask = valid_mask
    if automask:
        mask = (diff < blend_error(tgt, source_img)).to(diff.dtype) * valid_mask
    num = (diff * mask).sum(dim=(1, 2, 3))
    den = mask.sum(dim=(1, 2, 3))
    return torch.where(den > 0, num / den.clamp_min(1.0),
                       torch.full_like(num, float("nan")))


@torch.no_grad()
def loss_surface(target_img, source_img, target_depth, source_depth,
                 pose, K, trans_offsets: np.ndarray,
                 yaw_offsets: np.ndarray, automask: bool = True,
                 sampler: Sampler = grid_sample) -> Dict[str, np.ndarray]:
    """Photometric error along tz and yaw offsets around ``pose``: a 1-D
    sweep per axis. Returns {'trans': [T, B], 'yaw': [Y, B]}."""

    def sweep(offsets, axis):
        rows = []
        for off in np.asarray(offsets).tolist():
            p = pose.clone()
            p[:, axis] += off
            rows.append(photometric_error(target_img, source_img,
                                          target_depth, source_depth, p, K,
                                          automask=automask, sampler=sampler))
        return to_numpy(torch.stack(rows))

    return {"trans": sweep(trans_offsets, 2), "yaw": sweep(yaw_offsets, 4)}


@torch.no_grad()
def perturbation_response(num_iter: int, depths, pose_apply, target_img,
                          source_imgs, K, trans_pert: float = 0.0,
                          yaw_pert: float = 0.0,
                          sampler: Sampler = grid_sample):
    """Coupled solve with an injected initial-pose perturbation. Returns
    (clean, perturbed) final pose stacks [S, B, 6]."""
    S, b = source_imgs.shape[0], target_img.shape[0]
    n = 2 * S * b
    clean = solve_pose_iteratively(num_iter, depths, pose_apply, target_img,
                                   source_imgs, K, sampler=sampler)[0]
    pert = solve_pose_iteratively(
        num_iter, depths, pose_apply, target_img, source_imgs, K,
        trans_pert=target_img.new_full((n,), trans_pert),
        yaw_pert=target_img.new_full((n,), yaw_pert), sampler=sampler)[0]
    return clean, pert


@torch.no_grad()
def depth_scaling_response(num_iter: int, depths, pose_apply, target_img,
                           source_imgs, K, scales: Sequence[float],
                           sampler: Sampler = grid_sample) -> np.ndarray:
    """Mean translation norm of the coupled estimate vs depth scale.
    Returns [len(scales)]."""
    if not torch.is_tensor(depths):
        depths = torch.stack(list(depths))
    out = []
    for s in scales:
        poses = solve_pose_iteratively(num_iter, depths * s, pose_apply,
                                       target_img, source_imgs, K,
                                       sampler=sampler)[0]
        out.append(poses[..., 0:3].norm(dim=-1).mean().item())
    return np.asarray(out)
