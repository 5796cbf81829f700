"""The coupled depth↔pose solver (counterpart of
``tcsfm/solver/coupled.py:46-253``), differentiable end to end.

Sources are a stacked axis [S, B, ...]; all forward and inverse pairs go
through the pose net as ONE batch of 2·S·B (source-major: forward pairs
first, then inverse pairs). The iteration loop is a Python loop over
``num_iter``. The port has the pose-only path (``return_errors=False`` in
the JAX package): its pose-only warps skip resampling the source depth,
and the last iteration skips its re-warp, so ``num_iter`` iterations make
``num_iter - 1`` warps. Under autograd (the training step) each warp's
backward is the sampler's d_coords-only kernel: the warped images are
camera frames. The error products (``return_errors=True``) come with PFT;
``remat`` (recomputing each iteration in the backward) is not ported.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from tcsfm_torch.geom.warp import Sampler, inverse_warp2
from tcsfm_torch.ops.grid_sample import grid_sample

Apply = Callable[[torch.Tensor], object]


def solve_disp(depth_apply: Apply, target_img: torch.Tensor,
               source_imgs: torch.Tensor) -> List[List[torch.Tensor]]:
    """Run the depth network once over target + all sources.

    Args:
      depth_apply: images [N, H, W, 3] → list of [N, h_s, w_s, 1] disparities.
      target_img:  [B, H, W, 3]; source_imgs: [S, B, H, W, 3].

    Returns:
      disparities[f][s]: frame f (0 = target, 1.. = sources) at scale s.
    """
    S, b = source_imgs.shape[0], target_img.shape[0]
    imgs = torch.cat([target_img,
                      source_imgs.reshape((S * b,) + source_imgs.shape[2:])])
    disps = depth_apply(imgs)
    return [[d[f * b:(f + 1) * b] for d in disps] for f in range(S + 1)]


def solve_pose(pose_apply: Apply, target_img: torch.Tensor,
               source_imgs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot (non-iterative) pose for each source.

    Returns (poses [S, B, 6], poses_inv [S, B, 6]).
    """
    S, b = source_imgs.shape[0], target_img.shape[0]
    tgt = target_img[None].expand(source_imgs.shape)
    fwd = torch.cat([tgt, source_imgs], -1)                  # [S, B, H, W, 6]
    inv = torch.cat([source_imgs, tgt], -1)
    stacked = torch.cat([fwd, inv]).reshape((2 * S * b,) + fwd.shape[2:])
    poses = pose_apply(stacked)
    return poses[:S * b].reshape(S, b, 6), poses[S * b:].reshape(S, b, 6)


def solve_pose_iteratively(
    num_iter: int,
    depths: Sequence[torch.Tensor] | torch.Tensor,
    pose_apply: Apply,
    target_img: torch.Tensor,
    source_imgs: torch.Tensor,
    K: torch.Tensor,
    trans_pert: Optional[torch.Tensor] = None,
    yaw_pert: Optional[torch.Tensor] = None,
    sampler: Sampler = grid_sample,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Iterative coupled pose estimation, pose-only.

    The initial pose comes from the raw (target, source) pair; each further
    iteration warps the source with the current depth+pose and feeds
    (masked target, reconstruction) back through the pose net to predict a
    correction added to the running estimate.

    Args:
      num_iter:    number of coupled iterations (>= 1).
      depths:      [S+1, B, H, W, 1] (or a sequence): target depth first,
                   then source depths, full resolution.
      pose_apply:  [N, H, W, 6] stacked pairs → [N, 6] pose vectors.
      target_img:  [B, H, W, 3]; source_imgs: [S, B, H, W, 3].
      K:           [B, 3, 3] intrinsics.
      trans_pert / yaw_pert: optional [2SB]-broadcastable perturbations
                   added to the initial pose's tz / ry.
      sampler:     the warp's bilinear sampler (see ``inverse_warp2``).

    Returns:
      poses [S, B, 6], poses_inv [S, B, 6], and the per-iteration pose chain
      [2SB, num_iter, 6] (the JAX package's ``CoupledOutputs.poses`` of
      ``fwd`` and then ``inv``).
    """
    if num_iter < 1:
        raise ValueError(f"num_iter must be >= 1, got {num_iter}")
    if not torch.is_tensor(depths):
        depths = torch.stack(list(depths))
    S, b = source_imgs.shape[0], target_img.shape[0]
    split = S * b
    tgt_depth, src_depths = depths[0], depths[1:]

    # batched fwd+inv packing
    src_depths_flat = src_depths.reshape((split,) + src_depths.shape[2:])
    tgt_depths_flat = tgt_depth.repeat(S, 1, 1, 1)
    src_flat = source_imgs.reshape((split,) + source_imgs.shape[2:])
    tgt_flat = target_img.repeat(S, 1, 1, 1)

    rec_target = torch.cat([tgt_flat, src_flat])   # reconstruction target
    rec_source = torch.cat([src_flat, tgt_flat])   # the image being warped
    imgs = torch.cat([rec_target, rec_source], -1)           # [2SB, H, W, 6]
    K_full = K.repeat(2 * S, 1, 1)
    target_depth_full = torch.cat([tgt_depths_flat, src_depths_flat])
    source_depth_full = torch.cat([src_depths_flat, tgt_depths_flat])

    full_poses = pose_apply(imgs)                             # [2SB, 6]
    if trans_pert is not None or yaw_pert is not None:
        full_poses = full_poses.clone()
        if trans_pert is not None:
            full_poses[:, 2] += trans_pert
        if yaw_pert is not None:
            full_poses[:, 4] += yaw_pert

    def warp(poses):
        img_rec, valid_mask, _, _ = inverse_warp2(
            rec_source, target_depth_full, source_depth_full, -poses, K_full,
            sample_depth=False, sampler=sampler)
        return img_rec, valid_mask

    chain = [full_poses]
    if num_iter > 1:
        img_rec, valid_mask = warp(full_poses)
    for it in range(num_iter - 1):
        new_imgs = torch.cat([rec_target * valid_mask, img_rec], -1)
        full_poses = full_poses + pose_apply(new_imgs)
        chain.append(full_poses)
        if it < num_iter - 2:
            # the last iteration's re-warp would only feed error products
            img_rec, valid_mask = warp(full_poses)

    stacked = torch.stack(chain, 1)                           # [2SB, I, 6]
    poses = stacked[:split, -1].reshape(S, b, 6)
    poses_inv = stacked[split:, -1].reshape(S, b, 6)
    return poses, poses_inv, stacked
