"""The coupled depth↔pose solver (counterpart of
``tcsfm/solver/coupled.py``), differentiable end to end.

Sources are a stacked axis [S, B, ...]; all forward and inverse pairs go
through the pose net as ONE batch of 2·S·B (source-major: forward pairs
first, then inverse pairs). The iteration loop is a Python loop over
``num_iter``.

The pose-only path (``return_errors=False``): its warps skip resampling
the source depth, and the last iteration skips its re-warp, so
``num_iter`` iterations make ``num_iter - 1`` warps. Under autograd (the
training step) each warp's backward is the sampler's d_coords-only
kernel: the warped images are camera frames.

With ``return_errors=True`` every iteration re-warps (``num_iter`` warps,
the JAX package's MXU path): the first ``num_iter - 1`` stay 3-channel,
the last samples the source depth as the sampler's 4-channel tail (JAX's
``warp_final``), and the final iteration's error products are formed
(``CoupledOutputs``). That last warp's backward is the d_img kernel where
the source depth needs a gradient (PFT's depth modes), else d_coords only.
``remat`` (recomputing each iteration in the backward) is not ported.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from tcsfm_torch.geom.warp import Sampler, inverse_warp2
from tcsfm_torch.losses.photometric import _clip, ssim_loss
from tcsfm_torch.ops.grid_sample import grid_sample

Apply = Callable[[torch.Tensor], object]


def blend_error(target: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """Per-pixel 0.15 L1 + 0.85 SSIM of ``other`` against ``target``,
    averaged over channels: [N, H, W, 1]."""
    return (0.15 * _clip((other - target).abs(), 0.0, 1.0)
            + 0.85 * ssim_loss(target, other)).mean(-1, keepdim=True)


class CoupledOutputs(NamedTuple):
    """Per-direction error products of the final coupled iteration; all
    leading dims are [S*B] (source-major packing)."""

    diff_img: torch.Tensor         # [S*B, H, W, 1]
    img_rec: torch.Tensor          # [S*B, H, W, 3]
    valid_mask: torch.Tensor       # [S*B, H, W, 1]
    weight_mask: torch.Tensor      # [S*B, H, W, 1]
    poses: torch.Tensor            # [S*B, num_iter, 6] per-iteration chain
    auto_mask_error: torch.Tensor  # [S*B, H, W, 1]
    auto_mask: torch.Tensor        # [S*B, H, W, 1]


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
    return_errors: bool = False,
):
    """Iterative coupled pose estimation.

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
      return_errors: also build the fwd/inv error products (masks, diff
                   images, per-iteration pose chains) that PFT's loss reads.

    Returns:
      poses [S, B, 6], poses_inv [S, B, 6], and the per-iteration pose chain
      [2SB, num_iter, 6] (the JAX package's ``CoupledOutputs.poses`` of
      ``fwd`` and then ``inv``); with ``return_errors``, in place of the
      chain, a dict {'fwd': CoupledOutputs, 'inv': CoupledOutputs,
      'comb': {'imgs', 'valid_mask'}}.
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

    if return_errors:
        return _solve_with_errors(num_iter, pose_apply, full_poses, rec_target,
                                  rec_source, target_depth_full,
                                  source_depth_full, K_full, split, S, b,
                                  sampler)

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


def _solve_with_errors(num_iter, pose_apply, full_poses, rec_target,
                       rec_source, target_depth_full, source_depth_full,
                       K_full, split, S, b, sampler):
    """``solve_pose_iteratively``'s iterations with ``return_errors``:
    ``num_iter`` warps, the last one 4-channel, then the error products
    (``tcsfm/solver/coupled.py:243-301``)."""

    def warp(poses, final):
        return inverse_warp2(rec_source, target_depth_full, source_depth_full,
                             -poses, K_full, sample_depth=final,
                             sampler=sampler)

    chain = [full_poses]
    img_rec, valid_mask, projected_depth, computed_depth = warp(
        full_poses, num_iter == 1)
    for it in range(num_iter - 1):
        new_imgs = torch.cat([rec_target * valid_mask, img_rec], -1)
        full_poses = full_poses + pose_apply(new_imgs)
        chain.append(full_poses)
        img_rec, valid_mask, projected_depth, computed_depth = warp(
            full_poses, it == num_iter - 2)

    stacked = torch.stack(chain, 1)                           # [2SB, I, 6]
    poses = stacked[:split, -1].reshape(S, b, 6)
    poses_inv = stacked[split:, -1].reshape(S, b, 6)

    auto_mask_error = blend_error(rec_target, rec_source)
    diff_imgs = blend_error(rec_target.detach(), img_rec)
    auto_mask = (diff_imgs < auto_mask_error).to(img_rec.dtype)
    diff_depth = _clip((computed_depth - projected_depth).abs()
                       / (computed_depth + projected_depth), 0.0, 1.0)
    weight_masks = 1.0 - diff_depth

    def part(lo, hi):
        return CoupledOutputs(
            diff_img=diff_imgs[lo:hi], img_rec=img_rec[lo:hi],
            valid_mask=valid_mask[lo:hi], weight_mask=weight_masks[lo:hi],
            poses=stacked[lo:hi], auto_mask_error=auto_mask_error[lo:hi],
            auto_mask=auto_mask[lo:hi])

    outputs = {
        "fwd": part(0, split),
        "inv": part(split, 2 * split),
        "comb": {"imgs": torch.cat([rec_target * valid_mask, img_rec], -1),
                 "valid_mask": valid_mask},
    }
    return poses, poses_inv, outputs
