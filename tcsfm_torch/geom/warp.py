"""Inverse warping (counterpart of ``tcsfm/geom/warp.py``).

backproject → rigid transform → project → bilinear sample, NHWC,
differentiable. The sampler is the port's ``grid_sample`` (the CUDA
kernels on the card), with the semantics of the JAX package's unbanded XLA
sampler. The banded MXU path's band-coverage mask has no counterpart: a
GPU gather covers every pixel, so no pixel is invalidated for lying
outside a band.
"""

from __future__ import annotations

from typing import Callable

import torch

from tcsfm_torch.geom.camera import backproject
from tcsfm_torch.geom.se3 import pose_vec2mat
from tcsfm_torch.ops.grid_sample import grid_sample

# sampler(img, coords) or sampler(img, coords, tail): see ops.grid_sample
Sampler = Callable[..., torch.Tensor]


def _project_with_mask(cam_coords, K, pose_mat, h, w, zeros_padding=True):
    """Transform + project points → (coords, computed depth, valid mask).

    Keeps two quirks of the reference (cam2pixel2, models/stn.py:198-231)
    that the JAX package keeps too: the align_corners=True normalization
    2*(u/(W-1))-1, which then feeds an align_corners=False sampler; and,
    for zeros padding, the out-of-bounds push to 2.0, whose gradient is
    stopped as the reference's detached masked assignment stops it.
    Z is clamped at 1e-3.
    """
    P = K @ pose_mat                                   # [B, 3, 4]
    rot, tr = P[..., :3], P[..., 3:4]
    pcoords = rot @ cam_coords + tr                    # [B, 3, HW]
    X, Y = pcoords[:, 0], pcoords[:, 1]
    Z = pcoords[:, 2].clamp_min(1e-3)

    x_norm = 2.0 * (X / Z) / (w - 1) - 1.0
    y_norm = 2.0 * (Y / Z) / (h - 1) - 1.0
    if zeros_padding:
        pushed = torch.full_like(x_norm, 2.0)
        x_norm = torch.where(x_norm.abs() > 1.0, pushed, x_norm)
        y_norm = torch.where(y_norm.abs() > 1.0, pushed, y_norm)

    b = cam_coords.shape[0]
    coords = torch.stack([x_norm, y_norm], -1).reshape(b, h, w, 2)
    valid = (torch.maximum(x_norm.abs(), y_norm.abs()) <= 1.0).reshape(b, h, w)
    return coords, Z.reshape(b, h, w), valid


def inverse_warp2(img: torch.Tensor, depth: torch.Tensor,
                  ref_depth: torch.Tensor, pose: torch.Tensor, K: torch.Tensor,
                  sample_depth: bool = True,
                  sampler: Sampler = grid_sample):
    """Warp a source image into the target frame using target depth + pose.

    Args:
      img:       [B, H, W, 3] source image (sampled from). A data image (a
                 camera frame), which does not require grad, gets no d_img:
                 the sampler's backward computes only what autograd asks
                 for, as ``inverse_warp2_mxu(img_grad=False)`` does.
      depth:     [B, H, W, 1] target-frame depth.
      ref_depth: [B, H, W, 1] source-frame depth (sampled from).
      pose:      [B, 6] pose vector [tx ty tz rx ry rz] (target→source).
      K:         [B, 3, 3] intrinsics.
      sample_depth: False skips resampling ``ref_depth`` (pose-only
                 inference) and returns ``projected_depth`` None, as
                 ``tcsfm.geom.warp.inverse_warp2_mxu`` does.
      sampler:   the bilinear sampler; ``grid_sample`` launches the CUDA
                 kernels on the card, ``grid_sample_plain`` is its plain
                 twin.

    Returns:
      warped_img [B, H, W, 3], valid_mask [B, H, W, 1] float,
      projected_depth [B, H, W, 1] or None, computed_depth [B, H, W, 1].
    """
    b, h, w, _ = img.shape
    cam = backproject(depth, K)
    pose_mat = pose_vec2mat(pose[..., :6])
    coords, computed_depth, valid = _project_with_mask(cam, K, pose_mat, h, w)
    coords = coords.contiguous()
    img = img.contiguous()
    if sample_depth:
        # one 4-channel call samples image and depth together, as the JAX
        # MXU path packs them; the depth rides as the sampler's tail, so the
        # d_img of a data image is never formed. A bfloat16 net's depth
        # joins the float32 image promoted, as jnp.concatenate promotes it
        # (tcsfm/geom/warp.py:179); the samplers take float32 only.
        ref_depth = ref_depth.to(torch.promote_types(img.dtype,
                                                     ref_depth.dtype))
        sampled = sampler(img, coords, ref_depth)
        warped_img, projected_depth = sampled[..., :3], sampled[..., 3:4]
    else:
        warped_img, projected_depth = sampler(img, coords), None
    valid_mask = valid[..., None].to(img.dtype)
    return warped_img, valid_mask, projected_depth, computed_depth[..., None]


def inverse_warp(img: torch.Tensor, depth: torch.Tensor, pose: torch.Tensor,
                 K: torch.Tensor, rotation_mode: str = "euler",
                 sampler: Sampler = grid_sample):
    """The legacy single-output warp (``tcsfm/geom/warp.py:246-262``, the
    reference's ``inverse_warp``): no depth resampling, and border
    coordinates are not pushed out (``zeros_padding=False``), so the
    sampler's own zero padding decides what lies outside.

    Args:
      img:   [B, H, W, C]; depth: [B, H, W] or [B, H, W, 1]; pose: [B, 6].
      sampler: ``grid_sample`` (one value-kernel launch on the card) or
             ``grid_sample_plain``.
    Returns:
      (warped_img [B, H, W, C], valid [B, H, W] bool).
    """
    if depth.ndim == 3:
        depth = depth[..., None]
    b, h, w, _ = img.shape
    cam = backproject(depth, K)
    pose_mat = pose_vec2mat(pose, rotation_mode)
    coords, _, valid = _project_with_mask(cam, K, pose_mat, h, w,
                                          zeros_padding=False)
    return sampler(img.contiguous(), coords.contiguous()), valid
