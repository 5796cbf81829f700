"""Self-supervised SfM loss stack, NHWC (counterpart of
``tcsfm/losses/photometric.py``).

SSIM on reflection-padded 3x3 box statistics, edge-aware smoothness of the
mean-normalized disparity, the pose-consistency term, and the per-pair
photometric loss: L1+SSIM blend, Monodepth2 auto-masking, optional
depth-consistency weighting, min-fused forward reconstruction and the
0.3-weighted inverse reconstruction. ``compute_losses`` runs all 2·S
pairwise terms of a scale as one packed warp of 2·S·B, as the JAX package
does; its warp samples the source image (data) and the source depth
(differentiable) in one 4-channel call.

Data parallelism (``mesh``, a ``tcsfm_torch.dist.Mesh``): each rank holds
its rows of the global batch and computes its share of the global batch's
loss, so that the shares sum over the ranks to the JAX package's loss on
that batch and so do their gradients. A masked mean reduces its numerator
on the rank and divides by the mask count of the global batch, all-reduced
(it carries no gradient); the ``MIN_PIXELS`` guard reads that global count,
which a rank's own count can fall under where the global one does not. The
plain means (smoothness, the forward reconstruction, pose consistency) are
scaled by the rank's share of the rows, ``1 / world_size`` (the ranks hold
equal rows, ``dist.shard_batch``). With no mesh nothing changes.

Gradients follow JAX's at ties: ``_clip`` is ``jnp.clip``'s
maximum-then-minimum, and the forward reconstruction's min over sources
is ``torch.amin``; both split the gradient between equal values, where
``torch.clamp`` and ``torch.min(dim)`` would not.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from tcsfm_torch.config import Config
from tcsfm_torch.dist.mesh import Mesh
from tcsfm_torch.geom.warp import Sampler, inverse_warp2
from tcsfm_torch.ops.grid_sample import grid_sample
from tcsfm_torch.utils.helpers import disp_to_depth, weak

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2
MIN_PIXELS = 10000    # the reference's sparse-mask guard (losses.py:142-149)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: maximum then minimum, ties share the gradient."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _box3(x: torch.Tensor) -> torch.Tensor:
    """Reflection-pad(1) + 3x3 mean filter over NHWC (torch AvgPool2d(3,1))."""
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    return F.avg_pool2d(xp, 3, stride=1).permute(0, 2, 3, 1)


def ssim_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM dissimilarity in [0, 1] (losses.py:11-41), with the
    statistics pooled over the reflection-padded images."""
    c = x.shape[-1]
    # the five box filters in one pass over a stacked tensor
    stats = _box3(torch.cat([x, y, x * x, y * y, x * y], -1))
    mu_x, mu_y, xx, yy, xy = torch.split(stats, c, -1)
    sigma_x = xx - mu_x * mu_x
    sigma_y = yy - mu_y * mu_y
    sigma_xy = xy - mu_x * mu_y
    n = (2 * mu_x * mu_y + _C1) * (2 * sigma_xy + _C2)
    d = (mu_x * mu_x + mu_y * mu_y + _C1) * (sigma_x + sigma_y + _C2)
    return _clip((1 - n / d) / 2, 0.0, 1.0)


def smooth_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware disparity smoothness with mean normalization
    (losses.py:43-61). disp: [B, H, W, 1]; img: [B, H, W, C]."""
    mean_disp = disp.mean(dim=(1, 2), keepdim=True)
    d = disp / (mean_disp + weak(1e-7, mean_disp))
    grad_disp_x = (d[:, :, :-1] - d[:, :, 1:]).abs()
    grad_disp_y = (d[:, :-1] - d[:, 1:]).abs()
    grad_img_x = (img[:, :, :-1] - img[:, :, 1:]).abs().mean(-1, keepdim=True)
    grad_img_y = (img[:, :-1] - img[:, 1:]).abs().mean(-1, keepdim=True)
    return ((grad_disp_x * torch.exp(-grad_img_x)).mean()
            + (grad_disp_y * torch.exp(-grad_img_y)).mean())


def pose_consistency_loss(poses: torch.Tensor,
                          poses_inv: torch.Tensor) -> torch.Tensor:
    """Sum over sources of mean |pose + pose_inv| (train_mono.py:8-16);
    poses, poses_inv: [S, B, 6]."""
    return (poses + poses_inv).abs().mean(dim=(1, 2)).sum()


def share(mesh: Optional[Mesh]) -> float:
    """This rank's share of the global batch's rows (1 with no mesh)."""
    return 1.0 if mesh is None else 1.0 / mesh.world_size


def _global_count(total: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A mask count over the global batch: ``total`` with no mesh, else its
    sum over the ranks (no gradient)."""
    return total if mesh is None else mesh.all_reduce(total.detach().clone())


def mean_on_mask(diff: torch.Tensor, valid_mask: torch.Tensor,
                 min_pixels: int = MIN_PIXELS,
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Masked mean, 0 when no more than ``min_pixels`` pixels are valid;
    with a mesh, this rank's share of the global batch's masked mean."""
    mask = valid_mask.expand_as(diff)
    total = _global_count(mask.sum(), mesh)
    mean_val = (diff * mask).sum() / total.clamp_min(1.0)
    return torch.where(total > min_pixels, mean_val, mean_val.new_zeros(()))


def _photometric(cfg: Config, tgt, ref, warped, valid_mask, computed_depth,
                 projected_depth):
    """(diff_img [N,H,W,1], valid_mask, diff_depth) of the pair terms."""
    diff_img = _clip((tgt - warped).abs(), 0.0, 1.0)
    if cfg.with_auto_mask:
        auto = (diff_img.mean(-1, keepdim=True)
                < (tgt - ref).abs().mean(-1, keepdim=True)).to(diff_img.dtype)
        valid_mask = auto * valid_mask
    if cfg.l_ssim:
        diff_img = (cfg.l1_weight * diff_img
                    + cfg.l_ssim_weight * ssim_loss(tgt, warped)
                    ).mean(-1, keepdim=True)
    diff_depth = _clip((computed_depth - projected_depth).abs()
                       / (computed_depth + projected_depth), 0.0, 1.0)
    if cfg.with_depth_mask:
        diff_img = diff_img * (1.0 - diff_depth)
    return diff_img, valid_mask, diff_depth


def pairwise_loss(cfg: Config, tgt_img, ref_img, tgt_depth, ref_depth, pose,
                  K, sampler: Sampler = grid_sample):
    """One target↔reference photometric term (losses.py:151-183); ``pose``
    is already negated by the caller.

    Returns (l_reprojection, l_depth, diff_img [B,H,W,1], valid_mask
    [B,H,W,1]).
    """
    warped, valid_mask, projected_depth, computed_depth = inverse_warp2(
        ref_img, tgt_depth, ref_depth, pose, K, sampler=sampler)
    diff_img, valid_mask, diff_depth = _photometric(
        cfg, tgt_img, ref_img, warped, valid_mask, computed_depth,
        projected_depth)
    l_depth = (mean_on_mask(diff_depth, valid_mask) if cfg.l_depth_consist
               else diff_img.new_zeros(()))
    return mean_on_mask(diff_img, valid_mask), l_depth, diff_img, valid_mask


def _grouped_mean_on_mask(diff: torch.Tensor, mask: torch.Tensor,
                          min_pixels: int = MIN_PIXELS,
                          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Per-group masked means with the sparse guard: [G, B, H, W, 1] → [G];
    with a mesh, this rank's shares of the global batch's."""
    total = _global_count(mask.sum(dim=(1, 2, 3, 4)), mesh)
    val = (diff * mask).sum(dim=(1, 2, 3, 4)) / total.clamp_min(1.0)
    return torch.where(total > min_pixels, val, torch.zeros_like(val))


def _full_res(disp: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(method="nearest")`` of [B, h_s, w_s, 1] to [B, h, w, 1]."""
    if disp.shape[1] == h:
        return disp
    up = F.interpolate(disp.permute(0, 3, 1, 2), size=(h, w),
                       mode="nearest-exact")
    return up.permute(0, 2, 3, 1)


def compute_losses(cfg: Config, source_imgs: torch.Tensor,
                   target_img: torch.Tensor, poses: torch.Tensor,
                   poses_inv: torch.Tensor,
                   disparities: Sequence[Sequence[torch.Tensor]],
                   K: torch.Tensor,
                   sampler: Sampler = grid_sample,
                   mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """The multi-scale loss dict (losses.py:75-140); with a mesh, this
    rank's share of each term of the global batch's.

    Args:
      source_imgs: [S, B, H, W, 3] (clean stream); target_img: [B, H, W, 3].
      poses, poses_inv: [S, B, 6] final coupled poses (negated for the warp).
      disparities: disparities[f][s] = [B, h_s, w_s, 1] sigmoid disparity of
                   frame f (0 = target) at scale s.
      K:           [B, 3, 3] intrinsics.
      sampler:     the warp's sampler (``ops.grid_sample``).
      mesh:        the data mesh the batch is sharded over, or None.

    Returns l_reconstruct_inverse / l_reconstruct_forward / l_depth /
    l_smooth / total as 0-d tensors, each divided by num_scales, scale
    terms by 2^scale.
    """
    S = source_imgs.shape[0]
    b, h, w, _ = target_img.shape
    part = share(mesh)
    zero = target_img.new_zeros(())
    losses = {"l_reconstruct_inverse": zero, "l_reconstruct_forward": zero,
              "l_depth": zero, "l_smooth": zero}

    src_flat = source_imgs.reshape((S * b, h, w, 3))
    tgt_rep = target_img.repeat(S, 1, 1, 1)
    # pack [fwd (S·B) ; inv (S·B)] exactly like the solver
    tgt_pack = torch.cat([tgt_rep, src_flat])
    ref_pack = torch.cat([src_flat, tgt_rep])
    pose_pack = torch.cat([-poses.reshape(S * b, 6),
                           -poses_inv.reshape(S * b, 6)])
    K_pack = K.repeat(2 * S, 1, 1)

    for scale in range(cfg.num_scales):
        disp = _full_res(disparities[0][scale], h, w)
        _, d = disp_to_depth(disp, cfg.min_depth, cfg.max_depth)
        sdisps = [_full_res(disparities[j + 1][scale], h, w) for j in range(S)]
        _, src_d_flat = disp_to_depth(torch.cat(sdisps), cfg.min_depth,
                                      cfg.max_depth)

        if cfg.l_smooth:
            losses["l_smooth"] = losses["l_smooth"] + (
                cfg.l_smooth_weight * smooth_loss(disp, target_img) * part
            ) / (2 ** scale)
            for j in range(S):
                losses["l_smooth"] = losses["l_smooth"] + (
                    cfg.l_smooth_weight
                    * smooth_loss(sdisps[j], source_imgs[j]) * part
                ) / (2 ** scale)

        if not cfg.l_reconstruction:
            continue

        d_rep = d.repeat(S, 1, 1, 1)
        tgtd_pack = torch.cat([d_rep, src_d_flat])
        refd_pack = torch.cat([src_d_flat, d_rep])
        warped, valid_mask, projected_depth, computed_depth = inverse_warp2(
            ref_pack, tgtd_pack, refd_pack, pose_pack, K_pack,
            sampler=sampler)
        diff_img, valid_mask, diff_depth = _photometric(
            cfg, tgt_pack, ref_pack, warped, valid_mask, computed_depth,
            projected_depth)

        # regroup [2SB, ...] → [2S, B, H, W, 1]
        diff_g = diff_img.reshape((2 * S, b, h, w, 1))
        mask_g = valid_mask.reshape((2 * S, b, h, w, 1))

        if cfg.l_depth_consist:
            dd_g = diff_depth.reshape((2 * S, b, h, w, 1))
            n_groups = 2 * S if cfg.l_inverse else S
            losses["l_depth"] = losses["l_depth"] + (
                cfg.l_depth_consist_weight
                * _grouped_mean_on_mask(dd_g[:n_groups], mask_g[:n_groups],
                                        mesh=mesh).sum())

        # forward: min over sources, unmasked mean (losses.py:129-132)
        losses["l_reconstruct_forward"] = losses["l_reconstruct_forward"] + (
            torch.amin(diff_g[:S, ..., 0], dim=0).mean() * part)

        if cfg.l_inverse:
            losses["l_reconstruct_inverse"] = losses["l_reconstruct_inverse"] + (
                0.3 * _grouped_mean_on_mask(diff_g[S:], mask_g[S:],
                                            mesh=mesh).sum())

    total = zero
    for key in list(losses):
        losses[key] = losses[key] / cfg.num_scales
        total = total + losses[key]
    losses["total"] = total
    return losses
