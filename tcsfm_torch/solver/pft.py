"""PFT: inference-time parameter fine-tuning (counterpart of
``tcsfm/solver/pft.py``).

For every test window, ``epochs - 1`` Adam (or SGD) steps optimize a
chosen subset of the depth/pose state against the photometric objective,
with the pose re-derived from the coupled solver (``return_errors=True``)
at each step; a last evaluation forward takes no step, and the final
predictions average the last ``avg_final_epochs`` entries.

Optimization modes (``MODES``):
  'encoder'    -- depth encoder weights, BatchNorm scales and biases too
                  (paper default)
  'all_depth'  -- all depth weights
  'decoder'    -- decoder only, decoding from the frozen initial skips
  'depth_pred' -- the 1/4-resolution disparity maps themselves
  'bottleneck' -- the two deepest skip activations
  'pose'       -- pose network weights, on the detached initial disparities

PyTorch idiom in place of JAX's: the trainable subset is a working copy of
each network (``copy.deepcopy``) with ``requires_grad`` on the mode's
tensors only, so the caller's networks come out unchanged, as JAX's
functional ``optimize_window`` leaves its parameter trees. The depth net
runs in eval mode throughout (BatchNorm on its running statistics, which
no step moves), as JAX applies ``batch_stats`` without ``train=True``; the
``encoder`` mode still trains the encoder's BatchNorm scales and biases.
JAX's two ``lax.scan``s (steps without and with the flip-merged disparity)
are one Python loop with an ``if``. The skips are NCHW here, NHWC in JAX.
``optimize_window_jit`` has no counterpart: there is no jit to enter.

``optimize_window`` runs on the card unless it is given ``device="cpu"``;
with no card it raises. Its warps go through ``sampler``
(``ops.grid_sample.grid_sample``: the CUDA kernels on the card). Per call,
with E = epochs and I = cfg.iterations, in a mode that trains depth, the
sampler's kernels launch E·I times (value; the last warp of each forward
4-channel), (E-1)(I-1) times (d_coords only) and E-1 times (d_coords +
d_img of the source depth); in 'pose' mode the 4-channel warp's backward
is d_coords only too: (E-1)·I and 0. The flip-merge forwards launch none.
"""

from __future__ import annotations

import copy
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from tcsfm_torch.config import Config, PFTOptions
from tcsfm_torch.eval.scale_recovery import scale_recovery
from tcsfm_torch.geom.warp import Sampler
from tcsfm_torch.losses.photometric import smooth_loss, ssim_loss
from tcsfm_torch.models.depth import DepthNet
from tcsfm_torch.models.pose import PoseNet
from tcsfm_torch.ops.grid_sample import grid_sample
from tcsfm_torch.solver.coupled import CoupledOutputs, solve_pose_iteratively
from tcsfm_torch.utils.helpers import (disp_to_depth, post_process_disparity,
                                       resolve_device)

MODES = ("encoder", "all_depth", "decoder", "depth_pred", "bottleneck", "pose")


def compute_optimization_loss(
    opts: PFTOptions,
    target_img: torch.Tensor,            # [B, H, W, 3]
    target_disparity: torch.Tensor,      # [B, H, W, 1]
    init_target_disparity: torch.Tensor,
    fwd: CoupledOutputs,                 # leading dim S*B
    inv: CoupledOutputs,
) -> torch.Tensor:
    """Single-step PFT loss (``tcsfm/solver/pft.py:47-107``)."""
    b = target_img.shape[0]
    S = opts.num_source_imgs
    loss = target_img.new_zeros(())

    def by_window(x):
        """[S*B, ...] → [B, S, ...]"""
        return x.reshape(S, b, *x.shape[1:]).movedim(0, 1)

    if opts.diff_img_argmin:
        diff_min = torch.amin(by_window(fwd.diff_img), 1)    # [B, H, W, 1]
        valid_min = by_window(fwd.valid_mask).sum(1).clamp(0, 1)
        if opts.automasking:
            ame_min = torch.amin(by_window(fwd.auto_mask_error), 1)
            valid_min = (diff_min < ame_min).to(diff_min.dtype) * valid_min
        # the reference multiplies by the FIRST source's weight mask only
        # (optimizer.py:69); the quirk is kept
        w0 = fwd.weight_mask[:b]
        loss = loss + (diff_min * valid_min * w0).sum() / valid_min.sum(
        ).clamp_min(1.0)
    else:
        masked = fwd.diff_img * fwd.valid_mask * fwd.weight_mask
        loss = loss + 0.25 * masked.sum() / fwd.valid_mask.sum().clamp_min(1.0)

    if opts.l_inverse_reconstruction:
        inv_masked = inv.diff_img * inv.valid_mask * inv.weight_mask
        if opts.automasking:
            inv_masked = inv_masked * inv.auto_mask
            denom = (inv.valid_mask * inv.auto_mask).sum()
        else:
            denom = inv.valid_mask.sum()
        loss = loss + 0.25 * inv_masked.sum() / denom.clamp_min(1.0)

    if opts.l_depth_consist:
        loss = loss + opts.l_depth_consist_weight * (1.0 - fwd.weight_mask).mean()
        if opts.l_inverse_reconstruction:
            loss = loss + opts.l_depth_consist_weight * (
                1.0 - inv.weight_mask).mean()

    if opts.l_depth_init:
        loss = loss + opts.l_depth_init_weight * ssim_loss(
            target_disparity, init_target_disparity.detach()).mean()

    if opts.l_smooth:
        loss = loss + opts.l_smooth_weight * smooth_loss(target_disparity,
                                                         target_img)

    if opts.l_pose_consist:
        loss = loss + 0.1 * (fwd.poses + inv.poses).abs().mean()

    return loss


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (n, h, w, c), "bilinear")`` of NHWC ``x``:
    half-pixel centres with a triangle kernel widened by the downsampling
    factor (PyTorch's ``antialias=True``; upsampling is plain bilinear).
    A bfloat16 ``x`` (a bfloat16 net's disparity) is resized in float32
    and rounded back: the CPU has no bfloat16 antialiased resize."""
    xf = x.float() if x.dtype == torch.bfloat16 else x
    y = F.interpolate(xf.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


# --------------------------------------------------------------------------
# the trainable subset by optimization mode
# --------------------------------------------------------------------------


def partition_params(mode: str, depth_net: DepthNet, pose_net: PoseNet,
                     skips: Optional[Sequence[torch.Tensor]] = None,
                     disparities: Optional[torch.Tensor] = None):
    """The mode's trainable tensors, by name, and the skips and
    disparities its forward reads (``tcsfm/solver/pft.py:115-157``).

    ``depth_net`` and ``pose_net`` are the optimizer's working copies: the
    mode's parameters get ``requires_grad``, every other parameter loses
    it. 'depth_pred' trains a fresh leaf copy of ``disparities`` and
    'bottleneck' fresh leaf copies of the two deepest skips, which replace
    them in the returned skips. Returns (trainable, skips, disparities).
    """
    for p in list(depth_net.parameters()) + list(pose_net.parameters()):
        p.requires_grad_(False)
    named_depth = dict(depth_net.named_parameters())
    if mode == "encoder":
        trainable = {f"depth.{k}": v for k, v in named_depth.items()
                     if k.startswith("encoder.")}
    elif mode == "all_depth":
        trainable = {f"depth.{k}": v for k, v in named_depth.items()}
    elif mode == "decoder":
        trainable = {f"depth.{k}": v for k, v in named_depth.items()
                     if not k.startswith("encoder.")}
    elif mode == "depth_pred":
        disparities = disparities.detach().clone()
        trainable = {"disp": disparities}
    elif mode == "bottleneck":
        s3, s4 = (s.detach().clone() for s in skips[-2:])
        trainable = {"s4": s4, "s3": s3}
        skips = list(skips[:-2]) + [s3, s4]
    elif mode == "pose":
        trainable = {f"pose.{k}": v for k, v in pose_net.named_parameters()}
    else:
        raise ValueError(f"unknown PFT mode {mode!r}; one of {MODES}")
    for t in trainable.values():
        t.requires_grad_(True)
    return trainable, skips, disparities


class PFTResult(NamedTuple):
    poses_opt: torch.Tensor          # [S, B, 6] averaged final poses
    poses_inv_opt: torch.Tensor
    disp_opt: torch.Tensor           # [B, H, W] flip-merged disparity average
    poses_init: torch.Tensor
    poses_inv_init: torch.Tensor
    losses: torch.Tensor             # [epochs]
    # DNet ground-plane scale factors at the first and the last epoch
    # (0-d tensors)
    scale_init: Union[torch.Tensor, float] = 1.0
    scale_opt: Union[torch.Tensor, float] = 1.0
    # the whole optimization history, with ``record_history``
    poses_hist: Optional[torch.Tensor] = None    # [epochs, S, B, 6]
    disp_hist: Optional[torch.Tensor] = None     # [epochs, B, H, W]


class _Window(NamedTuple):
    """One window's inputs, working copies and initial predictions."""

    target_img: torch.Tensor        # [B, H, W, 3]
    source_imgs: torch.Tensor       # [S, B, H, W, 3]
    K: torch.Tensor                 # [B, 3, 3]
    imgs: torch.Tensor              # [(S+1)B, H, W, 3] target first
    depth_net: DepthNet             # working copies
    pose_net: PoseNet
    skips: List[torch.Tensor]       # NCHW; the trained pair in 'bottleneck'
    disparities: torch.Tensor       # 1/4 res; trained in 'depth_pred'
    init_disps: torch.Tensor        # [(S+1)B, H, W, 1], no grad
    trainable: Dict[str, torch.Tensor]


class PFTOptimizer:
    """Per-window inference-time optimizer (DepthOptimizer equivalent).

    ``depth_net`` and ``pose_net`` hold the weights every window starts
    from; ``optimize_window`` works on copies and leaves them unchanged.
    """

    def __init__(self, cfg: Config, opts: PFTOptions, depth_net: DepthNet,
                 pose_net: PoseNet, mode: str = "encoder",
                 record_history: bool = False):
        if mode not in MODES:
            raise ValueError(f"unknown PFT mode {mode!r}; one of {MODES}")
        self.cfg = cfg
        self.opts = opts
        self.mode = mode
        self.depth_net = depth_net
        self.pose_net = pose_net
        self.record_history = record_history

    # -- functional pieces --------------------------------------------------

    def _flip_merged_disp(self, depth_net: DepthNet,
                          target_img: torch.Tensor) -> torch.Tensor:
        """Normal + flipped disparity merge, [B, H, W]; no gradient."""
        with torch.no_grad():
            both = torch.cat([target_img, target_img.flip(2)])
            disps = depth_net(both)[0]
            scaled, _ = disp_to_depth(disps[..., 0], self.cfg.min_depth,
                                      self.cfg.max_depth)
            n = target_img.shape[0]
            return post_process_disparity(scaled[:n], scaled[n:].flip(2))

    def _prepare(self, batch, device: torch.device) -> _Window:
        """Inputs on ``device`` in the networks' float type, working copies
        of the networks in eval mode, the initial skips and disparities
        (full and 1/4 resolution), and the mode's trainable tensors."""
        for net in (self.depth_net, self.pose_net):
            p = next(net.parameters()).device
            if p.type != device.type:
                raise ValueError(f"model on {p}, inputs asked on {device}")
        dtype = next(self.depth_net.parameters()).dtype

        def as_input(x):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            return x.to(device=device, dtype=dtype).contiguous()

        target_img, source_imgs, K = (as_input(batch[k]) for k in (
            "target_img", "source_imgs", "intrinsics"))
        S, b = source_imgs.shape[:2]
        h, w = target_img.shape[1:3]
        imgs = torch.cat([target_img,
                          source_imgs.reshape((S * b,) + source_imgs.shape[2:])])
        depth_net = copy.deepcopy(self.depth_net).eval()
        pose_net = copy.deepcopy(self.pose_net).eval()
        with torch.no_grad():
            skips = depth_net.encode(imgs)
            init_disps = depth_net.decode(skips)[0]
            disp_small = resize_bilinear(init_disps, h // 4, w // 4)
        trainable, skips, disp_small = partition_params(
            self.mode, depth_net, pose_net, skips=skips,
            disparities=disp_small)
        return _Window(target_img, source_imgs, K, imgs, depth_net, pose_net,
                       skips, disp_small, init_disps, trainable)

    def _forward(self, win: _Window, sampler: Sampler):
        """The PFT loss at the window's current trainable state, and
        (poses, poses_inv, the target's disparity [B, H, W, 1])."""
        cfg, mode = self.cfg, self.mode
        b, h, w = win.target_img.shape[:3]
        if mode in ("encoder", "all_depth"):
            disps = win.depth_net(win.imgs)[0]
        elif mode in ("decoder", "bottleneck"):
            disps = win.depth_net.decode(win.skips)[0]
        elif mode == "depth_pred":
            disps = resize_bilinear(win.disparities, h, w)
        else:  # pose
            disps = win.init_disps
        target_disp = disps[:b]
        depths = torch.stack([
            disp_to_depth(disps[f * b:(f + 1) * b], cfg.min_depth,
                          cfg.max_depth)[1]
            for f in range(win.source_imgs.shape[0] + 1)])
        poses, poses_inv, outputs = solve_pose_iteratively(
            cfg.iterations, depths, win.pose_net, win.target_img,
            win.source_imgs, win.K, sampler=sampler, return_errors=True)
        loss = compute_optimization_loss(
            self.opts, win.target_img, target_disp, win.init_disps[:b],
            outputs["fwd"], outputs["inv"])
        return loss, (poses, poses_inv, target_disp)

    def _gradients(self, loss: torch.Tensor,
                   params: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """d loss / d params; zeros for a tensor the loss does not reach."""
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return tuple(torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads))

    def _make_optimizer(self, params) -> torch.optim.Optimizer:
        """optax's ``adam(lr)`` (betas (0.9, 0.999), eps 1e-8) or
        ``sgd(lr)`` (no momentum)."""
        if self.opts.optimizer == "adam":
            return torch.optim.Adam(params, lr=self.opts.lr,
                                    betas=(0.9, 0.999), eps=1e-8)
        if self.opts.optimizer == "sgd":
            return torch.optim.SGD(params, lr=self.opts.lr)
        raise ValueError(self.opts.optimizer)

    def optimize_window(self, batch: Dict[str, object], device=None,
                        sampler: Sampler = grid_sample) -> PFTResult:
        """Run the full PFT loop on one (batched) window.

        batch: target_img [B,H,W,3], source_imgs [S,B,H,W,3], intrinsics
        [B,3,3] (tensors or arrays): the *clean* stream, as PFT runs at
        test time. ``device`` None is the card; the networks must be on the
        device asked for, and set the float type the window runs in.
        """
        cfg, opts = self.cfg, self.opts
        win = self._prepare(batch, resolve_device(device))
        params = list(win.trainable.values())
        tx = self._make_optimizer(params)

        # epochs-1 optimized steps, then a final evaluation step without
        # an update (the reference skips backprop on the last epoch). The
        # flip-merged disparity (2 extra depth forwards) is formed only
        # for the last ``avg_final_epochs`` entries, from each step's
        # parameters before its update.
        k = min(max(opts.avg_final_epochs - 1, 0), opts.epochs - 1)
        losses, poses_hist, poses_inv_hist, disp_hist = [], [], [], []
        for step in range(opts.epochs - 1):
            loss, (poses, poses_inv, _) = self._forward(win, sampler)
            for p, g in zip(params, self._gradients(loss, params)):
                p.grad = g
            losses.append(loss.detach())
            poses_hist.append(poses.detach())
            poses_inv_hist.append(poses_inv.detach())
            if self.record_history or step >= opts.epochs - 1 - k:
                disp_hist.append(self._flip_merged_disp(win.depth_net,
                                                        win.target_img))
            tx.step()

        with torch.no_grad():
            final_loss, (final_poses, final_poses_inv,
                         final_target_disp) = self._forward(win, sampler)
        disp_hist.append(self._flip_merged_disp(win.depth_net,
                                                win.target_img))

        # DNet ground-plane scale factors at the first and the last epoch;
        # the camera height lives at 1/30 metric scale like the depths
        cam_h = cfg.camera_height / 30.0
        b = win.target_img.shape[0]
        with torch.no_grad():
            init_depth = disp_to_depth(win.init_disps[:b], cfg.min_depth,
                                       cfg.max_depth)[1]
            final_depth = disp_to_depth(final_target_disp, cfg.min_depth,
                                        cfg.max_depth)[1]
            scale_init = scale_recovery(init_depth, win.K, cam_h)
            scale_opt = scale_recovery(final_depth, win.K, cam_h)

        losses = torch.stack(losses + [final_loss])
        poses_hist = torch.stack(poses_hist + [final_poses])
        poses_inv_hist = torch.stack(poses_inv_hist + [final_poses_inv])
        disp_hist = torch.stack(disp_hist)
        n_avg = opts.avg_final_epochs
        return PFTResult(
            poses_opt=poses_hist[-n_avg:].mean(0),
            poses_inv_opt=poses_inv_hist[-n_avg:].mean(0),
            disp_opt=disp_hist[-n_avg:].mean(0),
            poses_init=poses_hist[0],
            poses_inv_init=poses_inv_hist[0],
            losses=losses,
            scale_init=scale_init,
            scale_opt=scale_opt,
            poses_hist=poses_hist if self.record_history else None,
            disp_hist=disp_hist if self.record_history else None,
        )
