"""Coupled depth-pose inference: the port's main path.

The forward that ``__graft_entry__.entry()`` compiles in the JAX package:
``solve_disp`` → ``disp_to_depth`` → ``solve_pose_iteratively`` (pose-only).
Inputs and outputs keep the JAX package's NHWC layout and source-major
``[S, B, ...]`` packing.

Both entry points run on the card unless the caller passes
``device="cpu"``; with no card they raise rather than fall back.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tcsfm_torch.config import Config
from tcsfm_torch.geom.warp import Sampler
from tcsfm_torch.models.depth import DepthNet
from tcsfm_torch.models.pose import PoseNet
from tcsfm_torch.ops.grid_sample import grid_sample
from tcsfm_torch.solver.coupled import solve_disp, solve_pose_iteratively
from tcsfm_torch.utils.helpers import disp_to_depth, resolve_device


# std of a standard normal truncated to [-2, 2] (Flax's truncated_normal)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def _init_weights(model: nn.Module, generator: torch.Generator,
                  uniform: bool) -> None:
    """Seeded random weights in the JAX package's distributions
    (``tcsfm/models/layers.py:23``): the depth net's convs from
    ``kaiming_out``, Flax's ``variance_scaling(2.0, "fan_out",
    "truncated_normal")`` (a normal of std sigma / 0.87962566 cut at two
    of that std, sigma^2 = 2 / fan_out, so the kept weights have std
    sigma); the pose net's from Xavier-uniform; zero biases; unit norm
    scales. The numbers drawn differ from JAX's: the generators differ."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            o, i, kh, kw = m.weight.shape
            if uniform:
                bound = math.sqrt(6.0 / ((i + o) * kh * kw))
                w = (torch.rand(m.weight.shape, generator=generator) * 2 - 1) * bound
            else:
                std = math.sqrt(2.0 / (o * kh * kw)) / _TRUNC_STD
                w = nn.init.trunc_normal_(torch.empty(m.weight.shape), std=std,
                                          a=-2.0 * std, b=2.0 * std,
                                          generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()


def build_models(cfg: Config, device=None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[DepthNet, PoseNet]:
    """(depth_net, pose_net) in eval mode on ``device``, computing in
    ``cfg.compute_dtype`` on float32 parameters, with seeded random weights
    drawn from ``generator`` (a CPU generator; seed 0 if None). Load
    trained weights with ``load_state_dict`` (see ``models.convert``; the
    state dicts are float32 in either dtype)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    depth_net = DepthNet(num_scales=cfg.num_scales, dtype=cfg.dtype)
    pose_net = PoseNet(cfg.pose_input_channels, dtype=cfg.dtype)
    _init_weights(depth_net, generator, uniform=False)
    _init_weights(pose_net, generator, uniform=True)
    return depth_net.to(device).eval(), pose_net.to(device).eval()


@torch.no_grad()
def coupled_forward(depth_net: DepthNet, pose_net: PoseNet, target_img,
                    source_imgs, K, cfg: Config, device=None,
                    sampler: Sampler = grid_sample,
                    depth_apply: Optional[Callable] = None):
    """The coupled inference forward.

    Args:
      target_img:  [B, H, W, 3]; source_imgs: [S, B, H, W, 3]; K: [B, 3, 3]
                   (tensors or arrays; moved to ``device`` as float32).
      sampler:     the warps' sampler: ``grid_sample`` (the CUDA kernel on
                   the card) or ``ops.grid_sample.grid_sample_plain``.
      depth_apply: images -> [disparity]; None runs ``depth_net`` itself,
                   ``models.depth.make_tail_apply(depth_net)`` the same net
                   through the fused decoder tail.

    Returns:
      poses [S, B, 6], poses_inv [S, B, 6], the target's disparity
      [B, H, W, 1] (in the depth net's compute dtype) and the pose chain
      [2SB, cfg.iterations, 6].
    """
    device = resolve_device(device)
    for net in (depth_net, pose_net):
        p = next(net.parameters()).device
        if p.type != device.type:
            raise ValueError(f"model on {p}, inputs asked on {device}")

    def as_input(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(device=device, dtype=torch.float32).contiguous()

    target_img, source_imgs, K = map(as_input, (target_img, source_imgs, K))
    disparities = solve_disp(depth_net if depth_apply is None else depth_apply,
                             target_img, source_imgs)
    depths = torch.stack([disp_to_depth(d[0], cfg.min_depth, cfg.max_depth)[1]
                          for d in disparities])
    poses, poses_inv, chain = solve_pose_iteratively(
        cfg.iterations, depths, pose_net, target_img, source_imgs, K,
        sampler=sampler)
    return poses, poses_inv, disparities[0][0], chain
