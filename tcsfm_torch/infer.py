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
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from tcsfm_torch.config import Config
from tcsfm_torch.geom.warp import Sampler
from tcsfm_torch.models.depth import DepthNet
from tcsfm_torch.models.pose import PoseNet
from tcsfm_torch.ops.grid_sample import grid_sample
from tcsfm_torch.solver.coupled import solve_disp, solve_pose_iteratively
from tcsfm_torch.utils.helpers import disp_to_depth


def _resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device with no card present raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return device


@torch.no_grad()
def _init_weights(model: nn.Module, generator: torch.Generator,
                  uniform: bool) -> None:
    """Seeded random weights: He-normal (fan-out) for the depth net's convs
    or Xavier-uniform for the pose net's, as the JAX package initialises
    them; zero biases; unit norm scales."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            o, i, kh, kw = m.weight.shape
            if uniform:
                bound = math.sqrt(6.0 / ((i + o) * kh * kw))
                w = (torch.rand(m.weight.shape, generator=generator) * 2 - 1) * bound
            else:
                w = torch.randn(m.weight.shape, generator=generator)
                w = w * math.sqrt(2.0 / (o * kh * kw))
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()


def build_models(cfg: Config, device=None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[DepthNet, PoseNet]:
    """(depth_net, pose_net) in eval mode on ``device``, with seeded random
    weights drawn from ``generator`` (a CPU generator; seed 0 if None).
    Load trained weights with ``load_state_dict`` (see ``models.convert``)."""
    device = _resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    depth_net = DepthNet(num_scales=cfg.num_scales)
    pose_net = PoseNet()
    _init_weights(depth_net, generator, uniform=False)
    _init_weights(pose_net, generator, uniform=True)
    return depth_net.to(device).eval(), pose_net.to(device).eval()


@torch.no_grad()
def coupled_forward(depth_net: DepthNet, pose_net: PoseNet, target_img,
                    source_imgs, K, cfg: Config, device=None,
                    sampler: Sampler = grid_sample):
    """The coupled inference forward.

    Args:
      target_img:  [B, H, W, 3]; source_imgs: [S, B, H, W, 3]; K: [B, 3, 3]
                   (tensors or arrays; moved to ``device`` as float32).
      sampler:     the warps' sampler: ``grid_sample`` (the CUDA kernel on
                   the card) or ``ops.grid_sample.grid_sample_plain``.

    Returns:
      poses [S, B, 6], poses_inv [S, B, 6], the target's disparity
      [B, H, W, 1] and the pose chain [2SB, cfg.iterations, 6].
    """
    device = _resolve_device(device)
    for net in (depth_net, pose_net):
        p = next(net.parameters()).device
        if p.type != device.type:
            raise ValueError(f"model on {p}, inputs asked on {device}")

    def as_input(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(device=device, dtype=torch.float32).contiguous()

    target_img, source_imgs, K = map(as_input, (target_img, source_imgs, K))
    disparities = solve_disp(depth_net, target_img, source_imgs)
    depths = torch.stack([disp_to_depth(d[0], cfg.min_depth, cfg.max_depth)[1]
                          for d in disparities])
    poses, poses_inv, chain = solve_pose_iteratively(
        cfg.iterations, depths, pose_net, target_img, source_imgs, K,
        sampler=sampler)
    return poses, poses_inv, disparities[0][0], chain
