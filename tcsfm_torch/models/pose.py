"""Pose network (counterpart of ``tcsfm/models/pose.py:20-45``).

Stacked (target, source) pair [N, H, W, 6] (``in_channels`` 8 with
``flow_type='classical'``'s two flow channels) → (x - 0.45) / 0.22 →
seven ConvGN stages [16, 32, 64, 128, 256, 256, 256] with kernels
7/5/3/3/3/3/3, all stride 2 → 1x1 conv head → spatial mean → 0.01 * pose
[N, 6] ([t, r]). Module names follow the reference's ``state_dict``
(``conv{i}.0``, ``conv{i}.1``, ``pose_pred``).
"""

from __future__ import annotations

import torch
from torch import nn

from tcsfm_torch.models.layers import ConvGN

CONV_CHANNELS = (16, 32, 64, 128, 256, 256, 256)
CONV_KERNELS = (7, 5, 3, 3, 3, 3, 3)


class PoseNet(nn.Module):
    def __init__(self, in_channels: int = 6):
        super().__init__()
        self.in_channels = in_channels
        prev = in_channels
        for i, (ch, k) in enumerate(zip(CONV_CHANNELS, CONV_KERNELS)):
            self.add_module(f"conv{i + 1}", ConvGN(prev, ch, k))
            prev = ch
        self.pose_pred = nn.Conv2d(prev, 6, 1)

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        """imgs: [N, H, W, in_channels] stacked pair → [N, 6] pose
        [t, r] * 0.01."""
        x = (imgs.permute(0, 3, 1, 2) - 0.45) / 0.22
        for i in range(len(CONV_CHANNELS)):
            x = getattr(self, f"conv{i + 1}")(x)
        return 0.01 * self.pose_pred(x).mean(dim=(2, 3))
