"""Pose network (counterpart of ``tcsfm/models/pose.py:20-45``).

Stacked (target, source) pair [N, H, W, 6] (``in_channels`` 8 with
``flow_type='classical'``'s two flow channels) → (x - 0.45) / 0.22 →
seven ConvGN stages [16, 32, 64, 128, 256, 256, 256] with kernels
7/5/3/3/3/3/3, all stride 2 → 1x1 conv head → spatial mean → 0.01 * pose
[N, 6] ([t, r]). Module names follow the reference's ``state_dict``
(``conv{i}.0``, ``conv{i}.1``, ``pose_pred``). ``dtype`` is the layers'
compute dtype: the input is normalized in float32 and then cast to it,
and the pose is returned in float32 (``tcsfm/models/pose.py:36-46``).
"""

from __future__ import annotations

import torch
from torch import nn

from tcsfm_torch.models.layers import Conv2d, ConvGN
from tcsfm_torch.utils.helpers import weak

CONV_CHANNELS = (16, 32, 64, 128, 256, 256, 256)
CONV_KERNELS = (7, 5, 3, 3, 3, 3, 3)


class PoseNet(nn.Module):
    def __init__(self, in_channels: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.compute_dtype = dtype
        prev = in_channels
        for i, (ch, k) in enumerate(zip(CONV_CHANNELS, CONV_KERNELS)):
            self.add_module(f"conv{i + 1}", ConvGN(prev, ch, k, dtype=dtype))
            prev = ch
        self.pose_pred = Conv2d(prev, 6, 1, dtype=dtype)

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        """imgs: [N, H, W, in_channels] stacked pair → [N, 6] pose
        [t, r] * 0.01, in float32 from a bfloat16 net (float32 casts
        nothing, so a net moved to float64 keeps its float64,
        ``models/layers.py``)."""
        x = (imgs.permute(0, 3, 1, 2) - 0.45) / 0.22
        if self.compute_dtype != torch.float32:
            x = x.to(self.compute_dtype)
        for i in range(len(CONV_CHANNELS)):
            x = getattr(self, f"conv{i + 1}")(x)
        pose = self.pose_pred(x).mean(dim=(2, 3))
        pose = weak(0.01, pose) * pose
        return pose if self.compute_dtype == torch.float32 else pose.float()
