"""ResNet-18 encoder of the depth network (counterpart of ``tcsfm/models/resnet.py``).

torchvision's layout and names: conv1 (7x7, s2) → bn1 → ReLU → maxpool
(3x3, s2, pad 1) → layer1..layer4 of two BasicBlocks each at
[64, 128, 256, 512] channels, emitting the 5 skip features the decoder
reads. BatchNorm runs in eval mode (running statistics, eps 1e-5).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, channels, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(channels, eps=1e-5)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2d(channels, channels, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(channels, eps=1e-5)
        self.downsample = None
        if stride != 1 or in_channels != channels:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, channels, 1, stride, bias=False),
                nn.BatchNorm2d(channels, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNet18Encoder(nn.Module):
    """5-skip ResNet-18 feature extractor, NCHW."""

    stage_features = (64, 128, 256, 512)

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        prev = 64
        for si, f in enumerate(self.stage_features):
            stride = 1 if si == 0 else 2
            self.add_module(f"layer{si + 1}", nn.Sequential(
                BasicBlock(prev, f, stride), BasicBlock(f, f, 1)))
            prev = f

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.relu(self.bn1(self.conv1(x)))
        feats = [x]                                           # H/2, 64
        x = self.maxpool(x)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            feats.append(x)                                   # H/4..H/32
        return feats
