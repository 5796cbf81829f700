"""ResNet-18 encoder of the depth network (counterpart of ``tcsfm/models/resnet.py``).

torchvision's layout and names: conv1 (7x7, s2) → bn1 → ReLU → maxpool
(3x3, s2, pad 1) → layer1..layer4 of two BasicBlocks each at
[64, 128, 256, 512] channels, emitting the 5 skip features the decoder
reads. BatchNorm (eps 1e-5) uses the running statistics in eval mode; in
train mode it normalizes with the batch's and updates the running ones by
Flax's rule (``layers.BatchNorm2d``). ``dtype`` is the compute dtype of
every conv and BatchNorm (``tcsfm/models/resnet.py:39-59,81-100``).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from tcsfm_torch.models.layers import BatchNorm2d, Conv2d


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_channels, channels, 3, stride, 1, bias=False,
                            dtype=dtype)
        self.bn1 = BatchNorm2d(channels, dtype=dtype)
        self.relu = nn.ReLU()
        self.conv2 = Conv2d(channels, channels, 3, 1, 1, bias=False,
                            dtype=dtype)
        self.bn2 = BatchNorm2d(channels, dtype=dtype)
        self.downsample = None
        if stride != 1 or in_channels != channels:
            self.downsample = nn.Sequential(
                Conv2d(in_channels, channels, 1, stride, bias=False,
                       dtype=dtype),
                BatchNorm2d(channels, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNet18Encoder(nn.Module):
    """5-skip ResNet-18 feature extractor, NCHW."""

    stage_features = (64, 128, 256, 512)

    def __init__(self, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_channels, 64, 7, 2, 3, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(64, dtype=dtype)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        prev = 64
        for si, f in enumerate(self.stage_features):
            stride = 1 if si == 0 else 2
            self.add_module(f"layer{si + 1}", nn.Sequential(
                BasicBlock(prev, f, stride, dtype),
                BasicBlock(f, f, 1, dtype)))
            prev = f

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.relu(self.bn1(self.conv1(x)))
        feats = [x]                                           # H/2, 64
        x = self.maxpool(x)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            feats.append(x)                                   # H/4..H/32
        return feats
