"""Depth network: ResNet-18 encoder + sigmoid-disparity decoder
(counterpart of ``tcsfm/models/depth.py:34-147``).

Decoder: upconv stages [512→256→128→64→64→32], each a 2x nearest upsample,
a reflect-pad conv3x3 and an ELU, with *additive* skips for the first four
stages, each followed by a reflect conv3x3 + ELU ("iconv"); per-scale
8-channel feature convs feed sigmoid disparity heads. ``encode`` and
``decode`` stay separate, as PFT needs them. Module names follow the
reference's ``state_dict`` (``encoder.encoder.*``, ``depth_upconvs.{i}.1``,
``iconvs.{i}.0``, ``feature_convs.{i}.0``, ``predict_disps.{i}.0``).

Images and disparities are NHWC at ``forward``/``decode``'s boundary, as in
the JAX package; the skip features between ``encode`` and ``decode`` are
NCHW. ``.train()`` is the JAX package's ``train=True``: the encoder's
BatchNorm normalizes with batch statistics and updates its running ones by
Flax's rule (``layers.BatchNorm2d``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tcsfm_torch.models.layers import ReflConv, Upsample2x
from tcsfm_torch.models.resnet import ResNet18Encoder

UPCONV_PLANES = (256, 128, 64, 64, 32)
# channels of the decoder features a head can read, coarse to fine: the
# bottleneck, the outputs of iconv0..iconv3, and the output of iconv4
DECODER_FEATURES = (512,) + UPCONV_PLANES


class ResnetEncoder(nn.Module):
    """Holds the ResNet as ``encoder`` to keep the ``encoder.encoder.*`` keys."""

    def __init__(self):
        super().__init__()
        self.encoder = ResNet18Encoder()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.encoder(x)


class DepthNet(nn.Module):
    def __init__(self, num_scales: int = 1):
        super().__init__()
        self.num_scales = num_scales
        self.encoder = ResnetEncoder()
        planes = (512,) + UPCONV_PLANES
        self.depth_upconvs = nn.ModuleList(
            nn.Sequential(Upsample2x(), ReflConv(planes[i], planes[i + 1]),
                          nn.ELU())
            for i in range(len(UPCONV_PLANES)))
        self.iconvs = nn.ModuleList(
            nn.Sequential(ReflConv(p, p), nn.ELU()) for p in UPCONV_PLANES)
        feats_in = DECODER_FEATURES[-num_scales:]
        self.feature_convs = nn.ModuleList(
            nn.Sequential(ReflConv(c, 8), nn.ELU()) for c in feats_in)
        # head k reads its scale's 8 features and those of every coarser scale
        self.predict_disps = nn.ModuleList(
            nn.Sequential(ReflConv(8 * (k + 1), 1), nn.Sigmoid())
            for k in range(num_scales))

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Image [B, H, W, 3] → 5 NCHW skip features, after the reference's
        (x - 0.45) / 0.22 input normalization."""
        x = (x.permute(0, 3, 1, 2) - 0.45) / 0.22
        return self.encoder(x)

    def decode(self, skips: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """NCHW skip features → sigmoid disparities [B, h_s, w_s, 1], finest
        scale first."""
        out = skips[-1]
        features = []
        for i in range(len(self.iconvs) - 1):
            features.append(out)
            up = self.depth_upconvs[i](out) + skips[-(i + 2)]
            out = self.iconvs[i](up)
        features.append(out)
        out = self.iconvs[-1](self.depth_upconvs[-1](out))
        features.append(out)

        n = self.num_scales
        feats = [conv(f) for conv, f in zip(self.feature_convs, features[-n:])]
        # each head sees its scale's features concatenated with all coarser
        # scales' upsized to it (nearest)
        merged = [feats[0]]
        for k in range(1, n):
            size = feats[k].shape[-2:]
            ups = [F.interpolate(feats[j], size=size, mode="nearest")
                   for j in range(k)]
            merged.append(torch.cat(ups + [feats[k]], 1))
        disps = [head(m) for head, m in zip(self.predict_disps, merged)]
        return [d.permute(0, 2, 3, 1) for d in reversed(disps)]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.decode(self.encode(x))
