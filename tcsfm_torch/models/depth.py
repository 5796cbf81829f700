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

``make_tail_apply`` is a second route to the same disparity: the decoder up
to the last upconv's conv, then the fused full-resolution tail
(``ops.decoder_tail``, a CUDA kernel on the card) in place of iconv4, the
feature conv and the head.

``dtype`` is the compute dtype of every layer (``tcsfm/models/depth.py``):
the input is normalized in float32 and then cast to it, the decoder's
ELUs and sigmoids run in it, so a bfloat16 net's disparity is bfloat16,
as the JAX package's is. The tail route of a bfloat16 net runs the bf16
tail and casts its float32 disparity to bfloat16, as
``experiments/decoder_tail.py:285`` does.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tcsfm_torch.models.layers import ReflConv, Upsample2x
from tcsfm_torch.models.resnet import ResNet18Encoder
from tcsfm_torch.ops.decoder_tail import decoder_tail

UPCONV_PLANES = (256, 128, 64, 64, 32)
# channels of the decoder features a head can read, coarse to fine: the
# bottleneck, the outputs of iconv0..iconv3, and the output of iconv4
DECODER_FEATURES = (512,) + UPCONV_PLANES


class ResnetEncoder(nn.Module):
    """Holds the ResNet as ``encoder`` to keep the ``encoder.encoder.*`` keys."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = ResNet18Encoder(dtype=dtype)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.encoder(x)


class DepthNet(nn.Module):
    def __init__(self, num_scales: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_scales = num_scales
        self.compute_dtype = dtype
        self.encoder = ResnetEncoder(dtype)
        planes = (512,) + UPCONV_PLANES
        self.depth_upconvs = nn.ModuleList(
            nn.Sequential(Upsample2x(),
                          ReflConv(planes[i], planes[i + 1], dtype=dtype),
                          nn.ELU())
            for i in range(len(UPCONV_PLANES)))
        self.iconvs = nn.ModuleList(
            nn.Sequential(ReflConv(p, p, dtype=dtype), nn.ELU())
            for p in UPCONV_PLANES)
        feats_in = DECODER_FEATURES[-num_scales:]
        self.feature_convs = nn.ModuleList(
            nn.Sequential(ReflConv(c, 8, dtype=dtype), nn.ELU())
            for c in feats_in)
        # head k reads its scale's 8 features and those of every coarser scale
        self.predict_disps = nn.ModuleList(
            nn.Sequential(ReflConv(8 * (k + 1), 1, dtype=dtype), nn.Sigmoid())
            for k in range(num_scales))

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Image [B, H, W, 3] → 5 NCHW skip features, after the reference's
        (x - 0.45) / 0.22 input normalization (in the images' float32, then
        cast to a bfloat16 compute dtype; float32 casts nothing, so a net
        moved to float64 keeps its float64, ``models/layers.py``)."""
        x = (x.permute(0, 3, 1, 2) - 0.45) / 0.22
        if self.compute_dtype != torch.float32:
            x = x.to(self.compute_dtype)
        return self.encoder(x)

    def _trunk(self, skips: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Decoder stages 0-3: the bottleneck and the outputs of
        iconv0..iconv3, coarse to fine."""
        out = skips[-1]
        features = []
        for i in range(len(self.iconvs) - 1):
            features.append(out)
            up = self.depth_upconvs[i](out) + skips[-(i + 2)]
            out = self.iconvs[i](up)
        features.append(out)
        return features

    def decode(self, skips: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """NCHW skip features → sigmoid disparities [B, h_s, w_s, 1], finest
        scale first."""
        features = self._trunk(skips)
        features.append(self.iconvs[-1](self.depth_upconvs[-1](features[-1])))

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

    def decode_tail_input(self, skips: Sequence[torch.Tensor]) -> torch.Tensor:
        """Decoder stages 0-3 and the last upconv without its ELU: the input
        [B, 32, H, W] of the fused tail (``ops.decoder_tail``), which
        replaces iconv4, the feature conv and the head (counterpart of
        ``decode_phase_tail``, without its phase layout)."""
        assert self.num_scales == 1
        upsample, conv, _elu = self.depth_upconvs[-1]
        return conv(upsample(self._trunk(skips)[-1]))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.decode(self.encode(x))


def tail_weights(depth_net: DepthNet) -> Tuple[torch.Tensor, ...]:
    """(w1, b1, w2, b2, w3, b3) of the fused tail: the convs of iconv4, the
    first feature conv and the first head."""
    convs = (depth_net.iconvs[-1][0].conv, depth_net.feature_convs[0][0].conv,
             depth_net.predict_disps[0][0].conv)
    return tuple(t for c in convs for t in (c.weight, c.bias))


def make_tail_apply(depth_net: DepthNet) -> Callable[[torch.Tensor],
                                                     List[torch.Tensor]]:
    """imgs [N, H, W, 3] -> [disparity [N, H, W, 1]] through the fused tail:
    ``solve_disp``'s ``depth_apply`` in place of the net itself (the
    counterpart of ``experiments/decoder_tail.py::make_tail_apply``). The
    tail of the net's dtype (``z``'s: the f32 or the bf16 tail), its
    disparity cast to that dtype. num_scales == 1 only."""

    def apply(imgs: torch.Tensor) -> List[torch.Tensor]:
        z = depth_net.decode_tail_input(depth_net.encode(imgs))
        return [decoder_tail(z, *tail_weights(depth_net)).to(z.dtype)]

    return apply
