"""Conv building blocks (counterpart of ``tcsfm/models/layers.py``), NCHW inside.

Literal formulations only. The JAX package evaluates some of these through
exact regroupings for the TPU (space-to-depth stems, subpixel phase convs,
phase-space decoder tail); each has the same parameters and computes the
same function up to f32 summation order, so the port keeps the literal
conv and the parameter names of the reference's ``state_dict``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ReflConv(nn.Module):
    """Reflection-pad + 3x3 conv, the monodepth2 Conv3x3 (``layers.py:110-130``).

    ``conv`` carries the reference's ``<prefix>.conv.{weight,bias}`` keys.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3):
        super().__init__()
        self.pad = (kernel - 1) // 2
        self.conv = nn.Conv2d(in_channels, out_channels, kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.pad
        return self.conv(F.pad(x, (p, p, p, p), mode="reflect"))


class WSConv(nn.Conv2d):
    """Weight-standardized conv, zero padding (``layers.py:301-377``).

    Per output channel the kernel loses its mean and is divided by its
    sample standard deviation (Bessel-corrected) plus 1e-5, as the
    reference's ``weight.view(O, -1).std(dim=1)`` does.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        wc = w - w.mean(dim=(1, 2, 3), keepdim=True)
        n = w[0].numel()
        std = torch.sqrt((wc * wc).sum(dim=(1, 2, 3), keepdim=True) / (n - 1))
        return F.conv2d(x, wc / (std + 1e-5), self.bias, self.stride,
                        self.padding)


class GroupNorm16(nn.GroupNorm):
    """GroupNorm with 16 groups and eps 1e-5 (``layers.py:427-437``)."""

    def __init__(self, channels: int):
        super().__init__(16, channels, eps=1e-5)


class ConvGN(nn.Sequential):
    """WSConv (stride 2, pad (k-1)//2) + GroupNorm16 + ReLU (``layers.py:440-454``).

    Indices 0 and 1 give the reference's ``conv{i}.0`` / ``conv{i}.1`` keys.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3):
        super().__init__(
            WSConv(in_channels, out_channels, kernel, stride=2,
                   padding=(kernel - 1) // 2),
            GroupNorm16(out_channels),
            nn.ReLU(),
        )


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor (``layers.py:457-467``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Upsample2x(nn.Module):
    """``upsample2x_nearest`` as a module, the first step of an upconv."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2x_nearest(x)
