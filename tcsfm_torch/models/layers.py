"""Conv building blocks (counterpart of ``tcsfm/models/layers.py``), NCHW inside.

Literal formulations only. The JAX package evaluates some of these through
exact regroupings for the TPU (space-to-depth stems, subpixel phase convs,
phase-space decoder tail); each has the same parameters and computes the
same function up to f32 summation order, so the port keeps the literal
conv and the parameter names of the reference's ``state_dict``.

Each layer takes ``dtype``, its compute dtype (Flax's ``dtype``, default
float32); parameters stay float32. In bfloat16 the casts sit where the
JAX modules place them, written out (not ``torch.autocast``, whose op
lists place them elsewhere): a conv casts its input, weight and bias to
bfloat16 and adds the bias after the conv (``Conv2D``); ``WSConv``
standardizes its weight in float32 and then casts it; ``GroupNorm16`` and
``BatchNorm2d`` normalize in float32 from the bfloat16 input and round
their output to bfloat16, the running statistics staying float32 (Flax's
``force_float32_reductions``). In float32 each layer runs its float32
code unchanged and casts nothing: a net moved to float64 with
``.double()`` (the float64 paths of the coupled solver, PFT and the
distributed BatchNorm) must keep its float64, which a cast to float32
would take away.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tcsfm_torch.dist.mesh import Mesh, all_reduce_sum


def cast_conv(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor], dtype: torch.dtype, stride=1,
              padding=0) -> torch.Tensor:
    """A conv in ``dtype`` as the JAX package's ``Conv2D`` computes it:
    input and weight cast to ``dtype``, the conv, then the bias cast to
    ``dtype`` added (``layers.py:315-326``)."""
    y = F.conv2d(x.to(dtype), weight.to(dtype), None, stride, padding)
    return y if bias is None else y + bias.to(dtype)[:, None, None]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (same parameters and keys) that computes in ``dtype``
    (``cast_conv``); float32 runs ``nn.Conv2d`` itself."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        return cast_conv(x, self.weight, self.bias, self.compute_dtype,
                         self.stride, self.padding)


class ReflConv(nn.Module):
    """Reflection-pad + 3x3 conv, the monodepth2 Conv3x3 (``layers.py:110-130``).

    ``conv`` carries the reference's ``<prefix>.conv.{weight,bias}`` keys.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pad = (kernel - 1) // 2
        self.conv = Conv2d(in_channels, out_channels, kernel, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.pad
        return self.conv(F.pad(x, (p, p, p, p), mode="reflect"))


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with Flax's running-statistics rule (``resnet.py:39-41``).

    Eval mode is ``nn.BatchNorm2d``'s (running statistics, eps 1e-5). In
    train mode the batch statistics normalize, and the running ones move
    as ``flax.linen.BatchNorm(momentum=0.9)`` moves them:
    ``r = 0.9 * r + 0.1 * batch`` with the *biased* batch variance, where
    ``nn.BatchNorm2d`` would use the unbiased one (n/(n-1) larger: 36/35
    at layer4 of six 64x96 images). The update runs under ``no_grad``.

    Inside ``global_batch_stats(net, mesh)`` with more than one rank, the
    train-mode statistics are the global batch's, as under the JAX
    package's mesh: the per-channel sums and counts are all-reduced for
    the mean, then the sums of squared deviations for the biased variance,
    both through the differentiable all-reduce, and the running statistics
    move by the same rule from those global values. At world size 1, and
    outside the block, the path is the one-card one.

    With a bfloat16 ``dtype`` the layer runs that float32 computation on
    the input cast to float32 and rounds its output to bfloat16, as Flax's
    BatchNorm does under ``force_float32_reductions`` (its statistics, the
    normalization, the scale and bias, all float32).
    """

    MOMENTUM = 0.9    # Flax's: the weight of the old running value
    mesh: Optional[Mesh] = None     # set by ``global_batch_stats``

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__(channels, eps=1e-5)
        self.compute_dtype = dtype

    def _move_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(self.MOMENTUM).add_(
            mean, alpha=1.0 - self.MOMENTUM)
        self.running_var.mul_(self.MOMENTUM).add_(
            var, alpha=1.0 - self.MOMENTUM)
        self.num_batches_tracked.add_(1)

    def _global_forward(self, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        c = x.shape[1]
        # the count by a fill on the device: a host tensor's copy would
        # make the host wait for the card at every layer
        sums = all_reduce_sum(torch.cat([x.sum(dim=(0, 2, 3)),
                                         x.new_full((1,), x.numel() // c)]),
                              mesh)
        n = sums[c]
        mean = sums[:c] / n
        dev = x - mean[None, :, None, None]
        var = all_reduce_sum((dev * dev).sum(dim=(0, 2, 3)), mesh) / n
        with torch.no_grad():
            self._move_running(mean, var)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return dev * scale[None, :, None, None] + self.bias[None, :, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:     # or float64 (.double())
            return self._forward(x)
        return self._forward(x.float()).to(self.compute_dtype)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.mesh is not None and self.mesh.world_size > 1:
            return self._global_forward(x, self.mesh)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self._move_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=self.eps)


@contextlib.contextmanager
def global_batch_stats(net: nn.Module, mesh: Optional[Mesh]):
    """Inside the block, ``net``'s ``BatchNorm2d`` layers take their
    train-mode statistics over ``mesh``'s global batch (a no-op for None
    or one rank)."""
    layers = [m for m in net.modules() if isinstance(m, BatchNorm2d)]
    for m in layers:
        m.mesh = mesh
    try:
        yield
    finally:
        for m in layers:
            m.mesh = None


class WSConv(Conv2d):
    """Weight-standardized conv, zero padding (``layers.py:301-377``).

    Per output channel the kernel loses its mean and is divided by its
    sample standard deviation (Bessel-corrected) plus 1e-5, as the
    reference's ``weight.view(O, -1).std(dim=1)`` does; in the weight's
    own dtype (float32), then cast to ``dtype`` for the conv.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        wc = w - w.mean(dim=(1, 2, 3), keepdim=True)
        n = w[0].numel()
        std = torch.sqrt((wc * wc).sum(dim=(1, 2, 3), keepdim=True) / (n - 1))
        if self.compute_dtype == torch.float32:
            return F.conv2d(x, wc / (std + 1e-5), self.bias, self.stride,
                            self.padding)
        return cast_conv(x, wc / (std + 1e-5), self.bias, self.compute_dtype,
                         self.stride, self.padding)


class GroupNorm16(nn.GroupNorm):
    """GroupNorm with 16 groups and eps 1e-5 (``layers.py:427-437``), in
    float32; a bfloat16 ``dtype`` casts the input up and the output
    back."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__(16, channels, eps=1e-5)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:     # or float64 (.double())
            return super().forward(x)
        return super().forward(x.float()).to(self.compute_dtype)


class ConvGN(nn.Sequential):
    """WSConv (stride 2, pad (k-1)//2) + GroupNorm16 + ReLU (``layers.py:440-454``).

    Indices 0 and 1 give the reference's ``conv{i}.0`` / ``conv{i}.1`` keys.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__(
            WSConv(in_channels, out_channels, kernel, stride=2,
                   padding=(kernel - 1) // 2, dtype=dtype),
            GroupNorm16(out_channels, dtype=dtype),
            nn.ReLU(),
        )


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor (``layers.py:457-467``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Upsample2x(nn.Module):
    """``upsample2x_nearest`` as a module, the first step of an upconv."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2x_nearest(x)
