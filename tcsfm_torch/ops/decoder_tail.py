"""The depth decoder's full-resolution tail: the CUDA kernel's wrapper and
its plain version.

Port of ``experiments/decoder_tail.py``: from the last upconv's pre-ELU
output to the disparity, ELU -> 3x3 conv 32->32 (``iconv4``) -> ELU -> 3x3
conv 32->8 (``feature_conv0``) -> ELU -> 3x3 conv 8->1 (``disp_head0``) ->
sigmoid, every conv over its own input reflect-padded by one pixel.

``decoder_tail`` is what the port calls (``models/depth.py::
make_tail_apply``). On CPU tensors it runs ``decoder_tail_plain`` under
ordinary autograd. On CUDA tensors it launches the fused kernel of
``csrc/decoder_tail.cu`` inside an autograd Function (``_DecoderTail``)
whose backward recomputes through ``decoder_tail_plain``, as the JAX
package's custom VJP differentiates its XLA reference; there is no backward
kernel, as there is none in JAX. A failed launch raises.

The TPU kernel took the upconv's output in its subpixel phase layout
``[N, H/2, W/2, 4*32]`` and ran in bf16; the kernel takes the
full-resolution ``[N, 32, H, W]`` that the port's decoder produces, NCHW
contiguous on the card, in f32. (On the CPU the decoder's tensors are
channels_last, which the NHWC images hand down; the plain version takes
any layout.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tcsfm_torch.ops import _build
from tcsfm_torch.ops.grid_sample import _raise_on, _stream

LAUNCHES = 0    # kernel launches by the wrapper below, read by chip_smoke.py

C1, C2 = 32, 8      # channels of the tail's input and of its feature conv
MIN_SIZE = 4


def _refl_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), w, b)


def decoder_tail_plain(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """The literal tail (counterpart of ``decoder_tail_reference``).

    Args:
      x:  [N, 32, H, W], the last upconv's output before its ELU.
      w1, b1: [32, 32, 3, 3], [32]; w2, b2: [8, 32, 3, 3], [8];
      w3, b3: [1, 8, 3, 3], [1] (``nn.Conv2d``'s OIHW).
    Returns:
      the disparity [N, H, W, 1].
    """
    x = F.elu(x)
    x = F.elu(_refl_conv(x, w1, b1))
    x = F.elu(_refl_conv(x, w2, b2))
    return torch.sigmoid(_refl_conv(x, w3, b3)).permute(0, 2, 3, 1)


_WEIGHT_SHAPES = ((C1, C1, 3, 3), (C1,), (C2, C1, 3, 3), (C2,), (1, C2, 3, 3),
                  (1,))


def _check(x: torch.Tensor, weights) -> None:
    tensors = (x, *weights)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"decoder_tail takes float32, got "
                        f"{[t.dtype for t in tensors]}")
    if x.dim() != 4 or x.shape[1] != C1:
        raise ValueError(f"decoder_tail takes x [N, {C1}, H, W], got "
                         f"{tuple(x.shape)}")
    if min(x.shape[2:]) < MIN_SIZE:
        raise ValueError(f"decoder_tail takes H, W >= {MIN_SIZE}, got "
                         f"{tuple(x.shape[2:])}")
    got = tuple(tuple(t.shape) for t in weights)
    if got != _WEIGHT_SHAPES:
        raise ValueError(f"decoder_tail weights {got}, expected "
                         f"{_WEIGHT_SHAPES}")
    if any(t.device != x.device for t in weights):
        raise ValueError(f"x on {x.device}, weights on "
                         f"{[str(t.device) for t in weights]}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decoder_tail runs on cpu or cuda, not {x.device}")
    if x.device.type == "cuda" and not all(t.is_contiguous()
                                           for t in tensors):
        raise ValueError("the decoder_tail kernel takes contiguous (NCHW) "
                         "tensors")


def _launch(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    global LAUNCHES
    n, _, h, w = x.shape
    out = x.new_empty(n, h, w, 1)
    _raise_on(_build.load().tcsfm_decoder_tail_fwd(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(), n, h, w,
        x.device.index, _stream(x.device)), "decoder_tail")
    LAUNCHES += 1
    return out


class _DecoderTail(torch.autograd.Function):
    """The fused kernel; as its backward, autodiff of
    ``decoder_tail_plain`` recomputed from the saved inputs (JAX's
    ``_tail_bwd``)."""

    @staticmethod
    def forward(ctx, *inputs):
        ctx.save_for_backward(*inputs)
        return _launch(*inputs)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(k)
                      for t, k in zip(ctx.saved_tensors, need)]
            out = decoder_tail_plain(*inputs)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if k else None for k in need)


def decoder_tail(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """``decoder_tail_plain``'s contract; differentiable.

    CPU tensors, in any layout, go to ``decoder_tail_plain``. CUDA tensors,
    contiguous, launch the fused kernel on the current stream and raise if
    the launch fails.
    """
    weights = (w1, b1, w2, b2, w3, b3)
    _check(x, weights)
    if x.device.type == "cpu":
        return decoder_tail_plain(x, *weights)
    return _DecoderTail.apply(x, *weights)
