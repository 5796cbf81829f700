"""The depth decoder's full-resolution tail: the CUDA kernel's wrapper and
its plain version.

Port of ``experiments/decoder_tail.py``: from the last upconv's pre-ELU
output to the disparity, ELU -> 3x3 conv 32->32 (``iconv4``) -> ELU -> 3x3
conv 32->8 (``feature_conv0``) -> ELU -> 3x3 conv 8->1 (``disp_head0``) ->
sigmoid, every conv over its own input reflect-padded by one pixel.

``decoder_tail`` is what the port calls (``models/depth.py::
make_tail_apply``). On CPU tensors it runs the plain version. On CUDA
tensors it launches a fused kernel of ``csrc/decoder_tail.cu`` inside an
autograd Function whose backward recomputes through ``decoder_tail_plain``
in float32, as the JAX package's custom VJP differentiates its f32 XLA
reference; there is no backward kernel, as there is none in JAX. A failed
launch raises.

Two precisions, chosen by ``x``'s dtype:
* float32 x (a float32 depth net): ``decoder_tail_plain`` and the f32
  kernel, whose two wide convs run on the tensor cores as f32-accurate
  3xTF32 products (the design is in the source's header); the disparity
  is float32.
* bfloat16 x (a bfloat16 depth net): what the TPU kernel computes
  (``_tail_forward``: bf16 operands into f32 accumulators, f32 biases,
  bf16 intermediate maps): ``decoder_tail_plain_bf16`` and the bf16
  kernel, x fed by TMA and its two wide convs on ``wgmma`` bf16 (the
  design is in the source's header). The disparity comes out float32, as
  the Pallas kernel's does; ``make_tail_apply`` casts it to the net's
  dtype.
  On the CPU its backward is the same f32 recomputation.

The TPU kernel took the upconv's output in its subpixel phase layout
``[N, H/2, W/2, 4*32]``; the kernels take the full-resolution
``[N, 32, H, W]`` that the port's decoder produces, NCHW contiguous on the
card. (On the CPU the decoder's tensors are channels_last, which the NHWC
images hand down; the plain versions take any layout.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tcsfm_torch.ops import _build
from tcsfm_torch.ops.grid_sample import _raise_on, _stream

LAUNCHES = 0        # f32 kernel launches by the wrapper below, and
LAUNCHES_BF16 = 0   # bf16 kernel launches; both read by chip_smoke.py

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


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16, held as float32."""
    return t.to(torch.bfloat16).float()


def decoder_tail_plain_bf16(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """The tail as the Pallas kernel computes it for a bfloat16 net
    (``_tail_forward``): x, elu(x), the weights, f1 = elu(conv1) and f2 =
    elu(conv2) rounded to bfloat16 and held as float32 (exactly), the
    convs in float32 on those operands with float32 biases, the activations
    in float32. ``decoder_tail_plain``'s arguments; returns the float32
    disparity [N, H, W, 1]."""
    x = _bf16(F.elu(_bf16(x)))
    x = _bf16(F.elu(_refl_conv(x, _bf16(w1), b1.float())))
    x = _bf16(F.elu(_refl_conv(x, _bf16(w2), b2.float())))
    return torch.sigmoid(_refl_conv(x, _bf16(w3), b3.float())
                         ).permute(0, 2, 3, 1)


_WEIGHT_SHAPES = ((C1, C1, 3, 3), (C1,), (C2, C1, 3, 3), (C2,), (1, C2, 3, 3),
                  (1,))


def _check(x: torch.Tensor, weights) -> None:
    tensors = (x, *weights)
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or any(t.dtype != torch.float32 for t in weights)):
        raise TypeError(f"decoder_tail takes x float32 or bfloat16 and "
                        f"float32 weights, got {[t.dtype for t in tensors]}")
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
    global LAUNCHES, LAUNCHES_BF16
    n, _, h, w = x.shape
    out = x.new_empty((n, h, w, 1), dtype=torch.float32)
    bf16 = x.dtype == torch.bfloat16
    lib = _build.load()
    fn = lib.tcsfm_decoder_tail_bf16_fwd if bf16 else lib.tcsfm_decoder_tail_fwd
    _raise_on(fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                 b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
                 n, h, w, x.device.index, _stream(x.device)),
              "decoder_tail_bf16" if bf16 else "decoder_tail")
    if bf16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    return out


class _DecoderTail(torch.autograd.Function):
    """A fused kernel (or, for bf16 x on the CPU, its plain version); as its
    backward, autodiff of ``decoder_tail_plain`` in float32 recomputed
    from the saved inputs (JAX's ``_tail_bwd``), the gradient of x in x's
    dtype."""

    @staticmethod
    def forward(ctx, *inputs):
        ctx.save_for_backward(*inputs)
        x = inputs[0]
        if x.dtype == torch.bfloat16 and x.device.type == "cpu":
            return decoder_tail_plain_bf16(*inputs)
        return _launch(*inputs)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            inputs = [t.detach().float().requires_grad_(k)
                      for t, k in zip(ctx.saved_tensors, need)]
            out = decoder_tail_plain(*inputs)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads).to(t.dtype) if k else None
                     for t, k in zip(ctx.saved_tensors, need))


def decoder_tail(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """The tail, differentiable; returns the float32 disparity
    [N, H, W, 1].

    float32 x on the CPU, in any layout, goes to ``decoder_tail_plain``
    under ordinary autograd; bfloat16 x on the CPU to
    ``decoder_tail_plain_bf16``. CUDA tensors, contiguous, launch the
    kernel of x's dtype on the current stream and raise if the launch
    fails.
    """
    weights = (w1, b1, w2, b2, w3, b3)
    _check(x, weights)
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return decoder_tail_plain(x, *weights)
    return _DecoderTail.apply(x, *weights)
