"""Bilinear grid sample and its gradient: the CUDA kernels' wrappers and
their plain versions.

Port of the sampler that ``tcsfm/ops/warp_mxu.py::grid_sample_mxu_diff``
carries: the forward kernel (Pallas ``_make_kernel``) and its custom VJP,
whose backward kernel (``tcsfm/ops/warp_mxu_grad.py::_make_bwd_kernel``)
comes in a d_coords-only variant (``grad_ch=()``) and a d_img variant. The
semantics are the unbanded XLA sampler's, ``tcsfm/geom/warp.py::grid_sample``:
torch's ``grid_sample`` with ``align_corners=False`` and zero padding, on
NHWC images, differentiated as autodiff differentiates it.

``grid_sample`` is what the port calls. On CPU tensors it runs
``grid_sample_plain`` under ordinary autograd. On CUDA tensors it launches
the forward kernel in ``csrc/grid_sample.cu`` inside an autograd Function
whose backward launches a kernel of ``csrc/grid_sample_bwd.cu``: the
d_coords-only kernel when no image channel needs a gradient, else the
d_img kernel for just the channels that need one. A failed launch raises.

``grad_ch`` semantics without zero planes: the image to sample may come in
two parts, ``img`` and ``tail``, sampled as ``cat([img, tail], -1)``. Each
part gets a gradient only if it requires one, so a data image (a camera
frame) with the differentiable source depth as ``tail`` is the JAX
package's ``grad_ch=(3,)``: the image's d_img is neither computed nor
allocated.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from tcsfm_torch.ops import _build

# kernel launches made by the wrappers below, read by chip_smoke.py
LAUNCHES = 0              # forward, csrc/grid_sample.cu
LAUNCHES_BWD_COORDS = 0   # d_coords only, csrc/grid_sample_bwd.cu
LAUNCHES_BWD_IMG = 0      # d_coords and d_img, csrc/grid_sample_bwd.cu


def _taps(img: torch.Tensor, coords: torch.Tensor):
    """Tap weights, in-image masks and flat pixel indices of each output
    pixel, in the f32 operations of the kernels' ``bilinear.cuh``."""
    b, h, w, _ = img.shape
    # align_corners=False un-normalization: x = ((g + 1) * W - 1) / 2
    x = ((coords[..., 0] + 1.0) * w - 1.0) * 0.5
    y = ((coords[..., 1] + 1.0) * h - 1.0) * 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = x - x0
    wx0 = 1.0 - wx1
    wy1 = y - y0
    wy0 = 1.0 - wy1

    def tap(ix, iy):
        inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        flat = iy.clamp(0, h - 1).long() * w + ix.clamp(0, w - 1).long()
        return inb, flat.reshape(b, h * w)

    taps = (tap(x0, y0), tap(x1, y0), tap(x0, y1), tap(x1, y1))
    return (wx0, wx1, wy0, wy1), taps


def _gather(img: torch.Tensor, taps) -> list:
    """The four taps' values [B,H,W,C], 0 outside the image."""
    b, h, w, c = img.shape
    flat_img = img.reshape(b, h * w, c)
    out = []
    for inb, flat in taps:
        idx = flat[..., None].expand(b, h * w, c)
        vals = torch.gather(flat_img, 1, idx).reshape(b, h, w, c)
        out.append(vals * inb[..., None].to(img.dtype))
    return out


def grid_sample_plain(img: torch.Tensor, coords: torch.Tensor,
                      tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The explicit 4-tap gather of ``tcsfm/geom/warp.py:31-72`` in torch.

    Args:
      img:    [B, H, W, C] source image.
      coords: [B, H, W, 2] normalized (x, y) in [-1, 1].
      tail:   optional [B, H, W, C'] channels sampled after ``img``'s.
    Returns:
      [B, H, W, C (+ C')] sampled image; out-of-image taps contribute 0.
    """
    if tail is not None:
        img = torch.cat([img, tail], -1)
    (wx0, wx1, wy0, wy1), taps = _taps(img, coords)
    v00, v10, v01, v11 = _gather(img, taps)
    return (v00 * (wx0 * wy0)[..., None]
            + v10 * (wx1 * wy0)[..., None]
            + v01 * (wx0 * wy1)[..., None]
            + v11 * (wx1 * wy1)[..., None])


def grid_sample_bwd_plain(img: torch.Tensor, coords: torch.Tensor,
                          g: torch.Tensor, grad_ch: Sequence[int] = ()
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The gradient of ``grid_sample_plain`` for the upstream gradient ``g``,
    in the f32 operations and order of ``csrc/grid_sample_bwd.cu``.

    Args:
      img, coords: the forward's inputs, [B,H,W,C] and [B,H,W,2].
      g:       [B, H, W, C] gradient of the sampled image.
      grad_ch: the channels whose image gradient is wanted, ascending.
    Returns:
      d_coords [B, H, W, 2], and d_img [B, H, W, len(grad_ch)] for the
      ``grad_ch`` channels in that order (None when ``grad_ch`` is empty).
    """
    b, h, w, c = img.shape
    (wx0, wx1, wy0, wy1), taps = _taps(img, coords)
    v00, v10, v01, v11 = _gather(img, taps)
    dwx = wy0[..., None] * (v10 - v00) + wy1[..., None] * (v11 - v01)
    dwy = wx0[..., None] * (v01 - v00) + wx1[..., None] * (v11 - v10)
    # channels summed one after another, as the kernel sums them
    acc_x = g[..., 0] * dwx[..., 0]
    acc_y = g[..., 0] * dwy[..., 0]
    for ch in range(1, c):
        acc_x = acc_x + g[..., ch] * dwx[..., ch]
        acc_y = acc_y + g[..., ch] * dwy[..., ch]
    d_coords = torch.stack([acc_x * (w * 0.5), acc_y * (h * 0.5)], -1)
    if not grad_ch:
        return d_coords, None

    ch = list(grad_ch)
    gk = g[..., ch]
    d_img = torch.zeros(b * h * w, len(ch), dtype=g.dtype, device=g.device)
    offsets = torch.arange(b, device=g.device)[:, None] * (h * w)
    weights = (wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1)
    for (inb, flat), wt in zip(taps, weights):
        src = gk * wt[..., None] * inb[..., None].to(g.dtype)
        d_img.index_add_(0, (flat + offsets).reshape(-1),
                         src.reshape(-1, len(ch)))
    return d_coords, d_img.reshape(b, h, w, len(ch))


def _check(img: torch.Tensor, coords: torch.Tensor) -> None:
    if img.dtype != torch.float32 or coords.dtype != torch.float32:
        raise TypeError(f"grid_sample takes float32, got {img.dtype} image "
                        f"and {coords.dtype} coords")
    if img.dim() != 4 or coords.dim() != 4 or coords.shape[-1] != 2:
        raise ValueError(f"grid_sample takes img [B,H,W,C] and coords "
                         f"[B,H,W,2], got {tuple(img.shape)} and "
                         f"{tuple(coords.shape)}")
    if coords.shape[:3] != img.shape[:3]:
        raise ValueError(f"coords {tuple(coords.shape)} do not match the "
                         f"image's [B,H,W] {tuple(img.shape[:3])}")
    if img.device != coords.device:
        raise ValueError(f"img on {img.device}, coords on {coords.device}")
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grid_sample runs on cpu or cuda, not {img.device}")
    if not (img.is_contiguous() and coords.is_contiguous()):
        raise ValueError("grid_sample takes contiguous tensors")
    if img.device.index not in (None, 0):
        # the kernel library carries its own CUDA runtime, whose current
        # device is the first card
        raise ValueError(f"the CUDA kernels run on cuda:0, not {img.device}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _launch_fwd(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    b, h, w, c = img.shape
    out = torch.empty_like(img)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    _raise_on(_build.load().tcsfm_grid_sample_fwd(
        img.data_ptr(), coords.data_ptr(), out.data_ptr(), b, h, w, c,
        stream), "grid_sample")
    LAUNCHES += 1
    return out


def grid_sample_bwd(img: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
                    grad_ch: Sequence[int] = ()
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The sampler's gradient: ``grid_sample_bwd_plain``'s contract.

    CPU tensors go to ``grid_sample_bwd_plain``. CUDA tensors launch the
    d_coords-only kernel when ``grad_ch`` is empty, else the d_img kernel,
    on the current stream, and raise if the launch fails.
    """
    global LAUNCHES_BWD_COORDS, LAUNCHES_BWD_IMG
    _check(img, coords)
    if g.shape != img.shape or g.dtype != img.dtype or g.device != img.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} on {g.device} does "
                         f"not match the image {tuple(img.shape)}")
    grad_ch = tuple(grad_ch)
    b, h, w, c = img.shape
    if list(grad_ch) != sorted(set(grad_ch)) or any(
            not 0 <= k < c for k in grad_ch):
        raise ValueError(f"grad_ch {grad_ch} must name distinct channels of "
                         f"0..{c - 1} in ascending order")
    if img.device.type == "cpu":
        return grid_sample_bwd_plain(img, coords, g, grad_ch)
    if c > 32:
        raise ValueError(f"the backward kernel takes at most 32 channels, "
                         f"got {c}")
    g = g.contiguous()
    lib = _build.load()
    stream = torch.cuda.current_stream(img.device).cuda_stream
    d_coords = torch.empty_like(coords)
    if not grad_ch:
        _raise_on(lib.tcsfm_grid_sample_bwd_coords(
            img.data_ptr(), coords.data_ptr(), g.data_ptr(),
            d_coords.data_ptr(), b, h, w, c, stream), "grid_sample_bwd_coords")
        LAUNCHES_BWD_COORDS += 1
        return d_coords, None
    d_img = torch.zeros(b, h, w, len(grad_ch), dtype=img.dtype,
                        device=img.device)
    mask = sum(1 << k for k in grad_ch)
    _raise_on(lib.tcsfm_grid_sample_bwd(
        img.data_ptr(), coords.data_ptr(), g.data_ptr(), d_coords.data_ptr(),
        d_img.data_ptr(), mask, b, h, w, c, len(grad_ch), stream),
        "grid_sample_bwd")
    LAUNCHES_BWD_IMG += 1
    return d_coords, d_img


class _GridSample(torch.autograd.Function):
    """The forward kernel, and as its backward the kernel variant that the
    inputs needing a gradient call for."""

    @staticmethod
    def forward(ctx, img, coords, tail):
        packed = img if tail is None else torch.cat([img, tail], -1)
        ctx.save_for_backward(packed, coords)
        ctx.img_channels = img.shape[-1]
        return _launch_fwd(packed, coords)

    @staticmethod
    def backward(ctx, g):
        packed, coords = ctx.saved_tensors
        need_img, need_coords, need_tail = ctx.needs_input_grad
        c_img, c = ctx.img_channels, packed.shape[-1]
        grad_ch = ((tuple(range(c_img)) if need_img else ())
                   + (tuple(range(c_img, c)) if need_tail else ()))
        d_coords, d_img = grid_sample_bwd(packed, coords, g, grad_ch)
        d_head = d_img[..., :c_img] if need_img else None
        d_tail = d_img[..., -(c - c_img):] if need_tail else None
        return d_head, (d_coords if need_coords else None), d_tail


def grid_sample(img: torch.Tensor, coords: torch.Tensor,
                tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample ``img`` [B,H,W,C] f32 (followed by ``tail`` [B,H,W,C'] when
    given) at ``coords`` [B,H,W,2] f32; differentiable.

    CPU tensors go to ``grid_sample_plain``. CUDA tensors launch the
    kernels on the current stream and raise if a launch fails.
    """
    _check(img, coords)
    if tail is not None:
        if (tail.dim() != 4 or tail.shape[:3] != img.shape[:3]
                or tail.dtype != img.dtype or tail.device != img.device):
            raise ValueError(f"tail {tuple(tail.shape)} {tail.dtype} on "
                             f"{tail.device} does not match the image "
                             f"{tuple(img.shape)} {img.dtype} on {img.device}")
    if img.device.type == "cpu":
        return grid_sample_plain(img, coords, tail)
    return _GridSample.apply(img, coords, tail)
