"""Bilinear grid sample: the CUDA kernel's wrapper and its plain version.

Port of the forward sampler that ``tcsfm/ops/warp_mxu.py::grid_sample_mxu``
launches (Pallas ``_make_kernel``), with the semantics of the unbanded XLA
sampler ``tcsfm/geom/warp.py::grid_sample``: torch's ``grid_sample`` with
``align_corners=False`` and zero padding, on NHWC images.

``grid_sample`` is what the port calls. On a CPU tensor it runs
``grid_sample_plain``; on a CUDA tensor it launches the kernel in
``csrc/grid_sample.cu`` or raises. The kernel is forward-only in this
slice: a call that autograd would have to differentiate raises.
"""

from __future__ import annotations

import torch

from tcsfm_torch.ops import _build

LAUNCHES = 0   # kernel launches made by grid_sample, read by chip_smoke.py


def grid_sample_plain(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The explicit 4-tap gather of ``tcsfm/geom/warp.py:31-72`` in torch.

    Args:
      img:    [B, H, W, C] source image.
      coords: [B, H, W, 2] normalized (x, y) in [-1, 1].
    Returns:
      [B, H, W, C] sampled image; out-of-image taps contribute 0.
    """
    b, h, w, c = img.shape
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
    flat_img = img.reshape(b, h * w, c)

    def gather(ix, iy):
        inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        ixc = ix.clamp(0, w - 1).long()
        iyc = iy.clamp(0, h - 1).long()
        flat = (iyc * w + ixc).reshape(b, h * w, 1).expand(b, h * w, c)
        vals = torch.gather(flat_img, 1, flat).reshape(b, h, w, c)
        return vals * inb[..., None].to(img.dtype)

    return (gather(x0, y0) * (wx0 * wy0)[..., None]
            + gather(x1, y0) * (wx1 * wy0)[..., None]
            + gather(x0, y1) * (wx0 * wy1)[..., None]
            + gather(x1, y1) * (wx1 * wy1)[..., None])


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
    if torch.is_grad_enabled() and (img.requires_grad or coords.requires_grad):
        raise NotImplementedError(
            "grid_sample is forward-only until the training slice ports the "
            "sampler's backward kernel (tcsfm/ops/warp_mxu_grad.py); call it "
            "under torch.no_grad()")


def grid_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` [B,H,W,C] f32 at ``coords`` [B,H,W,2] f32.

    CPU tensors go to ``grid_sample_plain``. CUDA tensors launch the kernel
    on the current stream and raise if the launch fails.
    """
    _check(img, coords)
    if img.device.type == "cpu":
        return grid_sample_plain(img, coords)
    if img.device.index not in (None, 0):
        # the kernel library carries its own CUDA runtime, whose current
        # device is the first card
        raise ValueError(f"the CUDA kernels run on cuda:0, not {img.device}")
    lib = _build.load()
    b, h, w, c = img.shape
    out = torch.empty_like(img)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    rc = lib.tcsfm_grid_sample_fwd(img.data_ptr(), coords.data_ptr(),
                                   out.data_ptr(), b, h, w, c, stream)
    if rc != 0:
        raise RuntimeError(f"grid_sample kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out
