"""Bilinear grid sample, its gradient and its jvp: the CUDA kernels'
wrappers and their plain versions.

Port of the samplers of ``tcsfm/ops/warp_mxu.py``: the forward kernel
(Pallas ``_make_kernel``) with the custom VJP of ``grid_sample_mxu_diff``,
whose backward kernel (``tcsfm/ops/warp_mxu_grad.py::_make_bwd_kernel``)
comes in a d_coords-only variant (``grad_ch=()``) and a d_img variant; and
the value+Jacobian kernel (``grid_sample_mxu_with_grads``) behind the jvp
rule of ``grid_sample_mxu_fwd_diff``. The semantics are the unbanded XLA
sampler's, ``tcsfm/geom/warp.py::grid_sample``: torch's ``grid_sample``
with ``align_corners=False`` and zero padding, on NHWC images,
differentiated as autodiff differentiates it (at an exactly integer
coordinate the one-sided difference, where the Pallas tent derivative
gives 0).

``grid_sample`` is what the port calls. On CPU tensors it runs
``grid_sample_plain`` under ordinary autograd. On CUDA tensors it launches
the forward kernel in ``csrc/grid_sample.cu`` inside an autograd Function
(``_GridSample``) whose backward launches a kernel of
``csrc/grid_sample_bwd.cu`` (the d_coords-only kernel when no image
channel needs a gradient, else the d_img kernel for just the channels that
need one), whose jvp launches the value+Jacobian kernel, and whose vmap
rule folds the vmapped dimension into B. So ``torch.autograd``,
``torch.autograd.forward_ad`` and ``torch.func``'s ``grad``, ``jvp`` and
``vmap`` work on the card as on the CPU. A failed launch raises.

``grid_sample_fwd_diff`` is the sampler to take jvps through: its forward
launches the value+Jacobian kernel once and keeps the derivatives for its
jvp, so one ``torch.func.jvp`` costs one launch, as one JAX jvp of
``grid_sample_mxu_fwd_diff`` costs one ``pallas_call``. The refiners
(``solver/ba.py``, ``solver/gauss_newton.py``) evaluate residuals with
``grid_sample`` and take their Jacobians through ``fwd_diff_of(sampler)``.

``grad_ch`` semantics without zero planes: the image to sample may come in
two parts, ``img`` and ``tail``, sampled as ``cat([img, tail], -1)``. Each
part gets a gradient only if it requires one, so a data image (a camera
frame) with the differentiable source depth as ``tail`` is the JAX
package's ``grad_ch=(3,)``: the image's d_img is neither computed nor
allocated.

Every launch passes the index of its tensors' card to the library, so the
kernels run on any card (``csrc/launch.cuh``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from tcsfm_torch.ops import _build

# kernel launches made by the wrappers below, read by chip_smoke.py
LAUNCHES = 0              # forward, value only, csrc/grid_sample.cu
LAUNCHES_FWD_GRADS = 0    # forward, value and d/dcoords, csrc/grid_sample.cu
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


def _blend(weights, vals) -> torch.Tensor:
    wx0, wx1, wy0, wy1 = weights
    v00, v10, v01, v11 = vals
    return (v00 * (wx0 * wy0)[..., None]
            + v10 * (wx1 * wy0)[..., None]
            + v01 * (wx0 * wy1)[..., None]
            + v11 * (wx1 * wy1)[..., None])


def _slopes(weights, vals):
    """d value / d x and d value / d y in pixel units, per channel."""
    wx0, wx1, wy0, wy1 = weights
    v00, v10, v01, v11 = vals
    dwx = wy0[..., None] * (v10 - v00) + wy1[..., None] * (v11 - v01)
    dwy = wx0[..., None] * (v01 - v00) + wx1[..., None] * (v11 - v10)
    return dwx, dwy


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
    weights, taps = _taps(img, coords)
    return _blend(weights, _gather(img, taps))


def grid_sample_with_grads_plain(img: torch.Tensor, coords: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """The sample and its derivatives with respect to the normalized
    coords, in the f32 operations and order of the kernel
    (``csrc/grid_sample.cu``, ``tcsfm_grid_sample_fwd_grads``).

    Returns (out, gx, gy), each [B, H, W, C]: ``gx = d out / d coords[...,
    0]``, ``gy = d out / d coords[..., 1]``, as autodiff of
    ``grid_sample_plain`` gives them (the counterpart of
    ``tcsfm/ops/warp_mxu.py::grid_sample_mxu_with_grads``).
    """
    b, h, w, c = img.shape
    weights, taps = _taps(img, coords)
    vals = _gather(img, taps)
    dwx, dwy = _slopes(weights, vals)
    return _blend(weights, vals), dwx * (w * 0.5), dwy * (h * 0.5)


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
    dwx, dwy = _slopes((wx0, wx1, wy0, wy1), _gather(img, taps))
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


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def _launch_fwd(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    b, h, w, c = img.shape
    out = torch.empty_like(img)
    _raise_on(_build.load().tcsfm_grid_sample_fwd(
        img.data_ptr(), coords.data_ptr(), out.data_ptr(), b, h, w, c,
        img.device.index, _stream(img.device)), "grid_sample")
    LAUNCHES += 1
    return out


def _launch_fwd_grads(img: torch.Tensor, coords: torch.Tensor):
    global LAUNCHES_FWD_GRADS
    b, h, w, c = img.shape
    out, gx, gy = (torch.empty_like(img) for _ in range(3))
    _raise_on(_build.load().tcsfm_grid_sample_fwd_grads(
        img.data_ptr(), coords.data_ptr(), out.data_ptr(), gx.data_ptr(),
        gy.data_ptr(), b, h, w, c, img.device.index, _stream(img.device)),
        "grid_sample_with_grads")
    LAUNCHES_FWD_GRADS += 1
    return out, gx, gy


def grid_sample_with_grads(img: torch.Tensor, coords: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(out, gx, gy): ``grid_sample_with_grads_plain``'s contract.

    CPU tensors go to ``grid_sample_with_grads_plain``. CUDA tensors launch
    the value+Jacobian kernel on the current stream and raise if the launch
    fails. Not differentiable; ``grid_sample_fwd_diff`` is its jvp.
    """
    _check(img, coords)
    if img.device.type == "cpu":
        return grid_sample_with_grads_plain(img, coords)
    return _launch_fwd_grads(img, coords)


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
    device, stream = img.device.index, _stream(img.device)
    d_coords = torch.empty_like(coords)
    if not grad_ch:
        _raise_on(lib.tcsfm_grid_sample_bwd_coords(
            img.data_ptr(), coords.data_ptr(), g.data_ptr(),
            d_coords.data_ptr(), b, h, w, c, device, stream),
            "grid_sample_bwd_coords")
        LAUNCHES_BWD_COORDS += 1
        return d_coords, None
    d_img = img.new_zeros(b, h, w, len(grad_ch))
    mask = sum(1 << k for k in grad_ch)
    _raise_on(lib.tcsfm_grid_sample_bwd(
        img.data_ptr(), coords.data_ptr(), g.data_ptr(), d_coords.data_ptr(),
        d_img.data_ptr(), mask, b, h, w, c, len(grad_ch), device, stream),
        "grid_sample_bwd")
    LAUNCHES_BWD_IMG += 1
    return d_coords, d_img


def _pack(img: torch.Tensor, tail: Optional[torch.Tensor]) -> torch.Tensor:
    return img if tail is None else torch.cat([img, tail], -1)


def _fold(info, in_dims, *xs):
    """vmap rule helper: each tensor with the vmapped dimension moved to
    the front (broadcast there when it is not vmapped) and folded into B."""
    out = []
    for x, d in zip(xs, in_dims):
        if x is not None:
            x = (x.expand(info.batch_size, *x.shape) if d is None
                 else x.movedim(d, 0))
            x = x.reshape(-1, *x.shape[2:]).contiguous()
        out.append(x)
    return out


def _unfold(info, x: torch.Tensor) -> torch.Tensor:
    return x.reshape(info.batch_size, -1, *x.shape[1:])


class _GridSample(torch.autograd.Function):
    """The forward kernel; as its backward, the kernel variant that the
    inputs needing a gradient call for; as its jvp, the value+Jacobian
    kernel; as its vmap rule, the vmapped dimension folded into B.

    Under ``torch.func`` the tensors that a jvp or backward rule sees are
    the transform's wrappers, which have no storage to launch on; both
    rules therefore launch through autograd Functions
    (``_GridSampleFwdDiff``, ``_GridSample``, ``_GridSampleBwd``), whose
    forwards receive the unwrapped tensors."""

    @staticmethod
    def forward(img, coords, tail):
        return _launch_fwd(_pack(img, tail), coords)

    @staticmethod
    def setup_context(ctx, inputs, output):
        img, coords, tail = inputs
        # an input without a tangent (or gradient) arrives as None, not as
        # a zero tensor that the kernel would be launched on
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(img, coords, tail)
        ctx.save_for_forward(img, coords, tail)

    @staticmethod
    def backward(ctx, g):
        img, coords, tail = ctx.saved_tensors
        need_img, need_coords, need_tail = ctx.needs_input_grad
        packed = _pack(img, tail)
        c_img, c = img.shape[-1], packed.shape[-1]
        grad_ch = ((tuple(range(c_img)) if need_img else ())
                   + (tuple(range(c_img, c)) if need_tail else ()))
        d_coords, *d_img = _GridSampleBwd.apply(packed, coords,
                                                g.contiguous(), grad_ch)
        d_head = d_img[0][..., :c_img] if need_img else None
        d_tail = d_img[0][..., -(c - c_img):] if need_tail else None
        return d_head, (d_coords if need_coords else None), d_tail

    @staticmethod
    def jvp(ctx, img_t, coords_t, tail_t):
        img, coords, tail = ctx.saved_tensors
        dout = None
        if coords_t is not None:
            _, gx, gy = _GridSampleFwdDiff.apply(_pack(img, tail), coords,
                                                 False)
            dout = gx * coords_t[..., 0:1] + gy * coords_t[..., 1:2]
        if img_t is not None or tail_t is not None:
            if tail is not None:
                img_t = torch.cat([
                    torch.zeros_like(img) if img_t is None else img_t,
                    torch.zeros_like(tail) if tail_t is None else tail_t], -1)
            s = _GridSample.apply(img_t.contiguous(), coords, None)
            dout = s if dout is None else dout + s
        return dout

    @staticmethod
    def vmap(info, in_dims, img, coords, tail):
        out = _GridSample.apply(*_fold(info, in_dims, img, coords, tail))
        return _unfold(info, out), 0


class _GridSampleFwdDiff(torch.autograd.Function):
    """The value+Jacobian kernel (or, with ``plain``, its plain twin) as a
    forward whose jvp reuses its derivatives: no launch for a coords
    tangent. Reverse mode through the backward kernels (their plain twin
    with ``plain``); vmap as ``_GridSample``'s."""

    @staticmethod
    def forward(img, coords, plain):
        if plain:
            return grid_sample_with_grads_plain(img, coords)
        return _launch_fwd_grads(img, coords)

    @staticmethod
    def setup_context(ctx, inputs, output):
        img, coords, plain = inputs
        _, gx, gy = output
        ctx.mark_non_differentiable(gx, gy)
        ctx.set_materialize_grads(False)
        ctx.plain = plain
        ctx.save_for_backward(img, coords)
        ctx.save_for_forward(coords, gx, gy)

    @staticmethod
    def backward(ctx, g, _gx, _gy):
        img, coords = ctx.saved_tensors
        need_img, need_coords, _ = ctx.needs_input_grad
        grad_ch = tuple(range(img.shape[-1])) if need_img else ()
        if ctx.plain:
            d_coords, d_img = grid_sample_bwd_plain(img, coords, g, grad_ch)
        else:
            d_coords, *d_img = _GridSampleBwd.apply(img, coords,
                                                    g.contiguous(), grad_ch)
            d_img = d_img[0] if need_img else None
        return d_img, (d_coords if need_coords else None), None

    @staticmethod
    def jvp(ctx, img_t, coords_t, _plain_t):
        coords, gx, gy = ctx.saved_tensors
        dout = None
        if coords_t is not None:
            dout = gx * coords_t[..., 0:1] + gy * coords_t[..., 1:2]
        if img_t is not None:
            s = (grid_sample_plain(img_t, coords) if ctx.plain else
                 _GridSample.apply(img_t.contiguous(), coords, None))
            dout = s if dout is None else dout + s
        return dout, None, None

    @staticmethod
    def vmap(info, in_dims, img, coords, plain):
        outs = _GridSampleFwdDiff.apply(*_fold(info, in_dims[:2], img, coords),
                                        plain)
        return tuple(_unfold(info, o) for o in outs), (0, 0, 0)


class _GridSampleBwd(torch.autograd.Function):
    """The backward kernels (``grid_sample_bwd``) as a Function, so that a
    backward rule running under ``torch.func`` launches on unwrapped
    tensors; vmap folds the vmapped dimension into B. Returns (d_coords,)
    or, for a non-empty ``grad_ch``, (d_coords, d_img). Not differentiable
    itself."""

    @staticmethod
    def forward(img, coords, g, grad_ch):
        d_coords, d_img = grid_sample_bwd(img, coords, g, grad_ch)
        return (d_coords,) if d_img is None else (d_coords, d_img)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the sampler's backward is not "
                                  "differentiable")

    @staticmethod
    def vmap(info, in_dims, img, coords, g, grad_ch):
        outs = _GridSampleBwd.apply(*_fold(info, in_dims[:3], img, coords, g),
                                    grad_ch)
        return tuple(_unfold(info, o) for o in outs), (0,) * len(outs)


def _check_tail(img: torch.Tensor, tail: Optional[torch.Tensor]) -> None:
    if tail is not None and (tail.dim() != 4 or tail.shape[:3] != img.shape[:3]
                             or tail.dtype != img.dtype
                             or tail.device != img.device):
        raise ValueError(f"tail {tuple(tail.shape)} {tail.dtype} on "
                         f"{tail.device} does not match the image "
                         f"{tuple(img.shape)} {img.dtype} on {img.device}")


def grid_sample(img: torch.Tensor, coords: torch.Tensor,
                tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample ``img`` [B,H,W,C] f32 (followed by ``tail`` [B,H,W,C'] when
    given) at ``coords`` [B,H,W,2] f32; differentiable in reverse and
    forward mode, and under ``torch.func``.

    CPU tensors go to ``grid_sample_plain``. CUDA tensors launch the
    kernels on the current stream and raise if a launch fails.
    """
    _check(img, coords)
    _check_tail(img, tail)
    if img.device.type == "cpu":
        return grid_sample_plain(img, coords, tail)
    return _GridSample.apply(img, coords, tail)


def grid_sample_fwd_diff(img: torch.Tensor, coords: torch.Tensor
                         ) -> torch.Tensor:
    """``grid_sample`` for callers that take jvps (the counterpart of
    ``tcsfm/ops/warp_mxu.py::grid_sample_mxu_fwd_diff``).

    CUDA tensors launch the value+Jacobian kernel once per call; a jvp
    through it costs no further launch for the coords' tangent (an image
    tangent is sampled by the value kernel, as ``_gsm_jvp`` does). CPU
    tensors run ``grid_sample_fwd_diff_plain``.
    """
    _check(img, coords)
    return _GridSampleFwdDiff.apply(img, coords, img.device.type == "cpu")[0]


def grid_sample_fwd_diff_plain(img: torch.Tensor, coords: torch.Tensor
                               ) -> torch.Tensor:
    """``grid_sample_fwd_diff`` with the plain twin of the value+Jacobian
    kernel (``grid_sample_with_grads_plain``), on any device and, as
    ``grid_sample_plain``, in any float type: its jvp does the kernel's
    arithmetic in the kernel's order."""
    return _GridSampleFwdDiff.apply(img, coords, True)[0]


def fwd_diff_of(sampler):
    """The sampler that jvps of ``sampler``'s samples go through:
    ``grid_sample_fwd_diff`` for ``grid_sample``,
    ``grid_sample_fwd_diff_plain`` for ``grid_sample_plain``; any other
    sampler itself."""
    return {grid_sample: grid_sample_fwd_diff,
            grid_sample_plain: grid_sample_fwd_diff_plain}.get(sampler,
                                                               sampler)
