"""Dense optical flow on the device: Farneback polynomial expansion
(counterpart of ``tcsfm/ops/flow.py``).

The reference feeds classical Farneback flow as two extra pose-network
input channels when ``flow_type == 'classical'`` (``cv2.
calcOpticalFlowFarneback`` with (0.5, 3, 15, 3, 5, 1.2, 0) on grey uint8
pairs, per sample on the host). This is the JAX package's on-device
design in PyTorch: the same two-frame polynomial expansion (Farnebäck,
SCIA 2003) as separable correlations, box filters and per-pixel 2x2
solves, written as batched tensor ops over a leading [N] axis (the JAX
function is ``vmap``ped), so one call computes a whole batch of pairs.

Plain PyTorch, no hand-written kernel: the JAX package computes the flow
with XLA, not Pallas. Each step keeps the JAX function's arithmetic in
its order: the correlations are shifted multiply-adds over an
edge-clamped (``replicate``) pad, tap by tap as ``_corr1d`` writes them,
so on the CPU every step but the pyramid's resize is bit-equal to JAX's.
The card's flow is held against the CPU's within the CPU's own spread
with its images one ulp up (``chip_smoke.py`` phase "flow"): where the
2x2 system is near singular, an ulp moves the flow visibly. The
pyramid's downscale is ``F.interpolate(antialias=True)``:
``jax.image.resize(..., "linear")`` widens its triangle kernel when it
shrinks; the flow's upscale between levels is plain bilinear.
Level sizes are Python ints, computed as JAX computes them.

Semantics follow OpenCV's implementation: polynomial expansion with
Gaussian applicability (``poly_n``, ``poly_sigma``) into per-pixel
channels (b_y, b_x, a_yy, a_xx, a_xy'); per level an iterative update
(averaged A, displacement-compensated delta-b, box-averaged normal
equations over ``winsize``, 2x2 solve); a Gaussian pre-smoothed pyramid,
the flow scaled by 1/pyr_scale between levels; edge-clamped correlations
and a 5-pixel linear confidence ramp at the frame's edge.

Everything runs in f32 whatever the input dtype (``farneback_flow``'s
``dtype`` runs the same steps in float64, for checks). Nothing
differentiates the flow.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_BORDER = 5  # confidence-ramp width in pixels (OpenCV BORDER)
_LUMA = (0.299, 0.587, 0.114)   # PIL's convert('L') weights


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """[..., 3] float RGB in [0, 1] → [...] luma in [0, 255] (PIL's
    ``convert('L')`` weights, as the reference loader). The weighted sum
    is two multiply-adds (``add`` with ``alpha``) in channel order, which
    round as the JAX function's 3-term dot does."""
    w = [float(np.float32(c)) for c in _LUMA]
    gray = torch.add(img[..., 0] * w[0], img[..., 1], alpha=w[1])
    return torch.add(gray, img[..., 2], alpha=w[2]) * 255.0


@functools.lru_cache(maxsize=None)
def _poly_exp_constants(poly_n: int, poly_sigma: float):
    """1D applicability kernels + the inverse-G coefficients (host-side;
    a copy of ``tcsfm/ops/flow.py:52-74``)."""
    n = (poly_n - 1) // 2
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2.0 * poly_sigma ** 2))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g

    # G = sum over the 2D window of w(x,y) * basis * basis^T with basis
    # (1, x, y, x^2, y^2, xy); its inverse has 4 distinct nonzero values.
    G = np.zeros((6, 6))
    for yi in x.astype(int):
        for xi in x.astype(int):
            w2 = g[yi + n] * g[xi + n]
            b = np.array([1.0, xi, yi, xi * xi, yi * yi, xi * yi])
            G += w2 * np.outer(b, b)
    invG = np.linalg.inv(G)
    ig11, ig03, ig33, ig55 = invG[1, 1], invG[0, 3], invG[3, 3], invG[5, 5]
    return (g.astype(np.float32), xg.astype(np.float32),
            xxg.astype(np.float32), float(ig11), float(ig03), float(ig33),
            float(ig55))


def _corr1d(img: torch.Tensor, kernel: np.ndarray, axis: int) -> torch.Tensor:
    """Edge-clamped 1D correlation along ``axis``: the taps' products added
    in order, as the JAX function adds them."""
    n = (len(kernel) - 1) // 2
    size = img.shape[axis]
    idx = torch.arange(-n, size + n, device=img.device).clamp_(0, size - 1)
    padded = img.index_select(axis, idx)
    out = None
    for k, c in enumerate(kernel):
        term = float(c) * padded.narrow(axis, k, size)
        out = term if out is None else out + term
    return out


def poly_expansion(img: torch.Tensor, poly_n: int = 5,
                   poly_sigma: float = 1.2) -> torch.Tensor:
    """Quadratic polynomial expansion of grey images [..., H, W] →
    [..., H, W, 5] channels (b_y, b_x, a_yy, a_xx, a_xy'), a_xy' in
    OpenCV's 2*A_xy convention: f(x) ~ x^T A x + b^T x + c over a
    Gaussian-weighted ``poly_n`` window, by two separable passes."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_constants(
        poly_n, poly_sigma)
    row_g = _corr1d(img, g, -2)
    row_xg = _corr1d(img, xg, -2)
    row_xxg = _corr1d(img, xxg, -2)

    b1 = _corr1d(row_g, g, -1)       # smoothed signal
    b2 = _corr1d(row_g, xg, -1)      # x-weighted
    b3 = _corr1d(row_xg, g, -1)      # y-weighted
    b4 = _corr1d(row_xxg, g, -1)     # y^2-weighted
    b5 = _corr1d(row_xg, xg, -1)     # xy-weighted
    b6 = _corr1d(row_g, xxg, -1)     # x^2-weighted
    return torch.stack([b3 * ig11,                # b_y
                        b2 * ig11,                # b_x
                        b1 * ig03 + b4 * ig33,    # a_yy
                        b1 * ig03 + b6 * ig33,    # a_xx
                        b5 * ig55], -1)           # a_xy (2*A12)


def _sample_clamped(field: torch.Tensor, fx: torch.Tensor,
                    fy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of [N, H, W, C] at pixel coords (fx, fy) [N, H, W]:
    the coords clamped to the frame, floored, ``x1 = min(x0 + 1, w - 1)``.
    Not the warp's sampler (zeros outside, the reference's normalization)."""
    n, h, w, c = field.shape
    fx = fx.clamp(0.0, w - 1.0)
    fy = fy.clamp(0.0, h - 1.0)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0 = x0.long()
    y0 = y0.long()
    x1 = (x0 + 1).clamp_max(w - 1)
    y1 = (y0 + 1).clamp_max(h - 1)
    flat = field.reshape(n, h * w, c)

    def tap(iy, ix):
        idx = (iy * w + ix).reshape(n, h * w, 1).expand(n, h * w, c)
        return flat.gather(1, idx).reshape(n, h, w, c)

    return (tap(y0, x0) * ((1 - tx) * (1 - ty))[..., None]
            + tap(y0, x1) * (tx * (1 - ty))[..., None]
            + tap(y1, x0) * ((1 - tx) * ty)[..., None]
            + tap(y1, x1) * (tx * ty)[..., None])


def _border_ramp(h: int, w: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """[H, W] confidence in [~0.17, 1], ramping down near the frame edge
    (f32, as JAX forms it, then cast)."""
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    dy = torch.minimum(ys, h - 1 - ys)
    dx = torch.minimum(xs, w - 1 - xs)
    d = torch.minimum(dy[:, None], dx[None, :])
    return ((d + 1.0) / (_BORDER + 1.0)).clamp(0.0, 1.0).to(dtype)


def _update_matrices(r0: torch.Tensor, r1: torch.Tensor,
                     flow: torch.Tensor) -> torch.Tensor:
    """Per-pixel normal-equation entries of the Farneback update.

    A d = db with A the averaged quadratic term and db the displacement-
    compensated difference of the linear terms; returns
    M = [A^T A (3 unique), A^T db (2)] for box averaging.

    Args:
      r0, r1: [..., H, W, 5] expansions of frames 0 and 1.
      flow:   [..., H, W, 2] current (dx, dy) estimate.
    Returns:
      [..., H, W, 5].
    """
    lead = r0.shape[:-3]
    h, w, _ = r0.shape[-3:]
    r0 = r0.reshape((-1, h, w, 5))
    r1 = r1.reshape((-1, h, w, 5))
    flow = flow.reshape((-1, h, w, 2))
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, :]
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    dx, dy = flow[..., 0], flow[..., 1]
    r1s = _sample_clamped(r1, xs + dx, ys + dy)

    a_yy = (r0[..., 2] + r1s[..., 2]) * 0.5
    a_xx = (r0[..., 3] + r1s[..., 3]) * 0.5
    a_xy = (r0[..., 4] + r1s[..., 4]) * 0.25
    db_y = (r0[..., 0] - r1s[..., 0]) * 0.5 + a_yy * dy + a_xy * dx
    db_x = (r0[..., 1] - r1s[..., 1]) * 0.5 + a_xy * dy + a_xx * dx

    s = _border_ramp(h, w, flow.dtype, flow.device)
    a_yy, a_xx, a_xy = a_yy * s, a_xx * s, a_xy * s
    db_y, db_x = db_y * s, db_x * s

    m = torch.stack([a_yy * a_yy + a_xy * a_xy,         # g11
                     (a_yy + a_xx) * a_xy,              # g12
                     a_xx * a_xx + a_xy * a_xy,         # g22
                     a_yy * db_y + a_xy * db_x,         # h1 (y)
                     a_xy * db_y + a_xx * db_x], -1)    # h2 (x)
    return m.reshape(lead + (h, w, 5))


def _box_blur(m: torch.Tensor, winsize: int) -> torch.Tensor:
    """Separable, normalized, edge-clamped box filter over [..., H, W, C]."""
    k = np.full(winsize, 1.0 / winsize, dtype=np.float32)
    return _corr1d(_corr1d(m, k, -3), k, -2)


def _solve_flow(m: torch.Tensor) -> torch.Tensor:
    """2x2 solve of the blurred normal equations → [..., H, W, 2] (dx, dy);
    0 where |det| <= 1e-9 (the JAX function's guard)."""
    g11, g12, g22, h1, h2 = m.unbind(-1)
    det = g11 * g22 - g12 * g12
    idet = torch.where(det.abs() > 1e-9, 1.0 / det, torch.zeros_like(det))
    fx = (g11 * h2 - g12 * h1) * idet
    fy = (g22 * h1 - g12 * h2) * idet
    return torch.stack([fx, fy], -1)


def _gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    if sigma <= 0:
        return img
    n = max(1, int(round(sigma * 2.5)))
    x = np.arange(-n, n + 1, dtype=np.float64)
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    k = (k / k.sum()).astype(np.float32)
    return _corr1d(_corr1d(img, k, -2), k, -1)


def _resize_image(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[N, H, W] → [N, h, w]: ``jax.image.resize(..., "linear")``, which
    antialiases (a widened triangle kernel) when it shrinks; the identity
    at the same size, as JAX's."""
    if img.shape[-2:] == (h, w):
        return img
    return F.interpolate(img[:, None], size=(h, w), mode="bilinear",
                         align_corners=False, antialias=True)[:, 0]


def _resize_flow(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[N, h0, w0, 2] → [N, h, w, 2], an upsample: plain bilinear with
    half-pixel centres."""
    y = F.interpolate(flow.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def level_sizes(h: int, w: int, pyr_scale: float = 0.5, levels: int = 3,
                winsize: int = 15, poly_n: int = 5):
    """The pyramid's (scale, lh, lw), coarsest first: ``levels`` clamped
    so the coarsest level still fits the averaging window (below ~winsize
    pixels the estimate falls into aliased basins), as JAX clamps it."""
    while levels > 0 and round(min(h, w) * pyr_scale ** levels) < winsize:
        levels -= 1
    out = []
    for k in range(levels, -1, -1):
        scale = pyr_scale ** k
        out.append((scale, max(int(round(h * scale)), poly_n),
                    max(int(round(w * scale)), poly_n)))
    return out


def pyramid_level(img: torch.Tensor, scale: float, lh: int,
                  lw: int) -> torch.Tensor:
    """One pyramid level of grey images [N, H, W]: Gaussian pre-smoothing
    by sigma = (1/scale - 1) / 2, then the antialiased resize."""
    return _resize_image(_gaussian_blur(img, (1.0 / scale - 1.0) * 0.5),
                         lh, lw)


def farneback_flow(
    img0: torch.Tensor,
    img1: torch.Tensor,
    pyr_scale: float = 0.5,
    levels: int = 3,
    winsize: int = 15,
    iterations: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 1.2,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Dense flow from frame 0 to frame 1: grey [..., H, W] → [..., H, W, 2].

    Default parameters mirror the reference's cv2 call. ``levels`` counts
    *extra* pyramid levels above full resolution, as cv2's does.
    """
    lead = img0.shape[:-2]
    h, w = img0.shape[-2:]
    img0 = img0.reshape((-1, h, w)).to(dtype)
    img1 = img1.reshape((-1, h, w)).to(dtype)
    n = img0.shape[0]

    flow = None
    for scale, lh, lw in level_sizes(h, w, pyr_scale, levels, winsize,
                                     poly_n):
        i0 = pyramid_level(img0, scale, lh, lw)
        i1 = pyramid_level(img1, scale, lh, lw)
        if flow is None:
            flow = torch.zeros((n, lh, lw, 2), dtype=dtype,
                               device=img0.device)
        else:
            ph, pw = flow.shape[1:3]
            flow = _resize_flow(flow, lh, lw) * torch.tensor(
                [lw / pw, lh / ph], dtype=dtype, device=flow.device)
        r0 = poly_expansion(i0, poly_n, poly_sigma)
        r1 = poly_expansion(i1, poly_n, poly_sigma)
        for _ in range(iterations):
            flow = _solve_flow(_box_blur(_update_matrices(r0, r1, flow),
                                         winsize))
    return flow.reshape(lead + (h, w, 2))


@torch.no_grad()
def batched_flow_pair(target: torch.Tensor, source: torch.Tensor,
                      normalize: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward and backward flow of RGB pairs, on their device.

    Returns (flow_fwd = target→source, flow_back = source→target), each
    [..., H, W, 2], from ``target``, ``source`` [..., H, W, 3] in [0, 1]:
    both directions of every pair go through ONE ``farneback_flow`` call.
    The reference stores the backward flow under its 'fwd' key; the JAX
    package, and the port, keep the plain semantics. ``normalize`` divides
    the pixel-unit flow by the width (roughly into [-1, 1]).
    """
    g_t = rgb_to_gray(target)
    g_s = rgb_to_gray(source)
    flows = farneback_flow(torch.cat([g_t, g_s]), torch.cat([g_s, g_t]))
    fwd, back = flows.split(g_t.shape[0])
    if normalize:
        fwd = fwd / target.shape[-2]
        back = back / target.shape[-2]
    return fwd, back


def pose_flows(target_img: torch.Tensor, source_imgs: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-shot pose's flow channels of ``flow_type='classical'``:
    (flow_fwd, flow_back) [S, B, H, W, 2] of the target [B, H, W, 3]
    against each source [S, B, H, W, 3] (the JAX package ``vmap``s
    ``batched_flow_pair`` over S)."""
    return batched_flow_pair(target_img[None].expand(source_imgs.shape),
                             source_imgs)
