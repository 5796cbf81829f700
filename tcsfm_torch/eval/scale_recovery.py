"""DNet ground-plane scale recovery (counterpart of
``tcsfm/eval/scale_recovery.py``).

Back-project depth, estimate surface normals from 4 cross-product
stencils, mask near-vertical normals below the camera, and take the
median masked per-pixel camera height; scale = real_height / est_height.

The masked median keeps the JAX package's static-shape form: invalid
entries go to +inf, the flat array is sorted, and the k-th entry with
k = (n_valid - 1) // 2 is taken (the lower median, torch.median's
convention). With no ground pixel that entry is +inf and the scale 0, as
in JAX; ``masked_select`` + ``torch.median`` would give NaN there.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tcsfm_torch.geom.camera import backproject


def _normalize(v: torch.Tensor, dim: int, eps: float = 1e-12) -> torch.Tensor:
    return v / (v * v).sum(dim, keepdim=True).clamp_min(eps).sqrt()


def surface_normals(points: torch.Tensor) -> torch.Tensor:
    """Per-pixel surface normals from 3D points [B, H, W, 3] → [B, H, W, 3].

    Four cross-product stencils over ±1-pixel neighbours, averaged and
    normalized, then reflection-padded back to full size.
    """
    c = points[:, 1:-1, 1:-1]
    x0 = points[:, 1:-1, :-2] - c
    x1 = points[:, 1:-1, 2:] - c
    y0 = points[:, :-2, 1:-1] - c
    y1 = points[:, 2:, 1:-1] - c
    x0y0 = points[:, :-2, :-2] - c
    x0y1 = points[:, 2:, :-2] - c
    x1y0 = points[:, :-2, 2:] - c
    x1y1 = points[:, 2:, 2:] - c

    def n(a, b):
        return _normalize(torch.linalg.cross(a, b, dim=-1), -1)

    normals = _normalize((n(x0, y0) + n(x1, y1) + n(x0y0, x0y1)
                          + n(x1y0, x1y1)) / 4.0, -1)
    padded = F.pad(normals.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    return padded.permute(0, 2, 3, 1)


def ground_mask(points: torch.Tensor, normals: torch.Tensor,
                threshold_deg: float = 5.0) -> torch.Tensor:
    """Near-vertical-normal pixels below the camera.

    points, normals: [B, H, W, 3]. Returns bool [B, H, W].
    """
    thr = math.cos(math.radians(threshold_deg))
    cos_sim = _normalize(normals, -1)[..., 1]   # dot with vertical (0, 1, 0)
    vertical = (cos_sim > thr) | (cos_sim < -thr)
    return vertical & (points[..., 1] > 0)


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lower median of ``values`` where ``mask``; +inf where none is."""
    flat_v, flat_m = values.reshape(-1), mask.reshape(-1)
    n_valid = flat_m.sum()
    ordered = torch.sort(torch.where(flat_m, flat_v,
                                     torch.full_like(flat_v, math.inf))).values
    k = ((n_valid - 1) // 2).clamp_min(0)
    return ordered[k]


def _ground_heights(depth: torch.Tensor, K: torch.Tensor):
    """Per-pixel camera heights [B, H, W] and the ground mask [B, H, W]."""
    if depth.dim() == 4:
        depth = depth[..., 0]
    b, h, w = depth.shape
    pts = backproject(depth, K).reshape(b, 3, h, w).permute(0, 2, 3, 1)
    normals = surface_normals(pts)
    return (pts * normals).sum(-1).abs(), ground_mask(pts, normals)


def scale_recovery(depth: torch.Tensor, K: torch.Tensor,
                   real_cam_height: float) -> torch.Tensor:
    """Metric scale factor from ground-plane geometry.

    Args:
      depth: [B, H, W] or [B, H, W, 1] predicted depth.
      K:     [B, 3, 3] intrinsics.
      real_cam_height: true camera height in the depth's metric units.

    Returns a 0-d tensor; the median is taken over the whole batch.
    """
    heights, gmask = _ground_heights(depth, K)
    return real_cam_height / masked_median(heights, gmask)


def scale_recovery_per_sample(depth: torch.Tensor, K: torch.Tensor,
                              real_cam_height: float) -> torch.Tensor:
    """``scale_recovery`` of each sample on its own, [B]: the JAX
    package's ``vmap`` of it (``tcsfm/eval/vo.py``), one sort for the
    batch."""
    heights, gmask = _ground_heights(depth, K)
    b = heights.shape[0]
    flat_m = gmask.reshape(b, -1)
    ordered = torch.sort(torch.where(flat_m, heights.reshape(b, -1),
                                     torch.full_like(heights.reshape(b, -1),
                                                     math.inf)), dim=1).values
    k = ((flat_m.sum(1) - 1) // 2).clamp_min(0)
    return real_cam_height / ordered.gather(1, k[:, None])[:, 0]
