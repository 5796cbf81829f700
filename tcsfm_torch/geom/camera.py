"""Pinhole back-projection and projection (counterpart of ``tcsfm/geom/camera.py``).

Points are [B, 3, H*W] over a flattened pixel grid; depths and coords stay
NHWC-shaped as in the JAX package. Float32 matmuls run in full f32 on the
card unless TF32 is switched on (``torch.backends.cuda.matmul.allow_tf32``),
which the port does not do.
"""

from __future__ import annotations

import torch


def pixel_grid(h: int, w: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Homogeneous pixel coordinates [3, H*W], rows (x, y, 1)."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=dtype),
                            torch.arange(w, device=device, dtype=dtype),
                            indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1),
                        torch.ones(h * w, device=device, dtype=dtype)])


def inv_intrinsics(K: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [..., 3, 3] pinhole intrinsics (no solve)."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    s = K[..., 0, 1]
    zr = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    inv_fx, inv_fy = 1.0 / fx, 1.0 / fy
    row0 = torch.stack([inv_fx, -s * inv_fx * inv_fy,
                        (s * cy - cx * fy) * inv_fx * inv_fy], -1)
    row1 = torch.stack([zr, inv_fy, -cy * inv_fy], -1)
    row2 = torch.stack([zr, zr, o], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def backproject(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Depth [B, H, W] or [B, H, W, 1] + intrinsics [B, 3, 3] → [B, 3, H*W].

    cam = depth * K^{-1} [x y 1]^T

    The pixel grid is made in the depth's dtype and the product promotes
    to the wider of K's and the depth's, as ``jnp.matmul`` does
    (``tcsfm/geom/camera.py:51-62``): a bfloat16 depth with float32 K
    gives float32 points from a bfloat16-rounded grid.
    """
    if depth.dim() == 4:
        depth = depth[..., 0]
    b, h, w = depth.shape
    dtype = torch.promote_types(K.dtype, depth.dtype)
    grid = pixel_grid(h, w, depth.dtype, depth.device)       # [3, HW]
    rays = inv_intrinsics(K).to(dtype) @ grid.to(dtype)      # [B, 3, HW]
    return rays * depth.reshape(b, 1, h * w)


def project(points: torch.Tensor, K: torch.Tensor, h: int, w: int,
            eps: float = 1e-3) -> tuple[torch.Tensor, torch.Tensor]:
    """Project [B, 3, HW] camera points → (coords [B, H, W, 2], depth [B, H, W]).

    Coords use the reference's align_corners=True convention 2*(u/(W-1))-1.
    """
    b = points.shape[0]
    pix = K @ points                                         # [B, 3, HW]
    X, Y = pix[:, 0], pix[:, 1]
    Z = pix[:, 2].clamp_min(eps)
    x_norm = 2.0 * (X / Z) / (w - 1) - 1.0
    y_norm = 2.0 * (Y / Z) / (h - 1) - 1.0
    coords = torch.stack([x_norm, y_norm], -1).reshape(b, h, w, 2)
    return coords, Z.reshape(b, h, w)
