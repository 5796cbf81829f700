"""Pose vectors to rotation and transform matrices (counterpart of
``tcsfm/geom/se3.py:33-105``).

Conventions of the reference: 6-DoF pose vectors are ``[tx ty tz rx ry rz]``
(translation first) and ``euler2mat`` composes ``R = Rx @ Ry @ Rz``. The
exponential and logarithm maps come with the refiner slice.
"""

from __future__ import annotations

import torch


def _stack33(rows) -> torch.Tensor:
    """Build [..., 3, 3] from 9 same-shaped entries (row major)."""
    return torch.stack([torch.stack(rows[0:3], -1),
                        torch.stack(rows[3:6], -1),
                        torch.stack(rows[6:9], -1)], dim=-2)


def euler2mat(angle: torch.Tensor) -> torch.Tensor:
    """Euler angles [..., 3] (rx, ry, rz) → rotations [..., 3, 3], R = Rx Ry Rz."""
    x, y, z = angle[..., 0], angle[..., 1], angle[..., 2]
    o = torch.ones_like(x)
    zr = torch.zeros_like(x)
    cz, sz = torch.cos(z), torch.sin(z)
    zmat = _stack33([cz, -sz, zr, sz, cz, zr, zr, zr, o])
    cy, sy = torch.cos(y), torch.sin(y)
    ymat = _stack33([cy, zr, sy, zr, o, zr, -sy, zr, cy])
    cx, sx = torch.cos(x), torch.sin(x)
    xmat = _stack33([o, zr, zr, zr, cx, -sx, zr, sx, cx])
    return (xmat @ ymat) @ zmat


def quat2mat(quat: torch.Tensor) -> torch.Tensor:
    """[..., 3] imaginary quaternion coefficients → [..., 3, 3] rotations.

    The real part is fixed at 1 before normalization.
    """
    q = torch.cat([torch.ones_like(quat[..., :1]), quat], -1)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return _stack33([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ])


def pose_vec2mat(vec: torch.Tensor, rotation_mode: str = "euler") -> torch.Tensor:
    """6-DoF pose vector [..., 6] → [..., 3, 4] transform."""
    t = vec[..., :3, None]
    rot = vec[..., 3:6]
    if rotation_mode == "euler":
        R = euler2mat(rot)
    elif rotation_mode == "quat":
        R = quat2mat(rot)
    else:
        raise ValueError(rotation_mode)
    return torch.cat([R, t], -1)


def pose_vec2mat44(vec: torch.Tensor, rotation_mode: str = "euler") -> torch.Tensor:
    """6-DoF pose vector [..., 6] → [..., 4, 4] homogeneous transform."""
    T34 = pose_vec2mat(vec, rotation_mode)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=T34.dtype,
                          device=T34.device).expand(T34.shape[:-2] + (1, 4))
    return torch.cat([T34, bottom], -2)
