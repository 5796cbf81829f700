"""Batched SO(3)/SE(3) operations (counterpart of ``tcsfm/geom/se3.py``):
pose vectors to rotation and transform matrices, and the exponential and
logarithm maps.

Conventions of the reference: 6-DoF pose vectors are ``[tx ty tz rx ry rz]``
(translation first) and ``euler2mat`` composes ``R = Rx @ Ry @ Rz``;
``se3_exp``/``se3_log`` take xi = [rho, phi], translation first, as
liegroups' ``SE3.exp`` of the reference's trajectory integration. The
maps use closed-form series with Taylor fallbacks near theta = 0, behind
the double-``where`` guard (``_safe_theta``): ``torch.where`` passes a NaN
from its unselected branch into the gradient as ``jnp.where`` does, so
that branch never sees theta = 0, and the gradient there stays finite.
"""

from __future__ import annotations

import torch


def _stack33(rows) -> torch.Tensor:
    """Build [..., 3, 3] from 9 same-shaped entries (row major)."""
    return torch.stack([torch.stack(rows[0:3], -1),
                        torch.stack(rows[3:6], -1),
                        torch.stack(rows[6:9], -1)], dim=-2)


def _bottom(like: torch.Tensor, lead) -> torch.Tensor:
    """The homogeneous row [0, 0, 0, 1] as [*lead, 1, 4]."""
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=like.dtype,
                        device=like.device).expand(tuple(lead) + (1, 4))


def _eye(like: torch.Tensor) -> torch.Tensor:
    """Identities shaped as the [..., 3, 3] ``like``."""
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        like.shape)


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
    return torch.cat([T34, _bottom(T34, T34.shape[:-2])], -2)


# --------------------------------------------------------------------------
# SO(3) / SE(3) exponential and logarithm maps
# --------------------------------------------------------------------------

def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] → [..., 3, 3] cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zr = torch.zeros_like(x)
    return _stack33([zr, -z, y, z, zr, -x, -y, x, zr])


def _safe_theta(theta2: torch.Tensor):
    """(small_mask, safe_theta2, theta): the double-where guard, so the
    gradient of the unselected branch never sees theta = 0."""
    small = theta2 < 1e-8
    safe_theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    return small, safe_theta2, torch.sqrt(safe_theta2)


def _sin_theta_over_theta(theta2):
    """sin(t)/t with a Taylor fallback; takes theta^2 to stay
    differentiable."""
    small, t2, theta = _safe_theta(theta2)
    return torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)


def _one_minus_cos_over_theta2(theta2):
    small, t2, theta = _safe_theta(theta2)
    return torch.where(small, 0.5 - theta2 / 24.0,
                       (1.0 - torch.cos(theta)) / t2)


def _theta_minus_sin_over_theta3(theta2):
    small, t2, theta = _safe_theta(theta2)
    return torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                       (theta - torch.sin(theta)) / (t2 * theta))


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rotation vector [..., 3] → [..., 3, 3] by Rodrigues' formula."""
    theta2 = (phi * phi).sum(-1)
    K = skew(phi)
    A = _sin_theta_over_theta(theta2)[..., None, None]
    B = _one_minus_cos_over_theta2(theta2)[..., None, None]
    return _eye(K) + A * K + B * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation → [..., 3] rotation vector, for theta in
    [0, pi) (the inter-frame rotations of SfM, as the reference's
    liegroups ``SO3.log``)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = ((trace - 1.0) / 2.0).clamp(-1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    # vee = 2 sin(theta) * axis ; phi = theta * axis
    theta2 = theta * theta
    small = theta2 < 1e-8
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    scale = 0.5 / torch.where(small, 1.0 - theta2 / 6.0,
                              torch.sin(safe_theta) / safe_theta)
    return scale[..., None] * vee


def _left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(phi): the V matrix of the SE(3) exp."""
    theta2 = (phi * phi).sum(-1)
    K = skew(phi)
    B = _one_minus_cos_over_theta2(theta2)[..., None, None]
    C = _theta_minus_sin_over_theta3(theta2)[..., None, None]
    return _eye(K) + B * K + C * (K @ K)


def _left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = (phi * phi).sum(-1)
    small, t2, theta = _safe_theta(theta2)
    K = skew(phi)
    half = 0.5 * theta
    cot_coeff = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / t2)
    return _eye(K) - 0.5 * K + cot_coeff[..., None, None] * (K @ K)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) vector [..., 6] = [rho, phi] → [..., 4, 4] transform."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], -1)
    return torch.cat([top, _bottom(xi, xi.shape[:-1])], -2)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] transform → [..., 6] = [rho, phi]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    rho = (_left_jacobian_inv(phi) @ t[..., None])[..., 0]
    return torch.cat([rho, phi], -1)


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] rigid transform inverse (R^T, no general solve)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t_inv = -(Rt @ T[..., :3, 3:4])
    top = torch.cat([Rt, t_inv], -1)
    return torch.cat([top, _bottom(T, T.shape[:-2])], -2)


def se3_from_matrix(T: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Project a noisy [..., 4, 4] onto SE(3) (liegroups'
    ``from_matrix(normalize=True)``): the rotation block orthogonalized as
    U diag(1, 1, det(U Vt)) Vt by SVD. The product does not depend on the
    SVD's signs, which may differ from ``jnp.linalg.svd``'s."""
    if not normalize:
        return T
    U, _, Vt = torch.linalg.svd(T[..., :3, :3])
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    Rn = U @ (D[..., :, None] * Vt)
    top = torch.cat([Rn, T[..., :3, 3:4]], -1)
    return torch.cat([top, _bottom(T, T.shape[:-2])], -2)
