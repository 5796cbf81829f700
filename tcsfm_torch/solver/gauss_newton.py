"""Gauss-Newton / Levenberg-Marquardt photometric pose refinement
(counterpart of ``tcsfm/solver/gauss_newton.py``).

Damped Gauss-Newton on the photometric objective, per window:

  r(xi) = I_tgt - warp(I_src; D, xi)          per pixel, masked by valid
  delta = -(J^T J + lam diag(J^T J) + 1e-8 I)^-1 J^T r,   xi <- xi + delta

with the 6 Jacobian columns from ``torch.func.jvp`` against the se(3)
basis tangents (no [Npix, 6] system beyond what the einsum reductions
consume). Batched over windows; the JAX package's ``lax.scan`` is a Python
loop that keeps its per-window accept/reject, lambda x0.3 on accept and x5
on reject, clipped to [1e-6, 1e6]. Nothing in the loop waits for the
card: the accept decisions are ``torch.where`` on the device.

On the card the residual samples with ``grid_sample`` (the value kernel)
and every jvp goes through ``grid_sample_fwd_diff`` (one launch of the
value+Jacobian kernel, ``ops/csrc/grid_sample.cu``); per LM iteration 2
value launches and 6 value+Jacobian launches. ``sampler=grid_sample_plain``
swaps every sampler call for the plain twin.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tcsfm_torch.geom.warp import Sampler, inverse_warp2
from tcsfm_torch.ops.grid_sample import fwd_diff_of, grid_sample
from tcsfm_torch.solver.ba import _f32, _solve


class GNResult(NamedTuple):
    pose: torch.Tensor          # [B, 6] refined pose
    cost: torch.Tensor          # [iters+1, B] photometric cost per iteration
    delta_norm: torch.Tensor    # [iters, B] update magnitudes


def _residuals(pose, target_img, source_img, tgt_depth, K,
               sampler: Sampler = grid_sample):
    """Masked photometric residuals r [B, H, W, 3] and the valid mask
    [B, H, W, 1]. The warp convention matches ``solve_pose_iteratively``
    (warp with -pose); only RGB is sampled (``sample_depth=False``): the
    JAX package's XLA residual samples the source depth and discards it.
    """
    warped, valid, _, _ = inverse_warp2(source_img, tgt_depth, None, -pose,
                                        K, sample_depth=False,
                                        sampler=sampler)
    return (target_img - warped) * valid, valid


def gauss_newton_pose(
    pose0,
    target_img,
    source_img,
    tgt_depth,
    src_depth,
    K,
    iters: int = 10,
    damping: float = 1e-3,
    sampler: Sampler = grid_sample,
    device=None,
) -> GNResult:
    """Refine [B, 6] poses by damped Gauss-Newton on photometric residuals.

    Args:
      pose0: [B, 6] initial poses (solver convention).
      target_img/source_img: [B, H, W, 3]; depths [B, H, W, 1]; K [B, 3, 3]
        (tensors or arrays, moved to ``device`` as float32). ``src_depth``
        is accepted for the JAX package's signature and never sampled.
      iters: GN iterations.
      damping: the initial Levenberg-Marquardt lambda.
      sampler: ``grid_sample`` (the CUDA kernels on the card) or
        ``ops.grid_sample.grid_sample_plain``.
      device: None means the card (raises where there is none).
    """
    pose0, target_img, source_img, tgt_depth, K = _f32(
        pose0, target_img, source_img, tgt_depth, K, device=device)
    del src_depth
    b = pose0.shape[0]
    eye6 = torch.eye(6, device=pose0.device)
    jvp_sampler = fwd_diff_of(sampler)

    def r_of(pose, s=sampler):
        return _residuals(pose, target_img, source_img, tgt_depth, K, s)[0]

    def cost_of(pose):
        r = r_of(pose)
        return torch.sum(r * r, dim=(1, 2, 3))

    pose, cost = pose0, cost_of(pose0)
    lam = torch.full((b,), damping, device=pose0.device)
    costs, dnorms = [cost], []
    for _ in range(iters):
        r0 = r_of(pose)
        # J columns via jvp against the 6 basis directions
        cols = [torch.func.jvp(lambda p: r_of(p, jvp_sampler), (pose,),
                               (eye6[k].expand(b, 6),))[1] for k in range(6)]
        J = torch.stack(cols, dim=-1)                      # [B, H, W, 3, 6]
        JtJ = torch.einsum("bhwck,bhwcl->bkl", J, J)       # [B, 6, 6]
        Jtr = torch.einsum("bhwck,bhwc->bk", J, r0)        # [B, 6]

        # Marquardt scaling: A = JtJ + lam diag(JtJ) (+ small absolute floor)
        A = JtJ + lam[:, None, None] * (JtJ * eye6) + 1e-8 * eye6
        delta = -_solve(A, Jtr)
        new_pose = pose + delta

        # per-window trust region: accept + shrink lam, or reject + grow lam
        new_cost = cost_of(new_pose)
        better = new_cost < cost
        pose = torch.where(better[:, None], new_pose, pose)
        cost = torch.where(better, new_cost, cost)
        lam = torch.where(better, lam * 0.3, lam * 5.0).clamp(1e-6, 1e6)
        costs.append(cost)
        dnorms.append(torch.linalg.norm(delta, dim=-1))
    return GNResult(pose=pose, cost=torch.stack(costs),
                    delta_norm=torch.stack(dnorms) if dnorms
                    else pose.new_zeros(0, b))
