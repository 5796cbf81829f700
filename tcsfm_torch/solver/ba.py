"""Photometric bundle adjustment: joint pose + per-pixel depth refinement
with an exact Schur complement over the depth block (counterpart of
``tcsfm/solver/ba.py``).

The photometric residual at pixel i depends only on the depth at pixel i
(through that pixel's reprojection), so the depth Hessian block is
diagonal and the Schur complement is closed-form:

  reduced pose system:  (H_pp - sum_i h_i h_i^T / H_dd_i) dp
                            = -(g_p - sum_i h_i g_d_i / H_dd_i)
  depth back-subst:     dd_i = -(g_d_i + h_i^T dp) / H_dd_i

with h_i = J_p_i^T J_d_i per pixel. The pose Jacobian comes from 6
``torch.func.jvp``s against the se(3) basis, the depth Jacobian diagonal
from ONE jvp with a ones-tangent (diagonality makes the full jvp equal the
diagonal), and the reductions are ``torch.einsum`` matrix products, as the
JAX package left them to XLA.

Each ``lax.scan`` LM loop of the JAX package is a Python loop here, with
the same per-window accept/reject, lambda x0.3 on accept and x5 on
reject, clipped to [1e-4, 1e6], and the max(., 1e-3) depth clamp;
``chain_ba`` keeps its per-window lambdas with one global accept. The
accept decisions are ``torch.where`` on the device, so no iteration waits
for the card.

The residual (``_residual``) is the XLA residual's: it warps RGB only
(the XLA path samples the source depth and discards it) and masks with
``valid``. The banded MXU path's knobs (``use_mxu_warp``, ``mxu_exact``,
``mxu_band``, ``interpret``) and its band-coverage mask are TPU
workarounds and have no counterpart. On the card the residual samples with
``grid_sample`` (the value kernel) and every jvp goes through
``grid_sample_fwd_diff`` (one launch of the value+Jacobian kernel); one
``_gn_blocks`` costs 1 value launch and 7 value+Jacobian launches.
``sampler=grid_sample_plain`` swaps every sampler call for the plain twin.

Every entry point moves its inputs to ``device`` as float32 (``_f32``):
None means the card, and raises where there is none.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tcsfm_torch.geom.warp import Sampler, inverse_warp2
from tcsfm_torch.ops.grid_sample import fwd_diff_of, grid_sample
from tcsfm_torch.utils.helpers import resolve_device


class BAResult(NamedTuple):
    pose: torch.Tensor          # [B, 6]
    depth: torch.Tensor         # [B, H, W, 1] refined target depth
    cost: torch.Tensor          # [iters+1, B]
    pose_info: torch.Tensor     # [B, 6, 6] reduced pose information matrix
    #   (Gauss-Newton Hessian after marginalizing depth) at the solution


def _f32(*xs, device=None):
    """Solver inputs as float32 on ``device`` (None: the card). BA is a
    second-order method (Hessian blocks, Schur complements, LM accept
    tests) and solves in f32 whatever type the upstream networks ran in."""
    device = resolve_device(device)
    out = tuple((torch.from_numpy(np.asarray(x)) if not torch.is_tensor(x)
                 else x).to(device=device, dtype=torch.float32).contiguous()
                for x in xs)
    return out[0] if len(out) == 1 else out


def _residual(pose, depth, target_img, source_img, K,
              sampler: Sampler = grid_sample):
    warped, valid, _, _ = inverse_warp2(source_img, depth, None, -pose, K,
                                        sample_depth=False, sampler=sampler)
    return (target_img - warped) * valid


def _gn_blocks(r_fn, pose, depth, sampler: Sampler = grid_sample):
    """Gauss-Newton blocks of one residual family vs (pose, depth).

    ``r_fn(pose, depth, sampler)`` is the residual; ``r0`` samples with
    ``sampler``, the 7 jvps with ``fwd_diff_of(sampler)``.

    Returns (H_pp [B,6,6], g_p [B,6], h [B,H,W,6], H_dd [B,H,W],
    g_d [B,H,W]) WITHOUT any prior terms; callers add those.
    """
    b = pose.shape[0]
    eye6 = torch.eye(6, device=pose.device)
    jvp_sampler = fwd_diff_of(sampler)
    r0 = r_fn(pose, depth, sampler)                        # [B, H, W, 3]
    cols = [torch.func.jvp(lambda p: r_fn(p, depth, jvp_sampler), (pose,),
                           (eye6[k].expand(b, 6),))[1] for k in range(6)]
    Jp = torch.stack(cols, dim=-1)                         # [B, H, W, 3, 6]
    _, Jd = torch.func.jvp(lambda d: r_fn(pose, d, jvp_sampler), (depth,),
                           (torch.ones_like(depth),))      # [B, H, W, 3]
    H_pp = torch.einsum("bhwck,bhwcl->bkl", Jp, Jp)        # [B, 6, 6]
    g_p = torch.einsum("bhwck,bhwc->bk", Jp, r0)           # [B, 6]
    h = torch.einsum("bhwck,bhwc->bhwk", Jp, Jd)           # [B, H, W, 6]
    H_dd = torch.sum(Jd * Jd, dim=-1)                      # [B, H, W]
    g_d = torch.sum(Jd * r0, dim=-1)                       # [B, H, W]
    return H_pp, g_p, h, H_dd, g_d


def _schur(h_k, inv_Hdd, h_l):
    """sum over pixels of h_k h_l^T / H_dd: [B, 6, 6]."""
    return torch.einsum("bhwk,bhw,bhwl->bkl", h_k, inv_Hdd, h_l)


def _schur_rhs(h, inv_Hdd, g_d):
    """sum over pixels of h g_d / H_dd: [B, 6]."""
    return torch.einsum("bhwk,bhw,bhw->bk", h, inv_Hdd, g_d)


def _solve(A, rhs):
    """A^-1 rhs for batched [.., n, n] A and [.., n] rhs, without a host
    sync (a singular system gives non-finite values, as JAX's solve)."""
    return torch.linalg.solve_ex(A, rhs[..., None])[0][..., 0]


def _prior(depth, depth0, weight):
    return weight * torch.sum((depth - depth0) ** 2, dim=(1, 2, 3))


def _sumsq(r):
    return torch.sum(r * r, dim=(1, 2, 3))


def photometric_ba(
    pose0,
    depth0,
    target_img,
    source_img,
    src_depth,
    K,
    iters: int = 8,
    pose_damping: float = 1e-2,
    depth_damping: float = 1e-2,
    depth_prior_weight: float = 1.0,
    sampler: Sampler = grid_sample,
    device=None,
) -> BAResult:
    """Jointly refine [B, 6] pose and [B, H, W, 1] target depth.

    ``depth_prior_weight`` adds a quadratic prior pulling depth toward its
    initial value (the network prediction). ``src_depth`` is accepted for
    the JAX package's signature and never sampled.
    """
    pose0, depth0, target_img, source_img, K = _f32(
        pose0, depth0, target_img, source_img, K, device=device)
    del src_depth
    b = pose0.shape[0]
    eye6 = torch.eye(6, device=pose0.device)

    def r_of(pose, depth, s=sampler):
        return _residual(pose, depth, target_img, source_img, K, s)

    def cost_of(pose, depth):
        return (_sumsq(r_of(pose, depth))
                + _prior(depth, depth0, depth_prior_weight))

    def blocks_of(pose, depth):
        """Gauss-Newton blocks of the joint (pose, depth) system."""
        H_pp, g_p, h, H_dd, g_d = _gn_blocks(r_of, pose, depth, sampler)
        H_dd = H_dd + depth_prior_weight
        g_d = g_d + depth_prior_weight * ((depth - depth0)[..., 0])
        return H_pp, g_p, h, H_dd, g_d

    pose, depth = pose0, depth0
    lam = torch.ones(b, device=pose0.device)
    cost = cost_of(pose0, depth0)
    costs = [cost]
    for _ in range(iters):
        H_pp, g_p, h, H_dd, g_d = blocks_of(pose, depth)

        # LM damping on both blocks
        H_dd = H_dd * (1.0 + lam)[:, None, None] + depth_damping
        inv_Hdd = 1.0 / H_dd

        # Schur complement of the diagonal depth block
        S = H_pp - _schur(h, inv_Hdd, h)
        rhs = g_p - _schur_rhs(h, inv_Hdd, g_d)
        S = S + (pose_damping * (1.0 + lam))[:, None, None] * (S * eye6 + eye6)
        dp = -_solve(S, rhs)                                     # [B, 6]

        # depth back-substitution
        dd = -(g_d + torch.einsum("bhwk,bk->bhw", h, dp)) * inv_Hdd
        new_pose = pose + dp
        new_depth = torch.clamp_min(depth + dd[..., None], 1e-3)

        new_cost = cost_of(new_pose, new_depth)
        better = new_cost < cost
        pose = torch.where(better[:, None], new_pose, pose)
        depth = torch.where(better[:, None, None, None], new_depth, depth)
        cost = torch.where(better, new_cost, cost)
        lam = torch.where(better, lam * 0.3, lam * 5.0).clamp(1e-4, 1e6)
        costs.append(cost)

    # reduced pose information at the solution (undamped Schur complement)
    H_pp, _, h, H_dd, _ = blocks_of(pose, depth)
    info = H_pp - _schur(h, 1.0 / H_dd, h)
    return BAResult(pose=pose, depth=depth, cost=torch.stack(costs),
                    pose_info=info)


# --------------------------------------------------------------------------
# sequence-level BA: information-weighted fwd/inv fusion over a pose chain
# --------------------------------------------------------------------------


def fuse_pose_estimates(xi_fwd, info_fwd, xi_inv, info_inv,
                        damping: float = 1e-8):
    """Information-weighted fusion of the two estimates of one relative
    pose: solves (I_f + I_i) xi = I_f xi_fwd - I_i xi_inv, which reduces
    to the reference's (fwd - inv) / 2 when the two informations are equal.

    Args: all [B, 6] / [B, 6, 6]. Returns fused [B, 6].
    """
    A = info_fwd + info_inv + damping * torch.eye(6, device=info_fwd.device)
    rhs = (torch.einsum("bkl,bl->bk", info_fwd, xi_fwd)
           - torch.einsum("bkl,bl->bk", info_inv, xi_inv))
    return _solve(A, rhs)


class SequenceBAResult(NamedTuple):
    fused_pose: torch.Tensor    # [N-1, 6] information-fused t -> t+1 twists
    fwd: BAResult               # per-pair forward refinement
    inv: BAResult               # per-pair inverse refinement


def sequence_ba(frames, depths, K, pose0_fwd, pose0_inv, iters: int = 8,
                residual_variance_weighting: bool = True,
                device=None, **ba_kwargs) -> SequenceBAResult:
    """Refine a whole pose chain: batched fwd+inv per-pair BA, then
    information-weighted fusion of each pair's two estimates.

    Args:
      frames:    [N, H, W, 3] consecutive frames of one sequence block.
      depths:    [N, H, W, 1] per-frame (network) depth.
      K:         [3, 3] shared intrinsics (or [N-1, 3, 3] per pair).
      pose0_fwd: [N-1, 6] initial t -> t+1 twists.
      pose0_inv: [N-1, 6] initial t+1 -> t twists.
      residual_variance_weighting: scale each window's information by
        1 / sigma^2 with sigma^2 = final cost / Npix.
    """
    frames, depths, K, pose0_fwd, pose0_inv = _f32(
        frames, depths, K, pose0_fwd, pose0_inv, device=device)
    tgt_f, src_f = frames[:-1], frames[1:]
    d_tgt, d_src = depths[:-1], depths[1:]
    n = tgt_f.shape[0]
    K_b = K.expand(n, 3, 3) if K.dim() == 2 else K

    fwd = photometric_ba(pose0_fwd, d_tgt, tgt_f, src_f, d_src, K_b,
                         iters=iters, device=frames.device, **ba_kwargs)
    inv = photometric_ba(pose0_inv, d_src, src_f, tgt_f, d_tgt, K_b,
                         iters=iters, device=frames.device, **ba_kwargs)
    info_f, info_i = fwd.pose_info, inv.pose_info
    if residual_variance_weighting:
        npix = float(np.prod(tgt_f.shape[1:]))
        info_f = info_f / torch.clamp_min(fwd.cost[-1] / npix,
                                          1e-12)[:, None, None]
        info_i = info_i / torch.clamp_min(inv.cost[-1] / npix,
                                          1e-12)[:, None, None]
    fused = fuse_pose_estimates(fwd.pose, info_f, inv.pose, info_i)
    return SequenceBAResult(fused_pose=fused, fwd=fwd, inv=inv)


# --------------------------------------------------------------------------
# cross-window shared-pose coupling: 3-frame window BA with a SHARED target
# depth + the block-tridiagonal reduced camera system over the pose chain
# --------------------------------------------------------------------------


class WindowBAResult(NamedTuple):
    """Joint refinement of one 3-frame window (prev, target, next): after
    marginalizing the shared (diagonal) depth block the reduced pose
    system is a 12x12 with a non-zero cross block."""
    pose_prev: torch.Tensor     # [B, 6] refined target -> prev twist
    pose_next: torch.Tensor     # [B, 6] refined target -> next twist
    depth: torch.Tensor         # [B, H, W, 1] refined target depth
    cost: torch.Tensor          # [iters+1, B]
    S_aa: torch.Tensor          # [B, 6, 6] reduced info, prev-pose block
    S_ab: torch.Tensor          # [B, 6, 6] reduced cross block (prev, next)
    S_bb: torch.Tensor          # [B, 6, 6] reduced info, next-pose block


def _reduced(H_aa, H_bb, h_a, h_b, inv_Hdd):
    S_aa = H_aa - _schur(h_a, inv_Hdd, h_a)
    S_ab = -_schur(h_a, inv_Hdd, h_b)
    S_bb = H_bb - _schur(h_b, inv_Hdd, h_b)
    return S_aa, S_ab, S_bb


def window_ba(
    pose_prev0,
    pose_next0,
    depth0,
    target_img,
    prev_img,
    next_img,
    prev_depth,
    next_depth,
    K,
    iters: int = 8,
    pose_damping: float = 1e-2,
    depth_damping: float = 1e-2,
    depth_prior_weight: float = 1.0,
    sampler: Sampler = grid_sample,
    device=None,
) -> WindowBAResult:
    """Jointly refine both window poses and the SHARED target depth:
    residuals r_a (target vs prev) and r_b (target vs next) both depend on
    the same target depth, so depth marginalization gives the coupled 12x12
    reduced system. ``prev_depth``/``next_depth`` are accepted for the JAX
    package's signature and never sampled."""
    (pose_prev0, pose_next0, depth0, target_img, prev_img, next_img,
     K) = _f32(pose_prev0, pose_next0, depth0, target_img, prev_img,
               next_img, K, device=device)
    del prev_depth, next_depth
    b = pose_prev0.shape[0]
    eye12 = torch.eye(12, device=K.device)

    def r_a_fn(p, d, s=sampler):
        return _residual(p, d, target_img, prev_img, K, s)

    def r_b_fn(p, d, s=sampler):
        return _residual(p, d, target_img, next_img, K, s)

    def cost_of(pa, pb, depth):
        return (_sumsq(r_a_fn(pa, depth)) + _sumsq(r_b_fn(pb, depth))
                + _prior(depth, depth0, depth_prior_weight))

    def blocks_of(pa, pb, depth):
        H_aa, g_a, h_a, Hdd_a, gd_a = _gn_blocks(r_a_fn, pa, depth, sampler)
        H_bb, g_b, h_b, Hdd_b, gd_b = _gn_blocks(r_b_fn, pb, depth, sampler)
        H_dd = Hdd_a + Hdd_b + depth_prior_weight
        g_d = gd_a + gd_b + depth_prior_weight * ((depth - depth0)[..., 0])
        return H_aa, H_bb, g_a, g_b, h_a, h_b, H_dd, g_d

    pa, pb, depth = pose_prev0, pose_next0, depth0
    lam = torch.ones(b, device=K.device)
    cost = cost_of(pa, pb, depth)
    costs = [cost]
    for _ in range(iters):
        H_aa, H_bb, g_a, g_b, h_a, h_b, H_dd, g_d = blocks_of(pa, pb, depth)

        H_dd = H_dd * (1.0 + lam)[:, None, None] + depth_damping
        inv_Hdd = 1.0 / H_dd
        S_aa, S_ab, S_bb = _reduced(H_aa, H_bb, h_a, h_b, inv_Hdd)
        rhs_a = g_a - _schur_rhs(h_a, inv_Hdd, g_d)
        rhs_b = g_b - _schur_rhs(h_b, inv_Hdd, g_d)

        S = torch.cat([torch.cat([S_aa, S_ab], dim=-1),
                       torch.cat([S_ab.transpose(1, 2), S_bb], dim=-1)],
                      dim=1)                                  # [B, 12, 12]
        damp = (pose_damping * (1.0 + lam))[:, None, None]
        S = S + damp * (S * eye12 + eye12)
        dp = -_solve(S, torch.cat([rhs_a, rhs_b], dim=-1))    # [B, 12]
        dpa, dpb = dp[:, :6], dp[:, 6:]

        dd = -(g_d + torch.einsum("bhwk,bk->bhw", h_a, dpa)
               + torch.einsum("bhwk,bk->bhw", h_b, dpb)) * inv_Hdd
        new_pa, new_pb = pa + dpa, pb + dpb
        new_depth = torch.clamp_min(depth + dd[..., None], 1e-3)

        new_cost = cost_of(new_pa, new_pb, new_depth)
        better = new_cost < cost
        pa = torch.where(better[:, None], new_pa, pa)
        pb = torch.where(better[:, None], new_pb, pb)
        depth = torch.where(better[:, None, None, None], new_depth, depth)
        cost = torch.where(better, new_cost, cost)
        lam = torch.where(better, lam * 0.3, lam * 5.0).clamp(1e-4, 1e6)
        costs.append(cost)

    # undamped reduced system at the solution: the window's contribution
    # to the sequence reduced camera system
    H_aa, H_bb, _, _, h_a, h_b, H_dd, _ = blocks_of(pa, pb, depth)
    S_aa, S_ab, S_bb = _reduced(H_aa, H_bb, h_a, h_b, 1.0 / H_dd)
    return WindowBAResult(pose_prev=pa, pose_next=pb, depth=depth,
                          cost=torch.stack(costs), S_aa=S_aa, S_ab=S_ab,
                          S_bb=S_bb)


def block_tridiag_solve(D, U, b):
    """Solve the symmetric block-tridiagonal system (block Thomas).

    D [E, 6, 6] diagonal blocks, U [E-1, 6, 6] super-diagonal blocks (the
    lower diagonal is U^T), b [E, 6]. The JAX package's two ``lax.scan``s
    are two Python loops of 6x6 solves; each forward step solves for C_i
    and d_i in one call (7 right-hand sides).
    """
    E = D.shape[0]
    zero = D.new_zeros(6, 6)
    C_prev, d_prev = zero, D.new_zeros(6)
    C, d = [], []
    for i in range(E):
        Ut_prev = U[i - 1].T if i > 0 else zero
        M = D[i] - Ut_prev @ C_prev
        Ui = U[i] if i < E - 1 else zero
        rhs = b[i] - (Ut_prev @ d_prev[:, None])[:, 0]
        sol = torch.linalg.solve_ex(M, torch.cat([Ui, rhs[:, None]], 1))[0]
        C_prev, d_prev = sol[:, :6], sol[:, 6]
        C.append(C_prev)
        d.append(d_prev)
    xs = [None] * E
    x_next = D.new_zeros(6)
    for i in reversed(range(E)):
        x_next = d[i] - (C[i] @ x_next[:, None])[:, 0]
        xs[i] = x_next
    return torch.stack(xs)


class ChainBAResult(NamedTuple):
    edge_pose: torch.Tensor     # [N-1, 6] jointly refined t -> t+1 twists
    depth: torch.Tensor         # [N, H, W, 1] refined per-frame depths
    cost: torch.Tensor          # [iters+1] total cost (finest level)


def _scale_intrinsics(K, s: float):
    """Pixel-unit intrinsics under s-times image scaling (pixel-center
    convention: a pixel center u maps to (u + 0.5) * s - 0.5)."""
    out = torch.zeros_like(K)
    out[..., 0, 0] = K[..., 0, 0] * s
    out[..., 1, 1] = K[..., 1, 1] * s
    out[..., 0, 2] = (K[..., 0, 2] + 0.5) * s - 0.5
    out[..., 1, 2] = (K[..., 1, 2] + 0.5) * s - 0.5
    out[..., 2, 2] = 1.0
    return out


def _downsample(x, factor: int):
    """Antialiased bilinear downsample of [N, H, W, C] by an integer
    factor: ``jax.image.resize(method="linear", antialias=True)``."""
    n, h, w, c = x.shape
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h // factor, w // factor),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).contiguous()


def _scatter_edges(first, last, mid_a, mid_b, n_edges: int):
    """Edge-indexed sum of window terms: ``mid_a`` onto edges [:-1],
    ``mid_b`` onto [1:], then ``first`` onto edge 0 and ``last`` onto the
    last edge, added in that order (the JAX package's ``.at[].add``)."""
    out = first.new_zeros((n_edges,) + first.shape)
    out[:-1] += mid_a
    out[1:] += mid_b
    out[0] += first
    out[-1] += last
    return out


def _chain_level(frames, depths, K, x0, iters, pose_damping, depth_damping,
                 depth_prior_weight, residual_variance_weighting,
                 sampler: Sampler = grid_sample):
    """One pyramid level of ``chain_ba``: the joint LM loop at fixed
    resolution. Returns (edge twists, [N,H,W,1] refined depth, costs)."""
    dev = frames.device
    tgt = frames[1:-1]
    prv, nxt = frames[:-2], frames[2:]
    bnd = torch.tensor([0, frames.shape[0] - 1], device=dev)
    depth0_mid, depth0_bnd = depths[1:-1], depths[bnd]
    w = tgt.shape[0]
    n_edges = w + 1
    K_b = K.expand(w, 3, 3) if K.dim() == 2 else K
    # boundary half-windows: targets (0, N-1), sources (1, N-2)
    tgt_bnd = frames[bnd]
    src_bnd = frames[torch.tensor([1, frames.shape[0] - 2], device=dev)]
    K_bnd = torch.stack([K, K]) if K.dim() == 2 else K[torch.tensor(
        [0, K.shape[0] - 1], device=dev)]
    npix = float(np.prod(tgt.shape[1:]))
    eye6 = torch.eye(6, device=dev)

    def r_a_fn(p, d, s=sampler):
        return _residual(p, d, tgt, prv, K_b, s)

    def r_b_fn(p, d, s=sampler):
        return _residual(p, d, tgt, nxt, K_b, s)

    def r_bnd_fn(p, d, s=sampler):
        return _residual(p, d, tgt_bnd, src_bnd, K_bnd, s)

    def poses_of(x):
        # interior: pa_w = -x_w, pb_w = x_{w+1}; boundary: (x_0, -x_{E-1})
        return -x[:-1], x[1:], torch.stack([x[0], -x[-1]])

    def costs_of(x, d_mid, d_bnd):
        pa, pb, pc = poses_of(x)
        cost_mid = (_sumsq(r_a_fn(pa, d_mid)) + _sumsq(r_b_fn(pb, d_mid))
                    + _prior(d_mid, depth0_mid, depth_prior_weight))
        cost_bnd = (_sumsq(r_bnd_fn(pc, d_bnd))
                    + _prior(d_bnd, depth0_bnd, depth_prior_weight))
        return cost_mid, cost_bnd

    x, d_mid, d_bnd = x0, depth0_mid, depth0_bnd
    lam_mid, lam_bnd = torch.ones(w, device=dev), torch.ones(2, device=dev)
    cost_mid, cost_bnd = costs_of(x0, depth0_mid, depth0_bnd)
    costs = [torch.sum(cost_mid) + torch.sum(cost_bnd)]
    ones_mid = torch.ones(w, device=dev)
    ones_bnd = torch.ones(2, device=dev)
    for _ in range(iters):
        pa, pb, pc = poses_of(x)

        # interior windows: shared-depth 12x12 reduced blocks
        H_aa, g_a, h_a, Hdd_a, gd_a = _gn_blocks(r_a_fn, pa, d_mid, sampler)
        H_bb, g_b, h_b, Hdd_b, gd_b = _gn_blocks(r_b_fn, pb, d_mid, sampler)
        H_dd = Hdd_a + Hdd_b + depth_prior_weight
        g_d = gd_a + gd_b + depth_prior_weight * (
            (d_mid - depth0_mid)[..., 0])
        H_dd = H_dd * (1.0 + lam_mid[:, None, None]) + depth_damping
        inv_Hdd = 1.0 / H_dd
        S_aa, S_ab, S_bb = _reduced(H_aa, H_bb, h_a, h_b, inv_Hdd)
        rhs_a = g_a - _schur_rhs(h_a, inv_Hdd, g_d)
        rhs_b = g_b - _schur_rhs(h_b, inv_Hdd, g_d)

        # boundary half-windows: single-pose 6x6 reduced blocks
        H_cc, g_c, h_c, Hdd_c, gd_c = _gn_blocks(r_bnd_fn, pc, d_bnd,
                                                 sampler)
        Hdd_c = Hdd_c + depth_prior_weight
        gd_c = gd_c + depth_prior_weight * ((d_bnd - depth0_bnd)[..., 0])
        Hdd_c = Hdd_c * (1.0 + lam_bnd[:, None, None]) + depth_damping
        inv_Hdd_c = 1.0 / Hdd_c
        S_cc = H_cc - _schur(h_c, inv_Hdd_c, h_c)
        rhs_c = g_c - _schur_rhs(h_c, inv_Hdd_c, gd_c)

        if residual_variance_weighting:
            w_mid = 1.0 / torch.clamp_min(cost_mid / (2.0 * npix), 1e-12)
            w_bnd = 1.0 / torch.clamp_min(cost_bnd / npix, 1e-12)
            norm = torch.mean(torch.cat([w_mid, w_bnd]))
            w_mid, w_bnd = w_mid / norm, w_bnd / norm
            S_aa = S_aa * w_mid[:, None, None]
            S_ab = S_ab * w_mid[:, None, None]
            S_bb = S_bb * w_mid[:, None, None]
            rhs_a = rhs_a * w_mid[:, None]
            rhs_b = rhs_b * w_mid[:, None]
            S_cc = S_cc * w_bnd[:, None, None]
            rhs_c = rhs_c * w_bnd[:, None]

        # chain rule pa_w = -x_w: gradient wrt x_w flips sign, the
        # (x_w, x_{w+1}) cross block flips once, diagonal blocks don't;
        # boundary: d pc_0/d x_0 = +I, d pc_1/d x_{E-1} = -I
        D = _scatter_edges(S_cc[0], S_cc[1], S_aa, S_bb, n_edges)
        U = -S_ab                                              # [E-1, 6, 6]
        g = _scatter_edges(rhs_c[0], -rhs_c[1], -rhs_a, rhs_b, n_edges)

        # per-window LM damping entered the depth blocks above; damp the
        # assembled pose diagonal with the mean window lambda per edge
        lam_edge = (_scatter_edges(lam_bnd[0], lam_bnd[1], lam_mid, lam_mid,
                                   n_edges)
                    / _scatter_edges(ones_bnd[0], ones_bnd[1], ones_mid,
                                     ones_mid, n_edges))
        damp = (pose_damping * (1.0 + lam_edge))[:, None, None]
        D = D + damp * (D * eye6 + eye6)
        dx = -block_tridiag_solve(D, U, g)                     # [E, 6]

        # depth back-substitution
        dpa, dpb = -dx[:-1], dx[1:]
        dd_mid = -(g_d + torch.einsum("bhwk,bk->bhw", h_a, dpa)
                   + torch.einsum("bhwk,bk->bhw", h_b, dpb)) * inv_Hdd
        dpc = torch.stack([dx[0], -dx[-1]])
        dd_bnd = -(gd_c + torch.einsum("bhwk,bk->bhw", h_c, dpc)) * inv_Hdd_c

        new_x = x + dx
        new_d_mid = torch.clamp_min(d_mid + dd_mid[..., None], 1e-3)
        new_d_bnd = torch.clamp_min(d_bnd + dd_bnd[..., None], 1e-3)

        new_cost_mid, new_cost_bnd = costs_of(new_x, new_d_mid, new_d_bnd)
        total_new = torch.sum(new_cost_mid) + torch.sum(new_cost_bnd)
        total_old = torch.sum(cost_mid) + torch.sum(cost_bnd)
        better = total_new < total_old
        x = torch.where(better, new_x, x)
        d_mid = torch.where(better, new_d_mid, d_mid)
        d_bnd = torch.where(better, new_d_bnd, d_bnd)
        # per-window lambda: relax where the window improved, stiffen
        # where it got worse (even inside an accepted global step)
        lam_mid = torch.where(better & (new_cost_mid < cost_mid),
                              lam_mid * 0.3, lam_mid * 5.0).clamp(1e-4, 1e6)
        lam_bnd = torch.where(better & (new_cost_bnd < cost_bnd),
                              lam_bnd * 0.3, lam_bnd * 5.0).clamp(1e-4, 1e6)
        cost_mid = torch.where(better, new_cost_mid, cost_mid)
        cost_bnd = torch.where(better, new_cost_bnd, cost_bnd)
        costs.append(torch.sum(cost_mid) + torch.sum(cost_bnd))

    full_depth = torch.cat([d_bnd[:1], d_mid, d_bnd[1:]], dim=0)
    return x, full_depth, torch.stack(costs)


def chain_ba(frames, depths, K, pose0_prev, pose0_next, iters: int = 8,
             pose_damping: float = 1e-2, depth_damping: float = 1e-2,
             depth_prior_weight: float = 1.0,
             residual_variance_weighting: bool = True,
             pyramid_levels: int = 1, coarse_iters: int = 6,
             sampler: Sampler = grid_sample, device=None) -> ChainBAResult:
    """Joint sequence BA over the window chain: ONE nonlinear least-squares
    problem over all N-1 edge twists x_e (frame e -> e+1) and all N
    per-frame depths.

    Interior window w (target t = w+1) contributes residuals against its
    prev frame (pose -x_w) and its next frame (pose x_{w+1}) through the
    shared target depth; two boundary half-windows (target 0 vs source 1,
    pose x_0; target N-1 vs source N-2, pose -x_{E-1}) give every edge two
    photometric constraints. Each LM iteration linearizes every window
    (batched), Schur-marginalizes the depth blocks, assembles the
    block-tridiagonal reduced camera system over edges, solves it with the
    block Thomas algorithm, back-substitutes the depths and accepts or
    rejects the global step; the LM lambdas are per window.

    ``pyramid_levels > 1`` prepends coarse-to-fine pre-alignment on
    2x-downsampled pyramids (``coarse_iters`` each, coarsest first),
    carrying only the edge twists between levels.

    Args:
      frames: [N, H, W, 3]; depths: [N, H, W, 1]; K: [3,3] or [N-2, 3, 3].
      pose0_prev/pose0_next: [N-2, 6] initial target->prev / target->next
        twists for windows with targets 1..N-2; edges start from the mean
        of their available measurements.
      residual_variance_weighting: IRLS-style per-window weight
        1/sigma^2 with sigma^2 = current window cost / Nresiduals,
        mean-normalized.
    """
    frames, depths, K, pose0_prev, pose0_next = _f32(
        frames, depths, K, pose0_prev, pose0_next, device=device)
    n_edges = frames.shape[0] - 1
    # edge init: mean of the available measurements per edge
    cnt = frames.new_zeros(n_edges, 1)
    cnt[:-1] += 1.0
    cnt[1:] += 1.0
    x0 = frames.new_zeros(n_edges, 6)
    x0[:-1] += -pose0_prev
    x0[1:] += pose0_next
    x0 = x0 / cnt
    for level in range(pyramid_levels - 1, 0, -1):
        f = 2 ** level
        x0, _, _ = _chain_level(
            _downsample(frames, f), _downsample(depths, f),
            _scale_intrinsics(K, 1.0 / f), x0, coarse_iters,
            pose_damping, depth_damping, depth_prior_weight,
            residual_variance_weighting, sampler)

    x, depth, costs = _chain_level(
        frames, depths, K, x0, iters, pose_damping, depth_damping,
        depth_prior_weight, residual_variance_weighting, sampler)
    return ChainBAResult(edge_pose=x, depth=depth, cost=costs)
