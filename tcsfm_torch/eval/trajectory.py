"""Trajectory integration and error metrics (first-party pyslam replacement).

Implements the evaluation path of validate.py:61-103 without the external
``liegroups``/``pyslam`` dependencies:

  * ``integrate_trajectory``: T_{k+1} = (exp(xi_k) · T_k^{-1})^{-1}
    (validate.py:64-68) — xi is the [rho, phi] frame-to-frame pose vector
    in the network's convention.
  * ``mean_err``: mean translational norm / rotational angle of the
    per-frame alignment error T_gt^{-1} · T_est (pyslam
    ``TrajectoryMetrics.mean_err`` semantics, 'Twv' convention).
  * ``segment_errors``: the standard KITTI odometry protocol — relative
    pose error over all (start frame, segment length) pairs with path
    lengths 100..800 m, normalized per meter (pyslam
    ``TrajectoryMetrics.segment_errors``).

Everything is numpy: trajectories are a few thousand 4x4 matrices, firmly
host-side work; the device-side half of evaluation (network + solver) is
the jitted coupled solver.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------------
# numpy SE(3) (mirrors tcsfm.geom.se3, host-side)
# --------------------------------------------------------------------------


def _skew(v):
    return np.array([
        [0.0, -v[2], v[1]],
        [v[2], 0.0, -v[0]],
        [-v[1], v[0], 0.0],
    ])


def np_se3_exp(xi: np.ndarray) -> np.ndarray:
    """[6] = [rho, phi] → [4, 4]."""
    rho, phi = xi[:3], xi[3:6]
    theta = np.linalg.norm(phi)
    K = _skew(phi)
    if theta < 1e-8:
        R = np.eye(3) + K
        V = np.eye(3) + 0.5 * K
    else:
        A = np.sin(theta) / theta
        B = (1.0 - np.cos(theta)) / theta ** 2
        C = (theta - np.sin(theta)) / theta ** 3
        R = np.eye(3) + A * K + B * (K @ K)
        V = np.eye(3) + B * K + C * (K @ K)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T


def np_se3_inv(T: np.ndarray) -> np.ndarray:
    R = T[:3, :3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ T[:3, 3]
    return out


def np_se3_log(T: np.ndarray) -> np.ndarray:
    """[4, 4] → [6] = [rho, phi] (inverse of np_se3_exp)."""
    R = T[:3, :3]
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(c)
    vee = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if theta < 1e-8:
        phi = 0.5 * vee
        V_inv = np.eye(3) - 0.5 * _skew(phi)
    else:
        phi = theta / (2.0 * np.sin(theta)) * vee
        K = _skew(phi)
        half = 0.5 * theta
        cot = (1.0 - half * np.cos(half) / np.sin(half)) / theta ** 2
        V_inv = np.eye(3) - 0.5 * K + cot * (K @ K)
    return np.concatenate([V_inv @ T[:3, 3], phi])


def np_normalize_rotation(T: np.ndarray) -> np.ndarray:
    """SVD-orthogonalize the rotation block (liegroups normalize=True)."""
    U, _, Vt = np.linalg.svd(T[:3, :3])
    D = np.diag([1.0, 1.0, np.linalg.det(U @ Vt)])
    out = T.copy()
    out[:3, :3] = U @ D @ Vt
    return out


def rotation_angle(R: np.ndarray) -> float:
    """Angle (rad) of a rotation matrix."""
    c = (np.trace(R) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


# --------------------------------------------------------------------------
# integration + metrics
# --------------------------------------------------------------------------


def integrate_trajectory(
    pose_vecs: np.ndarray, T0: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Frame-to-frame pose vectors → global trajectory (validate.py:61-68).

    Args:
      pose_vecs: [N, 6] network pose predictions (already metric-scaled).
      T0: [4, 4] initial pose (gt_traj[0]).

    Returns:
      (est_traj [N+1, 4, 4], cum_dist [N+1]) — cumulative distance uses
      the per-step translation norm of exp(xi), as in the reference.
    """
    est = [np.asarray(T0, dtype=np.float64)]
    cum = [0.0]
    for i in range(pose_vecs.shape[0]):
        dT = np_se3_exp(np.asarray(pose_vecs[i], dtype=np.float64))
        prev_inv = np_se3_inv(np_normalize_rotation(est[i]))
        est.append(np_se3_inv(dT @ prev_inv))
        cum.append(cum[i] + np.linalg.norm(dT[:3, 3]))
    return np.asarray(est), np.asarray(cum)


def mean_err(gt_traj: np.ndarray, est_traj: np.ndarray) -> Tuple[float, float]:
    """Mean absolute trajectory error: (trans [m], rot [rad])."""
    t_errs, r_errs = [], []
    for Tg, Te in zip(gt_traj, est_traj):
        err = np_se3_inv(np_normalize_rotation(np.asarray(Tg, np.float64))) @ \
            np_normalize_rotation(np.asarray(Te, np.float64))
        t_errs.append(np.linalg.norm(err[:3, 3]))
        r_errs.append(rotation_angle(err[:3, :3]))
    return float(np.mean(t_errs)), float(np.mean(r_errs))


def _cum_dists_from_traj(traj: np.ndarray) -> np.ndarray:
    steps = np.linalg.norm(np.diff(traj[:, :3, 3], axis=0), axis=-1)
    return np.concatenate([[0.0], np.cumsum(steps)])


def segment_errors(
    gt_traj: np.ndarray,
    est_traj: np.ndarray,
    seg_lengths: Sequence[float],
) -> np.ndarray:
    """KITTI segment errors over every (start, length) pair.

    Returns [M, 3] rows (length, trans_err_frac, rot_err_rad_per_m); empty
    rows → shape (0, 3). Matches pyslam's segment_errors consumed at
    validate.py:82-94 (trans % = 100*mean(col 1), rot deg/100m =
    100*mean(col 2)*180/pi).
    """
    gt = np.asarray(gt_traj, np.float64)
    est = np.asarray(est_traj, np.float64)
    cum = _cum_dists_from_traj(gt)
    rows: List[List[float]] = []
    for L in seg_lengths:
        # first frame index at distance >= cum[start] + L, per start
        ends = np.searchsorted(cum, cum + L, side="left")
        for start in range(len(gt)):
            end = ends[start]
            if end >= len(gt):
                continue
            d_gt = np_se3_inv(np_normalize_rotation(gt[start])) @ \
                np_normalize_rotation(gt[end])
            d_est = np_se3_inv(np_normalize_rotation(est[start])) @ \
                np_normalize_rotation(est[end])
            err = np_se3_inv(d_est) @ d_gt
            rows.append([
                float(L),
                np.linalg.norm(err[:3, 3]) / L,
                rotation_angle(err[:3, :3]) / L,
            ])
    return np.asarray(rows).reshape(-1, 3)


def avg_segment_errors(errs: np.ndarray) -> np.ndarray:
    """Per-length averages of :func:`segment_errors` rows.

    [M, 3] (length, trans frac, rot rad/m) → [K, 3] with one row per
    distinct length — pyslam ``segment_errors``'s second (``avg_segerr``)
    return, consumed by the leaderboard-style plot
    (visualizers.py:139-146)."""
    errs = np.asarray(errs, np.float64).reshape(-1, 3)
    if errs.shape[0] == 0:
        return np.zeros((0, 3))
    lengths = np.unique(errs[:, 0])
    return np.asarray([
        [L, float(np.mean(errs[errs[:, 0] == L, 1])),
         float(np.mean(errs[errs[:, 0] == L, 2]))]
        for L in lengths
    ])


def error_norms(gt_traj: np.ndarray,
                est_traj: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame alignment error norms (pyslam ``error_norms``):
    (trans_err [N] m, rot_err [N] rad) of T_gt^{-1} · T_est."""
    t_errs, r_errs = [], []
    for Tg, Te in zip(gt_traj, est_traj):
        err = np_se3_inv(np_normalize_rotation(np.asarray(Tg, np.float64))) @ \
            np_normalize_rotation(np.asarray(Te, np.float64))
        t_errs.append(np.linalg.norm(err[:3, 3]))
        r_errs.append(rotation_angle(err[:3, :3]))
    return np.asarray(t_errs), np.asarray(r_errs)


class TrajectoryMetrics:
    """Drop-in analogue of pyslam.metrics.TrajectoryMetrics ('Twv')."""

    def __init__(self, gt_traj: np.ndarray, est_traj: np.ndarray):
        self.gt = np.asarray(gt_traj, np.float64)
        self.est = np.asarray(est_traj, np.float64)

    def mean_err(self) -> Tuple[float, float]:
        return mean_err(self.gt, self.est)

    def segment_errors(self, seg_lengths: Sequence[float]):
        errs = segment_errors(self.gt, self.est, seg_lengths)
        return errs, avg_segment_errors(errs)

    def error_norms(self) -> Tuple[np.ndarray, np.ndarray]:
        return error_norms(self.gt, self.est)

    def cum_err(self) -> Tuple[np.ndarray, np.ndarray]:
        """Cumulative error norms over the trajectory (pyslam ``cum_err``,
        visualizers.py plot_cum_norm_err)."""
        t, r = error_norms(self.gt, self.est)
        return np.cumsum(t), np.cumsum(r)


def compute_trajectory(
    pose_vec: np.ndarray,
    gt_traj: np.ndarray,
    method: str = "odom",
    compute_seg_err: bool = False,
    verbose: bool = True,
):
    """Full evaluation driver mirroring validate.py:61-103.

    Returns (est_traj, gt_traj, (t_ate, r_ate_deg, t_seg_%, r_seg_deg/100m),
    cum_dist).
    """
    gt_traj = np.asarray(gt_traj, np.float64)
    est_traj, cum_dist = integrate_trajectory(pose_vec, gt_traj[0])

    t_ate, r_ate = mean_err(gt_traj, est_traj)
    t_ate = round(t_ate, 3)
    r_ate = round(r_ate * 180.0 / np.pi, 3)
    if verbose:
        print(f"{method} mean trans. error: {t_ate} | mean rot. error: {r_ate}")

    if compute_seg_err:
        seg_lengths = list(range(100, 801, 100))
        errs = segment_errors(gt_traj, est_traj, seg_lengths)
        if errs.shape[0] == 0:
            # NaN fallback (validate.py:87-94): trajectory shorter than
            # 100 m segments — shrink the length range to what exists.
            max_dist = cum_dist[-1] - cum_dist[-1] % 100 + 1 - 100
            seg_lengths = list(range(100, max(int(max_dist), 101), 100))
            errs = segment_errors(gt_traj, est_traj, seg_lengths)
        if errs.shape[0]:
            t_seg = round(float(np.mean(errs[:, 1])) * 100.0, 3)
            r_seg = round(float(np.mean(errs[:, 2])) * 100.0 * 180.0 / np.pi, 3)
        else:
            t_seg, r_seg = float("nan"), float("nan")
        if verbose:
            print(f"{method} mean Segment Errors: {t_seg} (trans, %) | "
                  f"{r_seg} (rot, deg/100m)")
        errors = (t_ate, r_ate, t_seg, r_seg)
    else:
        errors = (t_ate, r_ate, 0, 0)
    return est_traj, gt_traj, errors, cum_dist


class ResultsLogger:
    """Metric accumulator + CSV writer (validate.py:137-165).

    The reference declares a CSV ``filename`` but its writes are commented
    out; here a non-empty filename actually produces the CSV, with the
    reference's two header rows (validate.py:140-141)."""

    def __init__(self, filename: str = ""):
        self.filename = filename
        self.t_ate_list: list = []
        self.r_ate_list: list = []
        self.t_mse_list: list = []
        self.r_mse_list: list = []
        self.results: dict = {}
        if self.filename:
            import csv

            with open(self.filename, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["", "", "m-ATE", "", "Mean Segment Errors", ""])
                w.writerow(["Sequence (Length)", "Name", "Trans. (m)",
                            "Rot. (deg)", "Trans. (%)", "Rot. (deg/100m)"])

    def log(self, seq, name, t_ate, r_ate, t_mse, r_mse):
        if self.filename:
            import csv

            with open(self.filename, "a", newline="") as f:
                csv.writer(f).writerow([seq, name, t_ate, r_ate, t_mse, r_mse])
        self.t_ate_list.append(t_ate)
        self.r_ate_list.append(r_ate)
        self.t_mse_list.append(t_mse)
        self.r_mse_list.append(r_mse)
        self.results = {
            "t_ate_list": self.t_ate_list,
            "r_ate_list": self.r_ate_list,
            "t_mse_list": self.t_mse_list,
            "r_mse_list": self.r_mse_list,
        }
