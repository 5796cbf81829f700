"""Depth evaluation protocols: KITTI Eigen (Monodepth2) and ScanNet (DeepV2D)
(a copy of ``tcsfm/eval/depth_metrics.py`` with one resize).

Re-implements the reference protocols host-side in numpy:
  * Eigen: paper_plots_and_data/evaluate_depth_eigen.py:24-42,133-167 —
    resize to GT, depth = 30/disp, Eigen crop, median scaling, clamp
    [1e-3, 80], 7 metrics.
  * ScanNet: paper_plots_and_data/scannet_eval_utils.py — median scale
    matching, scale-invariant log RMSE, and DeepV2D pose errors
    (rotation angle, translation angle, scale-fitted translation cm).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

EIGEN_MIN_DEPTH = 1e-3
EIGEN_MAX_DEPTH = 80.0
METRIC_SCALE = 30.0  # network depth is at 1/30 metric scale (SURVEY.md §0.6)


def compute_depth_errors(gt: np.ndarray, pred: np.ndarray) -> Tuple[float, ...]:
    """(abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3) on flat valid arrays
    (evaluate_depth_eigen.py:24-42)."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = float((thresh < 1.25).mean())
    a2 = float((thresh < 1.25 ** 2).mean())
    a3 = float((thresh < 1.25 ** 3).mean())
    rmse = float(np.sqrt(((gt - pred) ** 2).mean()))
    rmse_log = float(np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean()))
    abs_rel = float(np.mean(np.abs(gt - pred) / gt))
    sq_rel = float(np.mean((gt - pred) ** 2 / gt))
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def eigen_crop_mask(gt_depth: np.ndarray) -> np.ndarray:
    """Garg/Eigen evaluation crop (evaluate_depth_eigen.py:144-151)."""
    h, w = gt_depth.shape[:2]
    mask = np.logical_and(gt_depth > EIGEN_MIN_DEPTH, gt_depth < EIGEN_MAX_DEPTH)
    crop = np.array(
        [0.40810811 * h, 0.99189189 * h, 0.03594771 * w, 0.96405229 * w]
    ).astype(np.int32)
    crop_mask = np.zeros_like(mask)
    crop_mask[crop[0]:crop[1], crop[2]:crop[3]] = 1
    return np.logical_and(mask, crop_mask)


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize (align_corners=False, cv2 INTER_LINEAR's grid) in
    numpy only.

    The JAX package calls ``cv2.resize`` where cv2 imports and this numpy
    path otherwise; cv2 is not installed where the port runs, so the port
    keeps the numpy path alone and resizes alike on every machine. The
    JAX package measured it against cv2.resize INTER_LINEAR on the Eigen
    protocol shapes (192x640→375x1242 up, 375x1242→192x640 down): max abs
    delta 1.3e-7 on float32 inputs in [0, 1], float32 rounding only
    (``tests/test_eval.py::TestResizeParity``).
    """
    ih, iw = img.shape[:2]
    # align_corners=False convention (matches cv2 INTER_LINEAR)
    ys = (np.arange(h) + 0.5) * ih / h - 0.5
    xs = (np.arange(w) + 0.5) * iw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, ih - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, iw - 1)
    y1 = np.clip(y0 + 1, 0, ih - 1)
    x1 = np.clip(x0 + 1, 0, iw - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    return (
        img[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
        + img[np.ix_(y0, x1)] * (1 - wy) * wx
        + img[np.ix_(y1, x0)] * wy * (1 - wx)
        + img[np.ix_(y1, x1)] * wy * wx
    )


def evaluate_eigen(
    pred_disps: Sequence[np.ndarray],
    gt_depths: Sequence[np.ndarray],
    median_scaling: bool = True,
    benchmark: str = "eigen",
) -> Dict[str, float]:
    """Full Eigen pipeline (evaluate_depth_eigen.py:131-177).

    pred_disps: per-image *scaled* disparities (output of disp_to_depth[0]).
    Returns the 7 mean metrics plus the median scaling ratio.
    """
    errors, ratios = [], []
    for pred_disp, gt_depth in zip(pred_disps, gt_depths):
        gt_h, gt_w = gt_depth.shape[:2]
        disp = _resize_bilinear(np.asarray(pred_disp, np.float32), gt_h, gt_w)
        pred_depth = METRIC_SCALE / disp

        if benchmark == "eigen":
            mask = eigen_crop_mask(gt_depth)
        else:
            mask = gt_depth > 0
        pred_m = pred_depth[mask]
        gt_m = gt_depth[mask]

        if median_scaling:
            sel = gt_m < 80
            ratio = np.median(gt_m[sel]) / np.median(pred_m[sel])
            ratios.append(ratio)
            pred_m = pred_m * ratio

        pred_m = np.clip(pred_m, EIGEN_MIN_DEPTH, EIGEN_MAX_DEPTH)
        errors.append(compute_depth_errors(gt_m, pred_m))

    mean = np.asarray(errors).mean(0)
    out = dict(zip(
        ["abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3"], mean
    ))
    if ratios:
        r = np.asarray(ratios)
        out["med_ratio"] = float(np.median(r))
        out["ratio_std"] = float(np.std(r / np.median(r)))
    return out


# --------------------------------------------------------------------------
# ScanNet / DeepV2D protocol (scannet_eval_utils.py)
# --------------------------------------------------------------------------


def scale_invariant(gt: np.ndarray, pr: np.ndarray) -> float:
    """Scale-invariant log RMSE (scannet_eval_utils.py:23-44)."""
    gt = gt.reshape(-1)
    pr = pr.reshape(-1)
    v = gt > 0.1
    gt, pr = gt[v], pr[v]
    log_diff = np.log(gt) - np.log(pr)
    n = np.float32(log_diff.size)
    return float(np.sqrt(np.sum(log_diff ** 2) / n - np.sum(log_diff) ** 2 / n ** 2))


def compute_scaling_factor(gt, pr, min_depth=0.5, max_depth=8.0) -> float:
    """Median GT/pred depth ratio on valid pixels (scannet_eval_utils.py:14-20)."""
    gt = np.asarray(gt, np.float64).reshape(-1)
    pr = np.asarray(pr, np.float64).reshape(-1)
    v = (gt > min_depth) & (gt < max_depth)
    return float(np.median(gt[v] / pr[v]))


def compute_pose_errors_deepv2d(gt: np.ndarray, pr: np.ndarray) -> Dict[str, float]:
    """DeepV2D pose errors on 4x4 matrices (scannet_eval_utils.py:46-69)."""
    R1, t1 = gt[:3, :3], gt[:3, 3]
    R2, t2 = pr[:3, :3], pr[:3, 3]
    costheta = (np.trace(R1.T @ R2) - 1.0) / 2.0
    rdeg = float(np.arccos(min(costheta, 1.0)) * 180.0 / np.pi)
    t1mag, t2mag = np.sqrt(t1 @ t1), np.sqrt(t2 @ t2)
    tdeg = float(np.arccos(np.clip(t1 @ t2 / (t1mag * t2mag), -1.0, 1.0))
                 * 180.0 / np.pi)
    a = t1 @ t2 / (t2 @ t2)
    tcm = float(100.0 * np.sqrt(np.sum((t1 - a * t2) ** 2)))
    return {"rot ang": rdeg, "trans ang": tdeg, "trans cm": tcm}


def compute_depth_errors_scannet(
    gt, pr, min_depth: float = 0.1, max_depth: float = 10.0
) -> Dict[str, float]:
    """DeepV2D depth metric dict (scannet_eval_utils.py:72-122)."""
    if isinstance(gt, list):
        scinv = float(np.mean([scale_invariant(g, p) for g, p in zip(gt, pr)]))
        gt = np.stack(gt).astype(np.float32).reshape(-1)
        pr = np.stack(pr).astype(np.float32).reshape(-1)
    else:
        scinv = scale_invariant(gt, pr)
        gt = gt.reshape(-1)
        pr = pr.reshape(-1)
    v = (gt > min_depth) & (gt < max_depth)
    gt, pr = gt[v], pr[v]
    rmse = float(np.sqrt(((gt - pr) ** 2).mean()))
    rmse_log = float(np.sqrt(((np.log(gt) - np.log(pr)) ** 2).mean()))
    return {
        "abs_rel": float(np.mean(np.abs(gt - pr) / gt)),
        "sq_rel1": float(np.mean((gt - pr) ** 2 / gt)),
        "rmse": rmse,
        "log_rmse": rmse_log,
        "sc-inv": scinv,
    }
