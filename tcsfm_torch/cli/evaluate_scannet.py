"""ScanNet depth + pose evaluation CLI (counterpart of
``tcsfm/cli/evaluate_scannet.py``, same flags and printed JSON).

DeepV2D protocol, reference-exact (evaluate_error_scannet.py:25-190):
  * pair inference on (target, source0) with 8 coupled iterations (:30),
  * flip post-processing: the [imgs; flip(imgs)] stack of target and
    source runs the depth net once (4B images), the disparities
    flip-merge (:78-86) BEFORE the pose solve, and the merged disparities
    feed the coupled iterations as depths = 1/disp,
  * pose metric on the fused pose exp((30·fwd − 30·inv)/2) only (:108,156),
  * depth metric on the target disparity resized to GT, depth = 30/disp,
    median-ratio scaled (:159-166).

The solver runs at S=1 (``source0_img[None]``) through ``solver/coupled.py``;
its warps go through ``ops.grid_sample`` (the sampler's value kernel on the
card: ``iterations - 1`` launches a batch). JAX pads the last batch to keep
one compiled program; the port runs a short last batch as it is, and
collects the batch's real windows only. JAX's sampler switches in the
config (``use_mxu_warp``, ``mxu_exact``, the bands) pick among its TPU
sampler's modes; the port has one sampler, exact in f32.

Usage: python -m tcsfm_torch.cli.evaluate_scannet --model_dir DIR
       --data_dir D --scenes S1 [S2 ...] [--iterations 8] [--frame_gap 8]
       [--batch 4] [--no_post_process] [--device cpu]

Runs on the card unless ``--device cpu``; with no card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from tcsfm_torch.ops.grid_sample import grid_sample


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", type=str, default="")
    p.add_argument("--data_dir", type=str, default="",
                   help="directory of preprocessed scene npz files")
    p.add_argument("--scenes", nargs="+", required=False, default=[])
    p.add_argument("--iterations", type=int, default=8)   # :30 in the reference
    p.add_argument("--frame_gap", type=int, default=8)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--no_post_process", action="store_true",
                   help="skip the flip-merge depth post-processing "
                        "(post_process=True is the reference default, :27)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the card")
    return p.parse_args(argv)


@torch.no_grad()
def infer(cfg, depth_net, pose_net, target_img: torch.Tensor,
          source0_img: torch.Tensor, K: torch.Tensor,
          post_process: bool = True, sampler=grid_sample):
    """Pair inference with the reference's flip-merge protocol.

    Returns (target scaled disparity [B, H, W], fwd pose [B, 6], inv pose
    [B, 6]).
    """
    from tcsfm_torch.solver.coupled import solve_pose_iteratively
    from tcsfm_torch.utils.helpers import disp_to_depth, post_process_disparity

    b = target_img.shape[0]
    imgs = torch.cat([target_img, source0_img])                  # [2B,...]
    if post_process:
        # each image gets two forward passes: as-is and flipped (:78-80)
        imgs = torch.cat([imgs, imgs.flip(2)])                   # [4B,...]
    disp = depth_net(imgs)[0][..., 0]
    scaled, _ = disp_to_depth(disp, cfg.min_depth, cfg.max_depth)
    if post_process:
        n = 2 * b
        scaled = post_process_disparity(scaled[:n], scaled[n:].flip(2))
    # depths = 1/scaled_disp == disp_to_depth's depth (:93)
    depths = (1.0 / scaled)[..., None]
    depths = torch.stack([depths[:b], depths[b:2 * b]])          # [2,B,H,W,1]
    poses, poses_inv, _ = solve_pose_iteratively(
        cfg.iterations, depths, pose_net, target_img, source0_img[None], K,
        sampler=sampler)
    return scaled[:b], poses[0], poses_inv[0]


def predict(args: argparse.Namespace, depth_net, pose_net, device,
            sampler=grid_sample):
    """Every window's predictions with ``depth_net``/``pose_net`` (on
    ``device``) and the warps' ``sampler``: (GT depths, target scaled
    disparities, fused pose matrices, GT pose matrices), each a list with
    an entry a window where the scene has that GT."""
    from tcsfm_torch.cli.common import load_config
    from tcsfm_torch.config import Config
    from tcsfm_torch.data.dataset import SequenceData
    from tcsfm_torch.data.loader import BatchLoader
    from tcsfm_torch.data.scannet import ScanNetTestDataset
    from tcsfm_torch.eval.trajectory import np_se3_exp
    from tcsfm_torch.utils.helpers import to_device, to_numpy

    cfg = dataclasses.replace(load_config(args.model_dir, Config()),
                              iterations=args.iterations)
    depth_net.eval()
    pose_net.eval()
    seqs = [SequenceData.from_npz(os.path.join(args.data_dir, f"{s}.npz"))
            for s in args.scenes]
    ds = ScanNetTestDataset(seqs, frame_gap=args.frame_gap)
    loader = BatchLoader(ds, args.batch, shuffle=False, drop_last=False,
                         prefetch=2)

    gt_depths, pred_disps, pred_mats, gt_mats = [], [], [], []
    for batch in loader:
        x = to_device(batch, ("target_img", "source_imgs", "intrinsics"),
                      device)
        disp_t, fwd, inv = infer(cfg, depth_net, pose_net, x["target_img"],
                                 x["source_imgs"][0], x["intrinsics"],
                                 post_process=not args.no_post_process,
                                 sampler=sampler)
        disp_t = to_numpy(disp_t)
        fwd = fwd.cpu().numpy().astype(np.float64)
        inv = inv.cpu().numpy().astype(np.float64)
        # metric scale: ×30 on translations before fusing (:101-103,108)
        fwd[:, 0:3] *= 30.0
        inv[:, 0:3] *= 30.0
        comb = (fwd - inv) / 2.0
        for i in range(len(batch["_valid"])):
            # depth and pose pairs are collected INDEPENDENTLY: a scene
            # with pose GT but no depth GT (or vice versa) keeps its
            # metrics, and mixed availability across batches can't
            # misalign the (gt, pred) pairing
            if "gt_depth" in batch:
                pred_disps.append(disp_t[i])
                gt_depths.append(batch["gt_depth"][i])
            if "gt_pose_mats" in batch:
                pred_mats.append(np_se3_exp(comb[i]))
                gt_mats.append(batch["gt_pose_mats"][i, 0])
    return gt_depths, pred_disps, pred_mats, gt_mats


def metrics(gt_depths, pred_disps, pred_mats, gt_mats) -> dict:
    """The DeepV2D depth and pose metrics, averaged over the windows."""
    from tcsfm_torch.eval.depth_metrics import (
        _resize_bilinear, compute_depth_errors_scannet,
        compute_pose_errors_deepv2d, compute_scaling_factor)

    depth_results, pose_results = [], []
    for gt_d, disp in zip(gt_depths, pred_disps):
        gt_h, gt_w = gt_d.shape[:2]
        disp_r = _resize_bilinear(np.asarray(disp, np.float32), gt_h, gt_w)
        pred_depth = 30.0 / disp_r                                 # (:161)
        scale = compute_scaling_factor(gt_d, pred_depth)
        depth_results.append(
            compute_depth_errors_scannet(gt_d, scale * pred_depth))
    for gt_m, pred_m in zip(gt_mats, pred_mats):
        pose_results.append(compute_pose_errors_deepv2d(gt_m, pred_m))

    out = {}
    if depth_results:
        out["depth"] = {k: float(np.mean([m[k] for m in depth_results]))
                        for k in depth_results[0]}
    if pose_results:
        out["pose"] = {k: float(np.mean([m[k] for m in pose_results]))
                       for k in pose_results[0]}
    return out


def run(args: argparse.Namespace, depth_net, pose_net, device,
        sampler=grid_sample) -> dict:
    """The evaluation with ``depth_net``/``pose_net`` (on ``device``) and
    the warps' ``sampler``: prints and returns the metrics."""
    out = metrics(*predict(args, depth_net, pose_net, device, sampler))
    print(json.dumps(out, indent=2, default=float))
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    from tcsfm_torch.cli.common import load_nets
    from tcsfm_torch.utils.helpers import resolve_device

    device = resolve_device(args.device)
    depth_net, pose_net = load_nets(args.model_dir, device)
    return run(args, depth_net, pose_net, device)


if __name__ == "__main__":
    main()
