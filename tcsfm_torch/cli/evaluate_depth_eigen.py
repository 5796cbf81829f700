"""Eigen depth evaluation CLI (counterpart of
``tcsfm/cli/evaluate_depth_eigen.py``, same flags and printed JSON).

Monodepth2 protocol: per-image disparity with flip post-processing, resize
to GT, depth = 30/disp, Eigen crop, median scaling, clamp, 7 metrics
(``eval/depth_metrics.evaluate_eigen``). ``--pred_disps`` evaluates saved
disparities (the reference's load_pred_disps path, :122-126) without the
network; ``--save_pred_disps`` saves them.

Flip-merge post-processing is the default: a batch of ``--batch`` test
images and its width-mirror go through one forward of the depth net
(``2 x batch`` images; ``torch.flip`` on the width axis, axis 2 of the NHWC
input), then ``utils/helpers.post_process_disparity``;
``--no_post_process`` runs the plain single pass. JAX jits that forward;
the port runs it eagerly. ``--model_dir`` reads a checkpoint either
package wrote; without it the depth net is the port's seeded init.

Usage: python -m tcsfm_torch.cli.evaluate_depth_eigen --model_dir DIR
       --data_dir D --gt_depths gt_depths.npz [--batch 4]
       [--no_post_process] [--no_median_scaling] [--pred_disps F.npy]
       [--save_pred_disps F.npy] [--benchmark eigen] [--device cpu]

The depth net runs on the card unless ``--device cpu``; with no card it
raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", type=str, default="")
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--gt_depths", type=str, default="",
                   help="npz from preprocess eigen_gt_depth")
    p.add_argument("--pred_disps", type=str, default="",
                   help="evaluate saved .npy disparities instead of running")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--no_post_process", action="store_true")
    p.add_argument("--no_median_scaling", action="store_true")
    p.add_argument("--save_pred_disps", type=str, default="")
    p.add_argument("--benchmark", type=str, default="eigen")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the card")
    return p.parse_args(argv)


@torch.no_grad()
def scaled_disparity(depth_net, imgs: torch.Tensor, cfg,
                     post_process: bool = True) -> torch.Tensor:
    """The scaled disparity [N, H, W] of images [N, H, W, 3]: flip-merged
    (reference :95-106) unless ``post_process`` is False."""
    from tcsfm_torch.utils.helpers import disp_to_depth, post_process_disparity

    if not post_process:
        disp = depth_net(imgs)[0][..., 0]
        return disp_to_depth(disp, cfg.min_depth, cfg.max_depth)[0]
    n = imgs.shape[0]
    disp = depth_net(torch.cat([imgs, imgs.flip(2)]))[0][..., 0]
    scaled, _ = disp_to_depth(disp, cfg.min_depth, cfg.max_depth)
    return post_process_disparity(scaled[:n], scaled[n:].flip(2))


def predict(args: argparse.Namespace, depth_net, device) -> np.ndarray:
    """The scaled disparities [N, H, W] of the Eigen test split under
    ``args.data_dir``, ``args.batch`` test images a forward (the loader's
    thread reads batch k+1 while the card computes batch k)."""
    from tcsfm_torch.cli.common import load_config
    from tcsfm_torch.config import Config
    from tcsfm_torch.data.eigen import EigenDataset
    from tcsfm_torch.data.loader import BatchLoader
    from tcsfm_torch.utils.helpers import to_device, to_numpy

    cfg = load_config(args.model_dir, Config())
    ds = EigenDataset(args.data_dir, mode="test")
    loader = BatchLoader(ds, args.batch, shuffle=False, drop_last=False,
                         prefetch=2)
    depth_net.eval()
    out = []
    for batch in loader:
        imgs = to_device(batch, ("target_img",), device)["target_img"]
        out.append(scaled_disparity(depth_net, imgs, cfg,
                                    not args.no_post_process))
    return to_numpy(torch.cat(out))


def run(args: argparse.Namespace, depth_net=None, device=None) -> dict:
    """The evaluation with ``depth_net`` (on ``device``), or of
    ``args.pred_disps``: prints and returns the metrics."""
    from tcsfm_torch.eval.depth_metrics import evaluate_eigen

    if args.pred_disps:
        pred_disps = np.load(args.pred_disps)
    else:
        pred_disps = predict(args, depth_net, device)
        if args.save_pred_disps:
            np.save(args.save_pred_disps, pred_disps)

    gt = np.load(args.gt_depths, allow_pickle=True)["data"]
    metrics = evaluate_eigen(
        list(pred_disps), list(gt),
        median_scaling=not args.no_median_scaling,
        benchmark=args.benchmark,
    )
    print(json.dumps({k: round(float(v), 4) for k, v in metrics.items()}))
    return metrics


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.pred_disps:
        return run(args)
    from tcsfm_torch.cli.common import load_nets
    from tcsfm_torch.utils.helpers import resolve_device

    device = resolve_device(args.device)
    depth_net, _ = load_nets(args.model_dir, device)
    return run(args, depth_net, device)


if __name__ == "__main__":
    main()
