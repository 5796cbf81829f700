"""VO evaluation CLI (counterpart of ``tcsfm/cli/evaluate_vo.py``, same
flags and printed JSON).

Runs whole-sequence pair-wise coupled inference on KITTI odometry test
sequences (or any ``--data_dir`` holding ``<seq>/sequence_data.npz`` or the
reference's pickle layout), with the DNet and GT scaling variants, and
reports m-ATE and segment errors. ``--synthetic`` evaluates on a generated
24-frame 64x96 sequence. ``--model_dir`` reads a checkpoint that either
package wrote (``train/checkpoint.py``); without it the networks are the
port's seeded init.

Usage: python -m tcsfm_torch.cli.evaluate_vo --model_dir DIR --data_dir D
       [--seqs 09_02 10_02] [--iterations N] [--batch 8] [--no_dnet]
       [--synthetic] [--out F] [--plot_dir D] [--save_preds D]
       [--load_preds D] [--device cpu]

Runs on the card unless ``--device cpu``; with no card it raises. The JAX
CLI's sampler flags (``--use_mxu_warp``, ``--no_mxu_warp``,
``--fast_sampler``, ``--no_uint8``, ``--mixed_sampler``) pick among its
TPU sampler's precision modes, workarounds an f32 gather on the card does
not need: the port has one sampler, exact in f32.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from tcsfm_torch.ops.grid_sample import grid_sample


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", type=str, default="",
                   help="checkpoint dir (config.json + checkpoint.msgpack)")
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--seqs", nargs="+", default=["09_02", "10_02"])
    p.add_argument("--iterations", type=int, default=0,
                   help="override test-time iterations (0 = training value)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--no_dnet", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out", type=str, default="")
    p.add_argument("--plot_dir", type=str, default="",
                   help="directory for per-seq trajectory plots (top-down, "
                        "segment errors, cumulative error norms) plus a "
                        "results.csv across sequences; needs matplotlib")
    p.add_argument("--save_preds", type=str, default="",
                   help="directory to save per-seq pose predictions (npz) "
                        "for later replay")
    p.add_argument("--load_preds", type=str, default="",
                   help="directory of saved predictions: replay metrics "
                        "without rerunning the networks")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the card")
    return p.parse_args(argv)


def config_of(args: argparse.Namespace):
    """The run's configuration: the model directory's, or JAX's synthetic
    default (2 iterations), with ``--iterations`` applied."""
    from tcsfm_torch.cli.common import load_config
    from tcsfm_torch.config import Config

    cfg = load_config(args.model_dir,
                      Config(iterations=2, compute_dtype="float32"))
    if args.iterations:
        cfg = dataclasses.replace(cfg, iterations=args.iterations)
    return cfg


def _write_plots(plot_dir: str, seq_name: str, res: dict) -> None:
    """Per-sequence plots: top-down, averaged segment errors, cumulative
    error norms."""
    from tcsfm_torch import vis
    from tcsfm_torch.eval.trajectory import TrajectoryMetrics

    gt = res["gt_traj"]
    named = {label: TrajectoryMetrics(gt, est)
             for label, est in res["est_trajs"].items()}
    trajs = [gt] + list(res["est_trajs"].values())
    labels = ["ground truth"] + list(res["est_trajs"].keys())
    vis.plot_trajectories(
        trajs, labels, title=seq_name,
        save_file=os.path.join(plot_dir, f"{seq_name}_topdown.png"))
    vis.plot_segment_errors(
        named, title=seq_name,
        save_file=os.path.join(plot_dir, f"{seq_name}_seg_err.png"))
    vis.plot_cum_norm_err(
        named, title=seq_name,
        save_file=os.path.join(plot_dir, f"{seq_name}_cum_err.png"))


def run(args: argparse.Namespace, depth_net, pose_net, device,
        sampler=grid_sample) -> dict:
    """The evaluation with ``depth_net``/``pose_net`` (on ``device``) and
    the warps' ``sampler``: prints and returns the errors by sequence."""
    from tcsfm_torch.data.dataset import sequence_sources
    from tcsfm_torch.data.synthetic import make_synthetic_sequence
    from tcsfm_torch.eval.trajectory import ResultsLogger
    from tcsfm_torch.eval.vo import (VOEvaluator, evaluate_saved_predictions,
                                     save_predictions)

    cfg = config_of(args)
    if args.synthetic:
        sources = {"synthetic":
                   lambda: make_synthetic_sequence(24, (64, 96), seed=11)}
    else:
        # lazy loaders: one sequence's frames in memory at a time
        sources = sequence_sources(args.data_dir, args.seqs)

    ev = VOEvaluator(cfg, depth_net, pose_net,
                     dnet_rescaling=not args.no_dnet, device=device,
                     sampler=sampler)
    logger = None
    if args.plot_dir:
        os.makedirs(args.plot_dir, exist_ok=True)
        logger = ResultsLogger(os.path.join(args.plot_dir, "results.csv"))

    all_results = {}
    for seq_name, load_seq in sources.items():
        seq = load_seq()
        if args.load_preds:
            res = evaluate_saved_predictions(
                os.path.join(args.load_preds, f"{seq_name}_preds.npz"),
                seq, dnet=not args.no_dnet, logger=logger)
        else:
            res = ev.run_sequence(seq, batch_size=args.batch, logger=logger)
            if args.save_preds:
                os.makedirs(args.save_preds, exist_ok=True)
                save_predictions(
                    os.path.join(args.save_preds, f"{seq_name}_preds.npz"),
                    res)
        if args.plot_dir:
            _write_plots(args.plot_dir, seq_name, res)
        all_results[seq_name] = {
            k: v for k, v in res.items()
            if k.startswith("errors") or k == "gt_scale"
        }

    print(json.dumps(all_results, default=str, indent=2))
    if args.out:
        import numpy as np

        np.savez(args.out, **{k: json.dumps(v, default=str)
                              for k, v in all_results.items()})
    return all_results


def main(argv=None) -> dict:
    args = parse_args(argv)
    from tcsfm_torch.cli.common import load_nets
    from tcsfm_torch.utils.helpers import resolve_device

    device = resolve_device(args.device)
    depth_net, pose_net = load_nets(args.model_dir, device)
    return run(args, depth_net, pose_net, device)


if __name__ == "__main__":
    main()
