"""Paper-experiment CLIs: perturbation, depth scaling, frame skip
(counterpart of ``tcsfm/cli/experiments.py``, same subcommands, flags and
printed JSON).

  * perturbation: trans/yaw noise injected into the coupled iterations
    over a whole sequence, and the trajectory errors it leaves;
  * depth_scaling: the predicted depth scaled x[0.7..1.3] and the mean
    translation norm that follows (coupled models track the scale ~linearly);
  * frame_skip: evaluation at frame stride 1..3.

Usage: python -m tcsfm_torch.cli.experiments
       {perturbation|depth_scaling|frame_skip} [--model_dir DIR]
       [--data_dir D --seq 09_02 | --synthetic] [--batch 8]
       [--iterations N] [--device cpu]

Runs on the card unless ``--device cpu``; with no card it raises.
``--model_dir`` reads a checkpoint that either package wrote; without it
the networks are the port's seeded init (``cli.common.load_nets``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from tcsfm_torch.ops.grid_sample import grid_sample


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("perturbation", "depth_scaling", "frame_skip"):
        sp = sub.add_parser(name)
        sp.add_argument("--model_dir", type=str, default="")
        sp.add_argument("--data_dir", type=str, default="")
        sp.add_argument("--seq", type=str, default="09_02")
        sp.add_argument("--batch", type=int, default=8)
        sp.add_argument("--iterations", type=int, default=0)
        sp.add_argument("--synthetic", action="store_true")
        sp.add_argument("--device", type=str, default=None,
                        help="torch device; default the card")
        if name == "perturbation":
            sp.add_argument("--trans_pert", type=float, default=0.05)
            sp.add_argument("--yaw_pert", type=float, default=0.0875)
    return p.parse_args(argv)


def _config_and_seq(args: argparse.Namespace):
    from tcsfm_torch.cli.common import load_config
    from tcsfm_torch.config import Config
    from tcsfm_torch.data.dataset import SequenceData
    from tcsfm_torch.data.synthetic import make_synthetic_sequence

    cfg = load_config(args.model_dir, Config(iterations=2))
    if args.iterations:
        cfg = dataclasses.replace(cfg, iterations=args.iterations)
    if args.synthetic:
        seq = make_synthetic_sequence(24, (64, 96), seed=17)
    else:
        d = os.path.join(args.data_dir, args.seq)
        npz = os.path.join(d, "sequence_data.npz")
        seq = (SequenceData.from_npz(npz) if os.path.exists(npz)
               else SequenceData.from_reference_pkl(d, args.seq))
    return cfg, seq


@torch.no_grad()
def _depths(cfg, depth_net, tgt, src):
    from tcsfm_torch.solver.coupled import solve_disp
    from tcsfm_torch.utils.helpers import disp_to_depth

    return torch.stack([disp_to_depth(d[0], cfg.min_depth, cfg.max_depth)[1]
                        for d in solve_disp(depth_net, tgt, src)])


def _unscaled_errors(cfg, depth_net, pose_net, seq, args, device, sampler,
                     **kw):
    """The fused x30 trajectory's errors (the VO evaluator's unscaled
    ones) with ``kw``'s perturbation or frame stride."""
    from tcsfm_torch.eval.vo import VOEvaluator

    ev = VOEvaluator(cfg, depth_net, pose_net, dnet_rescaling=False,
                     device=device, sampler=sampler)
    res = ev.run_sequence(seq, batch_size=args.batch, verbose=False, **kw)
    return [float(e) for e in res["errors_unscaled"]]


def cmd_perturbation(args, depth_net, pose_net, device, sampler):
    cfg, seq = _config_and_seq(args)
    return {name: _unscaled_errors(cfg, depth_net, pose_net, seq, args,
                                   device, sampler, trans_pert=tp,
                                   yaw_pert=yp)
            for name, tp, yp in (("clean", 0.0, 0.0),
                                 ("trans", args.trans_pert, 0.0),
                                 ("yaw", 0.0, args.yaw_pert),
                                 ("both", args.trans_pert, args.yaw_pert))}


def cmd_depth_scaling(args, depth_net, pose_net, device, sampler):
    from tcsfm_torch.data.dataset import SfMWindowDataset
    from tcsfm_torch.data.loader import BatchLoader
    from tcsfm_torch.data.transforms import WindowTransform
    from tcsfm_torch.eval.experiments import depth_scaling_response
    from tcsfm_torch.utils.helpers import to_device

    cfg, seq = _config_and_seq(args)
    ds = SfMWindowDataset(
        [seq], seq_len=3,
        transform=WindowTransform(jitter=False, flip_prob=None))
    batch = next(iter(BatchLoader(ds, args.batch, shuffle=False)))
    x = to_device(batch, ("target_img", "source_imgs", "intrinsics"), device)
    tgt, src = x["target_img"], x["source_imgs"]
    scales = [0.7, 0.8, 0.9, 1.0, 1.1, 1.2, 1.3]
    norms = depth_scaling_response(
        cfg.iterations, _depths(cfg, depth_net, tgt, src), pose_net, tgt,
        src, x["intrinsics"], scales, sampler=sampler)
    rel = (norms / norms[scales.index(1.0)]).tolist()
    return {"scales": scales, "trans_norms": norms.tolist(),
            "relative": rel}


def cmd_frame_skip(args, depth_net, pose_net, device, sampler):
    cfg, seq = _config_and_seq(args)
    return {f"skip_{k}": _unscaled_errors(cfg, depth_net, pose_net, seq,
                                          args, device, sampler,
                                          correction_rate=k)
            for k in (1, 2, 3)}


def run(args: argparse.Namespace, depth_net, pose_net, device,
        sampler=grid_sample) -> dict:
    """The experiment ``args.cmd`` with ``depth_net``/``pose_net`` (on
    ``device``) and the warps' ``sampler``: prints and returns its
    results."""
    from tcsfm_torch.utils.helpers import resolve_device

    cmd = {"perturbation": cmd_perturbation,
           "depth_scaling": cmd_depth_scaling,
           "frame_skip": cmd_frame_skip}[args.cmd]
    out = cmd(args, depth_net.eval(), pose_net.eval(),
              resolve_device(device), sampler)
    print(json.dumps(out, indent=2))
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    from tcsfm_torch.cli.common import load_nets
    from tcsfm_torch.utils.helpers import resolve_device

    device = resolve_device(args.device)
    return run(args, *load_nets(args.model_dir, device), device)


if __name__ == "__main__":
    main()
