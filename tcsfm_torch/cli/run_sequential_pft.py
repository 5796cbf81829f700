"""Sequential inference-time optimization over whole sequences (counterpart
of ``tcsfm/cli/run_sequential_pft.py``, same flags, saved arrays and
printed results).

For every 3-frame window (targets 1..N-2) a refiner improves the coupled
solver's poses; the fwd/inv estimates of each edge are fused, scaled to
metric (x30 and the DNet ground-plane factor) and integrated into a
trajectory, and the initial and the refined trajectories are scored
against the ground truth. The refiners:

  adam  -- PFT (``solver.pft.PFTOptimizer``, every ``--mode``): ~20 Adam
           steps on the chosen parameters, the last 5 predictions averaged;
  ba    -- ``solver.ba.window_ba``: pose + target depth, both pairs of the
           window, then the cross-window information-weighted fusion;
  gn    -- ``solver.gauss_newton.gauss_newton_pose``: pose only, per pair;
  chain -- ``solver.ba.chain_ba`` over blocks of ``--chain_block`` frames
           that overlap by one frame, so the blocks' edges partition the
           sequence's N-1 edges; per-frame depths and DNet scales, and the
           coupled solver's window poses as the start.

Windows go through the refiner ``--window_batch`` at a time; the chain's
per-frame depths and initial poses go in chunks of the same size. The
JAX package's fixed chunks of 8 and padded tails keep one compiled
program; here there is none to keep, so a short last batch stays short.
The DNet factor of the adam, ba and gn refiners is one per window batch
(the reference's), taken over the batch's real windows only: JAX's padded
tail repeats the last window into its last batch's factor and mean loss.
The chain's scale is per frame, as in JAX.

Usage: python -m tcsfm_torch.cli.run_sequential_pft --model_dir DIR
       --data_dir D [--seqs 09_02] [--refiner adam|ba|gn|chain]
       [--mode encoder] [--epochs 20] [--window_batch 4] [--synthetic]
       [--out_dir D] [--out_json F] [--device cpu]

Runs on the card unless ``--device cpu``; with no card it raises. On the
card the warps go through the CUDA kernels: per window batch, ``adam``
launches the value kernel E·I times, the d_coords-only backward
(E-1)(I-1) times and the d_img backward E-1 times (E epochs, I coupled
iterations, a mode that trains depth); ``ba`` and ``gn`` launch the value
and the value+Jacobian kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from collections import deque

import numpy as np
import torch

from tcsfm_torch.eval.vo import METRIC_SCALE
from tcsfm_torch.ops.grid_sample import grid_sample


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", type=str, default="")
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--seqs", nargs="+", default=["09_02"])
    p.add_argument("--mode", type=str, default="encoder",
                   help="encoder|all_depth|decoder|depth_pred|bottleneck|pose")
    p.add_argument("--refiner", type=str, default="adam",
                   choices=["adam", "ba", "chain", "gn"],
                   help="adam = PFT on network state; ba = Gauss-Newton "
                        "bundle adjustment over pose + per-pixel depth of "
                        "each window; chain = joint block-tridiagonal BA "
                        "over whole sequence blocks; gn = pose-only damped "
                        "Gauss-Newton per pair")
    p.add_argument("--chain_block", type=int, default=12,
                   help="frames per chain-BA block (refiner=chain); blocks "
                        "overlap by one frame so edges partition exactly")
    p.add_argument("--pyramid_levels", type=int, default=2,
                   help="coarse-to-fine levels for refiner=chain")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--window_batch", type=int, default=4)
    p.add_argument("--extra_iterations", type=int, default=0,
                   help="extra egomotion iterations at test time")
    p.add_argument("--scaling", type=str, default="unscaled",
                   choices=["unscaled", "none", "gt"],
                   help="'unscaled' applies the DNet ground-plane factor, "
                        "x30*scale on translations; 'none' applies x30 "
                        "only; 'gt' mean-norm-matches each trajectory's "
                        "translations to the GT increments")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_frames", type=int, default=16,
                   help="synthetic sequence length (over 48: the "
                        "world-anchored drive generator)")
    p.add_argument("--synthetic_size", type=int, nargs=2, default=(64, 96),
                   help="synthetic H W (192 640 = paper med res)")
    p.add_argument("--out_dir", type=str, default="")
    p.add_argument("--out_json", type=str, default="",
                   help="also write the results dict to this JSON file")
    p.add_argument("--chain_depth_prior", type=float, default=0.1,
                   help="refiner=chain: weight pinning refined depth to "
                        "its initialization")
    p.add_argument("--init_gt_pert", type=float, default=0.0,
                   help="refiner=chain control: start the edge poses from "
                        "GT twists + seeded Gaussian noise (sigma = this "
                        "fraction of the mean translation on t, x0.02 rad "
                        "on r) instead of the pose net")
    p.add_argument("--gt_depth", action="store_true",
                   help="refiner=chain control: linearize on the "
                        "sequence's stored depth maps instead of the depth "
                        "net's predictions")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the card")
    args = p.parse_args(argv)
    if args.refiner == "chain" and args.chain_block < 3:
        # block 1 never advances the block loop; block 2 gives chain_ba a
        # single-edge system whose edge-count normalization hits 0/0
        p.error("--chain_block must be >= 3")
    return args


def config_of(args: argparse.Namespace):
    """The model directory's configuration (or JAX's synthetic default, 2
    iterations) with ``--extra_iterations`` added."""
    from tcsfm_torch.cli.common import load_config
    from tcsfm_torch.config import Config

    cfg = load_config(args.model_dir,
                      Config(iterations=2, compute_dtype="float32"))
    return dataclasses.replace(
        cfg, iterations=cfg.iterations + args.extra_iterations)


def _sources(args: argparse.Namespace):
    from tcsfm_torch.data.dataset import sequence_sources
    from tcsfm_torch.data.synthetic import (make_drive_sequence,
                                            make_synthetic_sequence)

    if not args.synthetic:
        # lazy loaders: one sequence's frames in memory at a time
        return sequence_sources(args.data_dir, args.seqs)
    size = tuple(args.synthetic_size)
    if args.synthetic_frames > 48:
        # the frame-0 texture leaves its valid region after ~0.5 scene
        # units of travel; long sequences use the world-anchored generator
        print(f"synthetic: drive generator ({args.synthetic_frames} frames, "
              f"world-anchored texture)")
        return {"synthetic": lambda: make_drive_sequence(
            args.synthetic_frames, size, seed=13)}
    return {"synthetic": lambda: make_synthetic_sequence(
        args.synthetic_frames, size, seed=13)}


@torch.no_grad()
def coupled_poses(cfg, depth_net, pose_net, tgt, src, K, sampler):
    """The coupled forward of the ba and gn bodies: depths of the target
    and both sources [3,B,H,W,1], poses and inverse poses [2,B,6]."""
    from tcsfm_torch.solver.coupled import solve_disp, solve_pose_iteratively
    from tcsfm_torch.utils.helpers import disp_to_depth

    disps = solve_disp(depth_net, tgt, src)
    depths = torch.stack([disp_to_depth(d[0], cfg.min_depth,
                                        cfg.max_depth)[1] for d in disps])
    poses, poses_inv, _ = solve_pose_iteratively(
        cfg.iterations, depths, pose_net, tgt, src, K, sampler=sampler)
    return depths, poses, poses_inv


def _window_refiner(args, cfg, depth_net, pose_net, device, sampler):
    """refine(batch on the device) -> the refiner's outputs (tensors)."""
    from tcsfm_torch.config import PFTOptions
    from tcsfm_torch.eval.scale_recovery import scale_recovery
    from tcsfm_torch.solver.ba import window_ba
    from tcsfm_torch.solver.gauss_newton import gauss_newton_pose
    from tcsfm_torch.solver.pft import PFTOptimizer

    cam_h = cfg.camera_height / METRIC_SCALE
    if args.refiner == "adam":
        opts = PFTOptions(epochs=args.epochs, lr=args.lr, avg_final_epochs=5,
                          num_source_imgs=2)
        optimizer = PFTOptimizer(cfg, opts, depth_net, pose_net,
                                 mode=args.mode)
        return lambda batch: optimizer.optimize_window(batch, device=device,
                                                       sampler=sampler)

    def refine(batch):
        tgt, src, K = (batch[k] for k in ("target_img", "source_imgs",
                                          "intrinsics"))
        depths, poses, poses_inv = coupled_poses(cfg, depth_net, pose_net,
                                                 tgt, src, K, sampler)
        if args.refiner == "ba":
            # both pair constraints of the window share the target depth;
            # the inverse estimate of an edge comes from the next window
            res = window_ba(poses[0], poses[1], depths[0], tgt, src[0],
                            src[1], depths[1], depths[2], K,
                            iters=args.epochs // 2, depth_prior_weight=0.1,
                            sampler=sampler, device=device)
            # BA refines the target depth jointly: rescale from it
            return (poses, poses_inv, res, scale_recovery(depths[0], K, cam_h),
                    scale_recovery(res.depth, K, cam_h))
        gn_kw = dict(iters=max(args.epochs // 2, 4), sampler=sampler,
                     device=device)
        # forward: target vs the next frame (source 1); inverse: the next
        # frame as target vs the window's target
        res_f = gauss_newton_pose(poses[1], tgt, src[1], depths[0], depths[2],
                                  K, **gn_kw)
        res_i = gauss_newton_pose(poses_inv[1], src[1], tgt, depths[2],
                                  depths[0], K, **gn_kw)
        return poses, poses_inv, res_f, res_i, scale_recovery(depths[0], K,
                                                              cam_h)

    return refine


def _chain_refine_sequence(seq, args, cfg, depth_net, pose_net, device,
                           sampler):
    """Whole-sequence joint BA (refiner=chain): per-frame depths and DNet
    scales, the coupled solver's initial window poses, then ``chain_ba``
    over blocks of ``args.chain_block`` frames overlapping by one frame.

    Returns (pose_init [E,6], pose_opt [E,6], scale_edges [E], cost_first,
    cost_last) as numpy and floats."""
    from tcsfm_torch.data.dataset import relative_lie_alg
    from tcsfm_torch.eval.scale_recovery import scale_recovery_per_sample
    from tcsfm_torch.solver.ba import chain_ba
    from tcsfm_torch.solver.coupled import solve_pose_iteratively
    from tcsfm_torch.utils.helpers import disp_to_depth, to_numpy

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)

    n = len(seq)
    frames = put(np.stack([np.asarray(seq.load_image(i), np.float32)
                           for i in range(n)]))                # [N, H, W, 3]
    K1 = put(seq.intrinsics[0])
    ch = args.window_batch
    if args.gt_depth and seq.depths is None:
        raise SystemExit(f"--gt_depth: sequence {seq.name} carries no stored "
                         "depth maps")
    depths, scales = [], []
    with torch.no_grad():
        for i in range(0, n, ch):
            if args.gt_depth:
                # control: exact stored depths; the DNet scale still comes
                # from the depth field
                d = put(np.asarray(seq.depths[i:i + ch])[..., None])
            else:
                d = disp_to_depth(depth_net(frames[i:i + ch])[0],
                                  cfg.min_depth, cfg.max_depth)[1]
            depths.append(d)
            scales.append(scale_recovery_per_sample(
                d, K1.expand(len(d), 3, 3), cfg.camera_height / METRIC_SCALE))
    depths = torch.cat(depths)                                  # [N,H,W,1]
    frame_scale = to_numpy(torch.cat(scales))             # [N]

    if args.init_gt_pert > 0:
        # control: GT edge twists + seeded noise instead of the pose net,
        # the source -> target change with the source as window target
        rngp = np.random.RandomState(0)
        t_idx = np.arange(1, n - 1)
        gp = np.stack([relative_lie_alg(seq.gt_poses[t - 1], seq.gt_poses[t])
                       for t in t_idx])
        gn_ = np.stack([relative_lie_alg(seq.gt_poses[t + 1], seq.gt_poses[t])
                        for t in t_idx])
        tmag = float(np.mean(np.linalg.norm(gn_[:, :3], axis=1)))
        sig = args.init_gt_pert

        def pert(x):
            noise = np.concatenate(
                [rngp.randn(len(x), 3) * sig * tmag,
                 rngp.randn(len(x), 3) * sig * 0.02], axis=1)
            return (x + noise).astype(np.float32)

        pose0_prev, pose0_next = put(pert(gp)), put(pert(gn_))
    else:
        # coupled-solver initial poses of the windows with targets 1..N-2
        pp, pn = [], []
        with torch.no_grad():
            for i in range(1, n - 1, ch):
                t = torch.arange(i, min(i + ch, n - 1), device=device)
                srcs = torch.stack([frames[t - 1], frames[t + 1]])
                dps = torch.stack([depths[t], depths[t - 1], depths[t + 1]])
                poses, _, _ = solve_pose_iteratively(
                    cfg.iterations, dps, pose_net, frames[t], srcs,
                    K1.expand(len(t), 3, 3), sampler=sampler)
                pp.append(poses[0])                     # target -> prev
                pn.append(poses[1])                     # target -> next
        pose0_prev, pose0_next = torch.cat(pp), torch.cat(pn)   # [N-2, 6]

    # chain BA per block; block [i, end) owns edges i..end-2
    edges, costs0, costs1 = [], [], []
    i = 0
    while i < n - 1:
        end = min(i + args.chain_block, n)
        if n - end < 3:                 # avoid a tail too short to chain
            end = n
        res = chain_ba(frames[i:end], depths[i:end], K1,
                       pose0_prev[i:end - 2], pose0_next[i:end - 2],
                       iters=max(args.epochs // 2, 4),
                       depth_prior_weight=args.chain_depth_prior,
                       pyramid_levels=args.pyramid_levels, sampler=sampler,
                       device=device)
        edges.append(res.edge_pose)
        costs0.append(res.cost[0])
        costs1.append(res.cost[-1])
        i = end - 1
    pose_opt = torch.cat(edges).cpu().numpy()                   # [N-1, 6]
    pose0_prev, pose0_next = pose0_prev.cpu().numpy(), pose0_next.cpu().numpy()

    # initial per-edge estimate: mean of the available window measurements
    cnt = np.zeros((n - 1, 1))
    pose_init = np.zeros((n - 1, 6), np.float32)
    cnt[:-1] += 1.0
    cnt[1:] += 1.0
    pose_init[:-1] += -pose0_prev
    pose_init[1:] += pose0_next
    pose_init /= cnt

    scale_edges = 0.5 * (frame_scale[:-1] + frame_scale[1:])   # [N-1]
    return (pose_init, pose_opt, scale_edges,
            float(torch.stack(costs0).mean()),
            float(torch.stack(costs1).mean()))


def gt_scale(pred, gt_poses, first_edge_frame):
    """Mean-norm scale matching pred edge translations to the GT
    increments over the same edges."""
    n = len(pred)
    gt_norms = [np.linalg.norm(
        (np.linalg.inv(gt_poses[first_edge_frame + e])
         @ gt_poses[first_edge_frame + e + 1])[:3, 3])
        for e in range(n)]
    return (float(np.mean(gt_norms))
            / max(float(np.mean(np.linalg.norm(pred[:, 0:3], axis=1))),
                  1e-12))


def to_metric(seq, pred, gt_traj):
    """Synthetic worlds are defined at the network's 1/30-metric scale:
    both trajectories in metres, so the 100-800 m segment-error protocol
    applies."""
    if not seq.name.startswith(("drive", "synthetic")):
        return pred, gt_traj
    pred = pred.copy()
    pred[:, 0:3] *= METRIC_SCALE
    gt_traj = np.array(gt_traj, copy=True)
    gt_traj[:, :3, 3] *= METRIC_SCALE
    return pred, gt_traj


def _errors(pose_init, pose_opt, gt_traj):
    from tcsfm_torch.eval.trajectory import compute_trajectory

    _, _, err_init, _ = compute_trajectory(
        pose_init, gt_traj, method="initial", compute_seg_err=True)
    _, _, err_opt, _ = compute_trajectory(
        pose_opt, gt_traj, method="optimized", compute_seg_err=True)
    return [float(e) for e in err_init], [float(e) for e in err_opt]


def _run_chain(seq_name, seq, args, cfg, depth_net, pose_net, device,
               sampler, t_refine):
    pose_init, pose_opt, sc_edge, c0, c1 = _chain_refine_sequence(
        seq, args, cfg, depth_net, pose_net, device, sampler)
    if args.scaling == "gt":
        # chain edge e spans frames e -> e+1
        pose_init[:, 0:3] *= gt_scale(pose_init, seq.gt_poses, 0)
        pose_opt[:, 0:3] *= gt_scale(pose_opt, seq.gt_poses, 0)
    else:
        if args.scaling != "unscaled":
            sc_edge = np.ones_like(sc_edge)
        pose_init[:, 0:3] *= (METRIC_SCALE * sc_edge)[:, None]
        pose_opt[:, 0:3] *= (METRIC_SCALE * sc_edge)[:, None]
    gt_traj = seq.gt_poses[:len(pose_opt) + 1]
    if args.scaling == "gt":
        pose_init, _ = to_metric(seq, pose_init, gt_traj)
        pose_opt, gt_traj = to_metric(seq, pose_opt, gt_traj)
    err_init, err_opt = _errors(pose_init, pose_opt, gt_traj)
    wall = time.monotonic() - t_refine
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        np.savez(os.path.join(args.out_dir, f"{seq_name}_pft.npz"),
                 pose_init=pose_init, pose_opt=pose_opt)
    return {"errors_initial": err_init, "errors_optimized": err_opt,
            "pft_loss_first": c0, "pft_loss_last": c1,
            "wall_s": round(wall, 2),
            "edges_per_s": round(len(pose_opt) / max(wall, 1e-9), 2)}


def run(args: argparse.Namespace, depth_net, pose_net, device,
        sampler=grid_sample) -> dict:
    """The sequential refinement with ``depth_net``/``pose_net`` (on
    ``device``) and the warps' ``sampler``: prints and returns the results
    by sequence."""
    from tcsfm_torch.data.dataset import SfMWindowDataset
    from tcsfm_torch.data.loader import BatchLoader
    from tcsfm_torch.data.transforms import WindowTransform
    from tcsfm_torch.solver.ba import fuse_pose_estimates
    from tcsfm_torch.utils.helpers import (resolve_device, to_device,
                                           to_numpy)

    device = resolve_device(device)
    cfg = config_of(args)
    depth_net.eval()
    pose_net.eval()
    dtype = next(depth_net.parameters()).dtype
    refine = _window_refiner(args, cfg, depth_net, pose_net, device, sampler)

    results = {}
    for seq_name, load_seq in _sources(args).items():
        seq = load_seq()                 # one sequence in memory at a time
        t_refine = time.monotonic()      # refine wall-clock (excl. loading)
        if args.refiner == "chain":
            results[seq_name] = _run_chain(seq_name, seq, args, cfg,
                                           depth_net, pose_net, device,
                                           sampler, t_refine)
            continue

        ds = SfMWindowDataset(
            [seq], seq_len=3,
            transform=WindowTransform(jitter=False, flip_prob=None))
        loader = BatchLoader(ds, args.window_batch, shuffle=False,
                             drop_last=False)

        init_poses, opt_poses, init_inv, opt_inv, losses = [], [], [], [], []
        info_f, info_i, cost_last = [], [], []
        scales_init, scales_opt = [], []

        np_ = to_numpy

        def drain_one():
            n, out = pending.popleft()
            if args.refiner == "ba":
                poses, poses_inv, res, s_init, s_opt = out
                init_poses.append(np_(poses[1]))
                init_inv.append(np_(poses_inv[1]))
                # window target t: pose_next measures edge t->t+1,
                # pose_prev measures t->t-1 (the next edge of window t-1)
                opt_poses.append(np_(res.pose_next))
                opt_inv.append(np_(res.pose_prev))
                info_f.append(np_(res.S_bb))
                info_i.append(np_(res.S_aa))
                cost_last.append(np_(res.cost[-1]))
                losses.append(np_(res.cost).mean(axis=1))
            elif args.refiner == "gn":
                poses, poses_inv, res_f, res_i, s_init = out
                s_opt = s_init          # pose only: the depth is untouched
                init_poses.append(np_(poses[1]))
                init_inv.append(np_(poses_inv[1]))
                opt_poses.append(np_(res_f.pose))
                opt_inv.append(np_(res_i.pose))
                losses.append(np_(res_f.cost).mean(axis=1))
            else:
                res = out
                s_init, s_opt = res.scale_init, res.scale_opt
                # source 1 is the next frame (forward in time)
                init_poses.append(np_(res.poses_init[1]))
                opt_poses.append(np_(res.poses_opt[1]))
                init_inv.append(np_(res.poses_inv_init[1]))
                opt_inv.append(np_(res.poses_inv_opt[1]))
                losses.append(np_(res.losses))
            # one DNet factor per window batch
            scales_init.append(np.full(n, float(s_init)))
            scales_opt.append(np.full(n, float(s_opt)))

        # at most two batches' results wait on the device: the host reads
        # a batch's results two batches after it was queued
        pending = deque()
        img_shape = None
        for batch in loader:
            n = int(batch.pop("_valid").sum())
            img_shape = batch["target_img"].shape[1:]   # [H, W, 3]
            pending.append((n, refine(to_device(
                batch, ("target_img", "source_imgs", "intrinsics"), device,
                dtype))))
            if len(pending) > 2:
                drain_one()
        while pending:
            drain_one()

        if img_shape is None:
            results[seq_name] = {
                "skipped": f"sequence too short for seq_len=3 "
                           f"({len(seq.gt_poses)} frames)"}
            continue

        if args.scaling == "unscaled":
            sc_init = np.concatenate(scales_init)
            sc_opt = np.concatenate(scales_opt)
        else:
            # 'none' and 'gt': uniform x30 first; 'gt' renormalizes below
            sc_init = sc_opt = np.ones(sum(len(s) for s in scales_init))

        def fuse(fwd_list, inv_list, scales):
            fused = (np.concatenate(fwd_list) - np.concatenate(inv_list)) / 2.0
            fused[:, 0:3] *= (METRIC_SCALE * scales)[:, None]
            return fused

        pose_init = fuse(init_poses, init_inv, sc_init)
        if args.refiner == "ba":
            # edge (t, t+1) is measured by window t's refined next pose and
            # window t+1's refined prev pose: fuse them with the
            # depth-marginalized informations, each weighted by its
            # window's residual variance
            xi_next = np.concatenate(opt_poses)        # [Nw, 6] t -> t+1
            xi_prev = np.concatenate(opt_inv)          # [Nw, 6] t -> t-1
            npix = 2.0 * float(np.prod(img_shape))     # joint 2-pair cost
            var = np.maximum(np.concatenate(cost_last) / npix, 1e-12)
            i_next = np.concatenate(info_f) / var[:, None, None]
            i_prev = np.concatenate(info_i) / var[:, None, None]

            def put(x):
                return torch.from_numpy(np.ascontiguousarray(x)).to(device)

            fused_mid = fuse_pose_estimates(
                put(xi_next[:-1]), put(i_next[:-1]), put(xi_prev[1:]),
                put(i_prev[1:])).cpu().numpy()
            pose_opt = np.concatenate([fused_mid, xi_next[-1:]])
            pose_opt[:, 0:3] *= (METRIC_SCALE * sc_opt)[:, None]
        else:
            pose_opt = fuse(opt_poses, opt_inv, sc_opt)
        if args.scaling == "gt":
            # window target t's fused edge spans frames t -> t+1; t = 1..
            pose_init[:, 0:3] *= gt_scale(pose_init, seq.gt_poses, 1)
            pose_opt[:, 0:3] *= gt_scale(pose_opt, seq.gt_poses, 1)
        gt_traj = seq.gt_poses[1:1 + len(pose_init) + 1]
        if args.scaling == "gt":
            pose_init, _ = to_metric(seq, pose_init, gt_traj)
            pose_opt, gt_traj = to_metric(seq, pose_opt, gt_traj)
        err_init, err_opt = _errors(pose_init, pose_opt, gt_traj)

        mean_losses = np.mean(np.stack(losses), axis=0)
        wall = time.monotonic() - t_refine
        results[seq_name] = {
            "errors_initial": err_init,
            "errors_optimized": err_opt,
            "pft_loss_first": float(mean_losses[0]),
            "pft_loss_last": float(mean_losses[-1]),
            "wall_s": round(wall, 2),
            "windows_per_s": round(len(pose_opt) / max(wall, 1e-9), 2),
        }
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            np.savez(os.path.join(args.out_dir, f"{seq_name}_pft.npz"),
                     pose_init=pose_init, pose_opt=pose_opt,
                     losses=np.stack(losses))

    print(json.dumps(results, indent=2))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(results, f, indent=2)
    return results


def main(argv=None) -> dict:
    args = parse_args(argv)
    from tcsfm_torch.cli.common import load_nets
    from tcsfm_torch.utils.helpers import resolve_device

    device = resolve_device(args.device)
    depth_net, pose_net = load_nets(args.model_dir, device)
    return run(args, depth_net, pose_net, device)


if __name__ == "__main__":
    main()
