"""Dataset-free demo: PFT on a synthetic window + loss surfaces
(counterpart of ``tcsfm/cli/demo_pft.py``, same flags and summary).

Runs a single-window inference-time optimization and sweeps
photometric-error surfaces around the ground-truth pose; the window is
generated (``data.synthetic``), not bundled. The networks are the port's
seeded init (``infer.build_models``, generator seeds 0), so the PFT losses
differ from the JAX demo's, whose init draws other numbers; the surfaces
depend on no network.

Usage: python -m tcsfm_torch.cli.demo_pft [--epochs 20] [--mode encoder]
       [--device cpu]

Runs on the card unless ``--device cpu``; with no card it raises.
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--mode", type=str, default="encoder")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--iterations", type=int, default=2)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=96)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the card")
    return p.parse_args(argv)


def run(args: argparse.Namespace, depth_net, pose_net, device) -> dict:
    """The demo on ``depth_net``/``pose_net`` (on ``device``): prints the
    PFT loss, the loss surfaces' minima and the JSON summary; returns the
    summary."""
    import numpy as np
    import torch

    from tcsfm_torch.config import Config, PFTOptions
    from tcsfm_torch.data.dataset import SfMWindowDataset, relative_lie_alg
    from tcsfm_torch.data.loader import BatchLoader
    from tcsfm_torch.data.synthetic import make_synthetic_sequence
    from tcsfm_torch.data.transforms import WindowTransform
    from tcsfm_torch.eval.experiments import loss_surface
    from tcsfm_torch.solver.pft import PFTOptimizer

    H, W = args.height, args.width
    cfg = Config(iterations=args.iterations, num_scales=1,
                 compute_dtype="float32")
    seq = make_synthetic_sequence(8, (H, W), seed=4)
    ds = SfMWindowDataset(
        [seq], seq_len=3,
        transform=WindowTransform(jitter=False, flip_prob=None))
    batch = next(iter(BatchLoader(ds, 2, shuffle=False)))
    batch.pop("_valid")

    opts = PFTOptions(epochs=args.epochs, lr=args.lr, avg_final_epochs=5,
                      num_source_imgs=2)
    opt = PFTOptimizer(cfg, opts, depth_net, pose_net, mode=args.mode)
    res = opt.optimize_window(batch, device=device)
    losses = res.losses.cpu().numpy()
    print(f"PFT ({args.mode}, {args.epochs} epochs): "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f}")

    # loss surface around the GT pose with GT depth (sanity: minimum ~ 0)
    t, s = 1, 2
    xi = relative_lie_alg(seq.gt_poses[t], seq.gt_poses[s])
    tz = abs(float(xi[2])) + 1e-6
    offs = np.linspace(-1.5 * tz, 1.5 * tz, 21).astype(np.float32)
    yaws = np.linspace(-0.008, 0.008, 21).astype(np.float32)

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    surf = loss_surface(
        put(seq.images[t][None]), put(seq.images[s][None]),
        put(seq.depths[t][None, ..., None]),
        put(seq.depths[s][None, ..., None]), put(xi[None]),
        put(seq.intrinsics[t][None]), offs, yaws, automask=False)
    t_curve, y_curve = surf["trans"][:, 0], surf["yaw"][:, 0]
    print(f"loss surface: trans argmin at offset "
          f"{offs[np.nanargmin(t_curve)]:+.4f} (0 is GT), "
          f"yaw argmin at {yaws[np.nanargmin(y_curve)]:+.4f}")

    summary = {
        "pft_loss_first": float(losses[0]),
        "pft_loss_last": float(losses[-1]),
        "pft_improved": bool(losses[-1] < losses[0]),
        "surface_trans_argmin_offset": float(offs[np.nanargmin(t_curve)]),
        "surface_yaw_argmin_offset": float(yaws[np.nanargmin(y_curve)]),
    }
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**summary,
                       "trans_curve": t_curve.tolist(),
                       "yaw_curve": y_curve.tolist()}, f)
    return summary


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from tcsfm_torch.config import Config
    from tcsfm_torch.infer import build_models
    from tcsfm_torch.utils.helpers import resolve_device

    device = resolve_device(args.device)
    depth_net, pose_net = build_models(
        Config(iterations=args.iterations, num_scales=1,
               compute_dtype="float32"), device=device,
        generator=torch.Generator().manual_seed(0))
    return run(args, depth_net, pose_net, device)


if __name__ == "__main__":
    main()
