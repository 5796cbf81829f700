"""Import a reference torch checkpoint into a model directory (counterpart of
``tcsfm/cli/import_checkpoint.py``, same flags and printed JSON).

The reference publishes trained checkpoints as ``checkpoint.pt`` /
``best_model.pt`` dicts with ``depth_state_dict`` / ``pose_state_dict``
(run_mono_training.py:228-234, utils/learning_helpers.py:29-48). This CLI
maps one onto the port's networks (``models/torch_import.py``) and writes
the JAX package's checkpoint layout with ``config.json``
(``train/checkpoint.save_checkpoint``, ``is_best=True``, with a fresh
optimizer state as JAX's CLI writes), so every evaluation CLI of either
package reads it through ``--model_dir``:

    python -m tcsfm_torch.cli.import_checkpoint \
        --torch_ckpt /path/to/best_model.pt --out_dir results/kitti-4-iter \
        --iterations 4

``--torchvision`` takes a raw torchvision ImageNet resnet18 state dict
instead and warm-starts the depth encoder of the seeded networks
(generator seed 0; the JAX CLI's init draws other numbers), leaving the
decoder and the pose net as seeded (README.md:54).

The networks are built on the card unless ``--device cpu``; with no card
it raises. The conversion itself is host work.
"""

from __future__ import annotations

import argparse
import json
import os


def load_torch_state_dict(path: str):
    """``torch.load`` a checkpoint on the CPU. ``weights_only=False``: the
    reference's dicts carry non-tensor entries (epoch, best_val_loss)."""
    import torch

    return torch.load(path, map_location="cpu", weights_only=False)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--torch_ckpt", type=str, required=True,
                   help=".pt file: reference checkpoint dict, or a raw "
                        "state dict with --torchvision")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--torchvision", action="store_true",
                   help="input is a torchvision resnet18 ImageNet state "
                        "dict; warm-start only the depth encoder")
    p.add_argument("--iterations", type=int, default=4)
    p.add_argument("--img_resolution", type=str, default="med")
    p.add_argument("--min_depth", type=float, default=0.06)
    p.add_argument("--max_depth", type=float, default=80.0 / 30.0)
    p.add_argument("--config", type=str, default="",
                   help="optional existing config.json to carry over")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the card")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from tcsfm_torch.config import Config
    from tcsfm_torch.models.torch_import import (
        convert_reference_checkpoint, convert_torchvision_resnet18,
        warm_start_encoder)
    from tcsfm_torch.train.checkpoint import save_checkpoint
    from tcsfm_torch.train.trainer import create_train_state
    from tcsfm_torch.utils.helpers import resolve_device

    if args.config:
        cfg = Config.load(args.config)
    else:
        cfg = Config(iterations=args.iterations,
                     img_resolution=args.img_resolution,
                     min_depth=args.min_depth, max_depth=args.max_depth,
                     ckpt_dir=args.out_dir)

    state = create_train_state(cfg, device=resolve_device(args.device),
                               generator=torch.Generator().manual_seed(0),
                               steps_per_epoch=1)
    ckpt = load_torch_state_dict(args.torch_ckpt)

    if args.torchvision:
        state.depth_net.load_state_dict(warm_start_encoder(
            state.depth_net.state_dict(), convert_torchvision_resnet18(ckpt)))
        epoch, best = 0, float("inf")
    else:
        conv = convert_reference_checkpoint(ckpt)
        state.depth_net.load_state_dict(conv["depth"])
        state.pose_net.load_state_dict(conv["pose"])
        epoch, best = conv["epoch"], conv["best_val_loss"]

    os.makedirs(args.out_dir, exist_ok=True)
    path = save_checkpoint(args.out_dir, state, epoch=epoch,
                           best_val_loss=best, cfg=cfg, is_best=True)
    out = {"checkpoint": path, "epoch": int(epoch), "best_val_loss":
           float(best), "config": os.path.join(args.out_dir, "config.json")}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
