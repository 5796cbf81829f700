"""Training CLI (counterpart of ``tcsfm/cli/train.py``, same flags, the
same epoch loop and the same files).

Usage:
  python -m tcsfm_torch.cli.train --data_dir /path/to/preprocessed
      --data_format odometry --train_seq 00_02 02_02 --val_seq 05_02
      --test_seq 09_02 --iterations 4 --minibatch 6 --num_epochs 20
      [--synthetic] [--device cpu]

``--synthetic`` trains on generated sequences (no dataset needed). Each
epoch trains, validates and writes the scalars at ``epoch + 1``; from the
second epoch on it also forms the visual panels and the test sequence's
trajectory errors, and keeps the best model by the validation's forward +
inverse reconstruction loss. ``results_dir/date`` receives
``checkpoint.msgpack`` (with the optimizer state), ``best_model/``,
``config.json`` and ``logs/``, which the JAX package's ``cli.train``
reads and writes alike; ``--load_from_checkpoint`` resumes a run of
either package there (or in ``--pretrained_dir``).

Runs on the card unless ``--device cpu``; with no card it raises. Both
networks compute in ``--compute_dtype`` (``bfloat16``, the JAX package's
default, or ``float32``; anything else is refused) on float32 parameters,
and the run prints the dtype it computes in; TF32 stays off, so float32
is float32. ``--no_mxu_warp``, ``--fast_sampler`` and
``--mixed_sampler`` pick among the JAX package's TPU sampler modes,
workarounds an f32 gather on the card does not need: the port has one
sampler, exact in f32, and takes them without effect.

Several cards: one process a card under ``torchrun`` (``torchrun
--nproc_per_node 4 -m tcsfm_torch.cli.train ... --n_devices 4``), each
rank on ``cuda:LOCAL_RANK`` with its rows of every global batch (the
loaders are process-sliced) and the data-parallel step of
``train.trainer``, which computes what one rank computes on the whole
batch. ``--n_devices`` must be 0 (the launch's world size) or that world
size, and ``--minibatch`` (the global batch) must divide by it: where the
JAX package clamps ``--n_devices`` to a divisor of the minibatch, the
launcher here fixes the number of processes, so the port raises. Only
rank 0 writes the checkpoints, the logs, the panels and the trajectory
evaluation (the files of a one-rank run on the same global batch); the
others wait at a barrier after each. With ``--device cpu`` the ranks are
gloo processes.
``--flow_type classical`` raises before the first step: the training
step's iterative solver cannot take the 8-channel pose net, and the JAX
package's step fails on it too (``build_config``).
Visualization never stops training where matplotlib or PIL is missing;
a failure of the panels' or the trajectory's forward does.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from tcsfm_torch.config import Config
from tcsfm_torch.data.dataset import SequenceData, SfMWindowDataset
from tcsfm_torch.data.loader import BatchLoader
from tcsfm_torch.data.synthetic import (make_drive_sequence,
                                        make_synthetic_sequence)
from tcsfm_torch.data.transforms import get_transforms
from tcsfm_torch.dist.mesh import (initialize_distributed, make_mesh,
                                   process_info)
from tcsfm_torch.train.checkpoint import load_checkpoint, save_checkpoint
from tcsfm_torch.train.logging import MetricsWriter
from tcsfm_torch.train.trainer import Trainer, create_train_state
from tcsfm_torch.train.validate import (depth_and_reconstruction_panels,
                                        trajectory_eval)
from tcsfm_torch.utils.helpers import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tcsfm training (PyTorch port)")
    p.add_argument("--flow_type", type=str, default="none")
    p.add_argument("--num_scales", type=int, default=1)
    p.add_argument("--img_resolution", type=str, default="med",
                   choices=["low", "med", "high"])
    p.add_argument("--img_per_sample", type=int, default=3)
    p.add_argument("--iterations", type=int, default=4)
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--data_format", type=str, default="odometry")
    p.add_argument("--date", type=str, default=time.strftime("%Y%m%d%H%M"))
    p.add_argument("--train_seq", nargs="+", type=str, default=["00_02"])
    p.add_argument("--val_seq", nargs="+", type=str, default=["05_02"])
    p.add_argument("--test_seq", nargs="+", type=str, default=["09_02"])
    p.add_argument("--augment_motion", action="store_true", default=False)
    p.add_argument("--minibatch", type=int, default=6)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--num_epochs", type=int, default=20)
    p.add_argument("--lr_decay_epoch", type=int, default=7)
    p.add_argument("--max_depth", type=float, default=80.0 / 30.0)
    p.add_argument("--min_depth", type=float, default=0.06)
    p.add_argument("--load_from_checkpoint", action="store_true")
    p.add_argument("--load_best_model", action="store_true")
    p.add_argument("--pretrained_dir", type=str, default="")
    p.add_argument("--freeze_depthnet", action="store_true")
    p.add_argument("--freeze_posenet", action="store_true")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="the networks' compute dtype (the parameters stay "
                        "float32)")
    p.add_argument("--no_mxu_warp", action="store_true",
                   help="no effect: the JAX package's TPU sampler switch")
    p.add_argument("--fast_sampler", action="store_true",
                   help="no effect: a precision mode of the TPU sampler")
    p.add_argument("--mixed_sampler", action="store_true",
                   help="no effect: a precision mode of the TPU sampler")
    p.add_argument("--n_devices", type=int, default=0,
                   help="cards for data parallelism: 0 (the launch's "
                        "world size) or the torchrun world size")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated synthetic sequences")
    p.add_argument("--synthetic_frames", type=int, default=40)
    p.add_argument("--synthetic_kind", type=str, default="scene",
                   choices=["scene", "drive"],
                   help="'scene': short textured-plane windows; 'drive': "
                        "long world-anchored S-curve drives")
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the card")
    return p.parse_args(argv)


def build_config(args) -> Config:
    if args.flow_type == "classical":
        raise ValueError(
            "--flow_type classical cannot train: the training step runs the "
            "iterative coupled solver, which feeds the pose net 6-channel "
            "pairs, and the JAX package fails the same way (its "
            "create_train_state builds an 8-channel pose net, "
            "tcsfm/train/trainer.py:93-94, that solve_pose_iteratively "
            "feeds 6-channel stacks, tcsfm/solver/coupled.py:163-165). "
            "Classical flow runs on the one-shot evaluation paths "
            "(evaluate_vo --iterations 1)")
    return Config(
        flow_type=args.flow_type, num_scales=args.num_scales,
        img_resolution=args.img_resolution,
        img_per_sample=args.img_per_sample, iterations=args.iterations,
        data_dir=args.data_dir, data_format=args.data_format,
        train_seq=tuple(args.train_seq), val_seq=tuple(args.val_seq),
        test_seq=tuple(args.test_seq), augment_motion=args.augment_motion,
        minibatch=args.minibatch, wd=args.wd, lr=args.lr,
        num_epochs=args.num_epochs, lr_decay_epoch=args.lr_decay_epoch,
        min_depth=args.min_depth, max_depth=args.max_depth,
        freeze_depthnet=args.freeze_depthnet,
        freeze_posenet=args.freeze_posenet,
        compute_dtype=args.compute_dtype,
        ckpt_dir=os.path.join(args.results_dir, args.date),
        load_from_checkpoint=args.load_from_checkpoint,
        load_best_model=args.load_best_model,
        pretrained_dir=args.pretrained_dir,
    )


def load_datasets(cfg: Config, args):
    """(train, val, test) window datasets and the test sequences: generated
    with ``--synthetic`` (64x96 at ``low``, else the resolution's size),
    else read from ``cfg.data_dir`` (``<seq>.npz``,
    ``<seq>/sequence_data.npz`` or the reference's pickle layout; ``all``
    takes every sequence there but the val and test ones)."""
    tf = get_transforms()
    if args.synthetic:
        h, w = (64, 96) if cfg.img_resolution == "low" else cfg.image_size
        gen = (make_drive_sequence if args.synthetic_kind == "drive"
               else make_synthetic_sequence)
        train_seqs = [gen(args.synthetic_frames, (h, w), seed=s)
                      for s in range(2)]
        val_seqs = [gen(args.synthetic_frames, (h, w), seed=7)]
        test_seqs = [gen(args.synthetic_frames, (h, w), seed=9)]
    else:
        def load(names, exclude=()):
            if list(names) == ["all"]:
                names = sorted(
                    n.replace(".npz", "") for n in os.listdir(cfg.data_dir)
                    if n not in exclude and not n.startswith("."))
                names = [n for n in names if n not in exclude]
            out = []
            for n in names:
                d = os.path.join(cfg.data_dir, n)
                if os.path.exists(d + ".npz"):
                    out.append(SequenceData.from_npz(d + ".npz"))
                    continue
                npz = os.path.join(d, "sequence_data.npz")
                if os.path.exists(npz):
                    out.append(SequenceData.from_npz(npz))
                else:
                    out.append(SequenceData.from_reference_pkl(d, n))
            return out

        train_seqs = load(cfg.train_seq,
                          exclude=set(cfg.val_seq) | set(cfg.test_seq))
        val_seqs = load(cfg.val_seq)
        test_seqs = load(cfg.test_seq)

    def windows(seqs, key):
        return SfMWindowDataset(
            seqs, seq_len=cfg.img_per_sample, transform=tf[key],
            correction_rate=cfg.correction_rate, skip=cfg.skip,
            augment_motion=cfg.augment_motion and key == "train")

    return (windows(train_seqs, "train"), windows(val_seqs, "val"),
            windows(test_seqs, "test"), test_seqs)


def write_visuals(writer: MetricsWriter, panels, est, step: int) -> None:
    """The panels' and the trajectory's images (matplotlib and PIL); the
    ``ImportError`` of a missing one goes to the caller."""
    from tcsfm_torch import vis

    triplets = panels["triplets"]
    writer.add_image("val/imgs", vis.image_grid(
        triplets.reshape((-1,) + triplets.shape[2:])), step)
    writer.add_image("val/depth",
                     vis.colorize_disparity(panels["disparities"][0]), step)
    writer.add_image("val/exp_mask",
                     vis.image_grid(panels["exp_masks"][..., None]), step)
    if est is not None:
        writer.add_image("test/pose_components",
                         vis.plot_pose_components(est, "est"), step)


def check_ranks(args, world: int, minibatch: int) -> None:
    """``--n_devices`` against the launch: 0 or its world size, and a
    global minibatch that divides over the ranks."""
    if args.n_devices not in (0, world):
        raise ValueError(
            f"--n_devices {args.n_devices}, but this launch has {world} "
            f"process(es): start one process a card with torchrun "
            f"--nproc_per_node {args.n_devices} -m tcsfm_torch.cli.train "
            f"... (the port takes its ranks from the launcher and does not "
            f"clamp --n_devices as the JAX package does)")
    if minibatch % world:
        raise ValueError(f"--minibatch {minibatch} (the global batch) does "
                         f"not divide over {world} ranks")


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    cfg = build_config(args)
    joined = dist.is_initialized()          # a caller's group stays up
    grouped = initialize_distributed(device=args.device)
    try:
        rank, world = process_info()
        check_ranks(args, world, cfg.minibatch)
        mesh = make_mesh(world, device=args.device) if grouped else None
        return _train(args, cfg, mesh, rank, world)
    finally:
        if grouped and not joined:
            dist.destroy_process_group()


def _train(args, cfg: Config, mesh, rank: int, world: int) -> Trainer:
    device = mesh.device if mesh is not None else resolve_device(args.device)
    main_rank = rank == 0
    if main_rank:
        print(f"compute dtype: {cfg.compute_dtype} (float32 parameters, "
              f"TF32 off)")
        if world > 1:
            print(f"data parallel over {world} ranks, {cfg.minibatch // world}"
                  f" of the {cfg.minibatch} rows each")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    train_ds, val_ds, test_ds, test_seqs = load_datasets(cfg, args)
    train_loader = BatchLoader(train_ds, cfg.minibatch, shuffle=True,
                               process_index=rank, process_count=world)
    val_loader = BatchLoader(val_ds, cfg.minibatch, shuffle=False,
                             process_index=rank, process_count=world)
    steps_per_epoch = max(len(train_loader), 1)

    state = create_train_state(cfg, device=device,
                               steps_per_epoch=steps_per_epoch, mesh=mesh)
    start_epoch, best_val = 0, 1e5
    if cfg.load_from_checkpoint or cfg.load_best_model:
        state, start_epoch, best_val = load_checkpoint(
            cfg.pretrained_dir or cfg.ckpt_dir, state,
            load_best=cfg.load_best_model)
        if main_rank:
            print(f"loaded checkpoint, starting at epoch {start_epoch}")
    trainer = Trainer(state, mesh=mesh)
    writer = (MetricsWriter(os.path.join(cfg.ckpt_dir, "logs"))
              if main_rank else None)
    try:
        for epoch in range(start_epoch, cfg.num_epochs):
            train_ds.reseed(epoch)
            train_losses = trainer.run_epoch(train_loader, epoch, "train")
            val_losses = trainer.run_epoch(val_loader, epoch, "val")
            if main_rank:
                for k, v in train_losses.items():
                    writer.add_scalar(f"train/{k}", v, epoch + 1)
                for k, v in val_losses.items():
                    writer.add_scalar(f"val/{k}", v, epoch + 1)

            if epoch > 0 and main_rank:
                # panels and trajectory eval (run_mono_training.py:186-221)
                panels = depth_and_reconstruction_panels(
                    cfg, state.depth_net, state.pose_net, val_ds)
                est = None
                if cfg.data_format == "odometry" and len(test_seqs):
                    est, _, errors = trajectory_eval(
                        cfg, state.depth_net, state.pose_net, test_ds,
                        test_seqs[0].gt_poses)
                    for tag, err in zip(("t_ate", "r_ate", "t_seg", "r_seg"),
                                        errors):
                        writer.add_scalar(f"test/{tag}", err, epoch + 1)
                try:
                    write_visuals(writer, panels, est, epoch + 1)
                except ImportError as e:  # visualization never stops training
                    print(f"validation visualization failed: {e}")
            if mesh is not None:         # rank 0 wrote; the rest wait
                dist.barrier()

            key_metric = (val_losses.get("l_reconstruct_forward", 0.0)
                          + val_losses.get("l_reconstruct_inverse", 0.0))
            is_best = key_metric < best_val and epoch > 0
            if is_best:
                best_val = key_metric
                if main_rank:
                    print("Lowest validation loss (saving new best model)")
            if main_rank:
                save_checkpoint(cfg.ckpt_dir, state, epoch, best_val, cfg=cfg,
                                is_best=is_best)
            if mesh is not None:         # rank 0 wrote; the rest wait
                dist.barrier()
    finally:
        if writer is not None:
            writer.close()
    if main_rank:
        print("Training complete")
    return trainer


if __name__ == "__main__":
    main()
