"""Self-supervised training (counterpart of ``tcsfm/train/trainer.py``).

One training step: the depth net over target + sources (BatchNorm in train
mode unless the depth net is frozen; both nets compute in
``cfg.compute_dtype`` on float32 parameters, so the gradients and Adam's
state are float32 in either dtype, as under the JAX package's
``compute_dtype``) → ``disp_to_depth`` → the coupled
pose solver, differentiated through its 3 pose-only warps (each iteration
recomputed in the backward with ``cfg.remat_coupled``, the default, as in
JAX: 2 more value launches a step) → the loss stack
and the pose-consistency term → gradients of ``total`` → Adam with the
halving schedule, the pose net at ``pose_lr_mult`` times the depth lr. The
BatchNorm running statistics move during the forward (Flax's rule,
``models.layers.BatchNorm2d``).

Batches are dicts in the layout of the JAX package's loaders and
``bench.py``: ``target_img``/``target_img_aug`` [B,H,W,3],
``source_imgs``/``source_imgs_aug`` [S,B,H,W,3] and ``intrinsics_aug``
[B,3,3], tensors or numpy arrays. The augmented stream feeds the networks
and the warps' intrinsics, the clean one the photometric loss.

``create_train_state`` runs on the card unless ``device="cpu"``; with no
card it raises. The step runs where the state's networks are.

Data parallelism (``mesh``, from ``tcsfm_torch.dist.make_mesh``): each rank
steps on its rows of the global batch and the step computes what the JAX
package's step computes on the whole of it. The depth net's BatchNorm
takes global statistics (``models.layers.global_batch_stats``), each rank
backprops its share of the global loss (``losses.photometric``), one
all-reduce sums the gradients (one flat bucket), and Adam runs alike on
every rank. The nets are not wrapped in ``DistributedDataParallel``: its
gradient averaging and buffer broadcast do not fit this loss. The reported
losses are the global batch's on every rank.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tcsfm_torch.config import Config
from tcsfm_torch.dist.mesh import Mesh, shard_process_local_batch
from tcsfm_torch.geom.warp import Sampler
from tcsfm_torch.infer import build_models
from tcsfm_torch.losses.photometric import (compute_losses,
                                            pose_consistency_loss, share)
from tcsfm_torch.models.depth import DepthNet
from tcsfm_torch.models.layers import global_batch_stats
from tcsfm_torch.models.pose import PoseNet
from tcsfm_torch.ops.grid_sample import grid_sample
from tcsfm_torch.solver.coupled import solve_disp, solve_pose_iteratively
from tcsfm_torch.train.schedule import halving_schedule
from tcsfm_torch.utils.helpers import disp_to_depth

Losses = Dict[str, torch.Tensor]
BATCH_KEYS = ("target_img", "target_img_aug", "source_imgs",
              "source_imgs_aug", "intrinsics_aug")


@dataclass
class TrainState:
    """The networks, their optimizer (None when both are frozen) and the
    number of steps taken."""

    cfg: Config
    depth_net: DepthNet
    pose_net: PoseNet
    optimizer: Optional[torch.optim.Optimizer]
    steps_per_epoch: int = 1000
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.depth_net.parameters()).device


def make_optimizer(cfg: Config, depth_net: DepthNet, pose_net: PoseNet
                   ) -> Optional[torch.optim.Optimizer]:
    """Adam (AdamW when ``cfg.wd > 0``) over a depth group at ``cfg.lr`` and
    a pose group at ``cfg.pose_lr_mult * cfg.lr``; a frozen net is left
    out. Each group keeps its base lr as ``base_lr``; ``apply_gradients``
    sets ``lr`` from the halving schedule before every update. The
    defaults are optax's: betas (0.9, 0.999), eps 1e-8."""
    groups = []
    if not cfg.freeze_depthnet:
        groups.append({"name": "depth", "params": list(depth_net.parameters()),
                       "base_lr": cfg.lr})
    if not cfg.freeze_posenet:
        groups.append({"name": "pose", "params": list(pose_net.parameters()),
                       "base_lr": cfg.pose_lr_mult * cfg.lr})
    if not groups:
        return None
    for g in groups:
        g["lr"] = g["base_lr"]
    if cfg.wd:
        return torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.wd)
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(cfg: Config, device=None,
                       generator: Optional[torch.Generator] = None,
                       steps_per_epoch: int = 1000,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """Seeded networks (``infer.build_models``) on ``device`` (None = the
    card; the mesh's device where a mesh is given) and their optimizer; a
    frozen net's parameters need no grad. With a mesh in a group, rank 0's
    parameters and BatchNorm statistics are broadcast to every rank."""
    if mesh is not None:
        device = mesh.device
    depth_net, pose_net = build_models(cfg, device=device, generator=generator)
    if mesh is not None and mesh.group is not None:
        with torch.no_grad():
            for net in (depth_net, pose_net):
                for t in list(net.parameters()) + list(net.buffers()):
                    dist.broadcast(t, src=0, group=mesh.group)
    depth_net.requires_grad_(not cfg.freeze_depthnet)
    pose_net.requires_grad_(not cfg.freeze_posenet)
    return TrainState(cfg, depth_net, pose_net,
                      make_optimizer(cfg, depth_net, pose_net),
                      steps_per_epoch=steps_per_epoch)


def _to_device(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    def put(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(device=device, dtype=torch.float32).contiguous()

    return {k: put(batch[k]) for k in BATCH_KEYS}


def _global_moments(x: torch.Tensor, mesh: Optional[Mesh]):
    """Mean and biased standard deviation of ``x`` over the global batch,
    in ``x``'s dtype; a bfloat16 ``x``'s reduced in float32, as
    ``jnp.mean`` and ``jnp.std`` reduce it."""
    if mesh is None or mesh.world_size == 1:
        return x.mean(), x.std(correction=0)      # jnp.std is biased
    xf = x.float()
    sums = mesh.all_reduce(torch.stack([xf.sum(),
                                        xf.new_full((), x.numel())]))
    mean = sums[0] / sums[1]
    sq = mesh.all_reduce((xf - mean).square().sum())
    return mean.to(x.dtype), torch.sqrt(sq / sums[1]).to(x.dtype)


def forward_loss(cfg: Config, depth_net: DepthNet, pose_net: PoseNet,
                 batch: Dict[str, torch.Tensor], train: bool,
                 sampler: Sampler = grid_sample,
                 mesh: Optional[Mesh] = None
                 ) -> Tuple[Losses, Tuple[torch.Tensor, torch.Tensor, list]]:
    """The train/val forward (trainer.py:107-164): losses, then (poses,
    poses_inv, disparities). ``train`` puts the depth net's BatchNorm in
    train mode unless the depth net is frozen, and recomputes the coupled
    iterations in the backward when ``cfg.remat_coupled``. With a mesh the
    batch is this rank's rows, BatchNorm takes the global batch's
    statistics, each loss term is this rank's share of the global one
    (they sum over the ranks to it), and ``mean_disp``/``std_disp`` are
    the global batch's."""
    depth_net.train(train and not cfg.freeze_depthnet)
    tgt_aug = batch["target_img_aug"]
    src_aug = batch["source_imgs_aug"]
    K_aug = batch["intrinsics_aug"]

    with global_batch_stats(depth_net, mesh):
        disparities = solve_disp(depth_net, tgt_aug, src_aug)
    depths = torch.stack([disp_to_depth(d[0], cfg.min_depth, cfg.max_depth)[1]
                          for d in disparities])
    poses, poses_inv, _ = solve_pose_iteratively(
        cfg.iterations, depths, pose_net, tgt_aug, src_aug, K_aug,
        sampler=sampler, remat=train and cfg.remat_coupled)
    losses = compute_losses(cfg, batch["source_imgs"], batch["target_img"],
                            poses, poses_inv, disparities, K_aug,
                            sampler=sampler, mesh=mesh)
    if cfg.l_pose_consist:
        losses["l_pose_consist"] = (
            cfg.l_pose_consist_weight * pose_consistency_loss(poses, poses_inv)
            * share(mesh))
        losses["total"] = losses["total"] + losses["l_pose_consist"]
    # depth-collapse diagnostics, both sigmoid tails (read by run_epoch)
    losses["mean_disp"], losses["std_disp"] = _global_moments(
        disparities[0][0].detach(), mesh)
    return losses, (poses, poses_inv, disparities)


GLOBAL_KEYS = ("mean_disp", "std_disp")    # forward_loss's global values


def reported(losses: Losses, mesh: Optional[Mesh]) -> Losses:
    """The detached losses of the global batch: with a mesh, the ranks'
    shares summed (one all-reduce), on every rank."""
    out = {k: v.detach() for k, v in losses.items()}
    if mesh is None:
        return out
    keys = [k for k in out if k not in GLOBAL_KEYS]
    sums = mesh.all_reduce(torch.stack([out[k] for k in keys]))
    out.update(zip(keys, sums.unbind()))
    return out


def all_reduce_grads(mesh: Mesh, *nets: torch.nn.Module) -> None:
    """Sum the nets' parameter gradients over the ranks in one flat bucket:
    each rank's are those of its share of the global loss, so the sum is
    the global batch's gradient. A parameter with no gradient has none on
    any rank (the ranks run one graph) and keeps none."""
    params = [p for net in nets for p in net.parameters()
              if p.grad is not None]
    if mesh.group is None or not params:
        return
    flat = mesh.all_reduce(torch.cat([p.grad.reshape(-1) for p in params]))
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p.grad))


def apply_gradients(state: TrainState) -> None:
    """One optimizer update from the parameters' ``.grad``, at each group's
    scheduled lr for the current step; then count the step."""
    if state.optimizer is not None:
        for g in state.optimizer.param_groups:
            g["lr"] = halving_schedule(g["base_lr"], state.steps_per_epoch,
                                       state.cfg.lr_decay_epoch)(state.step)
        state.optimizer.step()
    state.step += 1


def train_step(state: TrainState, batch, sampler: Sampler = grid_sample,
               mesh: Optional[Mesh] = None) -> Losses:
    """One training step in place on ``state``; returns the detached losses.
    The gradients stay in the parameters' ``.grad`` until the next step.
    With a mesh, ``batch`` is this rank's rows, the gradients are summed
    over the ranks before Adam (the global batch's), and the losses are
    the global batch's."""
    batch = _to_device(batch, state.device)
    if state.optimizer is not None:
        state.optimizer.zero_grad(set_to_none=True)
    losses, _ = forward_loss(state.cfg, state.depth_net, state.pose_net,
                             batch, train=True, sampler=sampler, mesh=mesh)
    if state.optimizer is not None:
        losses["total"].backward()
        if mesh is not None:
            all_reduce_grads(mesh, state.depth_net, state.pose_net)
    apply_gradients(state)
    return reported(losses, mesh)


@torch.no_grad()
def eval_step(state: TrainState, batch, sampler: Sampler = grid_sample,
              mesh: Optional[Mesh] = None) -> Losses:
    """The losses with eval-mode BatchNorm and no gradients (with a mesh,
    the global batch's)."""
    losses, _ = forward_loss(state.cfg, state.depth_net, state.pose_net,
                             _to_device(batch, state.device), train=False,
                             sampler=sampler, mesh=mesh)
    return reported(losses, mesh)


class Trainer:
    """Runs epochs of train or eval steps (trainer.py:193-242). With a
    mesh each loader batch is this rank's rows (a process-sliced
    ``BatchLoader``; with one rank, the whole batch)."""

    def __init__(self, state: TrainState, mesh: Optional[Mesh] = None):
        self.state = state
        self.mesh = mesh

    def run_epoch(self, loader: Iterable[dict], epoch: int,
                  phase: str = "train") -> Dict[str, float]:
        start = time.time()
        running: Dict[str, float] = {}
        n = 0
        for batch in loader:
            if self.mesh is not None:
                batch.pop("_valid", None)
                batch = shard_process_local_batch(self.mesh, batch)
            if phase == "train":
                losses = train_step(self.state, batch, mesh=self.mesh)
            else:
                losses = eval_step(self.state, batch, mesh=self.mesh)
            n += 1
            for k, v in losses.items():
                running[k] = running.get(k, 0.0) + float(v)
        for k in running:
            running[k] /= max(n, 1)
        if self.mesh is not None and self.mesh.rank != 0:
            return running          # rank 0 prints for the launch
        print(f"{phase} epoch {epoch} done in {time.time() - start:.1f}s "
              f"loss {running.get('total', float('nan')):.6f}")
        # the reference's depth-collapse guard (train_mono.py:168-169), both
        # sigmoid tails: a saturated disparity freezes all depth gradients
        std = running.get("std_disp", 1.0)
        mean = running.get("mean_disp", 0.5)
        if std < 1e-6 or mean < 1e-6 or mean > 1.0 - 1e-6:
            print(f"warning - depth est has failed (mean disp {mean:.3g}, "
                  f"std {std:.3g}): sigmoid saturated, depth gradients are "
                  f"zero. Lower the lr or warm-start the encoder.")
        return running
