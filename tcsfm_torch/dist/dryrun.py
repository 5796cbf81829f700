"""The multi-rank dry run (counterpart of ``__graft_entry__.
dryrun_multichip``): one data-parallel training step and the
window-sharded sequence BA, through the functions a multi-card launch
uses.

    python -m tcsfm_torch.dist.dryrun --cpu --processes 2
    torchrun --nproc_per_node 4 -m tcsfm_torch.dist.dryrun
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from tcsfm_torch.dist.mesh import (Mesh, initialize_distributed, launch,
                                   make_mesh, process_info,
                                   shard_process_local_batch)
from tcsfm_torch.dist.scaling import _example_batch

S, H, W = 2, 32, 64
BA_TOL = 1e-6          # sharded vs unsharded fused poses
# multi-rank vs one-process loss, relative: at this raw init the
# one-process step itself moves 1.9e-5 between 4 and 8 CPU threads (conv
# summation order), as JAX's scripts/mp_train_step.py measured ~1.6e-5
# and holds 1e-4; a wrong row, a dropped shard or per-rank BatchNorm moves
# it far more
LOSS_TOL = 1e-4


class _Rows:
    """A dataset of the windows of one example batch, for a
    ``BatchLoader``."""

    def __init__(self, batch):
        self.batch = batch

    def __len__(self):
        return self.batch["target_img"].shape[0]

    def __getitem__(self, i):
        return {k: v[:, i] if v.ndim > 1 and k.startswith("source") else v[i]
                for k, v in self.batch.items()
                if k in ("target_img", "target_img_aug", "source_imgs",
                         "source_imgs_aug", "intrinsics_aug")}


def _dryrun_config(n: int):
    from tcsfm_torch.config import Config

    return Config(iterations=2, num_scales=1, minibatch=max(n, 2))


def _state(cfg, mesh: Optional[Mesh], device):
    from tcsfm_torch.train.trainer import create_train_state

    torch.backends.cudnn.allow_tf32 = False     # the port's f32
    torch.backends.cuda.matmul.allow_tf32 = False
    return create_train_state(cfg, device=device, mesh=mesh,
                              generator=torch.Generator().manual_seed(0),
                              steps_per_epoch=10)


def one_process_loss(n_devices: int, device=None) -> float:
    """The dry run's step in one process on the whole global batch, with
    no mesh: the reference of the multi-rank loss."""
    from tcsfm_torch.train.trainer import train_step

    cfg = _dryrun_config(n_devices)
    state = _state(cfg, None, device)
    return float(train_step(state, _example_batch(cfg.minibatch, S, H, W))
                 ["total"])


def sharded_sequence_ba(mesh: Mesh, frames, depths, K, pose_fwd, pose_inv,
                        iters: int = 2):
    """``sequence_ba`` with its window axis sharded over the ranks: each
    rank refines a contiguous block of pairs with their frames (the block's
    last frame is the next block's first), then the fused poses are
    all-gathered. Returns the [N-1, 6] fused poses on every rank."""
    from tcsfm_torch.solver.ba import sequence_ba

    n = pose_fwd.shape[0]
    bounds = np.linspace(0, n, mesh.world_size + 1).round().astype(int)
    lo, hi = bounds[mesh.rank], bounds[mesh.rank + 1]
    per = int(np.diff(bounds).max())
    fused = torch.zeros(per, 6, device=mesh.device)
    if hi > lo:
        fused[:hi - lo] = sequence_ba(
            frames[lo:hi + 1], depths[lo:hi + 1], K, pose_fwd[lo:hi],
            pose_inv[lo:hi], iters=iters, device=mesh.device).fused_pose
    if mesh.group is None:
        return fused[:n]
    parts = [torch.empty_like(fused) for _ in range(mesh.world_size)]
    dist.all_gather(parts, fused, group=mesh.group)
    return torch.cat([p[:c] for p, c in zip(parts, np.diff(bounds))])


def dryrun_body(n_devices: int, device=None) -> Dict:
    """One rank's dry run: a process-sliced loader's rows through
    ``shard_process_local_batch`` into one distributed training step, then
    the window-sharded sequence BA against the unsharded call. Returns
    the step's global loss, the BA's largest difference and the counts."""
    from tcsfm_torch.data.loader import BatchLoader
    from tcsfm_torch.solver.ba import sequence_ba
    from tcsfm_torch.train.trainer import train_step

    initialize_distributed(device=device)   # no-op in a group or alone
    rank, world = process_info()
    mesh = make_mesh(n_devices, device=device)
    cfg = _dryrun_config(n_devices)
    state = _state(cfg, mesh, device)
    loader = BatchLoader(_Rows(_example_batch(cfg.minibatch, S, H, W)),
                         cfg.minibatch, shuffle=False, prefetch=0,
                         process_index=rank, process_count=world,
                         decode_threads=0)
    batch = next(iter(loader))
    batch.pop("_valid")
    losses = train_step(state, shard_process_local_batch(mesh, batch),
                        mesh=mesh)
    total = float(losses["total"])
    if not np.isfinite(total):
        raise FloatingPointError(f"non-finite loss {total}")

    rng = np.random.RandomState(1)
    n_frames = 2 * n_devices + 1            # two windows a rank
    frames = torch.from_numpy(rng.rand(n_frames, H, W, 3).astype(np.float32))
    depths = torch.from_numpy(
        (1.0 + rng.rand(n_frames, H, W, 1)).astype(np.float32))
    K = torch.tensor([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2.5], [0, 0, 1]])
    pose_fwd = torch.zeros(n_frames - 1, 6)
    pose_fwd[:, 2] = 0.01
    pose_inv = -pose_fwd
    args = [t.to(mesh.device) for t in (frames, depths, K, pose_fwd,
                                        pose_inv)]
    fused = sharded_sequence_ba(mesh, *args)
    whole = sequence_ba(*args, iters=2, device=mesh.device).fused_pose
    ba_err = (fused - whole).abs().max().item()
    if not (torch.isfinite(fused).all() and ba_err <= BA_TOL):
        raise AssertionError(f"window-sharded sequence_ba is {ba_err} from "
                             f"the unsharded call (limit {BA_TOL})")
    return {"loss": total, "ba_err": ba_err, "ba_windows": n_frames - 1,
            "rank": rank, "processes": world, "device": str(mesh.device)}


def dryrun_multichip(n_devices: int, processes: Optional[int] = None,
                     device=None) -> Dict:
    """One distributed training step over ``n_devices`` ranks, then the
    window-sharded ``sequence_ba``.

    In a process group (``torchrun``, ``mesh.launch``, a one-rank group)
    this process runs its rank's part. Outside one, ``processes`` > 1
    spawns that many ranks (``n_devices`` of them), then checks their
    loss against the same step in this one process on the global batch
    (within LOSS_TOL, relative); ``device='cpu'`` makes them gloo ranks.
    Returns rank 0's results, with the parity where it was checked."""
    if dist.is_initialized() or (processes or 1) <= 1:
        out = dryrun_body(n_devices, device)
    else:
        if processes != n_devices:
            raise ValueError(f"one rank a device: {processes} processes "
                             f"for {n_devices} devices")
        out = launch(dryrun_body, processes, (n_devices, device),
                     device=device)[0]
        single = one_process_loss(n_devices, device)
        out["mp_loss_rel_delta"] = abs(out["loss"] - single) / abs(single)
        if out["mp_loss_rel_delta"] > LOSS_TOL:
            raise AssertionError(f"{processes}-rank loss {out['loss']} vs "
                                 f"one process {single}")
    if out["rank"] == 0:
        print(f"dryrun_multichip({n_devices}) OK: " + json.dumps(out),
              flush=True)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n_devices", type=int, default=None,
                   help="default: the launch's world size, or --processes")
    p.add_argument("--processes", type=int, default=None)
    p.add_argument("--cpu", action="store_true", help="gloo ranks")
    a = p.parse_args(argv)
    device = "cpu" if a.cpu else None
    if initialize_distributed(device=device):
        dryrun_multichip(a.n_devices or process_info()[1], device=device)
        dist.destroy_process_group()
    else:
        n = a.n_devices or a.processes or 1
        dryrun_multichip(n, a.processes or 1, device)


if __name__ == "__main__":
    main()
