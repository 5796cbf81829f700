"""Weak-scaling curve of the data-parallel training step (counterpart of
``tcsfm/dist/scaling.py``): frames/s against the number of ranks at a
fixed batch a rank.

Each world size is a group of that many spawned ranks (``mesh.launch``):
cards ``0..n-1`` with NCCL, or one-thread CPU processes with gloo where
the caller asks for the CPU. Every rank runs the whole step (depth net,
coupled solver, loss, the gradients' all-reduce, Adam) on its rows, fed
through the multi-rank path (process-local rows,
``shard_process_local_batch``). On one card the curve has one row: no
other is made up. CPU processes share the host's cores, so their numbers
test the plumbing, not the efficiency.

    python -m tcsfm_torch.dist.scaling            # every card's count
    python -m tcsfm_torch.dist.scaling --cpu 1 2  # gloo ranks
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tcsfm_torch.dist.mesh import launch, make_mesh, process_info


def _example_batch(b, s, h, w, seed=0):
    rng = np.random.RandomState(seed)
    K = np.array([[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2.5], [0, 0, 1]],
                 np.float32)
    return {
        "target_img": rng.rand(b, h, w, 3).astype(np.float32),
        "target_img_aug": rng.rand(b, h, w, 3).astype(np.float32),
        "source_imgs": rng.rand(s, b, h, w, 3).astype(np.float32),
        "source_imgs_aug": rng.rand(s, b, h, w, 3).astype(np.float32),
        "intrinsics": np.broadcast_to(K, (b, 3, 3)).copy(),
        "intrinsics_aug": np.broadcast_to(K, (b, 3, 3)).copy(),
        "gt_lie_alg": np.zeros((s, b, 6), np.float32),
        "gt_lie_alg_aug": np.zeros((s, b, 6), np.float32),
        "vo_lie_alg": np.zeros((s, b, 6), np.float32),
        "vo_lie_alg_aug": np.zeros((s, b, 6), np.float32),
        "dt": np.full((s, b), 0.1, np.float32),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mean_ms(fn, device: torch.device, reps: int = 10) -> float:
    """Mean wall ms of ``fn()`` over ``reps`` calls, the card drained before
    and after."""
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def step_seconds(batch_per_device: int, image_hw, iterations: int,
                 timed_steps: int, sources: int, device=None,
                 compute_dtype: str = "float32") -> Dict:
    """One rank's part of a scaling row: the mean seconds of a training step
    on the rank's rows, after one untimed step, and the mean ms of the
    step's collectives alone: the gradients' all-reduce (one bucket) and
    one small all-reduce (a BatchNorm layer's sums). Runs in a launched
    rank. The networks compute in ``compute_dtype``."""
    from tcsfm_torch.config import Config
    from tcsfm_torch.dist.mesh import shard_process_local_batch
    from tcsfm_torch.train.trainer import (all_reduce_grads,
                                           create_train_state, train_step)

    # float32 is float32: TF32 off (a spawned rank starts with torch's
    # defaults, which let cuDNN convolve in TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = process_info()
    mesh = make_mesh(world, device=device)
    h, w = image_hw
    cfg = Config(iterations=iterations, num_scales=1,
                 minibatch=batch_per_device * world,
                 compute_dtype=compute_dtype)
    state = create_train_state(cfg, mesh=mesh,
                               generator=torch.Generator().manual_seed(0),
                               steps_per_epoch=100)
    # each rank's rows of the global batch, as a process-sliced loader
    # gives them
    batch = shard_process_local_batch(mesh, _example_batch(
        batch_per_device, sources, h, w, seed=rank))
    losses = train_step(state, batch, mesh=mesh)        # warm-up
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        losses = train_step(state, batch, mesh=mesh)
    total = float(losses["total"])                      # waits for the card
    dt = (time.perf_counter() - t0) / timed_steps
    if not np.isfinite(total):
        raise FloatingPointError(f"non-finite loss {total} at {world} ranks")
    small = torch.zeros(65, device=mesh.device)
    return {"step_s": dt,
            "grads_ms": _mean_ms(lambda: all_reduce_grads(
                mesh, state.depth_net, state.pose_net), mesh.device),
            "small_ms": _mean_ms(lambda: mesh.all_reduce(small),
                                 mesh.device)}


def measure_scaling(world_sizes: Optional[Sequence[int]] = None,
                    batch_per_device: int = 2, image_hw=(32, 64),
                    iterations: int = 2, timed_steps: int = 3,
                    sources: int = 2, device=None,
                    compute_dtype: str = "float32",
                    verbose: bool = True) -> List[Dict]:
    """Weak-scaling curve of the data-parallel step, the networks in
    ``compute_dtype`` (float32 by default, as ``tcsfm/dist/scaling.py:53``).

    ``world_sizes`` None takes 1, 2, 4, 8 up to the cards present (CPU:
    1 and 2). Returns one dict per world size: {n_devices, global_batch,
    step_ms, frames_per_s, efficiency}, where efficiency = (frames/s at n)
    / (n x frames/s a rank at the first size). Raises where more cards are
    asked for than there are.
    """
    cpu = device is not None and torch.device(device).type == "cpu"
    n_avail = 2 if cpu else torch.cuda.device_count()
    if world_sizes is None:
        world_sizes = [n for n in (1, 2, 4, 8) if n <= max(n_avail, 1)]
    if not cpu:
        missing = [n for n in world_sizes if n > n_avail]
        if missing:
            raise ValueError(f"world sizes {missing} need more than the "
                             f"{n_avail} cards present")
    parts: Dict[int, List[Dict]] = {}
    for n in world_sizes:
        parts[n] = launch(step_seconds, n, (batch_per_device,
                                            tuple(image_hw), iterations,
                                            timed_steps, sources, device,
                                            compute_dtype),
                          device=device)
        if verbose:
            r = scaling_rows(parts, batch_per_device)[-1]
            print(f"n={n:3d}  batch={r['global_batch']:3d}  "
                  f"{r['step_ms']:9.3f} ms/step  {r['frames_per_s']:9.3f} "
                  f"f/s  eff={r['efficiency']:.3f}  alone: gradients' "
                  f"all-reduce {max(p['grads_ms'] for p in parts[n]):.3f} "
                  f"ms, one small all-reduce "
                  f"{max(p['small_ms'] for p in parts[n]):.3f} ms",
                  flush=True)
    return scaling_rows(parts, batch_per_device)


def scaling_rows(parts: Dict[int, List[Dict]],
                 batch_per_device: int) -> List[Dict]:
    """The curve's rows from each world size's ranks' ``step_seconds``
    results (``{n: [rank 0's, ..., rank n-1's]}``, in the curve's order):
    the step ends on its last rank, and efficiency is against the first
    size's frames/s a rank."""
    rows: List[Dict] = []
    base = None
    for n, ranks in parts.items():
        dt = max(p["step_s"] for p in ranks)
        b_global = batch_per_device * n
        fps = b_global / dt
        if base is None:
            base = fps / n
        rows.append({"n_devices": n, "global_batch": b_global,
                     "step_ms": dt * 1e3, "frames_per_s": fps,
                     "efficiency": fps / (n * base)})
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("world_sizes", nargs="*", type=int)
    p.add_argument("--cpu", action="store_true",
                   help="gloo ranks on the CPU instead of cards")
    p.add_argument("--batch_per_device", type=int, default=2)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--iterations", type=int, default=4)
    p.add_argument("--timed_steps", type=int, default=5)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    a = p.parse_args(argv)
    measure_scaling(a.world_sizes or None, a.batch_per_device,
                    (a.height, a.width), a.iterations, a.timed_steps,
                    device="cpu" if a.cpu else None,
                    compute_dtype=a.compute_dtype)


if __name__ == "__main__":
    main()
