"""Where the coupled forward's time goes on the card.

    python -m tcsfm_torch.profile_forward [--iters 5] [--tf32]

Runs the main path (med res 192x640, B=6, S=2, 4 iterations, f32, seeded
random weights) and prints: the forward's median wall time, the device
time of each layer (depth net, pose net, sampler kernel, the rest) from
CUDA events, and, from ``torch.profiler``, the device-busy share of the
profiled window and the top device kernels. ``--tf32`` lets cuDNN
convolutions run in TF32 (PyTorch's default); without it they run in full
f32, as ``chip_smoke.py`` runs them.
Needs the card.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tcsfm_torch.config import Config
from tcsfm_torch.infer import build_models, coupled_forward
from tcsfm_torch.ops.grid_sample import grid_sample
from tcsfm_torch.solver.coupled import solve_disp, solve_pose_iteratively
from tcsfm_torch.utils.helpers import disp_to_depth


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--tf32", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = args.tf32
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = Config(iterations=4, minibatch=6)
    h, w = cfg.image_size
    b, s = cfg.minibatch, cfg.num_source_imgs
    depth_net, pose_net = build_models(cfg)
    rng = np.random.RandomState(0)
    tgt = torch.from_numpy(rng.rand(b, h, w, 3).astype(np.float32)).cuda()
    src = torch.from_numpy(rng.rand(s, b, h, w, 3).astype(np.float32)).cuda()
    K = torch.tensor([[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2.5], [0, 0, 1]],
                     device="cuda").expand(b, 3, 3).contiguous()

    # device time of each layer: CUDA events around every call (the stream
    # is serial, so an event pair spans exactly that layer's kernels)
    spans = {"depth_net": [], "pose_net": [], "sampler": []}

    def timed(name, fn):
        def wrapper(*a, **k):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            start.record()
            out = fn(*a, **k)
            end.record()
            spans[name].append((start, end))
            return out
        return wrapper

    depth_apply = timed("depth_net", depth_net)
    pose_apply = timed("pose_net", pose_net)
    sampler = timed("sampler", grid_sample)

    def run(instrumented=False):
        if not instrumented:
            return coupled_forward(depth_net, pose_net, tgt, src, K, cfg)
        with torch.no_grad():
            disps = solve_disp(depth_apply, tgt, src)
            depths = torch.stack([disp_to_depth(d[0], cfg.min_depth,
                                                cfg.max_depth)[1] for d in disps])
            return solve_pose_iteratively(cfg.iterations, depths, pose_apply,
                                          tgt, src, K, sampler=sampler)

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    med = statistics.median(times)
    print(f"{torch.cuda.get_device_name(0)}; TF32 convs {args.tf32}; forward "
          f"median {med * 1e3:.3f} ms over {len(times)} -> {b / med:.2f} "
          f"frames/s")

    total = []
    for _ in range(args.iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        run(instrumented=True)
        end.record()
        total.append((start, end))
    torch.cuda.synchronize()

    def ms(pairs):
        return sum(a.elapsed_time(z) for a, z in pairs) / args.iters

    parts = {name: ms(pairs) for name, pairs in spans.items()}
    whole = ms(total)
    print(f"device time by layer (CUDA events, ms/forward over {args.iters}):"
          f" forward {whole:.3f}")
    for name, t in parts.items():
        print(f"  {name:<10} {t:9.3f}  {t / whole:6.1%}  "
              f"{len(spans[name]) // args.iters} calls/forward")
    rest = whole - sum(parts.values())
    print(f"  {'rest':<10} {rest:9.3f}  {rest / whole:6.1%}  "
          f"(packing, disp_to_depth, projection)")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(args.iters):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    if busy_us == 0.0:
        print("the profiler recorded no device time: busy share not measured")
        return
    print(f"profiled {args.iters} forwards: wall {wall_us / args.iters / 1e3:.3f}"
          f" ms/forward, kernel time {busy_us / args.iters / 1e3:.3f} "
          f"ms/forward = {busy_us / wall_us:.1%} of wall")
    if busy_us > wall_us:
        print("kernels overlapped (their sum exceeds the wall time): device "
              "busy share not measured")
    print("top device kernels (ms/forward, calls/forward):")
    for e in sorted(kernels, key=_device_us, reverse=True)[:15]:
        print(f"  {_device_us(e) / args.iters / 1e3:8.3f} "
              f"{e.count // args.iters:4d}  {e.key[:110]}")


if __name__ == "__main__":
    main()
