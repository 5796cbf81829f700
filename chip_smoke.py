#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its elapsed seconds:
  0. watchdog, card name and power limit, torch and CUDA versions;
  1. build the CUDA kernels from ``tcsfm_torch/ops/csrc`` (nvcc + ctypes);
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes, with times (kernel, plain, one PyTorch library call)
     and the kernel's memory/compute bound;
  3. the main path: the coupled depth-pose forward at med res 192x640,
     B=6, S=2, 4 iterations, f32, full-width networks with seeded random
     weights; kernel launch counts, the same forward with the plain
     sampler, frames/s and peak memory;
  4. the same forward on the card and on the CPU at a small input, with
     trained-like weights (``condition_like_trained``).

Prints the kernels' JSON line, then, as the last line,
``{"ok": true, "device": {...}}``. Any failed check raises and exits
non-zero; a hang past the watchdog dumps a traceback and exits non-zero.
Reads no data files: inputs and weights come from seeds.
"""

from __future__ import annotations

import faulthandler
import json
import statistics
import subprocess
import sys
import time

WATCHDOG_S = 540
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
H, W, B, S, ITERS = 192, 640, 6, 2, 4
KERNEL_TOL = 1e-5             # kernel vs plain: same arithmetic, same order
CHAIN_TOL = 1e-5              # kernel- vs plain-sampler forward, pose chain
DISP_TOL = 1e-6               # the two forwards run identical convs
CPU_TOL = 1e-5                # card vs CPU: other conv algorithms and orders

T0 = time.monotonic()


def say(phase: str, msg: str) -> None:
    print(f"[{time.monotonic() - T0:7.2f}s] {phase}: {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def smoke_coords(b: int, h: int, w: int, seed: int):
    """Mostly in-view, off-integer coords; 5% pushed to exactly 2.0 and 5%
    just outside +-1 (border taps)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    base = np.stack([(2 * xs + 1) / w - 1, (2 * ys + 1) / h - 1], -1)
    c = base[None] + rng.uniform(-0.05, 0.05, (b, h, w, 2))
    u = rng.rand(b, h, w)
    axis = rng.randint(0, 2, (b, h, w))
    pushed = u < 0.05
    c[pushed & (axis == 0), 0] = 2.0
    c[pushed & (axis == 1), 1] = 2.0
    edge = (u >= 0.05) & (u < 0.10)
    side = rng.choice([-1.0, 1.0], (b, h, w))
    c[..., 0] = np.where(edge & (axis == 0),
                         side * (1.0 + rng.uniform(0, 1.5 / w, (b, h, w))),
                         c[..., 0])
    c[..., 1] = np.where(edge & (axis == 1),
                         side * (1.0 + rng.uniform(0, 1.5 / h, (b, h, w))),
                         c[..., 1])
    return c.astype(np.float32)


def phase_kernels(torch, gs):
    """Kernel vs plain at [24,192,640,C], C=3 (main path) and C=4."""
    import numpy as np
    import torch.nn.functional as F

    n = 2 * S * B
    coords = torch.from_numpy(smoke_coords(n, H, W, seed=1)).cuda()
    rows = {}
    for c in (3, 4):
        img = torch.from_numpy(
            np.random.RandomState(c).rand(n, H, W, c).astype(np.float32)).cuda()
        out = gs.grid_sample(img, coords)
        ref = gs.grid_sample_plain(img, coords)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        check(err <= KERNEL_TOL, f"grid_sample C={c}: kernel vs plain "
              f"max abs err {err} > {KERNEL_TOL}")
        lib_img = img.permute(0, 3, 1, 2)

        def library():
            return F.grid_sample(lib_img, coords, mode="bilinear",
                                 padding_mode="zeros", align_corners=False)

        lib_err = (library().permute(0, 2, 3, 1) - out).abs().max().item()
        ms = time_ms(lambda: gs.grid_sample(img, coords))
        plain_ms = time_ms(lambda: gs.grid_sample_plain(img, coords), iters=10)
        library_ms = time_ms(library)
        nbytes = (img.numel() + coords.numel() + out.numel()) * 4
        flops = n * H * W * (18 + 7 * c)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        rows[c] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms,
                       bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                       library_ms=library_ms)
        say("kernels", f"grid_sample [{n},{H},{W},{c}]: max|kernel-plain| "
            f"{err:.3e} (limit {KERNEL_TOL}), max|kernel-F.grid_sample| "
            f"{lib_err:.3e}; kernel {ms * 1e3:.2f} us, plain "
            f"{plain_ms * 1e3:.2f} us, F.grid_sample {library_ms * 1e3:.2f} us;"
            f" bound {bound_ms * 1e3:.2f} us ({rows[c]['bound_by']}: "
            f"{nbytes / 1e6:.2f} MB), kernel at {bound_ms / ms:.1%} of bound")
    return rows


def smoke_inputs(b, s, h, w, seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    K = np.array([[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2.5], [0, 0, 1]],
                 np.float32)
    return (rng.rand(b, h, w, 3).astype(np.float32),
            rng.rand(s, b, h, w, 3).astype(np.float32),
            np.broadcast_to(K, (b, 3, 3)).copy())


def phase_slice(torch, gs, cfg, build_models, coupled_forward):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say("slice", "TF32 off for convolutions and matmuls (full f32)")
    depth_net, pose_net = build_models(
        cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    tgt, src, K = (torch.from_numpy(a).cuda()
                   for a in smoke_inputs(B, S, H, W, seed=0))

    torch.cuda.reset_peak_memory_stats()
    gs.LAUNCHES = 0
    poses, poses_inv, disp, chain = coupled_forward(
        depth_net, pose_net, tgt, src, K, cfg)
    torch.cuda.synchronize()
    launches = gs.LAUNCHES
    check(launches == ITERS - 1, f"grid_sample kernel launched {launches} "
          f"times in one coupled forward, expected {ITERS - 1}")
    say("slice", f"main path: grid_sample kernel launches {launches} "
        f"(expected {ITERS - 1}) in one coupled forward")

    shapes = {"poses": (S, B, 6), "poses_inv": (S, B, 6),
              "disp": (B, H, W, 1), "chain": (2 * S * B, ITERS, 6)}
    for name, t in zip(shapes, (poses, poses_inv, disp, chain)):
        check(tuple(t.shape) == shapes[name],
              f"{name} shape {tuple(t.shape)} != {shapes[name]}")
        check(bool(torch.isfinite(t).all()), f"{name} has non-finite values")

    _, _, disp_p, chain_p = coupled_forward(
        depth_net, pose_net, tgt, src, K, cfg, sampler=gs.grid_sample_plain)
    chain_err = (chain - chain_p).abs().max().item()
    disp_err = (disp - disp_p).abs().max().item()
    check(chain_err <= CHAIN_TOL, f"pose chain kernel vs plain sampler "
          f"{chain_err} > {CHAIN_TOL}")
    check(disp_err <= DISP_TOL, f"disparity differs between the two "
          f"forwards by {disp_err} > {DISP_TOL}")
    say("slice", f"plain-sampler forward: max|chain diff| {chain_err:.3e} "
        f"(limit {CHAIN_TOL}), max|disp diff| {disp_err:.3e} (limit "
        f"{DISP_TOL}); outputs finite, shapes {list(shapes.values())}")

    for _ in range(3):
        coupled_forward(depth_net, pose_net, tgt, src, K, cfg)
    torch.cuda.synchronize()
    times = []
    for _ in range(15):
        t = time.perf_counter()
        coupled_forward(depth_net, pose_net, tgt, src, K, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    med = statistics.median(times)
    say("slice", f"coupled forward {H}x{W} B={B} S={S} iters={ITERS} f32: "
        f"median {med * 1e3:.3f} ms over {len(times)} (min "
        f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}) -> "
        f"{B / med:.2f} frames/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return launches


def condition_like_trained(depth_net, torch) -> None:
    """Make random depth-net weights behave as a trained model's do:
    variance-preserving decoder kernels (std 1/sqrt(fan_in)) and a
    far-field disparity head (bias -3, depths near 1). At the raw random
    init the sigmoid heads saturate and the 4-iteration solver amplifies
    f32 rounding ~20x an iteration through its discontinuous valid mask,
    so two correct f32 evaluations need not agree there."""
    with torch.no_grad():
        for name, m in depth_net.named_modules():
            if isinstance(m, torch.nn.Conv2d) and not name.startswith("encoder"):
                o, i = m.weight.shape[:2]
                m.weight.mul_((o / (2.0 * i)) ** 0.5)
                if name.startswith("predict_disps"):
                    m.bias.sub_(3.0)


def smooth_inputs(torch, b, s, h, w, seed):
    """Images bilinear from a 9x13 random grid (smooth, like photographs)."""
    import numpy as np
    import torch.nn.functional as F

    rng = np.random.RandomState(seed)
    lo = torch.from_numpy(rng.rand((s + 1) * b, 3, 9, 13))
    up = F.interpolate(lo, size=(h, w), mode="bilinear", align_corners=True)
    imgs = up.permute(0, 2, 3, 1).float().numpy()
    K = np.array([[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2.5], [0, 0, 1]],
                 np.float32)
    return (imgs[:b], imgs[b:].reshape(s, b, h, w, 3),
            np.broadcast_to(K, (b, 3, 3)).copy())


def phase_cpu_reference(torch, cfg, build_models, coupled_forward):
    """The same small forward on the card (kernel) and on the CPU (plain
    sampler), the CPU port being the one the tests hold against JAX."""
    import copy

    b, s, h, w = 2, 2, 64, 96
    d_cpu, p_cpu = build_models(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(1))
    condition_like_trained(d_cpu, torch)
    d_gpu, p_gpu = copy.deepcopy(d_cpu).cuda(), copy.deepcopy(p_cpu).cuda()
    inputs = smooth_inputs(torch, b, s, h, w, seed=2)
    _, _, disp_c, chain_c = coupled_forward(d_cpu, p_cpu, *inputs, cfg,
                                            device="cpu")
    _, _, disp_g, chain_g = coupled_forward(d_gpu, p_gpu, *inputs, cfg)
    per_iter = (chain_g.cpu() - chain_c).abs().amax(dim=(0, 2)).tolist()
    disp_err = (disp_g.cpu() - disp_c).abs().max().item()
    check(max(per_iter) <= CPU_TOL and disp_err <= CPU_TOL,
          f"card vs CPU at {h}x{w}: chain per iteration {per_iter}, disp "
          f"{disp_err} > {CPU_TOL}")
    say("reference", f"{h}x{w} B={b} S={s}, trained-like conditioning: card "
        f"vs CPU max|chain diff| per iteration "
        f"{[f'{e:.2e}' for e in per_iter]}, max|disp diff| {disp_err:.2e} "
        f"(limit {CPU_TOL})")


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from tcsfm_torch.config import Config
    from tcsfm_torch.infer import build_models, coupled_forward
    from tcsfm_torch.ops import _build
    from tcsfm_torch.ops import grid_sample as gs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    say("setup", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t = time.monotonic()
    lib = _build.build()
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            say("build", line.strip())
    _build.load()
    say("build", f"{lib.relative_to(_build.BUILD_ROOT.parents[1])}, nvcc "
        f"{_build.build_seconds:.2f} s")

    say("build", f"phase took {time.monotonic() - t:.2f} s")

    t = time.monotonic()
    rows = phase_kernels(torch, gs)
    say("kernels", f"phase took {time.monotonic() - t:.2f} s")
    cfg = Config(iterations=ITERS, num_scales=1, minibatch=B,
                 img_resolution="med")
    check(cfg.image_size == (H, W), f"med res is {cfg.image_size}")
    t = time.monotonic()
    launches = phase_slice(torch, gs, cfg, build_models, coupled_forward)
    say("slice", f"phase took {time.monotonic() - t:.2f} s")
    t = time.monotonic()
    phase_cpu_reference(torch, cfg, build_models, coupled_forward)
    say("reference", f"phase took {time.monotonic() - t:.2f} s")

    kernels = [dict(name="grid_sample_fwd", route="cuda",
                    source="tcsfm_torch/ops/csrc/grid_sample.cu",
                    replaces="tcsfm/ops/warp_mxu.py:470",
                    launches=launches, **rows[3])]
    print(json.dumps({"kernels": kernels}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
