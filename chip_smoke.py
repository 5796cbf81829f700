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
     trained-like weights (``condition_like_trained``);
  5. the second main path: the training step at the same shape (solver,
     loss stack, gradients through both backward kernels, Adam), with
     launch counts, step time, frames/s, peak memory, and the same step
     with the plain sampler from the same state;
  6. one training step on the card and on the CPU at a small input;
  7. the third main path: the photometric refiners at full resolution
     (``scripts/bench_refiners.py``'s bodies): the coupled forward at B=4,
     S=2, 2 iterations, then ``window_ba`` (10 LM iterations) or
     ``gauss_newton_pose`` (10); and ``chain_ba`` on a 12-frame block
     with a 2-level pyramid; launch counts, falling costs, the same calls
     with the plain sampler, ms per window and peak memory;
  8. ``window_ba`` and ``gauss_newton_pose`` on the card and on the CPU at
     a small input;
  9. the fourth main path: the coupled forward of phase 3 with its depth
     net through the fused decoder tail (``make_tail_apply``): launch
     counts, the disparity against the default route at the raw init
     (and both routes against a float64 tail), the pose chain against the
     default route under trained-like conditioning, frames/s of both
     routes in turns, and peak memory.

Phase 2 also holds the sampler's two backward kernels (d_coords only,
and d_coords + d_img), its value+Jacobian kernel and the decoder tail
kernel against their plain versions.
Prints the kernels' JSON line, then, as the last line,
``{"ok": true, "device": {...}}``. Any failed check raises and exits
non-zero; a hang past the watchdog dumps a traceback and exits non-zero.
Reads no data files: inputs and weights come from seeds.
"""

from __future__ import annotations

import contextlib
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
BWD_COORDS_TOL = 1e-5         # of d_coords' largest magnitude: same order
BWD_IMG_TOL = 1e-5            # d_img: atomics add in a changing order
STEP_LOSS_TOL = 1e-6          # kernel- vs plain-sampler step: same forward
STEP_GRAD_TOL = 1e-4          # relative L2 per gradient tensor
# the plain-sampler step's own spread s (relative L2, per tensor): how far
# its gradients move when the same step runs again with its loss scaled one
# ulp above and one ulp below 1 (and the gradients scaled back), so that
# every sum of its backward rounds differently; cuDNN deterministic. A
# tensor is held at max(STEP_GRAD_TOL, STEP_SPREAD_FACTOR * s): at
# STEP_GRAD_TOL where the plain step reproduces itself to a quarter of it,
# elsewhere at a bound computed in the same run from that spread, and never
# above STEP_GRAD_CAP. At most STEP_GRAD_MAX_WIDENED of the 113 tensors may
# be held above STEP_GRAD_TOL. Over 50 runs on the card (the three settings
# of step_grad_parity, 10 states each, and 20 in phase "train") the kernel
# step came at most 5.95e-4 from the plain one (where the spread was
# 7.26e-4) and at most 13 tensors were widened
STEP_SPREAD_FACTOR = 4
STEP_GRAD_CAP = 1e-3
STEP_GRAD_MAX_WIDENED = 20
# the settings of phase "train"'s comparison: the config's defaults, and
# with the loss's depth terms on (the d_img kernel then launches)
STEP_GRAD_VARIANTS = (("defaults", {}),
                      ("depth terms on", dict(l_depth_consist=True,
                                              with_depth_mask=True)))
STEP_LOSS_SCALES = (1.0 + 2.0 ** -23, 1.0 - 2.0 ** -24)
REF_LOSS_TOL = 1e-5           # train step, card vs CPU, f32
# f32 resolves this loss's gradient only to ~1e-2 relative L2 (abs() of
# near-equal neighbours flips sign under rounding; measured on the CPU:
# the port's and JAX's f32 gradients are each up to 1e-2 from float64), so
# card vs CPU is held there at 5e-2 in f32, and at 1e-4 in float64
REF_GRAD_TOL_F32 = 5e-2
REF_GRAD_TOL_F64 = 1e-4
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
# the refiners: scripts/bench_refiners.py's shapes, window batch 4
RB, RITERS, BLOCK, REFINE_TIMED = 4, 2, 12, 3
GRADS_TOL = 1e-5              # gx, gy: of their largest magnitude
REF_POSE_TOL = 1e-5           # kernel- vs plain-sampler refiner: poses,
REF_DEPTH_TOL = 1e-5          # depths (relative to the largest) and
REF_COST_TOL = 1e-6           # costs (relative): the kernels are bit-equal
# to their plain twins, whose jvp does the same f32 arithmetic
# (value launches, value+Jacobian launches) of one refiner call, iters=10:
# _gn_blocks takes 1 value and 7 jvp launches, a cost evaluation 1 value
# launch per residual family (window_ba 2 families, gauss_newton_pose 1,
# chain_ba 3 per level, the coarse level 6 iterations)
REFINER_LAUNCHES = {"ba": (44, 154), "gn": (21, 60), "chain": (102, 336)}
CHAIN_TOL = 1e-5              # kernel- vs plain-sampler forward, pose chain
DISP_TOL = 1e-6               # the two forwards run identical convs
CPU_TOL = 1e-5                # card vs CPU: other conv algorithms and orders
TAIL_TOL = 1e-5               # tail kernel vs plain, on the sigmoid output:
# the same f32 convs summed in another order
# the disparity of the tail route vs the default (cuDNN) route: at the raw
# init f32 resolves the disparity only to ~2e-4 (ROADMAP §3; the tail alone
# is 3.3e-5 from float64 at 96x160 on the CPU), so 5e-4, the raw-init bound
# of tests/test_torch_models.py; under trained-like conditioning 1e-5
TAIL_DISP_TOL_RAW = 5e-4
TAIL_DISP_TOL = 1e-5
# the pose chain, trained-like, tail vs default route: 1e-5 at 64x96, where
# f32 resolves the solver (card vs CPU 2e-7 there). At 192x640 it does not:
# phase "tail" runs five smooth inputs through both routes and through the
# route whose tail is float64; where a pixel crosses the valid mask's
# border, either f32 route's chain leaves the float64 one by up to ~2e-4
# at iterations 1-4, so there 1e-3, and the disparity carries the 1e-5
# check
TAIL_POSE_TOL = 1e-5
TAIL_POSE_TOL_FULL = 1e-3
TAIL_SEEDS = (0, 1, 2, 3, 4)  # the smooth inputs of that comparison
TAIL_SHAPES = ((18, 32, H, W), (2, 32, 190, 638))
TAIL_TIMED = 15               # forwards of each route, in turns
# the tail kernel's multiply-adds per output pixel, and per 12x32 tile as
# it runs them (conv1 on the tile +-2, 16x36 cells; conv2 +-1, 14x34 cells
# in 30 M-tiles of 16, run as 8 warps x 4 = 32 M-tiles, 512 rows, the
# last two repeating a tile; conv3 on the tile)
TAIL_TILE = (12, 32)
TAIL_MACS = 9 * 32 * 32 + 9 * 32 * 8 + 9 * 8
TAIL_TILE_MACS = 16 * 36 * 9 * 32 * 32 + 512 * 9 * 32 * 8 + 12 * 32 * 72
# its f32-accurate work on the tensor cores: conv1 and conv2 as 3 TF32
# products for each f32 one (3xTF32)
TF32_FLOPS_PER_S = 495e12     # H100 SXM dense TF32 tensor cores
TAIL_TC_MACS = 9 * 32 * 32 + 9 * 32 * 8

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


def ptxas_by_kernel(log: str) -> dict:
    """``nvcc -Xptxas -v``'s registers, stack and spills of each entry
    function, by its name (empty where the library was not built in this
    process)."""
    import re

    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            # the mangled name's length-prefixed parts: the one naming a
            # kernel
            pos = 0
            while (part := re.compile(r"(\d+)").search(name, pos)):
                end = part.end() + int(part.group(1))
                if "kernel" in name[part.end():end]:
                    name = name[part.end():end]
                    break
                pos = end
            while name in found:    # another instantiation of a template
                name += "'"
            found[name] = []
        elif name is not None and re.search(r"registers|spill|stack", line):
            found[name].append(line.split(":", 1)[-1].strip()
                               if "ptxas" in line else line.strip())
    return {k: "; ".join(v) for k, v in found.items()}


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


def phase_bwd_kernels(torch, gs):
    """The backward kernels vs grid_sample_bwd_plain at the training
    step's shapes: d_coords only at [24,192,640,3] (the solver's warps),
    d_img for channel 3 at [24,192,640,4] (the loss warp)."""
    import numpy as np

    n = 2 * S * B
    coords = torch.from_numpy(smoke_coords(n, H, W, seed=1)).cuda()
    rows = {}
    for name, c, grad_ch in (("grid_sample_bwd_coords", 3, ()),
                             ("grid_sample_bwd_img", 4, (3,))):
        rng = np.random.RandomState(10 + c)
        img = torch.from_numpy(rng.rand(n, H, W, c).astype(np.float32)).cuda()
        g = torch.from_numpy(rng.randn(n, H, W, c).astype(np.float32)).cuda()
        d_coords, d_img = gs.grid_sample_bwd(img, coords, g, grad_ch)
        ref_coords, ref_img = gs.grid_sample_bwd_plain(img, coords, g, grad_ch)
        torch.cuda.synchronize()
        scale = ref_coords.abs().max().item()
        err = (d_coords - ref_coords).abs().max().item()
        check(err <= BWD_COORDS_TOL * scale, f"{name}: d_coords max abs err "
              f"{err} > {BWD_COORDS_TOL} x {scale}")
        img_err = 0.0
        if grad_ch:
            img_err = (d_img - ref_img).abs().max().item()
            check(img_err <= BWD_IMG_TOL, f"{name}: d_img max abs err "
                  f"{img_err} > {BWD_IMG_TOL}")
            check(d_img.abs().max().item() > 0, f"{name}: d_img is all 0")
        mask = [bool(grad_ch), True]
        lib_img, lib_g = img.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)

        def library():
            return torch.ops.aten.grid_sampler_2d_backward(
                lib_g, lib_img, coords, 0, 0, False, mask)

        lib_err = (library()[1] - d_coords).abs().max().item() / scale
        ms = time_ms(lambda: gs.grid_sample_bwd(img, coords, g, grad_ch))
        plain_ms = time_ms(lambda: gs.grid_sample_bwd_plain(
            img, coords, g, grad_ch), iters=10)
        library_ms = time_ms(library)
        # each input read once, each output written once: img, coords, g;
        # d_coords and the d_img channels (its zero-fill not counted)
        planes = c + 2 + c + 2 + len(grad_ch)
        nbytes = planes * n * H * W * 4
        flops = n * H * W * (20 + 14 * c + 8 * len(grad_ch))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        rows[name] = dict(max_abs_err=max(err, img_err), ms=ms,
                          plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by="bytes" if bytes_ms >= ops_ms else
                          "operations", library_ms=library_ms)
        say("kernels", f"{name} [{n},{H},{W},{c}] grad_ch={grad_ch}: "
            f"max|kernel-plain| d_coords {err:.3e} (limit {BWD_COORDS_TOL} "
            f"x {scale:.3e}), d_img {img_err:.3e} (limit {BWD_IMG_TOL}); "
            f"max|kernel-aten| d_coords {lib_err:.3e} of its magnitude; "
            f"kernel {ms * 1e3:.2f} us (d_img zero-fill included), plain "
            f"{plain_ms * 1e3:.2f} us, aten.grid_sampler_2d_backward "
            f"{library_ms * 1e3:.2f} us; bound {bound_ms * 1e3:.2f} us "
            f"({rows[name]['bound_by']}: {nbytes / 1e6:.2f} MB), kernel at "
            f"{bound_ms / ms:.1%} of bound")
    return rows


def phase_grads_kernel(torch, gs):
    """The value+Jacobian kernel vs grid_sample_with_grads_plain at the
    refiners' shapes: the window batch [4,192,640,3] and chain_ba's
    interior windows [10,192,640,3]."""
    import numpy as np
    import torch.nn.functional as F

    rows = {}
    for b in (RB, BLOCK - 2):
        coords = torch.from_numpy(smoke_coords(b, H, W, seed=1)).cuda()
        img = torch.from_numpy(np.random.RandomState(20 + b).rand(
            b, H, W, 3).astype(np.float32)).cuda()
        got = gs.grid_sample_with_grads(img, coords)
        ref = gs.grid_sample_with_grads_plain(img, coords)
        torch.cuda.synchronize()
        err = (got[0] - ref[0]).abs().max().item()
        check(err <= KERNEL_TOL, f"with_grads [{b},{H},{W},3]: out max abs "
              f"err {err} > {KERNEL_TOL}")
        errs = []
        for name, a, r in (("gx", got[1], ref[1]), ("gy", got[2], ref[2])):
            scale = r.abs().max().item()
            e = (a - r).abs().max().item()
            check(e <= GRADS_TOL * scale, f"with_grads [{b},{H},{W},3]: "
                  f"{name} max abs err {e} > {GRADS_TOL} x {scale}")
            errs.append(e / scale)
        lib_img = img.permute(0, 3, 1, 2)

        def context():
            return F.grid_sample(lib_img, coords, mode="bilinear",
                                 padding_mode="zeros", align_corners=False)

        ms = time_ms(lambda: gs.grid_sample_with_grads(img, coords))
        plain_ms = time_ms(lambda: gs.grid_sample_with_grads_plain(
            img, coords), iters=10)
        context_ms = time_ms(context)
        nbytes = (3 + 2 + 9) * b * H * W * 4
        flops = b * H * W * (18 + 3 * (7 + 12))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        rows[b] = dict(max_abs_err=max(err, *errs), ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by="bytes" if bytes_ms >=
                       ops_ms else "operations", library_ms=None,
                       grid_sample_value_only_ms=context_ms)
        say("kernels", f"grid_sample_with_grads [{b},{H},{W},3]: "
            f"max|kernel-plain| out {err:.3e} (limit {KERNEL_TOL}), gx, gy "
            f"{errs[0]:.3e}, {errs[1]:.3e} of their magnitude (limit "
            f"{GRADS_TOL}); kernel {ms * 1e3:.2f} us, plain "
            f"{plain_ms * 1e3:.2f} us, F.grid_sample value only (context, no "
            f"library call gives the derivatives) {context_ms * 1e3:.2f} us; "
            f"bound {bound_ms * 1e3:.2f} us ({rows[b]['bound_by']}: "
            f"{nbytes / 1e6:.2f} MB), kernel at {bound_ms / ms:.1%} of bound")
    return rows


def tail_inputs(torch, shape, seed):
    """Seeded tail input x (NCHW) and weights drawn as
    experiments/test_decoder_tail.py draws them."""
    import numpy as np

    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(*shape) * 0.5).astype(np.float32))
    ws = [torch.from_numpy(a.astype(np.float32)).cuda() for a in (
        rng.randn(32, 32, 3, 3) * 0.08, rng.randn(32) * 0.1,
        rng.randn(8, 32, 3, 3) * 0.08, rng.randn(8) * 0.1,
        rng.randn(1, 8, 3, 3) * 0.2, rng.randn(1) * 0.1)]
    return x.cuda(), ws


def phase_tail_kernel(torch, dt):
    """The decoder tail kernel vs decoder_tail_plain at the coupled
    forward's shape [18,32,192,640] and at an odd shape [2,32,190,638]
    (tiles on both borders cut short); at the main shape the times of the
    kernel, the plain version and the default route's cuDNN layer
    sequence, and the bound."""
    import math

    from tcsfm_torch.models.layers import ReflConv

    torch.backends.cudnn.allow_tf32 = False
    for shape in TAIL_SHAPES[::-1]:
        x, ws = tail_inputs(torch, shape, sum(shape))
        out = dt.decoder_tail(x, *ws)
        ref = dt.decoder_tail_plain(x, *ws)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        check(err <= TAIL_TOL, f"decoder_tail {list(shape)}: kernel vs plain "
              f"max abs err {err} > {TAIL_TOL}")
        if shape != TAIL_SHAPES[0]:
            say("kernels", f"decoder_tail {list(shape)}: max|kernel-plain| "
                f"{err:.3e} (limit {TAIL_TOL})")
    # x, ws, out and err are the main shape's. The default route's own
    # layers: ELU, then iconv4, the feature conv and the head as the depth
    # net holds them
    seq = torch.nn.Sequential(
        torch.nn.ELU(), ReflConv(32, 32), torch.nn.ELU(), ReflConv(32, 8),
        torch.nn.ELU(), ReflConv(8, 1), torch.nn.Sigmoid()).cuda()
    for conv, wt, bias in zip(seq[1::2], ws[0::2], ws[1::2]):
        conv.conv.weight.data.copy_(wt)
        conv.conv.bias.data.copy_(bias)

    def sequence():
        with torch.no_grad():
            return seq(x).permute(0, 2, 3, 1)

    seq_err = (sequence() - out).abs().max().item()
    ms = time_ms(lambda: dt.decoder_tail(x, *ws), iters=20)
    plain_ms = time_ms(lambda: dt.decoder_tail_plain(x, *ws), iters=20)
    seq_ms = time_ms(sequence, iters=20)
    n, _, h, w = x.shape
    tiles = n * math.ceil(h / TAIL_TILE[0]) * math.ceil(w / TAIL_TILE[1])
    halo = tiles * TAIL_TILE_MACS / (n * h * w * TAIL_MACS)
    nbytes = (x.numel() + out.numel() + sum(t.numel() for t in ws)) * 4
    flops = 2 * TAIL_MACS * n * h * w
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # the least time for f32-accurate work: the f32 units, or the tensor
    # cores at 3 TF32 products an f32 one (conv3's FMAs beside them)
    fma_ms = flops / F32_FLOPS_PER_S * 1e3
    tc_ms = (3 * 2 * TAIL_TC_MACS * n * h * w / TF32_FLOPS_PER_S
             + 2 * (TAIL_MACS - TAIL_TC_MACS) * n * h * w / F32_FLOPS_PER_S
             ) * 1e3
    ops_ms = min(fma_ms, tc_ms)
    bound_ms = max(bytes_ms, ops_ms)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               library_ms=None, library_sequence_ms=seq_ms,
               bound_f32_fma_ms=max(bytes_ms, fma_ms), halo_mac_ratio=halo)
    say("kernels", f"decoder_tail {list(x.shape)}: max|kernel-plain| "
        f"{err:.3e} (limit {TAIL_TOL}), max|kernel-cuDNN layers| "
        f"{seq_err:.3e}; kernel {ms * 1e3:.2f} us, plain "
        f"{plain_ms * 1e3:.2f} us, the default route's cuDNN layer sequence "
        f"(3 F.pad + F.conv2d, ELU, sigmoid; no single library call) "
        f"{seq_ms * 1e3:.2f} us; bound {bound_ms * 1e3:.2f} us "
        f"({row['bound_by']}: {flops / 1e9:.2f} GFLOP as 3xTF32 on the "
        f"tensor cores, {nbytes / 1e6:.2f} MB), kernel at "
        f"{bound_ms / ms:.1%} of it; f32-FMA bound "
        f"{row['bound_f32_fma_ms'] * 1e3:.2f} us, kernel at "
        f"{row['bound_f32_fma_ms'] / ms:.1%} of it; executed multiply-adds "
        f"{halo:.3f}x the output's (halo recompute)")
    return row


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
    zero_counts(gs)
    poses, poses_inv, disp, chain = coupled_forward(
        depth_net, pose_net, tgt, src, K, cfg)
    torch.cuda.synchronize()
    launches, *bwd = read_counts(gs)
    check(launches == ITERS - 1 and bwd == [0, 0], f"grid_sample kernels "
          f"launched (fwd, bwd_coords, bwd_img) {(launches, *bwd)} times in "
          f"one coupled forward, expected {(ITERS - 1, 0, 0)}")
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


def train_batch(torch, b, s, h, w, seed, device):
    """A seeded batch in the layout of bench.py: smooth clean frames and an
    augmented stream (brightness/contrast jitter), KITTI-like K."""
    import numpy as np

    tgt, src, K = smooth_inputs(torch, b, s, h, w, seed)
    batch = {"target_img": tgt, "source_imgs": src, "intrinsics_aug": K,
             "target_img_aug": np.clip(tgt * 1.05 + 0.01, 0, 1),
             "source_imgs_aug": np.clip(src * 0.95 + 0.02, 0, 1)}
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
            for k, v in batch.items()}


def zero_counts(gs) -> None:
    gs.LAUNCHES = gs.LAUNCHES_BWD_COORDS = gs.LAUNCHES_BWD_IMG = 0
    gs.LAUNCHES_FWD_GRADS = 0


def read_counts(gs):
    return gs.LAUNCHES, gs.LAUNCHES_BWD_COORDS, gs.LAUNCHES_BWD_IMG


def read_refine_counts(gs):
    return gs.LAUNCHES, gs.LAUNCHES_FWD_GRADS


def grads_of(state):
    return {f"{net}.{name}": p.grad
            for net, m in (("depth", state.depth_net), ("pose", state.pose_net))
            for name, p in m.named_parameters()}


def rel_l2(ours, ref):
    """Relative L2 per tensor, None where the reference is 0 up to 1e-6 of
    the largest gradient (an analytically zero one)."""
    largest = max(g.norm().item() for g in ref.values())
    return {k: None if r.norm().item() <= 1e-6 * largest else
            ((ours[k].double() - r.double()).norm() / r.double().norm()).item()
            for k, r in ref.items()}


def compare_grads(ours, ref, limit, what):
    """Relative L2 per tensor within ``limit`` (a number, or a function of
    the tensor's name); a tensor whose reference gradient is 0 up to 1e-6
    of the largest (an analytically zero one) must be as small. Returns
    the worst relative L2."""
    largest = max(g.norm().item() for g in ref.values())
    worst = 0.0
    for k, err in rel_l2(ours, ref).items():
        g = ours[k]
        check(g is not None, f"{what}: {k} has no grad")
        if err is None:
            check(g.norm().item() <= 1e-5 * largest, f"{what}: {k} should "
                  f"be ~0, norm {g.norm().item()}")
            continue
        bound = limit(k) if callable(limit) else limit
        worst = max(worst, err)
        check(err <= bound, f"{what}: {k} gradient relative L2 {err} > "
              f"{bound}")
    return worst


def step_grads(torch, train_step, state, batch, sampler):
    """Losses and gradients of one step from a copy of ``state``."""
    import copy

    st = copy.deepcopy(state)
    losses = train_step(st, batch, sampler=sampler)
    torch.cuda.synchronize()
    return losses, grads_of(st)


@contextlib.contextmanager
def cudnn_deterministic(torch, on: bool = True):
    """cuDNN's deterministic algorithms (and no autotuning) on or off for
    the block; the previous settings after it."""
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = prev[1] and not on
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev


def rescaled_grads(torch, forward_loss, gs, state, batch, scale):
    """The plain-sampler step's gradients from a copy of ``state`` with its
    loss multiplied by ``scale`` before the backward and the gradients
    divided by it after: the same values, rounded differently."""
    import copy

    st = copy.deepcopy(state)
    for m in (st.depth_net, st.pose_net):
        m.zero_grad(set_to_none=True)
    losses, _ = forward_loss(st.cfg, st.depth_net, st.pose_net, batch,
                             train=True, sampler=gs.grid_sample_plain)
    (losses["total"] * scale).backward()
    torch.cuda.synchronize()
    return {k: g / scale for k, g in grads_of(st).items()}


def step_grad_limits(spread, what):
    """Each tensor's limit from the plain step's own spread (by name):
    max(STEP_GRAD_TOL, STEP_SPREAD_FACTOR x spread), at most STEP_GRAD_CAP;
    fails if more than STEP_GRAD_MAX_WIDENED are above STEP_GRAD_TOL.
    Returns the limits, and the spread and limit of each widened tensor."""
    limits = {k: min(STEP_GRAD_CAP, max(STEP_GRAD_TOL,
                                        STEP_SPREAD_FACTOR * e))
              for k, e in spread.items()}
    widened = {k: (spread[k], v) for k, v in limits.items()
               if v > STEP_GRAD_TOL}
    check(len(widened) <= STEP_GRAD_MAX_WIDENED, f"{what}: the plain step "
          f"does not reproduce itself on {len(widened)} tensors (at most "
          f"{STEP_GRAD_MAX_WIDENED}): {sorted(widened)}")
    return limits, widened


def step_grad_parity(torch, gs, train_step, forward_loss, state, batch,
                     what, sampler=None):
    """The kernel- vs plain-sampler training step from one state: the
    kernel step (through ``sampler``, by default ``gs.grid_sample``), the
    plain-sampler step, and the plain step's own spread (STEP_LOSS_SCALES),
    all with cuDNN's deterministic algorithms, which take out the
    run-to-run order of cuDNN's backward sums. Losses within
    STEP_LOSS_TOL; each gradient within max(STEP_GRAD_TOL,
    STEP_SPREAD_FACTOR x that spread), at most STEP_GRAD_CAP, with at most
    STEP_GRAD_MAX_WIDENED tensors held above STEP_GRAD_TOL; an analytically
    zero gradient as small. Returns the kernel step's losses, the loss
    difference, the worst gradient relative L2, the worst spread and, for
    each tensor held above STEP_GRAD_TOL, its spread and limit."""
    with cudnn_deterministic(torch):
        losses, ours = step_grads(torch, train_step, state, batch,
                                  sampler or gs.grid_sample)
        ref_losses, ref = step_grads(torch, train_step, state, batch,
                                     gs.grid_sample_plain)
        spreads = [rel_l2(rescaled_grads(torch, forward_loss, gs, state,
                                         batch, c), ref)
                   for c in STEP_LOSS_SCALES]
    for k, v in losses.items():
        check(bool(torch.isfinite(v)), f"{what}: {k} = {v.item()}")
    loss_err = max(abs(losses[k].item() - ref_losses[k].item())
                   for k in losses)
    check(loss_err <= STEP_LOSS_TOL, f"{what}: losses differ by {loss_err} "
          f"> {STEP_LOSS_TOL}")
    spread = {k: max(s[k] or 0.0 for s in spreads) for k in ref}
    limits, widened = step_grad_limits(spread, what)
    worst = compare_grads(ours, ref, limits.get, what)
    return losses, loss_err, worst, max(spread.values()), widened


def train_setting(torch, cfg, create_train_state):
    """Phase "train"'s state, seeded, with trained-like conditioning, and
    its batch (B, S, H, W)."""
    state = create_train_state(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(0),
                               steps_per_epoch=1000)
    # training starts from a warm start (the reference trains from an
    # ImageNet encoder): with the raw init's saturated disparity head most
    # warps leave the image and the inverse term can fall under its guard
    condition_like_trained(state.depth_net, torch)
    return state, train_batch(torch, B, S, H, W, seed=4, device="cuda")


def card_test_setting(torch, create_train_state):
    """The state and batch of tests/test_torch_cuda.py's step-gradient
    checks: 96x160, B=2, S=2, the loss's depth terms on."""
    from tcsfm_torch.config import Config

    cfg = Config(iterations=ITERS, **dict(STEP_GRAD_VARIANTS)[
        "depth terms on"])
    state = create_train_state(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(0))
    condition_like_trained(state.depth_net, torch)
    return state, train_batch(torch, 2, 2, 96, 160, seed=6, device="cuda")


def phase_train(torch, gs, cfg, create_train_state, train_step,
                forward_loss):
    """The training step at full width, seeded weights with trained-like
    conditioning: launch counts, finite losses, every parameter and
    BatchNorm statistic moved, time, memory, and the same step with the
    plain sampler from the same state."""
    import copy
    import dataclasses

    state, batch = train_setting(torch, cfg, create_train_state)

    def tensors():
        return {f"{net}.{k}": v for net, m in (("depth", state.depth_net),
                                               ("pose", state.pose_net))
                for k, v in m.state_dict().items()}

    init = {k: v.detach().clone() for k, v in tensors().items()}
    times = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        zero_counts(gs)
        t = time.perf_counter()
        losses = train_step(state, batch)
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            times.append(time.perf_counter() - t)
        counts = read_counts(gs)
        check(counts == (ITERS, ITERS - 1, 1), f"step {i}: launches (fwd, "
              f"bwd_coords, bwd_img) {counts}, expected "
              f"{(ITERS, ITERS - 1, 1)}")
        for k, v in losses.items():
            check(bool(torch.isfinite(v)), f"step {i}: {k} = {v.item()}")
        check(losses["l_reconstruct_inverse"].item() > 0,
              f"step {i}: the inverse term is 0 (mean_on_mask guard)")
    step_counts = counts  # the main path's own: the last timed step
    say("train", f"main path: per training step launches (fwd, bwd_coords, "
        f"bwd_img) {step_counts}, expected {(ITERS, ITERS - 1, 1)}, over "
        f"{len(times) + TRAIN_WARMUP} steps; last losses " + ", ".join(
            f"{k} {v.item():.6f}" for k, v in sorted(losses.items())))
    med = statistics.median(times)
    say("train", f"train step {H}x{W} B={B} S={S} iters={ITERS} f32: median "
        f"{med * 1e3:.3f} ms over {len(times)} (min {min(times) * 1e3:.3f}, "
        f"max {max(times) * 1e3:.3f}) -> {B / med:.2f} frames/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    grads = grads_of(state)
    moved_params = moved_stats = 0
    for k, v in tensors().items():
        if k in grads:
            # a parameter stays only if its gradient is exactly 0
            check(not torch.equal(v, init[k]) or not grads[k].any(),
                  f"parameter {k} did not move")
            moved_params += not torch.equal(v, init[k])
        elif "running" in k:
            check(not torch.equal(v, init[k]), f"BatchNorm {k} did not move")
            moved_stats += 1
    say("train", f"{moved_params} of {len(grads)} parameters and "
        f"{moved_stats} BatchNorm running statistics moved")

    for label, extra in STEP_GRAD_VARIANTS:
        ours = copy.deepcopy(state)
        ours.cfg = dataclasses.replace(cfg, **extra)
        seen = {}

        def recording(img, coords, tail=None):
            if tail is not None and tail.requires_grad:
                tail.register_hook(
                    lambda g: seen.__setitem__("d_img", g.abs().max().item()))
            return gs.grid_sample(img, coords, tail)

        zero_counts(gs)
        _, loss_err, worst, spread, widened = step_grad_parity(
            torch, gs, train_step, forward_loss, ours, batch,
            f"{label}: kernel vs plain sampler step", sampler=recording)
        cmp_counts = read_counts(gs)
        check(cmp_counts == (ITERS, ITERS - 1, 1),
              f"{label}: launches {cmp_counts}")
        depth_terms = bool(extra)
        check((seen["d_img"] > 0) == depth_terms, f"{label}: the loss warp's "
              f"source-depth d_img max {seen['d_img']}")
        say("train", f"{label}: kernel- vs plain-sampler step from one state "
            f"(cuDNN deterministic): max|loss diff| {loss_err:.3e} (limit "
            f"{STEP_LOSS_TOL}), worst gradient relative L2 {worst:.3e} "
            f"(limit {STEP_GRAD_TOL}, or {STEP_SPREAD_FACTOR}x the plain "
            f"step's own spread where that is larger, at most "
            f"{STEP_GRAD_CAP}; worst spread {spread:.3e}); {len(widened)} "
            f"tensors widened (at most {STEP_GRAD_MAX_WIDENED}), spread -> "
            f"limit: " + (", ".join(f"{k} {e:.3e} -> {v:.3e}" for k, (e, v)
                                   in sorted(widened.items())) or "none")
            + f"; source-depth d_img max {seen['d_img']:.3e} (0 expected: "
            f"{not depth_terms})")
    return step_counts, B / med


def phase_train_reference(torch, cfg, create_train_state, train_step,
                          forward_loss, gs):
    """One training step on the card and on the CPU, trained-like weights,
    96x160, B=2, S=2 (each group keeps >10,000 valid pixels): f32 with
    the kernels, then float64 with the plain sampler on both."""
    import copy

    b, s, h, w = 2, 2, 96, 160
    states = {}
    for dev in ("cpu", "cuda"):
        st = create_train_state(cfg, device=dev,
                                generator=torch.Generator().manual_seed(1))
        condition_like_trained(st.depth_net, torch)
        states[dev] = st
    f64 = {dev: (copy.deepcopy(st.depth_net).double(),
                 copy.deepcopy(st.pose_net).double())
           for dev, st in states.items()}
    batch = train_batch(torch, b, s, h, w, seed=5, device="cpu")
    losses = {dev: train_step(st, batch) for dev, st in states.items()}
    loss_err = max(abs(losses["cuda"][k].item() - losses["cpu"][k].item())
                   for k in losses["cpu"])
    check(loss_err <= REF_LOSS_TOL, f"train step card vs CPU: losses differ "
          f"by {loss_err} > {REF_LOSS_TOL}")
    check(losses["cuda"]["l_reconstruct_inverse"].item() > 0,
          "train reference: the inverse term is 0")
    stats_err = max(
        (v.cpu() - states["cpu"].depth_net.state_dict()[k]).abs().max().item()
        for k, v in states["cuda"].depth_net.state_dict().items()
        if "running" in k)
    check(stats_err <= REF_LOSS_TOL, f"BatchNorm statistics card vs CPU "
          f"differ by {stats_err} > {REF_LOSS_TOL}")
    cpu_grads = grads_of(states["cpu"])
    worst32 = compare_grads({k: v.cpu() for k, v in
                             grads_of(states["cuda"]).items()}, cpu_grads,
                            REF_GRAD_TOL_F32, "train step card vs CPU, f32")

    grads64 = {}
    for dev, (dnet, pnet) in f64.items():
        b64 = {k: v.to(dev, torch.float64) for k, v in batch.items()}
        out, _ = forward_loss(cfg, dnet, pnet, b64, train=True,
                              sampler=gs.grid_sample_plain)
        out["total"].backward()
        grads64[dev] = (out["total"].item(), {
            f"{n}.{k}": p.grad.cpu() for n, m in (("depth", dnet),
                                                  ("pose", pnet))
            for k, p in m.named_parameters()})
    total_err = abs(grads64["cuda"][0] - grads64["cpu"][0])
    check(total_err <= 1e-9, f"float64 totals differ by {total_err}")
    worst64 = compare_grads(grads64["cuda"][1], grads64["cpu"][1],
                            REF_GRAD_TOL_F64, "train step card vs CPU, f64")
    say("train reference", f"{h}x{w} B={b} S={s}, trained-like conditioning: "
        f"f32 card (kernels) vs CPU max|loss diff| {loss_err:.2e} (limit "
        f"{REF_LOSS_TOL}), BatchNorm stats {stats_err:.2e}, worst gradient "
        f"relative L2 {worst32:.2e} (limit {REF_GRAD_TOL_F32}, f32 "
        f"resolution); float64 (plain sampler) total diff {total_err:.2e}, "
        f"worst gradient relative L2 {worst64:.2e} (limit {REF_GRAD_TOL_F64})")


def refiner_inputs(torch, cfg, build_models, seed):
    """Seeded, trained-like networks and smooth frames for the refiners:
    the window batch (target [RB,H,W,3], sources [2,RB,H,W,3], K) and a
    12-frame block with per-pixel depths and small initial twists, as
    scripts/bench_refiners.py makes them."""
    import numpy as np

    depth_net, pose_net = build_models(
        cfg, device="cuda", generator=torch.Generator().manual_seed(seed))
    condition_like_trained(depth_net, torch)
    tgt, src, K = (torch.from_numpy(a).cuda()
                   for a in smooth_inputs(torch, RB, 2, H, W, seed=seed))
    rng = np.random.RandomState(seed)
    frames = smooth_inputs(torch, BLOCK, 0, H, W, seed=seed + 1)[0]
    block = (frames, (0.5 + rng.rand(BLOCK, H, W, 1)).astype(np.float32)
             * 20.0, K[0].cpu().numpy(),
             (0.005 * rng.randn(BLOCK - 2, 6)).astype(np.float32),
             (0.005 * rng.randn(BLOCK - 2, 6)).astype(np.float32))
    return depth_net, pose_net, (tgt, src, K), [
        torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in block]


def forward_depths(torch, cfg, depth_net, pose_net, tgt, src, K):
    """The coupled forward of run_sequential_pft's ba/gn bodies: depths of
    the target and both sources [3,B,H,W,1] and the poses [2,B,6]."""
    from tcsfm_torch.solver.coupled import solve_disp, solve_pose_iteratively
    from tcsfm_torch.utils.helpers import disp_to_depth

    with torch.no_grad():
        disps = solve_disp(depth_net, tgt, src)
        depths = torch.stack([disp_to_depth(d[0], cfg.min_depth,
                                            cfg.max_depth)[1] for d in disps])
        poses, _, _ = solve_pose_iteratively(cfg.iterations, depths, pose_net,
                                             tgt, src, K)
    return depths, poses


def phase_refiners(torch, gs, build_models):
    """The three refiner bodies at full resolution: launch counts, costs
    falling in every window, kernel- vs plain-sampler agreement, times."""
    from tcsfm_torch.config import Config
    from tcsfm_torch.solver.ba import chain_ba, window_ba
    from tcsfm_torch.solver.gauss_newton import gauss_newton_pose

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config(iterations=RITERS, num_scales=1, minibatch=RB,
                 img_resolution="med")
    depth_net, pose_net, (tgt, src, K), block = refiner_inputs(
        torch, cfg, build_models, seed=7)

    def forward():
        return forward_depths(torch, cfg, depth_net, pose_net, tgt, src, K)

    def ba(sampler=gs.grid_sample, fwd=None):
        depths, poses = forward() if fwd is None else fwd
        res = window_ba(poses[0], poses[1], depths[0], tgt, src[0], src[1],
                        depths[1], depths[2], K, iters=10,
                        depth_prior_weight=0.1, sampler=sampler)
        return (res.pose_prev, res.pose_next), res.depth, res.cost

    def gn(sampler=gs.grid_sample, fwd=None):
        depths, poses = forward() if fwd is None else fwd
        res = gauss_newton_pose(poses[1], tgt, src[1], depths[0], depths[2],
                                K, iters=10, sampler=sampler)
        return (res.pose,), None, res.cost

    def chain(sampler=gs.grid_sample, fwd=None):
        res = chain_ba(*block, iters=10, depth_prior_weight=0.1,
                       pyramid_levels=2, sampler=sampler)
        return (res.edge_pose,), res.depth, res.cost[:, None]

    counts, ms_per_window = {}, {}
    for name, body, windows, fwd_launches in (
            ("ba", ba, RB, RITERS - 1), ("gn", gn, RB, RITERS - 1),
            ("chain", chain, BLOCK - 2, 0)):
        body()                                               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(gs)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        poses, depth, cost = body()
        end.record()
        torch.cuda.synchronize()
        got = read_refine_counts(gs)
        want = (REFINER_LAUNCHES[name][0] + fwd_launches,
                REFINER_LAUNCHES[name][1])
        check(got == want, f"{name}: launches (value, value+Jacobian) {got},"
              f" expected {want}")
        check(all(bool(torch.isfinite(p).all()) for p in poses)
              and bool(torch.isfinite(cost).all()), f"{name}: non-finite")
        check(bool((cost[-1] < cost[0]).all()), f"{name}: the cost did not "
              f"fall in every window: {cost[0].tolist()} -> "
              f"{cost[-1].tolist()}")
        counts[name] = got
        times = [start.elapsed_time(end)]
        for _ in range(REFINE_TIMED - 1):
            start.record()
            body()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated() / 2**20
        if name != "chain":
            fwd_ms = time_ms(lambda: forward_depths(
                torch, cfg, depth_net, pose_net, tgt, src, K), iters=3,
                warmup=1)
        else:
            fwd_ms = 0.0
        med = statistics.median(times)
        ms_per_window[name] = med / windows
        say("refiners", f"{name}: launches (value, value+Jacobian) {got} "
            f"(expected {want}); cost per window {cost[0].tolist()} -> "
            f"{cost[-1].tolist()}; median {med:.3f} ms over {len(times)} "
            f"(min {min(times):.3f}, max {max(times):.3f}) for {windows} "
            f"windows -> {med / windows:.3f} ms per window"
            + (f" (forward {fwd_ms:.3f} ms of it, refiner alone "
               f"{(med - fwd_ms) / windows:.3f} ms per window)"
               if fwd_ms else "") + f"; peak memory {peak:.1f} MiB")

        # the same refiner call with the plain sampler, on the same inputs
        # (one forward's outputs for ba/gn)
        fwd = forward() if name != "chain" else None
        poses, depth, cost = body(fwd=fwd)
        p_poses, p_depth, p_cost = body(gs.grid_sample_plain, fwd=fwd)
        pose_err = max((a - b).abs().max().item()
                       for a, b in zip(poses, p_poses))
        depth_err = 0.0 if depth is None else (
            (depth - p_depth).abs().max() / p_depth.abs().max()).item()
        cost_err = ((cost - p_cost).abs() / p_cost.abs()).max().item()
        check(pose_err <= REF_POSE_TOL and depth_err <= REF_DEPTH_TOL
              and cost_err <= REF_COST_TOL, f"{name}: kernel vs plain sampler"
              f" poses {pose_err}, depths {depth_err}, costs {cost_err}")
        say("refiners", f"{name}: kernel- vs plain-sampler call on the same "
            f"inputs: max|pose diff| {pose_err:.3e} (limit {REF_POSE_TOL}), "
            f"depth {depth_err:.3e} of the largest (limit {REF_DEPTH_TOL}), "
            f"costs {cost_err:.3e} relative (limit {REF_COST_TOL})")
    return counts, ms_per_window


def phase_refiners_reference(torch, gs):
    """window_ba and gauss_newton_pose on a small smooth scene on the card
    (kernels) and on the CPU port (plain sampler)."""
    import numpy as np

    from tcsfm_torch.solver.ba import window_ba
    from tcsfm_torch.solver.gauss_newton import gauss_newton_pose

    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, w = 2, 64, 96
    tgt, src, K = smooth_inputs(torch, b, 2, h, w, seed=8)
    rng = np.random.RandomState(8)
    depth = (2.0 + 3.0 * rng.rand(b, h, w, 1)).astype(np.float32)
    pose = (0.01 * rng.randn(2, b, 6)).astype(np.float32)
    worst = {}
    for name, fields, call in (
            ("window_ba", ("pose_prev", "pose_next"), lambda dev: window_ba(
                pose[0], pose[1], depth, tgt, src[0], src[1], depth, depth, K,
                iters=10, depth_prior_weight=0.1, device=dev)),
            ("gauss_newton_pose", ("pose",), lambda dev: gauss_newton_pose(
                pose[1], tgt, src[1], depth, depth, K, iters=10,
                device=dev))):
        card, cpu = call("cuda"), call("cpu")
        pose_err = max((getattr(card, f).cpu() - getattr(cpu, f)).abs().max()
                       .item() for f in fields)
        cost_err = ((card.cost.cpu() - cpu.cost).abs()
                    / cpu.cost.abs()).max().item()
        check(pose_err <= CPU_TOL and cost_err <= CPU_TOL, f"{name} card vs "
              f"CPU: poses {pose_err}, costs {cost_err} > {CPU_TOL}")
        check(bool((cpu.cost[-1] < cpu.cost[0]).all()), f"{name}: cost did "
              f"not fall on the CPU")
        worst[name] = (pose_err, cost_err)
    say("refiners reference", f"{h}x{w} B={b}, 10 iterations, card (kernels) "
        "vs CPU (plain): " + "; ".join(
            f"{k} max|pose diff| {p:.2e}, costs {c:.2e} relative"
            for k, (p, c) in worst.items()) + f" (limit {CPU_TOL})")


def phase_tail(torch, gs, dt, cfg, build_models, coupled_forward):
    """The coupled forward of phase "slice" with its depth net through the
    fused decoder tail: launch counts; the disparity against the default
    route at the raw init, and each route's tail against a float64 tail of
    the same input; under trained-like conditioning, at 64x96 and at
    192x640, the disparity and the pose chain against the default route
    and against the route with a float64 tail; both routes timed in turns;
    peak memory.
    Returns (tail launches, sampler launches) of one forward."""
    import copy

    from tcsfm_torch.models.depth import make_tail_apply, tail_weights

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    depth_net, pose_net = build_models(
        cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    tgt, src, K = (torch.from_numpy(a).cuda()
                   for a in smoke_inputs(B, S, H, W, seed=0))
    tail = make_tail_apply(depth_net)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(gs)
    dt.LAUNCHES = 0
    poses, poses_inv, disp, chain = coupled_forward(
        depth_net, pose_net, tgt, src, K, cfg, depth_apply=tail)
    torch.cuda.synchronize()
    counts = (dt.LAUNCHES, *read_counts(gs))
    peak_tail = torch.cuda.max_memory_allocated() / 2**20
    check(counts == (1, ITERS - 1, 0, 0), f"tail route: launches (tail, "
          f"grid_sample fwd, bwd_coords, bwd_img) {counts} in one forward, "
          f"expected {(1, ITERS - 1, 0, 0)}")
    shapes = {"poses": (S, B, 6), "poses_inv": (S, B, 6),
              "disp": (B, H, W, 1), "chain": (2 * S * B, ITERS, 6)}
    for name, t in zip(shapes, (poses, poses_inv, disp, chain)):
        check(tuple(t.shape) == shapes[name],
              f"tail route: {name} shape {tuple(t.shape)} != {shapes[name]}")
        check(bool(torch.isfinite(t).all()), f"tail route: {name} has "
              f"non-finite values")
    say("tail", f"main path: launches (tail, grid_sample fwd, bwd_coords, "
        f"bwd_img) {counts} in one coupled forward through make_tail_apply "
        f"(expected {(1, ITERS - 1, 0, 0)}); outputs finite, shapes "
        f"{list(shapes.values())}")

    torch.cuda.reset_peak_memory_stats()
    _, _, disp_d, _ = coupled_forward(depth_net, pose_net, tgt, src, K, cfg)
    torch.cuda.synchronize()
    peak_default = torch.cuda.max_memory_allocated() / 2**20
    raw_err = (disp - disp_d).abs().max().item()
    check(raw_err <= TAIL_DISP_TOL_RAW, f"tail vs default route at the raw "
          f"init: disparity {raw_err} > {TAIL_DISP_TOL_RAW}")
    with torch.no_grad():
        imgs = torch.cat([tgt, src.reshape(S * B, H, W, 3)])
        z = depth_net.decode_tail_input(depth_net.encode(imgs))
        w = tail_weights(depth_net)
        d64 = dt.decoder_tail_plain(z.double(), *(t.double() for t in w))
        k64 = (dt.decoder_tail(z, *w).double() - d64).abs().max().item()
        c64 = (dt.decoder_tail_plain(z, *w).double() - d64).abs().max().item()
    del z, d64
    say("tail", f"raw init: max|disp tail - default route| {raw_err:.3e} "
        f"(limit {TAIL_DISP_TOL_RAW}); the tail of the same input "
        f"[{(S + 1) * B},32,{H},{W}] against a float64 tail: kernel "
        f"{k64:.3e}, "
        f"cuDNN f32 {c64:.3e}")

    cond = copy.deepcopy(depth_net)
    condition_like_trained(cond, torch)
    w64 = [t.double() for t in tail_weights(cond)]

    def f64_tail(imgs):
        z = cond.decode_tail_input(cond.encode(imgs))
        return [dt.decoder_tail_plain(z.double(), *w64).float()]

    def iters(errs):
        return "[" + ", ".join(f"{e:.2e}" for e in errs) + "]"

    unresolved = {"tail": [], "default": []}   # full size, past 1e-5
    for (b, h, w), seed, tol in (
            ((2, 64, 96), 3, TAIL_POSE_TOL),
            *(((B, H, W), k, TAIL_POSE_TOL_FULL) for k in TAIL_SEEDS)):
        sm = [torch.from_numpy(a).cuda()
              for a in smooth_inputs(torch, b, S, h, w, seed=seed)]
        out = {k: coupled_forward(cond, pose_net, *sm, cfg, depth_apply=v)
               for k, v in (("tail", make_tail_apply(cond)), ("default", None),
                            ("f64", f64_tail))}
        disp, chain = {}, {}
        for a, r in (("tail", "default"), ("tail", "f64"),
                     ("default", "f64")):
            disp[a, r] = (out[a][2] - out[r][2]).abs().max().item()
            chain[a, r] = (out[a][3] - out[r][3]).abs().amax(
                dim=(0, 2)).tolist()
        check(max(chain["tail", "default"]) <= tol
              and disp["tail", "default"] <= TAIL_DISP_TOL
              and disp["tail", "f64"] <= TAIL_DISP_TOL,
              f"tail route, trained-like, {h}x{w}: chain vs default route "
              f"per iteration {chain['tail', 'default']} (limit {tol}), disp "
              f"vs default {disp['tail', 'default']}, vs the float64 tail's "
              f"route {disp['tail', 'f64']} (limit {TAIL_DISP_TOL})")
        if h == H:
            for k in unresolved:
                e = max(chain[k, "f64"])
                if e > TAIL_POSE_TOL:
                    unresolved[k].append(e)
        say("tail", f"trained-like conditioning, smooth images (seed {seed}),"
            f" {h}x{w} B={b}: tail vs default route max|disp diff| "
            f"{disp['tail', 'default']:.2e} (limit {TAIL_DISP_TOL}), "
            f"max|chain diff| per iteration "
            f"{iters(chain['tail', 'default'])} (limit {tol}); against the "
            f"route with a float64 tail: tail route disp "
            f"{disp['tail', 'f64']:.2e} (limit {TAIL_DISP_TOL}), chain "
            f"{iters(chain['tail', 'f64'])}; default route disp "
            f"{disp['default', 'f64']:.2e}, chain "
            f"{iters(chain['default', 'f64'])}")
    say("tail", f"{H}x{W}, {len(TAIL_SEEDS)} smooth inputs: the chain leaves "
        f"the float64-tail route's by more than {TAIL_POSE_TOL} on "
        f"{len(unresolved['default'])} inputs through the default route "
        f"(largest {max(unresolved['default'], default=0.0):.2e}) and on "
        f"{len(unresolved['tail'])} through the tail route (largest "
        f"{max(unresolved['tail'], default=0.0):.2e})")

    routes = {"default": lambda: coupled_forward(depth_net, pose_net, tgt,
                                                 src, K, cfg),
              "tail": lambda: coupled_forward(depth_net, pose_net, tgt, src,
                                              K, cfg, depth_apply=tail)}
    for run in routes.values():
        run()
        run()
    times = {k: [] for k in routes}
    for i in range(TAIL_TIMED):
        order = ("default", "tail") if i % 2 == 0 else ("tail", "default")
        for k in order:
            torch.cuda.synchronize()
            t = time.perf_counter()
            routes[k]()
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - t)
    med = {k: statistics.median(v) for k, v in times.items()}
    say("tail", f"coupled forward {H}x{W} B={B} S={S} iters={ITERS} f32, "
        f"{TAIL_TIMED} of each route in turns: through the tail median "
        f"{med['tail'] * 1e3:.3f} ms (min {min(times['tail']) * 1e3:.3f}, "
        f"max {max(times['tail']) * 1e3:.3f}) -> {B / med['tail']:.2f} "
        f"frames/s, peak memory {peak_tail:.1f} MiB; default route median "
        f"{med['default'] * 1e3:.3f} ms (min "
        f"{min(times['default']) * 1e3:.3f}, max "
        f"{max(times['default']) * 1e3:.3f}) -> {B / med['default']:.2f} "
        f"frames/s, peak memory {peak_default:.1f} MiB")
    return counts[:2]


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
    from tcsfm_torch.ops import decoder_tail as dt
    from tcsfm_torch.ops import grid_sample as gs
    from tcsfm_torch.train.trainer import (create_train_state, forward_loss,
                                           train_step)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    say("setup", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t = time.monotonic()
    lib = _build.build()
    ptxas = ptxas_by_kernel(_build.build_log)
    for name, text in ptxas.items():
        say("build", f"ptxas {name}: {text}")
    _build.load()
    say("build", f"{lib.relative_to(_build.BUILD_ROOT.parents[1])}, nvcc "
        f"{_build.build_seconds:.2f} s")

    say("build", f"phase took {time.monotonic() - t:.2f} s")

    t = time.monotonic()
    rows = phase_kernels(torch, gs)
    rows.update(phase_bwd_kernels(torch, gs))
    grads_rows = phase_grads_kernel(torch, gs)
    tail_row = phase_tail_kernel(torch, dt)
    tail_row["ptxas"] = ptxas.get("decoder_tail_kernel")
    say("kernels", f"decoder_tail_kernel, -Xptxas -v: {tail_row['ptxas']}")
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
    t = time.monotonic()
    step_counts, _ = phase_train(torch, gs, cfg, create_train_state,
                                 train_step, forward_loss)
    say("train", f"phase took {time.monotonic() - t:.2f} s")
    t = time.monotonic()
    phase_train_reference(torch, Config(iterations=ITERS), create_train_state,
                          train_step, forward_loss, gs)
    say("train reference", f"phase took {time.monotonic() - t:.2f} s")
    t = time.monotonic()
    refine_counts, _ = phase_refiners(torch, gs, build_models)
    say("refiners", f"phase took {time.monotonic() - t:.2f} s")
    t = time.monotonic()
    phase_refiners_reference(torch, gs)
    say("refiners reference", f"phase took {time.monotonic() - t:.2f} s")
    t = time.monotonic()
    tail_launches, tail_fwd_launches = phase_tail(
        torch, gs, dt, cfg, build_models, coupled_forward)
    say("tail", f"phase took {time.monotonic() - t:.2f} s")

    fwd_src = "tcsfm_torch/ops/csrc/grid_sample.cu"
    bwd_src = "tcsfm_torch/ops/csrc/grid_sample_bwd.cu"
    no_refine = {k: 0 for k in refine_counts}
    # launches per forward, training step, refiner call, tail-route forward
    per_path = {
        "grid_sample_fwd": (launches, step_counts[0],
                            {k: v[0] for k, v in refine_counts.items()},
                            tail_fwd_launches),
        "grid_sample_bwd_coords": (0, step_counts[1], no_refine, 0),
        "grid_sample_bwd_img": (0, step_counts[2], no_refine, 0),
        "grid_sample_with_grads": (0, 0, {k: v[1] for k, v in
                                          refine_counts.items()}, 0),
        "decoder_tail": (0, 0, no_refine, tail_launches)}
    kernels = []
    for name, source, replaces, row in (
            ("grid_sample_fwd", fwd_src, "tcsfm/ops/warp_mxu.py:470",
             rows[3]),
            ("grid_sample_bwd_coords", bwd_src,
             "tcsfm/ops/warp_mxu_grad.py:303", rows["grid_sample_bwd_coords"]),
            ("grid_sample_bwd_img", bwd_src,
             "tcsfm/ops/warp_mxu_grad.py:294", rows["grid_sample_bwd_img"]),
            ("grid_sample_with_grads", fwd_src, "tcsfm/ops/warp_mxu.py:526",
             grads_rows[RB]),
            ("decoder_tail", "tcsfm_torch/ops/csrc/decoder_tail.cu",
             "experiments/decoder_tail.py:200", tail_row)):
        fwd, step, refine, tail_fwd = per_path[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=fwd + step + sum(refine.values())
                            + tail_fwd,
                            launches_per_forward=fwd,
                            launches_per_train_step=step,
                            launches_per_refiner_call=refine,
                            launches_per_tail_forward=tail_fwd, **row))
    print(json.dumps({"kernels": kernels}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
