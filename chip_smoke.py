#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its elapsed seconds:
  0. watchdog, card name and power limit, torch and CUDA versions;
  1. build the CUDA kernels from ``tcsfm_torch/ops/csrc`` (nvcc + ctypes);
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes, and its times: device time (launches back to back,
     queued behind a spin kernel so that no host gap lies between them) in
     turns with one PyTorch library call (kernel, library, library,
     kernel), with the card's clocks, power and temperature sampled beside
     them; the same with the L2 flushed before each launch; the wrapper
     loop's time per call (what a Python caller pays); the plain
     version's; and the kernel's memory/compute bound. The samplers are
     timed at the main path's own coordinates (the coupled forward's three
     re-warps, the refiners' jvps, the training step's backward launches)
     and at ``smoke_coords``; the backward kernels also at coords spread
     over the whole image, with how far the d_img launches' taps spread.
     The build phase prints each kernel's registers and spills and checks
     the samplers' SASS (128-bit loads and stores, no calls; the d_img
     kernel's global reductions);
  3. the main path: the coupled depth-pose forward at med res 192x640,
     B=6, S=2, 4 iterations, f32, full-width networks with seeded random
     weights; kernel launch counts, the same forward with the plain
     sampler, frames/s and peak memory;
  4. the same forward on the card and on the CPU at a small input, with
     trained-like weights (``condition_like_trained``);
  5. the second main path: the training step at the same shape (solver,
     loss stack, gradients through both backward kernels, Adam), with
     launch counts, step time, frames/s and peak memory with
     ``remat_coupled`` on (the default) and off in turns, the two steps'
     losses bit-equal and gradients within the step's rounding limits, and
     the same step with the plain sampler from the same state;
  6. one training step on the card and on the CPU at a small input;
 6a. phase "dist": the data-parallel path (``tcsfm_torch.dist``) in a
     one-rank NCCL group started in this process: the distributed
     training step at phase 5's setting from the same state as the plain
     step, its launches and collectives counted, its losses, gradients and
     BatchNorm statistics held against the plain step's within the step's
     own rounding limits, both steps timed in turns on CUDA events and the
     gradients' all-reduce alone; BatchNorm's global-statistics path
     (the one of several ranks, through the NCCL all-reduces) held
     against the one-card path at the depth net's first BatchNorm, in
     float64 and float32; then ``measure_scaling([1])`` (one
     spawned rank) and ``dryrun_multichip(1)`` (the step and the
     window-sharded sequence BA); a single card runs one NCCL rank, so the
     parity of several ranks is held on the CPU (gloo, the tests);
 6b. the seventh main path, phase "train_cli": the training entry point
     (``tcsfm_torch.cli.train.main``) at full width on generated
     sequences, two epochs with validation, panels, trajectory eval,
     checkpoint and logs, then resumed from its checkpoint for a third:
     the files, the scalars, the resumed step and Adam state bit-equal to
     the saved, the launches of every training step as phase 5's, the
     train epochs' wall time and steps/s, and peak memory;
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
     routes in turns, and peak memory;
 9a. phase "bf16", the JAX package's default precision
     (``compute_dtype="bfloat16"``: both networks in bfloat16 on float32
     parameters, geometry and sampler in float32), at phase 3's setting
     with trained-like weights: the coupled forward through both routes
     (cuDNN bf16 layers; ``make_tail_apply`` with the bf16 tail kernel)
     and a training step (``remat_coupled`` on), their launches counted,
     each kernel held against its plain version on the same bf16 nets at
     that kernel's own limits (the sampler's f32 ones, the step's
     gradients by the plain step's own spread; the tail kernel on the
     path's decoder input and the route's disparity by its rounding
     flips), and timed in turns with the f32 run of the same weights
     (frames/s, step ms, peak memory); the 64x96 forward card vs CPU in
     bf16 within 2x the CPU's bf16-vs-f32 gap;
     ``cli.train`` with its default ``--compute_dtype`` for two epochs
     (its ``config.json`` says bfloat16; in ``build/bf16_cli/``). Every
     other phase runs in float32 (``compute_dtype="float32"`` pinned);
 10. the fifth main path: PFT (``solver.pft.PFTOptimizer.optimize_window``)
     at bench.py's setting: encoder mode, 20 epochs, window batch 4, S=2,
     4 iterations, 192x640, f32 with TF32 off, trained-like weights,
     uint8-grid images; launch counts per call, ms per window and
     windows/s (median of 3 calls on CUDA events) with the card's clocks,
     peak memory, the same call with the plain sampler held within a limit
     drawn from the plain call's own spread, and a small call on the card
     against the same call on the CPU, with two witnesses that their gap
     is rounding (the first forward's mask pixels that differ, and the
     CPU call against itself with its images one ulp up);
 11. the sixth main path: the sequence CLIs, weights through a checkpoint:
     phase 10's nets written with ``train.checkpoint.save_checkpoint`` and
     read back bit for bit; ``evaluate_vo`` (``--model_dir``) over the
     first 64 frames of the committed 1504-frame drive at 192x640 with
     the kernel and with the plain sampler, held equal (the plain run
     with its images one ulp up beside them), then one timed pass of the
     evaluator the CLI builds over the whole drive (batch 8, 4
     iterations) with windows/s, clocks, launches and peak memory;
     ``run_sequential_pft`` with each refiner (adam, ba, gn, chain) at
     192x640 with its launch counts and falling costs; and both CLIs card
     vs CPU at 64x96, each with the CPU run's images one ulp up beside it;
 12. the eighth main path, phase "eval": the evaluation CLIs at full width
     on the committed drive's frames. A reference-layout checkpoint
     (``save_reference_checkpoint``) through ``import_checkpoint``, read
     back bit for bit; ``evaluate_depth_eigen`` on 697 frames (the Eigen
     test split's size) as JPEGs with GT depth at 375x1242, flip-merged,
     with images/s and peak memory, its ``--pred_disps`` replay equal, and
     4 frames card vs CPU; ``evaluate_scannet`` on a scene of the first 200
     frames (gap 8, 8 iterations, batch 4) with the kernel and with the
     plain sampler held within the plain run's one-ulp spread, its launches
     (7 a batch), windows/s and peak memory; ``golden_eval``'s real table
     on the first 256 frames as 09_02 (four anchored rows; the verdicts of
     these weights printed), and ``golden_eval --synthetic`` at its
     defaults (JAX's keys, every metric finite, its launches; the gates'
     verdicts printed, not asserted: the from-scratch gate is calibrated on
     the JAX package's CPU trajectory);
 13. the ninth main path, phase "flow": classical optical flow
     (``flow_type='classical'``, iterations 1, the 8-channel pose net)
     at 192x640. Its config and seeded nets through a checkpoint, read
     back bit for bit; ``ops.flow.batched_flow_pair`` on two pairs of the
     drive card vs CPU within the CPU run's spread with its images one ulp
     up; a textured frame's known sub-pixel shift recovered; ``evaluate_vo
     --iterations 1`` through ``main`` over the drive's first 256 frames
     (no sampler launch), one timed pass of its evaluator (windows/s), the
     flow pair's and the whole batch's device ms (CUDA events), peak
     memory; the validation panels with the flows inside
     ``utils.profiling.trace`` (one value launch a panel, equal to the
     plain sampler's, the trace naming the kernel); the legacy
     ``inverse_warp`` kernel vs plain (one launch); the SE(3) maps card vs
     CPU.

Phase 2 also holds the sampler's two backward kernels (d_coords only,
and d_coords + d_img; d_coords bit for bit), its value+Jacobian kernel and
the decoder tail kernels (f32 and bf16) against their plain versions.
Prints the kernels' JSON line, then, as the last line,
``{"ok": true, "device": {...}}``. Any failed check raises and exits
non-zero; a hang past the watchdog dumps a traceback and exits non-zero.
Inputs and weights come from seeds, apart from the drive, the
repository's ``.flagship_data/drive1504_192x640/synthetic/
sequence_data.npz`` (phases 11-13). Writes under ``build/sequence/``,
``build/train_cli/``, ``build/bf16_cli/``, ``build/eval/`` and
``build/flow/``.
"""

from __future__ import annotations

import contextlib
import faulthandler
import hashlib
import itertools
import json
import math
import statistics
import subprocess
import sys
import time

WATCHDOG_S = 720
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
H, W, B, S, ITERS = 192, 640, 6, 2, 4
KERNEL_TOL = 1e-5             # kernel vs plain: same arithmetic, same order
# the kernels' device time: TIMED launches back to back, queued behind a
# spin of SLEEP_CYCLES (~5 ms at 1.98 GHz, doubled until the host has
# queued them all before the first starts), in TURNS rounds of kernel,
# library, library, kernel, after WARMUP_S of work; and FLUSHED launches
# each after FLUSH_BYTES written (the L2 holds 50 MB), for the L2-flushed
# figure; nvidia-smi's CLOCK_FIELDS sampled every 50 ms beside the turns
TIMED, TURNS, SLEEP_CYCLES, WARMUP_S = 50, 3, 10_000_000, 0.2
FLUSHED, FLUSH_BYTES = 20, 256 * 2**20
CLOCK_FIELDS = "clocks.sm,clocks.mem,power.draw,temperature.gpu"
# value+Jacobian launches recorded from the refiners for the kernel's
# timing at their own coordinates: one LM iteration's (7 jvps for each of
# window_ba's two residual families)
JVP_SAMPLES = 14
BWD_IMG_TOL = 1e-5            # d_img: atomics add in a changing order
# d_coords is bit-equal to its plain version (the same f32 operations in
# the same order); its sha256 at smoke_coords
BWD_SMOKE_SHA256 = {"grid_sample_bwd_coords": "6a433ed3de2c35a6",
                    "grid_sample_bwd_img": "163ccab1777eef91"}
# the spread of the d_img launches' taps: for tiles of a block (8 rows by
# 64 pixels) and of a warp (1 by 64), the shares whose taps' box of d_img
# (rows by 16-byte-aligned float columns) fits these sizes (floats)
BWD_TAP_BOXES = {(8, 64): (1024, 2048, 4096, 8192),
                 (1, 64): (256, 512, 1024, 2048)}
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
DIST_TIMED = 6                # distributed and plain steps each, in turns
DIST_COLLECTIVE_REPS = 20     # the gradients' all-reduce, timed alone
# BatchNorm's global-statistics path (``_global_forward``) against the
# one-card path at the depth net's first BatchNorm (B x 64 x H/2 x W/2):
# the largest difference of output, input/weight/bias gradients and running
# statistics, relative to the tensor's largest magnitude. The two compute
# the same statistics in different orders (two passes of sums against the
# one-card kernel's), so they differ by rounding alone
BN_GLOBAL_TOL = {"float64": 1e-10, "float32": 1e-4}
# phase "train_cli": the training entry point at full width on generated
# sequences of 14 frames (12 windows each: 24 training windows, 4 steps
# of B an epoch; 12 val windows, 2 batches; 12 test windows)
TRAIN_CLI_ARGS = ["--synthetic", "--img_resolution", "med", "--minibatch",
                  str(B), "--iterations", str(ITERS), "--synthetic_frames",
                  "14", "--compute_dtype", "float32"]
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
TAIL_TIMED_LAUNCHES = 10      # tail launches in one timed sample
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
# the bf16 tail kernel (decoder_tail_bf16): the same 51.3 GFLOP at
# [18, 32, 192, 640], all of it bf16 products (conv3's too), so its least
# time is the dense bf16 rate's; its bytes are x in bf16 and out in f32.
# Kernel vs decoder_tail_plain_bf16 on the f32 disparity (before the
# cast): both round elu(x), f1 and f2 to bf16 at the same points, but sum
# in another f32 order (the tensor cores' against cuDNN's f32 convs) and
# the kernel's ELU is a polynomial and a fast exponential; a value that
# lands on the other side of a bf16 rounding boundary moves by one bf16
# ulp (2^-8 relative) and carries that, through w2 and w3 and the
# sigmoid's slope (at most 1/4), to the disparity: a few flips near one
# pixel move it by ~1e-3 (measured on an H100, PR 17: 1.1e-3-1.8e-3 at the
# main shape, 8.2e-4-8.8e-4 at the border shape, 2-3.5% of the pixels
# moved by more than 1e-6)
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
TAIL_BF16_TOL = 4e-3
# phase "bf16". A kernel against its plain version on the same bf16 nets is
# held at that kernel's own limits: both sides run the same bf16 convs, so
# only the kernel differs. The sampler kernels (f32 as before) at the f32
# phases' limits: the forward's chain and disparity against the plain
# sampler's at CHAIN_TOL and DISP_TOL, the step's losses at STEP_LOSS_TOL
# (measured on an H100 80GB HBM3 at 700 W: the forwards and the step's
# losses bit-equal). The step's gradients by the f32 phases' rule without
# its cap, on the plain step's spread over BF16_LOSS_SCALES: each tensor
# within max(STEP_GRAD_TOL, STEP_SPREAD_FACTOR x its spread, the whole
# gradient's spread), and the whole gradient within STEP_SPREAD_FACTOR x its
# spread. STEP_GRAD_CAP and STEP_GRAD_MAX_WIDENED are what the f32 step
# reproduces itself to; the bf16 backward rounds its sums to bf16, and its
# plain step spreads by up to 1.2e-2-1.4e-2 on 81-83 of 114 tensors (that
# H100), where the kernel step came 1.37e-2-1.50e-2 from it; the whole
# gradient spreads 2.3e-3-2.5e-3, the kernel step 2.6e-3-3.1e-3 from it; one
# tensor of 16 values (a bias) came 4.1 x its two-sample spread from it, so
# four samples and the whole gradient's spread as a floor. The tail kernel
# on the path's own decoder input within TAIL_BF16_TOL, phase "kernels"'
# rule, and the tail route's bf16 disparity against the plain bf16 tail's
# within TAIL_BF16_REL relative L2: a rounding flip moves a pixel's
# disparity by about one bf16 ulp (2^-8 relative) at most, and the flips
# reach a few percent of the pixels (2-3.5% in phase "kernels"), so
# sqrt(0.035) x 2^-8 = 7.3e-4 (measured 1.23e-4 on that H100). Where two
# runs round in different places (the pose chain through the two tails,
# whose disparities differ by those flips; the card's bf16 run against the
# CPU's), relative L2 within BF16_FRACTION x the gap between the bf16 run
# and the f32 run of the same weights on the same inputs, as the CPU tests
# hold the port's bf16 run against JAX's (tests/test_torch_bf16*.py: two
# bf16 runs that round in different places differ by about sqrt(2) x that
# gap); BF16_TIMED runs of each dtype in turns
TAIL_BF16_REL = 1e-3
BF16_LOSS_SCALES = STEP_LOSS_SCALES + (1.0 + 2.0 ** -22, 1.0 - 2.0 ** -23)
BF16_FRACTION = 2.0
BF16_TIMED = 6
KERNEL_NAMES = ("grid_sample_fwd", "grid_sample_bwd_coords",
                "grid_sample_bwd_img", "grid_sample_with_grads",
                "decoder_tail", "decoder_tail_bf16")
# phase "pft": bench.py's PFT setting (encoder mode, PFTOptions(epochs=20,
# num_source_imgs=2), window batch 4, ITERS iterations at H x W)
PFT_B, PFT_EPOCHS, PFT_TIMED = 4, 20, 3
# kernel- vs plain-sampler PFT call, from one state, cuDNN deterministic.
# The first step's gradient (by each trainable tensor) is held as phase
# "train" holds the step's (step_grad_limits: max(STEP_GRAD_TOL,
# STEP_SPREAD_FACTOR x the plain gradient's own spread), at most
# STEP_GRAD_CAP). The whole call: the first epoch's loss (no update before
# it) within STEP_LOSS_TOL; the losses, poses_opt and disp_opt each within
# max(PFT_TOL, PFT_SPREAD_FACTOR x the plain call's own spread), at most
# PFT_CAP, as relative L2. The spreads: the plain run again with its loss
# scaled one ulp above and one below 1 (STEP_LOSS_SCALES) and the gradients
# scaled back (two more reruns since, below). Adam's first step is
# ~lr·sign(g), so a gradient within rounding of 0 moves its weight by 2·lr
# from one run to the other, and 19 steps carry that far. Measured on an
# H100 (python -m
# tcsfm_torch.step_grad_spread --pft, three states in each of three
# processes, and this phase): the plain call's own spread, relative L2,
# 5.9e-4..1.3e-2 (losses), 9.3e-3..3.7e-2 (poses_opt), 1.3e-2..9.9e-2
# (disp_opt), on this phase's state 3.1e-2..4.1e-2 (disp_opt); the kernel
# call at most 1.33x its spread and 7.3e-2 (disp_opt; 4.2e-2 on this
# phase's state). PFT_CAP is 1.5x the largest spread read, 9.9e-2. The
# first step's gradients: 2.3e-6..2.7e-6 apart.
# The plain call's spread is the largest of four reruns: the loss scaled
# one ulp above and one below 1, two ulps above (PFT_LOSS_SCALES), and the
# images one ulp up (one_ulp_up). One reading alone moved ~10x from run to
# run: a kernel call 1.193e-3 from the plain one failed a limit of 4x a
# reading of 2.181e-4 where other runs read 3.7e-4-2.1e-3
PFT_TOL = 1e-5
PFT_SPREAD_FACTOR = 4
PFT_CAP = 0.15
PFT_LOSS_SCALES = STEP_LOSS_SCALES + (1.0 + 2.0 ** -22,)
PFT_FIELDS = ("losses", "poses_opt", "disp_opt")
# a small PFT call (B=2, S=2, 64x96, 3 epochs, trained-like) on the card
# against the same call on the CPU: the first loss within PFT_CPU_LOSS_TOL
# relative (a pixel that enters or leaves the automask, whose comparison
# f32 does not resolve, moves the loss by ~1/12,288 of its error; measured
# 3.4e-5), the first step's gradients within REF_GRAD_TOL_F32 relative
# L2 (f32 resolves this loss's gradient only to ~1e-2, as the training
# step's), and the call's losses, poses_opt and disp_opt within
# PFT_CPU_TOL relative L2. Adam's first step is ~lr·sign(g) on every
# weight, and a gradient that f32 does not resolve takes either sign, so
# the card's call and the CPU's part further than a rerun of either does
# with its loss scaled one ulp (on an H100: card vs CPU 7.2e-4 to 7.6e-4
# in the losses, 2.4e-2 in poses_opt, 1.8e-2 in disp_opt; the CPU call's
# own spread 8.5e-5, 2.0e-3, 2.3e-4)
PFT_SMALL = (2, 64, 96, 3)
PFT_CPU_LOSS_TOL = 1e-4
PFT_CPU_TOL = 0.1
# phase "sequence": the committed 1504-frame drive at 192x640 through
# evaluate_vo (batch 8, 4 iterations: 1503 pair windows), a 64-frame cut
# of it with the kernel and with the plain sampler, run_sequential_pft's
# four refiners on synthetic 192x640 sequences (window batch 4; adam 20
# epochs in encoder mode, ba and gn at the CLI's 20 epochs, 10 frames;
# chain 23 frames, two blocks of 12), and the two CLIs card vs CPU at 64x96
SEQ_DRIVE, SEQ_DRIVE_FRAMES = ".flagship_data/drive1504_192x640", 1504
SEQ_BATCH, SEQ_CUT, SEQ_WB = 8, 64, 4
SEQ_FRAMES, SEQ_CHAIN_FRAMES, SEQ_CHAIN_BLOCK = 10, 23, 12
# card vs CPU: two f32 runs of the pose chain agree where the CPU run
# agrees with itself with its images one ulp up: the pose vectors and the
# DNet scales are each held at SEQ_SPREAD_FACTOR x their own spread, at
# least SEQ_TOL, at most SEQ_CAP (f32 does not resolve the chain past
# ~2e-4 where a pixel crosses the valid mask's border, ROADMAP §3); the
# printed errors are rounded to 3 decimals, so they are held at one unit
# of it, SEQ_ERR_TOL
SEQ_TOL, SEQ_SPREAD_FACTOR, SEQ_CAP = 1e-5, 4, 1e-3
SEQ_ERR_TOL = 1e-3
# phase "eval": the evaluation CLIs on the committed drive's frames. Eigen
# at the test split's 697 frames (JPEGs at 192x640 in the Eigen index
# layout, GT depth x30 to metres nearest-resized to KITTI raw's 375x1242),
# batch 4, flip-merged, its --pred_disps replay, and 4 frames card vs CPU
# (the scaled disparity held at the forward's CPU_TOL on the sigmoid, times
# the scaled disparity's range 1/min_depth - 1/max_depth); ScanNet on the
# drive's first 200 frames (gap 8: 184 windows in batches of 4, 8
# iterations); golden_eval's real table on the first 256 frames as 09_02
# (batch 8, ITERS iterations), and its --synthetic gate at its defaults
EVAL_EIGEN_FRAMES, EVAL_GT_SHAPE, EVAL_BATCH = 697, (375, 1242), 4
EVAL_SCENE_FRAMES, EVAL_GAP, EVAL_SCANNET_ITERS = 200, 8, 8
EVAL_REAL_FRAMES, EVAL_CPU_FRAMES = 256, 4
EVAL_CPU_TOL = CPU_TOL
# the keys of golden_eval --synthetic's result, and of its gates (the JAX
# package's, tcsfm/cli/golden_eval.py:390-406, :472-482)
GOLDEN_RAW_KEYS = (
    "mode", "train_loss_first", "train_loss_last", "rot_err_untrained",
    "rot_err_trained", "trans_dir_err_untrained", "trans_dir_err_trained",
    "ate_untrained", "ate_trained", "abs_rel_untrained", "abs_rel_trained",
    "ate_pft_init", "ate_pft_opt", "pft_loss_first", "pft_loss_last")
GOLDEN_GATES = ("trained_beats_untrained", "trained_depth_absolute",
                "pft_loss_decreases", "pft_no_trajectory_regression")

# phase "flow": classical flow at 192x640. The Farneback pair card vs CPU
# on FLOW_PAIRS of the drive, held at FLOW_SPREAD_FACTOR x the CPU run's
# own spread with its images one ulp up, at least FLOW_TOL px; a textured
# frame's known sub-pixel shift FLOW_SHIFT recovered within
# tests/test_flow.py's FLOW_SHIFT_TOL px; evaluate_vo --iterations 1 over
# the drive's first FLOW_VO_FRAMES frames (batch SEQ_BATCH); the panels
# (FLOW_PANELS samples); the legacy inverse_warp on FLOW_WARP_SHAPE; the
# SE(3) maps card vs CPU on FLOW_SE3_N vectors within CPU_TOL
FLOW_PAIRS = ((0, 1), (700, 701))
FLOW_TOL, FLOW_SPREAD_FACTOR = 1e-5, 4
FLOW_SHIFT, FLOW_SHIFT_TOL = (1.5, -1.0), 0.3
FLOW_VO_FRAMES, FLOW_PANELS, FLOW_TIMED = 256, 3, 5
FLOW_WARP_SHAPE = (6, 192, 640, 3)
FLOW_SE3_N = 1024
FLOW_KERNEL = "grid_sample_fwd_kernel"


T0 = time.monotonic()


def say(phase: str, msg: str) -> None:
    print(f"[{time.monotonic() - T0:7.2f}s] {phase}: {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """ms per call of ``fn`` between CUDA events around a loop of calls
    from the host: what a Python caller pays per call (the wrapper loop).
    Where the host takes longer per call than the card, this measures the
    host."""
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


def queued(torch, enqueue) -> None:
    """Call ``enqueue()`` behind a spin kernel and wait for the card.
    ``enqueue`` records CUDA events around its work and returns the first
    of them. The spin doubles until the host has queued all of the work
    before the card reaches that event, so no host gap lies between the
    events."""
    cycles = SLEEP_CYCLES
    while True:
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        first = enqueue()
        ahead = not first.query()
        torch.cuda.synchronize()
        if ahead:
            return
        check(cycles < 64 * SLEEP_CYCLES, f"the host did not queue the "
              f"timed work within a spin of {cycles} cycles")
        cycles *= 2


def device_ms(torch, fn, iters: int = TIMED) -> float:
    """Device ms per call of ``fn``: ``iters`` calls back to back on the
    card, with no host gap between them (``queued``)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")

    def enqueue():
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        return start

    queued(torch, enqueue)
    return start.elapsed_time(end) / iters


def flushed_ms(torch, fn, flush, iters: int = FLUSHED) -> float:
    """Median device ms of one call of ``fn`` with the L2 flushed before
    it: ``flush`` (FLUSH_BYTES) is written before each call, outside the
    call's events."""
    events = [tuple(torch.cuda.Event(enable_timing=True) for _ in "se")
              for _ in range(iters)]

    def enqueue():
        for start, end in events:
            flush.zero_()
            start.record()
            fn()
            end.record()
        return events[0][0]

    queued(torch, enqueue)
    return statistics.median(s.elapsed_time(e) for s, e in events)


def warm_up(torch, *fns) -> None:
    """WARMUP_S of calls of ``fns``, so that the card's clocks are up."""
    t = time.monotonic()
    while time.monotonic() - t < WARMUP_S:
        for fn in fns:
            fn()
        torch.cuda.synchronize()


def in_turns(torch, kernel, library=None, iters=TIMED):
    """Device ms per call (``device_ms``) of ``kernel`` and ``library`` in
    TURNS rounds of kernel, library, library, kernel (kernel, kernel where
    there is no library). Returns the two lists of samples in turn order."""
    k, lib = [], []
    for _ in range(TURNS):
        k.append(device_ms(torch, kernel, iters))
        if library is not None:
            lib += [device_ms(torch, library, iters),
                    device_ms(torch, library, iters)]
        k.append(device_ms(torch, kernel, iters))
    return k, lib


def with_clocks(fn):
    """``fn()`` while ``nvidia-smi`` samples the card's SM and memory
    clocks, power draw and temperature every 50 ms (the first sample taken
    before ``fn`` starts). Returns fn's result and each quantity's range
    over the samples."""
    proc = subprocess.Popen(
        ["nvidia-smi", f"--query-gpu={CLOCK_FIELDS}",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        first = proc.stdout.readline()
        check(bool(first.strip()), "nvidia-smi gave no clock sample")
        result = fn()
    finally:
        proc.terminate()
        rest = proc.communicate(timeout=30)[0]
    samples = [[float(v) for v in line.split(",")]
               for line in (first + rest).splitlines()
               if len(line.split(",")) == 4
               and "N/A" not in line]
    check(bool(samples), f"no readable clock sample: {first!r}")
    clocks = {name: [min(col), max(col)] for name, col in zip(
        ("sm_mhz", "mem_mhz", "power_w", "temp_c"), zip(*samples))}
    clocks["samples"] = len(samples)
    return result, clocks


def timed(torch, kernel, library, flush, library_key="library_ms",
          iters=TIMED):
    """A kernel's times on the card: device time in turns with a library
    call (``in_turns``; median and range), the clocks beside them, the
    wrapper loop's time per call (``time_ms``), and the device time of one
    call with the L2 flushed before it (``flushed_ms``), of both. The
    library's figures go under ``library_key`` (``library_ms`` where one
    library call computes the same function)."""
    (k, lib), clocks = with_clocks(lambda: in_turns(torch, kernel, library,
                                                    iters))
    row = dict(ms=statistics.median(k), ms_range=[min(k), max(k)],
               ms_turns=k, launches_per_sample=iters,
               wrapper_ms=time_ms(kernel),
               ms_l2_flushed=flushed_ms(torch, kernel, flush), clocks=clocks)
    if library is not None:
        row.update({
            library_key: statistics.median(lib),
            f"{library_key}_range": [min(lib), max(lib)],
            f"{library_key}_turns": lib,
            f"{library_key}_l2_flushed": flushed_ms(torch, library, flush),
            "faster_in_every_turn": all(
                max(k[2 * i:2 * i + 2]) < min(lib[2 * i:2 * i + 2])
                for i in range(TURNS))})
    return row


def us(ms) -> str:
    return f"{ms * 1e3:.2f}"


def times_text(row, library_key="library_ms", library="library") -> str:
    """The times of ``timed`` as one line of text."""
    text = (f"device {us(row['ms'])} us (range {us(row['ms_range'][0])}-"
            f"{us(row['ms_range'][1])}, {2 * TURNS} samples of "
            f"{row['launches_per_sample']} launches)")
    if row.get(library_key) is not None:
        lo, hi = row[f"{library_key}_range"]
        text += (f", {library} {us(row[library_key])} us (range {us(lo)}-"
                 f"{us(hi)}), kernel faster in every turn: "
                 f"{row['faster_in_every_turn']}")
    text += (f"; L2 flushed: kernel {us(row['ms_l2_flushed'])} us"
             + (f", {library} {us(row[library_key + '_l2_flushed'])} us"
                if row.get(library_key) is not None else "")
             + f"; wrapper loop {us(row['wrapper_ms'])} us")
    c = row["clocks"]
    return text + (f"; clocks SM {c['sm_mhz'][0]:.0f}-{c['sm_mhz'][1]:.0f} "
                   f"MHz, memory {c['mem_mhz'][0]:.0f}-{c['mem_mhz'][1]:.0f} "
                   f"MHz, {c['power_w'][0]:.2f}-{c['power_w'][1]:.2f} W, "
                   f"{c['temp_c'][0]:.0f}-{c['temp_c'][1]:.0f} C over "
                   f"{c['samples']} samples")


def cycling(pairs, fn):
    """A call of ``fn`` on the next of ``pairs`` (in turn) each time."""
    it = itertools.cycle(pairs)
    return lambda: fn(*next(it))


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
            name = mangled = m.group(1)
            # the mangled name's length-prefixed parts: the one naming a
            # kernel, with its template arguments (integers, bools)
            pos = 0
            while (part := re.compile(r"(\d+)").search(name, pos)):
                end = part.end() + int(part.group(1))
                if "kernel" in name[part.end():end]:
                    name = name[part.end():end]
                    args = re.match(r"I((?:L\w\d+E)+)E", mangled[end:])
                    if args:
                        name += "<" + ", ".join(re.findall(
                            r"L\w(\d+)E", args.group(1))) + ">"
                    break
                pos = end
            while name in found:    # another instantiation of a template
                name += "'"
            found[name] = []
        elif name is not None and re.search(r"registers|spill|stack", line):
            found[name].append(line.split(":", 1)[-1].strip()
                               if "ptxas" in line else line.strip())
    return {k: "; ".join(v) for k, v in found.items()}


def sass_of(lib, kernel: str) -> dict:
    """``cuobjdump -sass`` of the library's instances of ``kernel`` (the
    sampler kernels are templates on (C, a bool)): for each instance, by
    its template arguments (C, the bool), the counts of its global loads
    and stores, of those that move 128 bits, of its calls (a division
    routine is a call) and of its global reductions."""
    import re
    from pathlib import Path

    from tcsfm_torch.ops._build import find_nvcc

    text = subprocess.run(
        [str(Path(find_nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
        capture_output=True, text=True, timeout=120, check=True).stdout
    found = {}
    for part in text.split("Function : ")[1:]:
        m = re.search(rf"{kernel}ILi(\d+)ELb([01])E", part.split()[0])
        if m:
            found[int(m.group(1)), m.group(2) == "1"] = {
                k: len(re.findall(rf"\b{op}", part)) for k, op in (
                    ("ldg", r"LDG(\.\w+)*\b"),
                    ("ldg128", r"LDG(\.\w+)*\.128\b"),
                    ("stg", r"STG(\.\w+)*\b"),
                    ("stg128", r"STG(\.\w+)*\.128\b"),
                    ("calls", r"CALL(\.\w+)*\b"),
                    ("red", r"REDG?(\.\w+)*\b"))}
    return found


def library_sampler(img, coords):
    """``F.grid_sample`` on the NHWC image (an NCHW view of it): one
    PyTorch call that computes the forward kernel's function."""
    import torch.nn.functional as F

    return F.grid_sample(img.permute(0, 3, 1, 2), coords, mode="bilinear",
                         padding_mode="zeros", align_corners=False)


def bound(nbytes: float, flops: float) -> dict:
    """The least time for ``nbytes`` moved and ``flops`` f32 operations."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def main_path_warps(torch, gs, cfg, build_models, coupled_forward):
    """The (image, coords) pairs that the coupled forward's ITERS - 1
    pose-only re-warps hand to the sampler: phase "slice"'s forward (med
    res, B=6, S=2) under phase "tail"'s trained-like conditioning and
    smooth images, recorded through ``coupled_forward``'s ``sampler=``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    depth_net, pose_net = build_models(
        cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    condition_like_trained(depth_net, torch)
    inputs = [torch.from_numpy(a).cuda()
              for a in smooth_inputs(torch, B, S, H, W, seed=0)]
    warps = []

    def recording(img, coords, tail=None):
        warps.append((img, coords))
        return gs.grid_sample(img, coords, tail)

    coupled_forward(depth_net, pose_net, *inputs, cfg, sampler=recording)
    check(len(warps) == ITERS - 1 and all(
        tuple(img.shape) == (2 * S * B, H, W, 3) for img, _ in warps),
        f"the coupled forward's re-warps: {[tuple(i.shape) for i, _ in warps]}")
    return warps


def refiner_jvp_samples(torch, gs, build_models):
    """The (image, coords) pairs of the first JVP_SAMPLES value+Jacobian
    launches at full resolution of phase "refiners"' ``window_ba``
    ([RB,H,W,3]) and ``chain_ba`` ([BLOCK-2,H,W,3]) calls, on that
    phase's inputs: the first LM iteration's jvps (``iters=1`` gives the
    same ones; chain_ba's coarse level runs before them)."""
    from tcsfm_torch.config import Config
    from tcsfm_torch.solver.ba import chain_ba, window_ba

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config(iterations=RITERS, num_scales=1, minibatch=RB,
                 img_resolution="med", compute_dtype="float32")
    depth_net, pose_net, (tgt, src, K), block = refiner_inputs(
        torch, cfg, build_models, seed=7)
    depths, poses = forward_depths(torch, cfg, depth_net, pose_net, tgt, src,
                                   K)
    seen = {RB: [], BLOCK - 2: []}
    launch = gs._launch_fwd_grads

    def recording(img, coords):
        got = seen.get(img.shape[0])
        if (got is not None and tuple(img.shape[1:3]) == (H, W)
                and len(got) < JVP_SAMPLES):
            got.append((img, coords))
        return launch(img, coords)

    gs._launch_fwd_grads = recording
    try:
        window_ba(poses[0], poses[1], depths[0], tgt, src[0], src[1],
                  depths[1], depths[2], K, iters=1, depth_prior_weight=0.1)
        chain_ba(*block, iters=1, depth_prior_weight=0.1, pyramid_levels=2)
    finally:
        gs._launch_fwd_grads = launch
    check(all(len(v) == JVP_SAMPLES for v in seen.values()),
          f"recorded value+Jacobian launches: "
          f"{ {k: len(v) for k, v in seen.items()} }")
    return seen


def sampler_row(torch, gs, pairs, flush):
    """The forward kernel against its plain version and ``F.grid_sample``
    on each (img, coords) of ``pairs``, and timed (``timed``) cycling
    through them."""
    err = lib_err = 0.0
    for img, coords in pairs:
        out = gs.grid_sample(img, coords)
        err = max(err, (out - gs.grid_sample_plain(img, coords)).abs().max()
                  .item())
        lib_err = max(lib_err, (library_sampler(img, coords).permute(
            0, 2, 3, 1) - out).abs().max().item())
    kernel = cycling(pairs, gs.grid_sample)
    library = cycling(pairs, library_sampler)
    warm_up(torch, kernel, library)
    row = timed(torch, kernel, library, flush)
    img, coords = pairs[0]
    row.update(max_abs_err=err, max_abs_err_library=lib_err,
               plain_ms=time_ms(lambda: gs.grid_sample_plain(img, coords),
                                iters=10))
    return row


def phase_kernels(torch, gs, warps, flush):
    """The forward kernel vs its plain version at [24,192,640,C], and its
    times: C=3 at the main path's own coordinates (``warps``) and at
    ``smoke_coords``, C=4 at ``smoke_coords``. Returns the rows by C, the
    main path's (C=3) holding the smoke_coords row under "smoke_coords"."""
    import numpy as np

    n = 2 * S * B
    coords = torch.from_numpy(smoke_coords(n, H, W, seed=1)).cuda()
    imgs = {c: torch.from_numpy(np.random.RandomState(c).rand(
        n, H, W, c).astype(np.float32)).cuda() for c in (3, 4)}
    rows = {}
    for c, label, pairs in ((3, "main-path coords", warps),
                            (3, "smoke_coords", [(imgs[3], coords)]),
                            (4, "smoke_coords", [(imgs[4], coords)])):
        row = sampler_row(torch, gs, pairs, flush)
        check(row["max_abs_err"] <= KERNEL_TOL, f"grid_sample C={c}, "
              f"{label}: kernel vs plain max abs err {row['max_abs_err']} > "
              f"{KERNEL_TOL}")
        nbytes = (2 + 2 * c) * n * H * W * 4     # img, coords, out
        row.update(bound(nbytes, n * H * W * (18 + 7 * c)), coords=label)
        row["in_view"] = statistics.mean(
            (co.abs() <= 1).all(-1).float().mean().item() for _, co in pairs)
        say("kernels", f"grid_sample [{n},{H},{W},{c}], {label}"
            f"{f' ({len(pairs)} re-warps in turn)' if len(pairs) > 1 else ''}"
            f", {row['in_view']:.1%} of the pixels in view"
            f": max|kernel-plain| {row['max_abs_err']:.3e} (limit "
            f"{KERNEL_TOL}), max|kernel-F.grid_sample| "
            f"{row['max_abs_err_library']:.3e}; "
            + times_text(row, library="F.grid_sample")
            + f"; plain {us(row['plain_ms'])} us; bound "
            f"{us(row['bound_ms'])} us ({row['bound_by']}: "
            f"{nbytes / 1e6:.2f} MB), kernel at "
            f"{row['bound_ms'] / row['ms']:.1%} of bound")
        if label == "smoke_coords" and c == 3:
            rows[3]["smoke_coords"] = row
        else:
            rows[c] = row
    # what the card's own copy reaches on these bytes: the image copied
    # (read once, written once), device time as above
    img = warps[0][0]
    dst = torch.empty_like(img)
    copy_ms = device_ms(torch, lambda: dst.copy_(img))
    moved = 2 * img.numel() * 4
    per_ms = moved / copy_ms                  # bytes a ms
    needed = rows[3]["bound_ms"] * HBM_BYTES_PER_S / 1e3
    rows[3].update(copy_ms=copy_ms, copy_tb_s=per_ms / 1e9,
                   bytes_at_copy_rate_ms=needed / per_ms)
    say("kernels", f"the card's copy_ of [{n},{H},{W},3]: {us(copy_ms)} us "
        f"for {moved / 1e6:.2f} MB, {per_ms / 1e9:.3f} TB/s; at that rate "
        f"the forward's {needed / 1e6:.2f} MB take {us(needed / per_ms)} us, "
        f"the kernel at {needed / per_ms / rows[3]['ms']:.1%} of it")
    return rows


def train_step_bwd_samples(torch, gs, cfg, create_train_state, train_step):
    """The (img, coords, g, grad_ch) of every backward kernel launch of one
    training step in phase "train"'s setting (``train_setting``: med res,
    B=6, S=2, 4 iterations, trained-like conditioning, f32, TF32 off), for
    each of STEP_GRAD_VARIANTS, recorded as detached clones through
    ``gs.grid_sample_bwd`` (which ``_GridSampleBwd.forward`` looks up at
    call time). Returns the defaults' ITERS - 1 d_coords-only launches (the
    solver's pose-only re-warps, [24,192,640,3]) under "coords", and the
    d_img launch (the loss warp, [24,192,640,4], grad_ch=(3,)) with the
    depth terms on under "img" (its g reaches the depth channel) and under
    the defaults under "img defaults" (the depth channel's g is 0)."""
    import copy
    import dataclasses

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state, batch = train_setting(torch, cfg, create_train_state)
    launch = gs.grid_sample_bwd
    seen = {label: [] for label, _ in STEP_GRAD_VARIANTS}
    current = []

    def recording(img, coords, g, grad_ch=()):
        current.append((img.detach().clone(), coords.detach().clone(),
                        g.detach().clone(), tuple(grad_ch)))
        return launch(img, coords, g, grad_ch)

    gs.grid_sample_bwd = recording
    try:
        for label, extra in STEP_GRAD_VARIANTS:
            current = seen[label]
            st = copy.deepcopy(state)
            st.cfg = dataclasses.replace(cfg, **extra)
            train_step(st, batch)
            torch.cuda.synchronize()
            del st
    finally:
        gs.grid_sample_bwd = launch
    n = 2 * S * B
    want = sorted([((n, H, W, 3), ())] * (ITERS - 1) + [((n, H, W, 4), (3,))])
    for label, got in seen.items():
        shapes = sorted((tuple(s[0].shape), s[3]) for s in got)
        check(shapes == want, f"{label}: the training step's backward "
              f"launches {shapes}, expected {want}")

    def pick(label, grad_ch):
        return [s for s in seen[label] if s[3] == grad_ch]

    samples = {"coords": pick("defaults", ()),
               "img": pick("depth terms on", (3,)),
               "img defaults": pick("defaults", (3,))}
    depth_g = [s[2][..., 3].abs().max().item()
               for s in samples["img"] + samples["img defaults"]]
    check(depth_g[0] > 0 and depth_g[1] == 0, f"the loss warp's depth-channel "
          f"g, depth terms on and defaults: {depth_g}")
    return samples


def bwd_tile_boxes(torch, coords, cg, tile):
    """The box of d_img that the in-image taps of each tile (``tile``:
    rows by pixels) of ``coords`` [B,H,W,2] span: its rows by its float
    columns, widened to 16 bytes (Cg floats a pixel). Returns the floats of
    each tile's box, 0 for a tile with no in-image tap (a pushed coordinate
    has none)."""
    import torch.nn.functional as F

    b, h, w, _ = coords.shape
    x = ((coords[..., 0] + 1.0) * w - 1.0) * 0.5
    y = ((coords[..., 1] + 1.0) * h - 1.0) * 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    vx0, vx1 = (x0 >= 0) & (x0 <= w - 1), (x0 >= -1) & (x0 <= w - 2)
    vy0, vy1 = (y0 >= 0) & (y0 <= h - 1), (y0 >= -1) & (y0 <= h - 2)
    inside = (vx0 | vx1) & (vy0 | vy1)
    big = float(1 << 30)
    rows, run = tile

    def reduce(lo, hi, on_lo, on_hi):
        """min of the tile's first in-image tap, max of its last."""
        first = torch.where(inside, torch.where(on_lo, lo, lo + 1), big)
        last = torch.where(inside, torch.where(on_hi, hi + 1, hi), -big)
        out = []
        for t, fill, fn in ((first, big, torch.amin),
                            (last, -big, torch.amax)):
            t = F.pad(t, (0, -w % run, 0, -h % rows), value=fill)
            out.append(fn(t.reshape(b, t.shape[1] // rows, rows,
                                    t.shape[2] // run, run), dim=(2, 4)))
        return out

    c_lo, c_hi = reduce(x0, x0, vx0, vx1)
    r_lo, r_hi = reduce(y0, y0, vy0, vy1)
    empty = c_lo >= big
    c_lo, c_hi = (torch.where(empty, 0.0, t).double() for t in (c_lo, c_hi))
    r_lo, r_hi = (torch.where(empty, 0.0, t).double() for t in (r_lo, r_hi))
    cols = (torch.ceil((c_hi + 1) * cg / 4) - torch.floor(c_lo * cg / 4)) * 4
    return torch.where(empty, 0.0, cols * (r_hi - r_lo + 1)).reshape(-1)


def tap_spread_text(torch, launches):
    """How far the d_img launches' taps spread: for each tile shape of
    BWD_TAP_BOXES, the median and largest box of d_img a tile's taps span
    (``bwd_tile_boxes``) and the shares of tiles whose box fits each size.
    Returns the text and the numbers."""
    parts, spread = [], {}
    for tile, sizes in BWD_TAP_BOXES.items():
        floats = torch.cat([bwd_tile_boxes(torch, coords, len(grad_ch), tile)
                            for _, coords, _, grad_ch in launches])
        live = floats[floats > 0]
        fits = {k: ((floats <= k) & (floats > 0)).double().mean().item()
                for k in sizes}
        stats = dict(tiles=floats.numel(), empty=floats.numel() - live.numel(),
                     median=live.median().item() if live.numel() else 0.0,
                     max=live.max().item() if live.numel() else 0.0,
                     fits=fits)
        spread[f"{tile[0]}x{tile[1]}"] = stats
        parts.append(
            f"{tile[0]}x{tile[1]} tiles: {stats['empty']} of {stats['tiles']} "
            f"without an in-image tap, box median {stats['median']:.0f} and "
            f"max {stats['max']:.0f} floats, fitting " + ", ".join(
                f"{k}: {v:.1%}" for k, v in fits.items()))
    return "the taps' d_img boxes: " + "; ".join(parts), spread


def spread_coords(b, h, w, seed):
    """Coords uniform in [-1.2, 1.2] (taps scattered over the whole
    image), 5% pushed to 2.0."""
    import numpy as np

    rng = np.random.RandomState(seed)
    c = rng.uniform(-1.2, 1.2, (b, h, w, 2))
    c[rng.rand(b, h, w) < 0.05] = 2.0
    return c.astype(np.float32)


def bwd_set_row(torch, gs, name, label, launches, flush):
    """One backward kernel on ``launches`` (each (img, coords, g, grad_ch),
    launched in turn): d_coords bit-equal to grid_sample_bwd_plain's, d_img
    within BWD_IMG_TOL of it, and the kernel's times (``timed``) beside
    aten.grid_sampler_2d_backward's on the same inputs."""
    err = img_err = lib_err = 0.0
    lib_args = []
    for img, coords, g, grad_ch in launches:
        d_coords, d_img = gs.grid_sample_bwd(img, coords, g, grad_ch)
        ref_coords, ref_img = gs.grid_sample_bwd_plain(img, coords, g,
                                                       grad_ch)
        err = max(err, (d_coords - ref_coords).abs().max().item())
        if grad_ch:
            img_err = max(img_err, (d_img - ref_img).abs().max().item())
            live = bool((g[..., list(grad_ch)] != 0).any())
            check((d_img.abs().max().item() > 0) == live, f"{name}, {label}: "
                  f"d_img max {d_img.abs().max().item()}, g of its channels "
                  f"non-zero: {live}")
        mask = [bool(grad_ch), True]
        args = (g.permute(0, 3, 1, 2), img.permute(0, 3, 1, 2), coords, mask)
        lib_args.append(args)
        lib = torch.ops.aten.grid_sampler_2d_backward(*args[:3], 0, 0, False,
                                                      mask)
        lib_err = max(lib_err, ((lib[1] - d_coords).abs().max()
                                / ref_coords.abs().max()).item())
    check(err == 0, f"{name}, {label}: d_coords max|kernel-plain| {err}, "
          f"not bit-equal")
    check(img_err <= BWD_IMG_TOL, f"{name}, {label}: d_img max abs err "
          f"{img_err} > {BWD_IMG_TOL}")
    kernel = cycling(launches, gs.grid_sample_bwd)
    library = cycling(lib_args, lambda gg, ii, cc, m: (
        torch.ops.aten.grid_sampler_2d_backward(gg, ii, cc, 0, 0, False, m)))
    warm_up(torch, kernel, library)
    row = timed(torch, kernel, library, flush)
    img, coords, g, grad_ch = launches[0]
    n, h, w, c = img.shape
    # each input read once, each output written once: img, coords, g;
    # d_coords and the d_img channels (its zero-fill not counted)
    planes = c + 2 + c + 2 + len(grad_ch)
    nbytes = planes * n * h * w * 4
    row.update(bound(nbytes, n * h * w * (20 + 14 * c + 8 * len(grad_ch))),
               max_abs_err=max(err, img_err), coords=label,
               d_coords_max_abs_err=err, d_img_max_abs_err=img_err,
               max_rel_err_library=lib_err, bytes=nbytes,
               plain_ms=time_ms(lambda: gs.grid_sample_bwd_plain(
                   img, coords, g, grad_ch), iters=10),
               in_view=statistics.mean(
                   (co.abs() <= 1).all(-1).float().mean().item()
                   for _, co, _, _ in launches))
    return row


def phase_bwd_kernels(torch, gs, samples, flush):
    """The backward kernels vs grid_sample_bwd_plain and timed beside
    aten.grid_sampler_2d_backward: d_coords only at [24,192,640,3] (the
    solver's warps), d_img for channel 3 at [24,192,640,4] (the loss
    warp); each at the training step's own inputs (``samples``, from
    ``train_step_bwd_samples``: the solver's three launches in turn; the
    loss warp's with the depth terms on, and under the defaults), at
    ``smoke_coords`` (random image and g; d_coords' sha256 as recorded in
    BWD_SMOKE_SHA256) and at ``spread_coords``. For the d_img kernel,
    how far its taps spread (``tap_spread_text``). Returns the rows by kernel
    name, the training step's row holding the others by label."""
    import numpy as np

    n = 2 * S * B
    smoke = torch.from_numpy(smoke_coords(n, H, W, seed=1)).cuda()
    rows = {}
    for name, c, grad_ch, step_sets in (
            ("grid_sample_bwd_coords", 3, (), (
                ("training step", samples["coords"]),)),
            ("grid_sample_bwd_img", 4, (3,), (
                ("training step, depth terms on", samples["img"]),
                ("training step, defaults", samples["img defaults"])))):
        rng = np.random.RandomState(10 + c)
        img = torch.from_numpy(rng.rand(n, H, W, c).astype(np.float32)).cuda()
        g = torch.from_numpy(rng.randn(n, H, W, c).astype(np.float32)).cuda()
        spread = torch.from_numpy(spread_coords(n, H, W, seed=30 + c)).cuda()
        sets = (*step_sets, ("smoke_coords", [(img, smoke, g, grad_ch)]),
                ("spread_coords", [(img, spread, g, grad_ch)]))
        for label, launches in sets:
            row = bwd_set_row(torch, gs, name, label, launches, flush)
            paths = ""
            if grad_ch:
                paths, row["tap_boxes"] = tap_spread_text(torch, launches)
                paths = f"; {paths}"
            if label == "smoke_coords":
                d_coords, _ = gs.grid_sample_bwd(img, smoke, g, grad_ch)
                row["d_coords_sha256"] = hashlib.sha256(
                    d_coords.cpu().numpy().tobytes()).hexdigest()[:16]
                check(row["d_coords_sha256"] == BWD_SMOKE_SHA256[name],
                      f"{name}: d_coords sha256 {row['d_coords_sha256']} at "
                      f"smoke_coords, recorded {BWD_SMOKE_SHA256[name]}")
                paths += f"; d_coords sha256 {row['d_coords_sha256']}"
            shape = tuple(launches[0][0].shape)
            turns = (f" ({len(launches)} launches in turn)"
                     if len(launches) > 1 else "")
            say("kernels", f"{name} {list(shape)} grad_ch={grad_ch}, {label}"
                f"{turns}, {row['in_view']:.1%} of the pixels in view: "
                f"max|kernel-plain| d_coords {row['d_coords_max_abs_err']:.3e}"
                f" (bit-equal required), d_img "
                f"{row['d_img_max_abs_err']:.3e} (limit {BWD_IMG_TOL}); "
                f"max|kernel-aten| d_coords {row['max_rel_err_library']:.3e} "
                f"of its magnitude{paths}; kernel (d_img zero-fill "
                f"included) " + times_text(
                    row, library="aten.grid_sampler_2d_backward")
                + f"; plain {us(row['plain_ms'])} us; bound "
                f"{us(row['bound_ms'])} us ({row['bound_by']}: "
                f"{row['bytes'] / 1e6:.2f} MB), kernel at "
                f"{row['bound_ms'] / row['ms']:.1%} of bound")
            if label.startswith("training step") and name not in rows:
                rows[name] = row
            else:
                rows[name][label.replace(" ", "_").replace(",", "")] = row
    return rows


def phase_bwd_only(torch):
    """Phase "kernels"' backward kernels alone (``phase_bwd_kernels``), on
    whatever ``tcsfm_torch`` is imported: how a parent tree's backward
    kernels are timed in the same call (README): ``python3 -c "import
    torch, chip_smoke as c; c.phase_bwd_only(torch)"``."""
    from tcsfm_torch.ops import grid_sample as gs
    from tcsfm_torch.train.trainer import create_train_state, train_step

    samples = train_step_bwd_samples(torch, gs, med_config(),
                                     create_train_state, train_step)
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    return phase_bwd_kernels(torch, gs, samples, flush)


def phase_grads_kernel(torch, gs, jvp_samples, flush):
    """The value+Jacobian kernel vs grid_sample_with_grads_plain at the
    refiners' shapes, the window batch [4,192,640,3] and chain_ba's
    interior windows [10,192,640,3], at the refiners' own coordinates
    (``jvp_samples``) and at ``smoke_coords``, and its times. Returns the
    rows by batch, each holding its smoke_coords row under
    "smoke_coords"."""
    import numpy as np

    rows = {}
    for b in (RB, BLOCK - 2):
        smoke = (torch.from_numpy(np.random.RandomState(20 + b).rand(
            b, H, W, 3).astype(np.float32)).cuda(),
            torch.from_numpy(smoke_coords(b, H, W, seed=1)).cuda())
        for label, pairs in (("refiners' coords", jvp_samples[b]),
                             ("smoke_coords", [smoke])):
            err, errs = 0.0, [0.0, 0.0]
            for img, coords in pairs:
                got = gs.grid_sample_with_grads(img, coords)
                ref = gs.grid_sample_with_grads_plain(img, coords)
                err = max(err, (got[0] - ref[0]).abs().max().item())
                for i in (1, 2):
                    scale = ref[i].abs().max().item()
                    e = (got[i] - ref[i]).abs().max().item()
                    check(e <= GRADS_TOL * scale, f"with_grads [{b},{H},{W},"
                          f"3], {label}: {'gx' if i == 1 else 'gy'} max abs "
                          f"err {e} > {GRADS_TOL} x {scale}")
                    errs[i - 1] = max(errs[i - 1], e / scale)
            check(err <= KERNEL_TOL, f"with_grads [{b},{H},{W},3], {label}: "
                  f"out max abs err {err} > {KERNEL_TOL}")
            kernel = cycling(pairs, gs.grid_sample_with_grads)
            context = cycling(pairs, library_sampler)
            warm_up(torch, kernel, context)
            key = "grid_sample_value_only_ms"
            row = timed(torch, kernel, context, flush, library_key=key)
            img, coords = pairs[0]
            nbytes = (3 + 2 + 9) * b * H * W * 4
            row.update(bound(nbytes, b * H * W * (18 + 3 * (7 + 12))),
                       max_abs_err=max(err, *errs), library_ms=None,
                       coords=label, plain_ms=time_ms(
                           lambda: gs.grid_sample_with_grads_plain(
                               img, coords), iters=10))
            say("kernels", f"grid_sample_with_grads [{b},{H},{W},3], {label}"
                f"{f' ({len(pairs)} launches in turn)' if len(pairs) > 1 else ''}"
                f": max|kernel-plain| out {err:.3e} (limit {KERNEL_TOL}), gx, "
                f"gy {errs[0]:.3e}, {errs[1]:.3e} of their magnitude (limit "
                f"{GRADS_TOL}); no library call gives the derivatives; "
                + times_text(row, key, "F.grid_sample value only")
                + f"; plain {us(row['plain_ms'])} us; bound "
                f"{us(row['bound_ms'])} us ({row['bound_by']}: "
                f"{nbytes / 1e6:.2f} MB), kernel at "
                f"{row['bound_ms'] / row['ms']:.1%} of bound")
            if label == "smoke_coords":
                rows[b]["smoke_coords"] = row
            else:
                rows[b] = row
    # the launch floor: one launch on one pixel, back to back
    tiny = [(torch.rand(1, 1, 1, 3, device="cuda"),
             torch.zeros(1, 1, 1, 2, device="cuda"))]
    floor = device_ms(torch, cycling(tiny, gs.grid_sample_with_grads))
    rows[RB]["launch_floor_ms"] = floor
    say("kernels", f"grid_sample_with_grads launch floor: {us(floor)} us a "
        f"launch at [1,1,1,3], back to back ({floor / rows[RB]['ms']:.1%} of "
        f"the [{RB},{H},{W},3] row's device time, "
        f"{floor / rows[RB]['bound_ms']:.1%} of its bound)")
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


def phase_tail_kernel(torch, dt, flush):
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

    def kernel():
        return dt.decoder_tail(x, *ws)

    seq_err = (sequence() - out).abs().max().item()
    warm_up(torch, kernel, sequence)
    key = "library_sequence_ms"
    row = timed(torch, kernel, sequence, flush, library_key=key,
                iters=TAIL_TIMED_LAUNCHES)
    plain_ms = time_ms(lambda: dt.decoder_tail_plain(x, *ws), iters=20)
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
    ms = row["ms"]
    row.update(max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               library_ms=None, bound_f32_fma_ms=max(bytes_ms, fma_ms),
               halo_mac_ratio=halo)
    say("kernels", f"decoder_tail {list(x.shape)}: max|kernel-plain| "
        f"{err:.3e} (limit {TAIL_TOL}), max|kernel-cuDNN layers| "
        f"{seq_err:.3e}; " + times_text(
            row, key, "the default route's cuDNN layer sequence (3 F.pad + "
            "F.conv2d, ELU, sigmoid; no single library call)")
        + f"; plain {us(plain_ms)} us; bound {us(bound_ms)} us "
        f"({row['bound_by']}: {flops / 1e9:.2f} GFLOP as 3xTF32 on the "
        f"tensor cores, {nbytes / 1e6:.2f} MB), kernel at "
        f"{bound_ms / ms:.1%} of it; f32-FMA bound "
        f"{us(row['bound_f32_fma_ms'])} us, kernel at "
        f"{row['bound_f32_fma_ms'] / ms:.1%} of it; executed multiply-adds "
        f"{halo:.3f}x the output's (halo recompute)")
    return row


def phase_tail_bf16_kernel(torch, dt, flush):
    """The bf16 tail kernel vs decoder_tail_plain_bf16 at the coupled
    forward's shape [18,32,192,640] and at [2,32,190,638] (tiles cut short
    on both borders), on the f32 disparity before the cast; at the main
    shape its device time in turns with the default bf16 route's cuDNN
    layer sequence (its library call) and in turns with the f32 tail
    kernel on the same input in f32, the plain version's time, and the
    bound."""
    import math

    from tcsfm_torch.models.layers import ReflConv

    bf16 = torch.bfloat16
    torch.backends.cudnn.allow_tf32 = False    # the plain version's f32 convs
    for shape in TAIL_SHAPES[::-1]:
        x, ws = tail_inputs(torch, shape, sum(shape) + 1)
        x = x.to(bf16)
        out = dt.decoder_tail(x, *ws)
        ref = dt.decoder_tail_plain_bf16(x, *ws)
        torch.cuda.synchronize()
        check(out.dtype == torch.float32, f"bf16 tail returned {out.dtype}")
        diff = (out - ref).abs()
        err = diff.max().item()
        flipped = (diff > 1e-6).float().mean().item()
        check(err <= TAIL_BF16_TOL, f"decoder_tail_bf16 {list(shape)}: "
              f"kernel vs plain max abs err {err} > {TAIL_BF16_TOL}")
        say("kernels", f"decoder_tail_bf16 {list(shape)}: max|kernel-plain| "
            f"{err:.3e} (limit {TAIL_BF16_TOL}), {flipped:.3%} of the pixels "
            f"differ by more than 1e-6 (bf16 rounding flips of elu(x), f1, "
            f"f2)")
    # x, ws and out are the main shape's: the default bf16 route's layers
    seq = torch.nn.Sequential(
        torch.nn.ELU(), ReflConv(32, 32, dtype=bf16), torch.nn.ELU(),
        ReflConv(32, 8, dtype=bf16), torch.nn.ELU(),
        ReflConv(8, 1, dtype=bf16), torch.nn.Sigmoid()).cuda()
    for conv, wt, bias in zip(seq[1::2], ws[0::2], ws[1::2]):
        conv.conv.weight.data.copy_(wt)
        conv.conv.bias.data.copy_(bias)
    x32 = x.float()

    def sequence():
        with torch.no_grad():
            return seq(x).permute(0, 2, 3, 1)

    def kernel():
        return dt.decoder_tail(x, *ws)

    def f32_kernel():
        return dt.decoder_tail(x32, *ws)

    seq_err = (sequence().float() - out).abs().max().item()
    warm_up(torch, kernel, sequence, f32_kernel)
    row = timed(torch, kernel, sequence, flush, iters=TAIL_TIMED_LAUNCHES)
    k32, _ = in_turns(torch, f32_kernel, iters=TAIL_TIMED_LAUNCHES)
    k16, _ = in_turns(torch, kernel, iters=TAIL_TIMED_LAUNCHES)
    plain_ms = time_ms(lambda: dt.decoder_tail_plain_bf16(x, *ws), iters=20)
    n, _, h, w = x.shape
    nbytes = (x.numel() * 2 + out.numel() * 4
              + sum(t.numel() for t in ws) * 4)
    flops = 2 * TAIL_MACS * n * h * w
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    ms = row["ms"]
    row.update(max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bytes_bound_ms=bytes_ms, operations_bound_ms=ops_ms,
               f32_kernel_ms=statistics.median(k32), f32_kernel_turns=k32,
               bf16_kernel_turns_beside_f32=k16)
    say("kernels", f"decoder_tail_bf16 {list(x.shape)}: max|kernel-cuDNN "
        f"bf16 layers| {seq_err:.3e}; " + times_text(
            row, "library_ms", "the default bf16 route's cuDNN layer "
            "sequence (3 F.pad + F.conv2d in bf16, ELU, sigmoid)")
        + f"; in turns with the f32 kernel on the same input: f32 "
        f"{us(row['f32_kernel_ms'])} us, bf16 {us(statistics.median(k16))} "
        f"us; plain {us(plain_ms)} us; bound {us(bound_ms)} us "
        f"({row['bound_by']}: {flops / 1e9:.2f} GFLOP at "
        f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s = {us(ops_ms)} us, "
        f"{nbytes / 1e6:.2f} MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s = "
        f"{us(bytes_ms)} us), kernel at {bound_ms / ms:.1%} of it")
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


def step_launches(iters: int, remat: bool):
    """(value, d_coords only, d_coords + d_img) launches of one training
    step: the solver's first warp and one in each iteration body but the
    last (``iters - 1``), the loss's 4-channel warp, and with
    ``remat_coupled`` the ``iters - 2`` bodies' warps again, recomputed in
    the backward; each 3-channel warp's backward is d_coords only, the
    loss warp's d_coords + d_img."""
    return (iters + (max(iters - 2, 0) if remat else 0), iters - 1, 1)


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
                     what, sampler=None, ours_step=None):
    """The kernel- vs plain-sampler training step from one state: the
    kernel step (through ``sampler``, by default ``gs.grid_sample``, and
    ``ours_step``, by default ``train_step``: phase "dist" passes the
    distributed step), the plain-sampler step of ``train_step``, and the
    plain step's own spread (STEP_LOSS_SCALES),
    all with cuDNN's deterministic algorithms, which take out the
    run-to-run order of cuDNN's backward sums. Losses within
    STEP_LOSS_TOL; each gradient within max(STEP_GRAD_TOL,
    STEP_SPREAD_FACTOR x that spread), at most STEP_GRAD_CAP, with at most
    STEP_GRAD_MAX_WIDENED tensors held above STEP_GRAD_TOL; an analytically
    zero gradient as small. Returns the kernel step's losses, the loss
    difference, the worst gradient relative L2, the worst spread and, for
    each tensor held above STEP_GRAD_TOL, its spread and limit."""
    with cudnn_deterministic(torch):
        losses, ours = step_grads(torch, ours_step or train_step, state,
                                  batch, sampler or gs.grid_sample)
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

    cfg = Config(iterations=ITERS, compute_dtype="float32",
                 **dict(STEP_GRAD_VARIANTS)["depth terms on"])
    state = create_train_state(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(0))
    condition_like_trained(state.depth_net, torch)
    return state, train_batch(torch, 2, 2, 96, 160, seed=6, device="cuda")


def phase_train(torch, gs, cfg, create_train_state, train_step,
                forward_loss):
    """The training step at full width, seeded weights with trained-like
    conditioning: launch counts, finite losses, every parameter and
    BatchNorm statistic moved, time and peak memory with ``remat_coupled``
    on (the config's default) and off in turns, the losses of the two
    bit-equal and their gradients within the step's rounding limits, and
    the same step with the plain sampler from the same state."""
    import copy
    import dataclasses

    state, batch = train_setting(torch, cfg, create_train_state)

    def tensors():
        return {f"{net}.{k}": v for net, m in (("depth", state.depth_net),
                                               ("pose", state.pose_net))
                for k, v in m.state_dict().items()}

    init = {k: v.detach().clone() for k, v in tensors().items()}
    settings = (cfg.remat_coupled, not cfg.remat_coupled)
    expected = {r: step_launches(ITERS, r) for r in settings}
    times = {r: [] for r in settings}
    timeline = {r: [] for r in settings}
    peak = dict.fromkeys(settings, 0)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        for remat in settings if i % 2 == 0 else settings[::-1]:
            state.cfg = dataclasses.replace(cfg, remat_coupled=remat)
            zero_counts(gs)
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            start.record()
            losses = train_step(state, batch)
            end.record()
            torch.cuda.synchronize()
            peak[remat] = max(peak[remat], torch.cuda.max_memory_allocated())
            if i >= TRAIN_WARMUP:
                times[remat].append(time.perf_counter() - t)
                timeline[remat].append(start.elapsed_time(end))
            counts = read_counts(gs)
            check(counts == expected[remat], f"step {i}, remat {remat}: "
                  f"launches (fwd, bwd_coords, bwd_img) {counts}, expected "
                  f"{expected[remat]}")
            if remat == cfg.remat_coupled:
                step_counts = counts  # the main path's own
            for k, v in losses.items():
                check(bool(torch.isfinite(v)), f"step {i}: {k} = {v.item()}")
            check(losses["l_reconstruct_inverse"].item() > 0,
                  f"step {i}: the inverse term is 0 (mean_on_mask guard)")
    state.cfg = cfg
    say("train", f"main path (remat_coupled={cfg.remat_coupled}): per "
        f"training step launches (fwd, bwd_coords, bwd_img) {step_counts}, "
        f"expected {expected[cfg.remat_coupled]} (without remat "
        f"{expected[not cfg.remat_coupled]}), over "
        f"{2 * (TRAIN_TIMED + TRAIN_WARMUP)} steps in turns; last losses "
        + ", ".join(f"{k} {v.item():.6f}" for k, v in sorted(losses.items())))
    for remat in settings:
        med = statistics.median(times[remat])
        say("train", f"train step {H}x{W} B={B} S={S} iters={ITERS} f32, "
            f"remat_coupled={remat}: median {med * 1e3:.3f} ms over "
            f"{len(times[remat])} (min {min(times[remat]) * 1e3:.3f}, max "
            f"{max(times[remat]) * 1e3:.3f}) -> {B / med:.2f} frames/s; on "
            f"the card's timeline (CUDA events around the step) median "
            f"{statistics.median(timeline[remat]):.3f} ms (min "
            f"{min(timeline[remat]):.3f}, max {max(timeline[remat]):.3f}); "
            f"peak memory {peak[remat] / 2**20:.1f} MiB")
    meds = {r: statistics.median(times[r]) for r in settings}
    line = {r: statistics.median(timeline[r]) for r in settings}
    say("train", f"remat_coupled on vs off: peak memory "
        f"{(peak[True] - peak[False]) / 2**20:+.1f} MiB, median step "
        f"{(meds[True] - meds[False]) * 1e3:+.3f} ms wall, "
        f"{line[True] - line[False]:+.3f} ms on the card's timeline")
    med = meds[cfg.remat_coupled]

    # remat changes no loss; its gradients from one state (cuDNN
    # deterministic) are held as the kernel- vs plain-sampler step's, at
    # limits from the plain step's own rounding spread: on the card they
    # are not all bit-equal (PERF.md §6, PR 13)
    off = dataclasses.replace(cfg, remat_coupled=False)
    with cudnn_deterministic(torch):
        runs = {}
        for remat in settings:
            st = copy.deepcopy(state)
            st.cfg = dataclasses.replace(cfg, remat_coupled=remat)
            runs[remat] = step_grads(torch, train_step, st, batch,
                                     gs.grid_sample)
        st = copy.deepcopy(state)
        st.cfg = off
        _, again = step_grads(torch, train_step, st, batch, gs.grid_sample)
        _, ref = step_grads(torch, train_step, st, batch, gs.grid_sample_plain)
        spreads = [rel_l2(rescaled_grads(torch, forward_loss, gs, st, batch,
                                         c), ref) for c in STEP_LOSS_SCALES]
    (l_on, g_on), (l_off, g_off) = runs[True], runs[False]
    loss_differ = sorted(k for k in l_off if not torch.equal(l_on[k],
                                                             l_off[k]))
    check(not loss_differ, f"remat_coupled changed the losses {loss_differ}")
    differ = sorted(k for k in g_off if not torch.equal(g_on[k], g_off[k]))
    spread = {k: max(sp[k] or 0.0 for sp in spreads) for k in ref}
    limits, widened = step_grad_limits(spread, "remat on vs off")
    worst = compare_grads(g_on, g_off, limits.get, "remat_coupled on vs off")
    rerun = sorted(k for k in g_off if not torch.equal(again[k], g_off[k]))
    rerun_worst = max((e or 0.0 for e in rel_l2(again, g_off).values()),
                      default=0.0)
    say("train", f"the step without remat run twice from one state (cuDNN "
        f"deterministic): {len(rerun)} of {len(g_off)} gradient tensors "
        f"differ (pose net {sum(k.startswith('pose.') for k in rerun)}), "
        f"worst relative L2 {rerun_worst:.3e}")
    say("train", f"remat_coupled on vs off from one state (cuDNN "
        f"deterministic): losses bit-equal; {len(g_off) - len(differ)} of "
        f"{len(g_off)} gradient tensors bit-equal (of the pose net's "
        f"{sum(k.startswith('pose.') for k in g_off)}: "
        f"{sum(k.startswith('pose.') for k in differ)} differ; of the depth "
        f"net's {sum(k.startswith('depth.') for k in g_off)}: "
        f"{sum(k.startswith('depth.') for k in differ)} differ), worst "
        f"gradient relative L2 {worst:.3e} (limit {STEP_GRAD_TOL}, or "
        f"{STEP_SPREAD_FACTOR}x the plain step's own spread where larger, "
        f"at most {STEP_GRAD_CAP}; worst spread {max(spread.values()):.3e}; "
        f"{len(widened)} widened)")

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
        check(cmp_counts == step_launches(ITERS, cfg.remat_coupled),
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


def bn_global_parity(torch, mesh, dtype):
    """``BatchNorm2d._global_forward`` (the path of two or more ranks,
    through ``mesh``'s all-reduces) against the one-card path on the same
    input, at the depth net's first BatchNorm's shape in phase "train"
    (B x 64 x H/2 x W/2) in ``dtype``: the output, the gradients of input,
    weight and bias under ``(y * cos(y)).sum()`` and the running
    statistics after the call. Returns the largest difference relative to
    each tensor's largest magnitude, by name."""
    from tcsfm_torch.models.layers import BatchNorm2d

    gen = torch.Generator(device=mesh.device).manual_seed(0)
    x = torch.randn(B, 64, H // 2, W // 2, generator=gen, dtype=dtype,
                    device=mesh.device) * 2 + 1
    names = ("output", "d_input", "d_weight", "d_bias", "running_mean",
             "running_var")
    outs = []
    for path in ("one card", "global"):
        bn = BatchNorm2d(64).to(device=mesh.device, dtype=dtype).train()
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 2.0, 64))
            bn.bias.copy_(torch.linspace(-1.0, 1.0, 64))
        xi = x.clone().requires_grad_(True)
        y = bn(xi) if path == "one card" else bn._global_forward(xi, mesh)
        (y * torch.cos(y)).sum().backward()
        outs.append((y.detach(), xi.grad, bn.weight.grad, bn.bias.grad,
                     bn.running_mean.clone(), bn.running_var.clone()))
    return {k: ((a - b).abs().max() / b.abs().max()).item()
            for k, a, b in zip(names, *outs)}


def phase_dist(torch, gs, cfg, create_train_state, train_step,
               forward_loss):
    """Phase "dist": the data-parallel path (``tcsfm_torch.dist``) on the
    card in a one-rank NCCL group started in this process on a free port.
    At phase "train"'s setting (full width, 192x640, B=6, 4 iterations,
    trained-like weights) the distributed step from the same state as the
    plain step: its kernel launches (``step_launches``) and its
    collectives counted on one step; its losses, gradients and BatchNorm
    statistics held against the plain step's (``step_grad_parity``: the
    step's own rounding limits); ``bn_global_parity`` in float64 and
    float32 (at world size 1 the step takes the one-card BatchNorm, so the
    path of several ranks is held here on its own); the two steps timed in
    turns on CUDA events, and the collectives alone. Then
    ``measure_scaling([1])`` (one spawned rank at the same size) and
    ``dryrun_multichip(1)``; the group is destroyed. Returns the distributed step's launches."""
    import copy
    import functools

    import torch.distributed as dist

    from tcsfm_torch.dist import mesh as dm
    from tcsfm_torch.dist.dryrun import BA_TOL, dryrun_multichip
    from tcsfm_torch.dist.scaling import measure_scaling
    from tcsfm_torch.train.trainer import all_reduce_grads

    dm.init_group(0, 1, f"127.0.0.1:{dm.free_port()}")
    try:
        mesh = dm.make_mesh(1)
        check(dist.get_backend() == "nccl" and mesh.group is not None
              and mesh.device == torch.device("cuda", 0),
              f"the one-rank group: {dist.get_backend()}, {mesh}")
        state, batch = train_setting(torch, cfg, create_train_state)
        dist_step = functools.partial(train_step, mesh=mesh)

        sizes = []
        real = dist.all_reduce

        def counting(t, *args, **kwargs):
            sizes.append(t.numel() * t.element_size())
            return real(t, *args, **kwargs)

        with cudnn_deterministic(torch):
            ours, plain = copy.deepcopy(state), copy.deepcopy(state)
            dist.all_reduce = counting
            try:
                zero_counts(gs)
                losses = dist_step(ours, batch)
                torch.cuda.synchronize()
                counts = read_counts(gs)
            finally:
                dist.all_reduce = real
            plain_losses = train_step(plain, batch)
        expected = step_launches(ITERS, cfg.remat_coupled)
        check(counts == expected, f"distributed step launches (fwd, "
              f"bwd_coords, bwd_img) {counts}, expected {expected}")
        check(losses["l_reconstruct_inverse"].item() > 0,
              "distributed step: the inverse term is 0")
        loss_err = max(abs(losses[k].item() - plain_losses[k].item())
                       for k in plain_losses)
        check(loss_err <= STEP_LOSS_TOL, f"distributed vs plain step losses "
              f"differ by {loss_err} > {STEP_LOSS_TOL}")
        stats = {k: (v, plain.depth_net.state_dict()[k]) for k, v in
                 ours.depth_net.state_dict().items() if "running" in k}
        stats_err = max((a - b).abs().max().item() for a, b in
                        stats.values())
        for dtype, limit in BN_GLOBAL_TOL.items():
            errs = bn_global_parity(torch, mesh, getattr(torch, dtype))
            check(max(errs.values()) <= limit, f"BatchNorm's global path vs "
                  f"the one-card path, {dtype}: {errs} (limit {limit})")
            say("dist", f"BatchNorm's global-statistics path "
                f"(_global_forward, NCCL all-reduces) vs the one-card path "
                f"at {B}x64x{H // 2}x{W // 2} {dtype}: largest relative "
                f"difference "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f" (limit {limit})")
        check(len(stats) == 40 and stats_err <= STEP_LOSS_TOL,
              f"distributed vs plain step BatchNorm statistics differ by "
              f"{stats_err} > {STEP_LOSS_TOL}")
        say("dist", f"one-rank NCCL group on {mesh.device}; the distributed "
            f"step at {H}x{W} B={B} S={S} iters={ITERS}: launches (fwd, "
            f"bwd_coords, bwd_img) {counts}, expected {expected}; "
            f"{len(sizes)} all-reduces a step, {sum(sizes) / 2**20:.3f} MiB "
            f"(the gradient bucket {max(sizes) / 2**20:.3f} MiB); vs the "
            f"plain step from the same state (cuDNN deterministic): "
            f"max|loss diff| {loss_err:.3e}, BatchNorm statistics "
            f"{stats_err:.3e} (limit {STEP_LOSS_TOL} each)")
        _, loss_err, worst, spread, widened = step_grad_parity(
            torch, gs, train_step, forward_loss, state, batch,
            "distributed step vs plain-sampler plain step",
            ours_step=dist_step)
        say("dist", f"distributed (kernels) vs plain-sampler plain step from "
            f"one state: max|loss diff| {loss_err:.3e} (limit "
            f"{STEP_LOSS_TOL}), worst gradient relative L2 {worst:.3e} "
            f"(limit {STEP_GRAD_TOL}, or {STEP_SPREAD_FACTOR}x the plain "
            f"step's own spread where larger, at most {STEP_GRAD_CAP}; "
            f"worst spread {spread:.3e}); {len(widened)} tensors widened")

        steps = {"plain": (train_step, copy.deepcopy(state)),
                 "dist": (dist_step, copy.deepcopy(state))}
        times = {k: [] for k in steps}
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        for i in range(1 + DIST_TIMED):          # the first round warms up
            for k in ("plain", "dist") if i % 2 else ("dist", "plain"):
                step, st = steps[k]
                start.record()
                step(st, batch)
                end.record()
                torch.cuda.synchronize()
                if i:
                    times[k].append(start.elapsed_time(end))
        _, st = steps["dist"]
        bucket = sum(p.numel() for m in (st.depth_net, st.pose_net)
                     for p in m.parameters())
        start.record()
        for _ in range(DIST_COLLECTIVE_REPS):
            all_reduce_grads(mesh, st.depth_net, st.pose_net)
        end.record()
        torch.cuda.synchronize()
        grads_ms = start.elapsed_time(end) / DIST_COLLECTIVE_REPS
        flat = torch.zeros(bucket, device=mesh.device)
        start.record()
        for _ in range(DIST_COLLECTIVE_REPS):
            dist.all_reduce(flat)
        end.record()
        torch.cuda.synchronize()
        bucket_ms = start.elapsed_time(end) / DIST_COLLECTIVE_REPS
        med = {k: statistics.median(v) for k, v in times.items()}
        say("dist", "training step on CUDA events, in turns, "
            + "; ".join(f"{k}: median {med[k]:.3f} ms (min {min(v):.3f}, max "
                        f"{max(v):.3f}) over {len(v)}"
                        for k, v in times.items())
            + f"; distributed - plain {med['dist'] - med['plain']:+.3f} ms; "
            f"the gradients' all-reduce alone (cat, NCCL all-reduce of "
            f"{bucket} f32, copy back) {grads_ms:.3f} ms, the NCCL "
            f"all-reduce of the bucket alone {bucket_ms:.3f} ms (means of "
            f"{DIST_COLLECTIVE_REPS})")

        rows = measure_scaling([1], batch_per_device=B, image_hw=(H, W),
                               iterations=ITERS, timed_steps=3,
                               verbose=False)
        check(len(rows) == 1 and rows[0]["efficiency"] == 1.0
              and all(v > 0 for v in rows[0].values()),
              f"measure_scaling([1]): {rows}")
        say("dist", f"measure_scaling([1]), one spawned rank on the card: "
            f"{json.dumps(rows[0])}; no curve across cards is measured on "
            f"one card")
        dry = dryrun_multichip(1)
        check(dry["ba_err"] <= BA_TOL and math.isfinite(dry["loss"]),
              f"dryrun_multichip(1): {dry}")
    finally:
        dist.destroy_process_group()
    return counts


def phase_train_cli(torch, gs, dt, step_counts):
    """The seventh main path: the training entry point,
    ``tcsfm_torch.cli.train.main``, in this process at full width on
    generated sequences (TRAIN_CLI_ARGS): two epochs, then resumed with
    ``--load_from_checkpoint`` for a third in the same directory
    (``build/train_cli/run``). Checks the files, finite train and val
    scalars of each epoch and the test sequence's from the second on, the
    resumed run's start (epoch 2, ``step`` and the Adam state bit-equal to
    the state saved) and every training step's launches against phase
    "train"'s ``step_counts``. Returns the launches of the two calls by
    kernel (value, d_coords, d_img, value+Jacobian, tail)."""
    import copy
    import json
    import os
    import shutil
    from pathlib import Path

    from tcsfm_torch.cli import train as cli
    from tcsfm_torch.train import trainer as tr

    work = Path(__file__).resolve().parent / "build" / "train_cli"
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    run_dir = work / "run"
    args = TRAIN_CLI_ARGS + ["--results_dir", str(work), "--date", "run"]
    per_step, epochs, loaded = [], [], {}
    real_step, real_epoch, real_load = (tr.train_step, tr.Trainer.run_epoch,
                                        cli.load_checkpoint)

    def counted_step(state, batch, **kw):
        before = read_counts(gs)
        out = real_step(state, batch, **kw)
        per_step.append(tuple(a - b for a, b in zip(read_counts(gs),
                                                    before)))
        return out

    def timed_epoch(self, loader, epoch, phase="train"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_epoch(self, loader, epoch, phase)
        torch.cuda.synchronize()
        epochs.append((phase, epoch, time.perf_counter() - t, len(loader)))
        return out

    def recorded_load(ckpt_dir, state, load_best):
        out = real_load(ckpt_dir, state, load_best=load_best)
        loaded.update(epoch=out[1], step=state.step, adam=copy.deepcopy(
            state.optimizer.state_dict()["state"]))
        return out

    def adam_equal(a, b):
        return sorted(a) == sorted(b) and all(
            sorted(a[i]) == sorted(b[i]) and all(
                torch.equal(a[i][k], b[i][k]) for k in a[i]) for i in a)

    zero_counts(gs)
    dt.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    tr.train_step, tr.Trainer.run_epoch = counted_step, timed_epoch
    cli.load_checkpoint = recorded_load
    try:
        first = quiet(lambda: cli.main(args + ["--num_epochs", "2"]),
                      work / "epochs_1_2.log")
        saved = copy.deepcopy(first.state.optimizer.state_dict()["state"])
        spe = first.state.steps_per_epoch
        second = quiet(lambda: cli.main(args + [
            "--num_epochs", "3", "--load_from_checkpoint"]),
            work / "epoch_3.log")
    finally:
        tr.train_step, tr.Trainer.run_epoch = real_step, real_epoch
        cli.load_checkpoint = real_load
    torch.cuda.synchronize()
    launches = read_counts(gs) + (gs.LAUNCHES_FWD_GRADS, dt.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    for name in ("checkpoint.msgpack", "best_model/best_model.msgpack",
                 "config.json", "logs/scalars.jsonl"):
        check((run_dir / name).is_file(), f"train_cli: no {name}")
    with open(run_dir / "logs" / "scalars.jsonl") as f:
        values = {(r["tag"], r["step"]): r["value"]
                  for r in map(json.loads, f)}
    for epoch in (1, 2, 3):
        for tag in ("train/total", "val/total", "train/l_reconstruct_forward",
                    "val/l_reconstruct_forward"):
            v = values.get((tag, epoch))
            check(v is not None and v == v and abs(v) != float("inf"),
                  f"train_cli: {tag} at epoch {epoch}: {v}")
        for tag in ("test/t_ate", "test/r_ate", "test/t_seg", "test/r_seg"):
            check(((tag, epoch) in values) == (epoch > 1),
                  f"train_cli: {tag} at epoch {epoch}")
    check(all(values[("test/t_ate", e)] == values[("test/t_ate", e)]
              for e in (2, 3)), "train_cli: test/t_ate is NaN")
    check((loaded.get("epoch"), loaded.get("step")) == (2, 2 * spe),
          f"train_cli: resumed at epoch {loaded.get('epoch')}, step "
          f"{loaded.get('step')}, expected 2 and {2 * spe}")
    check(adam_equal(loaded["adam"], saved), "train_cli: the Adam state "
          "resumed is not the state saved")
    check(second.state.step == 3 * spe, f"train_cli: {second.state.step} "
          f"steps after the third epoch, expected {3 * spe}")
    check(len(per_step) == 3 * spe and set(per_step) == {step_counts},
          f"train_cli: launches a training step {sorted(set(per_step))} over "
          f"{len(per_step)} steps, expected {step_counts} over {3 * spe}")
    logs = sorted(os.listdir(run_dir / "logs"))
    trains = [(e, t, n) for p, e, t, n in epochs if p == "train"]
    say("train_cli", f"{' '.join(TRAIN_CLI_ARGS)}: 2 epochs, then resumed "
        f"at epoch {loaded['epoch']} (step {loaded['step']}, Adam state "
        f"bit-equal to the state saved) for a third; {spe} steps an epoch, "
        f"launches (fwd, bwd_coords, bwd_img) {step_counts} each step, as "
        f"phase \"train\"; scalars at epochs 1-3, test/t_ate "
        f"{values[('test/t_ate', 2)]:.3f}, {values[('test/t_ate', 3)]:.3f}; "
        f"train/total " + ", ".join(f"{values[('train/total', e)]:.6f}"
                                    for e in (1, 2, 3))
        + f"; logs/: {logs}")
    say("train_cli", "train epochs (wall, synchronized): " + ", ".join(
        f"epoch {e} {t:.3f} s, {n / t:.3f} steps/s" for e, t, n in trains)
        + "; val epochs: " + ", ".join(
            f"{t:.3f} s" for p, e, t, n in epochs if p == "val")
        + f"; peak memory {peak / 2**20:.1f} MiB; launches of the two calls "
        f"(fwd, bwd_coords, bwd_img, fwd_grads, tail) {launches}")
    return launches


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
                 img_resolution="med", compute_dtype="float32")
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


def within_gap(err, gap, what):
    check(err <= BF16_FRACTION * gap, f"{what}: {err:.3e} > {BF16_FRACTION} "
          f"x the bf16-vs-f32 gap {gap:.3e}")
    return f"{err:.2e} ({err / gap:.2f} x gap {gap:.2e})" if gap else \
        f"{err:.2e}"


def one_minus_cos(a, b) -> float:
    return 1.0 - (a @ b / (a.norm() * b.norm())).item()


def phase_bf16(torch, gs, dt, cfg, build_models, coupled_forward,
               create_train_state, train_step, forward_loss):
    """The JAX package's default precision on the card: both networks in
    bfloat16 on float32 parameters (``compute_dtype="bfloat16"``), the
    geometry and the sampler in float32. At phase "slice"'s setting
    (192x640, B=6, S=2, 4 iterations), seeded weights with trained-like
    conditioning: the coupled forward through both routes (cuDNN layers,
    and ``make_tail_apply`` with the bf16 tail kernel) and a training step
    (``remat_coupled`` on), each with its launches counted and each kernel
    held against its plain version on the same bf16 nets at that kernel's
    limits (the sampler's f32 ones; the tail's TAIL_BF16_TOL and
    TAIL_BF16_REL), and timed in turns with the f32 run of the same
    weights (frames/s or step ms, peak memory); the 64x96 forward card vs
    CPU in bf16 within BF16_FRACTION x the CPU's bf16-vs-f32 gap (the CPU
    tests' rule: tests/test_torch_bf16*.py); then ``cli.train`` with its
    default ``--compute_dtype`` for two epochs. Returns the launches by
    kernel name, and by path (the layers-route forward, the tail-route
    forward, the step) the launch counts in KERNEL_NAMES' order."""
    import copy
    import json
    import os
    import shutil
    from pathlib import Path

    from tcsfm_torch.cli import train as cli
    from tcsfm_torch.models.depth import make_tail_apply, tail_weights
    from tcsfm_torch.train import trainer as tr

    bf16 = torch.bfloat16
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    nets = {}
    for c in (cfg16, cfg):
        nets[c.compute_dtype] = build_models(
            c, device="cuda", generator=torch.Generator().manual_seed(3))
        condition_like_trained(nets[c.compute_dtype][0], torch)
    cfgs = {"bfloat16": cfg16, "float32": cfg}
    tgt, src, K = (torch.from_numpy(a).cuda()
                   for a in smooth_inputs(torch, B, S, H, W, seed=8))
    launches = dict.fromkeys(KERNEL_NAMES, 0)

    def plain_tail_apply(net):
        def apply(imgs):
            z = net.decode_tail_input(net.encode(imgs))
            fn = (dt.decoder_tail_plain_bf16 if z.dtype == bf16
                  else dt.decoder_tail_plain)
            return [fn(z, *tail_weights(net)).to(z.dtype)]
        return apply

    def forward(dtype, tail, plain_sampler=False, plain_tail=False):
        depth_net, pose_net = nets[dtype]
        apply = None
        if tail:
            apply = (plain_tail_apply if plain_tail else make_tail_apply)(
                depth_net)
        return coupled_forward(
            depth_net, pose_net, tgt, src, K, cfgs[dtype], depth_apply=apply,
            sampler=gs.grid_sample_plain if plain_sampler else gs.grid_sample)

    def counts():
        return read_counts(gs) + (gs.LAUNCHES_FWD_GRADS, dt.LAUNCHES,
                                  dt.LAUNCHES_BF16)

    def zero_all():
        zero_counts(gs)
        dt.LAUNCHES = dt.LAUNCHES_BF16 = 0

    def add(got):
        for name, n in zip(KERNEL_NAMES, got):
            launches[name] += n

    # 1. the forward through both routes, the main path's launches; each
    # kernel held against its plain version on the same bf16 nets
    per_path = {}
    for tail in (False, True):
        route = "tail" if tail else "layers"
        zero_all()
        _, _, disp, chain = forward("bfloat16", tail)
        torch.cuda.synchronize()
        got = per_path[f"{route}_forward"] = counts()
        add(got)
        want = (ITERS - 1, 0, 0, 0, 0, int(tail))
        check(got == want, f"bf16 forward ({route}): launches (fwd, "
              f"bwd_coords, bwd_img, fwd_grads, tail, tail_bf16) {got}, "
              f"expected {want}")
        check(disp.dtype == bf16 and chain.dtype == torch.float32,
              f"bf16 forward ({route}): disparity {disp.dtype}, chain "
              f"{chain.dtype}")
        check(tuple(disp.shape) == (B, H, W, 1) and bool(
            torch.isfinite(disp).all() and torch.isfinite(chain).all()),
            f"bf16 forward ({route}): shape {tuple(disp.shape)} or "
            f"non-finite values")
        _, _, disp_s, chain_s = forward("bfloat16", tail, plain_sampler=True)
        chain_err = (chain - chain_s).abs().max().item()
        disp_err = (disp.float() - disp_s.float()).abs().max().item()
        check(chain_err <= CHAIN_TOL, f"bf16 forward ({route}): chain "
              f"kernel vs plain sampler {chain_err} > {CHAIN_TOL}")
        check(disp_err <= DISP_TOL, f"bf16 forward ({route}): disparity "
              f"kernel vs plain sampler {disp_err} > {DISP_TOL}")
        _, _, disp_32, chain_32 = forward("float32", tail)
        text = (f"vs the plain sampler max|chain diff| {chain_err:.3e} "
                f"(limit {CHAIN_TOL}), max|disp diff| {disp_err:.3e} (limit "
                f"{DISP_TOL}); bf16 vs the f32 run of the same weights "
                f"(relative L2): disparity {rel_l2_of(disp, disp_32):.3e}, "
                f"chain by iteration " + ", ".join(
                    f"{rel_l2_of(chain[:, it], chain_32[:, it]):.3e}"
                    for it in range(ITERS)))
        if tail:
            depth_net = nets["bfloat16"][0]
            with torch.no_grad():
                z = depth_net.decode_tail_input(depth_net.encode(tgt))
                out = dt.decoder_tail(z, *tail_weights(depth_net))
                ref = dt.decoder_tail_plain_bf16(z, *tail_weights(depth_net))
            diff = (out - ref).abs()
            err = diff.max().item()
            flipped = (diff > 1e-6).float().mean().item()
            check(err <= TAIL_BF16_TOL, f"bf16 forward (tail): the tail "
                  f"kernel vs plain on the path's input {err} > "
                  f"{TAIL_BF16_TOL}")
            _, _, disp_p, chain_p = forward("bfloat16", tail,
                                            plain_sampler=True,
                                            plain_tail=True)
            tail_err = rel_l2_of(disp, disp_p)
            check(tail_err <= TAIL_BF16_REL, f"bf16 forward (tail): "
                  f"disparity vs the plain bf16 tail {tail_err} > "
                  f"{TAIL_BF16_REL}")
            texts = [within_gap(
                rel_l2_of(chain[:, it], chain_p[:, it]),
                rel_l2_of(chain[:, it], chain_32[:, it]),
                f"bf16 forward (tail): chain iteration {it} vs the plain "
                f"tail") for it in range(ITERS)]
            text += (f"; the tail kernel on the path's decoder input vs "
                     f"decoder_tail_plain_bf16: max abs {err:.3e} (limit "
                     f"{TAIL_BF16_TOL}), {flipped:.3%} of the pixels differ "
                     f"by more than 1e-6; vs the same run with the plain "
                     f"sampler and the plain bf16 tail: disparity relative "
                     f"L2 {tail_err:.3e} (limit {TAIL_BF16_REL}), chain by "
                     f"iteration (limit {BF16_FRACTION} x the gap to f32) "
                     + "; ".join(texts))
        say("bf16", f"forward {H}x{W} B={B} S={S} iters={ITERS}, {route} "
            f"route: launches (fwd, bwd_coords, bwd_img, fwd_grads, tail, "
            f"tail_bf16) {got}; disparity bf16, chain f32, finite; " + text)

    # 2. frames/s and peak memory, bf16 and f32 in turns, both routes
    for tail in (False, True):
        route = "tail" if tail else "layers"
        times = {"bfloat16": [], "float32": []}
        peak = {}
        for dtype in times:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            forward(dtype, tail)
            torch.cuda.synchronize()
            peak[dtype] = torch.cuda.max_memory_allocated()
        for i in range(2 + BF16_TIMED):
            for dtype in (("float32", "bfloat16") if i % 2 == 0
                          else ("bfloat16", "float32")):
                t = time.perf_counter()
                forward(dtype, tail)
                torch.cuda.synchronize()
                if i >= 2:
                    times[dtype].append(time.perf_counter() - t)
        med = {d: statistics.median(v) for d, v in times.items()}
        say("bf16", f"forward, {route} route, bf16 vs f32 in turns ("
            f"{len(times['bfloat16'])} each, wall, synchronized): " + "; ".join(
                f"{d} median {med[d] * 1e3:.3f} ms (min "
                f"{min(times[d]) * 1e3:.3f}, max {max(times[d]) * 1e3:.3f}) "
                f"-> {B / med[d]:.2f} frames/s, peak memory "
                f"{peak[d] / 2**20:.1f} MiB" for d in med))

    # 3. the 64x96 forward on the card and on the CPU, in bf16
    b, s, h, w = 2, 2, 64, 96
    inputs = smooth_inputs(torch, b, s, h, w, seed=2)
    small = {}
    for dtype, c in cfgs.items():
        cpu_nets = [copy.deepcopy(n).cpu() for n in nets[dtype]]
        small[dtype] = coupled_forward(*cpu_nets, *inputs, c, device="cpu")
    card = coupled_forward(*nets["bfloat16"], *inputs, cfg16)
    cpu16, cpu32 = small["bfloat16"], small["float32"]
    texts = [within_gap(rel_l2_of(card[2], cpu16[2]),
                        rel_l2_of(cpu16[2], cpu32[2]),
                        "bf16 64x96 card vs CPU: disparity")]
    for it in range(ITERS):
        texts.append(within_gap(
            rel_l2_of(card[3][:, it], cpu16[3][:, it]),
            rel_l2_of(cpu16[3][:, it], cpu32[3][:, it]),
            f"bf16 64x96 card vs CPU: chain iteration {it}"))
    say("bf16", f"{h}x{w} B={b} S={s} forward, bf16 card vs bf16 CPU, "
        f"relative L2 (limit {BF16_FRACTION} x the CPU's bf16-vs-f32 gap): "
        f"disparity {texts[0]}; chain by iteration " + "; ".join(texts[1:]))

    # 4. the training step (remat_coupled on), bf16 against the plain
    # sampler (its losses at the f32 limit, its gradients by the plain
    # step's own spread), the gap to the f32 step beside it, then timed in
    # turns with f32
    states, batch = {}, None
    for dtype, c in cfgs.items():
        states[dtype], batch = train_setting(torch, c, create_train_state)
    want = step_launches(ITERS, cfg.remat_coupled) + (0, 0, 0)
    state = states["bfloat16"]
    with cudnn_deterministic(torch):
        zero_all()
        losses, ours = step_grads(torch, train_step, state, batch,
                                  gs.grid_sample)
        got = per_path["train_step"] = counts()
        add(got)
        ref_losses, ref = step_grads(torch, train_step, state, batch,
                                     gs.grid_sample_plain)
        rescaled = [rescaled_grads(torch, forward_loss, gs, state, batch, c)
                    for c in BF16_LOSS_SCALES]
        f32 = step_grads(torch, train_step, states["float32"], batch,
                         gs.grid_sample)
    check(got == want, f"bf16 step: launches {got}, expected {want}")
    for k, v in losses.items():
        check(bool(torch.isfinite(v)), f"bf16 step: {k} = {v.item()}")
    check(losses["l_reconstruct_inverse"].item() > 0,
          "bf16 step: the inverse term is 0")
    check(losses["mean_disp"].dtype == bf16, "bf16 step: mean_disp is "
          f"{losses['mean_disp'].dtype}")
    loss_err = max(abs(losses[k].item() - ref_losses[k].item())
                   for k in losses)
    check(loss_err <= STEP_LOSS_TOL, f"bf16 step: losses differ from the "
          f"plain sampler's by {loss_err} > {STEP_LOSS_TOL}")
    def flat(grads):
        return torch.cat([g.reshape(-1).double() for g in grads.values()
                          if g is not None])

    spread = {k: max(rel_l2(g, ref)[k] or 0.0 for g in rescaled)
              for k in ref}
    whole_spread = max(rel_l2_of(flat(g), flat(ref)) for g in rescaled)
    worst = compare_grads(ours, ref, lambda k: max(
        STEP_GRAD_TOL, STEP_SPREAD_FACTOR * spread[k], whole_spread),
        "bf16 step")
    whole = rel_l2_of(flat(ours), flat(ref))
    check(whole <= STEP_SPREAD_FACTOR * whole_spread, f"bf16 step: the "
          f"whole gradient {whole} from the plain sampler's > "
          f"{STEP_SPREAD_FACTOR} x its spread {whole_spread}")
    widened = sum(e > STEP_GRAD_TOL / 4 for e in spread.values())
    gaps = "; ".join(f"{k} {abs(losses[k].item() / v.item() - 1):.2e}"
                     for k, v in sorted(f32[0].items()) if v.item() != 0)
    for st in states.values():
        for p in list(st.depth_net.parameters()) + list(
                st.pose_net.parameters()):
            check(p.dtype == torch.float32, "a parameter is not float32")
    say("bf16", f"training step {H}x{W} B={B} S={S} iters={ITERS}, "
        f"remat_coupled {cfg.remat_coupled}: launches (fwd, bwd_coords, "
        f"bwd_img, fwd_grads, tail, tail_bf16) {got}; float32 parameters "
        f"and gradients; vs the same bf16 step with the plain sampler (cuDNN "
        f"deterministic): losses max|diff| {loss_err:.3e} (limit "
        f"{STEP_LOSS_TOL}); gradients worst relative L2 {worst:.3e} (each "
        f"tensor within max({STEP_GRAD_TOL}, {STEP_SPREAD_FACTOR} x the "
        f"plain step's own spread, the whole gradient's spread); worst "
        f"spread "
        f"{max(spread.values()):.3e}, {widened} of {len(spread)} tensors "
        f"spread past {STEP_GRAD_TOL / 4}), the "
        f"whole gradient {whole:.3e} (limit {STEP_SPREAD_FACTOR} x its "
        f"spread {whole_spread:.3e}); bf16 vs the f32 step of the same "
        f"weights: losses (relative) {gaps}; gradient 1 - cos "
        f"{one_minus_cos(flat(ours), flat(f32[1])):.3e}")
    times = {"bfloat16": [], "float32": []}
    peak = dict.fromkeys(times, 0)
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        for dtype in (("float32", "bfloat16") if i % 2 == 0
                      else ("bfloat16", "float32")):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            step_losses = train_step(states[dtype], batch)
            torch.cuda.synchronize()
            peak[dtype] = max(peak[dtype], torch.cuda.max_memory_allocated())
            if i >= TRAIN_WARMUP:
                times[dtype].append(time.perf_counter() - t)
            check(all(bool(torch.isfinite(v)) for v in step_losses.values()),
                  f"{dtype} step {i}: non-finite losses")
    med = {d: statistics.median(v) for d, v in times.items()}
    say("bf16", f"training step, bf16 vs f32 in turns ({TRAIN_TIMED} each "
        f"after {TRAIN_WARMUP}, wall, synchronized): " + "; ".join(
            f"{d} median {med[d] * 1e3:.3f} ms (min {min(times[d]) * 1e3:.3f},"
            f" max {max(times[d]) * 1e3:.3f}) -> {B / med[d]:.2f} frames/s, "
            f"peak memory {peak[d] / 2**20:.1f} MiB" for d in med))

    # 5. the training CLI at its default --compute_dtype (bfloat16)
    work = Path(__file__).resolve().parent / "build" / "bf16_cli"
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    args = [a for a in TRAIN_CLI_ARGS if a not in ("--compute_dtype",
                                                   "float32")]
    per_step, real_step = [], tr.train_step

    def counted_step(state, batch, **kw):
        before = read_counts(gs)
        out = real_step(state, batch, **kw)
        per_step.append(tuple(a - b for a, b in zip(read_counts(gs),
                                                    before)))
        return out

    zero_all()
    tr.train_step = counted_step
    try:
        loop = quiet(lambda: cli.main(args + [
            "--results_dir", str(work), "--date", "run", "--num_epochs",
            "2"]), work / "cli.log")
    finally:
        tr.train_step = real_step
    torch.cuda.synchronize()
    got = counts()
    add(got)
    with open(work / "run" / "config.json") as f:
        written = json.load(f)["compute_dtype"]
    check(written == "bfloat16", f"bf16 cli: config.json says {written}")
    check(loop.state.depth_net.compute_dtype == bf16, "bf16 cli: the depth "
          "net computes in " + str(loop.state.depth_net.compute_dtype))
    with open(work / "cli.log") as f:
        printed = [line for line in f if line.startswith("compute dtype")]
    check(printed and "bfloat16" in printed[0], f"bf16 cli printed {printed}")
    with open(work / "run" / "logs" / "scalars.jsonl") as f:
        values = {(r["tag"], r["step"]): r["value"]
                  for r in map(json.loads, f)}
    for epoch in (1, 2):
        for tag in ("train/total", "val/total"):
            v = values.get((tag, epoch))
            check(v is not None and math.isfinite(v),
                  f"bf16 cli: {tag} at epoch {epoch}: {v}")
    check(set(per_step) == {want[:3]}, f"bf16 cli: launches a step "
          f"{sorted(set(per_step))}, expected {want[:3]}")
    say("bf16", f"cli.train {' '.join(args)} --num_epochs 2 (default "
        f"--compute_dtype): config.json compute_dtype {written}, printed "
        f"{printed[0].strip()!r}; {len(per_step)} steps, each launching "
        f"{want[:3]}; train/total " + ", ".join(
            f"{values[('train/total', e)]:.6f}" for e in (1, 2))
        + f", val/total " + ", ".join(
            f"{values[('val/total', e)]:.6f}" for e in (1, 2))
        + f"; launches of the call (fwd, bwd_coords, bwd_img, fwd_grads, "
        f"tail, tail_bf16) {got}")
    return launches, per_path


def pft_expected_launches(epochs: int, iters: int):
    """(value, d_coords only, d_coords + d_img) launches of one
    ``optimize_window`` call in a mode that trains depth: every forward
    makes ``iters`` warps, every updated step's backward takes each
    3-channel warp's d_coords and the 4-channel warp's d_coords + d_img."""
    return (epochs * iters, (epochs - 1) * (iters - 1), epochs - 1)


def pft_batch(torch, b, h, w, seed, device):
    """A window batch of smooth images on the uint8 grid (k/255), as
    frames read from files are, and KITTI-like K."""
    import numpy as np

    tgt, src, K = smooth_inputs(torch, b, S, h, w, seed)
    grid = lambda x: (np.round(x * 255.0) / 255.0).astype(np.float32)  # noqa
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in (("target_img", grid(tgt)),
                         ("source_imgs", grid(src)), ("intrinsics", K))}


def pft_results(res):
    return {k: getattr(res, k).detach().double().cpu() for k in PFT_FIELDS}


def rel_l2_of(ours, ref) -> float:
    """||ours - ref|| / ||ref|| over all entries, in float64 on ``ref``'s
    device."""
    ours, ref = ours.to(ref.device).double(), ref.double()
    return ((ours - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def rel_max(ours, ref) -> float:
    """max |ours - ref| over max |ref|."""
    return ((ours - ref).abs().max() / ref.abs().max().clamp_min(1e-30)
            ).item()


def scaled_loss_optimizer(pft, scale):
    """``PFTOptimizer`` whose backward runs on the loss times ``scale`` and
    divides the gradients by it: the same steps, rounded differently."""

    class Scaled(pft.PFTOptimizer):
        def _gradients(self, loss, params):
            return tuple(g / scale
                         for g in super()._gradients(loss * scale, params))

    return Scaled


def pft_first_step(torch, opt, batch, sampler, scale=1.0):
    """The first PFT step's loss and gradients, by trainable tensor, from
    ``opt``'s state; the backward on the loss times ``scale``, the
    gradients divided by it."""
    win = opt._prepare(batch, batch["target_img"].device)
    loss, _ = opt._forward(win, sampler)
    params = list(win.trainable.values())
    grads = torch.autograd.grad(loss * scale, params)
    if loss.is_cuda:
        torch.cuda.synchronize()
    return loss.detach(), {k: g / scale for k, g in zip(win.trainable, grads)}


def pft_call_readings(torch, gs, pft, opt, batch):
    """The kernel- and plain-sampler PFT calls from ``opt``'s state (cuDNN
    deterministic), and the plain call again in each of
    ``pft_spread_runs``' ways. Returns, by field of ``PFT_FIELDS``, the
    kernel call's distance from the plain one and the plain call's own
    spread (the largest of the reruns', and each rerun's), as relative L2
    and as max |diff| / max |plain|; and the first loss of the kernel call
    and of the plain one."""
    plain = gs.grid_sample_plain
    with cudnn_deterministic(torch):
        call = pft_results(opt.optimize_window(batch))
        call_ref = pft_results(opt.optimize_window(batch, sampler=plain))
        reruns = {name: pft_results(run()) for name, run
                  in pft_spread_runs(torch, gs, pft, opt, batch)}
    readings = {}
    for k in PFT_FIELDS:
        check(bool(torch.isfinite(call[k]).all()), f"PFT call: {k} not "
              f"finite")
        spreads = {n: rel_l2_of(r[k], call_ref[k]) for n, r in reruns.items()}
        readings[k] = {
            "rel_l2": rel_l2_of(call[k], call_ref[k]),
            "spread": max(spreads.values()), "spreads": spreads,
            "rel_max": rel_max(call[k], call_ref[k]),
            "spread_max": max(rel_max(r[k], call_ref[k])
                              for r in reruns.values())}
    return readings, (call["losses"][0].item(), call_ref["losses"][0].item())


def pft_spread_runs(torch, gs, pft, opt, batch):
    """(name, call) of the plain-sampler PFT reruns that read the plain
    call's own spread: its loss scaled by each of PFT_LOSS_SCALES (and the
    gradients scaled back), and its images one ulp up."""
    plain = gs.grid_sample_plain

    def scaled(c):
        return lambda: scaled_loss_optimizer(pft, c)(
            opt.cfg, opt.opts, opt.depth_net, opt.pose_net,
            mode=opt.mode).optimize_window(batch, sampler=plain)

    runs = [(f"loss x (1 {c - 1:+.3g})", scaled(c)) for c in PFT_LOSS_SCALES]
    runs.append(("images one ulp up", lambda: opt.optimize_window(
        one_ulp_up(torch, batch), sampler=plain)))
    return runs


def pft_parity(torch, gs, pft, opt, batch, what):
    """The kernel- vs plain-sampler PFT from one state (cuDNN
    deterministic): the first step's gradients, then the whole call, each
    within limits drawn from the plain run's own spread. Returns the worst
    gradient relative L2, its worst spread and the widened tensors, and
    each field's (error, spread, limit) of the call and the first loss's
    difference."""
    plain = gs.grid_sample_plain
    with cudnn_deterministic(torch):
        _, ours = pft_first_step(torch, opt, batch, gs.grid_sample)
        _, ref = pft_first_step(torch, opt, batch, plain)
        spread_runs = [rel_l2(pft_first_step(torch, opt, batch, plain, c)[1],
                              ref) for c in STEP_LOSS_SCALES]
    spread = {k: max(s[k] or 0.0 for s in spread_runs) for k in ref}
    limits, widened = step_grad_limits(spread, f"{what}, first step")
    worst = compare_grads(ours, ref, limits.get, f"{what}, first step")
    grads = (worst, max(spread.values()), widened)

    readings, (loss0, ref_loss0) = pft_call_readings(torch, gs, pft, opt,
                                                     batch)
    first = abs(loss0 - ref_loss0)
    fields = {}
    for k, r in readings.items():
        limit = min(PFT_CAP, max(PFT_TOL, PFT_SPREAD_FACTOR * r["spread"]))
        fields[k] = (r["rel_l2"], r["spread"], limit, r["rel_max"])
    say("pft", f"{what}: " + ", ".join(
        f"{k} relative L2 {e:.3e} (max {m:.3e}; plain run's own spread "
        f"{sp:.3e}, limit {lim:.3e})" for k, (e, sp, lim, m)
        in fields.items()) + f"; first loss diff {first:.3e}; the spread "
        f"readings: " + "; ".join(
            f"{k} " + ", ".join(f"{n} {v:.3e}" for n, v
                                in readings[k]["spreads"].items())
            for k in readings))
    check(first <= STEP_LOSS_TOL * abs(ref_loss0),
          f"{what}: first loss differs by {first}")
    for k, (err, sp, limit, _) in fields.items():
        check(err <= limit, f"{what}: {k} kernel vs plain relative L2 {err} "
              f"> {limit} (plain call's own spread {sp})")
    return grads, fields, first


def pft_first_masks(torch, opt, batch):
    """The first PFT forward's automask and valid mask (fwd and inv, each
    [2SB, H, W, 1]) in a mode that trains depth, from ``opt``'s state: the
    coupled solve with its error products on the initial disparities."""
    from tcsfm_torch.solver.coupled import solve_pose_iteratively
    from tcsfm_torch.utils.helpers import disp_to_depth

    win = opt._prepare(batch, batch["target_img"].device)
    b, cfg = win.target_img.shape[0], opt.cfg
    with torch.no_grad():
        depths = disp_to_depth(win.init_disps, cfg.min_depth,
                               cfg.max_depth)[1].reshape(
            (-1, b) + win.init_disps.shape[1:])
        _, _, out = solve_pose_iteratively(
            cfg.iterations, depths, win.pose_net, win.target_img,
            win.source_imgs, win.K, return_errors=True)
    return {k: torch.cat([getattr(out["fwd"], k), getattr(out["inv"], k)])
            .cpu() for k in ("auto_mask", "valid_mask")}


def one_ulp_up(torch, batch):
    """``batch`` with every image value moved one ulp up."""
    return {k: torch.nextafter(v, torch.full_like(v, 2.0))
            if k != "intrinsics" else v for k, v in batch.items()}


def phase_pft(torch, gs, cfg, build_models):
    """The fifth main path: PFT at bench.py's setting. Launch counts, ms
    per window and windows/s with the clocks, peak memory, the kernel- vs
    plain-sampler call, and a small call on the card against the CPU.
    Returns the launches (value, d_coords, d_img) of one call."""
    import copy

    from tcsfm_torch.config import PFTOptions
    from tcsfm_torch.solver import pft

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    depth_net, pose_net = build_models(
        cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    condition_like_trained(depth_net, torch)
    batch = pft_batch(torch, PFT_B, H, W, seed=7, device="cuda")
    opts = PFTOptions(epochs=PFT_EPOCHS, num_source_imgs=S)
    opt = pft.PFTOptimizer(cfg, opts, depth_net, pose_net, mode="encoder")
    expected = pft_expected_launches(PFT_EPOCHS, ITERS)
    before = copy.deepcopy(depth_net.state_dict())

    torch.cuda.reset_peak_memory_stats()
    zero_counts(gs)
    res = opt.optimize_window(batch)
    torch.cuda.synchronize()
    counts = read_counts(gs)
    check(counts == expected, f"launches (fwd, bwd_coords, bwd_img) "
          f"{counts} in one PFT call, expected {expected}")
    shapes = {"poses_opt": (S, PFT_B, 6), "poses_inv_opt": (S, PFT_B, 6),
              "disp_opt": (PFT_B, H, W), "losses": (PFT_EPOCHS,)}
    for k, shape in shapes.items():
        t = getattr(res, k)
        check(tuple(t.shape) == shape, f"{k} shape {tuple(t.shape)}")
        check(bool(torch.isfinite(t).all()), f"{k} has non-finite values")
    check(all(torch.equal(v, before[k])
              for k, v in depth_net.state_dict().items()),
          "optimize_window changed the caller's depth net")
    losses = res.losses.tolist()
    say("pft", f"main path: per PFT call launches (fwd, bwd_coords, "
        f"bwd_img) {counts}, expected E·I, (E-1)(I-1), E-1 = {expected}; "
        f"losses {losses[0]:.6f} -> {losses[-1]:.6f} (min "
        f"{min(losses):.6f}); scale_init {float(res.scale_init):.4f}, "
        f"scale_opt {float(res.scale_opt):.4f}")

    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")

    def timed_calls():
        ms = []
        for _ in range(PFT_TIMED):
            zero_counts(gs)
            start.record()
            opt.optimize_window(batch)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
            check(read_counts(gs) == expected, "launches of a timed call")
        return ms

    ms, clocks = with_clocks(timed_calls)
    counts = read_counts(gs)  # the main path's own: the last timed call
    med = statistics.median(ms)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    say("pft", f"{card}: PFT encoder {H}x{W} window batch {PFT_B} S={S} "
        f"iters={ITERS} epochs={PFT_EPOCHS} f32: median {med:.3f} ms a call "
        f"over {len(ms)} after 1 warm-up (CUDA events; {ms}) -> "
        f"{med / PFT_B:.3f} ms per window, {PFT_B / med * 1e3:.3f} "
        f"windows/s; clocks {clocks}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    (worst, spread, widened), fields, first = pft_parity(
        torch, gs, pft, opt, batch, "PFT kernel vs plain sampler")
    say("pft", f"kernel- vs plain-sampler first step from one state (cuDNN "
        f"deterministic): worst gradient relative L2 {worst:.3e} over the "
        f"encoder's {len(list(opt.depth_net.encoder.parameters()))} "
        f"parameter tensors (limit {STEP_GRAD_TOL}, or "
        f"{STEP_SPREAD_FACTOR}x the plain step's own spread where larger, "
        f"at most {STEP_GRAD_CAP}; worst spread {spread:.3e}); "
        f"{len(widened)} widened: " + (", ".join(
            f"{k} {e:.3e} -> {v:.3e}" for k, (e, v)
            in sorted(widened.items())) or "none"))
    say("pft", f"kernel- vs plain-sampler PFT call from one state: held "
        f"(first loss within {STEP_LOSS_TOL} relative, each field's "
        f"relative L2 within its limit, cap {PFT_CAP})")

    b, h, w, epochs = PFT_SMALL
    small = PFTOptions(epochs=epochs, num_source_imgs=S)
    d_cpu, p_cpu = build_models(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(1))
    condition_like_trained(d_cpu, torch)
    cpu_batch = pft_batch(torch, b, h, w, seed=8, device="cpu")
    card_batch = {k: v.cuda() for k, v in cpu_batch.items()}
    cpu_opt = pft.PFTOptimizer(cfg, small, d_cpu, p_cpu)
    card_opt = pft.PFTOptimizer(cfg, small, copy.deepcopy(d_cpu).cuda(),
                                copy.deepcopy(p_cpu).cuda())
    loss_c, grads_c = pft_first_step(torch, cpu_opt, cpu_batch,
                                     gs.grid_sample)
    loss_g, grads_g = pft_first_step(torch, card_opt, card_batch,
                                     gs.grid_sample)
    first = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    check(first <= PFT_CPU_LOSS_TOL, f"PFT card vs CPU: first loss {first}")
    worst = compare_grads({k: g.cpu() for k, g in grads_g.items()}, grads_c,
                          REF_GRAD_TOL_F32, "PFT card vs CPU, first step")
    on_cpu = pft_results(cpu_opt.optimize_window(cpu_batch, device="cpu"))
    on_card = pft_results(card_opt.optimize_window(card_batch))
    errs = {k: rel_l2_of(on_card[k], on_cpu[k]) for k in PFT_FIELDS}
    # witnesses that the gap is rounding: the first forward's mask pixels
    # that differ card vs CPU, and the CPU call against itself with its
    # images one ulp up (no kernel, no other device)
    masks_c = pft_first_masks(torch, cpu_opt, cpu_batch)
    masks_g = pft_first_masks(torch, card_opt, card_batch)
    flips = {k: int((masks_c[k] != masks_g[k]).sum()) for k in masks_c}
    on_cpu_ulp = pft_results(cpu_opt.optimize_window(
        one_ulp_up(torch, cpu_batch), device="cpu"))
    ulp = {k: rel_l2_of(on_cpu_ulp[k], on_cpu[k]) for k in PFT_FIELDS}
    say("pft", f"{h}x{w}: first forward's pixels that differ card vs CPU "
        f"of {masks_c['auto_mask'].numel()}: {flips}; the CPU call with "
        f"its images one ulp up against the CPU call, relative L2 "
        + ", ".join(f"{k} {e:.3e}" for k, e in ulp.items()))
    say("pft", f"{h}x{w} B={b} S={S} {epochs} epochs, trained-like: card vs "
        f"CPU first loss {first:.3e} relative (limit {PFT_CPU_LOSS_TOL}), "
        f"first "
        f"step's worst gradient relative L2 {worst:.3e} (limit "
        f"{REF_GRAD_TOL_F32}); the call's relative L2 " + ", ".join(
            f"{k} {e:.3e}" for k, e in errs.items())
        + f" (limit {PFT_CPU_TOL})")
    check(max(errs.values()) <= PFT_CPU_TOL, f"PFT card vs CPU at {h}x{w}: "
          f"{errs} > {PFT_CPU_TOL}")
    return counts


def seq_limit(spread: float) -> float:
    return min(SEQ_CAP, max(SEQ_TOL, SEQ_SPREAD_FACTOR * spread))


def quiet(fn, log_path):
    """``fn()`` with its standard output written to ``log_path`` (the CLIs
    print their JSON over many lines; this script's last two lines are
    its own)."""
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn()
    finally:
        with open(log_path, "w") as f:
            f.write(buf.getvalue())


def write_sequence(path, seq, images) -> None:
    """``seq`` with ``images`` as ``<path>/sequence_data.npz``, uncompressed,
    in ``SequenceData.from_npz``'s keys."""
    import os

    import numpy as np

    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "sequence_data.npz"), name=seq.name,
             intrinsics=seq.intrinsics, gt_poses=seq.gt_poses,
             vo_poses=seq.vo_poses, timestamps=seq.timestamps,
             images=images)


def preds_of(path):
    """Saved VO predictions: pose vectors at the solver's scale (the saved
    translations are x30) and the DNet scales."""
    import numpy as np

    d = np.load(path)
    out = {}
    for k in ("fwd_pose_vec", "inv_pose_vec"):
        v = d[k].astype(np.float64)
        v[:, :3] /= 30.0
        out[k] = v
    out["dnet_scale_factor"] = d["dnet_scale_factor"].astype(np.float64)
    return out


def preds_gap(a, b):
    """(max |a - b| over the pose vectors, max relative gap over the DNet
    scales): each is held at the limit its own spread sets, since the
    median under a DNet scale moves by a whole ulp of depth where a pose
    moves by far less."""
    import numpy as np

    gap = max(float(np.abs(a[k] - b[k]).max())
              for k in ("fwd_pose_vec", "inv_pose_vec"))
    sa, sb = a["dnet_scale_factor"], b["dnet_scale_factor"]
    with np.errstate(invalid="ignore", divide="ignore"):
        scale = np.where(sa == sb, 0.0, np.abs(sa - sb) / np.abs(sb))
    return gap, float(scale.max())


def within_spread(err, spread) -> bool:
    """Each of ``preds_gap``'s two gaps within the limit of its spread."""
    return all(e <= seq_limit(s) for e, s in zip(err, spread))


def gaps_text(err, spread) -> str:
    return "; ".join(f"{what} {e:.3e} (spread {s:.3e}, limit "
                     f"{seq_limit(s):.3e})" for what, e, s in
                     zip(("pose vectors", "DNet scales"), err, spread))


def seq_refiner_launches(refiner, iters, windows, frames):
    """(value, d_coords only, d_coords + d_img, value+Jacobian) launches of
    one run_sequential_pft call at the CLI's 20 epochs, ``iters`` coupled
    iterations: per window batch of ``SEQ_WB``, PFT's per call (phase
    "pft"), and the coupled forward's ``iters - 1`` value launches before
    ``window_ba`` or two ``gauss_newton_pose`` calls of 10 LM iterations
    (phase "refiners"); for chain, the coupled forward of every chunk of
    ``SEQ_WB`` windows and ``chain_ba`` of every block."""
    calls = -(-windows // SEQ_WB)
    if refiner == "adam":
        return tuple(calls * n
                     for n in pft_expected_launches(20, iters)) + (0,)
    if refiner == "chain":
        # blocks overlap by one frame (no short tail at these sizes)
        blocks = -(-(frames - 1) // (SEQ_CHAIN_BLOCK - 1))
        value, jac = REFINER_LAUNCHES["chain"]
        return (calls * (iters - 1) + blocks * value, 0, 0, blocks * jac)
    value, jac = REFINER_LAUNCHES[refiner]
    per = 1 if refiner == "ba" else 2
    return (calls * (iters - 1 + per * value), 0, 0, calls * per * jac)


def phase_sequence(torch, gs, cfg, build_models):
    """The sixth main path: the sequence CLIs on the card, weights through
    a checkpoint. Returns the launches (value, d_coords, d_img,
    value+Jacobian) of the VO pass over the drive and of each refiner's
    run_sequential_pft call."""
    import os
    from pathlib import Path

    import numpy as np

    from tcsfm_torch.cli import evaluate_vo
    from tcsfm_torch.cli import run_sequential_pft as seq_pft
    from tcsfm_torch.cli.common import load_nets
    from tcsfm_torch.data.dataset import SequenceData
    from tcsfm_torch.data.synthetic import make_synthetic_sequence
    from tcsfm_torch.eval.vo import VOEvaluator
    from tcsfm_torch.train.checkpoint import load_checkpoint, save_checkpoint

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    root = Path(__file__).resolve().parent
    work = root / "build" / "sequence"
    model_dir = str(work / "model")
    os.makedirs(work, exist_ok=True)

    def counts():
        return read_counts(gs) + (gs.LAUNCHES_FWD_GRADS,)

    # 1. phase "pft"'s trained-like nets through a checkpoint
    nets = build_models(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    condition_like_trained(nets[0], torch)
    save_checkpoint(model_dir, nets, epoch=1, best_val_loss=1.0, cfg=cfg,
                    is_best=True)
    fresh = build_models(cfg, device="cuda",
                         generator=torch.Generator().manual_seed(1))
    load_checkpoint(model_dir, fresh, load_best=True)
    for a, b in zip(nets, fresh):
        sa, sb = a.state_dict(), b.state_dict()
        check(sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                             for k in sa),
              "the checkpoint did not give the nets back bit for bit")
    size = os.path.getsize(os.path.join(model_dir, "checkpoint.msgpack"))
    say("sequence", f"checkpoint {size} B written and read back into fresh "
        f"nets: every tensor bit-equal")
    depth_net, pose_net = load_nets(model_dir, "cuda")

    # 2. the 64-frame cut: kernel vs plain sampler, the plain run's spread
    drive = root / SEQ_DRIVE
    t = time.monotonic()
    seq = SequenceData.from_npz(str(drive / "synthetic" / "sequence_data.npz"))
    load_s = time.monotonic() - t
    check(seq.images.dtype == np.uint8 and len(seq) == SEQ_DRIVE_FRAMES,
          f"the drive: {len(seq)} frames of {seq.images.dtype}")
    windows = len(seq) - 1
    cut = SequenceData(name="cut", intrinsics=seq.intrinsics[:SEQ_CUT],
                       gt_poses=seq.gt_poses[:SEQ_CUT],
                       vo_poses=seq.vo_poses[:SEQ_CUT],
                       timestamps=seq.timestamps[:SEQ_CUT])
    frames = seq.images[:SEQ_CUT]
    write_sequence(work / "data" / "cut", cut, frames)
    ulp = np.nextafter(frames.astype(np.float32) / np.float32(255.0),
                       np.float32(2.0))
    write_sequence(work / "data" / "cut_ulp", cut, ulp)

    def vo_args(seqs, preds, *extra):
        return evaluate_vo.parse_args(
            ["--model_dir", model_dir, "--batch", str(SEQ_BATCH),
             "--iterations", str(ITERS), "--save_preds", str(preds)]
            + (["--data_dir", str(work / "data"), "--seqs", seqs]
               if seqs else ["--synthetic"]) + list(extra))

    runs = {}
    for name, seqs, sampler in (("kernel", "cut", gs.grid_sample),
                                ("plain", "cut", gs.grid_sample_plain),
                                ("plain_ulp", "cut_ulp",
                                 gs.grid_sample_plain)):
        preds = work / f"preds_{name}"
        quiet(lambda: evaluate_vo.run(vo_args(seqs, preds), depth_net,
                                      pose_net, "cuda", sampler=sampler),
              work / f"vo_{name}.log")
        runs[name] = preds_of(preds / f"{seqs}_preds.npz")
    # the value kernel is bit-equal to the plain sampler (phase "kernels"),
    # so the two runs are too; one ulp on the images moves the pose chain
    # by ~1e-3 at 192x640, so no limit short of equality tells them apart
    err = preds_gap(runs["kernel"], runs["plain"])
    spread = preds_gap(runs["plain_ulp"], runs["plain"])
    say("sequence", f"evaluate_vo on the drive's first {SEQ_CUT} frames, "
        f"kernel vs plain sampler: pose vectors {err[0]:.3e}, DNet scales "
        f"{err[1]:.3e} apart (equality required; the plain run with its "
        f"images one ulp up: {spread[0]:.3e}, {spread[1]:.3e})")
    check(err == (0.0, 0.0), f"evaluate_vo kernel vs plain: pose vectors "
          f"{err[0]}, DNet scales {err[1]} apart, not equal")

    # 3. one timed pass over the whole drive, loaded above, by the
    # evaluator the CLI builds from its arguments (the cut warmed its
    # shapes up)
    args = evaluate_vo.parse_args(
        ["--model_dir", model_dir, "--data_dir", str(drive), "--seqs",
         "synthetic", "--batch", str(SEQ_BATCH), "--iterations", str(ITERS)])
    ev = VOEvaluator(evaluate_vo.config_of(args), depth_net, pose_net,
                     device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(gs)

    def whole():
        t0 = time.monotonic()
        out = quiet(lambda: ev.run_sequence(seq, batch_size=args.batch),
                    work / "vo_drive.log")
        torch.cuda.synchronize()
        return out, time.monotonic() - t0

    (errs, wall), clocks = with_clocks(whole)
    vo_counts = counts()
    del seq
    want = (-(-windows // SEQ_BATCH) * (ITERS - 1), 0, 0, 0)
    check(vo_counts == want, f"evaluate_vo launches {vo_counts}, expected "
          f"{want}")
    check(all(np.isfinite(errs[k][:2]).all() for k in
              ("errors_unscaled", "errors_dnet", "errors_gt_scaled")),
          f"evaluate_vo errors not finite: "
          f"{[errs[k] for k in errs if k.startswith('errors')]}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    say("sequence", f"{card}: evaluate_vo over the drive, {windows} pair "
        f"windows at 192x640, batch {SEQ_BATCH}, {ITERS} iterations, f32: "
        f"one pass {wall:.3f} s -> {windows / wall:.2f} windows/s (the "
        f"drive's load before it, host: {load_s:.3f} s); "
        f"clocks {clocks}; launches (value, d_coords, d_img, "
        f"value+Jacobian) {vo_counts}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; errors "
        + ", ".join(f"{k} {errs[k]}" for k in
                    ("errors_unscaled", "errors_dnet", "errors_gt_scaled"))
        + f", gt_scale {float(errs['gt_scale']):.6f}")

    # 4. run_sequential_pft, each refiner once, on the card
    refine_counts = {}
    for refiner, frames_n, extra in (
            ("adam", SEQ_FRAMES, ["--mode", "encoder", "--epochs", "20"]),
            ("ba", SEQ_FRAMES, []), ("gn", SEQ_FRAMES, []),
            ("chain", SEQ_CHAIN_FRAMES,
             ["--chain_block", str(SEQ_CHAIN_BLOCK)])):
        argv = (["--model_dir", model_dir, "--synthetic", "--synthetic_size",
                 str(H), str(W), "--synthetic_frames", str(frames_n),
                 "--window_batch", str(SEQ_WB), "--refiner", refiner,
                 "--out_dir", str(work / f"pft_{refiner}")] + extra)
        zero_counts(gs)
        res = quiet(lambda: seq_pft.main(argv), work / f"pft_{refiner}.log")
        torch.cuda.synchronize()
        got = counts()
        want = seq_refiner_launches(refiner, ITERS, frames_n - 2, frames_n)
        check(got == want, f"run_sequential_pft --refiner {refiner}: "
              f"launches {got}, expected {want}")
        r = res["synthetic"]
        rate = r.get("windows_per_s", r.get("edges_per_s"))
        check(np.isfinite(r["errors_optimized"][:2]).all()
              and np.isfinite(r["errors_initial"][:2]).all(),
              f"{refiner}: errors not finite: {r}")
        if refiner != "adam":
            check(r["pft_loss_last"] < r["pft_loss_first"], f"{refiner}: the "
                  f"cost did not fall: {r['pft_loss_first']} -> "
                  f"{r['pft_loss_last']}")
        refine_counts[refiner] = got
        say("sequence", f"run_sequential_pft --refiner {refiner}, "
            f"{frames_n} frames at {H}x{W}: "
            f"{'edges' if refiner == 'chain' else 'windows'}/s {rate} "
            f"(wall {r['wall_s']} s); loss {r['pft_loss_first']:.6f} -> "
            f"{r['pft_loss_last']:.6f}; errors initial "
            f"{r['errors_initial']}, optimized {r['errors_optimized']}; "
            f"launches (value, d_coords, d_img, value+Jacobian) {got} "
            f"(expected {want})")

    # 5. card vs CPU at 64x96, each with the CPU run's images one ulp up
    cpu_nets = load_nets(model_dir, "cpu")
    syn = make_synthetic_sequence(24, (64, 96), seed=11)
    write_sequence(work / "data" / "syn_ulp", syn,
                   np.nextafter(syn.images, np.float32(2.0)))
    vo_errs, vo_preds = {}, {}
    for name, seqs, device, pair in (
            ("card", "", "cuda", (depth_net, pose_net)),
            ("cpu", "", "cpu", cpu_nets),
            ("cpu_ulp", "syn_ulp", "cpu", cpu_nets)):
        preds = work / f"preds_syn_{name}"
        vo_errs[name] = quiet(lambda: evaluate_vo.run(
            vo_args(seqs, preds), *pair, device), work / f"vo_syn_{name}.log")
        vo_preds[name] = preds_of(preds / f"{seqs or 'synthetic'}_preds.npz")
    err = preds_gap(vo_preds["card"], vo_preds["cpu"])
    spread = preds_gap(vo_preds["cpu_ulp"], vo_preds["cpu"])
    card_errs = vo_errs["card"]["synthetic"]
    cpu_errs = vo_errs["cpu"]["synthetic"]
    err_gap = max(abs(a - b) for k in ("errors_unscaled", "errors_dnet",
                                       "errors_gt_scaled")
                  for a, b in zip(card_errs[k][:2], cpu_errs[k][:2]))
    say("sequence", f"evaluate_vo --synthetic (24 frames, 64x96, {ITERS} "
        f"iterations) card vs CPU, against the CPU run with its images one "
        f"ulp up: {gaps_text(err, spread)}; errors {err_gap:.3e} apart "
        f"(limit {SEQ_ERR_TOL})")
    check(within_spread(err, spread) and err_gap <= SEQ_ERR_TOL + 1e-9,
          f"evaluate_vo card vs CPU: {gaps_text(err, spread)}, errors "
          f"{err_gap}")

    gn_runs = {}
    seq16 = make_synthetic_sequence(SEQ_FRAMES, (64, 96), seed=13)
    write_sequence(work / "data" / "gn_ulp", seq16,
                   np.nextafter(seq16.images, np.float32(2.0)))
    for name, device, src in (("card", "cuda", ["--synthetic"]),
                              ("cpu", "cpu", ["--synthetic"]),
                              ("cpu_ulp", "cpu",
                               ["--data_dir", str(work / "data"), "--seqs",
                                "gn_ulp"])):
        out_dir = work / f"gn_{name}"
        argv = ["--model_dir", model_dir, "--refiner", "gn",
                "--synthetic_frames", str(SEQ_FRAMES), "--window_batch",
                str(SEQ_WB), "--out_dir", str(out_dir)] + src
        pair = (depth_net, pose_net) if device == "cuda" else cpu_nets
        res = quiet(lambda: seq_pft.run(seq_pft.parse_args(argv), *pair,
                                        device), work / f"gn_{name}.log")
        key = "synthetic" if name != "cpu_ulp" else "gn_ulp"
        gn_runs[name] = (res[key], np.load(out_dir / f"{key}_pft.npz"))

    def gap(a, b):
        return max(float(np.abs(a[1][k].astype(np.float64) - b[1][k]).max())
                   / max(float(np.abs(b[1][k]).max()), 1e-30)
                   for k in ("pose_init", "pose_opt"))

    err, spread = gap(gn_runs["card"], gn_runs["cpu"]), gap(
        gn_runs["cpu_ulp"], gn_runs["cpu"])
    err_gap = max(abs(a - b) for k in ("errors_initial", "errors_optimized")
                  for a, b in zip(gn_runs["card"][0][k][:2],
                                  gn_runs["cpu"][0][k][:2]))
    say("sequence", f"run_sequential_pft --synthetic --refiner gn "
        f"({SEQ_FRAMES} frames, 64x96) card vs CPU: pose_init and pose_opt "
        f"{err:.3e} of their largest apart (the CPU run with its images one "
        f"ulp up: {spread:.3e}, limit {seq_limit(spread):.3e}); errors "
        f"{err_gap:.3e} apart (limit {SEQ_ERR_TOL})")
    check(err <= seq_limit(spread) and err_gap <= SEQ_ERR_TOL + 1e-9,
          f"run_sequential_pft gn card vs CPU: {err}, errors {err_gap}")
    return vo_counts, refine_counts


def save_reference_checkpoint(torch, depth_net, pose_net, path) -> None:
    """The nets as the reference's published checkpoints hold them
    (run_mono_training.py:228-234): ``torch.save`` of a dict with
    ``depth_state_dict``, ``pose_state_dict``, ``epoch`` and
    ``best_val_loss``; the port's names are the reference's."""
    torch.save({"depth_state_dict": {k: v.cpu() for k, v in
                                     depth_net.state_dict().items()},
                "pose_state_dict": {k: v.cpu() for k, v in
                                    pose_net.state_dict().items()},
                "epoch": 7, "best_val_loss": 0.25}, str(path))


def nearest_resize(depth, shape):
    """``depth`` [h, w] nearest-resized to ``shape`` (pixel centres)."""
    import numpy as np

    h, w = depth.shape
    iy = ((np.arange(shape[0]) + 0.5) * h / shape[0]).astype(np.int64)
    ix = ((np.arange(shape[1]) + 0.5) * w / shape[1]).astype(np.int64)
    return depth[np.ix_(iy, ix)]


def write_eigen_split(path, images, K, poses):
    """``images`` as JPEGs (quality 95, as ``data.preprocess eigen`` writes
    them) with ``eigen_info_test.npz`` in ``data.eigen.EigenDataset``'s
    layout, one drive; written on 8 threads."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    os.makedirs(path, exist_ok=True)

    def write(i):
        f = os.path.join(path, f"{i:010d}.jpg")
        Image.fromarray(images[i]).save(f, quality=95)
        return f

    with ThreadPoolExecutor(8) as pool:
        files = list(pool.map(write, range(len(images))))
    n = len(files)
    np.savez(os.path.join(path, "eigen_info_test.npz"),
             files=np.asarray(files), K=K[:n], poses=poses[:n],
             folders=np.asarray(["drive1504"] * n), idxs=np.arange(n))


def write_gt_depths(path, depths) -> int:
    """``depths`` (1/30-metric) as metric GT maps at ``EVAL_GT_SHAPE`` in
    ``preprocess eigen_gt_depth``'s npz (an object array under ``data``);
    returns the maps' bytes."""
    import numpy as np

    gt = np.empty(len(depths), object)
    for i, d in enumerate(depths):
        gt[i] = nearest_resize(d, EVAL_GT_SHAPE) * np.float32(30.0)
    np.savez(path, data=gt)
    return sum(g.nbytes for g in gt)


def recorded(module, name, out: list):
    """Context: ``module.name`` wrapped to time each call (CUDA
    synchronized around it) and keep its result in ``out`` as
    (seconds, result)."""
    import torch

    real = getattr(module, name)

    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real(*a, **kw)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t, res))
        return res

    @contextlib.contextmanager
    def ctx():
        setattr(module, name, wrapper)
        try:
            yield out
        finally:
            setattr(module, name, real)

    return ctx()


def loader_seconds(dataset, batch: int) -> float:
    """Wall seconds of one pass of the CLIs' loader over ``dataset`` (batch
    ``batch``, prefetching), with no network behind it."""
    from tcsfm_torch.data.loader import BatchLoader

    t = time.perf_counter()
    for _ in BatchLoader(dataset, batch, shuffle=False, drop_last=False,
                         prefetch=2):
        pass
    return time.perf_counter() - t


def scannet_vecs(mats):
    """Fused pose matrices as pose vectors at the solver's scale."""
    import numpy as np

    from tcsfm_torch.eval.trajectory import np_se3_log

    v = np.stack([np_se3_log(np.asarray(m, np.float64)) for m in mats])
    v[:, :3] /= 30.0
    return v


def scannet_gap(a, b):
    """(max |a - b| over the target disparities, over the fused pose
    vectors) of two ``evaluate_scannet.predict`` results."""
    import numpy as np

    return (float(np.abs(np.stack(a[1]) - np.stack(b[1])).max()),
            float(np.abs(scannet_vecs(a[2]) - scannet_vecs(b[2])).max()))


def golden_synthetic_launches(args):
    """(value, d_coords, d_img) launches of ``golden_eval --synthetic`` at
    ``args``: its training steps (2 iterations, remat on), the VO passes
    over the test sequence (untrained, trained, and the saved pass with
    ``--save_dir``; batch 8, 1 value launch a batch) and PFT's calls
    (window batch 4, ``args.pft_epochs`` epochs)."""
    windows = 2 * (args.synthetic_frames - 2)
    test = max(16, args.synthetic_frames)
    steps = args.train_epochs * (windows // 4)
    vo = (2 + bool(args.save_dir)) * -(-(test - 1) // 8)
    calls = -(-(test - 2) // 4)
    step = step_launches(2, True)
    call = pft_expected_launches(args.pft_epochs, 2)
    return (steps * step[0] + vo + calls * call[0],
            steps * step[1] + calls * call[1],
            steps * step[2] + calls * call[2])


def phase_eval(torch, gs, cfg, build_models):
    """The eighth main path: the evaluation CLIs on the card, at full
    width. Returns their launches (value, d_coords, d_img, value+Jacobian)
    by path."""
    import dataclasses
    import os
    import shutil
    from pathlib import Path

    import numpy as np

    from tcsfm_torch.cli import (evaluate_depth_eigen, evaluate_scannet,
                                 golden_eval, import_checkpoint)
    from tcsfm_torch.cli.common import load_nets
    from tcsfm_torch.data.dataset import SequenceData

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    root = Path(__file__).resolve().parent
    work = root / "build" / "eval"
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    model_dir = str(work / "model")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    launches = {}

    def counts():
        return read_counts(gs) + (gs.LAUNCHES_FWD_GRADS,)

    # 1. a reference-layout checkpoint through import_checkpoint
    nets = build_models(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    condition_like_trained(nets[0], torch)
    pt = work / "best_model.pt"
    save_reference_checkpoint(torch, *nets, pt)
    # the float32 main-path config carried over (the CLI's own default,
    # as JAX's, is bfloat16)
    cfg.save(str(work / "config_in.json"))
    out = quiet(lambda: import_checkpoint.main(
        ["--torch_ckpt", str(pt), "--out_dir", model_dir, "--config",
         str(work / "config_in.json")]), work / "import.log")
    check(out["epoch"] == 7 and out["best_val_loss"] == 0.25,
          f"import_checkpoint printed {out}")
    depth_net, pose_net = load_nets(model_dir, "cuda")
    for a, b in zip(nets, (depth_net, pose_net)):
        sa, sb = a.state_dict(), b.state_dict()
        check(sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                             for k in sa),
              "the imported checkpoint did not give the nets back bit for "
              "bit")
    say("eval", f"reference-layout .pt ({os.path.getsize(pt)} B) through "
        f"import_checkpoint, read back by cli.common.load_nets: every "
        f"tensor bit-equal")

    # 2. Eigen at the test split's size
    t = time.monotonic()
    drive = np.load(str(root / SEQ_DRIVE / "synthetic" / "sequence_data.npz"))
    n_img = max(EVAL_EIGEN_FRAMES, EVAL_SCENE_FRAMES, EVAL_REAL_FRAMES)
    images = drive["images"][:n_img]
    depths = drive["depths"][:n_img]
    K, poses, stamps = (drive[k] for k in ("intrinsics", "gt_poses",
                                           "timestamps"))
    load_s = time.monotonic() - t
    t = time.monotonic()
    eig = work / "eigen"
    write_eigen_split(str(eig), images[:EVAL_EIGEN_FRAMES], K, poses)
    gt_path = str(eig / "gt_depths.npz")
    gt_bytes = write_gt_depths(gt_path, depths[:EVAL_EIGEN_FRAMES])
    write_s = time.monotonic() - t
    disps_path = str(work / "eigen_disps.npy")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(gs)
    argv = ["--model_dir", model_dir, "--data_dir", str(eig), "--gt_depths",
            gt_path, "--batch", str(EVAL_BATCH)]
    t = time.monotonic()
    with recorded(evaluate_depth_eigen, "predict", []) as pred:
        metrics = quiet(lambda: evaluate_depth_eigen.main(
            argv + ["--save_pred_disps", disps_path]), work / "eigen.log")
    wall = time.monotonic() - t
    launches["eigen"] = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    pred_s, disps = pred[0]
    check(disps.shape == (EVAL_EIGEN_FRAMES, H, W)
          and np.isfinite(disps).all(), f"Eigen disparities {disps.shape}")
    check(all(np.isfinite(v) for v in metrics.values())
          and 0.0 <= metrics["a1"] <= 1.0, f"Eigen metrics {metrics}")
    t = time.monotonic()
    replay = quiet(lambda: evaluate_depth_eigen.main(
        ["--gt_depths", gt_path, "--pred_disps", disps_path]),
        work / "eigen_replay.log")
    replay_s = time.monotonic() - t
    check(replay == metrics, f"the --pred_disps replay {replay} is not the "
          f"run's {metrics}")
    check(launches["eigen"] == (0, 0, 0, 0), f"Eigen launched the sampler: "
          f"{launches['eigen']}")
    from tcsfm_torch.data.eigen import EigenDataset

    eig_loader_s = loader_seconds(EigenDataset(str(eig), mode="test"),
                                  EVAL_BATCH)
    imgs = torch.from_numpy(images[:EVAL_BATCH].astype(np.float32)
                            / np.float32(255.0)).cuda()
    fwd_ms = time_ms(lambda: evaluate_depth_eigen.scaled_disparity(
        depth_net, imgs, cfg), iters=10, warmup=3)
    say("eval", f"{card}: evaluate_depth_eigen, {EVAL_EIGEN_FRAMES} frames "
        f"at {H}x{W}, batch {EVAL_BATCH} (flip-merged: {2 * EVAL_BATCH} "
        f"images a forward), GT {EVAL_GT_SHAPE[0]}x{EVAL_GT_SHAPE[1]} "
        f"({gt_bytes / 1e9:.2f} GB of f32): predictions {pred_s:.3f} s -> "
        f"{EVAL_EIGEN_FRAMES / pred_s:.2f} images/s (the loader alone "
        f"{eig_loader_s:.3f} s; one flip-merged forward of {EVAL_BATCH} "
        f"images {fwd_ms:.3f} ms, x{-(-EVAL_EIGEN_FRAMES // EVAL_BATCH)} = "
        f"{fwd_ms * -(-EVAL_EIGEN_FRAMES // EVAL_BATCH) / 1e3:.3f} s); the "
        f"CLI {wall:.3f} s "
        f"with its metrics (host); the --pred_disps replay {replay_s:.3f} s, "
        f"metrics equal; the drive's load {load_s:.3f} s, the split written "
        f"in {write_s:.3f} s; peak memory {peak:.1f} MiB; "
        + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))

    small = work / "eigen_small"
    write_eigen_split(str(small), images[:EVAL_CPU_FRAMES], K, poses)
    args = evaluate_depth_eigen.parse_args(["--model_dir", model_dir,
                                            "--data_dir", str(small)])
    cpu_depth, cpu_pose = load_nets(model_dir, "cpu")
    got = quiet(lambda: evaluate_depth_eigen.predict(args, depth_net, "cuda"),
                work / "eigen_small.log")
    ref = quiet(lambda: evaluate_depth_eigen.predict(args, cpu_depth, "cpu"),
                work / "eigen_small_cpu.log")
    span = 1.0 / cfg.min_depth - 1.0 / cfg.max_depth
    err = float(np.abs(got - ref).max()) / span
    say("eval", f"Eigen, {EVAL_CPU_FRAMES} frames card vs CPU: scaled "
        f"disparity {err:.3e} of its range apart (limit {EVAL_CPU_TOL})")
    check(err <= EVAL_CPU_TOL, f"Eigen card vs CPU {err} > {EVAL_CPU_TOL}")
    os.remove(gt_path)
    os.remove(disps_path)

    # 3. ScanNet: a scene of the drive's first frames, kernel vs plain
    n = EVAL_SCENE_FRAMES
    scan = work / "scannet"
    os.makedirs(scan)
    scene = dict(name="scene0", intrinsics=K[:n], gt_poses=poses[:n],
                 vo_poses=poses[:n], timestamps=stamps[:n],
                 depths=depths[:n])
    np.savez(scan / "scene0.npz", images=images[:n], **scene)
    np.savez(scan / "scene0_ulp.npz", images=np.nextafter(
        images[:n].astype(np.float32) / np.float32(255.0), np.float32(2.0)),
        **dict(scene, name="scene0_ulp"))
    windows = n - 2 * EVAL_GAP
    runs = {}
    for name, scenes, sampler in (
            ("kernel", "scene0", gs.grid_sample),
            ("plain", "scene0", gs.grid_sample_plain),
            ("plain_ulp", "scene0_ulp", gs.grid_sample_plain)):
        args = evaluate_scannet.parse_args(
            ["--model_dir", model_dir, "--data_dir", str(scan), "--scenes",
             scenes, "--iterations", str(EVAL_SCANNET_ITERS), "--frame_gap",
             str(EVAL_GAP), "--batch", str(EVAL_BATCH)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(gs)
        with recorded(evaluate_scannet, "predict", []) as pred:
            res = quiet(lambda: evaluate_scannet.run(
                args, depth_net, pose_net, "cuda", sampler=sampler),
                work / f"scannet_{name}.log")
        runs[name] = (pred[0][0], pred[0][1], res, counts(),
                      torch.cuda.max_memory_allocated() / 2 ** 20)
    wall, preds, res, got, peak = runs["kernel"]
    launches["scannet"] = got
    want = (-(-windows // EVAL_BATCH) * (EVAL_SCANNET_ITERS - 1), 0, 0, 0)
    check(got == want, f"evaluate_scannet launches {got}, expected {want}")
    check(runs["plain"][3] == (0, 0, 0, 0), "the plain run launched kernels")
    check(len(preds[2]) == windows and all(
        np.isfinite(v) for part in res.values() for v in part.values()),
        f"evaluate_scannet: {len(preds[2])} windows, {res}")
    from tcsfm_torch.data.scannet import ScanNetTestDataset
    from tcsfm_torch.utils.helpers import to_device

    ds = ScanNetTestDataset([SequenceData.from_npz(str(scan / "scene0.npz"))],
                            frame_gap=EVAL_GAP)
    scan_loader_s = loader_seconds(ds, EVAL_BATCH)
    from tcsfm_torch.data.loader import collate_windows

    x = to_device(collate_windows([ds[i] for i in range(EVAL_BATCH)]),
                  ("target_img", "source_imgs", "intrinsics"), "cuda")
    cfg8 = dataclasses.replace(cfg, iterations=EVAL_SCANNET_ITERS)
    infer_ms = time_ms(lambda: evaluate_scannet.infer(
        cfg8, depth_net, pose_net, x["target_img"], x["source_imgs"][0],
        x["intrinsics"]), iters=5, warmup=2)
    err = scannet_gap(preds, runs["plain"][1])
    spread = scannet_gap(runs["plain_ulp"][1], runs["plain"][1])
    text = "; ".join(f"{what} {e:.3e} (spread {s:.3e}, limit "
                     f"{seq_limit(s):.3e})" for what, e, s in zip(
                         ("disparities", "pose vectors"), err, spread))
    say("eval", f"{card}: evaluate_scannet, {windows} windows at {H}x{W} "
        f"(gap {EVAL_GAP}), batch {EVAL_BATCH}, {EVAL_SCANNET_ITERS} "
        f"iterations, flip-merged: {wall:.3f} s -> {windows / wall:.2f} "
        f"windows/s (the loader alone {scan_loader_s:.3f} s; one batch's "
        f"infer {infer_ms:.3f} ms, x{-(-windows // EVAL_BATCH)} = "
        f"{infer_ms * -(-windows // EVAL_BATCH) / 1e3:.3f} s); launches (value, d_coords, d_img, value+Jacobian) "
        f"{got} (expected {want}: {EVAL_SCANNET_ITERS - 1} a batch); peak "
        f"memory {peak:.1f} MiB; kernel vs plain sampler: {text}; "
        f"depth {res['depth']}, pose {res['pose']}")
    check(all(e <= seq_limit(s) for e, s in zip(err, spread)),
          f"evaluate_scannet kernel vs plain: {text}")

    # 4. golden_eval's real table on the drive's first frames as 09_02
    n = EVAL_REAL_FRAMES
    # KITTI's poses are in metres, the drive's at the networks' 1/30 scale
    metric = poses[:n].copy()
    metric[:, :3, 3] *= 30.0
    real = SequenceData(name="09_02", intrinsics=K[:n], gt_poses=metric,
                        vo_poses=metric, timestamps=stamps[:n])
    write_sequence(work / "real" / "09_02", real, images[:n])
    zero_counts(gs)
    t = time.monotonic()
    out = quiet(lambda: golden_eval.main(
        ["--model_dir", model_dir, "--data_dir", str(work / "real"),
         "--seqs", "09_02", "--iterations", str(ITERS)]),
        work / "golden_real.log")
    wall = time.monotonic() - t
    launches["golden_real"] = counts()
    rows = out["seqs"]["09_02"]["rows"]
    anchors = golden_eval.BASELINES["09_02"]
    check(len(rows) == 4 and all(
        r["baseline"] == anchors[r["metric"]] and "tol" in r
        and r["status"] in ("PASS", "FAIL") for r in rows),
        f"golden_eval's table: {rows}")
    want = (-(-(n - 1) // 8) * (ITERS - 1), 0, 0, 0)
    check(launches["golden_real"] == want, f"golden_eval real launches "
          f"{launches['golden_real']}, expected {want}")
    say("eval", f"golden_eval (real path) on the drive's first {n} frames "
        f"as 09_02, {ITERS} iterations: {wall:.3f} s; launches "
        f"{launches['golden_real']}; rows (random weights, verdicts not "
        f"asserted): " + "; ".join(
            f"{r['metric']} {r['ours']:.3f} vs {r['baseline']} + {r['tol']} "
            f"{r['status']}" for r in rows))

    # 5. golden_eval --synthetic at its defaults
    argv = ["--synthetic"]
    zero_counts(gs)
    t = time.monotonic()
    out = quiet(lambda: golden_eval.main(argv), work / "golden_synthetic.log")
    torch.cuda.synchronize()
    wall = time.monotonic() - t
    launches["golden_synthetic"] = counts()
    want = golden_synthetic_launches(golden_eval.parse_args(argv)) + (0,)
    check(set(GOLDEN_RAW_KEYS) | {"inject_regression", "gates", "pass"}
          == set(out) and set(out["gates"]) == set(GOLDEN_GATES),
          f"golden_eval --synthetic keys {sorted(out)}")
    check(all(np.isfinite(out[k]) for k in GOLDEN_RAW_KEYS[1:]),
          f"golden_eval --synthetic: a metric is not finite: {out}")
    check(launches["golden_synthetic"] == want, f"golden_eval --synthetic "
          f"launches {launches['golden_synthetic']}, expected {want}")
    say("eval", f"{card}: golden_eval --synthetic at its defaults: "
        f"{wall:.3f} s; launches {launches['golden_synthetic']}; gates "
        f"(printed, not asserted) {out['gates']}; "
        + ", ".join(f"{k} {out[k]!r}" for k in GOLDEN_RAW_KEYS[1:]))
    return launches


def phase_flow(torch, gs, build_models):
    """The ninth main path, phase "flow": classical flow on the card at
    192x640 (``ops.flow``), the 8-channel pose net's one-shot VO and
    validation panels, the legacy ``inverse_warp``, the SE(3) maps and
    ``utils.profiling.trace``. Returns the value kernel's launches by
    path (the other kernels launch no time here)."""
    import json as json_
    import os
    import shutil
    from pathlib import Path

    import numpy as np
    import scipy.ndimage as ndi

    from tcsfm_torch.cli import evaluate_vo
    from tcsfm_torch.config import Config
    from tcsfm_torch.data.dataset import SequenceData, SfMWindowDataset
    from tcsfm_torch.data.transforms import get_transforms
    from tcsfm_torch.eval.vo import VOEvaluator
    from tcsfm_torch.geom import se3
    from tcsfm_torch.geom.warp import inverse_warp
    from tcsfm_torch.ops import flow
    from tcsfm_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from tcsfm_torch.train.validate import depth_and_reconstruction_panels
    from tcsfm_torch.utils import profiling

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    root = Path(__file__).resolve().parent
    work = root / "build" / "flow"
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    model_dir = str(work / "model")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    launches = {}

    def counts():
        return read_counts(gs) + (gs.LAUNCHES_FWD_GRADS,)

    # 1. a classical config with seeded 8-channel nets through a checkpoint
    cfg = Config(iterations=1, flow_type="classical", img_resolution="med",
                 compute_dtype="float32")
    nets = build_models(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    condition_like_trained(nets[0], torch)
    check(nets[1].conv1[0].weight.shape[1] == 8,
          f"the pose net takes {nets[1].conv1[0].weight.shape[1]} channels")
    save_checkpoint(model_dir, nets, epoch=1, best_val_loss=1.0, cfg=cfg,
                    is_best=True)
    fresh = build_models(cfg, device="cuda",
                         generator=torch.Generator().manual_seed(1))
    load_checkpoint(model_dir, fresh, load_best=True)
    for a, b in zip(nets, fresh):
        sa, sb = a.state_dict(), b.state_dict()
        check(sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                             for k in sa),
              "the classical checkpoint did not give the nets back bit for "
              "bit")
    check(Config.load(os.path.join(model_dir, "config.json")) == cfg,
          "config.json did not give the classical config back")
    say("flow", "classical config (iterations 1, 8-channel pose net) and "
        "seeded nets through a checkpoint: every tensor bit-equal")

    # 2. the flow pair on the card against the CPU on the drive's frames,
    # held at the CPU run's own spread with its images one ulp up
    drive = root / SEQ_DRIVE
    seq = SequenceData.from_npz(str(drive / "synthetic" / "sequence_data.npz"))
    frames = seq.images
    pairs = np.stack([np.stack([frames[i], frames[j]]) for i, j in
                      FLOW_PAIRS]).astype(np.float32) / np.float32(255.0)
    tgt, src = torch.from_numpy(pairs[:, 0]), torch.from_numpy(pairs[:, 1])

    def pair_px(t, s):
        fwd, back = flow.batched_flow_pair(t, s)
        return torch.stack([fwd, back]).double().cpu().numpy() * W

    on_card = pair_px(tgt.cuda(), src.cuda())
    on_cpu = pair_px(tgt, src)
    up = [torch.from_numpy(np.nextafter(x.numpy(), np.float32(2.0)))
          for x in (tgt, src)]
    on_cpu_ulp = pair_px(*up)
    gap = float(np.abs(on_card - on_cpu).max())
    spread = float(np.abs(on_cpu_ulp - on_cpu).max())
    limit = max(FLOW_TOL, FLOW_SPREAD_FACTOR * spread)
    check(np.isfinite(on_card).all(), "the card's flow is not finite")
    say("flow", f"batched_flow_pair on drive pairs {FLOW_PAIRS} at {H}x{W}: "
        f"card vs CPU {gap:.3e} px (the CPU with its images one ulp up: "
        f"{spread:.3e} px, limit {limit:.3e}); |flow| up to "
        f"{np.abs(on_card).max():.2f} px")
    check(gap <= limit, f"flow card vs CPU {gap} px > {limit}")

    # 3. a textured frame's known sub-pixel shift, on the card
    rng = np.random.RandomState(0)
    base = ndi.gaussian_filter(rng.rand(H, W).astype(np.float32), 3.0) * 255
    moved = ndi.shift(base, FLOW_SHIFT[::-1], order=3, mode="nearest")
    got = flow.farneback_flow(torch.from_numpy(base).cuda(),
                              torch.from_numpy(moved).cuda()).cpu().numpy()
    mean = got[12:-12, 12:-12].reshape(-1, 2).mean(0)
    say("flow", f"farneback_flow of a texture shifted by {FLOW_SHIFT} px: "
        f"interior mean {mean[0]:.4f}, {mean[1]:.4f} px (limit "
        f"{FLOW_SHIFT_TOL} px)")
    check(np.abs(mean - FLOW_SHIFT).max() <= FLOW_SHIFT_TOL,
          f"the shift came back as {mean}")

    # 4. evaluate_vo --iterations 1 through main over the drive's first
    # frames, then one timed pass of the evaluator it builds
    cut = SequenceData(name="cut", intrinsics=seq.intrinsics[:FLOW_VO_FRAMES],
                       gt_poses=seq.gt_poses[:FLOW_VO_FRAMES],
                       vo_poses=seq.vo_poses[:FLOW_VO_FRAMES],
                       timestamps=seq.timestamps[:FLOW_VO_FRAMES],
                       images=frames[:FLOW_VO_FRAMES])
    del seq, frames
    write_sequence(work / "data" / "cut", cut, cut.images)
    argv = ["--model_dir", model_dir, "--data_dir", str(work / "data"),
            "--seqs", "cut", "--batch", str(SEQ_BATCH), "--iterations", "1"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(gs)
    t0 = time.monotonic()
    errs = quiet(lambda: evaluate_vo.main(argv), work / "vo.log")["cut"]
    torch.cuda.synchronize()
    main_s = time.monotonic() - t0
    launches["evaluate_vo"] = counts()
    check(launches["evaluate_vo"] == (0, 0, 0, 0), f"evaluate_vo "
          f"--iterations 1 launched {launches['evaluate_vo']}: the one-shot "
          f"pose warps nothing")
    check(all(np.isfinite(errs[k][:2]).all() for k in
              ("errors_unscaled", "errors_dnet", "errors_gt_scaled")),
          f"evaluate_vo errors not finite: {errs}")
    peak = torch.cuda.max_memory_allocated() / 2**20
    windows = FLOW_VO_FRAMES - 1
    depth_net, pose_net = nets
    ev = VOEvaluator(evaluate_vo.config_of(evaluate_vo.parse_args(argv)),
                     depth_net, pose_net, device="cuda")

    def one_pass():
        t1 = time.monotonic()
        quiet(lambda: ev.run_sequence(cut, batch_size=SEQ_BATCH),
              work / "vo_pass.log")
        torch.cuda.synchronize()
        return time.monotonic() - t1

    wall, clocks = with_clocks(one_pass)
    batch = cut.images[:SEQ_BATCH + 1].astype(np.float32) / np.float32(255.0)
    b_tgt = torch.from_numpy(batch[1:]).cuda()
    b_src = torch.from_numpy(batch[:-1])[None].cuda()
    b_K = torch.from_numpy(np.ascontiguousarray(
        cut.intrinsics[:SEQ_BATCH], np.float32)).cuda()
    with torch.no_grad():
        flow_ms = time_ms(lambda: flow.pose_flows(b_tgt, b_src),
                          iters=FLOW_TIMED, warmup=1)
        infer_ms = time_ms(lambda: ev.infer(b_tgt, b_src, b_K),
                           iters=FLOW_TIMED, warmup=1)
    say("flow", f"{card}: evaluate_vo --iterations 1 (classical flow) over "
        f"the drive's first {FLOW_VO_FRAMES} frames, {windows} windows, "
        f"batch {SEQ_BATCH}: main {main_s:.3f} s (nets and frames loaded, "
        f"cold shapes); one pass of its evaluator {wall:.3f} s -> "
        f"{windows / wall:.2f} windows/s; clocks {clocks}; a batch of "
        f"{SEQ_BATCH}: the flow pair {flow_ms:.3f} ms of {infer_ms:.3f} ms "
        f"(CUDA events over {FLOW_TIMED} calls; "
        f"{100 * flow_ms / infer_ms:.1f}%); peak memory "
        f"{peak:.1f} MiB; launches {launches['evaluate_vo']}; errors "
        + ", ".join(f"{k} {errs[k]}" for k in
                    ("errors_unscaled", "errors_dnet", "errors_gt_scaled")))

    # 5. the validation panels at iterations 1 with the flows, one value
    # launch a panel, inside profiling.trace, then the plain sampler
    ds = SfMWindowDataset([cut], seq_len=3, transform=get_transforms()["val"])
    plain = depth_and_reconstruction_panels(
        cfg, depth_net, pose_net, ds, n_samples=FLOW_PANELS,
        sampler=gs.grid_sample_plain)
    trace_dir = str(work / "trace")
    zero_counts(gs)
    t0 = time.monotonic()
    with profiling.trace(trace_dir):
        panels = depth_and_reconstruction_panels(
            cfg, depth_net, pose_net, ds, n_samples=FLOW_PANELS)
        torch.cuda.synchronize()
    traced_s = time.monotonic() - t0
    launches["panels"] = counts()
    check(launches["panels"] == (FLOW_PANELS, 0, 0, 0),
          f"the panels launched {launches['panels']}, expected "
          f"({FLOW_PANELS}, 0, 0, 0)")
    panel_gap = max(float(np.abs(panels[k] - plain[k]).max())
                    for k in panels)
    check(all(np.isfinite(v).all() for v in panels.values()),
          "a panel is not finite")
    with open(os.path.join(trace_dir, "trace.json")) as f:
        trace = json_.load(f)
    kernels = [e for e in trace.get("traceEvents", [])
               if e.get("cat") == "kernel"
               and FLOW_KERNEL in str(e.get("name"))]
    say("flow", f"panels at iterations 1 with the flows, {FLOW_PANELS} "
        f"samples: kernel vs plain sampler {panel_gap:.3e} (limit "
        f"{KERNEL_TOL}); launches {launches['panels']}; the traced call "
        f"{traced_s:.3f} s (trace written), "
        f"{os.path.getsize(os.path.join(trace_dir, 'trace.json'))} B, "
        f"{len(kernels)} {FLOW_KERNEL} events ("
        f"{sum(e.get('dur', 0) for e in kernels):.1f} us)")
    check(panel_gap <= KERNEL_TOL, f"panels kernel vs plain {panel_gap}")
    check(len(kernels) == FLOW_PANELS, f"the trace names {FLOW_KERNEL} "
          f"{len(kernels)} times, expected {FLOW_PANELS}")

    # 6. the legacy inverse_warp: kernel vs plain, one launch
    n, h, w, c = FLOW_WARP_SHAPE
    g = torch.Generator().manual_seed(5)
    img = torch.rand(FLOW_WARP_SHAPE, generator=g).cuda()
    depth = (1.0 + torch.rand((n, h, w), generator=g)).cuda()
    pose = (torch.randn((n, 6), generator=g) * 0.02).cuda()
    K = torch.tensor([[0.58 * w, 0, w / 2], [0, 1.92 * h, h / 2],
                      [0, 0, 1]]).expand(n, 3, 3).contiguous().cuda()
    zero_counts(gs)
    warped, valid = inverse_warp(img, depth, pose, K)
    torch.cuda.synchronize()
    launches["inverse_warp"] = counts()
    check(launches["inverse_warp"] == (1, 0, 0, 0),
          f"inverse_warp launched {launches['inverse_warp']}")
    ref, ref_valid = inverse_warp(img, depth, pose, K,
                                  sampler=gs.grid_sample_plain)
    warp_gap = float((warped - ref).abs().max())
    check(torch.equal(valid, ref_valid) and warp_gap <= KERNEL_TOL,
          f"inverse_warp kernel vs plain {warp_gap}")
    say("flow", f"inverse_warp on {list(FLOW_WARP_SHAPE)}: kernel vs plain "
        f"{warp_gap:.3e} (limit {KERNEL_TOL}), valid share "
        f"{valid.float().mean().item():.3f}, launches "
        f"{launches['inverse_warp']}")

    # 7. the SE(3) maps on the card against the CPU
    # rotation angles in [0, 2]: so3_log holds for theta in [0, pi)
    axis = torch.randn((FLOW_SE3_N, 3), generator=g)
    axis = axis / axis.norm(dim=1, keepdim=True)
    xi = torch.cat([torch.randn((FLOW_SE3_N, 3), generator=g),
                    axis * 2.0 * torch.rand((FLOW_SE3_N, 1), generator=g)],
                   1)
    noisy = se3.se3_exp(xi)
    noisy[:, :3, :3] += 1e-2 * torch.randn((FLOW_SE3_N, 3, 3), generator=g)
    fns = {"so3_exp": (se3.so3_exp, xi[:, 3:]), "se3_exp": (se3.se3_exp, xi),
           "so3_log": (se3.so3_log, se3.so3_exp(xi[:, 3:])),
           "se3_log": (se3.se3_log, se3.se3_exp(xi)),
           "se3_inv": (se3.se3_inv, se3.se3_exp(xi)),
           "se3_from_matrix": (se3.se3_from_matrix, noisy)}
    gaps = {k: float((fn(x.cuda()).cpu() - fn(x)).abs().max())
            for k, (fn, x) in fns.items()}
    say("flow", f"SE(3) maps on {FLOW_SE3_N} vectors, card vs CPU (limit "
        f"{CPU_TOL}): " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    check(max(gaps.values()) <= CPU_TOL, f"SE(3) card vs CPU {gaps}")
    return {k: v[0] for k, v in launches.items()}


def med_config():
    """The main path's configuration: med res, B=6, 4 iterations."""
    from tcsfm_torch.config import Config

    cfg = Config(iterations=ITERS, num_scales=1, minibatch=B,
                 img_resolution="med", compute_dtype="float32")
    check(cfg.image_size == (H, W), f"med res is {cfg.image_size}")
    return cfg


def phase_all_kernels(torch, cfg):
    """Phase "kernels": every kernel against its plain version on the card
    and timed, the samplers at the main path's own coordinates (the
    coupled forward's re-warps, the refiners' jvps, the training step's
    backward launches) and at ``smoke_coords``. Returns the forward rows by
    C (and the backward rows by name), the value+Jacobian rows by batch,
    and the f32 and bf16 tails' rows. Runs on whatever ``tcsfm_torch`` is imported, so a
    parent tree's kernels are timed the same way from its own checkout
    (README):
    ``python3 -c "import torch, chip_smoke as c;
    c.phase_all_kernels(torch, c.med_config())"``."""
    from tcsfm_torch.infer import build_models, coupled_forward
    from tcsfm_torch.ops import decoder_tail as dt
    from tcsfm_torch.ops import grid_sample as gs
    from tcsfm_torch.train.trainer import create_train_state, train_step

    warps = main_path_warps(torch, gs, cfg, build_models, coupled_forward)
    jvp_samples = refiner_jvp_samples(torch, gs, build_models)
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    rows = phase_kernels(torch, gs, warps, flush)
    rows.update(phase_bwd_kernels(torch, gs, train_step_bwd_samples(
        torch, gs, cfg, create_train_state, train_step), flush))
    grads_rows = phase_grads_kernel(torch, gs, jvp_samples, flush)
    tail_row = phase_tail_kernel(torch, dt, flush)
    # a parent tree's checkout may have no bf16 tail
    tail_bf16_row = (phase_tail_bf16_kernel(torch, dt, flush)
                     if hasattr(dt, "decoder_tail_plain_bf16") else None)
    return rows, grads_rows, tail_row, tail_bf16_row


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
    for (c, grads), n in sorted(sass_of(lib, "grid_sample_fwd_kernel")
                                .items()):
        say("build", f"SASS grid_sample_fwd_kernel<C={c or 'any'}, "
            f"derivatives={grads}>: {n['ldg']} global loads ({n['ldg128']} "
            f"of 128 bits), {n['stg']} stores ({n['stg128']} of 128 bits), "
            f"{n['calls']} calls")
        check(n["calls"] == 0, f"the forward kernel <{c}, {grads}> calls a "
              f"routine (a division?)")
        check(c not in (1, 3, 4) or (n["ldg128"] and n["stg128"]),
              f"the forward kernel <{c}, {grads}> has no 128-bit global "
              f"loads or stores")
    for (c, d_img), n in sorted(sass_of(lib, "grid_sample_bwd_kernel")
                                .items()):
        say("build", f"SASS grid_sample_bwd_kernel<C={c or 'any'}, "
            f"d_img={d_img}>: {n['ldg']} global loads ({n['ldg128']} of 128 "
            f"bits), {n['stg']} stores ({n['stg128']} of 128 bits), "
            f"{n['calls']} calls, {n['red']} global reductions")
        check(n["calls"] == 0, f"the backward kernel <{c}, {d_img}> calls a "
              f"routine (a division?)")
        check(c not in (1, 3, 4) or (n["ldg128"] and n["stg128"]),
              f"the backward kernel <{c}, {d_img}> has no 128-bit global "
              f"loads or stores")
        check(not d_img or n["red"], f"the backward kernel <{c}, {d_img}> "
              f"has no global reduction")

    say("build", f"phase took {time.monotonic() - t:.2f} s")

    cfg = med_config()
    t = time.monotonic()
    rows, grads_rows, tail_row, tail_bf16_row = phase_all_kernels(torch, cfg)
    tail_row["ptxas"] = ptxas.get("decoder_tail_kernel")
    tail_bf16_row["ptxas"] = ptxas.get("decoder_tail_bf16_kernel")
    say("kernels", f"decoder_tail_kernel, -Xptxas -v: {tail_row['ptxas']}")
    say("kernels", f"decoder_tail_bf16_kernel, -Xptxas -v: "
        f"{tail_bf16_row['ptxas']}")
    say("kernels", f"phase took {time.monotonic() - t:.2f} s")
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
    phase_train_reference(torch, Config(iterations=ITERS,
                                        compute_dtype="float32"),
                          create_train_state, train_step, forward_loss, gs)
    say("train reference", f"phase took {time.monotonic() - t:.2f} s")
    t = time.monotonic()
    dist_counts = phase_dist(torch, gs, cfg, create_train_state, train_step,
                             forward_loss)
    say("dist", f"phase took {time.monotonic() - t:.2f} s")
    t = time.monotonic()
    cli_counts = phase_train_cli(torch, gs, dt, step_counts)
    say("train_cli", f"phase took {time.monotonic() - t:.2f} s")
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
    t = time.monotonic()
    bf16_launches, bf16_paths = phase_bf16(
        torch, gs, dt, cfg, build_models, coupled_forward,
        create_train_state, train_step, forward_loss)
    say("bf16", f"phase took {time.monotonic() - t:.2f} s")
    t = time.monotonic()
    pft_counts = phase_pft(torch, gs, cfg, build_models)
    say("pft", f"phase took {time.monotonic() - t:.2f} s")
    t = time.monotonic()
    vo_counts, seq_counts = phase_sequence(torch, gs, cfg, build_models)
    say("sequence", f"phase took {time.monotonic() - t:.2f} s")
    t = time.monotonic()
    eval_counts = phase_eval(torch, gs, cfg, build_models)
    say("eval", f"phase took {time.monotonic() - t:.2f} s")
    t = time.monotonic()
    flow_counts = phase_flow(torch, gs, build_models)
    say("flow", f"phase took {time.monotonic() - t:.2f} s")

    fwd_src = "tcsfm_torch/ops/csrc/grid_sample.cu"
    bwd_src = "tcsfm_torch/ops/csrc/grid_sample_bwd.cu"
    no_refine = {k: 0 for k in refine_counts}
    # launches per forward, training step, refiner call, tail-route
    # forward, PFT call (all f32; the bf16 forward, tail-route forward and
    # step in the launches_per_bf16_* fields); then per VO pass over the
    # drive, per run_sequential_pft call by refiner, of phase "train_cli"'s two
    # training CLI calls, of phase "eval"'s runs by CLI, and of phase
    # "flow"'s paths (the value kernel only), and per distributed step
    seq_index = {"grid_sample_fwd": 0, "grid_sample_bwd_coords": 1,
                 "grid_sample_bwd_img": 2, "grid_sample_with_grads": 3}
    cli_index = dict(seq_index, decoder_tail=4)
    per_path = {
        "grid_sample_fwd": (launches, step_counts[0],
                            {k: v[0] for k, v in refine_counts.items()},
                            tail_fwd_launches, pft_counts[0]),
        "grid_sample_bwd_coords": (0, step_counts[1], no_refine, 0,
                                   pft_counts[1]),
        "grid_sample_bwd_img": (0, step_counts[2], no_refine, 0,
                                pft_counts[2]),
        "grid_sample_with_grads": (0, 0, {k: v[1] for k, v in
                                          refine_counts.items()}, 0, 0),
        "decoder_tail": (0, 0, no_refine, tail_launches, 0),
        "decoder_tail_bf16": (0, 0, no_refine, 0, 0)}
    kernels = []
    for name, source, replaces, row in (
            ("grid_sample_fwd", fwd_src, "tcsfm/ops/warp_mxu.py:470",
             dict(rows[3], c4_smoke_coords=rows[4])),
            ("grid_sample_bwd_coords", bwd_src,
             "tcsfm/ops/warp_mxu_grad.py:303", rows["grid_sample_bwd_coords"]),
            ("grid_sample_bwd_img", bwd_src,
             "tcsfm/ops/warp_mxu_grad.py:294", rows["grid_sample_bwd_img"]),
            ("grid_sample_with_grads", fwd_src, "tcsfm/ops/warp_mxu.py:526",
             dict(grads_rows[RB], chain_windows=grads_rows[BLOCK - 2])),
            ("decoder_tail", "tcsfm_torch/ops/csrc/decoder_tail.cu",
             "experiments/decoder_tail.py:200", tail_row),
            ("decoder_tail_bf16", "tcsfm_torch/ops/csrc/decoder_tail.cu",
             "experiments/decoder_tail.py:200", tail_bf16_row)):
        fwd, step, refine, tail_fwd, pft_call = per_path[name]
        k = KERNEL_NAMES.index(name)
        i = seq_index.get(name)
        vo_pass = 0 if i is None else vo_counts[i]
        seq_calls = {r: 0 if i is None else c[i]
                     for r, c in seq_counts.items()}
        train_cli = cli_counts[cli_index[name]] if name in cli_index else 0
        evals = {p: 0 if i is None else c[i] for p, c in eval_counts.items()}
        flows = {p: n if name == "grid_sample_fwd" else 0
                 for p, n in flow_counts.items()}
        dist_step = 0 if i is None or i > 2 else dist_counts[i]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=fwd + step + sum(refine.values())
                            + tail_fwd + pft_call + vo_pass
                            + sum(seq_calls.values()) + train_cli
                            + sum(evals.values()) + sum(flows.values())
                            + dist_step + bf16_launches[name],
                            launches_per_forward=fwd,
                            launches_per_train_step=step,
                            launches_per_refiner_call=refine,
                            launches_per_tail_forward=tail_fwd,
                            launches_per_pft_call=pft_call,
                            launches_per_vo_sequence=vo_pass,
                            launches_per_sequential_pft=seq_calls,
                            launches_per_train_cli=train_cli,
                            launches_per_eval=evals,
                            launches_per_flow=flows,
                            launches_per_dist_step=dist_step,
                            launches_per_bf16_forward=bf16_paths[
                                "layers_forward"][k],
                            launches_per_bf16_tail_forward=bf16_paths[
                                "tail_forward"][k],
                            launches_per_bf16_train_step=bf16_paths[
                                "train_step"][k],
                            launches_in_bf16_phase=bf16_launches[name],
                            **row))
    print(json.dumps({"kernels": kernels}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
