"""Where the coupled forward's, the training step's, a refiner's, PFT's or
the VO loop's time goes on the card.

    python -m tcsfm_torch.profile_forward [--iters 5] [--tf32]
        [--compute_dtype float32|bfloat16]
        [--tail | --train | --refiners | --pft | --vo]

Runs the main path (med res 192x640, B=6, S=2, 4 iterations, seeded
random weights, the networks in ``--compute_dtype``, float32 by default)
and prints: the forward's median wall time, the device
time of each layer (the depth net split into its full-resolution tail --
iconv4, the feature conv and the head, on 18 images at 192x640 -- and the
rest of it, the pose net, the sampler kernel, the rest) from CUDA events,
and, from ``torch.profiler``, the device-busy share of the profiled window
and the top device kernels. ``--tail`` runs the depth net through
``make_tail_apply``, its tail the fused kernel, where the default route
runs the net's own cuDNN layers. ``--tf32`` lets cuDNN convolutions run in
TF32 (PyTorch's default); without it they run in full f32, as
``chip_smoke.py`` runs them.

``--train`` splits the training step at the same shape instead: the whole
step's median device time, and the device time of each piece run alone at
the step's shapes (CUDA events): the depth net forward+backward on the
3B images (train-mode BatchNorm), the pose net's 4 forward+backward passes
on the 2SB pairs, the solver's sampler kernels (3 forward, 3 d_coords-only
backward), the loss stack forward+backward with its own warp (1 forward,
1 d_img backward), the optimizer update, and the rest (the step minus the
pieces: the solver's and the warps' glue, the backward of the packing);
then the profiler's top kernels of the step.

``--pft`` splits one PFT call at bench.py's setting (encoder mode, 20
epochs, window batch 4, S=2, 4 iterations, 192x640, the networks in
``--compute_dtype``), on the inputs
of ``chip_smoke.py``'s phase "pft" (its seeded weights with trained-like
conditioning, its smooth uint8-grid window batch; run from the
repository root): the call's median device time (CUDA events) and ms per
window; one updated step (forward, backward, flip-merge, update); and
the device time of each piece of a step run alone at its shapes: the
depth net forward+backward on the (S+1)B images (eval-mode BatchNorm,
the encoder trainable), the coupled solver with its error products
forward+backward (4 pose-net passes, 4 warps, 3 d_coords-only and 1 d_img
backward), the sampler kernels alone at those shapes, the PFT loss
forward+backward, the Adam update, and the two flip-merge depth
forwards; then the profiler's top kernels of one step.

``--refiners`` splits one Levenberg-Marquardt iteration of ``window_ba``
at the refiners' window batch (4 windows at 192x640, f32, TF32 off): the
iteration's time on the card's timeline is that of ``window_ba(iters=10)``
less that of ``window_ba(iters=0)``, over 10 (CUDA events); its kernel
time the same difference from the profiler, by kind of kernel: the
sampler kernels (4 value and 14 value+Jacobian launches an iteration),
the matmuls (the einsum reductions and the geometry's 3x3 products), the
LU solves, and the rest (elementwise, copies, reductions); the share of
the timeline that kernels fill; then the profiler's top kernels of one
``window_ba(iters=10)`` call.

``--vo`` splits ``evaluate_vo``'s loop (``eval.vo.VOEvaluator``, batch 8
pair windows at 192x640, 4 iterations, f32) on the first 65 frames of
the committed drive (``.flagship_data/drive1504_192x640``; run from the
repository root): the host's time to assemble a batch (the loader alone,
no card), the wall time per batch of ``run_sequence`` and the share of it
the card's kernels fill (the profiler), and the device time of each piece
of one batch run alone (CUDA events): the depth net on 16 images, the
coupled solver (4 pose-net passes, 3 warps), the per-sample DNet scale.
Needs the card.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tcsfm_torch.config import Config, PFTOptions
from tcsfm_torch.infer import build_models, coupled_forward
from tcsfm_torch.losses.photometric import compute_losses
from tcsfm_torch.models.depth import make_tail_apply, tail_weights
from tcsfm_torch.ops.decoder_tail import decoder_tail
from tcsfm_torch.ops.grid_sample import grid_sample, grid_sample_bwd
from tcsfm_torch.train.trainer import create_train_state, train_step
from tcsfm_torch.solver.coupled import solve_disp, solve_pose_iteratively
from tcsfm_torch.solver.pft import PFTOptimizer, compute_optimization_loss
from tcsfm_torch.utils.helpers import disp_to_depth


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _median_event_ms(fn, iters: int) -> float:
    """Median device ms of ``fn()`` over ``iters`` runs after one warm-up,
    with CUDA events around each run."""
    fn()
    pairs = []
    for _ in range(iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(z) for a, z in pairs)


def _top_kernels(run, iters: int, what: str) -> None:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    if busy_us == 0.0:
        print("the profiler recorded no device time: busy share not measured")
        return
    print(f"profiled {iters} {what}s: wall {wall_us / iters / 1e3:.3f}"
          f" ms/{what}, kernel time {busy_us / iters / 1e3:.3f} "
          f"ms/{what} = {busy_us / wall_us:.1%} of wall")
    if busy_us > wall_us:
        print("kernels overlapped (their sum exceeds the wall time): device "
              "busy share not measured")
    print(f"top device kernels (ms/{what}, calls/{what}):")
    for e in sorted(kernels, key=_device_us, reverse=True)[:15]:
        print(f"  {_device_us(e) / iters / 1e3:8.3f} "
              f"{e.count // iters:4d}  {e.key[:110]}")


def train_split(args) -> None:
    """The training step's device time, whole and by piece."""
    cfg = Config(iterations=4, minibatch=6, compute_dtype=args.compute_dtype)
    h, w = cfg.image_size
    b, s = cfg.minibatch, cfg.num_source_imgs
    n = 2 * s * b
    state = create_train_state(cfg)
    rng = np.random.RandomState(0)

    def rand(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda()

    K = torch.tensor([[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2.5], [0, 0, 1]],
                     device="cuda").expand(b, 3, 3).contiguous()
    tgt, src = rand(b, h, w, 3), rand(s, b, h, w, 3)
    batch = {"target_img": tgt, "target_img_aug": tgt, "source_imgs": src,
             "source_imgs_aug": src, "intrinsics_aug": K}
    step_ms = _median_event_ms(lambda: train_step(state, batch), args.iters)

    imgs, pairs = rand((s + 1) * b, h, w, 3), rand(n, h, w, 6)

    def depth():
        state.depth_net.train()
        out = state.depth_net(imgs)[0]
        out.backward(torch.ones_like(out))

    def pose():
        for _ in range(cfg.iterations):
            state.pose_net(pairs).sum().backward()

    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    ident = np.stack([(2 * xs + 1) / w - 1, (2 * ys + 1) / h - 1], -1)
    coords = torch.from_numpy((ident + rng.uniform(-0.01, 0.01, (n, h, w, 2)))
                              .astype(np.float32)).cuda()
    img3, g3 = rand(n, h, w, 3), rand(n, h, w, 3)

    def sampler():
        for _ in range(cfg.iterations - 1):
            grid_sample(img3, coords)
        for _ in range(cfg.iterations - 1):
            grid_sample_bwd(img3, coords, g3)

    disps = [[(0.05 + 0.1 * rand(b, h, w, 1)).to(cfg.dtype)
              .requires_grad_(True)] for _ in range(s + 1)]
    poses = (0.01 * rand(s, b, 6)).requires_grad_(True)

    def loss():
        out = compute_losses(cfg, src, tgt, poses, -poses, disps, K)
        out["total"].backward()

    parts = {"depth net fwd+bwd": depth, "pose net x4 fwd+bwd": pose,
             "sampler, solver (3 fwd, 3 bwd)": sampler,
             "loss fwd+bwd (1 fwd, 1 d_img bwd)": loss,
             "optimizer": state.optimizer.step}
    times = {k: _median_event_ms(fn, args.iters) for k, fn in parts.items()}
    print(f"{torch.cuda.get_device_name(0)}; {cfg.compute_dtype} networks; "
          f"TF32 convs {args.tf32}; train "
          f"step {h}x{w} B={b} S={s} iters={cfg.iterations}: median device "
          f"{step_ms:.3f} ms over {args.iters} -> {b / step_ms * 1e3:.2f} "
          f"frames/s")
    print("device ms of each piece run alone at the step's shapes:")
    for k, t in times.items():
        print(f"  {k:<36} {t:9.3f}  {t / step_ms:6.1%}")
    rest = step_ms - sum(times.values())
    print(f"  {'rest (step - pieces)':<36} {rest:9.3f}  {rest / step_ms:6.1%}")
    _top_kernels(lambda: train_step(state, batch), args.iters, "step")


def pft_split(args) -> None:
    """One PFT call's device time, whole, by step and by piece."""
    import chip_smoke as cs

    cfg = cs.med_config().replace(compute_dtype=args.compute_dtype)
    h, w = cfg.image_size
    b, s, epochs = cs.PFT_B, cfg.num_source_imgs, cs.PFT_EPOCHS
    n = 2 * s * b
    depth_net, pose_net = build_models(
        cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    cs.condition_like_trained(depth_net, torch)
    batch = cs.pft_batch(torch, b, h, w, seed=7, device="cuda")
    K = batch["intrinsics"]
    rng = np.random.RandomState(0)

    def rand(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda()

    opt = PFTOptimizer(cfg, PFTOptions(epochs=epochs, num_source_imgs=s),
                       depth_net, pose_net, mode="encoder")
    call_ms = _median_event_ms(lambda: opt.optimize_window(batch), args.iters)

    win = opt._prepare(batch, torch.device("cuda"))
    params = list(win.trainable.values())
    tx = opt._make_optimizer(params)

    def step():
        loss, _ = opt._forward(win, grid_sample)
        for p, g in zip(params, opt._gradients(loss, params)):
            p.grad = g
        opt._flip_merged_disp(win.depth_net, win.target_img)
        tx.step()

    step_ms = _median_event_ms(step, args.iters)

    def depth():
        out = win.depth_net(win.imgs)[0]
        torch.autograd.grad(out, params, torch.ones_like(out))

    with torch.no_grad():
        disps = win.depth_net(win.imgs)[0]
    depths = disp_to_depth(disps, cfg.min_depth, cfg.max_depth)[1].reshape(
        s + 1, b, h, w, 1)

    def solver():
        d = depths.detach().requires_grad_(True)
        _, _, out = solve_pose_iteratively(
            cfg.iterations, d, win.pose_net, win.target_img, win.source_imgs,
            K, return_errors=True)
        (out["fwd"].diff_img.sum() + out["fwd"].weight_mask.sum()
         + out["inv"].diff_img.sum()).backward()

    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    ident = np.stack([(2 * xs + 1) / w - 1, (2 * ys + 1) / h - 1], -1)
    coords = torch.from_numpy((ident + rng.uniform(-0.01, 0.01, (n, h, w, 2)))
                              .astype(np.float32)).cuda()
    img3, img4, g3, g4 = (rand(n, h, w, c) for c in (3, 4, 3, 4))

    def sampler():
        for _ in range(cfg.iterations - 1):
            grid_sample(img3, coords)
            grid_sample_bwd(img3, coords, g3)
        grid_sample(img4, coords)
        grid_sample_bwd(img4, coords, g4, (3,))

    with torch.no_grad():
        _, _, out = solve_pose_iteratively(
            cfg.iterations, depths, win.pose_net, win.target_img,
            win.source_imgs, K, return_errors=True)

    def loss():
        fwd = out["fwd"]._replace(
            diff_img=out["fwd"].diff_img.clone().requires_grad_(True),
            weight_mask=out["fwd"].weight_mask.clone().requires_grad_(True))
        target = disps[:b].clone().requires_grad_(True)
        compute_optimization_loss(opt.opts, win.target_img, target,
                                  disps[:b], fwd, out["inv"]).backward()

    parts = {"depth net fwd+bwd": depth,
             "solver with errors fwd+bwd": solver,
             "  of which sampler kernels": sampler,
             "PFT loss fwd+bwd": loss, "optimizer (Adam)": tx.step,
             "flip-merge (2 depth fwds)":
                 lambda: opt._flip_merged_disp(win.depth_net, win.target_img)}
    times = {k: _median_event_ms(fn, args.iters) for k, fn in parts.items()}
    print(f"{torch.cuda.get_device_name(0)}; TF32 convs {args.tf32}; PFT "
          f"encoder {h}x{w} window batch {b} S={s} iters={cfg.iterations} "
          f"epochs={epochs}: median device {call_ms:.3f} ms a call over "
          f"{args.iters} -> {call_ms / b:.3f} ms per window, "
          f"{b / call_ms * 1e3:.3f} windows/s; one updated step with its "
          f"flip-merge {step_ms:.3f} ms")
    print("device ms of each piece run alone at a step's shapes:")
    for k, t in times.items():
        print(f"  {k:<36} {t:9.3f}  {t / step_ms:6.1%}")
    rest = step_ms - sum(t for k, t in times.items() if not k.startswith(" "))
    print(f"  {'rest (step - pieces)':<36} {rest:9.3f}  {rest / step_ms:6.1%}")
    _top_kernels(step, args.iters, "step")


_REFINER_KINDS = (  # kernel-name patterns of the pieces of an LM iteration
    ("sampler kernels (value, value+Jacobian)", ("grid_sample",)),
    ("matmuls: einsum reductions, 3x3 geometry", ("gemm", "gemv", "Gemv")),
    ("solves (LU)", ("getr", "trsm", "laswp", "lu_", "pivot")),
)


def _kernel_ms_by_kind(run) -> dict:
    """Device ms of one ``run()`` by kind of kernel, from the profiler."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {k: 0.0 for k, _ in _REFINER_KINDS}
    out["rest: elementwise, copies, reductions"] = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = next((k for k, pats in _REFINER_KINDS
                     if any(p in e.key for p in pats)),
                    "rest: elementwise, copies, reductions")
        out[kind] += _device_us(e) / 1e3
    return out


def refiners_split(args) -> None:
    """One LM iteration of window_ba: its time on the card's timeline, and
    its kernel time by kind."""
    import torch.nn.functional as F

    from tcsfm_torch.solver.ba import window_ba

    torch.backends.cuda.matmul.allow_tf32 = False
    b, (h, w) = 4, Config().image_size
    rng = np.random.RandomState(0)

    def smooth(n):
        lo = torch.from_numpy(rng.rand(n, 3, 9, 13).astype(np.float32))
        up = F.interpolate(lo, size=(h, w), mode="bilinear",
                           align_corners=True)
        return up.permute(0, 2, 3, 1).contiguous().cuda()

    tgt, prv, nxt = smooth(b), smooth(b), smooth(b)
    depth = torch.from_numpy((2.0 + 3.0 * rng.rand(b, h, w, 1))
                             .astype(np.float32)).cuda()
    pa, pb = (torch.from_numpy((0.01 * rng.randn(b, 6)).astype(np.float32))
              .cuda() for _ in range(2))
    K = torch.tensor([[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2.5], [0, 0, 1]],
                     device="cuda").expand(b, 3, 3).contiguous()

    def call(iters):
        return lambda: window_ba(pa, pb, depth, tgt, prv, nxt, depth, depth,
                                 K, iters=iters, depth_prior_weight=0.1)

    ten, zero = (_median_event_ms(call(n), args.iters) for n in (10, 0))
    iteration = (ten - zero) / 10
    kinds = {k: (a - z) / 10 for (k, a), z in zip(
        _kernel_ms_by_kind(call(10)).items(),
        _kernel_ms_by_kind(call(0)).values())}
    busy = sum(kinds.values())
    print(f"{torch.cuda.get_device_name(0)}; window_ba {b}x{h}x{w}, TF32 "
          f"off: iters=10 {ten:.3f} ms, iters=0 {zero:.3f} ms (first cost, "
          f"final blocks), CUDA events -> one LM iteration {iteration:.3f} ms "
          f"on the card's timeline; {ten / b:.3f} ms per window for the call")
    print(f"kernel time of one LM iteration by kind (profiler, iters=10 less "
          f"iters=0, over 10): {busy:.3f} ms = {busy / iteration:.1%} of the "
          f"timeline (the rest of it the card waits for the host)")
    for k, t in kinds.items():
        print(f"  {k:<44} {t:9.3f}  {t / busy:6.1%}")
    _top_kernels(call(10), 1, "window_ba call")


def vo_split(args) -> None:
    from tcsfm_torch.data.dataset import SequenceData, SfMWindowDataset
    from tcsfm_torch.data.loader import BatchLoader
    from tcsfm_torch.data.transforms import WindowTransform
    from tcsfm_torch.eval.scale_recovery import scale_recovery_per_sample
    from tcsfm_torch.eval.vo import METRIC_SCALE, VOEvaluator
    from tcsfm_torch.utils.helpers import to_device

    frames, batch = 65, 8
    cfg = Config(iterations=4, compute_dtype=args.compute_dtype)
    drive = SequenceData.from_npz(
        ".flagship_data/drive1504_192x640/synthetic/sequence_data.npz")
    seq = SequenceData(name="cut", intrinsics=drive.intrinsics[:frames],
                       gt_poses=drive.gt_poses[:frames],
                       vo_poses=drive.vo_poses[:frames],
                       timestamps=drive.timestamps[:frames],
                       images=drive.images[:frames])
    del drive
    depth_net, pose_net = build_models(cfg)
    ev = VOEvaluator(cfg, depth_net, pose_net)
    ds = SfMWindowDataset([seq], seq_len=2, transform=WindowTransform(
        jitter=False, flip_prob=None))
    t = time.perf_counter()
    batches = list(BatchLoader(ds, batch, shuffle=False, drop_last=False,
                               prefetch=0))
    host_ms = (time.perf_counter() - t) * 1e3 / len(batches)
    ev.run_sequence(seq, batch, verbose=False)               # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    ev.run_sequence(seq, batch, verbose=False)
    wall_ms = (time.perf_counter() - t) * 1e3 / len(batches)
    print(f"{torch.cuda.get_device_name(0)}; evaluate_vo loop, {frames - 1} "
          f"windows in {len(batches)} batches of {batch} at "
          f"{cfg.image_size[0]}x{cfg.image_size[1]}, {cfg.iterations} "
          f"iterations: {wall_ms:.3f} ms wall a batch; the loader alone "
          f"{host_ms:.3f} ms a batch (host)")

    x = to_device(batches[0], ("target_img", "source_imgs", "intrinsics"),
                  torch.device("cuda"))
    tgt, src, K = x["target_img"], x["source_imgs"], x["intrinsics"]
    imgs = torch.cat([tgt, src[0]])
    with torch.no_grad():
        depth = disp_to_depth(depth_net(imgs)[0], cfg.min_depth,
                              cfg.max_depth)[1]
        depths = depth.reshape((2, batch) + depth.shape[1:])
        pieces = {
            "depth net": lambda: depth_net(imgs),
            "coupled solver": lambda: solve_pose_iteratively(
                cfg.iterations, depths, pose_net, tgt, src, K),
            "DNet scale": lambda: scale_recovery_per_sample(
                METRIC_SCALE * depths[0], K, cfg.camera_height),
            "whole batch": lambda: ev.infer(tgt, src, K),
        }
        for name, fn in pieces.items():
            print(f"  {name:<15} {_median_event_ms(fn, args.iters):9.3f} "
                  f"ms device (CUDA events, median of {args.iters})")
    _top_kernels(lambda: ev.run_sequence(seq, batch, verbose=False), 1,
                 "pass")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--compute_dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="the networks' compute dtype")
    ap.add_argument("--tail", action="store_true",
                    help="the depth net through the fused decoder tail")
    ap.add_argument("--train", action="store_true",
                    help="split the training step instead of the forward")
    ap.add_argument("--refiners", action="store_true",
                    help="split one LM iteration of window_ba instead")
    ap.add_argument("--pft", action="store_true",
                    help="split one PFT call (encoder mode) instead")
    ap.add_argument("--vo", action="store_true",
                    help="split evaluate_vo's loop instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = args.tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.train:
        train_split(args)
        return
    if args.refiners:
        refiners_split(args)
        return
    if args.pft:
        pft_split(args)
        return
    if args.vo:
        vo_split(args)
        return

    cfg = Config(iterations=4, minibatch=6, compute_dtype=args.compute_dtype)
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
    spans = {"depth rest": [], "depth tail": [], "pose_net": [], "sampler": []}

    def timed(name, fn):
        def wrapper(*a, **k):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            start.record()
            out = fn(*a, **k)
            end.record()
            spans[name].append((start, end))
            return out
        return wrapper

    weights = tail_weights(depth_net)

    def layers_tail(z):
        # the default route's layers after the last upconv's conv
        x = depth_net.iconvs[-1](torch.nn.functional.elu(z))
        x = depth_net.predict_disps[0](depth_net.feature_convs[0](x))
        return x.permute(0, 2, 3, 1)

    trunk = timed("depth rest", lambda imgs: depth_net.decode_tail_input(
        depth_net.encode(imgs)))
    tail = timed("depth tail", (lambda z: decoder_tail(z, *weights))
                 if args.tail else layers_tail)

    def depth_apply(imgs):
        return [tail(trunk(imgs))]

    pose_apply = timed("pose_net", pose_net)
    sampler = timed("sampler", grid_sample)
    route = make_tail_apply(depth_net) if args.tail else None

    def run(instrumented=False):
        if not instrumented:
            return coupled_forward(depth_net, pose_net, tgt, src, K, cfg,
                                   depth_apply=route)
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
    print(f"{torch.cuda.get_device_name(0)}; {cfg.compute_dtype} networks; "
          f"TF32 convs {args.tf32}; depth net tail {'fused kernel' if args.tail else 'cuDNN layers'}; "
          f"forward median {med * 1e3:.3f} ms over {len(times)} -> "
          f"{b / med:.2f} frames/s")

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

    _top_kernels(run, args.iters, "forward")


if __name__ == "__main__":
    main()
