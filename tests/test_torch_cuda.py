"""The port's CUDA kernels against their plain versions, and the training
step and the refiners through them, on the card.

Marked ``cuda``: each test asks the ``cuda`` fixture, which skips where
there is no card. This file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: forward atol 1e-5, value+Jacobian gx/gy 1e-6 of their
largest magnitude (each kernel repeats its plain version's f32 arithmetic
in the same order; the forward kernels have measured bit-equal on an
H100); backward d_coords bit-equal (``torch.equal``); d_img 1e-5 (atomics
add in an order that changes from run to run); a refiner with the kernels
vs the plain sampler: poses 1e-5, costs 1e-6 relative (the jvps' products
run in another order); the
decoder tail kernel vs its plain version (cuDNN convolutions, TF32 off)
atol 1e-5 on the sigmoid output (the sums run in another order), its
gradient (the plain version's autodiff either way) 1e-6 of the largest;
the bf16 tail kernel vs ``decoder_tail_plain_bf16`` within
``chip_smoke.TAIL_BF16_TOL`` (bf16 rounding flips).
The evaluation CLIs: scaled disparities within 1e-5 (the plain sampler's
run) and 1e-4 (the CPU's) of their range, 1/min_depth - 1/max_depth;
ScanNet's fused pose vectors within 1e-5 and 1e-4; the warm-start gate's
PFT t-ATE within the CPU's own one-ulp spread (its test's docstring).
Classical flow: the Farneback pair and the classical VO's pose vectors
and DNet scales card vs CPU within ``chip_smoke``'s limits of the CPU
run's own spread with its images one ulp up; the legacy ``inverse_warp``
kernel vs plain atol 1e-5.
"""

import numpy as np
import pytest
import torch

from tcsfm_torch.config import Config
from tcsfm_torch.infer import build_models, coupled_forward
from tcsfm_torch.models.depth import make_tail_apply
from tcsfm_torch.ops import decoder_tail as dt
from tcsfm_torch.ops import grid_sample as gs
from tcsfm_torch.train.trainer import (create_train_state, forward_loss,
                                       train_step)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _inputs(shape, seed, device):
    rng = np.random.RandomState(seed)
    b, h, w, c = shape
    img = rng.rand(b, h, w, c).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (b, h, w, 2)).astype(np.float32)
    coords[rng.rand(b, h, w) < 0.05] = 2.0          # the pushed-OOB rule
    return (torch.from_numpy(img).to(device),
            torch.from_numpy(coords).to(device))


# the forward kernels' shapes: runs of a row cut short (W < 128, W % 128),
# W % 4 in {1, 2, 3} (rows whose runs do not fall on 16 bytes), B = 1, C
# without a vector path (7), and the main path's
SAMPLER_SHAPES = [(2, 31, 45, 1), (2, 32, 64, 3), (3, 17, 23, 4),
                  (1, 8, 9, 7), (2, 20, 257, 3), (2, 19, 258, 1),
                  (1, 11, 259, 4), (1, 9, 387, 3), (24, 192, 640, 3),
                  (24, 192, 640, 4)]


def _offset(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a contiguous tensor one float into its storage
    (its data 4 bytes past a 16-byte boundary)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.fixture(scope="module")
def main_path_warps():
    """The coupled forward's (image, coords) re-warps at [24,192,640,3]
    (``chip_smoke.main_path_warps``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import chip_smoke

    cfg = Config(compute_dtype="float32",
                 iterations=chip_smoke.ITERS, num_scales=1,
                 minibatch=chip_smoke.B, img_resolution="med")
    return chip_smoke.main_path_warps(torch, gs, cfg, build_models,
                                      coupled_forward)


def _sample_inputs(case, shape, seed, warps, device):
    if case == "main_path":
        return warps[0]
    img, coords = _inputs(shape, seed, device)
    return (img, _offset(coords)) if case == "offset" else (img, coords)


SAMPLER_CASES = ([("random", s) for s in SAMPLER_SHAPES]
                 + [("offset", (2, 20, 257, 3)), ("offset", (2, 8, 256, 4)),
                    ("main_path", (24, 192, 640, 3))])


@pytest.mark.parametrize("case,shape", SAMPLER_CASES)
def test_kernel_matches_plain(cuda, case, shape, request):
    warps = (request.getfixturevalue("main_path_warps")
             if case == "main_path" else None)
    img, coords = _sample_inputs(case, shape, 0, warps, cuda)
    before = gs.LAUNCHES
    out = gs.grid_sample(img, coords)
    torch.cuda.synchronize()
    assert gs.LAUNCHES == before + 1
    ref = gs.grid_sample_plain(img, coords)
    assert out.shape == img.shape
    err = (out - ref).abs().max().item()
    print(f"grid_sample {case} {tuple(img.shape)}: max|kernel-plain| {err}")
    assert err <= 1e-5


@pytest.fixture(scope="module")
def train_step_bwd_samples():
    """The backward launches of one training step in chip_smoke.py's phase
    "train" setting (``chip_smoke.train_step_bwd_samples``): the solver's
    three d_coords-only launches at [24,192,640,3], and the loss warp's
    d_img launch at [24,192,640,4] with the depth terms on and under the
    defaults."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import chip_smoke

    cfg = Config(compute_dtype="float32",
                 iterations=chip_smoke.ITERS, num_scales=1,
                 minibatch=chip_smoke.B, img_resolution="med")
    return chip_smoke.train_step_bwd_samples(torch, gs, cfg,
                                             create_train_state, train_step)


def _smooth_coords(shape, seed, device):
    """Near-identity coords: a shift of up to 2 px and 0.5 px of jitter."""
    rng = np.random.RandomState(seed)
    b, h, w, _ = shape
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    c = np.stack([(2 * xs + 1) / w - 1, (2 * ys + 1) / h - 1], -1)[None]
    px = np.array([2.0 / w, 2.0 / h])
    c = (c + rng.uniform(-2, 2, (b, 1, 1, 2)) * px
         + rng.uniform(-0.5, 0.5, (b, h, w, 2)) * px)
    return torch.from_numpy(c.astype(np.float32)).to(device)


def _bwd_launches(case, shape, grad_ch, device, request):
    """The (img, coords, g, grad_ch) launches of one case."""
    if case == "train_step":
        return request.getfixturevalue("train_step_bwd_samples")[shape]
    img, coords = _inputs(shape, 3, device)
    if case in ("smooth", "pushed"):
        coords = _smooth_coords(shape, 5, device)
    if case == "pushed":            # whole tiles and single pixels at 2.0
        coords[0, :16] = 2.0
        coords[torch.rand(shape[:3], generator=torch.Generator().manual_seed(
            6)).to(device) < 0.1] = 2.0
    if case == "offset":            # every run misaligned: the scalar path
        coords = _offset(coords)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(4)).to(
        device)
    return [(img, coords, g, grad_ch)]


# the backward kernels' cases: coords uniform in +-1.2 (taps scattered
# over the image), smooth coords (neighbouring pixels' taps shared), pushed
# coords (whole runs without an in-image tap), a coords view one float into
# its storage (the scalar path), C = 3 and 4, and the training step's own
# launches
BWD_CASES = [
    *(("random", s, gc) for s in ((2, 31, 45, 4), (3, 17, 23, 4),
                                  (24, 192, 640, 4))
      for gc in ((), (3,), (0, 1, 2, 3))),
    *(("smooth", (2, 33, 130, 4), gc) for gc in ((), (3,), (0, 1, 2, 3))),
    ("pushed", (2, 40, 130, 4), (3,)), ("offset", (2, 20, 257, 4), (3,)),
    ("offset", (2, 8, 256, 3), ()), ("offset", (2, 8, 256, 3), (0, 2)),
    ("train_step", "coords", ()), ("train_step", "img", (3,)),
    ("train_step", "img defaults", (3,))]


@pytest.mark.parametrize("case,shape,grad_ch", BWD_CASES)
def test_bwd_kernel_matches_plain(cuda, case, shape, grad_ch, request):
    """d_coords bit-equal to the plain version (the same f32 operations in
    the same order), d_img within 1e-5 (atomics sum in another order)."""
    for img, coords, g, grad_ch in _bwd_launches(case, shape, grad_ch, cuda,
                                                 request):
        counters = (gs.LAUNCHES_BWD_COORDS, gs.LAUNCHES_BWD_IMG)
        d_coords, d_img = gs.grid_sample_bwd(img, coords, g, grad_ch)
        torch.cuda.synchronize()
        launched = (gs.LAUNCHES_BWD_COORDS - counters[0],
                    gs.LAUNCHES_BWD_IMG - counters[1])
        assert launched == ((0, 1) if grad_ch else (1, 0))
        ref_coords, ref_img = gs.grid_sample_bwd_plain(img, coords, g,
                                                       grad_ch)
        assert torch.equal(d_coords, ref_coords)
        if not grad_ch:
            assert d_img is None
            continue
        assert d_img.shape == img.shape[:3] + (len(grad_ch),)
        err = (d_img - ref_img).abs().max().item()
        print(f"grid_sample_bwd {case} {tuple(img.shape)} {grad_ch}: "
              f"max|d_img-plain| {err}")
        assert err <= 1e-5


@pytest.mark.parametrize("grad_ch", [(), (3,)])
def test_bwd_kernel_under_vmap(cuda, grad_ch):
    """``_GridSampleBwd`` under ``torch.func.vmap`` folds the vmapped
    dimension into B: one launch, the plain version's results."""
    v, b, h, w, c = 3, 2, 16, 70, 4
    img, coords = _inputs((v * b, h, w, c), 9, cuda)
    g = torch.randn(v * b, h, w, c, generator=torch.Generator()
                    .manual_seed(10)).to(cuda)
    before = gs.LAUNCHES_BWD_COORDS + gs.LAUNCHES_BWD_IMG
    outs = torch.func.vmap(lambda i, co, gg: gs._GridSampleBwd.apply(
        i, co, gg, grad_ch))(img.view(v, b, h, w, c),
                             coords.view(v, b, h, w, 2),
                             g.view(v, b, h, w, c))
    torch.cuda.synchronize()
    assert gs.LAUNCHES_BWD_COORDS + gs.LAUNCHES_BWD_IMG == before + 1
    ref = gs.grid_sample_bwd_plain(img, coords, g, grad_ch)
    assert torch.equal(outs[0].reshape(v * b, h, w, 2), ref[0])
    if grad_ch:
        assert (outs[1].reshape(v * b, h, w, 1) - ref[1]).abs().max() <= 1e-5


def test_autograd_picks_the_kernel(cuda):
    """Only coords need a gradient: the d_coords kernel; a differentiable
    tail behind a data image: the d_img kernel for the tail alone."""
    img, coords = _inputs((2, 16, 24, 4), 5, cuda)
    rgb, depth = img[..., :3].contiguous(), img[..., 3:].contiguous()
    coords.requires_grad_(True)
    before = (gs.LAUNCHES, gs.LAUNCHES_BWD_COORDS, gs.LAUNCHES_BWD_IMG)
    gs.grid_sample(rgb, coords).sum().backward()
    assert (gs.LAUNCHES, gs.LAUNCHES_BWD_COORDS, gs.LAUNCHES_BWD_IMG) == (
        before[0] + 1, before[1] + 1, before[2])
    depth.requires_grad_(True)
    out = gs.grid_sample(rgb, coords, depth)
    out.backward(torch.ones_like(out))
    assert (gs.LAUNCHES_BWD_COORDS, gs.LAUNCHES_BWD_IMG) == (
        before[1] + 1, before[2] + 1)
    assert rgb.grad is None and depth.grad.abs().max().item() > 0
    ref = gs.grid_sample_bwd_plain(img, coords.detach(),
                                   torch.ones_like(img), (3,))[1]
    assert (depth.grad - ref).abs().max().item() <= 1e-5


def test_train_step_on_card(cuda):
    """One step with the kernels and one with the plain sampler from the
    same state (chip_smoke.py's seeded, trained-like conditioning, with the
    depth terms on, ``remat_coupled`` on as by default): 6 forward (4 and
    the two iteration bodies' warps recomputed in the backward), 3
    d_coords and 1 d_img launches (``chip_smoke.step_launches``); the same
    losses (the forward kernel is bit-equal to its plain version) and
    gradients within 1e-4 relative L2, the compared steps with cuDNN's
    deterministic algorithms, a tensor whose plain step does not reproduce
    itself to 2.5e-5 (rerun with its loss scaled one ulp off 1) held at 4
    times that spread, at most 1e-3, and at most 20 tensors so widened
    (``chip_smoke.step_grad_parity``)."""
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state, batch = chip_smoke.card_test_setting(torch, create_train_state)
    before = (gs.LAUNCHES, gs.LAUNCHES_BWD_COORDS, gs.LAUNCHES_BWD_IMG)
    losses, *_ = chip_smoke.step_grad_parity(
        torch, gs, train_step, forward_loss, state, batch,
        "kernel vs plain sampler step")
    assert state.cfg.remat_coupled
    assert (gs.LAUNCHES - before[0], gs.LAUNCHES_BWD_COORDS - before[1],
            gs.LAUNCHES_BWD_IMG - before[2]) == chip_smoke.step_launches(
                chip_smoke.ITERS, remat=True) == (6, 3, 1)
    assert all(torch.isfinite(v) for v in losses.values())


def test_distributed_step_at_world_size_one(cuda):
    """The data-parallel step (``train_step(..., mesh=...)``) in a one-rank
    NCCL group on ``cuda:0`` against the plain step from the same state
    (``card_test_setting``): the same launches, losses within 1e-6 and
    gradients within the step's rounding limits
    (``chip_smoke.step_grad_parity``), the BatchNorm statistics within
    1e-6; the group is destroyed after."""
    import copy
    import functools

    import torch.distributed as dist

    import chip_smoke
    from tcsfm_torch.dist import mesh as dm

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state, batch = chip_smoke.card_test_setting(torch, create_train_state)
    dm.init_group(0, 1, f"127.0.0.1:{dm.free_port()}")
    try:
        mesh = dm.make_mesh(1)
        assert dist.get_backend() == "nccl"
        assert mesh.device == torch.device("cuda", 0)
        dist_step = functools.partial(train_step, mesh=mesh)
        before = (gs.LAUNCHES, gs.LAUNCHES_BWD_COORDS, gs.LAUNCHES_BWD_IMG)
        losses, *_ = chip_smoke.step_grad_parity(
            torch, gs, train_step, forward_loss, state, batch,
            "distributed vs plain step", ours_step=dist_step)
        assert (gs.LAUNCHES - before[0], gs.LAUNCHES_BWD_COORDS - before[1],
                gs.LAUNCHES_BWD_IMG - before[2]) == chip_smoke.step_launches(
                    chip_smoke.ITERS, remat=True)
        assert all(torch.isfinite(v) for v in losses.values())
        with chip_smoke.cudnn_deterministic(torch):
            ours, plain = copy.deepcopy(state), copy.deepcopy(state)
            dist_step(ours, batch)
            train_step(plain, batch)
        ref = plain.depth_net.state_dict()
        for k, v in ours.depth_net.state_dict().items():
            if "running" in k:
                assert (v - ref[k]).abs().max().item() <= 1e-6, k
    finally:
        dist.destroy_process_group()


class _ScaledBackward(torch.autograd.Function):
    """The identity forward; its backward scales the gradient by 1 + 1e-3."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * (1 + 1e-3)


def test_step_grad_check_fails_on_a_planted_fault(cuda):
    """The check of ``test_train_step_on_card`` on a sampler whose d_coords
    is the kernel's scaled by 1 + 1e-3: it fails on the gradients."""
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state, batch = chip_smoke.card_test_setting(torch, create_train_state)

    def faulty(img, coords, tail=None):
        return gs.grid_sample(img, _ScaledBackward.apply(coords), tail)

    with pytest.raises(AssertionError, match="gradient relative L2"):
        chip_smoke.step_grad_parity(torch, gs, train_step, forward_loss,
                                    state, batch, "planted fault",
                                    sampler=faulty)


def test_coupled_forward_on_card(cuda):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config(compute_dtype="float32", iterations=4)
    depth_net, pose_net = build_models(cfg,
                                       generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(2)
    tgt = rng.rand(2, 64, 96, 3).astype(np.float32)
    src = rng.rand(2, 2, 64, 96, 3).astype(np.float32)
    K = np.broadcast_to(np.array([[57.6, 0, 48], [0, 57.6, 25.6], [0, 0, 1]],
                                 np.float32), (2, 3, 3)).copy()
    before = gs.LAUNCHES
    out = coupled_forward(depth_net, pose_net, tgt, src, K, cfg)
    torch.cuda.synchronize()
    assert gs.LAUNCHES - before == cfg.iterations - 1
    plain = coupled_forward(depth_net, pose_net, tgt, src, K, cfg,
                            sampler=gs.grid_sample_plain)
    for a, b in zip(out, plain):
        assert a.is_cuda and torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= 1e-5


@pytest.mark.parametrize("case,shape", [
    *(c for c in SAMPLER_CASES if c[1] != (24, 192, 640, 4)),
    ("random", (4, 192, 640, 3))])
def test_with_grads_kernel_matches_plain(cuda, case, shape, request):
    warps = (request.getfixturevalue("main_path_warps")
             if case == "main_path" else None)
    img, coords = _sample_inputs(case, shape, 7, warps, cuda)
    before = gs.LAUNCHES_FWD_GRADS
    got = gs.grid_sample_with_grads(img, coords)
    torch.cuda.synchronize()
    assert gs.LAUNCHES_FWD_GRADS == before + 1
    ref = gs.grid_sample_with_grads_plain(img, coords)
    errs = [(got[0] - ref[0]).abs().max().item()] + [
        (a - r).abs().max().item() / r.abs().max().item()
        for a, r in zip(got[1:], ref[1:])]
    print(f"grid_sample_with_grads {case} {tuple(img.shape)}: "
          f"max|kernel-plain| out {errs[0]}, gx, gy {errs[1:]} of their "
          f"magnitude")
    assert errs[0] <= 1e-5
    for a, e in zip(got[1:], errs[1:]):
        assert a.shape == img.shape
        assert e <= 1e-6


def test_forward_mode_on_the_card(cuda):
    """torch.func.jvp through grid_sample_fwd_diff: one value+Jacobian
    launch and no other; through grid_sample: its forward and one
    value+Jacobian launch; vmap and grad as on the CPU."""
    img, coords = _inputs((2, 16, 24, 3), 8, cuda)
    tangent = torch.randn(coords.shape, generator=torch.Generator()
                          .manual_seed(9)).to(cuda)
    _, ref = torch.func.jvp(lambda c: gs.grid_sample_plain(img, c),
                            (coords,), (tangent,))
    for fn, launches in ((gs.grid_sample_fwd_diff, (0, 1)),
                         (gs.grid_sample, (1, 1))):
        before = (gs.LAUNCHES, gs.LAUNCHES_FWD_GRADS)
        _, tan = torch.func.jvp(lambda c: fn(img, c), (coords,), (tangent,))
        torch.cuda.synchronize()
        assert (gs.LAUNCHES - before[0],
                gs.LAUNCHES_FWD_GRADS - before[1]) == launches
        assert (tan - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    many = coords[None] * torch.tensor([1.0, 0.9], device=cuda)[
        :, None, None, None, None]
    out = torch.func.vmap(gs.grid_sample, in_dims=(None, 0))(img, many)
    assert torch.equal(out, torch.stack([gs.grid_sample_plain(img, c)
                                         for c in many]))
    grad = torch.func.grad(lambda c: gs.grid_sample(img, c).sum())(coords)
    ref = torch.func.grad(lambda c: gs.grid_sample_plain(img, c).sum())(
        coords)
    assert (grad - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_window_ba_on_card(cuda):
    """window_ba with the kernels and with the plain sampler on the same
    small smooth scene: 44 value and 154 value+Jacobian launches at 10
    iterations, the same poses and costs, and the cost falls."""
    import chip_smoke
    from tcsfm_torch.solver.ba import window_ba

    torch.backends.cuda.matmul.allow_tf32 = False
    tgt, src, K = chip_smoke.smooth_inputs(torch, 2, 2, 64, 96, seed=3)
    rng = np.random.RandomState(3)
    depth = (2.0 + 3.0 * rng.rand(2, 64, 96, 1)).astype(np.float32)
    pose = (0.01 * rng.randn(2, 2, 6)).astype(np.float32)
    args = (pose[0], pose[1], depth, tgt, src[0], src[1], depth, depth, K)
    before = (gs.LAUNCHES, gs.LAUNCHES_FWD_GRADS)
    res = window_ba(*args, iters=10, depth_prior_weight=0.1)
    torch.cuda.synchronize()
    assert (gs.LAUNCHES - before[0],
            gs.LAUNCHES_FWD_GRADS - before[1]) == (44, 154)
    ref = window_ba(*args, iters=10, depth_prior_weight=0.1,
                    sampler=gs.grid_sample_plain)
    assert res.pose_prev.is_cuda and bool((res.cost[-1] < res.cost[0]).all())
    for k in ("pose_prev", "pose_next"):
        assert (getattr(res, k) - getattr(ref, k)).abs().max().item() <= 1e-5
    assert ((res.cost - ref.cost).abs() / ref.cost).max().item() <= 1e-6


def _tail_inputs(shape, seed, device):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(*shape) * 0.5).astype(np.float32))
    ws = [torch.from_numpy(a.astype(np.float32)).to(device) for a in (
        rng.randn(32, 32, 3, 3) * 0.08, rng.randn(32) * 0.1,
        rng.randn(8, 32, 3, 3) * 0.08, rng.randn(8) * 0.1,
        rng.randn(1, 8, 3, 3) * 0.2, rng.randn(1) * 0.1)]
    return x.to(device), ws


@pytest.mark.parametrize("shape", [(1, 32, 5, 7), (2, 32, 37, 50),
                                   (3, 32, 32, 48), (2, 32, 19, 38),
                                   (1, 32, 4, 4), (7, 32, 64, 96),
                                   (7, 32, 100, 200)])
def test_decoder_tail_kernel_matches_plain(cuda, shape):
    """Smaller than a 12x32 tile (5x7, and the minimum 4x4); not a
    multiple of it (37x50, 32x48); a W that is not a multiple of 4 (19x38:
    every tile takes 4-byte copies); tiles with interior columns, which
    take 16-byte copies (64x96, 100x200); and tile counts that are not
    multiples of the persistent grid: 126 (7x32x64x96), fewer than the
    card's 132 SMs, and 441 (7x32x100x200), which loops past them."""
    torch.backends.cudnn.allow_tf32 = False
    x, ws = _tail_inputs(shape, 11, cuda)
    before = dt.LAUNCHES
    out = dt.decoder_tail(x, *ws)
    torch.cuda.synchronize()
    assert dt.LAUNCHES == before + 1
    ref = dt.decoder_tail_plain(x, *ws)
    n, _, h, w = shape
    assert out.shape == (n, h, w, 1) and out.is_contiguous()
    assert (out - ref).abs().max().item() <= 1e-5


def test_decoder_tail_gradient_on_card(cuda):
    torch.backends.cudnn.allow_tf32 = False
    x, ws = _tail_inputs((2, 32, 20, 24), 12, cuda)
    grads = []
    for fn in (dt.decoder_tail, dt.decoder_tail_plain):
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, *ws)]
        fn(*leaves).sum().backward()
        grads.append([t.grad for t in leaves])
    for g, r in zip(*grads):
        assert (g - r).abs().max().item() <= 1e-6 * r.abs().max().item()


def test_make_tail_apply_on_card(cuda):
    """The depth net through the fused tail vs its own forward at 64x96,
    seeded weights with trained-like conditioning: one tail launch."""
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    depth_net, _ = build_models(Config(compute_dtype="float32"),
                                generator=torch.Generator().manual_seed(3))
    chip_smoke.condition_like_trained(depth_net, torch)
    imgs = torch.from_numpy(np.random.RandomState(4).rand(
        3, 64, 96, 3).astype(np.float32)).to(cuda)
    before = dt.LAUNCHES
    with torch.no_grad():
        (tail,) = make_tail_apply(depth_net)(imgs)
        (plain,) = depth_net(imgs)
    torch.cuda.synchronize()
    assert dt.LAUNCHES == before + 1
    assert tail.shape == plain.shape == (3, 64, 96, 1)
    assert (tail - plain).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape", [(1, 32, 5, 7), (2, 32, 37, 50),
                                   (2, 32, 19, 38), (1, 32, 4, 4),
                                   (7, 32, 100, 200)])
def test_decoder_tail_bf16_kernel_matches_plain(cuda, shape):
    """The bf16 tail kernel against ``decoder_tail_plain_bf16`` at the f32
    kernel's border cases, on the f32 disparity: within
    ``chip_smoke.TAIL_BF16_TOL`` (bf16 rounding flips of elu(x), f1 and f2
    under another f32 summation order); one bf16 launch, no f32 one."""
    import chip_smoke

    x, ws = _tail_inputs(shape, 13, cuda)
    x = x.to(torch.bfloat16)
    before = (dt.LAUNCHES, dt.LAUNCHES_BF16)
    out = dt.decoder_tail(x, *ws)
    torch.cuda.synchronize()
    assert (dt.LAUNCHES, dt.LAUNCHES_BF16) == (before[0], before[1] + 1)
    ref = dt.decoder_tail_plain_bf16(x, *ws)
    n, _, h, w = shape
    assert out.dtype == torch.float32 and out.shape == (n, h, w, 1)
    assert (out - ref).abs().max().item() <= chip_smoke.TAIL_BF16_TOL


def test_bf16_nets_on_card(cuda):
    """``compute_dtype="bfloat16"``'s forward through both routes and a
    training step at 64x96: bf16 disparities, f32 poses, finite losses,
    float32 parameters and gradients, one bf16 tail launch on the tail
    route."""
    import chip_smoke

    cfg = Config(iterations=2, compute_dtype="bfloat16")
    depth_net, pose_net = build_models(
        cfg, generator=torch.Generator().manual_seed(3))
    chip_smoke.condition_like_trained(depth_net, torch)
    inputs = chip_smoke.smooth_inputs(torch, 2, 2, 64, 96, seed=2)
    before = dt.LAUNCHES_BF16
    for apply in (None, make_tail_apply(depth_net)):
        _, _, disp, chain = coupled_forward(depth_net, pose_net, *inputs,
                                            cfg, depth_apply=apply)
        assert disp.dtype == torch.bfloat16 and chain.dtype == torch.float32
        assert torch.isfinite(disp).all() and torch.isfinite(chain).all()
    assert dt.LAUNCHES_BF16 == before + 1
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(0))
    chip_smoke.condition_like_trained(state.depth_net, torch)
    losses = train_step(state, chip_smoke.train_batch(
        torch, 2, 2, 96, 160, seed=5, device="cuda"))
    assert all(torch.isfinite(v) for v in losses.values())
    for p in list(state.depth_net.parameters()) + list(
            state.pose_net.parameters()):
        assert p.dtype == p.grad.dtype == torch.float32


@pytest.mark.parametrize("mode", ["encoder", "pose"])
def test_pft_on_card(cuda, mode):
    """One PFT call at 64x96, B=2, S=2, 4 iterations, 4 epochs with the
    kernels against the same call with the plain sampler
    (``chip_smoke.pft_parity``, cuDNN deterministic: the first step's
    gradients as ``test_train_step_on_card`` holds a step's; the first
    loss within 1e-6 relative; the losses, poses_opt and disp_opt within
    max(1e-5, 4x the plain call's own spread), at most 0.15, as relative
    L2, the spread the largest of four plain reruns:
    ``chip_smoke.pft_spread_runs``). Launches: encoder mode E·I value, (E-1)(I-1) d_coords-only and
    E-1 d_img; 'pose' mode trains no depth, so the 4-channel warp's
    backward is d_coords only too, at C=4: (E-1)·I and no d_img."""
    import chip_smoke
    from tcsfm_torch.config import PFTOptions
    from tcsfm_torch.solver import pft

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    epochs, iters = 4, chip_smoke.ITERS
    cfg = Config(compute_dtype="float32", iterations=iters)
    depth_net, pose_net = build_models(
        cfg, generator=torch.Generator().manual_seed(5))
    chip_smoke.condition_like_trained(depth_net, torch)
    batch = chip_smoke.pft_batch(torch, 2, 64, 96, seed=9, device=cuda)
    opt = pft.PFTOptimizer(cfg, PFTOptions(epochs=epochs, num_source_imgs=2),
                           depth_net, pose_net, mode=mode)
    seen = []
    real = gs.grid_sample_bwd

    def recording(img, coords, g, grad_ch=()):
        seen.append((img.shape[-1], tuple(grad_ch)))
        return real(img, coords, g, grad_ch)

    chip_smoke.zero_counts(gs)
    gs.grid_sample_bwd = recording
    try:
        res = opt.optimize_window(batch)
        torch.cuda.synchronize()
    finally:
        gs.grid_sample_bwd = real
    counts = chip_smoke.read_counts(gs)
    if mode == "encoder":
        assert counts == chip_smoke.pft_expected_launches(epochs, iters)
        assert seen.count((4, (3,))) == epochs - 1
    else:
        assert counts == (epochs * iters, (epochs - 1) * iters, 0)
        assert seen.count((4, ())) == epochs - 1
    assert res.losses.shape == (epochs,) and torch.isfinite(res.losses).all()
    grads, fields, first = chip_smoke.pft_parity(torch, gs, pft, opt, batch,
                                                 mode)
    print(mode, grads, fields, first)


# card vs CPU where f32 does not resolve a path: within this many times
# the CPU run's own one-ulp spread (chip_smoke's SEQ_SPREAD_FACTOR)
SPREAD_FACTOR = 4


def _card_model_dir(tmp_path, seed):
    """A checkpoint of seeded, trained-like nets (4 iterations) in
    ``tmp_path``, written by the port."""
    import chip_smoke
    from tcsfm_torch.train.checkpoint import save_checkpoint

    cfg = Config(compute_dtype="float32", iterations=chip_smoke.ITERS)
    nets = build_models(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    chip_smoke.condition_like_trained(nets[0], torch)
    save_checkpoint(str(tmp_path), nets, epoch=1, best_val_loss=1.0,
                    cfg=cfg, is_best=True)
    return str(tmp_path)


def test_evaluate_vo_on_card(cuda, tmp_path):
    """``evaluate_vo --synthetic`` (24 frames, 64x96, batch 8: 3 batches,
    3 value launches each) on the card, through ``--model_dir``: pose
    vectors and DNet scales within 1e-5 of the plain sampler's run (the
    kernel is bit-equal to it) and within 1e-4 of the CPU's (phase
    "sequence" read 1.5e-5 card vs CPU, 1.7e-5 for the CPU run with its
    images one ulp up), the printed errors within 1e-3 (their 3-decimal
    rounding)."""
    import chip_smoke
    from tcsfm_torch.cli import evaluate_vo
    from tcsfm_torch.cli.common import load_nets

    torch.backends.cudnn.allow_tf32 = False
    model_dir = _card_model_dir(tmp_path / "model", seed=6)
    preds = {}
    for name, device, sampler in (("kernel", "cuda", gs.grid_sample),
                                  ("plain", "cuda", gs.grid_sample_plain),
                                  ("cpu", "cpu", gs.grid_sample)):
        args = evaluate_vo.parse_args(
            ["--model_dir", model_dir, "--synthetic", "--save_preds",
             str(tmp_path / name)])
        chip_smoke.zero_counts(gs)
        out = evaluate_vo.run(args, *load_nets(model_dir, device), device,
                              sampler=sampler)
        if name == "kernel":
            assert chip_smoke.read_counts(gs) == (3 * (chip_smoke.ITERS - 1),
                                                  0, 0)
        preds[name] = (out["synthetic"], chip_smoke.preds_of(
            tmp_path / name / "synthetic_preds.npz"))
    for ref, tol in (("plain", 1e-5), ("cpu", 1e-4)):
        pose, scale = chip_smoke.preds_gap(preds["kernel"][1],
                                           preds[ref][1])
        print(f"kernel vs {ref}: pose vectors {pose:.3e}, DNet scales "
              f"{scale:.3e}")
        assert pose <= tol and scale <= tol
        for k in ("errors_unscaled", "errors_dnet", "errors_gt_scaled"):
            assert np.allclose(preds["kernel"][0][k][:2],
                               preds[ref][0][k][:2], rtol=0, atol=1e-3)


# launches of one call at 3 epochs: PFT's E·I, (E-1)(I-1), E-1; the
# coupled forward's I-1 value launches, then window_ba (1 LM iteration:
# 4n+4 value, 14(n+1) value+Jacobian) or two gauss_newton_pose calls (4
# iterations: 2n+1 value, 6n value+Jacobian each)
@pytest.mark.parametrize("refiner,expected", [
    ("adam", lambda i: (3 * i, 2 * (i - 1), 2, 0)),
    ("ba", lambda i: (i - 1 + 8, 0, 0, 28)),
    ("gn", lambda i: (i - 1 + 2 * 9, 0, 0, 2 * 24)),
    ("chain", None)])
def test_run_sequential_pft_on_card(cuda, tmp_path, refiner, expected):
    """``run_sequential_pft`` at 64x96 (6 frames: 4 windows, one window
    batch; 3 epochs; chain 6 frames, one block) on the card through
    ``--model_dir``: finite results, the cost falling (ba, gn, chain), and
    the launches (value, d_coords, d_img, value+Jacobian)."""
    import chip_smoke
    from tcsfm_torch.cli import run_sequential_pft as seq_pft

    torch.backends.cudnn.allow_tf32 = False
    model_dir = _card_model_dir(tmp_path / "model", seed=7)
    chip_smoke.zero_counts(gs)
    res = seq_pft.main(["--model_dir", model_dir, "--synthetic",
                        "--synthetic_frames", "6", "--epochs", "3",
                        "--window_batch", "4", "--refiner", refiner,
                        "--out_dir", str(tmp_path / "out")])["synthetic"]
    torch.cuda.synchronize()
    counts = chip_smoke.read_counts(gs) + (gs.LAUNCHES_FWD_GRADS,)
    npz = np.load(tmp_path / "out" / "synthetic_pft.npz")
    assert np.isfinite(npz["pose_opt"]).all()
    assert np.isfinite(res["errors_optimized"][0])
    if refiner != "adam":
        assert res["pft_loss_last"] < res["pft_loss_first"]
    if expected is not None:
        assert counts == expected(chip_smoke.ITERS)
    else:
        assert npz["pose_opt"].shape == (5, 6) and counts[3] > 0


def _eigen_split(root, frames=6):
    """``frames`` synthetic 64x96 frames as PNGs in the Eigen index layout,
    and their metric GT depths nearest-resized to 120x372."""
    from PIL import Image

    import chip_smoke
    from tcsfm_torch.data.synthetic import make_synthetic_sequence

    seq = make_synthetic_sequence(frames, (64, 96), seed=8)
    files = []
    for i in range(frames):
        files.append(str(root / f"{i:010d}.png"))
        Image.fromarray((seq.images[i] * 255).astype(np.uint8)).save(
            files[-1])
    np.savez(root / "eigen_info_test.npz", files=np.asarray(files),
             K=seq.intrinsics, poses=seq.gt_poses,
             folders=np.asarray(["drive0"] * frames), idxs=np.arange(frames))
    gt = np.empty(frames, object)
    for i in range(frames):
        gt[i] = chip_smoke.nearest_resize(seq.depths[i], (120, 372)) * 30.0
    np.savez(root / "gt_depths.npz", data=gt)
    return str(root)


def test_evaluate_depth_eigen_on_card(cuda, tmp_path):
    """``evaluate_depth_eigen`` (6 frames at 64x96, batch 4, flip-merged)
    on the card against the CPU: the scaled disparities within 1e-5 of
    their range (the forward's card-vs-CPU 1e-5 on the sigmoid), the
    metrics within 1e-4 relative; the path launches no sampler kernel."""
    import chip_smoke
    from tcsfm_torch.cli import evaluate_depth_eigen

    torch.backends.cudnn.allow_tf32 = False
    model_dir = _card_model_dir(tmp_path / "model", seed=8)
    data = _eigen_split(tmp_path)
    out = {}
    for device in ("cuda", "cpu"):
        chip_smoke.zero_counts(gs)
        npy = str(tmp_path / f"{device}.npy")
        out[device] = (evaluate_depth_eigen.main(
            ["--model_dir", model_dir, "--data_dir", data, "--gt_depths",
             data + "/gt_depths.npz", "--save_pred_disps", npy, "--device",
             device]), np.load(npy))
        assert chip_smoke.read_counts(gs) == (0, 0, 0)
    cfg = Config(compute_dtype="float32")
    span = 1.0 / cfg.min_depth - 1.0 / cfg.max_depth
    err = np.abs(out["cuda"][1] - out["cpu"][1]).max() / span
    print(f"Eigen card vs CPU: scaled disparity {err:.3e} of its range")
    assert err <= 1e-5
    for k, v in out["cpu"][0].items():
        assert abs(out["cuda"][0][k] - v) <= 1e-4 * max(abs(v), 1e-12), k


def test_evaluate_scannet_on_card(cuda, tmp_path):
    """``evaluate_scannet`` (a 21-frame 64x96 scene, gap 4: 13 windows in
    batches of 4, 8 iterations) on the card: 7 value launches a batch; the
    disparities and fused pose vectors within 1e-5 of the plain sampler's
    run (the kernel is bit-equal to it) and within 1e-4 of the CPU's."""
    import chip_smoke
    from tcsfm_torch.cli import evaluate_scannet
    from tcsfm_torch.cli.common import load_nets
    from tcsfm_torch.data.synthetic import make_synthetic_sequence

    torch.backends.cudnn.allow_tf32 = False
    model_dir = _card_model_dir(tmp_path / "model", seed=9)
    make_synthetic_sequence(21, (64, 96), seed=7).save_npz(
        str(tmp_path / "scene0.npz"))
    args = evaluate_scannet.parse_args(
        ["--model_dir", model_dir, "--data_dir", str(tmp_path), "--scenes",
         "scene0", "--frame_gap", "4"])
    runs = {}
    for name, device, sampler in (("kernel", "cuda", gs.grid_sample),
                                  ("plain", "cuda", gs.grid_sample_plain),
                                  ("cpu", "cpu", gs.grid_sample)):
        chip_smoke.zero_counts(gs)
        runs[name] = evaluate_scannet.predict(
            args, *load_nets(model_dir, device), device, sampler=sampler)
        if name == "kernel":
            assert chip_smoke.read_counts(gs) == (4 * 7, 0, 0)
    cfg = Config(compute_dtype="float32")
    span = 1.0 / cfg.min_depth - 1.0 / cfg.max_depth
    for ref, tol in (("plain", 1e-5), ("cpu", 1e-4)):
        disp, pose = chip_smoke.scannet_gap(runs["kernel"], runs[ref])
        print(f"ScanNet kernel vs {ref}: disparities {disp:.3e} (their range "
              f"{span:.2f}), pose vectors {pose:.3e}")
        assert disp <= tol * span and pose <= tol
    assert np.isfinite(list(evaluate_scannet.metrics(
        *runs["kernel"])["pose"].values())).all()


def test_golden_warm_start_gate_on_card(cuda, tmp_path):
    """``golden_eval --warm_start_gate`` at the CLI's defaults: phase A
    (``--synthetic --device cpu`` in a subprocess, 5 epochs at 64x96) on
    the card's host CPU, phase B on the card, ``native`` continuing in
    bfloat16 beside ``match`` in float32. Its VO parity gates and its PFT
    loss parity gate (card vs CPU from the same weights) must pass. The PFT t-ATE is held to the
    CPU's own spread: the card's gap to the CPU's t-ATE within
    ``SPREAD_FACTOR`` x the larger gap of the same PFT on the CPU with the
    test images one ulp up or down, at least the CLI's gate (0.050, set
    <10% above the JAX package's TPU reading 0.046). The continued-training
    gates (calibrated on the JAX package's TPU run) are printed beside the
    same continuation on the CPU."""
    import dataclasses
    import json

    from tcsfm_torch.cli import golden_eval
    from tcsfm_torch.train.checkpoint import load_checkpoint

    torch.backends.cudnn.allow_tf32 = False
    warm = str(tmp_path / "warm")
    out = golden_eval.main(["--warm_start_gate", "--warm_dir", warm])
    print(json.dumps(out, indent=1, default=float))
    native, match = out["variants"]["native"], out["variants"]["match"]
    assert native["losses"] != match["losses"]
    assert np.isfinite(native["losses"] + [native["rot_err"]]).all()

    args = golden_eval.parse_args([])
    with open(f"{warm}/warm_metrics.json") as f:
        cpu = json.load(f)
    cfg = Config.load(f"{warm}/config.json")
    _, seq = golden_eval.synthetic_data(args)
    state = create_train_state(cfg, device="cpu", steps_per_epoch=32)
    load_checkpoint(warm, state)
    spread = 0.0
    for direction in (2.0, -1.0):
        moved = dataclasses.replace(seq, images=np.nextafter(
            seq.images, np.float32(direction)))
        _, ate, _ = golden_eval._run_pft(cfg, state.depth_net,
                                         state.pose_net, moved, args,
                                         torch.device("cpu"))
        spread = max(spread, abs(ate - cpu["ate_pft_opt"])
                     / cpu["ate_pft_opt"])
    limit = max(args.warm_pft_ate_gate, SPREAD_FACTOR * spread)
    cont = golden_eval.continue_training(warm, args, torch.device("cpu"))
    print(f"PFT t-ATE card vs CPU {out['pft_ate_delta_rel']:.4f}; the CPU's "
          f"own one-ulp spread {spread:.4f}, limit {limit:.4f}; continued "
          f"training on the card: loss ratio "
          f"{out['variants']['match']['loss_ratio']:.4f}, rot ratio "
          f"{out['variants']['match']['rot_ratio']:.4f}; on the CPU: loss "
          f"ratio {cont['loss_ratio']:.4f}, rot ratio "
          f"{cont['rot_ratio']:.4f} (gates {args.warm_loss_gate}, "
          f"{args.warm_rot_gate})")
    for gate in ("vo_pose_parity", "vo_ate_parity", "pft_loss_parity"):
        assert out["gates"][gate], (gate, out)
    assert out["pft_ate_delta_rel"] <= limit


def test_flow_pair_on_card(cuda):
    """``ops.flow.batched_flow_pair`` (plain PyTorch, no hand-written
    kernel) on the card against the CPU, on two pairs of generated 64x96
    frames, in pixels: within ``chip_smoke.FLOW_SPREAD_FACTOR`` x the CPU
    run's own spread with its images one ulp up, at least
    ``chip_smoke.FLOW_TOL`` (phase "flow"'s rule)."""
    import chip_smoke
    from tcsfm_torch.data.synthetic import make_synthetic_sequence
    from tcsfm_torch.ops import flow

    imgs = make_synthetic_sequence(4, (64, 96), seed=3).images
    tgt = torch.from_numpy(np.ascontiguousarray(imgs[[0, 2]]))
    src = torch.from_numpy(np.ascontiguousarray(imgs[[1, 3]]))

    def px(t, s):
        return torch.stack(flow.batched_flow_pair(t, s)).double().cpu() * 96

    card, cpu = px(tgt.to(cuda), src.to(cuda)), px(tgt, src)
    up = [torch.from_numpy(np.nextafter(x.numpy(), np.float32(2.0)))
          for x in (tgt, src)]
    spread = float((px(*up) - cpu).abs().max())
    gap = float((card - cpu).abs().max())
    limit = max(chip_smoke.FLOW_TOL, chip_smoke.FLOW_SPREAD_FACTOR * spread)
    print(f"flow card vs CPU {gap:.3e} px (spread {spread:.3e}, limit "
          f"{limit:.3e})")
    assert torch.isfinite(card).all() and gap <= limit


def test_evaluate_vo_classical_on_card(cuda, tmp_path):
    """``evaluate_vo --synthetic --iterations 1`` with a classical-flow
    model (the 8-channel pose net fed the Farneback pair) on the card: no
    sampler launch; pose vectors and DNet scales against the CPU's within
    ``chip_smoke``'s limits of the CPU run's own spread with its images
    one ulp up (phase "sequence"'s rule), the printed errors within 1e-3."""
    import chip_smoke
    from tcsfm_torch.cli import evaluate_vo
    from tcsfm_torch.cli.common import load_nets
    from tcsfm_torch.data.synthetic import make_synthetic_sequence
    from tcsfm_torch.train.checkpoint import save_checkpoint

    torch.backends.cudnn.allow_tf32 = False
    model_dir = str(tmp_path / "model")
    cfg = Config(compute_dtype="float32", iterations=1, flow_type="classical")
    nets = build_models(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(7))
    chip_smoke.condition_like_trained(nets[0], torch)
    save_checkpoint(model_dir, nets, epoch=1, best_val_loss=1.0, cfg=cfg,
                    is_best=True)
    syn = make_synthetic_sequence(24, (64, 96), seed=11)
    chip_smoke.write_sequence(tmp_path / "data" / "ulp", syn,
                              np.nextafter(syn.images, np.float32(2.0)))
    preds = {}
    for name, device, src in (
            ("card", "cuda", ["--synthetic"]), ("cpu", "cpu", ["--synthetic"]),
            ("cpu_ulp", "cpu", ["--data_dir", str(tmp_path / "data"),
                                "--seqs", "ulp"])):
        args = evaluate_vo.parse_args(
            ["--model_dir", model_dir, "--iterations", "1", "--save_preds",
             str(tmp_path / name)] + src)
        chip_smoke.zero_counts(gs)
        out = evaluate_vo.run(args, *load_nets(model_dir, device), device)
        if name == "card":
            assert chip_smoke.read_counts(gs) == (0, 0, 0)
        key = "ulp" if name == "cpu_ulp" else "synthetic"
        preds[name] = (out[key], chip_smoke.preds_of(
            tmp_path / name / f"{key}_preds.npz"))
    err = chip_smoke.preds_gap(preds["card"][1], preds["cpu"][1])
    spread = chip_smoke.preds_gap(preds["cpu_ulp"][1], preds["cpu"][1])
    print(f"classical VO card vs CPU: {chip_smoke.gaps_text(err, spread)}")
    assert chip_smoke.within_spread(err, spread)
    for k in ("errors_unscaled", "errors_dnet", "errors_gt_scaled"):
        assert np.allclose(preds["card"][0][k][:2], preds["cpu"][0][k][:2],
                           rtol=0, atol=1e-3)


def test_inverse_warp_on_card(cuda):
    """The legacy ``inverse_warp`` through the value kernel (one launch)
    against the plain sampler at [6,192,640,3]: atol 1e-5, valid masks
    equal."""
    from tcsfm_torch.geom.warp import inverse_warp

    n, h, w = 6, 192, 640
    g = torch.Generator().manual_seed(8)
    img = torch.rand((n, h, w, 3), generator=g).to(cuda)
    depth = (1.0 + torch.rand((n, h, w, 1), generator=g)).to(cuda)
    pose = (0.02 * torch.randn((n, 6), generator=g)).to(cuda)
    K = torch.tensor([[0.58 * w, 0, w / 2], [0, 1.92 * h, h / 2],
                      [0, 0, 1]]).expand(n, 3, 3).contiguous().to(cuda)
    before = gs.LAUNCHES
    out, valid = inverse_warp(img, depth, pose, K)
    assert gs.LAUNCHES == before + 1
    ref, ref_valid = inverse_warp(img, depth, pose, K,
                                  sampler=gs.grid_sample_plain)
    assert torch.equal(valid, ref_valid)
    assert float((out - ref).abs().max()) <= 1e-5
