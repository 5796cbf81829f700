"""The port's CUDA kernels against their plain versions, and the training
step and the refiners through them, on the card.

Marked ``cuda``: each test asks the ``cuda`` fixture, which skips where
there is no card. This file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: forward atol 1e-5, value+Jacobian gx/gy and backward d_coords
1e-6 of their largest magnitude (each kernel repeats its plain version's
f32 arithmetic in the same order; the forward kernels have measured
bit-equal on an H100); d_img 1e-5 (atomics add in an order that changes
from run to run); a refiner with the kernels vs the plain sampler: poses
1e-5, costs 1e-6 relative (the jvps' products run in another order); the
decoder tail kernel vs its plain version (cuDNN convolutions, TF32 off)
atol 1e-5 on the sigmoid output (the sums run in another order), its
gradient (the plain version's autodiff either way) 1e-6 of the largest.
"""

import copy

import numpy as np
import pytest
import torch

from tcsfm_torch.config import Config
from tcsfm_torch.infer import build_models, coupled_forward
from tcsfm_torch.models.depth import make_tail_apply
from tcsfm_torch.ops import decoder_tail as dt
from tcsfm_torch.ops import grid_sample as gs
from tcsfm_torch.train.trainer import create_train_state, train_step

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


@pytest.mark.parametrize("shape", [(2, 31, 45, 1), (2, 32, 64, 3),
                                   (3, 17, 23, 4), (1, 8, 9, 7),
                                   (24, 192, 640, 3), (24, 192, 640, 4)])
def test_kernel_matches_plain(cuda, shape):
    img, coords = _inputs(shape, 0, cuda)
    before = gs.LAUNCHES
    out = gs.grid_sample(img, coords)
    torch.cuda.synchronize()
    assert gs.LAUNCHES == before + 1
    ref = gs.grid_sample_plain(img, coords)
    assert out.shape == img.shape
    assert (out - ref).abs().max().item() <= 1e-5


@pytest.mark.parametrize("grad_ch", [(), (3,), (0, 1, 2, 3)])
@pytest.mark.parametrize("shape", [(2, 31, 45, 4), (3, 17, 23, 4),
                                   (24, 192, 640, 4)])
def test_bwd_kernel_matches_plain(cuda, shape, grad_ch):
    """d_coords bit for bit in the kernel's order (limit 1e-6 of its largest
    magnitude), d_img within 1e-5 (atomics sum in another order)."""
    img, coords = _inputs(shape, 3, cuda)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(4)).to(cuda)
    counters = (gs.LAUNCHES_BWD_COORDS, gs.LAUNCHES_BWD_IMG)
    d_coords, d_img = gs.grid_sample_bwd(img, coords, g, grad_ch)
    torch.cuda.synchronize()
    launched = (gs.LAUNCHES_BWD_COORDS - counters[0],
                gs.LAUNCHES_BWD_IMG - counters[1])
    assert launched == ((0, 1) if grad_ch else (1, 0))
    ref_coords, ref_img = gs.grid_sample_bwd_plain(img, coords, g, grad_ch)
    scale = ref_coords.abs().max().item()
    assert (d_coords - ref_coords).abs().max().item() <= 1e-6 * scale
    if grad_ch:
        assert d_img.shape == shape[:3] + (len(grad_ch),)
        assert (d_img - ref_img).abs().max().item() <= 1e-5
    else:
        assert d_img is None


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
    depth terms on): 4 forward, 3 d_coords and 1 d_img launches; the same
    losses (the forward kernel is bit-equal to its plain version) and
    gradients within 1e-4 relative L2."""
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config(iterations=4, l_depth_consist=True, with_depth_mask=True)
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(0))
    chip_smoke.condition_like_trained(state.depth_net, torch)
    plain = copy.deepcopy(state)
    batch = chip_smoke.train_batch(torch, 2, 2, 96, 160, seed=6,
                                   device="cuda")
    before = (gs.LAUNCHES, gs.LAUNCHES_BWD_COORDS, gs.LAUNCHES_BWD_IMG)
    losses = train_step(state, batch)
    torch.cuda.synchronize()
    assert (gs.LAUNCHES - before[0], gs.LAUNCHES_BWD_COORDS - before[1],
            gs.LAUNCHES_BWD_IMG - before[2]) == (4, 3, 1)
    ref = train_step(plain, batch, sampler=gs.grid_sample_plain)
    for k in losses:
        assert torch.isfinite(losses[k]) and abs(
            losses[k].item() - ref[k].item()) <= 1e-6, k
    chip_smoke.compare_grads(chip_smoke.grads_of(state),
                             chip_smoke.grads_of(plain), 1e-4,
                             "kernel vs plain sampler step")


def test_coupled_forward_on_card(cuda):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config(iterations=4)
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


@pytest.mark.parametrize("shape", [(2, 31, 45, 1), (2, 32, 64, 3),
                                   (3, 17, 23, 4), (1, 8, 9, 7),
                                   (4, 192, 640, 3)])
def test_with_grads_kernel_matches_plain(cuda, shape):
    img, coords = _inputs(shape, 7, cuda)
    before = gs.LAUNCHES_FWD_GRADS
    got = gs.grid_sample_with_grads(img, coords)
    torch.cuda.synchronize()
    assert gs.LAUNCHES_FWD_GRADS == before + 1
    ref = gs.grid_sample_with_grads_plain(img, coords)
    assert (got[0] - ref[0]).abs().max().item() <= 1e-5
    for a, r in zip(got[1:], ref[1:]):
        assert a.shape == img.shape
        assert (a - r).abs().max().item() <= 1e-6 * r.abs().max().item()


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
                                   (3, 32, 32, 48)])
def test_decoder_tail_kernel_matches_plain(cuda, shape):
    """Smaller than a 16x16 tile, not a multiple of it, a multiple of
    it."""
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
    depth_net, _ = build_models(Config(),
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
