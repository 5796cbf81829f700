"""The port's loss stack (tcsfm_torch.losses.photometric) against the JAX
package's, on CPU.

Inputs: smooth images (bilinear from a 9x13 grid, as photographs are) and
rough per-pixel disparities, at B=2, S=2, 96x160, so that each (direction,
source) group keeps more than the 10,000 valid pixels below which
``mean_on_mask`` returns 0; the tests assert that the inverse term is not
0. Rough disparities keep the abs() terms of the smoothness loss away from
0, where f32 rounding would pick the sign of their gradient.

Tolerances: the single terms atol 1e-5 (f32, other summation orders),
except the per-pixel diff map of ``pairwise_loss``, 1e-4: SSIM's local
variance E[x²] - E[x]² of a smooth image cancels to within ~1e-7 of 0 in
f32, against a regulariser C2 of 9e-4 (measured: 3.3e-5 at 2% of pixels);
``compute_losses`` 3e-5, the bound tests/test_reference_parity.py holds the
JAX stack to against the original torch code; the gradients of ``total``
w.r.t. the disparities and poses in float64 (see
``test_compute_losses_and_grads``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tcsfm.config import Config as JaxConfig
from tcsfm.losses import photometric as jl
from tcsfm_torch.config import Config
from tcsfm_torch.losses import photometric as pl
from tcsfm_torch.ops import grid_sample as gs
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, S, H, W = 2, 2, 96, 160
ATOL = 1e-5
MAP_ATOL = 1e-4   # per-pixel SSIM maps, see the module docstring
CONFIGS = {
    "default": {},
    "depth_consist": {"l_depth_consist": True, "with_depth_mask": True},
    "two_scales": {"num_scales": 2},
}


def _smooth(rng, n, h=H, w=W):
    lo = torch.from_numpy(rng.rand(n, 3, 9, 13))
    up = F.interpolate(lo, size=(h, w), mode="bilinear", align_corners=True)
    return up.permute(0, 2, 3, 1).numpy().astype(np.float32)


def _inputs(seed, num_scales=1):
    rng = np.random.RandomState(seed)
    tgt = _smooth(rng, B)
    src = _smooth(rng, S * B).reshape(S, B, H, W, 3)
    disps = [[rng.uniform(0.02, 0.2, (B, H >> s, W >> s, 1)).astype(np.float32)
              for s in range(num_scales)] for _ in range(S + 1)]
    poses = (rng.uniform(-1, 1, (S, B, 6)) * ([0.02] * 3 + [0.01] * 3)
             ).astype(np.float32)
    poses_inv = (-poses + 0.002 * rng.randn(S, B, 6)).astype(np.float32)
    K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2.5], [0, 0, 1]],
                 np.float32)
    return tgt, src, disps, poses, poses_inv, np.broadcast_to(K, (B, 3, 3)).copy()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def test_ssim_loss():
    rng = np.random.RandomState(0)
    x, y = _smooth(rng, B), rng.rand(B, H, W, 3).astype(np.float32)
    _close(pl.ssim_loss(_t(x), _t(y)), jl.ssim_loss(jnp.asarray(x), jnp.asarray(y)))


def test_smooth_loss():
    tgt, _, disps, *_ = _inputs(1)
    _close(pl.smooth_loss(_t(disps[0][0]), _t(tgt)),
           jl.smooth_loss(jnp.asarray(disps[0][0]), jnp.asarray(tgt)))


def test_pose_consistency_loss():
    *_, poses, poses_inv, _ = _inputs(2)
    _close(pl.pose_consistency_loss(_t(poses), _t(poses_inv)),
           jl.pose_consistency_loss(jnp.asarray(poses), jnp.asarray(poses_inv)))


@pytest.mark.parametrize("valid_share", [0.9, 0.3])
def test_mean_on_mask(valid_share):
    """0.3 of 2x96x160 pixels is under the 10,000-pixel guard: exactly 0."""
    rng = np.random.RandomState(3)
    diff = rng.rand(B, H, W, 1).astype(np.float32)
    mask = (rng.rand(B, H, W, 1) < valid_share).astype(np.float32)
    port = pl.mean_on_mask(_t(diff), _t(mask))
    _close(port, jl.mean_on_mask(jnp.asarray(diff), jnp.asarray(mask)))
    assert (port.item() == 0.0) == (valid_share < 0.5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pairwise_loss(name):
    tgt, src, disps, poses, _, K = _inputs(4)
    jcfg = JaxConfig(use_mxu_warp=False, **CONFIGS[name])
    cfg = Config(**CONFIGS[name])
    depth = 1.0 / (0.4 + 16.0 * disps[0][0])
    ref_depth = 1.0 / (0.4 + 16.0 * disps[1][0])
    args = (tgt, src[0], depth, ref_depth, -poses[0], K)
    port = pl.pairwise_loss(cfg, *map(_t, args))
    ref = jl.pairwise_loss(jcfg, *map(jnp.asarray, args))
    for i, (p, r) in enumerate(zip(port, ref)):
        _close(p, r, atol=MAP_ATOL if i == 2 else ATOL)
    assert port[0].item() > 0


@pytest.fixture(scope="module")
def jax_fns():
    """Per configuration: one jit of the JAX loss stack and one of the
    gradient of its total w.r.t. (disparities, poses, poses_inv)."""
    fns = {}
    for name, kw in CONFIGS.items():
        jcfg = JaxConfig(use_mxu_warp=False, **kw)

        def losses(disps, poses, poses_inv, tgt, src, K, jcfg=jcfg):
            return jl.compute_losses(jcfg, src, tgt, poses, poses_inv, disps, K)

        def total(*args, losses=losses):
            return losses(*args)["total"]

        fns[name] = (jax.jit(losses), jax.jit(jax.grad(total, (0, 1, 2))))
    return fns


def _jax_args(inputs, dtype):
    tgt, src, disps, poses, poses_inv, K = inputs
    a = functools.partial(jnp.asarray, dtype=dtype)
    return (jax.tree_util.tree_map(a, disps), a(poses), a(poses_inv), a(tgt),
            a(src), a(K))


def _port(name, inputs, sampler=gs.grid_sample, dtype=torch.float32):
    tgt, src, disps, poses, poses_inv, K = inputs

    def t(x):
        return torch.from_numpy(np.asarray(x)).to(dtype)

    cfg = Config(**CONFIGS[name])
    t_disps = [[t(d).requires_grad_(True) for d in f] for f in disps]
    t_poses = t(poses).requires_grad_(True)
    t_poses_inv = t(poses_inv).requires_grad_(True)
    losses = pl.compute_losses(cfg, t(src), t(tgt), t_poses, t_poses_inv,
                               t_disps, t(K), sampler=sampler)
    losses["total"].backward()
    grads = [d.grad for f in t_disps for d in f] + [t_poses.grad,
                                                      t_poses_inv.grad]
    return losses, [g.double().numpy() for g in grads]


def _flat(jax_grads):
    g_disps, g_poses, g_poses_inv = jax_grads
    return [np.asarray(d, np.float64) for f in g_disps for d in f] + [
        np.asarray(g_poses, np.float64), np.asarray(g_poses_inv, np.float64)]


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_compute_losses_and_grads(jax_fns, name):
    """Losses at f32 against JAX at f32. Gradients: f32 resolves the
    gradient of this stack only to ~1e-2 relative L2 (its abs, clip and min
    kinks, and SSIM's cancelling local variances: JAX's own f32 gradient,
    run eagerly, is 8.3e-3 from its float64 one with the depth terms on,
    1.1e-4 under jit), so the port is held against JAX in float64 at 1e-6
    relative L2 per tensor, and its f32 gradient to within 2e-2 of that."""
    inputs = _inputs(5, num_scales=CONFIGS[name].get("num_scales", 1))
    losses_fn, grad_fn = jax_fns[name]
    ref = losses_fn(*_jax_args(inputs, jnp.float32))
    port, grads32 = _port(name, inputs)
    assert sorted(port) == sorted(ref)
    for k in ref:
        _close(port[k], ref[k], atol=3e-5)
    assert port["l_reconstruct_inverse"].item() > 0     # the guard let it through
    assert (port["l_depth"].item() > 0) == (name == "depth_consist")

    with jax.enable_x64(True):
        jax64 = _flat(grad_fn(*_jax_args(inputs, jnp.float64)))
    _, grads64 = _port(name, inputs, sampler=gs.grid_sample_plain,
                       dtype=torch.float64)
    for i, (p64, p32, ref64) in enumerate(zip(grads64, grads32, jax64)):
        assert _rel_l2(p64, ref64) <= 1e-6, i
        assert _rel_l2(p32, ref64) <= 2e-2, i


@pytest.mark.parametrize("name", ["default", "depth_consist"])
def test_source_depth_gradient(name):
    """The loss warp samples the source depth as the sampler's tail; its
    gradient (the d_img of grad_ch=(3,)) is 0 at the defaults, where the
    projected depth feeds nothing, and not 0 with the depth terms on."""
    seen = {}

    def sampler(img, coords, tail=None):
        if tail is not None:
            tail.register_hook(lambda g: seen.setdefault("d_tail", g))
            assert not img.requires_grad       # the image is data
        return gs.grid_sample(img, coords, tail)

    _port(name, _inputs(6), sampler=sampler)
    nonzero = seen["d_tail"].abs().max().item() > 0
    assert nonzero == (name == "depth_consist")
