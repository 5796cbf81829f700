"""Port geometry (tcsfm_torch.geom, .utils) against the JAX package's, on CPU.

The same numpy-seeded float32 inputs go through both; tolerance atol 1e-5
(f32 arithmetic in a different operation order: small matmuls, trig).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcsfm.geom import camera as jcam
from tcsfm.geom import se3 as jse3
from tcsfm.geom import warp as jwarp
from tcsfm.utils import helpers as jhelpers
from tcsfm_torch.geom import camera, se3, warp
from tcsfm_torch.ops.grid_sample import grid_sample_plain
from tcsfm_torch.utils import helpers
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
B, H, W = 2, 16, 24


def _K(b=B, h=H, w=W):
    K = np.array([[0.6 * w, 0.3, w / 2], [0, 0.55 * w, h / 2.5], [0, 0, 1]],
                 np.float32)
    return np.broadcast_to(K, (b, 3, 3)).copy()


def _rand(shape, seed, lo=0.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(np.float32)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                               rtol=0)


def test_pixel_grid():
    _close(camera.pixel_grid(H, W), jcam.pixel_grid(H, W), atol=0)


def test_inv_intrinsics():
    K = _K()
    _close(camera.inv_intrinsics(torch.from_numpy(K)), jcam.inv_intrinsics(K))
    _close(camera.inv_intrinsics(torch.from_numpy(K)) @ torch.from_numpy(K),
           np.broadcast_to(np.eye(3), (B, 3, 3)))


@pytest.mark.parametrize("with_channel", [False, True])
def test_backproject(with_channel):
    depth = _rand((B, H, W, 1) if with_channel else (B, H, W), 1, 0.3, 2.0)
    K = _K()
    _close(camera.backproject(torch.from_numpy(depth), torch.from_numpy(K)),
           jcam.backproject(jnp.asarray(depth), jnp.asarray(K)))


def test_project():
    pts = _rand((B, 3, H * W), 2, -1.0, 1.0)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.5
    pts[0, 2, :5] = -0.2                  # behind the camera: Z clamps at eps
    K = _K()
    c_port, z_port = camera.project(torch.from_numpy(pts), torch.from_numpy(K),
                                    H, W)
    c_ref, z_ref = jcam.project(jnp.asarray(pts), jnp.asarray(K), H, W)
    _close(z_port, z_ref)
    # x/z with z = 1e-3 reaches ~1e4: compare relative to the magnitude
    np.testing.assert_allclose(c_port.numpy(), np.asarray(c_ref), rtol=1e-5,
                               atol=ATOL)


@pytest.mark.parametrize("fn", ["euler2mat", "quat2mat"])
def test_rotations(fn):
    ang = _rand((5, 3), 3, -0.6, 0.6)
    _close(getattr(se3, fn)(torch.from_numpy(ang)),
           getattr(jse3, fn)(jnp.asarray(ang)))


@pytest.mark.parametrize("mode", ["euler", "quat"])
@pytest.mark.parametrize("fn", ["pose_vec2mat", "pose_vec2mat44"])
def test_pose_vec2mat(fn, mode):
    vec = _rand((4, 6), 4, -0.3, 0.3)
    _close(getattr(se3, fn)(torch.from_numpy(vec), mode),
           getattr(jse3, fn)(jnp.asarray(vec), mode))


def test_pose_vec2mat_rejects_unknown_mode():
    with pytest.raises(ValueError):
        se3.pose_vec2mat(torch.zeros(1, 6), "axis_angle")


def test_disp_depth_round_trip():
    disp = _rand((B, H, W, 1), 5)
    sd_p, d_p = helpers.disp_to_depth(torch.from_numpy(disp), 0.06, 80 / 30)
    sd_r, d_r = jhelpers.disp_to_depth(jnp.asarray(disp), 0.06, 80 / 30)
    _close(sd_p, sd_r)
    _close(d_p, d_r, atol=0)
    _close(helpers.depth_to_disp(d_p, 0.06, 80 / 30),
           jhelpers.depth_to_disp(d_r, 0.06, 80 / 30))


def _warp_inputs(seed, pose_scale):
    rng = np.random.RandomState(seed)
    depth = rng.uniform(0.3, 2.0, (B, H, W, 1)).astype(np.float32)
    pose = (rng.uniform(-1, 1, (B, 6)) * pose_scale).astype(np.float32)
    return depth, pose, _K()


@pytest.mark.parametrize("pose_scale", [0.02, 0.3])
def test_project_with_mask(pose_scale):
    """Coords (with the OOB push to 2.0), computed depth and valid mask;
    pose_scale 0.3 pushes a large share of pixels out of view."""
    depth, pose, K = _warp_inputs(6, pose_scale)
    cam_p = camera.backproject(torch.from_numpy(depth), torch.from_numpy(K))
    cam_r = jcam.backproject(jnp.asarray(depth), jnp.asarray(K))
    c_p, z_p, v_p = warp._project_with_mask(
        cam_p, torch.from_numpy(K), se3.pose_vec2mat(torch.from_numpy(pose)),
        H, W)
    c_r, z_r, v_r = jwarp._project_with_mask(
        cam_r, jnp.asarray(K), jse3.pose_vec2mat(jnp.asarray(pose)), H, W)
    _close(c_p, c_r)
    _close(z_p, z_r)
    np.testing.assert_array_equal(v_p.numpy(), np.asarray(v_r))
    if pose_scale > 0.1:
        assert 0 < (c_p == 2.0).float().mean() < 1


@pytest.mark.parametrize("pose_scale", [0.02, 0.3])
@pytest.mark.parametrize("sample_depth", [True, False])
def test_inverse_warp2(pose_scale, sample_depth):
    depth, pose, K = _warp_inputs(7, pose_scale)
    img = _rand((B, H, W, 3), 8)
    ref_depth = _rand((B, H, W, 1), 9, 0.3, 2.0)
    port = warp.inverse_warp2(
        torch.from_numpy(img), torch.from_numpy(depth),
        torch.from_numpy(ref_depth), torch.from_numpy(pose),
        torch.from_numpy(K), sample_depth=sample_depth)
    ref = jwarp.inverse_warp2(jnp.asarray(img), jnp.asarray(depth),
                              jnp.asarray(ref_depth), jnp.asarray(pose),
                              jnp.asarray(K))
    for i, (p, r) in enumerate(zip(port, ref)):
        if i == 2 and not sample_depth:
            assert p is None
        else:
            assert tuple(p.shape) == r.shape
            _close(p, r)


def test_inverse_warp2_plain_sampler_is_default_on_cpu():
    depth, pose, K = _warp_inputs(10, 0.05)
    img = _rand((B, H, W, 3), 11)
    args = [torch.from_numpy(a) for a in (img, depth, depth, pose, K)]
    a = warp.inverse_warp2(*args)
    b = warp.inverse_warp2(*args, sampler=grid_sample_plain)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
