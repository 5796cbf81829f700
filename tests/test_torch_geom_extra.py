"""The port's SE(3) maps, legacy ``inverse_warp`` and profiling hooks
against the JAX package's (``tcsfm.geom.se3``, ``tcsfm.geom.warp``,
``tcsfm.utils.profiling``), on the CPU, in f32.

SE(3)/SO(3): every function on 64 random vectors in three regimes of
theta: near 0 (1e-5, in the Taylor branch, and 5e-4, just outside it),
moderate (0.3-2.0) and near pi (pi - 1e-3). ``so3_log`` and ``se3_log``
skip the near-pi regime: JAX documents them for theta in [0, pi), where
the log's axis is ill-conditioned. Held within ``SE3_TOL`` = 2e-6
absolute (the same formulas in f32; measured up to 3.6e-7). The
gradients at theta = 0 are finite and equal JAX's (``tests/test_se3.py``
holds JAX to finite). ``se3_from_matrix`` on 64 rotations with 1e-2
noise (its SVD's signs may differ from JAX's; the product does not):
within ``SE3_TOL`` of JAX's (measured 8.9e-7), and R R^T within
``ORTHO_TOL`` = 1e-5 of the identity, the limit of
``tests/test_se3.py``'s own check (measured 2.0e-6).

``inverse_warp`` at 64x96, 3 channels, against JAX within ``WARP_TOL`` =
1e-5 (the valid masks equal), on a smooth image (a blurred random field
spread over [0, 1], as camera frames are smooth): a sampled value
carries the f32 rounding of its coordinate times the image's slope, and
on white noise (slopes up to 1 a pixel) the two packages read 1.4e-5
apart at 64x96. The port's kernel route and its plain sampler give the
same values on the CPU.
"""

import contextlib
import io
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from tcsfm.geom import se3 as jse3
from tcsfm.geom import warp as jwarp
from tcsfm_torch.geom import se3, warp
from tcsfm_torch.ops.grid_sample import grid_sample_plain
from tcsfm_torch.utils import profiling
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SE3_TOL = 2e-6
ORTHO_TOL = 1e-5
WARP_TOL = 1e-5
N = 64
REGIMES = {"tiny": (1e-5,), "small": (5e-4,), "moderate": (0.3, 2.0),
           "near_pi": (math.pi - 1e-3,)}


def rotvecs(regime, seed):
    rng = np.random.RandomState(seed)
    axis = rng.randn(N, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    bounds = REGIMES[regime]
    theta = rng.uniform(bounds[0], bounds[-1], (N, 1))
    return (axis * theta).astype(np.float32)


def xis(regime, seed):
    rho = np.random.RandomState(seed + 100).randn(N, 3).astype(np.float32)
    return np.concatenate([rho, rotvecs(regime, seed)], 1)


def close(ours, ref, tol=SE3_TOL, what=""):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    err = np.abs(ours - np.asarray(ref)).max()
    print(f"{what}: {err:.3e}")
    assert err <= tol, (what, err)


def t(x):
    return torch.from_numpy(np.asarray(x))


def jitted(fn):
    """A JAX function compiled once (its eager call compiles every
    operation on its own)."""
    return jax.jit(fn)


@pytest.mark.parametrize("regime", list(REGIMES))
def test_exp_maps_match_jax(regime):
    phi, xi = rotvecs(regime, 1), xis(regime, 2)
    ref = jitted(lambda p, x: (
        jse3.skew(p), jse3.so3_exp(p), jse3._left_jacobian(p),
        jse3._left_jacobian_inv(p), jse3.se3_exp(x),
        jse3.se3_inv(jse3.se3_exp(x))))(phi, xi)
    close(se3.skew(t(phi)), ref[0], 0, "skew")
    close(se3.so3_exp(t(phi)), ref[1], what=f"so3_exp {regime}")
    close(se3._left_jacobian(t(phi)), ref[2], what=f"left Jacobian {regime}")
    close(se3._left_jacobian_inv(t(phi)), ref[3],
          what=f"left Jacobian inverse {regime}")
    T = se3.se3_exp(t(xi))
    close(T, ref[4], what=f"se3_exp {regime}")
    close(se3.se3_inv(T), jitted(jse3.se3_inv)(T.numpy()),
          what=f"se3_inv {regime}")


@pytest.mark.parametrize("regime", ["tiny", "small", "moderate"])
def test_log_maps_match_jax(regime):
    R, T, phi, xi = jitted(lambda p, x: (
        jse3.so3_exp(p), jse3.se3_exp(x),
        jse3.so3_log(jse3.so3_exp(p)), jse3.se3_log(jse3.se3_exp(x))))(
        rotvecs(regime, 3), xis(regime, 4))
    close(se3.so3_log(t(R)), phi, what=f"so3_log {regime}")
    close(se3.se3_log(t(T)), xi, what=f"se3_log {regime}")


@pytest.mark.parametrize("fn,n", [("so3_exp", 3), ("se3_exp", 6),
                                  ("_left_jacobian_inv", 3)])
def test_gradient_finite_at_zero(fn, n):
    x = torch.zeros(n, requires_grad=True)
    (g,) = torch.autograd.grad(getattr(se3, fn)(x).sum(), x)
    ref = jitted(jax.grad(lambda p: jnp.sum(getattr(jse3, fn)(p))))(
        jnp.zeros(n))
    assert torch.isfinite(g).all()
    close(g, ref, what=f"d {fn} at 0")


def test_from_matrix_matches_jax():
    T = np.array(jitted(jse3.se3_exp)(xis("moderate", 5)))
    T[:, :3, :3] += 1e-2 * np.random.RandomState(6).randn(N, 3, 3)
    ours = se3.se3_from_matrix(t(T))
    close(ours, jitted(jse3.se3_from_matrix)(T), what="from_matrix")
    R = ours[:, :3, :3]
    close(R @ R.transpose(1, 2), np.broadcast_to(np.eye(3), (N, 3, 3)),
          ORTHO_TOL, "orthogonality")
    assert se3.se3_from_matrix(t(T), normalize=False) is not None
    np.testing.assert_array_equal(
        se3.se3_from_matrix(t(T), normalize=False).numpy(), T)


@pytest.mark.parametrize("depth_rank", [3, 4])
def test_inverse_warp_matches_jax(depth_rank):
    rng = np.random.RandomState(7)
    b, h, w = 2, 64, 96
    img = ndi.gaussian_filter(rng.rand(b, h, w, 3), (0, 2, 2, 0))
    img = ((img - img.min()) / (img.max() - img.min())).astype(np.float32)
    depth = (1.0 + rng.rand(b, h, w)).astype(np.float32)
    if depth_rank == 4:
        depth = depth[..., None]
    pose = np.concatenate([0.05 * rng.randn(b, 3), 0.02 * rng.randn(b, 3)],
                          1).astype(np.float32)
    K = np.tile(np.array([[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1]],
                         np.float32), (b, 1, 1))
    ours, valid = warp.inverse_warp(t(img), t(depth), t(pose), t(K))
    ref, ref_valid = jitted(jwarp.inverse_warp)(img, depth, pose, K)
    close(ours, ref, WARP_TOL, "inverse_warp")
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    assert 0 < valid.float().mean() < 1
    plain, _ = warp.inverse_warp(t(img), t(depth), t(pose), t(K),
                                 sampler=grid_sample_plain)
    torch.testing.assert_close(ours, plain, rtol=0, atol=0)


def test_profiling_hooks(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        torch.ones(8, 8) @ torch.ones(8, 8)
    path = os.path.join(logdir, "trace.json")
    assert os.path.getsize(path) > 0
    assert "aten::mm" in open(path).read()

    times = {}
    with contextlib.redirect_stdout(io.StringIO()) as out:
        with profiling.time_region("region", times):
            pass
    assert times["region"] >= 0 and "region" in out.getvalue()

    tree = {"a": torch.arange(4.0), "b": [torch.ones(2, 2),
                                          (torch.full((3,), 0.5),)]}
    assert profiling.force_completion(tree) == 6.0 + 4.0 + 1.5

    assert not torch.is_anomaly_enabled()
    try:
        profiling.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
