"""DNet ground-plane scale recovery (tcsfm_torch.eval.scale_recovery)
against the JAX package's, on CPU.

* The synthetic sequence's depths (a ground plane under a far wall) and a
  smooth random depth, f32: the normals, the ground mask and the scale
  against JAX's (normals within 1e-5, the mask equal where JAX's normal
  is not within 1e-5 of the 5-degree threshold, the scale within 1e-5
  relative).
* A ground plane built analytically at a known camera height gives the
  scale real / height (1e-6 relative in f32, 1e-12 in float64).
* No pixel below the camera: an empty ground mask gives a scale of 0 on
  both sides (the masked median's k-th entry is +inf), as does a masked
  median over nothing.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcsfm_torch.data.synthetic import make_synthetic_sequence
from tcsfm_torch.eval import scale_recovery as sr
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# tcsfm.eval's __init__ binds the name scale_recovery to the function
jax_sr = importlib.import_module("tcsfm.eval.scale_recovery")

H, W = 48, 80
REAL = 1.70 / 30.0


def _K(cy, f=40.0):
    return np.array([[f, 0, W / 2], [0, f, cy], [0, 0, 1]], np.float32)


def _depths():
    seq = make_synthetic_sequence(4, (H, W), seed=5)
    smooth = np.random.RandomState(0).uniform(0.5, 2.0, (2, 6, 10))
    smooth = torch.nn.functional.interpolate(
        torch.from_numpy(smooth)[:, None], size=(H, W), mode="bilinear",
        align_corners=True)[:, 0].numpy().astype(np.float32)
    return [("synthetic", seq.depths[:2].astype(np.float32),
             seq.intrinsics[:2].astype(np.float32)),
            ("smooth", smooth, np.stack([_K(H / 2.5)] * 2))]


@pytest.mark.parametrize("case", range(2))
def test_scale_recovery_matches_jax(case):
    _, depth, K = _depths()[case]
    pts_j = np.asarray(jax_sr.backproject(jnp.asarray(depth), jnp.asarray(K))
                       ).reshape(2, 3, H, W).transpose(0, 2, 3, 1)
    n_j = np.asarray(jax_sr.surface_normals(jnp.asarray(pts_j)))
    m_j = np.asarray(jax_sr.ground_mask(jnp.asarray(pts_j), jnp.asarray(n_j)))
    pts = torch.from_numpy(np.ascontiguousarray(pts_j))
    n = sr.surface_normals(pts)
    np.testing.assert_allclose(n.numpy(), n_j, atol=1e-5, rtol=0)
    m = sr.ground_mask(pts, torch.from_numpy(np.array(n_j))).numpy()
    thr = math.cos(math.radians(5.0))
    decided = np.abs(np.abs(n_j[..., 1]) - thr) > 1e-5
    np.testing.assert_array_equal(m[decided], m_j[decided])
    assert m_j.any()
    ref = float(jax_sr.scale_recovery(jnp.asarray(depth), jnp.asarray(K), REAL))
    got = sr.scale_recovery(torch.from_numpy(depth), torch.from_numpy(K),
                            REAL).item()
    assert ref > 0 and got == pytest.approx(ref, rel=1e-5, abs=0)
    # [B, H, W, 1] depths too
    got4 = sr.scale_recovery(torch.from_numpy(depth)[..., None],
                             torch.from_numpy(K), REAL).item()
    assert got4 == got


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-12)])
def test_ground_plane_at_a_known_height(dtype, tol):
    """Every row below the horizon (cy above the image): the plane Y =
    height, depth z = height * fy / (y - cy); every pixel is ground and
    sits at the camera height, so the scale is real / height."""
    height, K = 0.05, _K(-10.0)
    ys = np.arange(H, dtype=np.float64)[:, None].repeat(W, 1)
    depth = height * K[1, 1] / (ys - K[1, 2])
    depth = torch.from_numpy(np.stack([depth, depth])).to(dtype)
    Kt = torch.from_numpy(np.stack([K, K])).to(dtype)
    got = sr.scale_recovery(depth, Kt, REAL).item()
    assert got == pytest.approx(REAL / height, rel=tol, abs=0)


def test_no_ground_gives_zero():
    """cy below the image: every point lies above the camera (Y < 0)."""
    K = np.stack([_K(H + 10.0)] * 2)
    depth = np.full((2, H, W), 1.3, np.float32)
    ref = float(jax_sr.scale_recovery(jnp.asarray(depth), jnp.asarray(K), REAL))
    got = sr.scale_recovery(torch.from_numpy(depth), torch.from_numpy(K),
                            REAL).item()
    assert ref == 0.0 and got == 0.0
    v = torch.arange(6.0)
    assert sr.masked_median(v, torch.zeros(6, dtype=torch.bool)).item() \
        == math.inf


@pytest.mark.parametrize("n_valid", [1, 2, 5, 6])
def test_masked_median_is_the_lower_median(n_valid):
    rng = np.random.RandomState(n_valid)
    v = rng.rand(4, 5).astype(np.float32)
    mask = np.zeros(20, bool)
    mask[rng.choice(20, n_valid, replace=False)] = True
    mask = mask.reshape(4, 5)
    ref = float(jax_sr.masked_median(jnp.asarray(v), jnp.asarray(mask)))
    got = sr.masked_median(torch.from_numpy(v), torch.from_numpy(mask)).item()
    assert got == ref == float(torch.from_numpy(v)[torch.from_numpy(mask)]
                               .median())
