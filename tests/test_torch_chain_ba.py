"""The port's ``chain_ba`` and its pieces against the JAX package's, on
CPU (the JAX side on its XLA path, ``use_mxu_warp=False``).

* ``block_tridiag_solve`` against a dense ``torch.linalg.solve`` of the
  assembled system and against JAX: atol 1e-5 (f32 6x6 solves);
* ``_scale_intrinsics``: exactly;
* ``_downsample`` (``F.interpolate(antialias=True)``) against
  ``jax.image.resize(method="linear", antialias=True)`` on white noise,
  borders included: atol 1e-6 (measured 1.8e-7);
* ``chain_ba`` on 5 frames at 64x96 with a 2-level pyramid: the limits of
  tests/test_torch_ba.py (edge poses atol 1e-6, costs rtol 5e-5 with the
  decisions they imply). Depths: 5e-5 of the largest depth against JAX on
  every pixel where JAX's f32 run is itself within that of a float64
  evaluation of the same algorithm, and on every pixel against that
  float64 evaluation (the port's own ``_chain_level`` in float64 with the
  plain sampler). Measured: one near-field pixel (depth 0.027) of JAX's
  f32 run is 9.1e-4 from float64, where the port is 1.1e-7 from it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcsfm.data.dataset import relative_lie_alg
from tcsfm.data.synthetic import make_synthetic_sequence
from tcsfm.solver import ba as jba
from tcsfm_torch.ops.grid_sample import grid_sample_plain
from tcsfm_torch.solver import ba as tba
from test_torch_ba import (COST_RTOL, DEPTH_REL, POSE_ATOL, _costs, _jax,
                           _np)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_block_tridiag_solve_matches_dense_and_jax():
    rng = np.random.RandomState(3)
    E = 5
    D = np.stack([a @ a.T + 6 * np.eye(6) for a in rng.randn(E, 6, 6)])
    U = 0.3 * rng.randn(E - 1, 6, 6)
    b = rng.randn(E, 6)
    H = np.zeros((6 * E, 6 * E))
    for i in range(E):
        H[6 * i:6 * i + 6, 6 * i:6 * i + 6] = D[i]
    for i in range(E - 1):
        H[6 * i:6 * i + 6, 6 * i + 6:6 * i + 12] = U[i]
        H[6 * i + 6:6 * i + 12, 6 * i:6 * i + 6] = U[i].T
    args = [a.astype(np.float32) for a in (D, U, b)]
    ours = tba.block_tridiag_solve(*map(torch.from_numpy, args)).numpy()
    dense = torch.linalg.solve(torch.from_numpy(H.astype(np.float32)),
                               torch.from_numpy(args[2].reshape(-1)))
    np.testing.assert_allclose(ours, dense.numpy().reshape(E, 6), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(ours, _np(_jax(jba.block_tridiag_solve, *args)),
                               atol=1e-5, rtol=0)


def test_scale_intrinsics_is_exact():
    K = np.float32([[[370.3, 0.2, 320.7], [0, 371.1, 96.4], [0, 0, 1]],
                    [[58.0, 0, 48.0], [0, 57.0, 25.6], [0, 0, 1]]])
    for s in (0.5, 0.25):
        ours = tba._scale_intrinsics(torch.from_numpy(K), s).numpy()
        assert np.array_equal(ours, _np(jba._scale_intrinsics(
            jnp.asarray(K), s)))


@pytest.mark.parametrize("factor", [2, 4])
def test_downsample_matches_jax_resize(factor):
    x = np.random.RandomState(factor).rand(3, 64, 96, 3).astype(np.float32)
    ours = tba._downsample(torch.from_numpy(x), factor).numpy()
    np.testing.assert_allclose(
        ours, _np(jba._downsample(jnp.asarray(x), factor)), atol=1e-6, rtol=0)


ITERS, COARSE_ITERS, PRIOR = 4, 3, 0.1


@pytest.fixture(scope="module")
def chain():
    seq = make_synthetic_sequence(5, (64, 96), seed=29)
    xi_prev = np.stack([relative_lie_alg(seq.gt_poses[t], seq.gt_poses[t - 1])
                        for t in range(1, 4)]).astype(np.float32)
    xi_next = np.stack([relative_lie_alg(seq.gt_poses[t], seq.gt_poses[t + 1])
                        for t in range(1, 4)]).astype(np.float32)
    rng = np.random.RandomState(3)
    args = (seq.images.astype(np.float32),
            seq.depths[..., None].astype(np.float32),
            seq.intrinsics[0].astype(np.float32),
            xi_prev + 0.004 * rng.randn(3, 6).astype(np.float32),
            xi_next + 0.004 * rng.randn(3, 6).astype(np.float32))
    kw = dict(iters=ITERS, depth_prior_weight=PRIOR, pyramid_levels=2,
              coarse_iters=COARSE_ITERS)
    return (_jax(jba.chain_ba, *args, **kw),
            tba.chain_ba(*args, **kw, device="cpu"), args)


def _chain_f64(frames, depths, K, pose0_prev, pose0_next):
    """``chain_ba``'s two levels in float64 (its ``_f32`` entry cast
    skipped), with the plain sampler, which takes float64."""
    frames, depths, K, pp, pn = (torch.from_numpy(a).double() for a in
                                 (frames, depths, K, pose0_prev, pose0_next))
    n_edges = frames.shape[0] - 1
    cnt = torch.zeros(n_edges, 1, dtype=torch.float64)
    cnt[:-1] += 1.0
    cnt[1:] += 1.0
    x0 = torch.zeros(n_edges, 6, dtype=torch.float64)
    x0[:-1] += -pp
    x0[1:] += pn
    common = (1e-2, 1e-2, PRIOR, True, grid_sample_plain)
    x0, _, _ = tba._chain_level(
        tba._downsample(frames, 2), tba._downsample(depths, 2),
        tba._scale_intrinsics(K, 0.5), x0 / cnt, COARSE_ITERS, *common)
    return tba._chain_level(frames, depths, K, x0, ITERS, *common)


def test_chain_ba_matches_jax(chain):
    ref, ours, args = chain
    np.testing.assert_allclose(_np(ours.edge_pose), _np(ref.edge_pose),
                               atol=POSE_ATOL, rtol=0)
    _costs(ours.cost, ref.cost)
    assert ours.cost[-1] < 0.6 * ours.cost[0]

    limit = DEPTH_REL * np.abs(_np(ref.depth)).max()
    _, depth64, cost64 = _chain_f64(*args)
    np.testing.assert_allclose(_np(ours.cost), cost64.numpy(), rtol=COST_RTOL)
    depth64 = depth64.numpy()
    assert np.abs(_np(ours.depth) - depth64).max() <= limit
    resolved = np.abs(_np(ref.depth) - depth64) <= limit
    assert resolved.mean() > 0.999
    err = np.abs(_np(ours.depth) - _np(ref.depth))[resolved]
    assert err.max() <= limit
