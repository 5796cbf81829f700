"""The port's Gauss-Newton and bundle-adjustment refiners against the JAX
package's, on CPU (the JAX side on its XLA path, ``use_mxu_warp=False``).

Scenes: ``make_synthetic_sequence`` at 64x96, ground-truth twists
perturbed as tests/test_ba.py perturbs them, <= 5 LM iterations. Each
JAX refiner runs once per module (module-scoped fixtures).
``chain_ba`` and its pieces: tests/test_torch_chain_ba.py.

Compared: poses, depths, per-iteration costs, the accept decisions that
the costs imply (a step was accepted iff the cost fell), and the
information blocks. Limits, each near its measured gap (same arithmetic,
other f32 summation orders; the ceiling tests/test_ba.py allows between
the Pallas and XLA residuals is 2e-4/3e-4 on poses):
* poses atol 1e-6 (measured <= 2e-7);
* depths 5e-5 of the largest depth (measured <= 1.7e-5: the depth step
  divides by H_dd, which on textureless pixels is little more than the
  prior weight 0.1, so residual rounding reaches the depth amplified);
* costs rtol 5e-5 (sums of ~18k squared residuals; measured <= 2.9e-5,
  at costs near convergence, where the residuals are small);
* GN step norms 5e-5 of the largest (measured 2.1e-5);
* information blocks 5e-5 of their largest entry (a Schur complement
  subtracts terms of nearly equal size; measured <= 1.5e-5).
Decisions: every cost that moved fell by >= 1e-3 of itself on both
sides, a margin far above the 5e-5 at which the two sides' costs agree,
so no decision sits on a tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcsfm.data.dataset import relative_lie_alg
from tcsfm.data.synthetic import make_synthetic_sequence
from tcsfm.solver import ba as jba
from tcsfm.solver import gauss_newton as jgn
from tcsfm_torch.ops import grid_sample as gs
from tcsfm_torch.solver import ba as tba
from tcsfm_torch.solver import gauss_newton as tgn
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

POSE_ATOL = 1e-6
DEPTH_REL = 5e-5
COST_RTOL = 5e-5
INFO_REL = 5e-5
MARGIN = 1e-3


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(ours, ref, limit):
    ours, ref = _np(ours), _np(ref)
    err = np.abs(ours - ref).max() / np.abs(ref).max()
    assert err <= limit, f"{err} > {limit} of the largest magnitude"


def _costs(ours, ref):
    """Per-iteration costs [iters+1, ...] and the decisions they imply."""
    ours, ref = _np(ours), _np(ref)
    np.testing.assert_allclose(ours, ref, rtol=COST_RTOL, atol=0)
    for c in (ours, ref):
        fell = c[1:] < c[:-1]
        assert np.array_equal(fell, ~(c[1:] == c[:-1])), "a cost rose"
        drop = (c[:-1] - c[1:])[fell] / c[:-1][fell]
        assert (drop >= MARGIN).all(), f"an accepted step fell by {drop.min()}"
    assert np.array_equal(ours[1:] < ours[:-1], ref[1:] < ref[:-1])


def _pair(seed, t=1, s=2):
    seq = make_synthetic_sequence(4, (64, 96), seed=seed)
    xi = relative_lie_alg(seq.gt_poses[t], seq.gt_poses[s])
    return [np.asarray(a, np.float32) for a in (
        xi[None], seq.images[t][None], seq.images[s][None],
        seq.depths[t][None, ..., None], seq.depths[s][None, ..., None],
        seq.intrinsics[t][None])]


def _jax(fn, *args, **kw):
    return fn(*map(jnp.asarray, args), **kw)


# -- gauss_newton_pose -----------------------------------------------------


@pytest.fixture(scope="module")
def gn():
    xi, tgt, src, d_t, d_s, K = _pair(21)
    args = (xi + np.float32([0, 0, 0.01, 0, 0.004, 0]), tgt, src, d_t, d_s, K)
    return (_jax(jgn.gauss_newton_pose, *args, iters=5),
            tgn.gauss_newton_pose(*args, iters=5, device="cpu"))


def test_gauss_newton_pose_matches_jax(gn):
    ref, ours = gn
    np.testing.assert_allclose(_np(ours.pose), _np(ref.pose), atol=POSE_ATOL,
                               rtol=0)
    _costs(ours.cost, ref.cost)
    _rel(ours.delta_norm, ref.delta_norm, 5e-5)
    assert ours.cost[-1, 0] < 0.9 * ours.cost[0, 0]


# -- photometric_ba --------------------------------------------------------


@pytest.fixture(scope="module")
def pba():
    xi, tgt, src, d_t, d_s, K = _pair(26)
    args = (xi + np.float32([0, 0, 0.006, 0, 0, 0]), d_t * 1.1, tgt, src,
            d_s, K)
    kw = dict(iters=5, depth_prior_weight=0.1)
    return (_jax(jba.photometric_ba, *args, **kw),
            tba.photometric_ba(*args, **kw, device="cpu"))


def test_photometric_ba_matches_jax(pba):
    ref, ours = pba
    np.testing.assert_allclose(_np(ours.pose), _np(ref.pose), atol=POSE_ATOL,
                               rtol=0)
    _rel(ours.depth, ref.depth, DEPTH_REL)
    _costs(ours.cost, ref.cost)
    _rel(ours.pose_info, ref.pose_info, INFO_REL)
    assert ours.cost[-1, 0] < 0.6 * ours.cost[0, 0]


# -- fuse_pose_estimates / sequence_ba -------------------------------------


def test_fuse_pose_estimates_matches_jax():
    rng = np.random.RandomState(4)
    a, b = rng.randn(2, 3, 6, 6).astype(np.float32)
    info_f = a @ a.transpose(0, 2, 1) + np.eye(6, dtype=np.float32)
    info_i = b @ b.transpose(0, 2, 1) + np.eye(6, dtype=np.float32)
    xf, xi = rng.randn(2, 3, 6).astype(np.float32)
    args = (xf, info_f, xi, info_i)
    ours = tba.fuse_pose_estimates(*map(torch.from_numpy, args))
    _rel(ours, _jax(jba.fuse_pose_estimates, *args), 1e-5)
    # equal information: the reference's unweighted (fwd - inv) / 2
    same = tba.fuse_pose_estimates(*map(torch.from_numpy,
                                        (xf, info_f, xi, info_f)))
    np.testing.assert_allclose(same.numpy(), (xf - xi) / 2, atol=1e-5)


@pytest.fixture(scope="module")
def seq_ba():
    seq = make_synthetic_sequence(4, (64, 96), seed=31)
    fwd = np.stack([relative_lie_alg(seq.gt_poses[i], seq.gt_poses[i + 1])
                    for i in range(3)]).astype(np.float32)
    inv = np.stack([relative_lie_alg(seq.gt_poses[i + 1], seq.gt_poses[i])
                    for i in range(3)]).astype(np.float32)
    rng = np.random.RandomState(0)
    args = (seq.images.astype(np.float32),
            seq.depths[..., None].astype(np.float32),
            seq.intrinsics[0].astype(np.float32),
            fwd + 0.004 * rng.randn(3, 6).astype(np.float32),
            inv + 0.004 * rng.randn(3, 6).astype(np.float32))
    kw = dict(iters=3, depth_prior_weight=0.1)
    return (_jax(jba.sequence_ba, *args, **kw),
            tba.sequence_ba(*args, **kw, device="cpu"))


def test_sequence_ba_matches_jax(seq_ba):
    ref, ours = seq_ba
    np.testing.assert_allclose(_np(ours.fused_pose), _np(ref.fused_pose),
                               atol=POSE_ATOL, rtol=0)
    for part in ("fwd", "inv"):
        o, r = getattr(ours, part), getattr(ref, part)
        np.testing.assert_allclose(_np(o.pose), _np(r.pose), atol=POSE_ATOL,
                                   rtol=0)
        _rel(o.depth, r.depth, DEPTH_REL)
        _costs(o.cost, r.cost)
        _rel(o.pose_info, r.pose_info, INFO_REL)


# -- window_ba -------------------------------------------------------------


@pytest.fixture(scope="module")
def win():
    seq = make_synthetic_sequence(4, (64, 96), seed=28)
    t = 1
    xi_p = relative_lie_alg(seq.gt_poses[t], seq.gt_poses[t - 1])
    xi_n = relative_lie_alg(seq.gt_poses[t], seq.gt_poses[t + 1])
    args = [np.asarray(a, np.float32) for a in (
        xi_p[None] + np.float32([0, 0, 0.005, 0, 0, 0]),
        xi_n[None] - np.float32([0, 0, 0.005, 0, 0, 0]),
        seq.depths[t][None, ..., None] * 1.1, seq.images[t][None],
        seq.images[t - 1][None], seq.images[t + 1][None],
        seq.depths[t - 1][None, ..., None], seq.depths[t + 1][None, ..., None],
        seq.intrinsics[t][None])]
    kw = dict(iters=5, depth_prior_weight=0.1)
    return (_jax(jba.window_ba, *args, **kw),
            tba.window_ba(*args, **kw, device="cpu"), args)


def test_window_ba_matches_jax(win):
    ref, ours, _ = win
    for k in ("pose_prev", "pose_next"):
        np.testing.assert_allclose(_np(getattr(ours, k)), _np(getattr(ref, k)),
                                   atol=POSE_ATOL, rtol=0)
    _rel(ours.depth, ref.depth, DEPTH_REL)
    _costs(ours.cost, ref.cost)
    for k in ("S_aa", "S_ab", "S_bb"):
        _rel(getattr(ours, k), getattr(ref, k), INFO_REL)
    assert ours.cost[-1, 0] < 0.6 * ours.cost[0, 0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_window_ba_solves_in_f32(win, dtype):
    """bf16 or float64 inputs give the f32 solve (``_f32``): the same
    result as the f32 inputs they round to."""
    _, _, args = win
    cast = [torch.from_numpy(a).to(dtype) for a in args]
    rounded = [c.float() for c in cast]
    kw = dict(iters=2, depth_prior_weight=0.1, device="cpu")
    res = tba.window_ba(*cast, **kw)
    ref = tba.window_ba(*rounded, **kw)
    assert res.depth.dtype == torch.float32
    for a, b in zip(res, ref):
        assert torch.equal(a, b)


# -- entry points ----------------------------------------------------------


def test_refiners_need_a_card_unless_cpu(monkeypatch, win):
    """device=None means the card, and raises where there is none; the CPU
    path launches no kernel."""
    _, _, args = win
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tba.window_ba(*args, iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgn.gauss_newton_pose(args[0], args[3], args[4], args[2], args[6],
                              args[8], iters=1)
    before = (gs.LAUNCHES, gs.LAUNCHES_FWD_GRADS)
    res = tba.window_ba(*args, iters=1, device="cpu")
    assert (gs.LAUNCHES, gs.LAUNCHES_FWD_GRADS) == before
    assert torch.isfinite(res.depth).all()
