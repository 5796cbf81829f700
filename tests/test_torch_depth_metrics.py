"""The port's depth metrics (``tcsfm_torch.eval.depth_metrics``) against the
JAX package's (``tcsfm.eval.depth_metrics``), on seeded arrays.

The port's module is a numpy copy, so everything is held bit for bit
(``assert_array_equal``, ``==`` on floats), with one exception: the JAX
package resizes through ``cv2.resize`` where cv2 imports and through its
numpy path otherwise, while the port keeps only the numpy path (cv2 is not
installed where the port runs). So the JAX side runs with cv2 hidden, as
``tests/test_eval.py::TestResizeParity`` hides it, and the port's resize
is also held within ``CV2_TOL`` = 1.3e-7 of ``cv2.resize`` itself, the
JAX package's measured figure (read 1.05e-7 to 1.20e-7 on the three
shapes with cv2 5.0 on an x86-64 CPU).
"""

import builtins
import sys

import numpy as np
import pytest

from tcsfm.eval import depth_metrics as jax_dm
from tcsfm_torch.eval import depth_metrics as dm
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CV2_TOL = 1.3e-7
RESIZE_SHAPES = [((192, 640), (375, 1242)), ((128, 448), (370, 1224)),
                 ((375, 1242), (192, 640))]


@pytest.fixture
def no_cv2(monkeypatch):
    """Hide cv2 from imports, so the JAX package takes its numpy resize."""
    real_import = builtins.__import__

    def hide(name, *a, **k):
        if name == "cv2":
            raise ImportError("hidden: the numpy resize path")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", hide)


def depth_pair(seed, shape=(96, 160), scale=20.0):
    rng = np.random.RandomState(seed)
    gt = (rng.rand(*shape) * scale + 0.5).astype(np.float32)
    gt[rng.rand(*shape) < 0.3] = 0.0                  # sparse like velodyne
    pred = (gt * (0.8 + 0.4 * rng.rand(*shape)) + 0.1).astype(np.float32)
    return gt, pred


def test_compute_depth_errors_equal():
    gt, pred = depth_pair(0)
    v = gt > 0
    assert dm.compute_depth_errors(gt[v], pred[v]) == \
        jax_dm.compute_depth_errors(gt[v], pred[v])


@pytest.mark.parametrize("shape", [(375, 1242), (370, 1224), (64, 96)])
def test_eigen_crop_mask_equal(shape):
    gt, _ = depth_pair(1, shape, scale=100.0)
    np.testing.assert_array_equal(dm.eigen_crop_mask(gt),
                                  jax_dm.eigen_crop_mask(gt))


@pytest.mark.parametrize("shape_in,shape_out", RESIZE_SHAPES)
def test_resize_equals_jax_numpy_path(shape_in, shape_out, no_cv2):
    img = np.random.RandomState(3).rand(*shape_in).astype(np.float32)
    got = dm._resize_bilinear(img, *shape_out)
    want = jax_dm._resize_bilinear(img, *shape_out)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def real_cv2():
    """The installed cv2, also where another test module has put a stub in
    ``sys.modules`` (``tests/test_reference_parity.py`` does, at import, for
    the reference's imports); the stub is put back after."""
    mp = pytest.MonkeyPatch()
    if not hasattr(sys.modules.get("cv2"), "resize"):
        mp.delitem(sys.modules, "cv2", raising=False)
    try:
        cv2 = pytest.importorskip("cv2")
    finally:
        mp.undo()
    return cv2


@pytest.mark.parametrize("shape_in,shape_out", RESIZE_SHAPES)
def test_resize_within_cv2_rounding(shape_in, shape_out, real_cv2):
    cv2 = real_cv2
    img = np.random.RandomState(3).rand(*shape_in).astype(np.float32)
    err = np.abs(dm._resize_bilinear(img, *shape_out)
                 - cv2.resize(img, (shape_out[1], shape_out[0]))).max()
    print(f"{shape_in} -> {shape_out}: max |numpy - cv2| {err:.3e}")
    assert err <= CV2_TOL


def test_the_port_never_calls_cv2(monkeypatch):
    """The port's resize gives the same bits whether cv2 imports or not."""
    img = np.random.RandomState(4).rand(48, 80).astype(np.float32)
    with_cv2 = dm._resize_bilinear(img, 75, 124)
    real_import = builtins.__import__

    def hide(name, *a, **k):
        if name == "cv2":
            raise AssertionError("the port imported cv2")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", hide)
    np.testing.assert_array_equal(dm._resize_bilinear(img, 75, 124), with_cv2)


@pytest.mark.parametrize("median_scaling", [True, False])
@pytest.mark.parametrize("benchmark", ["eigen", "other"])
def test_evaluate_eigen_equal(median_scaling, benchmark, no_cv2):
    rng = np.random.RandomState(5)
    disps = [(0.05 + rng.rand(24, 80)).astype(np.float32) for _ in range(3)]
    gts = [depth_pair(10 + i, (75, 248), scale=70.0)[0] for i in range(3)]
    got = dm.evaluate_eigen(disps, gts, median_scaling, benchmark)
    want = jax_dm.evaluate_eigen(disps, gts, median_scaling, benchmark)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k


def test_scannet_metrics_equal():
    gt, pred = depth_pair(6, (48, 64), scale=9.0)
    gt = gt / 2.0
    assert dm.scale_invariant(gt, pred) == jax_dm.scale_invariant(gt, pred)
    assert dm.compute_scaling_factor(gt, pred) == \
        jax_dm.compute_scaling_factor(gt, pred)
    assert dm.compute_depth_errors_scannet(gt, pred) == \
        jax_dm.compute_depth_errors_scannet(gt, pred)
    lists = [list(depth_pair(s, (48, 64), scale=9.0)) for s in (7, 8)]
    gl, pl = [g for g, _ in lists], [p for _, p in lists]
    assert dm.compute_depth_errors_scannet(gl, pl) == \
        jax_dm.compute_depth_errors_scannet(gl, pl)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deepv2d_pose_errors_equal(seed):
    from tcsfm_torch.eval.trajectory import np_se3_exp

    rng = np.random.RandomState(seed)
    xi_gt = np.concatenate([rng.randn(3) * 0.3, rng.randn(3) * 0.05])
    xi_pr = xi_gt + np.concatenate([rng.randn(3) * 0.03,
                                    rng.randn(3) * 0.005])
    gt, pr = np_se3_exp(xi_gt), np_se3_exp(xi_pr)
    assert dm.compute_pose_errors_deepv2d(gt, pr) == \
        jax_dm.compute_pose_errors_deepv2d(gt, pr)
