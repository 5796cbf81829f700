"""The port's PFT in 'depth_pred' mode against the JAX package's, in
float64: the one mode whose forward differs from the others. It trains
the 1/4-resolution disparities themselves, formed by a downsampling
resize of the initial disparities (``jax.image.resize`` "bilinear", which
antialiases: the port's ``F.interpolate(..., antialias=True)``) and
brought back to full resolution by an upsampling one at every step.

The setting, weights and limits are ``test_torch_pft_jax.py``'s (that
file's docstring gives them and their measured values). The flip-merged
disparity comes from the untouched network in this mode, so ``disp_hist``
does not move; the losses and the poses do. Measured on the CPU: 5.5e-8
(losses) and 5.1e-7 (poses) before the first update, 1.6e-7 (losses)
and 5.1e-7 (poses) after it.
"""

import pytest

from test_torch_pft_jax import TOL, assert_results_match, rel_delta, run_both


@pytest.fixture(scope="module")
def depth_pred_runs():
    return run_both("depth_pred")


def test_depth_pred_matches_jax_f64(depth_pred_runs):
    ref, port = depth_pred_runs
    assert_results_match(ref, port)


def test_depth_pred_trains_the_disparities(depth_pred_runs):
    _, port = depth_pred_runs
    assert rel_delta(port["disp_hist"][-1], port["disp_hist"][0]) == 0.0
    moved = rel_delta(port["poses_hist"][-1], port["poses_hist"][0])
    print(f"poses_hist: moved {moved:.3e} relative over the steps")
    assert moved > 20 * TOL
    assert abs(port["losses"][-1] - port["losses"][0]) > 1e-6
