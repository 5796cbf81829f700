"""PFT in bfloat16 on bfloat16 leaves: the port's 'depth_pred' mode (the
1/4-resolution disparities trained) here, and 'bottleneck' mode (the two
deepest skips trained) in ``test_torch_bf16_pft_bottleneck.py`` with these
checks, each against the JAX package's bfloat16 ``PFTOptimizer``, on the
CPU, over a whole window (one JAX program a file).

The setting, the runs and the rule are ``bf16_pft_harness.py``'s (one
window at 64x96, B=2, S=2, 2 iterations, 3 epochs, ``avg_final_epochs``
2: two Adam steps, since optax's bfloat16 moments part from torch's Adam
from the second on), the bounds those of ``test_torch_bf16_pft.py``:
loss terms at 10 x, gradient directions and update signs at 2 x, the window at 3 x the larger
of JAX's bfloat16-vs-float32 gap and the port's one-ulp spread, each with
its planted fault; the gap read against the port's float32 window, which
in these modes equals JAX's float32 window far below the gap (the gaps
read against either agreed to three digits in both modes; JAX's float32
window costs another ~30 s of XLA compile a mode). Here the trained
tensors are bfloat16 activations, as
in JAX: their gradients and Adam's moments are bfloat16, and an lr-sized
step on a value above ~0.06 rounds away (2e-4 is under half a bfloat16
ulp there), so the share of updates that survive is held too: which
elements' updates round away differs from JAX's on no more than 2 x the
port's own spread of it (planted fault: no update rounds away).

Readings (parity / gap / spread), 'depth_pred': loss total 8.79e-4 /
2.35e-3 / 2.02e-4, depth_consist 4.33e-3 / 1.10e-4 / 7.68e-4 (5.6 x: one
reading of a masked mean), disparity gradient 1 - cos 2.83e-2 / 2.98e-2 /
5.22e-2, update signs 2.95% against a spread of 4.50% (34.2% of JAX's
updates round away), window losses 1.15e-3 / 2.51e-3 / 1.57e-3, poses
2.27e-2 / 3.92e-2 / 3.44e-2, disparity 4.77e-3 / 4.36e-3 / 3.78e-3 (the
flip-merge reads the untouched net in this mode); which disparity updates
round away differs from JAX's on 0.52% of the elements, the port's spread
0.52%. 'bottleneck': skip
gradients 1 - cos 1.91e-2 / 2.93e-2 / 2.83e-2 (s3) and 1.40e-2 / 2.05e-2
/ 2.09e-2 (s4), update signs 2.97% and 2.78% against 4.72% and 3.81%
(60.5% and 64.7% round away; 0.23% and 0.24% other than JAX's, spread
0.21% and 0.26%), window losses 2.70e-3 / 1.50e-3 / 3.58e-3,
poses 4.28e-2 / 5.51e-2 / 4.70e-2.
"""

import pytest

import bf16_pft_harness as h
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


EPOCHS, AVG_FINAL_EPOCHS = 3, 2


@pytest.fixture(scope="module", params=["depth_pred"])
def runs(request):
    return h.mode_runs(request.param, EPOCHS, AVG_FINAL_EPOCHS,
                       *h.weights(), h.window())


def test_first_step_losses(runs):
    h.assert_first_step_losses(runs)


def test_first_step_gradients(runs):
    h.assert_first_step_gradients(runs)


def test_first_updates_and_what_rounds_away(runs):
    h.assert_first_updates(runs)


def test_window(runs):
    h.assert_window(runs)


def test_leaves_gradients_and_moments_are_bfloat16(runs):
    """The trained leaves are bfloat16 in both packages, and so are their
    gradients and optimizer moments (optax keeps a leaf's dtype)."""
    jax_rec, port_rec = runs["jax"][1], runs["port"][1]
    assert jax_rec.dtypes["grad"] == {"bfloat16"}
    assert jax_rec.dtypes["moments"] == {"bfloat16", "int32"}
    assert port_rec.dtypes["grad"] == {"torch.bfloat16"}
    assert port_rec.dtypes["moments"] == {"torch.bfloat16"}
