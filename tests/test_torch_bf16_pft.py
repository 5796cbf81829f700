"""PFT in bfloat16, the modes that train weights: the port's
``PFTOptimizer`` in 'encoder' mode (the paper's default) over a whole
window, and in 'encoder', 'all_depth', 'decoder' and 'pose' modes at their
first step, against the JAX package's bfloat16 ``PFTOptimizer`` on the
CPU ('depth_pred' and 'bottleneck': ``test_torch_bf16_pft_leaves.py`` and
``test_torch_bf16_pft_bottleneck.py``; the two repairs this comparison
made: ``test_torch_bf16_pft_repairs.py``).

The setting, the runs and the rule are ``bf16_pft_harness.py``'s: one
window at 64x96, B=2, S=2, 2 iterations, 2 epochs (one Adam step and the
evaluation forward; a third epoch costs ~18 s more here). One JAX program
serves every mode: 'encoder' with the decoder's and the pose net's
weights trainable but frozen (``joint``), whose first step is every weight
mode's (``first_step_runs``). Each quantity is held within a stated
multiple of the larger of JAX's bfloat16-vs-float32 gap (read against the
port's float32 run) and the port's one-ulp spread. Readings (parity / gap
/ spread, measured on an x86 CPU):

* the first step (``TERM_FRACTION`` = 10, ``GRAD_FRACTION`` = 2,
  ``UPDATE_FRACTION`` = 2), the same forward in every mode:
  - each loss term, relative: reconstruct_forward 1.54e-3 / 1.76e-3 /
    3.35e-3, reconstruct_inverse 6.94e-4 / 9.21e-4 / 5.02e-4,
    depth_consist 1.50e-3 / 4.77e-4 / 4.19e-3, total 1.36e-3 / 1.33e-3 /
    2.61e-3 (depth_init is 0 in both before any update). A term is a
    masked mean whose masks flip pixel by pixel, so one reading of the gap
    or the spread is itself noisy (the 'depth_pred' mode's depth_consist
    reads 5.6 x): hence 10 x. Planted fault: a term's weight 25% off;
  - the gradient's direction by weight group, 1 - cos: encoder 2.54e-2 /
    3.32e-2 / 2.94e-2 ('encoder', 'all_depth'), decoder 1.24e-2 /
    9.51e-3 / 1.40e-2 ('all_depth', 'decoder'), pose 8.14e-2 / 2.03e-1 /
    1.79e-1 ('pose'). Planted fault: every second leaf zeroed (4.42e-1,
    3.15e-1, 4.20e-1);
  - the first Adam update's signs, on the elements whose sign JAX's
    bfloat16 and the float32 run share: encoder 3.51% differ (spread
    5.30%), decoder 2.88% (4.45%), pose 3.34% (10.58%). Planted fault:
    half the leaves unchanged (58.7%, 67.0%, 56.8%);
  - these modes train float32 parameters through bfloat16 convs: their
    gradients and Adam's moments are float32 in both packages. 'pose'
    trains the pose net's weights at 64x96, where torch's CPU bfloat16
    conv backward gives finite weight gradients (ROADMAP §3);
* the 'encoder' window (``WINDOW_FRACTION`` = 3): losses 1.03e-3 /
  3.96e-3 / 6.29e-3, poses_opt 1.06e-1 / 8.85e-2 / 1.60e-1, poses_inv_opt
  8.10e-2 / 1.05e-1 / 1.22e-1, disp_opt 2.85e-2 / 2.49e-2 / 3.07e-2,
  poses_init 6.03e-2 / 6.69e-2 / 5.38e-2, the DNet scales 0.19 / 0.33 /
  0.09 (init) and 1.3e-2 / 4.0e-2 / 8.7e-2 (opt; the ground mask's 5
  degree threshold on normals of a bfloat16 depth flips pixels, so the
  scale is held, not the mask). Planted faults: the losses without their
  depth-consistency term (1.29e-1), the forward and inverse poses
  swapped (0.58-0.66), the raw sigmoid in place of the scaled disparity
  (0.95), the scale of a depth taken as metric already (x30: 23, 29).
"""

import jax
import numpy as np
import pytest

import bf16_pft_harness as h
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

EPOCHS, AVG_FINAL_EPOCHS = 2, 1


@pytest.fixture(scope="module")
def setting():
    """(params, batch_stats, window)"""
    return (*h.weights(), h.window())


@pytest.fixture(scope="module")
def encoder_runs(setting):
    return h.mode_runs("encoder", EPOCHS, AVG_FINAL_EPOCHS, *setting,
                       joint=True)


@pytest.fixture(scope="module", params=["encoder", "all_depth", "decoder",
                                        "pose"])
def first_step(request, encoder_runs, setting):
    if request.param == "encoder":
        return encoder_runs
    return h.first_step_runs(encoder_runs, request.param, *setting)


def test_first_step_losses(first_step):
    h.assert_first_step_losses(first_step)


def test_first_step_gradients(first_step):
    h.assert_first_step_gradients(first_step)


def test_first_update(first_step):
    h.assert_first_updates(first_step)


def test_float32_gradients_and_moments(first_step):
    """These modes train float32 parameters through bfloat16 convs: their
    gradients and Adam's moments are float32 in both packages, and
    finite."""
    jax_rec, port_rec = first_step["jax"][1], first_step["port"][1]
    assert jax_rec.dtypes["grad"] == {"float32"}
    assert port_rec.dtypes["grad"] == {"torch.float32"}
    assert port_rec.dtypes["moments"] == {"torch.float32"}
    for g in port_rec.grads[0].values():
        assert all(np.isfinite(a).all() for a in jax.tree_util.tree_leaves(g))


def test_encoder_window(encoder_runs):
    h.assert_window(encoder_runs)


def test_encoder_dtypes(encoder_runs):
    """The disparity is bfloat16 and the error products float32 in both;
    the flip-merged disparity float32 (``post_process_disparity``'s
    float32 ramp promotes it, as ``jnp.linspace``'s does)."""
    jax_rec, port_rec = encoder_runs["jax"][1], encoder_runs["port"][1]
    assert jax_rec.dtypes["disparity"] == "bfloat16"
    assert port_rec.dtypes["disparity"] == "torch.bfloat16"
    assert jax_rec.dtypes["diff_img"] == "float32"
    assert port_rec.dtypes["diff_img"] == "torch.float32"
    assert port_rec.dtypes["disp_opt"] == "torch.float32"
