"""The port's PFT (tcsfm_torch.solver.pft) against the JAX package's
``PFTOptimizer.optimize_window``, end to end, in float64 on both sides.

One window of the synthetic sequence (JAX's ``make_synthetic_sequence``,
seed 2) at 32x64, B=2, S=2, 2 coupled iterations, 3 epochs,
``avg_final_epochs=2``, ``record_history=True`` (one scan in JAX, so one
compile of the step: the JAX call is ~35 s of XLA compile on an x86 CPU; its
values are those of the split scan). Weights: Flax's init (jitted,
seeds 0/1) with trained-like conditioning (``test_torch_coupled._condition``:
the raw init does not resolve in f32, ROADMAP §3), converted by
``from_flax`` with the batch statistics. JAX runs jitted under
``jax.enable_x64(True)`` with float64 modules; the port runs ``.double()``
nets with ``sampler=grid_sample_plain`` (the plain sampler takes float64).

Held, each relative to the field's largest magnitude:
* what precedes the first update (epoch 0 of ``losses``, ``poses_hist``
  and ``disp_hist``; ``poses_init``, ``poses_inv_init``, ``scale_init``)
  within ``TOL_INIT`` = 1e-6. Measured: 4.3e-7 (the poses; JAX's float64
  run keeps a few float32 pieces, so its poses sit ~1.5e-8 from the
  port's, as in ``test_torch_train.py``'s float64 case);
* everything after it (the later epochs, ``poses_opt``,
  ``poses_inv_opt``, ``disp_opt``, ``scale_opt``) within ``TOL`` = 5e-5.
  Measured: 1.0e-5 (disparity), 5.1e-6 (poses), 1.9e-6 (losses). Adam's
  first step is lr·g/|g| per weight, so a gradient within rounding of 0,
  which the two runs put on opposite sides of 0, moves its weight by
  2·lr in one run against the other; that, not the arithmetic, sets the
  spread after the first update. The steps themselves move the
  disparity and the poses by more than 20x ``TOL``
  (``test_the_window_moves_and_finds_ground``).
This file holds encoder mode; ``test_torch_pft_depth_pred.py`` the
depth_pred mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tcsfm.config import Config as JaxConfig
from tcsfm.config import PFTOptions as JaxPFTOptions
from tcsfm.data.dataset import SfMWindowDataset
from tcsfm.data.loader import BatchLoader
from tcsfm.data.synthetic import make_synthetic_sequence
from tcsfm.data.transforms import WindowTransform
from tcsfm.models.depth import DepthNet as JaxDepthNet
from tcsfm.models.pose import PoseNet as JaxPoseNet
from tcsfm.solver.pft import PFTOptimizer as JaxPFTOptimizer
from tcsfm_torch.config import Config, PFTOptions
from tcsfm_torch.models.convert import from_flax
from tcsfm_torch.models.depth import DepthNet
from tcsfm_torch.models.pose import PoseNet
from tcsfm_torch.ops.grid_sample import grid_sample_plain
from tcsfm_torch.solver.pft import PFTOptimizer
from test_torch_coupled import _condition
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W, B, ITERS = 32, 64, 2, 2
OPTS = dict(epochs=3, avg_final_epochs=2, num_source_imgs=2)
TOL_INIT = 1e-6
TOL = 5e-5
HIST = ("losses", "poses_hist", "disp_hist")
INIT = ("poses_init", "poses_inv_init", "scale_init")
FINAL = ("poses_opt", "poses_inv_opt", "disp_opt", "scale_opt")
FIELDS = HIST + INIT + FINAL


def jax_weights():
    """Flax's init (jitted: eager init takes ~1 min on the CPU), conditioned."""
    depth_model, pose_model = JaxDepthNet(num_scales=1), JaxPoseNet()
    dvars = jax.jit(depth_model.init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 32, 32, 3)))
    pvars = jax.jit(pose_model.init)(jax.random.PRNGKey(1),
                                     jnp.zeros((1, 32, 32, 6)))
    tree = lambda x: jax.tree_util.tree_map(np.asarray, unfreeze(x))  # noqa
    params = {"depth": _condition(tree(dvars["params"])),
              "pose": tree(pvars["params"])}
    return depth_model, pose_model, params, tree(dvars["batch_stats"])


def window():
    seq = make_synthetic_sequence(8, (H, W), seed=2)
    ds = SfMWindowDataset([seq], seq_len=3,
                          transform=WindowTransform(jitter=False,
                                                    flip_prob=None))
    batch = next(iter(BatchLoader(ds, B, shuffle=False)))
    return {k: batch[k] for k in ("target_img", "source_imgs", "intrinsics")}


def run_both(mode):
    """(JAX result, port result) of one float64 ``optimize_window`` each,
    as dicts of float64 numpy arrays."""
    depth_model, pose_model, params, stats = jax_weights()
    batch = window()
    jcfg = JaxConfig(compute_dtype="float64", iterations=ITERS, num_scales=1,
                     use_mxu_warp=False)
    with jax.enable_x64(True):
        to64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                      (params, stats, batch))
        jparams, jstats, jbatch = to64
        opt = JaxPFTOptimizer(jcfg, JaxPFTOptions(**OPTS),
                              depth_model.clone(dtype=jnp.float64),
                              pose_model.clone(dtype=jnp.float64),
                              mode=mode, record_history=True)
        res = opt.optimize_window_jit(jbatch, jparams["depth"],
                                      jparams["pose"], jstats)
        ref = {k: np.asarray(getattr(res, k), np.float64) for k in FIELDS}

    depth_sd, pose_sd = from_flax(params, stats)
    depth_net, pose_net = DepthNet(num_scales=1), PoseNet()
    depth_net.load_state_dict(depth_sd)
    pose_net.load_state_dict(pose_sd)
    depth_net.double().eval()
    pose_net.double().eval()
    port_opt = PFTOptimizer(Config(iterations=ITERS), PFTOptions(**OPTS),
                            depth_net, pose_net, mode=mode,
                            record_history=True)
    res = port_opt.optimize_window(batch, device="cpu",
                                   sampler=grid_sample_plain)
    port = {k: torch.as_tensor(getattr(res, k)).numpy() for k in FIELDS}
    return ref, port


def rel_delta(p, r):
    return np.abs(p - r).max() / max(np.abs(r).max(), 1e-30)


def assert_results_match(ref, port):
    for k in FIELDS:
        r, p = ref[k], port[k]
        assert p.shape == r.shape, (k, p.shape, r.shape)
        assert p.dtype == np.float64, (k, p.dtype)
        assert np.isfinite(p).all(), k
    held = {f"{k}[0]": (port[k][0], ref[k][0], TOL_INIT) for k in HIST}
    held.update({k: (port[k], ref[k], TOL_INIT) for k in INIT})
    held.update({f"{k}[1:]": (port[k][1:], ref[k][1:], TOL) for k in HIST})
    held.update({k: (port[k], ref[k], TOL) for k in FINAL})
    for name, (p, r, tol) in held.items():
        err = rel_delta(p, r)
        print(f"{name}: max rel delta {err:.3e} (limit {tol})")
        assert err <= tol, (name, err, tol)


@pytest.fixture(scope="module")
def encoder_runs():
    return run_both("encoder")


def test_optimize_window_matches_jax_f64(encoder_runs):
    ref, port = encoder_runs
    assert_results_match(ref, port)


def test_the_window_moves_and_finds_ground(encoder_runs):
    """The comparison is not vacuous: the steps change the loss and the
    poses, and both scales see ground pixels (0 means none)."""
    ref, port = encoder_runs
    assert ref["losses"].shape == (OPTS["epochs"],)
    for k in ("disp_hist", "poses_hist"):
        moved = rel_delta(port[k][-1], port[k][0])
        print(f"{k}: moved {moved:.3e} relative over the steps")
        assert moved > 20 * TOL, (k, moved)
    assert np.abs(np.diff(port["losses"])).min() > 1e-6
    assert port["scale_init"] > 0 and port["scale_opt"] > 0
