"""The port's training-time validation (``tcsfm_torch.train.validate``)
against the JAX package's (``tcsfm.train.validate``), on the CPU.

The same weights on both sides: the port's seeded nets with trained-like
conditioning (``chip_smoke.condition_like_trained``), through ``to_flax``;
the same window datasets (the port's copied loaders over generated 64x96
sequences, which both packages' functions index), 4 iterations, f32. At
64x96 f32 resolves the coupled solver (ROADMAP §3: the 1e-5 of
``tests/test_torch_coupled.py``). Held:

* ``depth_and_reconstruction_panels`` (2 samples): the disparities and
  the reconstructed disparities within 1e-5, the automasks equal; the
  reconstructions and the depth-consistency masks, which carry the pose
  into a textured image, within 5e-5: f32 resolves them only to ~3e-5
  here (measured: the port's f32 panels up to 2.7e-5 from the same panels
  in float64, JAX's up to 2.0e-5, the two 1.4e-5 apart);
* ``trajectory_eval`` over 9 windows in batches of 8 (JAX pads the last
  batch, the port keeps it short): the GT poses equal, the poses within
  1e-5 before their metric scale of 30 (3e-4 after it), and the
  trajectory errors within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tcsfm.config import Config as JaxConfig
from tcsfm.models.depth import DepthNet as JaxDepthNet
from tcsfm.models.pose import PoseNet as JaxPoseNet
from tcsfm.train import validate as jax_validate
from tcsfm_torch.config import Config
from tcsfm_torch.data.dataset import SfMWindowDataset
from tcsfm_torch.data.synthetic import make_synthetic_sequence
from tcsfm_torch.data.transforms import get_transforms
from tcsfm_torch.infer import build_models
from tcsfm_torch.models.convert import to_flax
from tcsfm_torch.train import validate
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ITERS, FRAMES = 4, 11


class Jitted:
    """A Flax model whose ``apply`` runs as one compiled program: the JAX
    functions call ``model.apply`` eagerly, which compiles every
    operation of the nets on its own."""

    def __init__(self, model):
        self.apply = jax.jit(model.apply)


@pytest.fixture(scope="module")
def setting():
    cfg = Config(iterations=ITERS)
    depth_net, pose_net = build_models(
        cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    chip_smoke.condition_like_trained(depth_net, torch)
    params, stats = to_flax(depth_net.state_dict(), pose_net.state_dict())
    tf = get_transforms()
    seq = make_synthetic_sequence(FRAMES, (64, 96), seed=9)
    datasets = {key: SfMWindowDataset([seq], seq_len=3, transform=tf[key])
                for key in ("val", "test")}
    jax_args = (JaxConfig(iterations=ITERS, compute_dtype="float32"),
                Jitted(JaxDepthNet(num_scales=1, dtype=jnp.float32)),
                Jitted(JaxPoseNet(dtype=jnp.float32)), params, stats)
    return cfg, (depth_net, pose_net), jax_args, datasets, seq


def test_panels_match_jax(setting):
    cfg, nets, jax_args, datasets, _ = setting
    ours = validate.depth_and_reconstruction_panels(
        cfg, *nets, datasets["val"], n_samples=2)
    theirs = jax_validate.depth_and_reconstruction_panels(
        *jax_args, datasets["val"], n_samples=2)
    assert sorted(ours) == sorted(theirs)
    assert ours["triplets"].shape == (2, 3, 64, 96, 3)
    for k, v in theirs.items():
        assert ours[k].shape == v.shape, k
        atol = 5e-5 if k in ("triplets", "depth_masks") else 1e-5
        np.testing.assert_allclose(ours[k], v, atol=atol, rtol=0, err_msg=k)
    np.testing.assert_array_equal(ours["exp_masks"], theirs["exp_masks"])
    assert 0 < ours["exp_masks"].mean() < 1


def test_trajectory_eval_matches_jax(setting):
    cfg, nets, jax_args, datasets, seq = setting
    est, gts, errors = validate.trajectory_eval(
        cfg, *nets, datasets["test"], seq.gt_poses, verbose=False)
    j_est, j_gts, j_errors = jax_validate.trajectory_eval(
        *jax_args, datasets["test"], seq.gt_poses, verbose=False)
    assert est.shape == (FRAMES - 2, 6)
    np.testing.assert_array_equal(gts, j_gts)
    np.testing.assert_allclose(est, j_est, atol=30 * 1e-5, rtol=0)
    np.testing.assert_allclose(np.asarray(errors, np.float64),
                               np.asarray(j_errors, np.float64),
                               rtol=1e-4, atol=0, equal_nan=True)
    assert np.isfinite(errors[0]) and np.isfinite(errors[1])
