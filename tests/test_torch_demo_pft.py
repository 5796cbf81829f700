"""The port's dataset-free PFT demo (``python -m tcsfm_torch.cli.demo_pft``)
and what it stands on, against the JAX package's, on CPU.

* The copied numpy data modules (``tcsfm_torch/data``,
  ``tcsfm_torch/eval/trajectory.py``) give bit-identical windows to the
  JAX package's: ``make_synthetic_sequence``, ``SfMWindowDataset`` with
  and without the augmenting transform, ``BatchLoader`` and
  ``relative_lie_alg``, same seeds.
* ``loss_surface`` (and so ``photometric_error``) against JAX's on the
  demo's own inputs at 32x64, NaN where JAX has NaN: without the
  automask (the demo's setting) within 1e-5 (f32 warps next to the
  border, see ``test_torch_coupled_errors.py``); with it within 1e-3,
  since a pixel whose two errors tie within f32 rounding enters the mask
  in one run and not in the other, and one pixel of the ~1,000 kept moves
  the masked mean by up to ~2e-4 (measured: 1.8e-4 at one offset of 42).
* The demo itself at 32x64, 3 epochs, on the CPU through ``main([...,
  "--device", "cpu"])`` and through ``run(...)``: it prints the keys of
  the JAX demo's summary (read from its source), its ``surface_*``
  values, which depend on no network, equal JAX's, and ``--out`` writes
  the curves. The perturbation and depth-scaling experiments run too.
"""

import ast
import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcsfm.cli.demo_pft as jax_demo
from tcsfm.data.dataset import SfMWindowDataset as JaxDataset
from tcsfm.data.dataset import relative_lie_alg as jax_relative_lie_alg
from tcsfm.data.loader import BatchLoader as JaxLoader
from tcsfm.data.synthetic import make_synthetic_sequence as jax_sequence
from tcsfm.data.transforms import WindowTransform as JaxTransform
from tcsfm.eval.experiments import loss_surface as jax_loss_surface
from tcsfm_torch import infer
from tcsfm_torch.cli import demo_pft
from tcsfm_torch.config import Config
from tcsfm_torch.data.dataset import SfMWindowDataset, relative_lie_alg
from tcsfm_torch.data.loader import BatchLoader
from tcsfm_torch.data.synthetic import make_synthetic_sequence
from tcsfm_torch.data.transforms import WindowTransform
from tcsfm_torch.eval import experiments
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W = 32, 64
ARGS = ["--epochs", "3", "--height", str(H), "--width", str(W)]


def _batches(seq_fn, ds_cls, tf_cls, loader_cls, transform):
    seq = seq_fn(8, (H, W), seed=4)
    tf = (tf_cls(jitter=False, flip_prob=None) if transform == "clean"
          else tf_cls())
    ds = ds_cls([seq], seq_len=3, transform=tf, seed=3)
    return seq, list(loader_cls(ds, 2, shuffle=transform != "clean"))


@pytest.mark.parametrize("transform", ["clean", "augmented"])
def test_data_pipeline_is_bit_identical(transform):
    seq_j, batches_j = _batches(jax_sequence, JaxDataset, JaxTransform,
                                JaxLoader, transform)
    seq_p, batches_p = _batches(make_synthetic_sequence, SfMWindowDataset,
                                WindowTransform, BatchLoader, transform)
    for k in ("images", "depths", "intrinsics", "gt_poses", "vo_poses",
              "timestamps"):
        np.testing.assert_array_equal(getattr(seq_p, k), getattr(seq_j, k),
                                      err_msg=k)
    assert len(batches_p) == len(batches_j) > 1
    for bp, bj in zip(batches_p, batches_j):
        assert set(bp) == set(bj)
        for k in bj:
            np.testing.assert_array_equal(bp[k], bj[k], err_msg=k)
            assert bp[k].dtype == bj[k].dtype
    for t, s in ((1, 2), (3, 0), (5, 7)):
        np.testing.assert_array_equal(
            relative_lie_alg(seq_p.gt_poses[t], seq_p.gt_poses[s]),
            jax_relative_lie_alg(seq_j.gt_poses[t], seq_j.gt_poses[s]))


def _surface_inputs():
    """The demo's loss-surface inputs and offsets."""
    seq = make_synthetic_sequence(8, (H, W), seed=4)
    t, s = 1, 2
    xi = relative_lie_alg(seq.gt_poses[t], seq.gt_poses[s])
    tz = abs(float(xi[2])) + 1e-6
    offs = np.linspace(-1.5 * tz, 1.5 * tz, 21).astype(np.float32)
    yaws = np.linspace(-0.008, 0.008, 21).astype(np.float32)
    arrays = [np.ascontiguousarray(a, np.float32) for a in (
        seq.images[t][None], seq.images[s][None],
        seq.depths[t][None, ..., None], seq.depths[s][None, ..., None],
        xi[None], seq.intrinsics[t][None])]
    return arrays, offs, yaws


@pytest.fixture(scope="module")
def jax_surface():
    arrays, offs, yaws = _surface_inputs()
    out = {}
    for automask in (False, True):
        out[automask] = jax_loss_surface(*map(jnp.asarray, arrays), offs,
                                         yaws, automask=automask)
    return out


@pytest.mark.parametrize("automask", [False, True])
def test_loss_surface_matches_jax(jax_surface, automask):
    arrays, offs, yaws = _surface_inputs()
    port = experiments.loss_surface(*map(torch.from_numpy, arrays), offs,
                                    yaws, automask=automask)
    for k in ("trans", "yaw"):
        ref = jax_surface[automask][k]
        assert port[k].shape == ref.shape == (21, 1)
        np.testing.assert_array_equal(np.isnan(port[k]), np.isnan(ref))
        np.testing.assert_allclose(port[k], ref, atol=1e-3 if automask
                                   else 1e-5, rtol=0, equal_nan=True,
                                   err_msg=k)


def _jax_summary_keys():
    """The keys of the JAX demo's ``summary`` dict, from its source."""
    tree = ast.parse(open(jax_demo.__file__).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", "") == "summary"
                        for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no summary dict in the JAX demo")


def test_demo_runs_on_the_cpu(jax_surface, tmp_path):
    out_file = os.path.join(tmp_path, "demo.json")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        summary = demo_pft.main(ARGS + ["--device", "cpu", "--out", out_file])
    last = json.loads(printed.getvalue().strip().splitlines()[-1])
    assert last == summary
    assert list(summary) == _jax_summary_keys()
    assert np.isfinite([summary["pft_loss_first"], summary["pft_loss_last"]]
                       ).all()
    _, offs, yaws = _surface_inputs()
    ref = jax_surface[False]
    assert summary["surface_trans_argmin_offset"] == float(
        offs[np.nanargmin(ref["trans"][:, 0])])
    assert summary["surface_yaw_argmin_offset"] == float(
        yaws[np.nanargmin(ref["yaw"][:, 0])])
    with open(out_file) as f:
        saved = json.load(f)
    np.testing.assert_allclose(saved["trans_curve"], ref["trans"][:, 0],
                               atol=1e-5, rtol=0)

    # run(...) takes the networks it is handed
    args = demo_pft.parse_args(ARGS)
    nets = infer.build_models(Config(iterations=2), device="cpu",
                              generator=torch.Generator().manual_seed(0))
    with contextlib.redirect_stdout(io.StringIO()):
        assert demo_pft.run(args, *nets, torch.device("cpu")) == summary


def test_perturbation_and_depth_scaling_run():
    nets = infer.build_models(Config(), device="cpu",
                              generator=torch.Generator().manual_seed(2))
    rng = np.random.RandomState(0)
    tgt = torch.from_numpy(rng.rand(1, H, W, 3).astype(np.float32))
    src = torch.from_numpy(rng.rand(2, 1, H, W, 3).astype(np.float32))
    K = torch.tensor([[[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2.5],
                       [0, 0, 1]]])
    depths = torch.full((3, 1, H, W, 1), 0.8)
    clean, pert = experiments.perturbation_response(
        2, depths, nets[1], tgt, src, K, trans_pert=0.01, yaw_pert=0.002)
    assert clean.shape == pert.shape == (2, 1, 6)
    assert not torch.equal(clean, pert)
    norms = experiments.depth_scaling_response(2, depths, nets[1], tgt, src,
                                               K, [0.5, 1.0, 2.0])
    assert norms.shape == (3,) and np.isfinite(norms).all()
