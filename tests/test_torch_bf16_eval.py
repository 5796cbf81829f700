"""The evaluation path in bfloat16: ``VOEvaluator`` and ``evaluate_vo``
from a bfloat16 model directory, against the JAX package's CLI on the same
directory, on the CPU; and bfloat16 model directories crossing between
the packages (``evaluate_depth_eigen`` and ``evaluate_scannet``:
``test_torch_bf16_eval_depth.py``; ``run_sequential_pft``:
``test_torch_bf16_seqpft.py``).

The directory, the rule and the one-ulp runs are ``bf16_eval_harness.py``'s
(``FRACTION`` = 3 x the larger of JAX's bfloat16-vs-float32 gap and the
port's one-ulp spread; the port's float32 run stands in for JAX's, which
each CLI's float32 test holds within 1e-5 to 1e-4). Held, relative L2
(parity / gap / spread measured on an x86 CPU), each with a
planted fault that fails it:

* ``VOEvaluator.run_sequence`` (the 24-frame synthetic sequence at 64x96,
  batch 8, 2 iterations) against JAX's ``evaluate_vo --save_preds``: the
  fused pose vectors and the DNet scales; with the DNet scales off the
  poses are the same and the scales 1. Planted faults: every pose one
  window late (a batching fault), the scale of a depth taken as metric
  already (x30; the ground mask's 5 degree threshold on normals of a
  bfloat16 depth flips pixels, so the scale is held, not the mask, and
  its gap and spread are large). Read: fwd 2.88e-2 / 5.73e-2 / 3.34e-2,
  inv 2.86e-2 / 5.16e-2 / 3.21e-2, scales 0.534 / 0.418 / 0.471;
* the printed errors of ``evaluate_vo`` (unscaled, DNet-scaled,
  GT-scaled): the finite entries as one vector, 9.35e-3 / 2.80e-2 /
  2.36e-2. Planted fault: the errors with the inverse poses fused with
  the wrong sign;
* saved predictions of bfloat16 nets cross: each package replays the
  other's file to the same errors, bit for bit (the same numpy tail);

Model directories crossing between the packages:
``test_torch_bf16_model_dirs.py``.
"""

import os

import jax  # noqa: F401  (keeps JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest

import bf16_eval_harness as eh
from tcsfm.cli.evaluate_vo import main as jax_vo_main
from tcsfm.eval import vo as jax_vo
from tcsfm_torch.cli import evaluate_vo
from tcsfm_torch.cli.common import load_config, load_nets
from tcsfm_torch.config import Config
from tcsfm_torch.data.synthetic import make_synthetic_sequence
from tcsfm_torch.eval import vo
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ERROR_KEYS = ("errors_unscaled", "errors_dnet", "errors_gt_scaled")


def sequence():
    return make_synthetic_sequence(24, (64, 96), seed=11)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return eh.write_model_dirs(tmp_path_factory.mktemp("bf16_model"))


@pytest.fixture(scope="module")
def jax_run(dirs, tmp_path_factory):
    preds = str(tmp_path_factory.mktemp("jax_vo_preds"))
    out = jax_vo_main(["--model_dir", dirs["bfloat16"], "--synthetic",
                       "--save_preds", preds])
    path = os.path.join(preds, "synthetic_preds.npz")
    return out["synthetic"], dict(np.load(path)), path


def _evaluator(model_dir, **kw):
    return vo.VOEvaluator(load_config(model_dir, Config()),
                          *load_nets(model_dir, "cpu"), device="cpu", **kw)


@pytest.fixture(scope="module")
def port_runs(dirs):
    def run(dtype, **kw):
        return _evaluator(dirs[dtype], **kw).run_sequence(
            sequence(), batch_size=8, verbose=False)

    runs = {dtype: run(dtype) for dtype in dirs}
    runs["moved"] = []
    for d in eh.DIRECTIONS:
        with eh.nudged(d):
            runs["moved"].append(run("bfloat16"))
    runs["no_dnet"] = run("bfloat16", dnet_rescaling=False)
    return runs


@pytest.fixture(scope="module")
def port_cli(dirs, tmp_path_factory):
    """The port's ``evaluate_vo`` on the bfloat16 directory: (its printed
    errors, its saved predictions' path)."""
    preds = str(tmp_path_factory.mktemp("port_vo_preds"))
    got = evaluate_vo.main(["--model_dir", dirs["bfloat16"], "--synthetic",
                            "--device", "cpu", "--save_preds", preds])
    return got, os.path.join(preds, "synthetic_preds.npz")


def _late(a):
    """Every prediction one window late."""
    return np.roll(np.asarray(a), 1, axis=0)


def test_vo_evaluator_matches_jax(jax_run, port_runs):
    _, preds, _ = jax_run
    ours, f32, moved = (port_runs["bfloat16"], port_runs["float32"],
                        port_runs["moved"])
    faults = {"fwd_pose_vec": _late(ours["fwd_pose_vec"]),
              "inv_pose_vec": _late(ours["inv_pose_vec"]),
              "dnet_scale_factor": ours["dnet_scale_factor"] * 30.0}
    for k, fault in faults.items():
        assert ours[k].shape == preds[k].shape
        eh.hold(ours[k], preds[k], f32[k], [m[k] for m in moved],
                f"VOEvaluator {k}", fault=fault)
    np.testing.assert_array_equal(ours["gt_pose_vec"], preds["gt_pose_vec"])


def test_vo_evaluator_without_scales(jax_run, port_runs):
    """With the DNet scales off the poses are the same and every scale is
    1; the unscaled errors are held against JAX's."""
    ref, _, _ = jax_run
    plain, ours = port_runs["no_dnet"], port_runs["bfloat16"]
    for k in ("fwd_pose_vec", "inv_pose_vec"):
        np.testing.assert_array_equal(plain[k], ours[k])
    np.testing.assert_array_equal(plain["dnet_scale_factor"], 1.0)
    k = "errors_unscaled"
    eh.hold(eh.finite(plain[k]), eh.finite(ref[k]),
            eh.finite(port_runs["float32"][k]),
            [eh.finite(m[k]) for m in port_runs["moved"]], f"no-DNet {k}")


def _errors(res):
    return np.concatenate([eh.finite(res[k][:2]) for k in ERROR_KEYS])


def test_evaluate_vo_cli_matches_jax(jax_run, port_runs, port_cli):
    ref, _, _ = jax_run
    got = port_cli[0]["synthetic"]
    assert sorted(got) == sorted(ref)
    ours = port_runs["bfloat16"]
    for k in ERROR_KEYS:
        assert got[k] == ours[k] or np.allclose(got[k], ours[k],
                                                equal_nan=True), k
    # planted fault: the inverse poses fused with the wrong sign
    fault = vo.metrics_from_pose_vecs(
        "s", sequence().gt_poses, ours["fwd_pose_vec"],
        -ours["inv_pose_vec"], ours["gt_pose_vec"],
        ours["dnet_scale_factor"].reshape(-1, 1), verbose=False)
    eh.hold(_errors(got), _errors(ref), _errors(port_runs["float32"]),
            [_errors(m) for m in port_runs["moved"]],
            "evaluate_vo errors (t_err, r_err of each scaling)",
            fault=_errors(fault))


def test_saved_predictions_cross(jax_run, port_cli):
    """Predictions of bfloat16 nets, saved by either package, replay in
    the other to the same errors."""
    ref, _, jax_path = jax_run
    port_path = port_cli[1]
    seq = sequence()
    for path in (port_path, jax_path):
        saved = np.load(path)
        assert all(saved[k].dtype == np.float32 for k in (
            "fwd_pose_vec", "inv_pose_vec", "dnet_scale_factor")), path
        a = vo.evaluate_saved_predictions(path, seq, verbose=False)
        b = jax_vo.evaluate_saved_predictions(path, seq, verbose=False)
        for k in ERROR_KEYS:
            np.testing.assert_array_equal(a[k], b[k])
    replay = vo.evaluate_saved_predictions(jax_path, seq, verbose=False)
    for k in ERROR_KEYS:
        np.testing.assert_array_equal(replay[k], ref[k])
