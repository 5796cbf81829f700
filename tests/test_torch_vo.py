"""The port's VO evaluation (``tcsfm_torch.eval.vo``,
``tcsfm_torch.cli.evaluate_vo``) against the JAX package's.

One checkpoint directory, written by the port (``save_checkpoint`` and
``Config.save``: seeded nets with trained-like conditioning, since f32
does not resolve the coupled forward at the raw init, ROADMAP §3), is read
by both packages' CLIs through ``--model_dir``. The JAX CLI runs once
(``--synthetic``: 24 frames at 64x96, 23 pair windows in batches of 8, the
last one short, 2 iterations), cached per module, with ``--save_preds``.

Held:
* the metric tail (``metrics_from_pose_vecs``) and the saved-prediction
  replay: equal to JAX's, bit for bit (the same numpy code);
* ``VOEvaluator.run_sequence`` at batch 4 against JAX's CLI at batch 8:
  pose vectors (translations back at the solver's 1/30 scale) within
  ``POSE_TOL`` = 1e-5, DNet scales within ``SCALE_TOL`` = 1e-4 relative;
* the CLIs' printed errors within ``ERR_TOL`` = 1e-3, one unit of the
  3-decimal rounding ``compute_trajectory`` applies.

The tests print what they measure (``-s``).
"""

import os

import jax  # noqa: F401  (keeps JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest
import torch

import chip_smoke
from tcsfm.cli.evaluate_vo import main as jax_main
from tcsfm.data.synthetic import make_synthetic_sequence as jax_sequence
from tcsfm.eval import vo as jax_vo
from tcsfm_torch.cli import evaluate_vo
from tcsfm_torch.config import Config
from tcsfm_torch.data.synthetic import make_synthetic_sequence
from tcsfm_torch.eval import vo
from tcsfm_torch.infer import build_models
from tcsfm_torch.train.checkpoint import save_checkpoint
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

POSE_TOL = 1e-5
SCALE_TOL = 1e-4
ERR_TOL = 1e-3
ERROR_KEYS = ("errors_unscaled", "errors_dnet", "errors_gt_scaled")


def nan_equal(a, b):
    return all(x == y or (x != x and y != y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("vo_model"))
    cfg = Config(iterations=2, img_resolution="low")
    depth_net, pose_net = build_models(
        cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    chip_smoke.condition_like_trained(depth_net, torch)
    save_checkpoint(d, (depth_net, pose_net), epoch=1, best_val_loss=1.0,
                    cfg=cfg, is_best=True)
    return d


@pytest.fixture(scope="module")
def jax_run(model_dir, tmp_path_factory):
    preds = str(tmp_path_factory.mktemp("jax_preds"))
    out = jax_main(["--model_dir", model_dir, "--synthetic",
                    "--save_preds", preds])
    return out["synthetic"], np.load(os.path.join(preds,
                                                  "synthetic_preds.npz"))


def seeded_vecs(n, seed):
    rng = np.random.RandomState(seed)
    fwd = np.concatenate([rng.randn(n, 3) * 0.6, rng.randn(n, 3) * 0.01], 1)
    inv = -fwd + 0.01 * rng.randn(n, 6)
    gts = fwd + 0.02 * rng.randn(n, 6)
    scales = 1.0 + 0.2 * rng.rand(n, 1)
    return [a.astype(np.float32) for a in (fwd, inv, gts, scales)]


@pytest.mark.parametrize("dnet,with_scales", [(True, True), (False, True),
                                              (True, False)])
def test_metric_tail_matches_jax(dnet, with_scales):
    seq = make_synthetic_sequence(24, (64, 96), seed=11)
    fwd, inv, gts, scales = seeded_vecs(23, seed=1)
    scales = scales if with_scales else None
    ours = vo.metrics_from_pose_vecs("s", seq.gt_poses, fwd, inv, gts, scales,
                                     dnet=dnet, verbose=False)
    ref = jax_vo.metrics_from_pose_vecs("s", seq.gt_poses, fwd, inv, gts,
                                        scales, dnet=dnet, verbose=False)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        if k.startswith("errors"):
            assert nan_equal(ours[k], ref[k]), k
    assert ours["gt_scale"] == ref["gt_scale"]
    for k, v in ref["est_trajs"].items():
        np.testing.assert_array_equal(ours["est_trajs"][k], v)


def test_saved_predictions_cross(tmp_path):
    seq = make_synthetic_sequence(24, (64, 96), seed=11)
    fwd, inv, gts, scales = seeded_vecs(23, seed=2)
    res = vo.metrics_from_pose_vecs("s", seq.gt_poses, fwd, inv, gts, scales,
                                    verbose=False)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    vo.save_predictions(ours, res)
    jax_vo.save_predictions(theirs, res)
    for path in (ours, theirs):
        a = vo.evaluate_saved_predictions(path, seq, verbose=False)
        b = jax_vo.evaluate_saved_predictions(path, seq, verbose=False)
        for k in ERROR_KEYS:
            assert nan_equal(a[k], b[k]) and nan_equal(a[k], res[k]), k


def test_the_port_generates_jax_s_sequence():
    ours, ref = (f(24, (64, 96), seed=11) for f in (make_synthetic_sequence,
                                                    jax_sequence))
    for k in ("images", "intrinsics", "gt_poses", "depths"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k))


def test_run_sequence_matches_jax(model_dir, jax_run):
    """Batch 4 here (23 = 5 x 4 + 3) against JAX's batch 8 (8 + 8 + 7)."""
    from tcsfm_torch.cli.common import load_nets

    _, preds = jax_run
    depth_net, pose_net = load_nets(model_dir, "cpu")
    ev = vo.VOEvaluator(Config(iterations=2), depth_net, pose_net,
                        device="cpu")
    res = ev.run_sequence(make_synthetic_sequence(24, (64, 96), seed=11),
                          batch_size=4, verbose=False)
    for k in ("fwd_pose_vec", "inv_pose_vec"):
        ours, ref = res[k].copy(), preds[k].copy()
        assert ours.shape == ref.shape == (23, 6)
        ours[:, :3] /= vo.METRIC_SCALE
        ref[:, :3] /= vo.METRIC_SCALE
        print(f"{k}: max |port - JAX| {np.abs(ours - ref).max():.3e}")
        np.testing.assert_allclose(ours, ref, rtol=0, atol=POSE_TOL)
    np.testing.assert_array_equal(res["gt_pose_vec"], preds["gt_pose_vec"])
    rel = np.abs(res["dnet_scale_factor"] / preds["dnet_scale_factor"] - 1)
    print(f"DNet scales: max relative gap {rel.max():.3e}")
    np.testing.assert_allclose(res["dnet_scale_factor"],
                               preds["dnet_scale_factor"], rtol=SCALE_TOL)


def test_cli_matches_jax_and_replays(model_dir, jax_run, tmp_path, capsys):
    ref, _ = jax_run
    preds = str(tmp_path / "preds")
    out = evaluate_vo.main(["--model_dir", model_dir, "--synthetic",
                            "--device", "cpu", "--save_preds", preds])
    assert "compute dtype: the config asks float32" in capsys.readouterr().out
    got = out["synthetic"]
    assert sorted(got) == sorted(ref)
    for k in ERROR_KEYS:
        assert np.isfinite(got[k][:2]).all()
        print(f"{k}: port {got[k]}, JAX {ref[k]}")
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=ERR_TOL)
    np.testing.assert_allclose(float(got["gt_scale"]), float(ref["gt_scale"]),
                               rtol=SCALE_TOL)

    replay = evaluate_vo.main(["--model_dir", model_dir, "--synthetic",
                               "--device", "cpu", "--load_preds", preds])
    for k in ERROR_KEYS + ("gt_scale",):
        assert nan_equal(np.atleast_1d(replay["synthetic"][k]),
                         np.atleast_1d(got[k])), k


def test_plot_dir_needs_matplotlib(model_dir, tmp_path, monkeypatch):
    """--plot_dir draws with matplotlib; where it is missing the CLI fails
    with the ImportError that names it, and never skips the plots."""
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ModuleNotFoundError("No module named 'matplotlib'",
                                      name="matplotlib")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="matplotlib"):
        evaluate_vo.main(["--model_dir", model_dir, "--synthetic",
                          "--device", "cpu", "--iterations", "1",
                          "--plot_dir", str(tmp_path / "plots")])
