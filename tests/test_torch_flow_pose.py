"""Classical flow on the port's pose paths (``flow_type='classical'``: the
8-channel pose net fed the Farneback flow pair) against the JAX
package's, on the CPU, in f32.

Held, each with what was measured here:

* the 8-channel ``PoseNet`` from Flax-initialised params
  (``models.convert.pose_state_dict``) against JAX's ``PoseNet`` within
  ``POSE_TOL`` = 1e-5, the coupled tests' limit (measured ~1e-9: poses
  are 0.01 x a spatial mean), and ``pose_to_flax`` back to the same
  params;
* ``solve_pose`` with the flow pair (``ops.flow.pose_flows``) against
  JAX's ``solve_pose`` on the same flows within ``POSE_TOL``;
* the port's ``evaluate_vo --model_dir d --iterations 1 --synthetic``
  (24 frames at 64x96, batch 8) with a port-written classical checkpoint
  (seeded nets, trained-like depth conditioning, ROADMAP §3) against the
  JAX package's ``VOEvaluator`` with the same weights on the same
  sequence: pose vectors (translations back at the solver's 1/30 scale) within
  ``POSE_TOL``, DNet scales and ``gt_scale`` within ``REL_TOL`` = 1e-4
  relative, the printed errors within 1e-4 relative or one unit of the
  3-decimal rounding ``compute_trajectory`` applies (``ERR_TOL`` =
  1e-3), as ``tests/test_torch_vo.py`` holds them;
* the validation panels at ``iterations == 1`` with the flows (2 samples
  of 32x64 windows): every panel within ``PANEL_TOL`` = 5e-5, the limit
  ``tests/test_torch_validate.py`` draws from f32's resolution of the
  reconstruction; the automasks equal;
* the refusals: JAX's iterative solver raises on an 8-channel pose net,
  and so do the port's iterative paths (the solver, the training step,
  PFT, the evaluator's perturbed and iterative routes) and
  ``cli.train --flow_type classical``, with their messages; a JAX-written
  classical ``config.json`` loads.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tcsfm.config import Config as JaxConfig
from tcsfm.eval import vo as jax_vo
from tcsfm.models.depth import DepthNet as JaxDepthNet
from tcsfm.models.pose import PoseNet as JaxPoseNet
from tcsfm.solver import coupled as jax_coupled
from tcsfm.train import validate as jax_validate
from tcsfm_torch.cli import evaluate_vo
from tcsfm_torch.cli import train as train_cli
from tcsfm_torch.config import Config, json_notes
from tcsfm_torch.data.dataset import SfMWindowDataset
from tcsfm_torch.data.synthetic import make_synthetic_sequence
from tcsfm_torch.data.transforms import get_transforms
from tcsfm_torch.eval import vo
from tcsfm_torch.infer import build_models
from tcsfm_torch.models.convert import pose_state_dict, pose_to_flax, to_flax
from tcsfm_torch.models.pose import PoseNet
from tcsfm_torch.ops.flow import pose_flows
from tcsfm_torch.solver.coupled import solve_pose, solve_pose_iteratively
from tcsfm_torch.train import validate
from tcsfm_torch.train.checkpoint import save_checkpoint
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

POSE_TOL = 1e-5
REL_TOL = 1e-4
ERR_TOL = 1e-3
PANEL_TOL = 5e-5
ERROR_KEYS = ("errors_unscaled", "errors_dnet", "errors_gt_scaled")
CLASSICAL = dict(flow_type="classical", iterations=1)


def nan_close(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    both_nan = np.isnan(a) & np.isnan(b)
    ok = np.isclose(a, b, rtol=REL_TOL, atol=0) | (np.abs(a - b) <= ERR_TOL)
    return bool(np.all(both_nan | ok))


@pytest.fixture(scope="module")
def flax_pose():
    model = JaxPoseNet(dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 64, 96, 8)))["params"]
    return params, jax.jit(lambda p, x: model.apply({"params": p}, x))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A port-written classical checkpoint; returns (dir, Flax params,
    batch statistics) of its nets."""
    d = str(tmp_path_factory.mktemp("classical_model"))
    cfg = Config(compute_dtype="float32", img_resolution="low", **CLASSICAL)
    depth_net, pose_net = build_models(
        cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    chip_smoke.condition_like_trained(depth_net, torch)
    save_checkpoint(d, (depth_net, pose_net), epoch=1, best_val_loss=1.0,
                    cfg=cfg, is_best=True)
    return (d,) + tuple(to_flax(depth_net.state_dict(),
                                pose_net.state_dict()))


def test_pose_net_8_channels_from_flax(flax_pose):
    params, apply = flax_pose
    sd = pose_state_dict(params)
    net = PoseNet(in_channels=8)
    net.load_state_dict(sd, strict=True)
    assert tuple(net.conv1[0].weight.shape) == (16, 8, 7, 7)
    back = pose_to_flax(net.state_dict())
    np.testing.assert_array_equal(back["conv1"]["WSConv_0"]["kernel"],
                                  params["conv1"]["WSConv_0"]["kernel"])
    x = np.random.RandomState(0).rand(4, 64, 96, 8).astype(np.float32)
    with torch.no_grad():
        ours = net(torch.from_numpy(x)).numpy()
    ref = np.asarray(apply(params, jnp.asarray(x)))
    print(f"8-channel pose net: {np.abs(ours - ref).max():.3e}")
    np.testing.assert_allclose(ours, ref, rtol=0, atol=POSE_TOL)


def test_solve_pose_with_flows_matches_jax(flax_pose):
    params, apply = flax_pose
    net = PoseNet(in_channels=8)
    net.load_state_dict(pose_state_dict(params))
    rng = np.random.RandomState(1)
    tgt = torch.from_numpy(rng.rand(2, 64, 96, 3).astype(np.float32))
    src = torch.from_numpy(rng.rand(2, 2, 64, 96, 3).astype(np.float32))
    flows = pose_flows(tgt, src)
    assert flows[0].shape == (2, 2, 64, 96, 2)
    with torch.no_grad():
        ours = solve_pose(net, tgt, src, flows)
    ref = jax_coupled.solve_pose(
        lambda im: apply(params, im), jnp.asarray(tgt.numpy()),
        jnp.asarray(src.numpy()),
        tuple(jnp.asarray(f.numpy()) for f in flows))
    for a, b in zip(ours, ref):
        print(f"solve_pose with flows: {np.abs(a.numpy() - b).max():.3e}")
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=POSE_TOL)


def test_evaluate_vo_classical_matches_jax(model_dir, tmp_path, capsys):
    """The port's CLI against JAX's ``VOEvaluator`` (``eval/vo.py``) with
    the same weights on the CLI's synthetic sequence."""
    d, params, stats = model_dir
    ref = jax_vo.VOEvaluator(
        JaxConfig(compute_dtype="float32", img_resolution="low", **CLASSICAL),
        JaxDepthNet(num_scales=1, dtype=jnp.float32),
        JaxPoseNet(dtype=jnp.float32), params, stats).run_sequence(
        make_synthetic_sequence(24, (64, 96), seed=11), batch_size=8,
        verbose=False)
    preds = str(tmp_path / "port")
    got = evaluate_vo.main(["--model_dir", d, "--iterations", "1",
                            "--synthetic", "--device", "cpu", "--save_preds",
                            preds])["synthetic"]
    assert "flow_type" not in capsys.readouterr().out
    a = np.load(os.path.join(preds, "synthetic_preds.npz"))
    for k in ("fwd_pose_vec", "inv_pose_vec"):
        ours, theirs = a[k].copy(), np.array(ref[k])
        assert ours.shape == theirs.shape == (23, 6)
        ours[:, :3] /= vo.METRIC_SCALE
        theirs[:, :3] /= vo.METRIC_SCALE
        print(f"{k}: max |port - JAX| {np.abs(ours - theirs).max():.3e}")
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=POSE_TOL)
    np.testing.assert_array_equal(a["gt_pose_vec"], ref["gt_pose_vec"])
    np.testing.assert_allclose(a["dnet_scale_factor"].ravel(),
                               np.ravel(ref["dnet_scale_factor"]),
                               rtol=REL_TOL)
    for k in ERROR_KEYS:
        print(f"{k}: port {got[k]}, JAX {ref[k]}")
        assert np.isfinite(got[k][:2]).all()
        assert nan_close(got[k], ref[k]), k
    np.testing.assert_allclose(float(got["gt_scale"]), float(ref["gt_scale"]),
                               rtol=REL_TOL)


def test_panels_with_flows_match_jax():
    cfg = Config(compute_dtype="float32", **CLASSICAL)
    depth_net, pose_net = build_models(
        cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    chip_smoke.condition_like_trained(depth_net, torch)
    params, stats = to_flax(depth_net.state_dict(), pose_net.state_dict())
    seq = make_synthetic_sequence(6, (32, 64), seed=9)
    ds = SfMWindowDataset([seq], seq_len=3, transform=get_transforms()["val"])
    ours = validate.depth_and_reconstruction_panels(cfg, depth_net, pose_net,
                                                    ds, n_samples=2)

    class Jitted:
        def __init__(self, model):
            self.apply = jax.jit(model.apply)

    theirs = jax_validate.depth_and_reconstruction_panels(
        JaxConfig(compute_dtype="float32", **CLASSICAL),
        Jitted(JaxDepthNet(num_scales=1, dtype=jnp.float32)),
        Jitted(JaxPoseNet(dtype=jnp.float32)), params, stats, ds,
        n_samples=2)
    assert sorted(ours) == sorted(theirs)
    assert ours["triplets"].shape == (2, 3, 32, 64, 3)
    for k, v in theirs.items():
        err = np.abs(ours[k] - v).max()
        print(f"panel {k}: {err:.3e}")
        if k == "exp_masks":
            np.testing.assert_array_equal(ours[k], v)
        else:
            assert err <= PANEL_TOL, k


def test_jax_iterative_solver_raises_on_flow_channels(flax_pose):
    params, _ = flax_pose
    model = JaxPoseNet(dtype=jnp.float32)
    rng = np.random.RandomState(2)
    tgt = jnp.asarray(rng.rand(1, 64, 96, 3), jnp.float32)
    src = jnp.asarray(rng.rand(1, 1, 64, 96, 3), jnp.float32)
    with pytest.raises(Exception, match="expected to generate shape"):
        jax_coupled.solve_pose_iteratively(
            2, jnp.ones((2, 1, 64, 96, 1)),
            lambda im: model.apply({"params": params}, im), tgt, src,
            jnp.eye(3)[None])


def _windows(b=1, s=2, h=32, w=64):
    rng = np.random.RandomState(3)
    tgt = torch.from_numpy(rng.rand(b, h, w, 3).astype(np.float32))
    src = torch.from_numpy(rng.rand(s, b, h, w, 3).astype(np.float32))
    K = torch.tensor([[[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]]])
    return tgt, src, K.expand(b, 3, 3)


@pytest.mark.parametrize("path", ["solver", "train_step", "pft",
                                  "vo_iterative", "vo_perturbed"])
def test_port_iterative_paths_refuse_flow_channels(path):
    from tcsfm_torch.config import PFTOptions
    from tcsfm_torch.solver.pft import PFTOptimizer
    from tcsfm_torch.train.trainer import create_train_state, train_step

    cfg = Config(compute_dtype="float32",
                 img_resolution="low", flow_type="classical", iterations=2)
    tgt, src, K = _windows()
    with pytest.raises(ValueError, match="6-channel pairs, but this pose "
                                         "net takes 8"):
        if path == "solver":
            solve_pose_iteratively(2, torch.ones(3, 1, 32, 64, 1),
                                   PoseNet(8), tgt, src, K)
        elif path == "train_step":
            state = create_train_state(cfg, device="cpu")
            train_step(state, {"target_img": tgt, "target_img_aug": tgt,
                               "source_imgs": src, "source_imgs_aug": src,
                               "intrinsics_aug": K})
        elif path == "pft":
            depth_net, pose_net = build_models(cfg, device="cpu")
            PFTOptimizer(cfg, PFTOptions(epochs=1), depth_net,
                         pose_net).optimize_window(
                {"target_img": tgt, "source_imgs": src, "intrinsics": K},
                device="cpu")
        else:
            iters = 2 if path == "vo_iterative" else 1
            run_cfg = Config(compute_dtype="float32",
                             flow_type="classical", iterations=iters)
            ev = vo.VOEvaluator(run_cfg, *build_models(run_cfg, device="cpu"),
                                device="cpu")
            ev.infer(tgt, src[:1], K,
                     trans_pert=0.1 if path == "vo_perturbed" else 0.0)


def test_train_cli_refuses_classical(tmp_path):
    with pytest.raises(ValueError, match="tcsfm/train/trainer.py"):
        train_cli.main(["--synthetic", "--flow_type", "classical",
                        "--results_dir", str(tmp_path), "--device", "cpu"])


def test_jax_written_classical_config_loads(tmp_path):
    path = str(tmp_path / "config.json")
    JaxConfig(img_resolution="low", **CLASSICAL).save(path)
    text = open(path).read()
    cfg = Config.load(path)
    assert (cfg.flow_type, cfg.iterations, cfg.pose_input_channels) == \
        ("classical", 1, 8)
    assert not any("flow_type" in note for note in json_notes(text))
    assert build_models(cfg, device="cpu")[1].in_channels == 8
    assert Config(flow_type="classical").pose_input_channels == 8
