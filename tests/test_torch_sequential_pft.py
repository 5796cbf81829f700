"""The port's sequential refinement CLI (``tcsfm_torch.cli.
run_sequential_pft``) against the JAX package's, and its refiners on the
CPU.

One checkpoint directory, written by the port (``save_checkpoint``,
``Config.save``; seeded nets with trained-like conditioning, ROADMAP §3),
is read by both CLIs through ``--model_dir``. The JAX CLI runs once
(``--refiner gn``, 6 synthetic frames at 64x96, 3 epochs, window batch 4),
cached per module.

Held against JAX (``gn``): the saved ``pose_init`` within ``POSE_TOL`` =
1e-5 (the coupled solver's poses, x30 and the DNet factor), ``pose_opt``
within ``OPT_TOL`` = 1e-4, the losses within ``LOSS_TOL`` = 1e-5
relative, and the printed errors within ``ERR_TOL`` = 1e-3, one unit of
``compute_trajectory``'s 3-decimal rounding (the test prints its
readings with ``-s``). PFT itself is held against JAX in float64 by
``test_torch_pft_jax.py``; here ``adam`` is held against the port's own
``PFTOptimizer``, bit for bit.
"""

import json
import os

import jax  # noqa: F401  (keeps JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest
import torch

import chip_smoke
from tcsfm.cli.run_sequential_pft import main as jax_main
from tcsfm_torch.cli import run_sequential_pft as seq_pft
from tcsfm_torch.cli.common import load_nets
from tcsfm_torch.config import Config, PFTOptions
from tcsfm_torch.data.dataset import SfMWindowDataset
from tcsfm_torch.data.loader import BatchLoader
from tcsfm_torch.data.synthetic import make_synthetic_sequence
from tcsfm_torch.data.transforms import WindowTransform
from tcsfm_torch.infer import build_models
from tcsfm_torch.solver.pft import PFTOptimizer
from tcsfm_torch.train.checkpoint import save_checkpoint
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

POSE_TOL = 1e-5
OPT_TOL = 1e-4
LOSS_TOL = 1e-5
ERR_TOL = 1e-3
SMALL = ["--synthetic", "--synthetic_frames", "6", "--epochs", "3",
         "--window_batch", "4"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("seq_model"))
    cfg = Config(iterations=2, img_resolution="low")
    depth_net, pose_net = build_models(
        cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    chip_smoke.condition_like_trained(depth_net, torch)
    save_checkpoint(d, (depth_net, pose_net), epoch=1, best_val_loss=1.0,
                    cfg=cfg, is_best=True)
    return d


def port(model_dir, out_dir, extra):
    res = seq_pft.main(["--model_dir", model_dir, "--device", "cpu",
                        "--out_dir", out_dir] + extra)
    return res["synthetic"], dict(np.load(os.path.join(out_dir,
                                                       "synthetic_pft.npz")))


@pytest.fixture(scope="module")
def gn_runs(model_dir, tmp_path_factory):
    jd = str(tmp_path_factory.mktemp("jax_gn"))
    ref = jax_main(["--model_dir", model_dir, "--out_dir", jd,
                    "--refiner", "gn"] + SMALL)["synthetic"]
    ours = port(model_dir, str(tmp_path_factory.mktemp("port_gn")),
                ["--refiner", "gn"] + SMALL)
    return (ref, dict(np.load(os.path.join(jd, "synthetic_pft.npz")))), ours


def test_gn_matches_jax(gn_runs):
    (ref, ref_npz), (got, npz) = gn_runs
    assert sorted(npz) == sorted(ref_npz) == ["losses", "pose_init",
                                              "pose_opt"]
    for k, tol in (("pose_init", POSE_TOL), ("pose_opt", OPT_TOL)):
        assert npz[k].shape == ref_npz[k].shape == (4, 6)
        print(f"{k}: max |port - JAX| {np.abs(npz[k] - ref_npz[k]).max():.3e}")
        np.testing.assert_allclose(npz[k], ref_npz[k], rtol=0, atol=tol)
    rel = np.abs(npz["losses"] / ref_npz["losses"] - 1).max()
    print(f"losses: max relative gap {rel:.3e}; errors port "
          f"{got['errors_optimized']}, JAX {ref['errors_optimized']}")
    np.testing.assert_allclose(npz["losses"], ref_npz["losses"],
                               rtol=LOSS_TOL)
    assert sorted(got) == sorted(ref)
    for k in ("errors_initial", "errors_optimized"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=ERR_TOL)
    for k in ("pft_loss_first", "pft_loss_last"):
        np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_TOL)
    assert got["pft_loss_last"] < got["pft_loss_first"]


def windows(seq, batch):
    ds = SfMWindowDataset([seq], seq_len=3,
                          transform=WindowTransform(jitter=False,
                                                    flip_prob=None))
    for b in BatchLoader(ds, batch, shuffle=False, drop_last=False):
        yield {k: b[k] for k in ("target_img", "source_imgs", "intrinsics")}


def test_adam_is_pft_window_by_window(model_dir, tmp_path):
    """Window batch 2 over 3 windows: two PFT calls (the second on one
    window), each the same as a direct ``optimize_window`` on its batch,
    bit for bit; ``--scaling none`` keeps the rotations and takes the DNet
    factor off the translations, row by row."""
    extra = ["--synthetic", "--synthetic_frames", "5", "--epochs", "2",
             "--window_batch", "2", "--refiner", "adam"]
    got, npz = port(model_dir, str(tmp_path / "un"), extra)
    _, npz_none = port(model_dir, str(tmp_path / "none"),
                       extra + ["--scaling", "none"])

    depth_net, pose_net = load_nets(model_dir, "cpu")
    opt = PFTOptimizer(Config(iterations=2),
                       PFTOptions(epochs=2, avg_final_epochs=5,
                                  num_source_imgs=2),
                       depth_net, pose_net, mode="encoder")
    results = [opt.optimize_window(b, device="cpu") for b in windows(
        make_synthetic_sequence(5, (64, 96), seed=13), 2)]
    assert [r.poses_opt.shape[1] for r in results] == [2, 1]
    np.testing.assert_array_equal(
        npz["losses"], np.stack([r.losses.numpy() for r in results]))
    for key, scale in (("pose_init", "scale_init"),
                       ("pose_opt", "scale_opt")):
        fwd = "poses_init" if key == "pose_init" else "poses_opt"
        inv = "poses_inv_init" if key == "pose_init" else "poses_inv_opt"
        want = np.concatenate([
            ((getattr(r, fwd)[1] - getattr(r, inv)[1]) / 2.0).numpy()
            for r in results])
        sc = np.concatenate([np.full(getattr(r, fwd).shape[1],
                                     float(getattr(r, scale)))
                             for r in results])
        want[:, :3] *= (30.0 * sc)[:, None]
        np.testing.assert_array_equal(npz[key], want)

        np.testing.assert_array_equal(npz_none[key][:, 3:], npz[key][:, 3:])
        ratio = (np.linalg.norm(npz[key][:, :3], axis=1)
                 / np.linalg.norm(npz_none[key][:, :3], axis=1))
        np.testing.assert_allclose(ratio, sc, rtol=1e-6)
    assert not np.allclose(sc, 1.0)
    assert np.isfinite(got["errors_initial"][0])
    assert np.isfinite(got["errors_optimized"][0])


@pytest.mark.parametrize("refiner,extra,edges", [
    ("ba", [], 4),
    ("chain", ["--init_gt_pert", "0.1", "--gt_depth"], 5),
])
def test_refiners_lower_their_cost(model_dir, tmp_path, refiner, extra,
                                   edges):
    """ba, and chain with its two controls (one block, on a 2-level
    pyramid): the cost falls, everything is finite, the chain gives the
    sequence's N-1 edges. ``test_torch_sequential_chain.py`` holds the
    chain against JAX's CLI."""
    out_json = str(tmp_path / "r.json")
    got, npz = port(model_dir, str(tmp_path / refiner),
                    ["--synthetic", "--synthetic_frames", "6", "--epochs",
                     "8", "--refiner", refiner, "--out_json", out_json]
                    + extra)
    assert got["pft_loss_last"] < got["pft_loss_first"]
    assert np.isfinite(got["errors_initial"][0])
    assert np.isfinite(got["errors_optimized"][0])
    assert np.isfinite(npz["pose_opt"]).all()
    assert npz["pose_opt"].shape == npz["pose_init"].shape == (edges, 6)
    with open(out_json) as f:
        assert json.load(f)["synthetic"] == json.loads(json.dumps(got))


def test_file_backed_sequence(model_dir, tmp_path):
    """A ``--data_dir`` sequence stored as uint8 frames: the windows read
    k/255 frames, as a direct PFT call on them does."""
    seq = make_synthetic_sequence(5, (64, 96), seed=13)
    seq.images = np.round(seq.images * 255.0).astype(np.uint8)
    seq.name = "drive_u8"
    os.makedirs(tmp_path / "data" / "u8")
    seq.save_npz(str(tmp_path / "data" / "u8" / "sequence_data.npz"))
    res = seq_pft.main(["--model_dir", model_dir, "--device", "cpu",
                        "--data_dir", str(tmp_path / "data"), "--seqs", "u8",
                        "--epochs", "2", "--refiner", "adam",
                        "--out_dir", str(tmp_path / "out")])
    npz = np.load(tmp_path / "out" / "u8_pft.npz")
    assert npz["pose_opt"].shape == (3, 6)
    assert np.isfinite(res["u8"]["errors_optimized"][0])

    depth_net, pose_net = load_nets(model_dir, "cpu")
    opt = PFTOptimizer(Config(iterations=2),
                       PFTOptions(epochs=2, avg_final_epochs=5,
                                  num_source_imgs=2),
                       depth_net, pose_net, mode="encoder")
    batch = next(windows(seq, 4))
    assert batch["target_img"].dtype == np.float32
    np.testing.assert_array_equal(
        npz["losses"][0], opt.optimize_window(batch, device="cpu")
        .losses.numpy())
