"""The port's sequential refinement CLI with ``--refiner chain`` against
the JAX package's.

One checkpoint directory, written by the port (``save_checkpoint``,
``Config.save``; seeded nets with trained-like conditioning, ROADMAP §3),
is read by both CLIs through ``--model_dir``. The JAX CLI runs once: 7
synthetic frames at 64x96, ``--chain_block 4`` (two blocks of 4 frames
that share frame 3, so the blocks' edges partition the sequence's 6
edges), 8 epochs (4 LM iterations a block), one pyramid level, cached per
module. This holds the chain's own code in the CLI against the
reference's: the per-frame depths and DNet scales, the coupled solver's
window poses averaged per edge into ``pose_init``, the blocks' partition
and the per-edge scaling.

Held: ``pose_init`` within ``POSE_TOL`` = 1e-5 (read 7.3e-7), ``pose_opt``
within ``OPT_TOL`` = 1e-4 (read 8.7e-6), the mean first and last block
costs within ``LOSS_TOL`` = 1e-5 relative (read 2.4e-6), and the printed
errors within ``ERR_TOL``, one unit of ``compute_trajectory``'s 3-decimal
rounding (the test prints its readings with ``-s``). ``chain_ba`` itself
is held against JAX by ``test_torch_chain_ba.py``.
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
from tcsfm_torch.config import Config
from tcsfm_torch.infer import build_models
from tcsfm_torch.train.checkpoint import save_checkpoint
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

POSE_TOL = 1e-5
OPT_TOL = 1e-4
LOSS_TOL = 1e-5
# one unit of the 3-decimal rounding, and the float error of the difference
ERR_TOL = 1e-3 + 1e-9
CHAIN = ["--synthetic", "--synthetic_frames", "7", "--chain_block", "4",
         "--epochs", "8", "--pyramid_levels", "1", "--refiner", "chain"]


@pytest.fixture(scope="module")
def chain_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("chain_model"))
    cfg = Config(compute_dtype="float32", iterations=2, img_resolution="low")
    depth_net, pose_net = build_models(
        cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    chip_smoke.condition_like_trained(depth_net, torch)
    save_checkpoint(d, (depth_net, pose_net), epoch=1, best_val_loss=1.0,
                    cfg=cfg, is_best=True)

    runs = []
    for name, fn, extra in (("jax", jax_main, []),
                            ("port", seq_pft.main, ["--device", "cpu"])):
        out = tmp_path_factory.mktemp(f"{name}_chain")
        res = fn(["--model_dir", d, "--out_dir", str(out), "--out_json",
                  str(out / "r.json")] + CHAIN + extra)["synthetic"]
        runs.append((res, dict(np.load(out / "synthetic_pft.npz")),
                     str(out / "r.json")))
    return runs


def test_chain_matches_jax(chain_runs):
    (ref, ref_npz, _), (got, npz, _) = chain_runs
    assert sorted(npz) == sorted(ref_npz) == ["pose_init", "pose_opt"]
    for k, tol in (("pose_init", POSE_TOL), ("pose_opt", OPT_TOL)):
        assert npz[k].shape == ref_npz[k].shape == (6, 6)
        print(f"{k}: max |port - JAX| {np.abs(npz[k] - ref_npz[k]).max():.3e}")
        np.testing.assert_allclose(npz[k], ref_npz[k], rtol=0, atol=tol)
    assert sorted(got) == sorted(ref)
    for k in ("pft_loss_first", "pft_loss_last"):
        print(f"{k}: port {got[k]}, JAX {ref[k]}, relative gap "
              f"{abs(got[k] / ref[k] - 1):.3e}")
        np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_TOL)
    print(f"errors port {got['errors_initial']} -> "
          f"{got['errors_optimized']}, JAX {ref['errors_initial']} -> "
          f"{ref['errors_optimized']}")
    for k in ("errors_initial", "errors_optimized"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=ERR_TOL)


def test_chain_lowers_its_cost(chain_runs):
    """The cost falls, everything is finite, the two blocks give the
    sequence's N-1 edges, and ``--out_json`` holds the printed results."""
    got, npz, out_json = chain_runs[1]
    assert got["pft_loss_last"] < got["pft_loss_first"]
    assert np.isfinite(got["errors_initial"][0])
    assert np.isfinite(got["errors_optimized"][0])
    assert np.isfinite(npz["pose_opt"]).all()
    with open(out_json) as f:
        assert json.load(f)["synthetic"] == json.loads(json.dumps(got))
