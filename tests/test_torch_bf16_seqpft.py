"""``run_sequential_pft`` from a bfloat16 model directory: the port's CLI
with ``--refiner adam`` (PFT window by window) here and ``--refiner ba``
(the joint window BA, the value+Jacobian sampler's path) in
``test_torch_bf16_seqpft_ba.py`` with these checks, against the JAX
package's CLI on the same directory, on the CPU (one JAX program a file).

The directory, the rule and the one-ulp runs are ``bf16_eval_harness.py``'s
(``FRACTION`` = 3 x the larger of JAX's bfloat16-vs-float32 gap and the
port's one-ulp spread, relative L2). 6 synthetic frames at 64x96 (4
windows, one batch of 4), 2 epochs for adam (one Adam step and the
evaluation forward) and 4 for ba (2 LM iterations), ``--scaling none`` (the
translations x30 without the DNet factor, whose noise
``test_torch_bf16_eval.py`` holds apart). Held, each with a planted fault
that fails it (parity / gap / spread measured on an x86 CPU, adam then
ba): the saved ``pose_init`` (the same coupled forward in both refiners)
0.192 / 0.305 / 0.156 (fault: one window late, 1.50), ``pose_opt``
0.130 / 0.321 / 0.180 and 0.649 / 0.520 / 0.536 (at this size the
bfloat16 pose chain is mostly noise; fault: the metric x30 applied twice,
27 and 31), the losses 9.2e-3 / 1.2e-2 / 1.9e-2 and 1.2e-2 / 1.2e-2 /
7.9e-3 (fault: a loss weight 25% off, 0.25) and the printed t-ATE/r-ATE
before and after 5.3e-2 / 0.223 / 0.108 and 0.178 / 5.6e-2 / 0.263
(fault: the rotation errors in radians, not degrees, 0.84 and 0.89). In
both packages the nets hand the refiners bfloat16 depths (recorded at
``window_ba``'s door); ``window_ba`` computes in float32 (``_f32``) in
both, and adam's PFT in the nets' bfloat16 with float32 poses, as
``test_torch_bf16_pft*.py`` hold.
"""

import os

import jax  # noqa: F401  (keeps JAX on the CPU, tests/conftest.py)
import numpy as np
import pytest

import bf16_eval_harness as eh
from tcsfm.cli.run_sequential_pft import main as jax_main
from tcsfm_torch.cli import run_sequential_pft as seq_pft
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = ["--synthetic", "--synthetic_frames", "6", "--window_batch", "4",
         "--scaling", "none"]
# adam: one Adam step and the evaluation forward; ba: 2 LM iterations
EPOCHS = {"adam": 2, "ba": 4}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return eh.write_model_dirs(tmp_path_factory.mktemp("bf16_model"))


def _npz(out_dir):
    return dict(np.load(os.path.join(out_dir, "synthetic_pft.npz")))


def refiner_runs(refiner, dirs, tmp_path_factory):
    """Both packages' CLIs with ``--refiner refiner`` on the bfloat16
    directory, and the port's on the float32 one and with its images one
    ulp up and down; the dtype of the depths each hands ``window_ba``."""
    import tcsfm.solver.ba as jax_ba
    import tcsfm_torch.solver.ba as port_ba

    seen, args = {}, SMALL + ["--epochs", str(EPOCHS[refiner])]

    def recording(module, name):
        original = module.window_ba

        def window_ba(pose_prev0, pose_next0, depth0, *a, **kw):
            seen[name] = str(depth0.dtype)
            return original(pose_prev0, pose_next0, depth0, *a, **kw)
        return window_ba

    def port(dtype, name):
        out = str(tmp_path_factory.mktemp(f"{refiner}_{name}"))
        res = seq_pft.main(["--model_dir", dirs[dtype], "--device", "cpu",
                            "--out_dir", out, "--refiner", refiner] + args)
        return res["synthetic"], _npz(out)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ba, "window_ba", recording(jax_ba, "jax"))
        mp.setattr(port_ba, "window_ba", recording(port_ba, "port"))
        jd = str(tmp_path_factory.mktemp(f"{refiner}_jax"))
        out = {"jax": (jax_main(["--model_dir", dirs["bfloat16"],
                                 "--out_dir", jd, "--refiner", refiner]
                                + args)["synthetic"], _npz(jd)),
               "bfloat16": port("bfloat16", "port")}
    out["float32"] = port("float32", "port32")
    out["moved"] = []
    for i, d in enumerate(eh.DIRECTIONS):
        with eh.nudged(d):
            out["moved"].append(port("bfloat16", f"moved{i}"))
    out["refiner"], out["seen"] = refiner, seen
    return out


@pytest.fixture(scope="module", params=["adam"])
def runs(request, dirs, tmp_path_factory):
    return refiner_runs(request.param, dirs, tmp_path_factory)


def test_saved_poses_and_losses_match_jax(runs):
    (_, ref), (_, ours) = runs["jax"], runs["bfloat16"]
    f32, moved = runs["float32"][1], [m[1] for m in runs["moved"]]
    assert sorted(ours) == sorted(ref) == ["losses", "pose_init", "pose_opt"]
    metric_twice = ours["pose_opt"].copy()
    metric_twice[:, :3] *= 30.0
    faults = {"pose_init": np.roll(ours["pose_init"], 1, axis=0),
              "pose_opt": metric_twice,
              "losses": ours["losses"] * 1.25}
    for k in ("pose_init", "pose_opt", "losses"):
        assert ours[k].shape == ref[k].shape
        assert np.isfinite(ours[k]).all()
        eh.hold(ours[k], ref[k], f32[k], [m[k] for m in moved],
                f"{runs['refiner']} {k}", fault=faults[k])


def test_printed_errors_match_jax(runs):
    (ref, _), (got, _) = runs["jax"], runs["bfloat16"]
    assert sorted(got) == sorted(ref)

    def errors(res):
        return np.concatenate([eh.finite(res[k][:2]) for k in (
            "errors_initial", "errors_optimized")])

    # planted fault: the rotation errors in radians, not degrees
    fault = {k: [e * (np.pi / 180.0 if i % 2 else 1.0)
                 for i, e in enumerate(got[k])]
             for k in ("errors_initial", "errors_optimized")}
    eh.hold(errors(got), errors(ref), errors(runs["float32"][0]),
            [errors(m[0]) for m in runs["moved"]],
            f"{runs['refiner']} t-ATE/r-ATE", fault=errors(fault))
    assert got["pft_loss_last"] < got["pft_loss_first"]


def test_refiners_take_bfloat16_depths(runs):
    if runs["refiner"] != "ba":
        assert runs["seen"] == {}
        return
    assert runs["seen"] == {"jax": "bfloat16", "port": "torch.bfloat16"}
