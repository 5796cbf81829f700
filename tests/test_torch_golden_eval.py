"""The port's golden accuracy harness (``tcsfm_torch.cli.golden_eval``)
against the JAX package's (``tcsfm.cli.golden_eval``).

Held: the anchors, tolerances and ``compare_to_baseline`` equal to JAX's;
both gate functions equal to JAX's on ``tests/test_cli.py``'s recorded
metrics, with R = 1.0 passing and R = 1.1 failing (every synthetic gate;
the named warm-start gates); every flag the port keeps parsing to JAX's
default (the five gate flags of the two TPU sampler A/Bs are not kept, and
``--device`` is the port's); the A/Bs refused with a message;
``run_real`` turnkey on a 16-frame 64x96 sequence, run as ``python -m``
(exit code 0 only on a pass); a tiny ``--synthetic`` run (``--force_cpu``)
returning JAX's keys and writing the warm-start handoff.
"""

import argparse
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import test_cli as jax_cli_tests
from tcsfm.cli import golden_eval as jax_golden
from tcsfm_torch.cli import golden_eval as golden
from tcsfm_torch.config import Config
from tcsfm_torch.data.synthetic import make_synthetic_sequence
from tcsfm_torch.infer import build_models
from tcsfm_torch.train.checkpoint import save_checkpoint
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYN = jax_cli_tests.TestSyntheticGateSensitivity
WARM = jax_cli_tests.TestWarmStartGateSensitivity
NOT_KEPT = {"ab_pose_gate", "ab_ate_gate", "ab_seeds", "train_ab_loss_gate",
            "train_ab_ate_gate"}


def test_anchors_and_tolerances_equal():
    assert golden.BASELINES == jax_golden.BASELINES
    assert golden.ABS_TOL == jax_golden.ABS_TOL
    assert golden.REL_TOL == jax_golden.REL_TOL


@pytest.mark.parametrize("seq,errors", [
    ("09_02", (33.0, 2.9, 3.9, 0.7)),
    ("09_02", (40.0, 3.0, 4.5, 0.95)),
    ("10_02", (19.0, float("nan"), 3.5, 0.9)),
    ("00_02", (1.0, 2.0, 3.0, 4.0)),
])
def test_compare_to_baseline_equal(seq, errors, capsys):
    ours = golden.compare_to_baseline(seq, errors)
    ref = jax_golden.compare_to_baseline(seq, errors)
    assert json.dumps(ours) == json.dumps(ref)
    golden.print_table(seq, ours)
    mine = capsys.readouterr().out
    jax_golden.print_table(seq, ref)
    assert mine == capsys.readouterr().out


@pytest.mark.parametrize("inject", [1.0, 1.1])
def test_synthetic_gates_equal_jax(inject):
    raw = dict(SYN.RAW, mode="synthetic")
    ours = golden.apply_synthetic_gates(raw, **SYN.DEFAULTS,
                                        inject_regression=inject)
    assert ours == jax_golden.apply_synthetic_gates(
        raw, **SYN.DEFAULTS, inject_regression=inject)
    if inject == 1.0:
        assert ours["pass"], ours["gates"]
    else:
        assert not any(ours["gates"].values()), ours["gates"]


@pytest.mark.parametrize("inject", [1.0, 1.1])
def test_warm_gates_equal_jax(inject):
    ours = golden.apply_warm_gates(WARM.RAW, **WARM.DEFAULTS,
                                   inject_regression=inject)
    assert ours == jax_golden.apply_warm_gates(
        WARM.RAW, **WARM.DEFAULTS, inject_regression=inject)
    if inject == 1.0:
        assert ours["pass"], ours["gates"]
    else:
        assert not ours["pass"]
        for name in ("vo_pose_parity", "pft_loss_parity", "pft_ate_parity",
                     "native_loss_no_regression", "native_rot_no_regression"):
            assert not ours["gates"][name], name


class _Parsed(Exception):
    pass


def jax_defaults(monkeypatch):
    """JAX's parser's defaults: its ``main`` builds the parser inline, so
    the parse is caught on its way out."""
    real = argparse.ArgumentParser.parse_args

    def catch(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed) as got:
        jax_golden.main([])
    monkeypatch.undo()
    return vars(got.value.args[0])


def test_kept_flags_default_as_jax(monkeypatch):
    ref = jax_defaults(monkeypatch)
    ours = vars(golden.parse_args([]))
    assert set(ours) == (set(ref) - NOT_KEPT) | {"device"}
    for k in set(ours) - {"device"}:
        assert ours[k] == ref[k], k
    # the gates' defaults are the ones tests/test_cli.py records
    recorded = dict(SYN.DEFAULTS, **{f"warm_{k}": v
                                     for k, v in WARM.DEFAULTS.items()})
    for flag, val in recorded.items():
        assert ours[flag] == val, flag


@pytest.mark.parametrize("flag", ["--fast_sampler_ab", "--train_sampler_ab"])
def test_tpu_sampler_ab_refused(flag):
    with pytest.raises(SystemExit, match="exact in f32"):
        golden.main([flag, "--synthetic", "--device", "cpu"])


def test_warm_start_gate_wants_the_card():
    with pytest.raises(SystemExit, match="needs the card"):
        golden.main(["--warm_start_gate", "--device", "cpu"])


def test_phase_a_command_is_jax_s_on_the_port():
    """The CPU phase is this CLI's ``--synthetic`` on the CPU with the
    gate's data, training and PFT settings passed on."""
    args = golden.parse_args(["--seed_offset", "100", "--train_epochs", "3",
                              "--synthetic_size", "32", "64"])
    cmd = golden.phase_a_command(args, "w")
    assert cmd[1:3] == ["-m", "tcsfm_torch.cli.golden_eval"]
    sub = golden.parse_args(cmd[3:])
    assert (sub.synthetic, sub.device, sub.save_dir) == (True, "cpu", "w")
    for k in ("train_epochs", "pft_epochs", "synthetic_frames",
              "synthetic_size", "lr", "seed_offset"):
        assert tuple(np.atleast_1d(getattr(sub, k))) == tuple(
            np.atleast_1d(getattr(args, k))), k


def test_refusal_exits_non_zero():
    r = subprocess.run([sys.executable, "-m", "tcsfm_torch.cli.golden_eval",
                        "--fast_sampler_ab"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 1 and "exact in f32" in r.stderr


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("golden_model"))
    cfg = Config(compute_dtype="float32", iterations=2, img_resolution="low")
    depth_net, pose_net = build_models(
        cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    chip_smoke.condition_like_trained(depth_net, torch)
    save_checkpoint(d, (depth_net, pose_net), epoch=1, best_val_loss=1.0,
                    cfg=cfg, is_best=True)
    return d


def test_run_real_turnkey(model_dir, tmp_path, monkeypatch, capsys):
    """The anchored table from a model dir and a sequence dir, run as
    ``python -m``: four rows with their anchors; the verdicts of these
    weights are printed, and the exit code follows ``pass``."""
    d = tmp_path / "data" / "09_02"
    d.mkdir(parents=True)
    make_synthetic_sequence(16, (64, 96), seed=3).save_npz(
        str(d / "sequence_data.npz"))
    monkeypatch.setattr(sys, "argv", [
        "golden_eval", "--model_dir", model_dir, "--data_dir",
        str(tmp_path / "data"), "--seqs", "09_02", "--batch", "4",
        "--device", "cpu"])
    with pytest.raises(SystemExit) as code:
        runpy.run_path(golden.__file__, run_name="__main__")
    text = capsys.readouterr().out
    out = json.loads(text[text.index("{\n"):])
    rows = out["seqs"]["09_02"]["rows"]
    print(text)
    assert {r["metric"] for r in rows} == {"t_err", "r_err", "t_ate",
                                           "r_ate"}
    assert all(r["baseline"] == golden.BASELINES["09_02"][r["metric"]]
               and "tol" in r for r in rows)
    assert all(r["status"] in ("PASS", "FAIL") for r in rows)
    assert code.value.code == (0 if out["pass"] else 1)


def test_tiny_synthetic_returns_jax_keys(tmp_path):
    save = str(tmp_path / "warm")
    out = golden.main(["--synthetic", "--force_cpu", "--train_epochs", "1",
                       "--pft_epochs", "2", "--synthetic_frames", "6",
                       "--save_dir", save])
    ref = jax_golden.apply_synthetic_gates(dict(SYN.RAW, mode="synthetic"),
                                           **SYN.DEFAULTS)
    assert sorted(out) == sorted(ref)
    assert sorted(out["gates"]) == sorted(ref["gates"])
    assert all(np.isfinite(v) for k, v in out.items()
               if isinstance(v, float))
    for name in ("checkpoint.msgpack", "config.json", "warm_eval.npz",
                 "warm_metrics.json"):
        assert os.path.exists(os.path.join(save, name)), name
    with open(os.path.join(save, "warm_metrics.json")) as f:
        saved = json.load(f)
    assert saved["rot_err_trained"] == out["rot_err_trained"]
    assert np.load(os.path.join(save, "warm_eval.npz"))[
        "fwd_pose_vec"].shape == (15, 6)


def port_nets_from_jax_init(cfg):
    """The port's nets holding the JAX package's synthetic-gate init
    (``create_train_state`` of its ``run_synthetic`` config at
    ``PRNGKey(0)``), which its recorded metrics start from."""
    import jax

    from tcsfm.config import Config as JaxConfig
    from tcsfm.train.trainer import create_train_state
    from tcsfm_torch.models.convert import from_flax

    jcfg = JaxConfig(iterations=2, img_resolution="low", minibatch=4,
                     lr=5e-5, compute_dtype="float32", num_scales=1)
    state, _, _ = create_train_state(jcfg, jax.random.PRNGKey(0),
                                     steps_per_epoch=32)

    def host(tree):
        return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))

    depth_sd, pose_sd = from_flax(host(state.params), host(state.batch_stats))
    depth_net, pose_net = build_models(cfg, device="cpu")
    depth_net.load_state_dict(depth_sd)
    pose_net.load_state_dict(pose_sd)
    return depth_net, pose_net


UNTRAINED_RTOL = 1e-4


def test_untrained_metrics_from_jax_init():
    """From the JAX package's init, the port's synthetic-gate evaluation
    (``_pose_metrics``, ``_depth_abs_rel``) gives the untrained metrics that
    ``tests/test_cli.py`` records for JAX, within ``UNTRAINED_RTOL`` = 1e-4
    relative (read: rot_err 4.5e-7, trans_dir_err 7.4e-6, abs_rel 4.6e-6;
    the 3-decimal t-ATE equal). The raw init's saturated sigmoids are
    where f32 resolves the coupled forward least (ROADMAP §3)."""
    from tcsfm_torch.eval.vo import VOEvaluator

    cfg = Config(compute_dtype="float32",
                 iterations=2, img_resolution="low", minibatch=4, lr=5e-5,
                 num_scales=1)
    depth_net, pose_net = port_nets_from_jax_init(cfg)
    seq = make_synthetic_sequence(24, (64, 96), seed=11)
    m = golden._pose_metrics(VOEvaluator(cfg, depth_net, pose_net,
                                         dnet_rescaling=False, device="cpu"),
                             seq)
    got = {"rot_err_untrained": m["rot_err"],
           "trans_dir_err_untrained": m["trans_dir_err"],
           "ate_untrained": m["t_ate"],
           "abs_rel_untrained": golden._depth_abs_rel(depth_net, seq, cfg,
                                                      "cpu")}
    for k, v in got.items():
        rel = abs(v - SYN.RAW[k]) / abs(SYN.RAW[k])
        print(f"{k}: port {v!r}, JAX recorded {SYN.RAW[k]!r}, rel {rel:.2e}")
        assert rel <= UNTRAINED_RTOL, k


if __name__ == "__main__":
    # python tests/test_torch_golden_eval.py [golden_eval flags]: the
    # port's synthetic gate on the CPU from the JAX package's init instead
    # of the port's own seeded one (the from-scratch trajectory depends on
    # the init's draws)
    import jax

    from tcsfm_torch.train import trainer

    jax.config.update("jax_platforms", "cpu")
    seeded = trainer.create_train_state

    def from_jax_init(cfg, device=None, generator=None, steps_per_epoch=1000):
        state = seeded(cfg, device=device, generator=generator,
                       steps_per_epoch=steps_per_epoch)
        nets = port_nets_from_jax_init(cfg)
        state.depth_net.load_state_dict(nets[0].state_dict())
        state.pose_net.load_state_dict(nets[1].state_dict())
        return state

    trainer.create_train_state = from_jax_init
    result = golden.main(["--synthetic", "--device", "cpu"] + sys.argv[1:])
    sys.exit(0 if result.get("pass") else 1)
