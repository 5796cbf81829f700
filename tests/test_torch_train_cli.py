"""The port's training entry point (``tcsfm_torch.cli.train``) on the CPU,
its ``remat_coupled`` and its metric writer.

* The CLI: ``--synthetic --img_resolution low --minibatch 2`` on 4-frame
  sequences (4 training windows: 2 steps an epoch) for 2 epochs, then
  resumed with ``--load_from_checkpoint`` for a third: the files, the
  scalars of every epoch (the test sequence's from the second on), the
  best model; the resumed run starts at epoch 2 with ``step`` and the
  Adam state bit-equal to what was saved. ``--n_devices 2`` without a
  launcher raises, naming torchrun; a failure planted in
  ``trajectory_eval`` is not swallowed; a missing
  matplotlib and PIL are, and the scalars are still written. The
  real-data branch of ``load_datasets`` reads sequence files written
  here. TensorBoard
  is kept out of these runs (its import here pulls TensorFlow, ~17 s):
  images go to PNG files; ``test_metrics_writer`` drives the TensorBoard
  branch through a stand-in module.
* Two gloo ranks (``tcsfm_torch.dist.mesh.launch``, run beside the
  one-rank CLI): the same CLI run at the same global batch of 2, one row a
  rank, writes the same files and a checkpoint within the step's f32
  limit of the one-rank one (see ``test_two_ranks_write_the_one_rank_run``);
  only rank 0 writes, and the two ranks end with bit-equal weights.
* ``remat_coupled``: one training step at 64x96, B=2, S=2, 4 iterations,
  f32, with it on and off from the same state gives bit-equal losses,
  parameters and BatchNorm statistics (the recomputation repeats the same
  operations on the CPU), and 6 value calls of the sampler where there
  were 4. The step with it on, the default, is held against JAX's step
  in ``tests/test_torch_train.py``. The solver's error products and their
  gradients are bit-equal with it on and off too.
"""

import copy
import json
import os
import shutil
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chip_smoke
import torch_dist_ranks
from tcsfm_torch.cli import train as cli
from tcsfm_torch.config import Config
from tcsfm_torch.data.synthetic import make_synthetic_sequence
from tcsfm_torch.dist.mesh import launch
from tcsfm_torch.infer import build_models
from tcsfm_torch.ops import grid_sample as gs
from tcsfm_torch.solver.coupled import solve_pose_iteratively
from tcsfm_torch.train import trainer
from tcsfm_torch.train.checkpoint import load_checkpoint, save_checkpoint
from tcsfm_torch.train.logging import MetricsWriter
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARGS = ["--synthetic", "--img_resolution", "low", "--minibatch", "2",
        "--synthetic_frames", "4", "--device", "cpu", "--date", "run",
        "--compute_dtype", "float32"]
STEPS_PER_EPOCH = 2
TAGS = ("total", "l_reconstruct_forward", "l_reconstruct_inverse")


def scalars(run_dir):
    with open(os.path.join(run_dir, "logs", "scalars.jsonl")) as f:
        return {(r["tag"], r["step"]): r["value"] for r in map(json.loads, f)}


def adam_state(state):
    return copy.deepcopy(state.optimizer.state_dict()["state"])


def assert_adam_equal(a, b):
    assert sorted(a) == sorted(b) and a
    for i in a:
        assert sorted(a[i]) == ["exp_avg", "exp_avg_sq", "step"]
        for k in a[i]:
            assert torch.equal(a[i][k], b[i][k]), (i, k)


STEP_TOL = 0.5
ONE_STEP = [("3" if a == "4" else a) for a in ARGS] + [
    "--load_best_model", "--num_epochs", "2"]  # 3 frames: 2 windows, 1 step


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One training step of the CLI (``ONE_STEP``, epoch 1 from
    trained-like weights) on two gloo ranks, started in the background:
    the arguments without ``--results_dir``, the run's directory and the
    future of the ranks' results. At the raw init f32 does not resolve the
    coupled solver's poses (ROADMAP §3), so the two runs start from a
    checkpoint of conditioned nets."""
    pretrained = str(tmp_path_factory.mktemp("pretrained"))
    nets = build_models(Config(compute_dtype="float32"), device="cpu")
    chip_smoke.condition_like_trained(nets[0], torch)
    save_checkpoint(pretrained, nets, epoch=1, best_val_loss=1.0,
                    cfg=Config(compute_dtype="float32"), is_best=True)
    args = ONE_STEP + ["--pretrained_dir", pretrained]
    results = str(tmp_path_factory.mktemp("two_ranks"))
    with ThreadPoolExecutor(1) as pool:
        yield args, os.path.join(results, "run"), pool.submit(
            launch, torch_dist_ranks.cli_rank, 2,
            (args + ["--results_dir", results],), device="cpu")


@pytest.fixture(scope="module")
def run(tmp_path_factory, two_ranks):
    """Two epochs of the CLI; the run's directory, its trainer and its
    Adam state at the end (the state saved). The two-rank run of the same
    epochs runs beside it."""
    results = str(tmp_path_factory.mktemp("results"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        loop = cli.main(ARGS + ["--num_epochs", "2", "--results_dir",
                                results])
    return os.path.join(results, "run"), loop, adam_state(loop.state)


def resume(run_dir, tmp_path, monkeypatch):
    """A copy of ``run_dir`` resumed for a third epoch."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    shutil.copytree(run_dir, tmp_path / "run")
    return cli.main(ARGS + ["--num_epochs", "3", "--results_dir",
                            str(tmp_path), "--load_from_checkpoint"])


def test_cli_writes_the_run(run):
    run_dir, loop, _ = run
    assert sorted(os.listdir(run_dir)) == ["best_model", "checkpoint.msgpack",
                                           "config.json", "logs"]
    assert os.listdir(os.path.join(run_dir, "best_model")) == [
        "best_model.msgpack"]
    assert loop.state.step == 2 * STEPS_PER_EPOCH
    cfg = Config.load(os.path.join(run_dir, "config.json"))
    assert (cfg.minibatch, cfg.num_epochs, cfg.remat_coupled) == (2, 2, True)
    assert cfg.ckpt_dir == run_dir
    values = scalars(run_dir)
    for epoch in (1, 2):
        for tag in TAGS:
            for phase in ("train", "val"):
                assert np.isfinite(values[(f"{phase}/{tag}", epoch)])
    for tag in ("t_ate", "r_ate", "t_seg", "r_seg"):
        assert (f"test/{tag}", 1) not in values
        assert (f"test/{tag}", 2) in values
    assert np.isfinite(values[("test/t_ate", 2)])
    pngs = sorted(f for f in os.listdir(os.path.join(run_dir, "logs"))
                  if f.endswith(".png"))
    assert pngs == ["test_pose_components_2.png", "val_depth_2.png",
                    "val_exp_mask_2.png", "val_imgs_2.png"]


def test_cli_resumes_and_survives_missing_image_writers(
        run, tmp_path, monkeypatch, capsys):
    run_dir, _, saved = run
    loaded = {}
    real = cli.load_checkpoint

    def recording(ckpt_dir, state, load_best):
        out = real(ckpt_dir, state, load_best=load_best)
        loaded.update(step=state.step, epoch=out[1], adam=adam_state(state))
        return out

    monkeypatch.setattr(cli, "load_checkpoint", recording)
    for name in ("matplotlib", "PIL"):
        monkeypatch.setitem(sys.modules, name, None)
    loop = resume(run_dir, tmp_path, monkeypatch)
    assert (loaded["epoch"], loaded["step"]) == (2, 2 * STEPS_PER_EPOCH)
    assert_adam_equal(loaded["adam"], saved)
    assert loop.state.step == 3 * STEPS_PER_EPOCH
    out = capsys.readouterr().out
    assert "loaded checkpoint, starting at epoch 2" in out
    assert "validation visualization failed" in out
    assert "Training complete" in out
    values = scalars(str(tmp_path / "run"))
    for tag in TAGS:
        assert np.isfinite(values[(f"train/{tag}", 3)])
        assert np.isfinite(values[(f"val/{tag}", 3)])
    assert np.isfinite(values[("test/t_ate", 3)])
    assert ("train/total", 1) in values           # the log is appended


def test_trajectory_failure_is_not_swallowed(run, tmp_path, monkeypatch):
    def planted(*args, **kwargs):
        raise RuntimeError("planted trajectory fault")

    monkeypatch.setattr(cli, "trajectory_eval", planted)
    with pytest.raises(RuntimeError, match="planted trajectory fault"):
        resume(run[0], tmp_path, monkeypatch)


def test_several_devices_raise(tmp_path):
    """``--n_devices 2`` in a single process (no launcher) names the
    launch it needs; so does a global minibatch that does not divide."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        cli.main(ARGS + ["--n_devices", "2", "--results_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        cli.check_ranks(cli.parse_args(ARGS + ["--minibatch", "3"]), 2, 3)


def _checkpoint_nets(args):
    """The nets of ``--pretrained_dir``'s best model."""
    d = args[args.index("--pretrained_dir") + 1]
    state = trainer.create_train_state(Config(compute_dtype="float32"),
                                       device="cpu")
    state, _, _ = load_checkpoint(d, state, load_best=True)
    return state.depth_net, state.pose_net


def _checkpoint(run_dir):
    """The checkpoint's epoch, tensors by name and Adam first moments by
    parameter name."""
    state = trainer.create_train_state(Config(compute_dtype="float32"),
                                       device="cpu")
    state, epoch, _ = load_checkpoint(run_dir, state, load_best=False)
    nets = (("depth", state.depth_net), ("pose", state.pose_net))
    moments = state.optimizer.state_dict()["state"]
    names = [f"{n}.{k}" for n, m in nets for k, _ in m.named_parameters()]
    return epoch, {f"{n}.{k}": v for n, m in nets
                   for k, v in m.state_dict().items()}, {
        k: moments[i]["exp_avg"] for i, k in enumerate(names)}


def test_two_ranks_write_the_one_rank_checkpoint(tmp_path, monkeypatch,
                                                 two_ranks):
    """One step of the CLI on two ranks, a row of the global batch of 2
    each, against the same step on one rank: the same files; the train
    scalars (the global batch's losses before the step) within 1e-5; a
    checkpoint within the step's f32 limit: the Adam first moments (0.1 x
    the gradient) within 5e-2 relative L2 a tensor, the f32 gradient limit
    of tests/test_torch_train.py (read: 1.6e-2), and the BatchNorm
    statistics within 1e-5. Adam's first step is lr x sign(gradient), so
    where f32 does not resolve a gradient element's sign the runs step
    apart: the parameters' steps within STEP_TOL relative L2 a tensor
    (read: 0.177; per-rank BatchNorm statistics flip about half the signs,
    ~1.4), and the test trajectory's errors after the step within 5%
    (read: 1.5%). The gradient of ``pose.conv1.0.bias`` is analytically 0
    (a one-channel-a-group GroupNorm follows) and is held as small."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    args, two_dir, future = two_ranks
    loop = cli.main(args + ["--results_dir", str(tmp_path)])
    one_dir = os.path.join(str(tmp_path), "run")
    ranks = future.result(timeout=600)
    assert [r["step"] for r in ranks] == [1, 1] and loop.state.step == 1
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert sorted(os.listdir(two_dir)) == sorted(os.listdir(one_dir))
    assert sorted(os.listdir(os.path.join(two_dir, "logs"))) == sorted(
        os.listdir(os.path.join(one_dir, "logs")))
    one, two = scalars(one_dir), scalars(two_dir)
    assert sorted(one) == sorted(two) and ("test/t_ate", 2) in one
    for key, v in one.items():
        if key[0].startswith("train/"):
            assert abs(two[key] - v) <= 1e-5, (key, two[key], v)
        elif np.isfinite(v):
            assert abs(two[key] - v) <= 0.05 * abs(v), (key, two[key], v)
        else:
            assert not np.isfinite(two[key]), key
    init = {f"{n}.{k}": v for n, m in zip(("depth", "pose"),
                                          _checkpoint_nets(args))
            for k, v in m.state_dict().items()}
    (e1, w1, m1), (e2, w2, m2) = _checkpoint(one_dir), _checkpoint(two_dir)
    assert e1 == e2 == 2          # resumes after epoch 1
    largest = max(a.norm().item() for a in m1.values())
    for k, a in m1.items():
        if k == "pose.conv1.0.bias":
            assert max(a.norm(), m2[k].norm()).item() <= 1e-6 * largest
        else:
            assert ((m2[k] - a).norm() / a.norm()).item() <= 5e-2, k
    for k, v in w1.items():
        if not v.is_floating_point():
            assert torch.equal(v, w2[k]), k
        elif "running" in k:
            assert (w2[k] - v).abs().max().item() <= 1e-5, k
        elif k != "pose.conv1.0.bias":
            step = (v - init[k]).norm()
            assert ((w2[k] - v).norm() / step).item() <= STEP_TOL, k


def test_the_card_by_default_and_tpu_flags_accepted(tmp_path, monkeypatch):
    """Without ``--device`` the CLI wants the card and raises where there
    is none; the JAX CLI's TPU sampler flags parse and change nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    no_device = [a for a in ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(no_device + ["--results_dir", str(tmp_path)])
    flags = ["--no_mxu_warp", "--fast_sampler", "--mixed_sampler"]
    args = cli.parse_args(ARGS + flags)
    assert cli.build_config(args) == cli.build_config(cli.parse_args(ARGS))


def test_load_datasets_reads_sequence_files(tmp_path):
    """The real-data branch on files written here: ``<seq>.npz`` and
    ``<seq>/sequence_data.npz``, named or as ``all`` (every sequence but
    the val and test ones); 4 frames make 2 windows of 3 a sequence."""
    written = {}
    for i, name in enumerate(("a", "b", "v", "t")):
        seq = make_synthetic_sequence(4, (64, 96), seed=i)
        path = tmp_path / (f"{name}.npz" if name != "b" else "b")
        if name == "b":
            path.mkdir()
            path = path / "sequence_data.npz"
        seq.save_npz(str(path))
        written[name] = seq
    for train in (["a", "b"], ["all"]):
        args = cli.parse_args(["--data_dir", str(tmp_path), "--train_seq",
                               *train, "--val_seq", "v", "--test_seq", "t",
                               "--device", "cpu"])
        train_ds, val_ds, test_ds, test_seqs = cli.load_datasets(
            cli.build_config(args), args)
        assert (len(train_ds), len(val_ds), len(test_ds)) == (4, 2, 2)
        assert [len(s) for s in train_ds.sequences] == [4, 4]
        np.testing.assert_array_equal(test_seqs[0].gt_poses,
                                      written["t"].gt_poses)
        np.testing.assert_array_equal(train_ds.sequences[1].gt_poses,
                                      written["b"].gt_poses)
        assert train_ds[0]["target_img_aug"].shape == (64, 96, 3)


def test_metrics_writer(tmp_path, monkeypatch):
    """Scalars always to ``scalars.jsonl``; with TensorBoard, scalars and
    images to it too; without it, images as PNG files through PIL, and
    without PIL the ``ImportError`` naming it."""
    calls = []

    class SummaryWriter:
        def __init__(self, log_dir, comment):
            calls.append(("init", log_dir))

        def __getattr__(self, name):
            return lambda *args, **kwargs: calls.append((name,) + args[:1])

    img = np.zeros((4, 6, 3), np.uint8)
    stub = types.ModuleType("torch.utils.tensorboard")
    stub.SummaryWriter = SummaryWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", stub)
    w = MetricsWriter(str(tmp_path / "tb"))
    w.add_scalar("a/b", 1.5, 3)
    w.add_image("c/d", img, 3)
    w.close()
    assert calls == [("init", str(tmp_path / "tb")), ("add_scalar", "a/b"),
                     ("add_image", "c/d"), ("close",)]

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = MetricsWriter(str(tmp_path / "png"))
    w.add_image("c/d", img, 3)
    assert sorted(os.listdir(tmp_path / "png")) == ["c_d_3.png",
                                                    "scalars.jsonl"]
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        w.add_image("e/f", img, 4)
    w.add_scalar("g/h", 2.0, 4)
    w.close()
    for d in ("tb", "png"):
        with open(tmp_path / d / "scalars.jsonl") as f:
            rows = [json.loads(line) for line in f]
        assert [(r["tag"], r["step"]) for r in rows] == (
            [("a/b", 3)] if d == "tb" else [("g/h", 4)])


@pytest.fixture(scope="module")
def remat_steps():
    """One training step with ``remat_coupled`` on and one with it off from
    the same trained-like state, through a sampler that records the
    channels of each call: by setting, (losses, every tensor of the nets,
    the calls)."""
    batch = chip_smoke.train_batch(torch, 2, 2, 64, 96, seed=3, device="cpu")
    base = trainer.create_train_state(
        Config(compute_dtype="float32"), device="cpu",
        generator=torch.Generator().manual_seed(4))
    chip_smoke.condition_like_trained(base.depth_net, torch)
    out = {}
    for remat in (True, False):
        state = copy.deepcopy(base)
        state.cfg = Config(compute_dtype="float32", remat_coupled=remat)
        calls = []

        def counting(img, coords, tail=None):
            calls.append(img.shape[-1]
                         + (0 if tail is None else tail.shape[-1]))
            return gs.grid_sample(img, coords, tail)

        losses = trainer.train_step(state, batch, sampler=counting)
        out[remat] = (losses, {f"{n}.{k}": v.clone() for n, m in (
            ("depth", state.depth_net), ("pose", state.pose_net))
            for k, v in m.state_dict().items()}, calls)
    return out


@pytest.mark.parametrize("remat", [True, False])
def test_remat_counts_value_calls(remat_steps, remat):
    calls = remat_steps[remat][2]
    # the first warp, the two iteration bodies' (twice with remat: once in
    # the forward, once recomputed in the backward), the loss's 4-channel
    assert calls == ([3, 3, 3, 4, 3, 3] if remat else [3, 3, 3, 4])
    assert len(calls) == chip_smoke.step_launches(4, remat)[0]


def test_remat_changes_no_number(remat_steps):
    (l_on, t_on, _), (l_off, t_off, _) = remat_steps[True], remat_steps[False]
    assert sorted(l_on) == sorted(l_off)
    for k in l_off:
        assert torch.equal(l_on[k], l_off[k]), k
    assert sorted(t_on) == sorted(t_off)
    for k in t_off:
        assert torch.equal(t_on[k], t_off[k]), k


def test_remat_with_error_products():
    """``return_errors=True`` with remat (every iteration a recomputed
    body, the last one 4-channel): outputs and the pose net's and depths'
    gradients bit-equal to the path without it."""
    cfg = Config(compute_dtype="float32")
    _, pose_net = build_models(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(5))
    b = chip_smoke.train_batch(torch, 2, 2, 64, 96, seed=3, device="cpu")
    rng = np.random.RandomState(6)
    depths0 = torch.from_numpy(
        (1.0 + rng.rand(3, 2, 64, 96, 1)).astype(np.float32))
    grads = {}
    for remat in (True, False):
        pose_net.zero_grad(set_to_none=True)
        depths = depths0.clone().requires_grad_(True)
        poses, poses_inv, errs = solve_pose_iteratively(
            cfg.iterations, depths, pose_net, b["target_img"],
            b["source_imgs"], b["intrinsics_aug"], return_errors=True,
            remat=remat)
        loss = (errs["fwd"].diff_img.mean() + errs["inv"].diff_img.mean()
                + poses.square().sum() + poses_inv.square().sum())
        loss.backward()
        grads[remat] = [loss.detach(), depths.grad] + [
            p.grad for p in pose_net.parameters()]
    for a, c in zip(grads[True], grads[False]):
        assert torch.equal(a, c)
