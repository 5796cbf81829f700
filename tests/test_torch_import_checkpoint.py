"""The port's reference-checkpoint import (``tcsfm_torch.models.torch_import``,
``tcsfm_torch.cli.import_checkpoint``) against the JAX package's.

A seeded state dict in the reference's layout (the port's nets'
``state_dict``: its names are the reference's) goes through both
converters: the port's output is held bit-equal to JAX's
``convert_reference_checkpoint`` followed by the port's
``convert.from_flax``, and the same for the torchvision mode
(``convert_torchvision_resnet18``, ``warm_start_encoder``). Then both
packages' CLIs import one ``.pt`` file (one JAX CLI call), and JAX's
``load_checkpoint`` reads both outputs, bit-equal: the weights
(``load_best=True``) and the fresh optimizer state (``load_best=False``).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tcsfm.cli import import_checkpoint as jax_cli
from tcsfm.models import torch_import as jax_ti
from tcsfm_torch.cli import import_checkpoint
from tcsfm_torch.config import Config
from tcsfm_torch.infer import build_models
from tcsfm_torch.models import torch_import as ti
from tcsfm_torch.models.convert import depth_state_dict, from_flax, to_flax
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ENC = "encoder.encoder."


def seeded_nets(seed):
    """Seeded nets with random BatchNorm running statistics, so the import
    of the statistics shows."""
    depth_net, pose_net = build_models(
        Config(compute_dtype="float32"), device="cpu",
        generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    for name, buf in depth_net.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(torch.randn(buf.shape, generator=g) * 0.1)
        elif name.endswith("running_var"):
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
        elif name.endswith("num_batches_tracked"):
            buf.fill_(7)
    return depth_net, pose_net


def reference_ckpt(seed=5):
    depth_net, pose_net = seeded_nets(seed)
    return {"depth_state_dict": depth_net.state_dict(),
            "pose_state_dict": pose_net.state_dict(),
            "epoch": 5, "best_val_loss": 0.5}


def assert_sd_equal(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype, k
        assert torch.equal(ours[k], theirs[k]), k


def test_reference_import_matches_jax():
    ckpt = reference_ckpt()
    ours = ti.convert_reference_checkpoint(ckpt)
    ref = jax_ti.convert_reference_checkpoint(ckpt)
    depth_sd, pose_sd = from_flax(
        {"depth": ref["depth"]["params"], "pose": ref["pose"]["params"]},
        ref["depth"]["batch_stats"])
    assert_sd_equal(ours["depth"], depth_sd)
    assert_sd_equal(ours["pose"], pose_sd)
    assert (ours["epoch"], ours["best_val_loss"]) == (ref["epoch"],
                                                      ref["best_val_loss"])
    # loads into the port's nets, statistics as stored
    depth_net, pose_net = build_models(Config(compute_dtype="float32"),
                                       device="cpu")
    depth_net.load_state_dict(ours["depth"])
    pose_net.load_state_dict(ours["pose"])
    src = ckpt["depth_state_dict"]
    assert torch.equal(depth_net.state_dict()[f"{ENC}bn1.running_var"],
                       src[f"{ENC}bn1.running_var"])


def test_import_drops_extras_and_needs_every_key():
    ckpt = reference_ckpt()
    sd = dict(ckpt["depth_state_dict"], **{"fc.weight": torch.zeros(2)})
    assert "fc.weight" not in ti.convert_depth_state_dict(sd)
    del sd[f"{ENC}layer3.0.downsample.1.running_mean"]
    with pytest.raises(KeyError):
        ti.convert_depth_state_dict(sd)
    pose = dict(ckpt["pose_state_dict"])
    del pose["conv7.1.bias"]
    with pytest.raises(KeyError):
        ti.convert_pose_state_dict(pose)


def torchvision_sd(seed=6):
    """A torchvision resnet18 state dict: the encoder's entries without
    their prefix, ``num_batches_tracked`` and the classifier."""
    depth_net, _ = seeded_nets(seed)
    sd = {k[len(ENC):]: v for k, v in depth_net.state_dict().items()
          if k.startswith(ENC)}
    g = torch.Generator().manual_seed(seed)
    sd["fc.weight"] = torch.randn(1000, 512, generator=g)
    sd["fc.bias"] = torch.randn(1000, generator=g)
    return sd


def test_torchvision_import_matches_jax():
    tv = torchvision_sd()
    enc = ti.convert_torchvision_resnet18(tv)
    params, stats = jax_ti.convert_torchvision_resnet18(tv)
    assert_sd_equal(enc, depth_state_dict(params, stats))
    assert all(k.startswith(ENC) for k in enc)

    base_depth, base_pose = build_models(
        Config(compute_dtype="float32"), device="cpu",
        generator=torch.Generator().manual_seed(2))
    ours = ti.warm_start_encoder(base_depth.state_dict(), enc)
    flax_params, flax_stats = to_flax(base_depth.state_dict(),
                                      base_pose.state_dict())
    merged = depth_state_dict(
        jax_ti.warm_start_encoder(flax_params["depth"], params),
        jax_ti.warm_start_encoder(flax_stats, stats))
    assert_sd_equal(ours, merged)
    base_depth.load_state_dict(ours)


def flax_leaves(tree):
    return jax.tree_util.tree_leaves_with_path(jax.device_get(tree))


def assert_flax_equal(a, b):
    la, lb = flax_leaves(a), flax_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=jax.tree_util.keystr(p))


def test_import_cli_read_by_jax(tmp_path, capsys):
    """Both CLIs import one .pt file; JAX's load_checkpoint reads both
    outputs bit-equal, weights and optimizer state."""
    from tcsfm.config import Config as JaxConfig
    from tcsfm.train.checkpoint import load_checkpoint
    from tcsfm.train.trainer import create_train_state

    pt = str(tmp_path / "best_model.pt")
    torch.save(reference_ckpt(), pt)
    argv = ["--torch_ckpt", pt, "--iterations", "2",
            "--img_resolution", "low"]
    ours = import_checkpoint.main(argv + ["--out_dir", str(tmp_path / "port"),
                                          "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == ours
    ref = jax_cli.main(argv + ["--out_dir", str(tmp_path / "jax")])
    assert {k: v for k, v in ours.items() if k not in ("checkpoint",
                                                       "config")} == \
        {k: v for k, v in ref.items() if k not in ("checkpoint", "config")}
    for path in (ours["checkpoint"], ours["config"],
                 os.path.join(tmp_path, "port", "best_model",
                              "best_model.msgpack")):
        assert os.path.exists(path)

    cfg = JaxConfig.load(os.path.join(tmp_path, "jax", "config.json"))
    assert JaxConfig.load(ours["config"]).iterations == cfg.iterations == 2
    state, _, _ = create_train_state(cfg, jax.random.PRNGKey(1),
                                     steps_per_epoch=1)
    loaded = {}
    for name in ("port", "jax"):
        best, _, _ = load_checkpoint(str(tmp_path / name), state,
                                     load_best=True)
        resumed, epoch, val = load_checkpoint(str(tmp_path / name), state)
        loaded[name] = (best, resumed, epoch, val)
    (pb, pr, pe, pv), (jb, jr, je, jv) = loaded["port"], loaded["jax"]
    assert_flax_equal(pb.params, jb.params)
    assert_flax_equal(pb.batch_stats, jb.batch_stats)
    assert_flax_equal(pr.opt_state, jr.opt_state)
    assert (int(pr.step), pe, pv) == (int(jr.step), je, jv) == (0, 6, 0.5)


def test_import_cli_torchvision(tmp_path):
    """--torchvision: the encoder imported, the decoder and the pose net as
    the seeded init (generator seed 0) of ``cli.common.load_nets``."""
    from tcsfm_torch.cli.common import load_nets

    pt = str(tmp_path / "resnet18.pth")
    tv = torchvision_sd()
    torch.save(tv, pt)
    out = import_checkpoint.main(["--torch_ckpt", pt, "--torchvision",
                                  "--out_dir", str(tmp_path / "m"),
                                  "--device", "cpu"])
    assert (out["epoch"], out["best_val_loss"]) == (0, float("inf"))
    depth_net, pose_net = load_nets(str(tmp_path / "m"), "cpu")
    init_depth, init_pose = load_nets("", "cpu")
    got, init = depth_net.state_dict(), init_depth.state_dict()
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            continue
        want = tv[k[len(ENC):]] if k.startswith(ENC) else init[k]
        assert torch.equal(v, want), k
    assert_sd_equal(pose_net.state_dict(), init_pose.state_dict())
