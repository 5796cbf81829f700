"""``compute_dtype`` through the port's configuration, files and entry
points, against the JAX package's, on CPU.

* ``Config`` has JAX's field with JAX's default (``"bfloat16"``), takes
  ``"float32"`` too and refuses anything else; ``to_json`` writes the
  value, so a file either package saves loads in the other as the same
  run, both dtypes.
* ``json_notes`` no longer names a dtype; it names the JAX keys the port
  does not read.
* ``cli.train`` computes in ``--compute_dtype`` (default bfloat16, as
  JAX's), prints it, and writes it into ``config.json``, which JAX's
  ``Config.load`` reads as the same run; the checkpoint of a bfloat16 run
  holds float32 parameters and loads in the JAX package (the msgpack codec
  still refuses bfloat16 arrays: nothing the port saves is bfloat16).
* The entry points that default to float32 in JAX (``measure_scaling``,
  the synthetic CLIs' nets without a model directory) default to it here.
"""

import contextlib
import inspect
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from flax.core import unfreeze

from tcsfm.config import Config as JaxConfig
from tcsfm.dist import scaling as jax_scaling
from tcsfm.train import checkpoint as jax_ckpt
from tcsfm.train.trainer import create_train_state as jax_create_train_state
from tcsfm_torch.cli import train as cli
from tcsfm_torch.cli.common import load_config, load_nets
from tcsfm_torch.config import Config, json_notes
from tcsfm_torch.dist import scaling
from tcsfm_torch.models.convert import to_flax
from tcsfm_torch.train import checkpoint as ckpt
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARGS = ["--synthetic", "--img_resolution", "low", "--minibatch", "2",
        "--synthetic_frames", "4", "--device", "cpu", "--date", "run",
        "--num_epochs", "1", "--iterations", "2"]


def test_default_and_refusal():
    assert Config().compute_dtype == JaxConfig().compute_dtype == "bfloat16"
    assert Config().dtype == torch.bfloat16
    assert Config(compute_dtype="float32").dtype == torch.float32
    for bad in ("float16", "float64", "bf16"):
        with pytest.raises(ValueError, match="compute_dtype"):
            Config(compute_dtype=bad)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_config_crosses_both_ways(tmp_path, dtype):
    path = str(tmp_path / "config.json")
    Config(iterations=3, compute_dtype=dtype).save(path)
    with open(path) as f:
        assert json.load(f)["compute_dtype"] == dtype
    assert JaxConfig.load(path).compute_dtype == dtype
    JaxConfig(iterations=5, compute_dtype=dtype).save(path)
    cfg = Config.load(path)
    assert (cfg.iterations, cfg.compute_dtype) == (5, dtype)


def test_json_notes_name_no_dtype(tmp_path):
    text = JaxConfig(compute_dtype="float32").to_json()
    notes = json_notes(text)
    assert len(notes) == 1
    assert notes[0].startswith("config keys the port does not read: ")
    assert "compute_dtype" not in notes[0] and "float32" not in notes[0]
    assert "use_mxu_warp" in notes[0] and "param_dtype" in notes[0]
    assert json_notes(Config().to_json()) == []


@pytest.fixture(scope="module")
def bf16_run(tmp_path_factory):
    """One epoch of ``cli.train`` at its default ``--compute_dtype``: the
    run's directory, its trainer and what it printed."""
    results = str(tmp_path_factory.mktemp("bf16_cli"))
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        loop = cli.main(ARGS + ["--results_dir", results])
    return os.path.join(results, "run"), loop, out.getvalue()


def test_cli_trains_in_bf16_by_default(bf16_run, capsys):
    run_dir, loop, printed = bf16_run
    assert "compute dtype: bfloat16 (float32 parameters, TF32 off)" in printed
    assert "float32 (TF32 off)" not in printed
    assert loop.state.cfg.compute_dtype == "bfloat16"
    assert loop.state.depth_net.compute_dtype == torch.bfloat16
    assert loop.state.pose_net.compute_dtype == torch.bfloat16
    for net in (loop.state.depth_net, loop.state.pose_net):
        assert all(p.dtype == torch.float32 for p in net.parameters())
    path = os.path.join(run_dir, "config.json")
    with open(path) as f:
        assert json.load(f)["compute_dtype"] == "bfloat16"
    jcfg = JaxConfig.load(path)
    cfg = Config.load(path)
    assert jcfg.compute_dtype == "bfloat16"
    for f in cfg.__dataclass_fields__:
        assert getattr(jcfg, f) == getattr(cfg, f), f
    # a CLI that reads the model directory builds bfloat16 nets from it
    capsys.readouterr()
    assert load_config(run_dir, Config()).compute_dtype == "bfloat16"
    assert capsys.readouterr().out == ""
    depth_net, pose_net = load_nets(run_dir, "cpu")
    assert depth_net.compute_dtype == pose_net.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_cli_takes_float32_and_refuses_others(dtype):
    if dtype == "float32":
        assert cli.build_config(cli.parse_args(
            ARGS + ["--compute_dtype", dtype])).compute_dtype == dtype
    else:
        with pytest.raises(SystemExit):
            cli.parse_args(ARGS + ["--compute_dtype", dtype])


def test_bf16_checkpoint_loads_in_jax(bf16_run):
    """The bfloat16 run's checkpoint: float32 parameters and statistics,
    which the JAX package reads into its state (the trees do not depend on
    the compute dtype); the codec refuses bfloat16 arrays."""
    run_dir, loop, _ = bf16_run
    template, _, _ = jax_create_train_state(
        JaxConfig(iterations=2, compute_dtype="float32",
                  img_resolution="low"), jax.random.PRNGKey(0),
        steps_per_epoch=1)
    loaded, _, _ = jax_ckpt.load_checkpoint(run_dir, template,
                                            load_best=False)
    params, stats = to_flax(loop.state.depth_net.state_dict(),
                            loop.state.pose_net.state_dict())
    got = jax.tree_util.tree_map(np.asarray, unfreeze(loaded.params))
    for net in ("depth", "pose"):
        for a, b in zip(jax.tree_util.tree_leaves(got[net]),
                        jax.tree_util.tree_leaves(params[net])):
            assert a.dtype == np.float32 and np.array_equal(a, b)
    data = serialization.msgpack_serialize(
        {"a": np.ones(2, dtype=jnp.bfloat16)})
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.msgpack_restore(data)


def test_float32_defaults_where_jax_has_them():
    jax_default = inspect.signature(
        jax_scaling.measure_scaling).parameters["compute_dtype"].default
    for fn in (scaling.measure_scaling, scaling.step_seconds):
        assert inspect.signature(fn).parameters[
            "compute_dtype"].default == jax_default == "float32"
    # the sequence CLIs' seeded nets without a model directory
    depth_net, pose_net = load_nets("", "cpu")
    assert depth_net.compute_dtype == pose_net.compute_dtype == torch.float32


def test_step_seconds_builds_its_nets_in_the_dtype(monkeypatch):
    """``step_seconds`` (a ``measure_scaling`` rank) builds its train state
    in ``compute_dtype``."""
    import torch.distributed as dist

    from tcsfm_torch.dist.mesh import free_port, init_group
    from tcsfm_torch.train import trainer

    made = []
    real = trainer.create_train_state

    def recording(cfg, **kw):
        made.append(cfg.compute_dtype)
        return real(cfg, **kw)

    monkeypatch.setattr(trainer, "create_train_state", recording)
    init_group(0, 1, f"127.0.0.1:{free_port()}", "cpu")
    try:
        out = scaling.step_seconds(1, (64, 96), 2, 1, 2, "cpu", "bfloat16")
    finally:
        dist.destroy_process_group()
    assert made == ["bfloat16"] and out["step_s"] > 0
