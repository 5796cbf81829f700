"""bfloat16 model directories crossing between the packages, on the CPU:
a bfloat16 ``config.json`` with its checkpoint written by the JAX package
(``Config.save``, ``train.checkpoint.save_checkpoint``) is read by the
port's ``evaluate_vo`` as the same bfloat16 run as the port's own
directory (equal results); the port's directory is read by JAX's
``Config.load`` as bfloat16 (JAX's CLIs read it in
``test_torch_bf16_eval*.py`` and ``test_torch_bf16_seqpft*.py``), and the
nets both packages build from it compute in bfloat16; the port's
``import_checkpoint`` writes ``"bfloat16"``, which JAX's ``Config.load``
reads.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bf16_eval_harness as eh
from tcsfm.config import Config as JaxConfig
from tcsfm.train import checkpoint as jax_ckpt
from tcsfm.train.trainer import TrainState as JaxTrainState
from tcsfm.train.trainer import make_optimizer as jax_make_optimizer
from tcsfm_torch.cli import evaluate_vo
from tcsfm_torch.cli.common import load_config, load_nets
from tcsfm_torch.config import Config
from tcsfm_torch.models.convert import to_flax
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return eh.write_model_dirs(tmp_path_factory.mktemp("bf16_model"))


def test_nets_compute_in_the_directory_s_dtype(dirs):
    for dtype, d in dirs.items():
        depth_net, pose_net = load_nets(d, "cpu")
        assert depth_net.compute_dtype == pose_net.compute_dtype == \
            getattr(torch, dtype)
        assert load_config(d, Config()).compute_dtype == dtype
        assert JaxConfig.load(os.path.join(d, "config.json")
                              ).compute_dtype == dtype


def test_jax_written_directory_is_the_same_run(dirs, tmp_path):
    """A bfloat16 directory the JAX package writes (its ``Config.save``,
    its checkpoint of the same weights) runs in the port's ``evaluate_vo``
    exactly as the port's own directory does."""
    jdir = str(tmp_path / "jax_dir")
    jcfg = JaxConfig(compute_dtype="bfloat16", iterations=2,
                     img_resolution="low")
    depth_net, pose_net = load_nets(dirs["float32"], "cpu")
    params, stats = to_flax(depth_net.state_dict(), pose_net.state_dict())
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jax_make_optimizer(jcfg, 1)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             stats),
                          opt_state=tx.init(params), tx=tx)
    jax_ckpt.save_checkpoint(jdir, state, epoch=1, best_val_loss=1.0,
                             cfg=jcfg, is_best=True)
    with open(os.path.join(jdir, "config.json")) as f:
        assert '"compute_dtype": "bfloat16"' in f.read()
    theirs = evaluate_vo.main(["--model_dir", jdir, "--synthetic",
                               "--device", "cpu"])
    assert load_nets(jdir, "cpu")[0].compute_dtype == torch.bfloat16
    ours = evaluate_vo.main(["--model_dir", dirs["bfloat16"], "--synthetic",
                             "--device", "cpu"])
    np.testing.assert_equal(theirs, ours)


def test_port_import_writes_bfloat16_for_jax(tmp_path):
    from tcsfm_torch.cli import import_checkpoint

    from test_torch_import_checkpoint import reference_ckpt

    src = str(tmp_path / "best_model.pt")
    torch.save(reference_ckpt(), src)
    out = str(tmp_path / "imported")
    import_checkpoint.main(["--torch_ckpt", src, "--out_dir", out,
                            "--device", "cpu"])
    assert JaxConfig.load(os.path.join(out, "config.json")
                          ).compute_dtype == "bfloat16"
    assert load_nets(out, "cpu")[0].compute_dtype == torch.bfloat16
