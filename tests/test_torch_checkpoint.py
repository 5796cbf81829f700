"""The port's checkpoints (``tcsfm_torch.train.checkpoint``) against the JAX
package's (``tcsfm.train.checkpoint``), both ways, and the pieces they
rest on: the msgpack codec against ``flax.serialization``, ``to_flax``
against the Flax trees, and ``Config.save`` against ``tcsfm.config``.

Everything is exact: the codec's trees, the converted parameters and the
configuration fields compare equal, leaf by leaf. One jitted JAX init
(``create_train_state`` at low res, cached per module) serves both
directions.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from flax.core import unfreeze
from flax.traverse_util import flatten_dict

from tcsfm.config import Config as JaxConfig
from tcsfm.models.depth import DepthNet as JaxDepthNet
from tcsfm.models.pose import PoseNet as JaxPoseNet
from tcsfm.train import checkpoint as jax_ckpt
from tcsfm.train.trainer import create_train_state as jax_create_train_state
from tcsfm_torch.cli.common import load_config
from tcsfm_torch.config import Config
from tcsfm_torch.infer import build_models
from tcsfm_torch.models.convert import from_flax, to_flax
from tcsfm_torch.train import checkpoint as ckpt
from tcsfm_torch.train.trainer import apply_gradients, create_train_state
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def leaves(tree):
    return flatten_dict(unfreeze(tree)) if tree else {}


def assert_trees_equal(a, b):
    """Same keys, and leaves of the same type, dtype, shape and bits."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        assert a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b), (a, b)
        assert a == b or (a != a and b != b)


def every_leaf_kind():
    rng = np.random.RandomState(0)
    return {
        "f32": rng.randn(3, 4).astype(np.float32),
        "f64": rng.randn(5).astype(np.float64),
        "i32": rng.randint(-9, 9, (2, 3)).astype(np.int32),
        "bool": rng.rand(4) > 0.5,
        "zero_d": np.asarray(7, np.int32),
        "empty": np.zeros((0, 3), np.float32),
        "np_scalars": {"f32": np.float32(1.5), "i64": np.int64(-3),
                       "f64": np.float64(2.25)},
        "ints": {"small": 3, "neg": -5, "i8": -100, "u16": 300,
                 "i32": -70000, "u64": 2 ** 40},
        "floats": {"x": 0.1, "nan": float("nan"), "inf": -float("inf")},
        "str": "best_model", "long_str": "x" * 300, "none": None,
        "flags": {"t": True, "f": False},
        "nested": {"a": {"b": {"c": np.arange(20, dtype=np.float32)}}},
        "complex": 1.5 - 2.0j,
        "many": {f"k{i}": i for i in range(40)},
    }


def test_codec_reads_flax_bytes():
    tree = every_leaf_kind()
    ours = ckpt.msgpack_restore(serialization.msgpack_serialize(tree))
    assert_trees_equal(serialization.msgpack_restore(
        serialization.msgpack_serialize(tree)), ours)


def test_flax_reads_codec_bytes():
    tree = every_leaf_kind()
    theirs = serialization.msgpack_restore(ckpt.msgpack_serialize(tree))
    assert_trees_equal(ckpt.msgpack_restore(ckpt.msgpack_serialize(tree)),
                       theirs)
    assert_trees_equal(serialization.msgpack_restore(
        serialization.msgpack_serialize(tree)), theirs)


def test_reads_chunked_leaves(monkeypatch):
    """Flax's chunked form of a leaf over its bound (patched small)."""
    tree = {"big": np.arange(1000, dtype=np.float32).reshape(10, 100),
            "small": np.arange(3, dtype=np.float32)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 512)
    flax_bytes = serialization.msgpack_serialize(tree)
    raw = serialization.msgpack.unpackb(flax_bytes, raw=False)
    assert raw["big"]["__msgpack_chunked_array__"] is True
    assert len(raw["big"]["chunks"]) == 8                # 4000 B / 512 B
    assert_trees_equal(ckpt.msgpack_restore(flax_bytes), tree)


def test_codec_refuses_truncated_and_unknown():
    data = ckpt.msgpack_serialize({"a": np.ones(4, np.float32)})
    with pytest.raises(ValueError):
        ckpt.msgpack_restore(data[:-3])
    with pytest.raises(TypeError):
        ckpt.msgpack_serialize({"a": object()})


@pytest.fixture(scope="module")
def nets():
    """Two pairs of seeded nets: the one saved, and the one loaded into
    (every load overwrites all of its tensors)."""
    return port_nets(0), port_nets(1)


def test_to_flax_is_the_flax_tree(nets):
    """Keys, shapes and dtypes against ``jax.eval_shape`` of the JAX nets'
    init (no compile), and ``from_flax(to_flax(.))`` bit for bit."""
    dvars = jax.eval_shape(JaxDepthNet(num_scales=1).init,
                           jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)))
    pvars = jax.eval_shape(JaxPoseNet().init, jax.random.PRNGKey(1),
                           jnp.zeros((1, 64, 96, 6)))
    depth_net, pose_net = nets[0]
    params, stats = to_flax(depth_net.state_dict(), pose_net.state_dict())
    want = {**{("params", "depth") + k: v
               for k, v in leaves(dvars["params"]).items()},
            **{("params", "pose") + k: v
               for k, v in leaves(pvars["params"]).items()},
            **{("batch_stats",) + k: v
               for k, v in leaves(dvars["batch_stats"]).items()}}
    got = {**{("params",) + k: v for k, v in leaves(params).items()},
           **{("batch_stats",) + k: v for k, v in leaves(stats).items()}}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert (got[k].shape, got[k].dtype) == (v.shape, v.dtype), k

    depth_sd, pose_sd = from_flax(params, stats)
    for net, sd in ((depth_net, depth_sd), (pose_net, pose_sd)):
        ref = net.state_dict()
        assert sorted(sd) == sorted(ref)
        for k, v in ref.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(sd[k], v), k


@pytest.fixture(scope="module")
def jax_state():
    cfg = JaxConfig(iterations=2, compute_dtype="float32",
                    img_resolution="low")
    state, _, _ = jax_create_train_state(cfg, jax.random.PRNGKey(0),
                                         steps_per_epoch=1)
    return cfg, state


def port_nets(seed):
    return build_models(Config(iterations=2), device="cpu",
                        generator=torch.Generator().manual_seed(seed))


def assert_nets_equal(nets, depth_sd, pose_sd):
    for net, sd in zip(nets, (depth_sd, pose_sd)):
        for k, v in net.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, sd[k]), k


def test_port_round_trip_and_best_fallback(nets, tmp_path, capsys):
    nets, other = nets
    d = str(tmp_path / "run")
    ckpt.save_checkpoint(d, nets, epoch=4, best_val_loss=0.25,
                         cfg=Config(iterations=2), is_best=True)
    assert sorted(os.listdir(d)) == ["best_model", "checkpoint.msgpack",
                                     "config.json"]
    with open(os.path.join(d, "checkpoint.msgpack"), "rb") as f:
        payload = ckpt.msgpack_restore(f.read())
    assert sorted(payload) == ["batch_stats", "best_val_loss", "epoch",
                               "params", "step"]
    assert (payload["epoch"], payload["best_val_loss"]) == (4, 0.25)

    state, epoch, best = ckpt.load_checkpoint(d, other, load_best=True)
    assert state is other and (epoch, best) == (1, 1e5)
    assert_nets_equal(other, *(n.state_dict() for n in nets))

    # no best model: the latest checkpoint, with JAX's message
    d2 = str(tmp_path / "latest")
    ckpt.save_checkpoint(d2, nets, epoch=1, best_val_loss=1.0)
    capsys.readouterr()
    ckpt.load_checkpoint(d2, other, load_best=True)
    assert (f"no best_model in {d2}; loading latest checkpoint instead"
            in capsys.readouterr().out)

    # resuming needs a TrainState and a file with opt_state: a tuple of
    # nets is saved without one
    with pytest.raises(ValueError, match="TrainState"):
        ckpt.load_checkpoint(d, other, load_best=False)
    state = create_train_state(Config(iterations=2), device="cpu")
    with pytest.raises(ValueError, match="holds no opt_state"):
        ckpt.load_checkpoint(d, state, load_best=False)

    # a TrainState's file resumes: weights, optimizer state, step, epoch
    saved = create_train_state(Config(iterations=2), device="cpu",
                               generator=torch.Generator().manual_seed(2))
    for p in saved.depth_net.parameters():
        p.grad = torch.full_like(p, 1e-3)
    for p in saved.pose_net.parameters():
        p.grad = torch.full_like(p, -1e-3)
    apply_gradients(saved)
    ckpt.save_checkpoint(d, saved, epoch=4, best_val_loss=0.25)
    resumed, epoch, best = ckpt.load_checkpoint(d, state, load_best=False)
    assert resumed is state and (epoch, best, state.step) == (5, 0.25, 1)
    assert_nets_equal((state.depth_net, state.pose_net),
                      *(n.state_dict() for n in (saved.depth_net,
                                                  saved.pose_net)))
    ours, theirs = (s.optimizer.state_dict() for s in (state, saved))
    assert sorted(ours["state"]) == sorted(theirs["state"])
    for i, st in theirs["state"].items():
        for k, v in st.items():
            assert torch.equal(ours["state"][i][k], v), (i, k)


def test_train_state_and_mismatched_tree(nets, tmp_path):
    """A ``TrainState`` saves and loads like the tuple of nets; a tree of
    other keys is refused, as Flax's ``from_state_dict`` refuses it."""
    state = create_train_state(Config(iterations=2), device="cpu")
    state.step = 5
    d = str(tmp_path / "ts")
    ckpt.save_checkpoint(d, state, epoch=2, best_val_loss=0.5,
                         is_best=True)
    with open(os.path.join(d, "checkpoint.msgpack"), "rb") as f:
        assert ckpt.msgpack_restore(f.read())["step"] == np.int32(5)
    loaded, _, _ = ckpt.load_checkpoint(d, nets[1], load_best=True)
    assert_nets_equal(loaded, state.depth_net.state_dict(),
                      state.pose_net.state_dict())

    with open(os.path.join(d, "checkpoint.msgpack"), "rb") as f:
        payload = ckpt.msgpack_restore(f.read())
    del payload["params"]["depth"]["upconv0"]
    with open(os.path.join(d, "best_model", "best_model.msgpack"), "wb") as f:
        f.write(ckpt.msgpack_serialize(payload))
    with pytest.raises(ValueError, match="params/depth"):
        ckpt.load_checkpoint(d, nets[1], load_best=True)


def test_jax_reads_a_port_checkpoint(nets, tmp_path, jax_state):
    jcfg, state = jax_state
    nets = nets[0]
    d = str(tmp_path / "port")
    ckpt.save_checkpoint(d, nets, epoch=3, best_val_loss=0.5,
                         cfg=Config(iterations=2), is_best=True)
    loaded, epoch, best = jax_ckpt.load_checkpoint(d, state, load_best=True)
    assert (epoch, best) == (1, 1e5)
    params, stats = to_flax(nets[0].state_dict(), nets[1].state_dict())
    assert_trees_equal(jax.tree_util.tree_map(np.asarray,
                                              unfreeze(loaded.params)),
                       params)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray,
                                              unfreeze(loaded.batch_stats)),
                       stats)


def test_port_reads_a_jax_checkpoint(nets, tmp_path, jax_state):
    jcfg, state = jax_state
    d = str(tmp_path / "jax")
    jax_ckpt.save_checkpoint(d, state, epoch=1, best_val_loss=1.0, cfg=jcfg,
                             is_best=True)
    nets = nets[1]
    ckpt.load_checkpoint(d, nets, load_best=True)
    tree = jax.tree_util.tree_map(np.asarray, unfreeze(state.params))
    assert_nets_equal(nets, *from_flax(
        tree, jax.tree_util.tree_map(np.asarray,
                                     unfreeze(state.batch_stats))))
    cfg = load_config(d, Config())
    assert (cfg.iterations, cfg.img_resolution) == (2, "low")


def test_config_crosses_with_its_compute_dtype(tmp_path, capsys):
    cfg = Config(iterations=3, lr=3e-5, min_depth=0.1, camera_height=1.65,
                 l_depth_consist=True, img_resolution="low")
    path = str(tmp_path / "config.json")
    cfg.save(path)
    jcfg = JaxConfig.load(path)
    assert jcfg.compute_dtype == "float32"
    for f in cfg.__dataclass_fields__:
        assert getattr(jcfg, f) == getattr(cfg, f), f
    assert Config.load(path) == cfg

    # a JAX config asking bfloat16 (cli/train.py's default) loads, and the
    # CLIs name both dtypes and the keys the port does not read
    JaxConfig(iterations=3).save(path)
    with open(path) as f:
        assert json.load(f)["compute_dtype"] == "bfloat16"
    capsys.readouterr()
    assert load_config(str(tmp_path), Config()).iterations == 3
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("compute dtype: the config asks bfloat16, the port "
                      "computes in float32 (TF32 off)")
    assert out[1].startswith("config keys the port does not read: ")
    assert "use_mxu_warp" in out[1]
    # the training CLI's data, remat, mesh and checkpoint fields are read
    for key in ("train_seq", "remat_coupled", "mesh_shape", "mesh_axes",
                "ckpt_dir", "pretrained_dir"):
        assert key not in out[1]
