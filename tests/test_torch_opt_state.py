"""The optimizer state in the port's checkpoints against optax's, both ways
(``tcsfm_torch.train.checkpoint``'s ``opt_state``), with no forward pass.

Both optimizers start from the same full-width nets (the port's seeded
``build_models`` through ``to_flax``; JAX's ``TrainState`` is built by
hand, since ``create_train_state`` would initialize its nets under jit),
take two updates from the same seeded gradients, then each package's
checkpoint is resumed by the other with ``load_best=False`` and
both take a third update, at the halved lr of the schedule's second
epoch. Held: the written ``opt_state`` tree equals optax's key for key
(Flax's ``from_state_dict`` refuses any other keys); the step, epoch and
best loss resumed; the parameters within 5e-5 of the lr (optax forms
Adam's bias corrections in f32, ``tests/test_torch_train.py``) and the
moments within 1e-6 relative. Cases: the default, either net frozen, and
AdamW (``wd > 0``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from flax.core import unfreeze

from tcsfm.config import Config as JaxConfig
from tcsfm.train import checkpoint as jax_ckpt
from tcsfm.train.trainer import TrainState as JaxTrainState
from tcsfm.train.trainer import make_optimizer as jax_make_optimizer
from tcsfm_torch.config import Config
from tcsfm_torch.infer import build_models
from tcsfm_torch.models.convert import (depth_to_flax, grads_from_flax,
                                        pose_to_flax, to_flax)
from tcsfm_torch.train import checkpoint as ckpt
from tcsfm_torch.train import trainer
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

LR, STEPS_PER_EPOCH = 1e-2, 2
CASES = {"default": {}, "freeze_posenet": {"freeze_posenet": True},
         "freeze_depthnet": {"freeze_depthnet": True}, "wd": {"wd": 0.1}}


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, unfreeze(x))


@pytest.fixture(scope="module")
def nets():
    """Two pairs of seeded full-width nets, each with its Flax trees: the
    one trained, and the one each checkpoint is resumed into."""
    out = []
    for seed in (0, 3):
        pair = build_models(Config(), device="cpu",
                            generator=torch.Generator().manual_seed(seed))
        out.append((pair, to_flax(*(m.state_dict() for m in pair))))
    return out


@pytest.fixture(scope="module")
def grads(nets):
    """Three sets of seeded gradients, by net and parameter name, in the
    port's layout and in Flax's."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(3):
        port = {net: {n: torch.from_numpy(
            1e-3 * rng.standard_normal(tuple(p.shape), np.float32))
            for n, p in m.named_parameters()}
            for net, m in zip(("depth", "pose"), nets[0][0])}
        out.append((port, {"depth": depth_to_flax(port["depth"])[0],
                           "pose": pose_to_flax(port["pose"])}))
    return out


def _states(kw, nets):
    """The port's TrainState on copies of ``nets``' pair
    (trainer.create_train_state's, without its seeded init), and JAX's on
    its Flax trees, built by hand."""
    (pair, (params, stats)) = nets
    cfg = Config(lr=LR, lr_decay_epoch=1, iterations=2, **kw)
    depth_net, pose_net = (copy.deepcopy(m) for m in pair)
    depth_net.requires_grad_(not cfg.freeze_depthnet)
    pose_net.requires_grad_(not cfg.freeze_posenet)
    port = trainer.TrainState(
        cfg, depth_net, pose_net,
        trainer.make_optimizer(cfg, depth_net, pose_net),
        steps_per_epoch=STEPS_PER_EPOCH)
    tx = jax_make_optimizer(JaxConfig(lr=LR, lr_decay_epoch=1, **kw),
                            STEPS_PER_EPOCH)
    return port, JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=stats, opt_state=tx.init(params),
                               tx=tx)


def _update(port_state, jax_state, grads):
    """One update of each package from ``grads`` (port, Flax); returns the
    JAX state."""
    port, flax_grads = grads
    for net, m in (("depth", port_state.depth_net),
                   ("pose", port_state.pose_net)):
        for n, p in m.named_parameters():
            p.grad = port[net][n].clone() if p.requires_grad else None
    trainer.apply_gradients(port_state)
    return _apply(jax_state, flax_grads)


@jax.jit
def _apply(state, grads):
    # one program per optimizer; eager optax compiles each op by shape
    return state.apply_gradients(grads)


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return (np.asarray(tree).dtype.name, np.shape(tree))


def _check_params(port_state, jax_state, what):
    expect = grads_from_flax(_tree(jax_state.params))
    for net, m in (("depth", port_state.depth_net),
                   ("pose", port_state.pose_net)):
        for n, p in m.named_parameters():
            np.testing.assert_allclose(
                p.detach().numpy(), expect[net][n].numpy(), atol=5e-5 * LR,
                rtol=0, err_msg=f"{what}: {net}.{n}")


def _check_moments(port_state, jax_state, what):
    """mu and nu of each trained label within 1e-6 relative (of the
    largest entry of the tensor), and Adam's count."""
    ours = ckpt.opt_state_tree(port_state)["inner_states"]
    theirs = _tree(serialization.to_state_dict(jax_state.opt_state))
    theirs = theirs["inner_states"]
    for label, inner in ours.items():
        if not inner["inner_state"]:
            continue
        a, b = inner["inner_state"]["0"], theirs[label]["inner_state"]["0"]
        assert int(a["count"]) == int(b["count"]), what
        for key in ("mu", "nu"):
            flat_a = jax.tree_util.tree_leaves(a[key])
            flat_b = jax.tree_util.tree_leaves(b[key])
            assert len(flat_a) == len(flat_b)
            for x, y in zip(flat_a, flat_b):
                scale = max(np.abs(y).max(), 1e-30)
                assert np.abs(x - y).max() <= 1e-6 * scale, (what, label, key)


@pytest.mark.parametrize("case", list(CASES))
def test_opt_state_resumes_across_packages(case, nets, grads, tmp_path):
    kw = CASES[case]
    port, jst = _states(kw, nets[0])
    for g in grads[:2]:
        jst = _update(port, jst, g)
    # the updates' parameters: tests/test_torch_train.py's Adam test
    _check_moments(port, jst, f"{case}, two updates")

    # the port's file, resumed by JAX; JAX's file, resumed by the port
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    ckpt.save_checkpoint(port_dir, port, epoch=0, best_val_loss=0.5)
    jax_ckpt.save_checkpoint(jax_dir, jst, epoch=0, best_val_loss=0.5)
    with open(f"{port_dir}/checkpoint.msgpack", "rb") as f:
        written = ckpt.msgpack_restore(f.read())["opt_state"]
    assert _structure(written) == _structure(
        serialization.to_state_dict(jax.device_get(jst.opt_state)))

    fresh, jax_fresh = _states(kw, nets[1])
    jax_resumed, epoch, best = jax_ckpt.load_checkpoint(
        port_dir, jax_fresh, load_best=False)
    assert (int(jax_resumed.step), epoch, best) == (2, 1, 0.5)
    port_resumed, epoch, best = ckpt.load_checkpoint(
        jax_dir, fresh, load_best=False)
    assert (port_resumed.step, epoch, best) == (2, 1, 0.5)
    _check_moments(port_resumed, jst, f"{case}, the port resumed")
    _check_moments(port, jax_resumed, f"{case}, JAX resumed")

    jst = _update(port_resumed, jst, grads[2])
    jax_resumed = _update(port, jax_resumed, grads[2])
    assert port_resumed.step == port.step == 3
    _check_params(port_resumed, jst, f"{case}, the port resumed, third")
    _check_params(port, jax_resumed, f"{case}, JAX resumed, third")
