"""One training step of the port (tcsfm_torch.train.trainer) against the
JAX package's ``forward_loss`` and ``jax.grad``, on CPU.

Weights: seeded ``create_train_state`` params (compute_dtype float32)
with trained-like conditioning (variance-preserving decoder, disparity
head bias -3; see tests/test_torch_coupled.py), converted by ``from_flax``;
smooth images, B=2, S=2, 4 iterations.

* 96x160, f32: every loss term within 1e-5, the inverse term not 0 (each
  group keeps more than the 10,000 valid pixels of the guard), the new
  BatchNorm running statistics within 1e-5 (Flax's rule: momentum 0.9 and
  the biased batch variance).
* Gradients. f32 resolves the gradient of this loss only to ~1e-2 relative
  L2: the abs() of near-equal neighbouring disparities (smoothness) and of
  photometric residuals flips sign under rounding, and SSIM's local
  variances cancel. Measured at this size, JAX's f32 gradient and the
  port's are each up to 1e-2 from a float64 evaluation, and up to 9.3e-3
  from each other. So per tensor, through ``grads_from_flax``: the f32
  step's gradients within 5e-2 of JAX's f32 ones, and the gradient of the
  port's ``forward_loss`` in float64 within 1e-4 of JAX's in float64 (at
  96x160 too, so the inverse term clears the guard and is held).
  The first pose stage's conv bias has an analytically zero gradient (its
  GroupNorm has one channel a group); it is held at 1e-6 of the largest
  gradient norm instead.
* The Adam update from identical gradients, 5e-5 of the lr (optax's f32
  bias correction); the halving schedule, exactly; the freeze flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax.core import unfreeze

from tcsfm.config import Config as JaxConfig
from tcsfm.train.schedule import halving_schedule as jax_halving
from tcsfm.train.trainer import create_train_state as jax_create_train_state
from tcsfm.train.trainer import forward_loss as jax_forward_loss
from tcsfm.train.trainer import make_optimizer as jax_make_optimizer
from tcsfm_torch.config import Config
from tcsfm_torch.models.convert import (depth_state_dict, from_flax,
                                        grads_from_flax)
from tcsfm_torch.ops import grid_sample as gs
from tcsfm_torch.train import trainer
from tcsfm_torch.train.schedule import halving_schedule
from test_torch_coupled import _condition
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, S = 2, 2
ZERO_GRAD = ("pose", "conv1.0.bias")


def _batch(seed, h, w):
    rng = np.random.RandomState(seed)

    def smooth(n):
        lo = torch.from_numpy(rng.rand(n, 3, 9, 13))
        up = F.interpolate(lo, size=(h, w), mode="bilinear", align_corners=True)
        return up.permute(0, 2, 3, 1).numpy().astype(np.float32)

    tgt, src = smooth(B), smooth(S * B).reshape(S, B, h, w, 3)
    K = np.array([[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2.5], [0, 0, 1]],
                 np.float32)
    return {"target_img": tgt, "source_imgs": src,
            "target_img_aug": np.clip(tgt * 1.05 + 0.01, 0, 1),
            "source_imgs_aug": np.clip(src * 0.95 + 0.02, 0, 1),
            "intrinsics_aug": np.broadcast_to(K, (B, 3, 3)).copy()}


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, unfreeze(x))


def _jax_step(jcfg, depth_model, pose_model):
    def loss_fn(params, stats, batch):
        losses, new_stats, _ = jax_forward_loss(
            jcfg, depth_model, pose_model, params, stats, batch, train=True)
        return losses["total"], (losses, new_stats)

    return jax.jit(jax.grad(loss_fn, has_aux=True))


@pytest.fixture(scope="module")
def ref():
    jcfg = JaxConfig(compute_dtype="float32", img_resolution="low",
                     use_mxu_warp=False)
    state, depth_model, pose_model = jax_create_train_state(
        jcfg, jax.random.PRNGKey(0), steps_per_epoch=10)
    params, stats = _tree(state.params), _tree(state.batch_stats)
    params["depth"] = _condition(params["depth"])
    batch = _batch(0, 96, 160)
    grads, (losses, new_stats) = _jax_step(jcfg, depth_model, pose_model)(
        params, stats, jax.tree_util.tree_map(jnp.asarray, batch))
    return dict(params=params, stats=stats, batch=batch,
                grads=grads_from_flax(_tree(grads)), jax_grads=_tree(grads),
                losses={k: float(v) for k, v in losses.items()},
                new_stats=_tree(new_stats), jcfg=jcfg,
                models=(depth_model, pose_model))


def _port_state(ref, cfg=None, device="cpu", **kw):
    cfg = cfg or Config(compute_dtype="float32")
    state = trainer.create_train_state(cfg, device=device, **kw)
    depth_sd, pose_sd = from_flax(ref["params"], ref["stats"])
    state.depth_net.load_state_dict(depth_sd)
    state.pose_net.load_state_dict(pose_sd)
    return state


@pytest.fixture(scope="module")
def port_step(ref):
    state = _port_state(ref, steps_per_epoch=10)
    losses = trainer.train_step(state, ref["batch"])
    return state, losses


def _named_grads(state):
    return {"depth": dict(state.depth_net.named_parameters()),
            "pose": dict(state.pose_net.named_parameters())}


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def _check_grads(port, ref_grads, limit):
    largest = max(g.norm().item() for net in ref_grads.values()
                  for g in net.values())
    assert set(port["depth"]) == set(ref_grads["depth"])
    assert set(port["pose"]) == set(ref_grads["pose"])
    for net in ("depth", "pose"):
        for name, p in port[net].items():
            g, r = p.grad, ref_grads[net][name]
            assert g is not None and g.shape == r.shape, (net, name)
            if (net, name) == ZERO_GRAD:
                assert g.norm().item() <= 1e-6 * largest
                assert r.norm().item() <= 1e-6 * largest
            else:
                assert _rel_l2(g, r) <= limit, (net, name, _rel_l2(g, r))


def test_step_losses_match_jax(ref, port_step):
    _, losses = port_step
    assert set(losses) == set(ref["losses"])
    for k, v in ref["losses"].items():
        assert abs(losses[k].item() - v) <= 1e-5, (k, losses[k].item(), v)
    assert losses["l_reconstruct_inverse"].item() > 0
    assert losses["l_depth"].item() == 0.0


def test_step_batch_stats_match_jax(ref, port_step):
    state, _ = port_step
    expect = depth_state_dict(ref["params"]["depth"], ref["new_stats"])
    moved = 0
    for k, v in state.depth_net.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), expect[k].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
            old = depth_state_dict(ref["params"]["depth"], ref["stats"])[k]
            moved += not torch.equal(v, old)
    assert moved == 40       # every running mean and var of the encoder


def test_step_grads_match_jax_f32(ref, port_step):
    state, _ = port_step
    _check_grads(_named_grads(state), ref["grads"], 5e-2)


def test_forward_loss_grads_match_jax_f64(ref):
    """The gradient of ``forward_loss``'s total in float64 on both sides,
    96x160, from the same weights. At that size each group of the inverse
    term keeps more than the guard's 10,000 valid pixels (at 64x128 it
    does not), so the term is not 0 and its gradient through the nets is
    held too. JAX's float64 run keeps a few float32 pieces (its pixel
    grid, f32 accumulation types), so the two totals differ at ~1e-7 and
    the gradients by up to 2.9e-6 (measured)."""
    batch = _batch(1, 96, 160)
    jcfg = JaxConfig(compute_dtype="float64", img_resolution="low",
                     use_mxu_warp=False)
    depth_model, pose_model = (m.clone(dtype=jnp.float64)
                               for m in ref["models"])
    with jax.enable_x64(True):
        to64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            (ref["params"], ref["stats"], batch))
        grads, (losses, _) = _jax_step(jcfg, depth_model, pose_model)(*to64)
        grads = grads_from_flax(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   unfreeze(grads)))
    state = _port_state(ref)
    state.depth_net.double()
    state.pose_net.double()
    t_batch = {k: torch.from_numpy(v).double() for k, v in batch.items()}
    port, _ = trainer.forward_loss(state.cfg, state.depth_net, state.pose_net,
                                   t_batch, train=True,
                                   sampler=gs.grid_sample_plain)
    port["total"].backward()
    assert float(losses["l_reconstruct_inverse"]) > 0
    assert port["l_reconstruct_inverse"].item() > 0
    assert abs(port["total"].item() - float(losses["total"])) <= 1e-6
    _check_grads(_named_grads(state), grads, 1e-4)


def test_adam_update_matches_optax(ref):
    """JAX's gradients fed to both optimizers, from zero parameters (Adam's
    update does not depend on them; AdamW's decay acts from the second
    step on), three steps with the lr halving every step. Limit 5e-5 of
    the lr: optax forms the bias corrections 1 - 0.9^t and 1 - 0.999^t in
    f32, where 1 - 0.999 is 1.3e-5 off (measured worst 2.6e-5 of the lr);
    torch.optim forms them in float64."""
    for kw in ({}, {"wd": 0.1}, {"freeze_posenet": True},
               {"freeze_depthnet": True}):
        cfg = Config(compute_dtype="float32", lr=1e-2, lr_decay_epoch=1, **kw)
        jcfg = JaxConfig(lr=1e-2, lr_decay_epoch=1, **kw)
        state = trainer.create_train_state(cfg, device="cpu",
                                           steps_per_epoch=1)
        named = _named_grads(state)
        with torch.no_grad():
            for net in named.values():
                for p in net.values():
                    p.zero_()
        tx = jax_make_optimizer(jcfg, steps_per_epoch=1)
        update = jax.jit(tx.update)
        jparams = jax.tree_util.tree_map(np.zeros_like, ref["jax_grads"])
        opt_state = tx.init(jparams)
        for step in range(3):
            updates, opt_state = update(ref["jax_grads"], opt_state, jparams)
            jparams = optax.apply_updates(jparams, updates)
            for net_name, net in named.items():
                for name, p in net.items():
                    p.grad = (ref["grads"][net_name][name].clone()
                              if p.requires_grad else None)
            trainer.apply_gradients(state)
            assert state.step == step + 1
            expect = grads_from_flax(_tree(jparams))
            for net_name, net in named.items():
                for name, p in net.items():
                    np.testing.assert_allclose(
                        p.detach().numpy(), expect[net_name][name].numpy(),
                        atol=5e-5 * cfg.lr, rtol=0,
                        err_msg=f"{kw} step {step} {net_name}.{name}")


def test_halving_schedule_is_exact():
    for base, spe, decay in ((1e-4, 1000, 7), (2e-4, 3, 1), (1e-3, 0, 0)):
        port, jref = halving_schedule(base, spe, decay), jax_halving(
            base, spe, decay)
        for step in (0, 1, 2, 3, 999, 1000, 6999, 7000, 14000, 20999, 21000):
            assert np.float32(port(step)) == np.asarray(jref(jnp.int32(step)))


@pytest.mark.parametrize("frozen", ["depth", "pose"])
def test_freeze_flags(ref, frozen):
    """A frozen net is left out of the optimizer and does not move; a
    frozen depth net runs eval-mode BatchNorm, so its statistics stay and
    the step's losses are the eval losses."""
    cfg = Config(compute_dtype="float32", freeze_depthnet=frozen == "depth",
                 freeze_posenet=frozen == "pose", iterations=2)
    state = _port_state(ref, cfg)
    assert [g["name"] for g in state.optimizer.param_groups] == (
        ["pose"] if frozen == "depth" else ["depth"])
    batch = _batch(2, 64, 96)
    nets = {"depth": state.depth_net, "pose": state.pose_net}
    before = {n: {k: v.clone() for k, v in net.state_dict().items()}
              for n, net in nets.items()}
    evals = trainer.eval_step(state, batch)
    losses = trainer.train_step(state, batch)
    for n, net in nets.items():
        params = dict(net.named_parameters())
        for k, v in net.state_dict().items():
            same = torch.equal(v, before[n][k])
            if n == frozen:
                assert same, (n, k)
            elif k in params:
                assert not same, (n, k)
    if frozen == "depth":
        assert not state.depth_net.training
        for k in losses:
            assert torch.equal(losses[k], evals[k]), k
    else:
        assert state.depth_net.training


def test_create_train_state_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.create_train_state(Config(compute_dtype="float32"))
    state = trainer.create_train_state(Config(compute_dtype="float32",
                                              iterations=2), device="cpu")
    assert state.device.type == "cpu" and state.step == 0
    before = (gs.LAUNCHES, gs.LAUNCHES_BWD_COORDS, gs.LAUNCHES_BWD_IMG)
    trainer.train_step(state, _batch(3, 64, 96))
    assert state.step == 1
    assert (gs.LAUNCHES, gs.LAUNCHES_BWD_COORDS, gs.LAUNCHES_BWD_IMG) == before


def test_trainer_run_epoch(capsys):
    """Mean losses over the loader, one step a batch; the depth-collapse
    warning when the disparity head saturates."""
    cfg = Config(compute_dtype="float32", iterations=1)
    state = trainer.create_train_state(cfg, device="cpu")
    loop = trainer.Trainer(state)
    loader = [_batch(4, 64, 96), _batch(5, 64, 96)]
    out = loop.run_epoch(loader, epoch=0)
    assert state.step == 2 and np.isfinite(out["total"])
    assert "train epoch 0 done" in capsys.readouterr().out
    with torch.no_grad():
        state.depth_net.predict_disps[0][0].conv.bias.fill_(-100.0)
    out = loop.run_epoch(loader[:1], epoch=1, phase="val")
    assert state.step == 2 and out["mean_disp"] < 1e-6
    assert "depth est has failed" in capsys.readouterr().out


def test_step_grad_limits_are_capped_and_counted():
    """The card's kernel- vs plain-sampler step check
    (``chip_smoke.step_grad_limits``): a tensor whose plain step
    reproduces itself to a quarter of 1e-4 is held at 1e-4, one that does
    not at 4 times its spread, never above 1e-3; more than 20 such tensors
    fail the check."""
    import chip_smoke

    spread = {"a": 1e-6, "b": 2.5e-5, "c": 1e-4, "d": 7.26e-4}
    limits, widened = chip_smoke.step_grad_limits(spread, "case")
    assert limits == {"a": 1e-4, "b": 1e-4, "c": 4e-4, "d": 1e-3}
    assert widened == {"c": (1e-4, 4e-4), "d": (7.26e-4, 1e-3)}
    many = {f"t{i}": 1e-4 for i in range(20)}
    assert len(chip_smoke.step_grad_limits(many, "case")[1]) == 20
    with pytest.raises(AssertionError, match="does not reproduce itself "
                       "on 21 tensors"):
        chip_smoke.step_grad_limits({**many, "x": 1e-4}, "case")
