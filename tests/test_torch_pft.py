"""The port's PFT pieces (tcsfm_torch.solver.pft, config.PFTOptions,
utils.helpers.post_process_disparity) on CPU.

* ``compute_optimization_loss`` against the JAX package's on the same
  seeded ``CoupledOutputs`` arrays, for each of its switches, f32: the
  loss within 1e-6 relative, and its gradients (by the diff images, the
  weight masks, the poses and the target disparity) within 1e-5 of the
  largest.
* ``post_process_disparity`` and the two resizes of the 'depth_pred'
  mode against ``jax.image.resize`` (1e-6; measured 1.8e-7).
* The modes among themselves, at 32x64, B=2, S=2, 2 iterations with
  trained-like weights: at step 0 every mode but 'depth_pred' gives the
  same loss; each mode's gradient is the matching slice of the gradient of
  everything at once; the caller's networks (state_dict, BatchNorm
  statistics, train flags, requires_grad) come out unchanged; the history
  and the last-N averages, the ``epochs <= avg_final_epochs`` edge
  included.
* ``Config`` refuses ``l_ssim=False``; ``PFTOptions``' fields and
  ``Config.camera_height`` carry JAX's defaults.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from tcsfm.config import Config as JaxConfig
from tcsfm.config import PFTOptions as JaxPFTOptions
from tcsfm.solver.coupled import CoupledOutputs as JaxCoupledOutputs
from tcsfm.solver.pft import \
    compute_optimization_loss as jax_compute_optimization_loss
from tcsfm.utils.helpers import \
    post_process_disparity as jax_post_process_disparity
from tcsfm_torch import infer
from tcsfm_torch.config import Config, PFTOptions
from tcsfm_torch.ops import grid_sample as gs
from tcsfm_torch.solver import pft
from tcsfm_torch.solver.coupled import CoupledOutputs
from tcsfm_torch.utils.helpers import post_process_disparity
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

S, B, H, W, ITERS = 2, 2, 32, 64, 2


# --------------------------------------------------------------------------
# the loss against JAX's
# --------------------------------------------------------------------------


def _outputs(rng, h, w):
    """Seeded CoupledOutputs fields, [S*B, ...] numpy f32."""
    n = S * B

    def rand(*shape, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def mask(*shape, p=0.8):
        return (rng.rand(*shape) < p).astype(np.float32)

    return dict(diff_img=rand(n, h, w, 1, hi=0.5), img_rec=rand(n, h, w, 3),
                valid_mask=mask(n, h, w, 1),
                weight_mask=rand(n, h, w, 1, lo=0.5),
                poses=rand(n, ITERS, 6, lo=-0.02, hi=0.02),
                auto_mask_error=rand(n, h, w, 1, hi=0.5),
                auto_mask=mask(n, h, w, 1, p=0.6))


SWITCHES = [{}, {"diff_img_argmin": False}, {"automasking": False},
            {"diff_img_argmin": False, "automasking": False},
            {"l_inverse_reconstruction": False}, {"l_depth_consist": False},
            {"l_depth_init": False}, {"l_smooth": True},
            {"l_pose_consist": True},
            {"l_smooth": True, "l_pose_consist": True,
             "l_inverse_reconstruction": False}]
GRAD_OF = ("diff_img", "weight_mask", "poses")


@pytest.mark.parametrize("switches", SWITCHES,
                         ids=lambda d: "-".join(d) or "defaults")
def test_optimization_loss_matches_jax(switches):
    rng = np.random.RandomState(len(json.dumps(switches)))
    h, w = 12, 20
    fwd, inv = _outputs(rng, h, w), _outputs(rng, h, w)
    tgt = rng.rand(B, h, w, 3).astype(np.float32)
    disp = rng.uniform(0.1, 1.0, (B, h, w, 1)).astype(np.float32)
    init = rng.uniform(0.1, 1.0, (B, h, w, 1)).astype(np.float32)

    def jax_loss(fwd_g, inv_g, disp):
        f = JaxCoupledOutputs(**{**fwd, **fwd_g})
        i = JaxCoupledOutputs(**{**inv, **inv_g})
        return jax_compute_optimization_loss(
            JaxPFTOptions(**switches), jnp.asarray(tgt), disp,
            jnp.asarray(init), f, i)

    pick = lambda d: {k: jnp.asarray(d[k]) for k in GRAD_OF}  # noqa: E731
    ref, ref_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        pick(fwd), pick(inv), jnp.asarray(disp))

    leaves = {f"{part}.{k}": torch.tensor(d[k], requires_grad=True)
              for part, d in (("fwd", fwd), ("inv", inv)) for k in GRAD_OF}
    disp_t = torch.tensor(disp, requires_grad=True)

    def outputs(part, d):
        return CoupledOutputs(**{k: leaves[f"{part}.{k}"] if k in GRAD_OF
                                 else torch.from_numpy(v)
                                 for k, v in d.items()})

    loss = pft.compute_optimization_loss(
        PFTOptions(**switches), torch.from_numpy(tgt), disp_t,
        torch.from_numpy(init), outputs("fwd", fwd), outputs("inv", inv))
    assert abs(loss.item() - float(ref)) <= 1e-6 * abs(float(ref))
    loss.backward()
    want = {f"fwd.{k}": v for k, v in ref_grads[0].items()}
    want.update({f"inv.{k}": v for k, v in ref_grads[1].items()})
    want["disp"] = ref_grads[2]
    got = dict(leaves, disp=disp_t)
    largest = max(np.abs(np.asarray(v)).max() for v in want.values())
    for k, v in want.items():
        g = got[k].grad
        g = np.zeros_like(np.asarray(v)) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(v), atol=1e-5 * largest,
                                   rtol=0, err_msg=k)


# --------------------------------------------------------------------------
# the flip-merge and the resizes
# --------------------------------------------------------------------------


def test_post_process_disparity_matches_jax():
    rng = np.random.RandomState(0)
    l, r = (rng.rand(2, 24, 80).astype(np.float32) for _ in range(2))
    ref = np.asarray(jax_post_process_disparity(jnp.asarray(l), jnp.asarray(r)))
    port = post_process_disparity(torch.from_numpy(l), torch.from_numpy(r))
    np.testing.assert_allclose(port.numpy(), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("src,dst", [((192, 640), (48, 160)),
                                     ((32, 64), (8, 16)),
                                     ((8, 16), (32, 64))])
def test_resize_matches_jax_image_resize(src, dst):
    """Downsampling antialiases in both (without ``antialias`` the 1/4
    resize of a 192x640 map is 0.46 off); upsampling is plain bilinear."""
    x = np.random.RandomState(1).rand(3, *src, 1).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (3, *dst, 1), "bilinear"))
    port = pft.resize_bilinear(torch.from_numpy(x), *dst)
    np.testing.assert_allclose(port.numpy(), ref, atol=1e-6, rtol=0)


# --------------------------------------------------------------------------
# the modes among themselves
# --------------------------------------------------------------------------


def smooth_window(seed):
    return chip_smoke.pft_batch(torch, B, H, W, seed, "cpu")


@pytest.fixture(scope="module")
def nets():
    depth_net, pose_net = infer.build_models(
        Config(compute_dtype="float32"), device="cpu",
        generator=torch.Generator().manual_seed(0))
    chip_smoke.condition_like_trained(depth_net, torch)
    return depth_net, pose_net


def _optimizer(nets, mode, **opts):
    kw = dict(epochs=3, avg_final_epochs=2, num_source_imgs=S)
    kw.update(opts)
    return pft.PFTOptimizer(Config(compute_dtype="float32",
                                   iterations=ITERS), PFTOptions(**kw),
                            *nets, mode=mode)


def _step0_grads(nets, mode, extra=()):
    """The step-0 loss and gradients by name of a mode's trainable tensors
    (and of ``extra`` ones, set to require grad first)."""
    opt = _optimizer(nets, mode)
    win = opt._prepare(smooth_window(0), torch.device("cpu"))
    named = dict(win.trainable)
    for k, t in extra(win) if extra else ():
        named[k] = t.requires_grad_()
    loss, _ = opt._forward(win, gs.grid_sample)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss.item(), dict(zip(named, grads))


def test_modes_agree_at_step_zero_and_slice_the_full_gradient(nets):
    def everything(win):
        return [(f"pose.{k}", p) for k, p in win.pose_net.named_parameters()]

    loss_all, full = _step0_grads(nets, "all_depth", everything)
    for mode in ("encoder", "decoder", "pose", "all_depth"):
        loss, grads = _step0_grads(nets, mode)
        assert loss == pytest.approx(loss_all, rel=1e-6, abs=0), mode
        assert grads and all(k in full for k in grads), mode
        for k, g in grads.items():
            ref = full[k]
            assert g is not None and g.shape == ref.shape, (mode, k)
            assert (g - ref).norm() <= 1e-5 * ref.norm() + 1e-12, (mode, k)
    assert set(_step0_grads(nets, "encoder")[1]) | set(
        _step0_grads(nets, "decoder")[1]) == {k for k in full
                                              if k.startswith("depth.")}

    # bottleneck: the gradient by the two deepest skips, as a decoder-mode
    # forward that lets its skips take one gives it
    def deepest(win):
        return [("s3", win.skips[-2]), ("s4", win.skips[-1])]

    loss_b, grads_b = _step0_grads(nets, "bottleneck")
    loss_d, grads_d = _step0_grads(nets, "decoder", deepest)
    assert loss_b == pytest.approx(loss_all, rel=1e-6, abs=0)
    for k in ("s3", "s4"):
        assert grads_b[k].abs().max() > 0
        assert torch.allclose(grads_b[k], grads_d[k], rtol=0,
                              atol=1e-6 * grads_d[k].abs().max())

    loss_p, grads_p = _step0_grads(nets, "depth_pred")
    assert loss_p != loss_all and grads_p["disp"].abs().max() > 0
    assert grads_p["disp"].shape == ((S + 1) * B, H // 4, W // 4, 1)


def _snapshot(net):
    return ({k: v.clone() for k, v in net.state_dict().items()}, net.training,
            [p.requires_grad for p in net.parameters()])


@pytest.mark.parametrize("mode", pft.MODES)
def test_mode_runs_and_leaves_the_callers_nets(nets, mode):
    before = [_snapshot(n) for n in nets]
    res = _optimizer(nets, mode).optimize_window(smooth_window(1),
                                                 device="cpu")
    for net, (sd, training, flags) in zip(nets, before):
        for k, v in net.state_dict().items():
            assert torch.equal(v, sd[k]), (mode, k)
        assert net.training == training
        assert [p.requires_grad for p in net.parameters()] == flags
    assert res.losses.shape == (3,)
    assert torch.isfinite(res.losses).all()
    assert res.poses_opt.shape == (S, B, 6) == res.poses_init.shape
    assert res.disp_opt.shape == (B, H, W)
    assert res.poses_hist is None and res.disp_hist is None
    assert (res.losses[1:] != res.losses[0]).all(), mode


@pytest.mark.parametrize("epochs,avg", [(4, 2), (2, 5), (3, 3)])
def test_history_and_last_n_averages(nets, epochs, avg):
    """The split path (flip-merge only for the last ``avg`` entries) gives
    the history path's values; the averages take the last ``avg`` entries,
    or all there are when ``epochs <= avg``."""
    batch = smooth_window(2)
    plain = _optimizer(nets, "encoder", epochs=epochs,
                       avg_final_epochs=avg).optimize_window(batch,
                                                             device="cpu")
    opt = _optimizer(nets, "encoder", epochs=epochs, avg_final_epochs=avg)
    opt.record_history = True
    hist = opt.optimize_window(batch, device="cpu")
    assert hist.poses_hist.shape == (epochs, S, B, 6)
    assert hist.disp_hist.shape == (epochs, B, H, W)
    assert torch.equal(plain.losses, hist.losses)
    n = min(avg, epochs)
    torch.testing.assert_close(hist.poses_opt, hist.poses_hist[-n:].mean(0),
                               rtol=0, atol=0)
    torch.testing.assert_close(hist.disp_opt, hist.disp_hist[-n:].mean(0),
                               rtol=0, atol=0)
    torch.testing.assert_close(plain.poses_opt, hist.poses_opt, rtol=0,
                               atol=0)
    torch.testing.assert_close(plain.disp_opt, hist.disp_opt, rtol=0, atol=0)
    assert torch.equal(hist.poses_init, hist.poses_hist[0])


def test_sgd_and_the_errors(nets, monkeypatch):
    res = _optimizer(nets, "pose", optimizer="sgd").optimize_window(
        smooth_window(3), device="cpu")
    assert torch.isfinite(res.losses).all()
    with pytest.raises(ValueError, match="unknown PFT mode"):
        pft.PFTOptimizer(Config(compute_dtype="float32"),
                         PFTOptions(), *nets, mode="skips")
    with pytest.raises(ValueError, match="rmsprop"):
        _optimizer(nets, "encoder", optimizer="rmsprop").optimize_window(
            smooth_window(3), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _optimizer(nets, "encoder").optimize_window(smooth_window(3))


# --------------------------------------------------------------------------
# the configuration
# --------------------------------------------------------------------------


def test_options_carry_jax_defaults():
    jax_defaults = dataclasses.asdict(JaxPFTOptions())
    for name, value in dataclasses.asdict(PFTOptions()).items():
        assert jax_defaults[name] == value, name
    assert Config().camera_height == JaxConfig().camera_height == 1.70
    assert Config.from_json(JaxConfig(camera_height=1.5).to_json()
                            ).camera_height == 1.5


def test_config_refuses_ssim_off():
    with pytest.raises(NotImplementedError, match="l_ssim=False"):
        Config(l_ssim=False)
    with pytest.raises(NotImplementedError, match="l_ssim=False"):
        Config.from_json(JaxConfig(l_ssim=False).to_json())
    with pytest.raises(NotImplementedError, match="l_ssim=False"):
        dataclasses.replace(Config(), l_ssim=False)
    assert Config.from_json(JaxConfig().to_json()).l_ssim
