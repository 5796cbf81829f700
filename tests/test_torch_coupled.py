"""The port's coupled forward (tcsfm_torch.infer) against the JAX package's.

The whole slice at 64x96, B=2, S=2, 4 iterations on CPU: solve_disp →
disp_to_depth → solve_pose_iteratively, with seeded ``create_train_state``
weights converted by ``from_flax``. The per-iteration pose chain is held
against JAX's ``CoupledOutputs.poses`` (fwd then inv) iteration by
iteration at atol 1e-5; the disparity at atol 1e-5. A second group feeds
both sides the same depths, so that solver parity shows apart from
depth-net parity.

Conditioning of the inputs. The iterations feed each pose back through a
warp whose valid mask is discontinuous (a pixel projecting past the image
border is pushed to 2.0 and masked out). With white-noise images and the
near depths (~0.1) of a random-init depth net, a pose delta of 1e-7 shifts
projections by ~1e-4 px, flips a few border pixels, and the chain delta
grows ~20x an iteration; float64 runs of the port alone, 1e-7 apart in
depth, already differ by 1.5e-3 at iteration 4. So the slice runs as a
trained model would see it: smooth images (bilinear from a 9x13 grid), a
variance-preserving decoder and a far-field disparity head (bias -3,
depths near 1). The raw init is held on the first, one-shot pose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.core import unfreeze

from tcsfm.config import Config as JaxConfig
from tcsfm.solver.coupled import solve_disp as jax_solve_disp
from tcsfm.solver.coupled import solve_pose as jax_solve_pose
from tcsfm.solver.coupled import solve_pose_iteratively as jax_spi
from tcsfm.train.trainer import create_train_state
from tcsfm.utils.helpers import disp_to_depth as jax_disp_to_depth
from tcsfm_torch import infer
from tcsfm_torch.config import Config
from tcsfm_torch.models.convert import from_flax
from tcsfm_torch.models.depth import DepthNet
from tcsfm_torch.models.pose import PoseNet
from tcsfm_torch.ops import grid_sample as gs
from tcsfm_torch.solver import coupled
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, S, H, W, ITERS = 2, 2, 64, 96, 4
ATOL = 1e-5
DECODER = ("upconv", "iconv", "feature_conv", "disp_head")


def _condition(depth_params):
    """Variance-preserving decoder kernels (std 1/sqrt(fan_in)) and a
    far-field disparity head (bias -3)."""
    out = dict(depth_params)
    for k, v in depth_params.items():
        if k.startswith(DECODER):
            kern, bias = v["Conv_0"]["kernel"], v["Conv_0"]["bias"]
            scale = np.sqrt(kern.shape[3] / (2.0 * kern.shape[2]))
            if k.startswith("disp_head"):
                bias = bias - 3.0
            out[k] = {"Conv_0": {"kernel": (kern * scale).astype(np.float32),
                                 "bias": bias.astype(np.float32)}}
    return out


def _smooth(rng, shape):
    lo = torch.from_numpy(rng.rand(int(np.prod(shape[:-3])), 3, 9, 13))
    up = F.interpolate(lo, size=(H, W), mode="bilinear", align_corners=True)
    return up.permute(0, 2, 3, 1).reshape(shape).numpy().astype(np.float32)


def _inputs(seed, smooth=True):
    rng = np.random.RandomState(seed)
    make = (lambda s: _smooth(rng, s)) if smooth else \
        (lambda s: rng.rand(*s).astype(np.float32))
    K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2.5], [0, 0, 1]],
                 np.float32)
    return make((B, H, W, 3)), make((S, B, H, W, 3)), \
        np.broadcast_to(K, (B, 3, 3)).copy()


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(compute_dtype="float32", img_resolution="low",
                     use_mxu_warp=False, iterations=ITERS)
    state, depth_model, pose_model = create_train_state(
        jcfg, jax.random.PRNGKey(0), steps_per_epoch=10)
    params = jax.tree_util.tree_map(np.asarray, unfreeze(state.params))
    stats = jax.tree_util.tree_map(np.asarray, unfreeze(state.batch_stats))
    cfg = Config(iterations=ITERS)

    def jax_slice(depth_params, pose_params, tgt, src, K):
        disps = jax_solve_disp(lambda x: depth_model.apply(
            {"params": depth_params, "batch_stats": stats}, x), tgt, src)
        depths = jnp.stack([
            jax_disp_to_depth(d[0], cfg.min_depth, cfg.max_depth)[1]
            for d in disps])
        poses, poses_inv, out = jax_spi(
            ITERS, depths, lambda x: pose_model.apply({"params": pose_params}, x),
            tgt, src, K, return_errors=True)
        chain = jnp.concatenate([out["fwd"].poses, out["inv"].poses])
        return poses, poses_inv, disps[0][0], chain

    def port_models(depth_params):
        depth_sd, pose_sd = from_flax(
            {"depth": depth_params, "pose": params["pose"]}, stats)
        depth_net, pose_net = DepthNet(), PoseNet()
        depth_net.load_state_dict(depth_sd)
        pose_net.load_state_dict(pose_sd)
        return depth_net.eval(), pose_net.eval()

    return dict(params=params, cfg=cfg, jax_slice=jax.jit(jax_slice),
                port_models=port_models, pose_model=pose_model)


def _assert_chain(port_chain, ref_chain, atol=ATOL):
    port_chain, ref_chain = port_chain.numpy(), np.asarray(ref_chain)
    assert port_chain.shape == ref_chain.shape
    for it in range(port_chain.shape[1]):
        err = np.abs(port_chain[:, it] - ref_chain[:, it]).max()
        assert err <= atol, f"iteration {it}: max abs delta {err} > {atol}"


@pytest.mark.parametrize("seed", [0, 1])
def test_slice_matches_jax(models, seed):
    depth_params = _condition(models["params"]["depth"])
    tgt, src, K = _inputs(seed)
    ref = models["jax_slice"](depth_params, models["params"]["pose"],
                              tgt, src, K)
    depth_net, pose_net = models["port_models"](depth_params)
    port = infer.coupled_forward(depth_net, pose_net, tgt, src, K,
                                 models["cfg"], device="cpu")
    shapes = [(S, B, 6), (S, B, 6), (B, H, W, 1), (2 * S * B, ITERS, 6)]
    assert [tuple(p.shape) for p in port] == shapes
    np.testing.assert_allclose(port[2].numpy(), np.asarray(ref[2]), atol=ATOL,
                               rtol=0)
    _assert_chain(port[3], ref[3])
    for p, r in zip(port[:2], ref[:2]):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=ATOL, rtol=0)


def test_slice_raw_init_first_pose(models):
    """Raw create_train_state weights, white-noise images: the one-shot pose
    (iteration 0) before any warp feeds back."""
    tgt, src, K = _inputs(2, smooth=False)
    ref = models["jax_slice"](models["params"]["depth"],
                              models["params"]["pose"], tgt, src, K)
    depth_net, pose_net = models["port_models"](models["params"]["depth"])
    port = infer.coupled_forward(depth_net, pose_net, tgt, src, K,
                                 models["cfg"], device="cpu")
    np.testing.assert_allclose(port[3][:, 0].numpy(), np.asarray(ref[3])[:, 0],
                               atol=1e-6, rtol=0)


def _same_depths(seed):
    rng = np.random.RandomState(seed)
    lo = torch.from_numpy(rng.uniform(0.3, 1.8, ((S + 1) * B, 1, 9, 13)))
    up = F.interpolate(lo, size=(H, W), mode="bilinear", align_corners=True)
    return up.reshape(S + 1, B, 1, H, W).permute(0, 1, 3, 4, 2).numpy() \
        .astype(np.float32)


def _jax_pose_apply(models):
    params = models["params"]["pose"]
    return lambda x: models["pose_model"].apply({"params": params}, x)


@pytest.mark.parametrize("iterations", [1, 2, 4])
def test_solver_on_same_depths(models, iterations):
    tgt, src, K = _inputs(3)
    depths = _same_depths(4)
    _, _, out = jax_spi(iterations, jnp.asarray(depths), _jax_pose_apply(models),
                        jnp.asarray(tgt), jnp.asarray(src), jnp.asarray(K),
                        return_errors=True)
    ref_chain = jnp.concatenate([out["fwd"].poses, out["inv"].poses])
    _, pose_net = models["port_models"](models["params"]["depth"])
    calls = []

    def counting_sampler(img, coords):
        calls.append(img.shape)
        return gs.grid_sample(img, coords)

    with torch.no_grad():
        poses, poses_inv, chain = coupled.solve_pose_iteratively(
            iterations, torch.from_numpy(depths), pose_net,
            torch.from_numpy(tgt), torch.from_numpy(src), torch.from_numpy(K),
            sampler=counting_sampler)
    _assert_chain(chain, ref_chain)
    assert torch.equal(poses, chain[:S * B, -1].reshape(S, B, 6))
    assert torch.equal(poses_inv, chain[S * B:, -1].reshape(S, B, 6))
    # pose-only warps: 3 channels, and the last iteration skips its re-warp
    assert calls == [(2 * S * B, H, W, 3)] * (iterations - 1)


def test_solver_perturbations(models):
    tgt, src, K = _inputs(5)
    depths = _same_depths(6)
    rng = np.random.RandomState(7)
    trans = rng.uniform(-0.02, 0.02, 2 * S * B).astype(np.float32)
    yaw = rng.uniform(-0.02, 0.02, 2 * S * B).astype(np.float32)
    _, _, out = jax_spi(2, jnp.asarray(depths), _jax_pose_apply(models),
                        jnp.asarray(tgt), jnp.asarray(src), jnp.asarray(K),
                        return_errors=True, trans_pert=jnp.asarray(trans),
                        yaw_pert=jnp.asarray(yaw))
    _, pose_net = models["port_models"](models["params"]["depth"])
    with torch.no_grad():
        _, _, chain = coupled.solve_pose_iteratively(
            2, torch.from_numpy(depths), pose_net, torch.from_numpy(tgt),
            torch.from_numpy(src), torch.from_numpy(K),
            trans_pert=torch.from_numpy(trans), yaw_pert=torch.from_numpy(yaw))
    _assert_chain(chain, jnp.concatenate([out["fwd"].poses, out["inv"].poses]))


def test_solve_pose_one_shot(models):
    tgt, src, _ = _inputs(8)
    ref = jax_solve_pose(_jax_pose_apply(models), jnp.asarray(tgt),
                         jnp.asarray(src))
    _, pose_net = models["port_models"](models["params"]["depth"])
    with torch.no_grad():
        port = coupled.solve_pose(pose_net, torch.from_numpy(tgt),
                                  torch.from_numpy(src))
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-6, rtol=0)


def test_solve_disp_packing():
    tgt, src, _ = _inputs(9)
    seen = []

    def depth_apply(x):
        seen.append(x)
        return [x[..., :1] * 2]

    out = coupled.solve_disp(depth_apply, torch.from_numpy(tgt),
                             torch.from_numpy(src))
    assert len(out) == S + 1 and tuple(seen[0].shape) == ((S + 1) * B, H, W, 3)
    assert torch.equal(out[0][0], torch.from_numpy(tgt)[..., :1] * 2)
    assert torch.equal(out[2][0], torch.from_numpy(src[1])[..., :1] * 2)


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(iterations=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.build_models(cfg)
    depth_net, pose_net = infer.build_models(cfg, device="cpu")
    tgt, src, K = _inputs(10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.coupled_forward(depth_net, pose_net, tgt, src, K, cfg)
    before = gs.LAUNCHES
    out = infer.coupled_forward(depth_net, pose_net, tgt, src, K, cfg,
                                device="cpu")
    assert gs.LAUNCHES == before and all(torch.isfinite(o).all() for o in out)


def test_build_models_is_seeded():
    cfg = Config()
    a = infer.build_models(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(5))
    b = infer.build_models(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(5))
    for net_a, net_b in zip(a, b):
        assert not net_a.training
        for (ka, va), (kb, vb) in zip(net_a.state_dict().items(),
                                      net_b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)


def test_depth_net_init_is_flax_truncated_normal():
    """The depth net's convs follow the JAX package's ``kaiming_out``:
    Flax's ``variance_scaling(2.0, "fan_out", "truncated_normal")``, a
    normal of std sigma / 0.87962566 cut at two of that std (sigma^2 =
    2 / fan_out). Every weight lies inside the cut, the std is sigma within
    3% (tensors of >= 4096 weights), and the largest weight is where Flax's
    own draw of the same shape puts it (both ~2.27 sigma)."""
    from tcsfm.models.layers import kaiming_out

    depth_net, _ = infer.build_models(
        Config(), device="cpu", generator=torch.Generator().manual_seed(0))
    convs = [m.weight for m in depth_net.modules()
             if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) > 20
    cut = 2.0 / 0.87962566103423978
    for w in convs:
        o, i, kh, kw = w.shape
        sigma = (2.0 / (o * kh * kw)) ** 0.5
        assert w.abs().max().item() <= cut * sigma * (1 + 1e-6)
        if w.numel() >= 4096:
            assert abs(w.std().item() / sigma - 1) < 0.03
    w = convs[1]                                      # a 3x3 64->64 conv
    o, i, kh, kw = w.shape
    sigma = (2.0 / (o * kh * kw)) ** 0.5
    flax = np.asarray(kaiming_out(jax.random.PRNGKey(0), (kh, kw, i, o)))
    assert abs(w.abs().max().item() - np.abs(flax).max()) < 0.02 * sigma


def test_config_reads_jax_config_json():
    jcfg = JaxConfig(iterations=3, num_scales=2, min_depth=0.1,
                     img_resolution="low")
    cfg = Config.from_json(jcfg.to_json())
    assert (cfg.iterations, cfg.num_scales, cfg.min_depth, cfg.image_size) == \
        (3, 2, 0.1, (128, 448))
    assert Config.from_json(cfg.to_json()) == cfg
    classical = Config.from_json(JaxConfig(flow_type="classical").to_json())
    assert (classical.flow_type, classical.pose_input_channels) == \
        ("classical", 8)
    assert cfg.pose_input_channels == 6
