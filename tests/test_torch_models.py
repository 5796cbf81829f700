"""The port's DepthNet / PoseNet against the JAX package's, on CPU.

Weights: seeded ``create_train_state`` params (compute_dtype float32),
converted by ``tcsfm_torch.models.convert.from_flax``. The BatchNorm running
``mean``/``var`` are first set to seeded non-trivial values, so eval-mode
BatchNorm really normalizes.

Tolerances:
* poses atol 1e-6: the pose net ends in a spatial mean times 0.01;
* encoder features 1e-5 of their largest magnitude: f32 convolutions in
  another summation order;
* disparity atol 1e-5 with a variance-preserving decoder (``_condition``):
  at the raw random init the decoder's He fan-out scaling grows the
  activations ~2x a stage, the sigmoid logits reach ~1e2, and f32 resolves
  the disparity only to ~2e-4 in either framework (each is that far from a
  float64 evaluation of the same weights). The raw init is held at the 5e-4
  that tests/test_models.py::test_subpixel_decoder_matches_literal holds
  two exact regroupings of the JAX decoder to, for the same reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tcsfm.config import Config as JaxConfig
from tcsfm.models.depth import DepthNet as JaxDepthNet
from tcsfm.train.trainer import create_train_state
from tcsfm_torch.models.convert import depth_state_dict, from_flax
from tcsfm_torch.models.depth import DepthNet
from tcsfm_torch.models.pose import PoseNet
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, H, W = 2, 64, 96
DECODER = ("upconv", "iconv", "feature_conv", "disp_head")


def _seeded_bn_stats(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _seeded_bn_stats(v, rng)
        elif k == "mean":
            out[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return out


def _condition(depth_params):
    """Rescale the decoder kernels from He fan-out to variance-preserving
    fan-in scaling, std 1/sqrt(fan_in): the sigmoid heads then sit in their
    unsaturated range, as a trained model's do."""
    out = dict(depth_params)
    for k, v in depth_params.items():
        if k.startswith(DECODER):
            kern = v["Conv_0"]["kernel"]
            scale = np.sqrt(kern.shape[3] / (2.0 * kern.shape[2]))
            out[k] = {"Conv_0": {"kernel": (kern * scale).astype(np.float32),
                                 "bias": v["Conv_0"]["bias"]}}
    return out


@pytest.fixture(scope="module")
def jax_models():
    cfg = JaxConfig(compute_dtype="float32", img_resolution="low",
                    use_mxu_warp=False)
    state, depth_model, pose_model = create_train_state(
        cfg, jax.random.PRNGKey(0), steps_per_epoch=10)
    params = jax.tree_util.tree_map(np.asarray, unfreeze(state.params))
    stats = _seeded_bn_stats(
        jax.tree_util.tree_map(np.asarray, unfreeze(state.batch_stats)),
        np.random.RandomState(0))
    depth_fn = jax.jit(lambda p, s, x: depth_model.apply(
        {"params": p, "batch_stats": s}, x))
    encode_fn = jax.jit(lambda p, s, x: depth_model.apply(
        {"params": p, "batch_stats": s}, x, method=depth_model.encode))
    pose_fn = jax.jit(lambda p, x: pose_model.apply({"params": p}, x))
    return params, stats, depth_fn, encode_fn, pose_fn


def _port_depth(depth_params, stats, num_scales=1):
    net = DepthNet(num_scales=num_scales)
    net.load_state_dict(depth_state_dict(depth_params, stats))
    return net.eval()


def _images(seed, n=B, c=3):
    return np.random.RandomState(seed).rand(n, H, W, c).astype(np.float32)


def test_state_dicts_load_strictly(jax_models):
    params, stats = jax_models[:2]
    depth_sd, pose_sd = from_flax(params, stats)
    assert set(depth_sd) == set(DepthNet().state_dict())
    assert set(pose_sd) == set(PoseNet().state_dict())
    DepthNet().load_state_dict(depth_sd, strict=True)
    PoseNet().load_state_dict(pose_sd, strict=True)
    w = pose_sd["conv1.0.weight"]
    assert tuple(w.shape) == (16, 6, 7, 7)          # OIHW
    np.testing.assert_array_equal(
        w.numpy(), params["pose"]["conv1"]["WSConv_0"]["kernel"].transpose(3, 2, 0, 1))


def test_bn_stats_are_nontrivial(jax_models):
    params, stats = jax_models[:2]
    net = _port_depth(params["depth"], stats)
    bn = net.encoder.encoder.layer2[0].bn1
    assert not torch.allclose(bn.running_var, torch.ones_like(bn.running_var))
    assert not torch.allclose(bn.running_mean, torch.zeros_like(bn.running_mean))


@pytest.mark.parametrize("seed", [1, 2])
def test_encoder_features(jax_models, seed):
    params, stats, _, encode_fn, _ = jax_models
    x = _images(seed)
    ref = encode_fn(params["depth"], stats, x)
    with torch.no_grad():
        port = _port_depth(params["depth"], stats).encode(torch.from_numpy(x))
    assert len(port) == len(ref) == 5
    for p, r in zip(port, ref):
        r = np.asarray(r)
        p = p.permute(0, 2, 3, 1).numpy()
        assert p.shape == r.shape
        scale = max(1.0, float(np.abs(r).max()))
        assert np.abs(p - r).max() <= 1e-5 * scale


@pytest.mark.parametrize("seed", [3, 4])
def test_disparity_matches_jax(jax_models, seed):
    params, stats, depth_fn, _, _ = jax_models
    depth_params = _condition(params["depth"])
    x = _images(seed)
    ref = np.asarray(depth_fn(depth_params, stats, x)[0])
    with torch.no_grad():
        port = _port_depth(depth_params, stats)(torch.from_numpy(x))
    assert len(port) == 1 and tuple(port[0].shape) == (B, H, W, 1)
    assert 0.05 < ref.min() and ref.max() < 0.95     # unsaturated heads
    np.testing.assert_allclose(port[0].numpy(), ref, atol=1e-5, rtol=0)


def test_disparity_at_raw_init(jax_models):
    params, stats, depth_fn, _, _ = jax_models
    x = _images(5)
    ref = np.asarray(depth_fn(params["depth"], stats, x)[0])
    with torch.no_grad():
        port = _port_depth(params["depth"], stats)(torch.from_numpy(x))[0]
    np.testing.assert_allclose(port.numpy(), ref, atol=5e-4, rtol=0)


def test_encode_decode_split(jax_models):
    params, stats = jax_models[:2]
    net = _port_depth(_condition(params["depth"]), stats)
    x = torch.from_numpy(_images(6))
    with torch.no_grad():
        assert torch.equal(net(x)[0], net.decode(net.encode(x))[0])


def test_multiscale_disparities_match_jax():
    """num_scales=3: per-scale heads reading the merged coarser features."""
    x = _images(7)
    model = JaxDepthNet(num_scales=3, dtype=jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, unfreeze(variables["params"]))
    stats = _seeded_bn_stats(jax.tree_util.tree_map(
        np.asarray, unfreeze(variables["batch_stats"])), np.random.RandomState(1))
    params = _condition(params)
    ref = jax.jit(model.apply)({"params": params, "batch_stats": stats},
                               jnp.asarray(x))
    with torch.no_grad():
        port = _port_depth(params, stats, num_scales=3)(torch.from_numpy(x))
    assert [tuple(p.shape) for p in port] == [r.shape for r in ref]
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [8, 9])
def test_pose_matches_jax(jax_models, seed):
    params, stats, _, _, pose_fn = jax_models
    x = _images(seed, n=4, c=6)
    ref = np.asarray(pose_fn(params["pose"], x))
    net = PoseNet()
    net.load_state_dict(from_flax(params, stats)[1])
    with torch.no_grad():
        port = net.eval()(torch.from_numpy(x))
    assert tuple(port.shape) == (4, 6)
    np.testing.assert_allclose(port.numpy(), ref, atol=1e-6, rtol=0)
