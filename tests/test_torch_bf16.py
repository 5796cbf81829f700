"""The port's layers and networks in bfloat16 against the JAX package's
modules built with ``dtype=jnp.bfloat16``, on CPU.

``compute_dtype="bfloat16"`` is the JAX package's default: the networks'
convolutions take bfloat16 operands while the parameters stay float32.
Both sides get the same seeded numpy inputs and the same float32 weights
(JAX's seeded ``create_train_state`` params through ``models.convert``).

How the bounds are set. Each comparison measures three relative L2
distances on the same inputs: ``gap``, JAX's own bfloat16 run against its
float32 run (what bfloat16 rounding does to this computation); ``parity``,
the port's bfloat16 run against JAX's; and ``apart``, the port's bfloat16
run against its own float32 run. The bounds are fractions of ``gap``:

* a single layer (a conv, ``WSConv``, ``ConvGN``, BatchNorm) does the same
  roundings at the same points in both frameworks, so only the f32
  accumulation order (of a conv, of BatchNorm's batch statistics, of the
  weight standardization) differs and a rounding flips now and then:
  parity is held to 0.1 x gap (measured 0 for ReflConv, ConvGN and eval
  BatchNorm, 0.051 x for WSConv, 0.057 x for train BatchNorm);
* a network: XLA's fusions keep some bfloat16 intermediates in float32
  (``xla_allow_excess_precision``, on by default: a conv's output goes
  into the next BatchNorm unrounded) where the port rounds each one, JAX's
  depth net sums the subpixel upconv's taps in bfloat16
  (``layers._PhaseConv3x3``), and the output is rounded to bfloat16 last
  (the disparity's sigmoid, the pose's 0.01 * mean). The two runs then
  differ by independent roundings as large as bfloat16's own: about
  sqrt(2) x gap. Held at 2 x gap (measured: encoder features 0.97-1.31 x,
  disparity 1.24 x, pose 0.39 x);
* the encoder against JAX compiled with ``xla_allow_excess_precision``
  off (every bfloat16 intermediate rounded, as the program states it):
  its first two features at 0.1 x gap (measured 0.010 x, 0.045 x); the
  deeper three, where the residual blocks compound the flips, at 1 x gap
  (measured 0.30-0.62 x).

The tests that show the path is bfloat16, because a port that stayed
float32 would pass a network-level bound: every conv of both nets gets a
bfloat16 input and a bfloat16 weight (``F.conv2d`` recorded), the
parameters stay float32, the disparity is bfloat16 and the pose float32,
and at the layer level ``apart`` exceeds the parity bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn
from flax.core import unfreeze

from tcsfm.config import Config as JaxConfig
from tcsfm.models import layers as jl
from tcsfm.models.depth import DepthNet as JaxDepthNet
from tcsfm.models.pose import PoseNet as JaxPoseNet
from tcsfm.train.trainer import create_train_state
from tcsfm_torch.config import Config
from tcsfm_torch.infer import build_models
from tcsfm_torch.models import layers
from tcsfm_torch.models.convert import _conv_w, depth_state_dict, from_flax
from tcsfm_torch.models.depth import DepthNet
from tcsfm_torch.models.pose import PoseNet
from test_torch_models import _condition, _seeded_bn_stats
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

BF16 = torch.bfloat16
LAYER_FRACTION = 0.1
STRICT_FRACTIONS = (0.1, 0.1, 1.0, 1.0, 1.0)   # encoder features 0-4
NET_FRACTION = 2.0
B, H, W = 2, 64, 96


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def check_parity(jax_f32, jax_bf16, port_f32, port_bf16, fraction, what):
    """Hold ``parity`` to ``fraction`` x ``gap`` (module docstring); returns
    (gap, parity, apart)."""
    gap = rel(_f32(jax_bf16), _f32(jax_f32))
    parity = rel(_f32(port_bf16), _f32(jax_bf16))
    apart = rel(_f32(port_bf16), _f32(port_f32))
    print(f"{what}: gap {gap:.3e}, parity {parity:.3e} "
          f"({parity / gap:.3g} x gap), apart {apart:.3e}")
    assert gap > 0, what
    assert parity <= fraction * gap, \
        f"{what}: parity {parity:.3e} > {fraction} x gap {gap:.3e}"
    return gap, parity, apart


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def _layer_input(seed, shape=(2, 16, 24, 32)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("stride_kernel", [(1, 3), (2, 5)])
def test_wsconv_and_conv_gn(stride_kernel):
    """``WSConv`` alone (standardized in f32, then cast) at stride 1 and
    ``ConvGN`` (stride 2, GroupNorm16 in f32, ReLU)."""
    stride, k = stride_kernel
    x = _layer_input(1)
    rng = np.random.RandomState(2)
    kern = (rng.randn(k, k, 32, 32) * 0.1).astype(np.float32)
    bias = (rng.randn(32) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    shift = (rng.randn(32) * 0.1).astype(np.float32)
    if stride == 1:
        mods = {d: jl.WSConv(32, kernel=k, padding=k // 2, dtype=d)
                for d in (jnp.float32, jnp.bfloat16)}
        variables = {"params": {"kernel": kern, "bias": bias}}

        def port(dtype):
            m = layers.WSConv(32, 32, k, padding=k // 2, dtype=dtype)
            m.weight.data, m.bias.data = _conv_w(kern), torch.from_numpy(bias)
            return m
    else:
        mods = {d: jl.ConvGN(32, kernel=k, dtype=d)
                for d in (jnp.float32, jnp.bfloat16)}
        variables = {"params": {
            "WSConv_0": {"kernel": kern, "bias": bias},
            "GroupNorm16_0": {"GroupNorm_0": {"scale": scale,
                                              "bias": shift}}}}

        def port(dtype):
            m = layers.ConvGN(32, 32, k, dtype=dtype)
            m[0].weight.data, m[0].bias.data = _conv_w(kern), \
                torch.from_numpy(bias)
            m[1].weight.data, m[1].bias.data = torch.from_numpy(scale), \
                torch.from_numpy(shift)
            return m
    ref = {d: m.apply(variables, x) for d, m in mods.items()}
    with torch.no_grad():
        out = {d: port(d)(_nchw(x)) for d in (torch.float32, BF16)}
    assert out[BF16].dtype == BF16 and ref[jnp.bfloat16].dtype == jnp.bfloat16
    gap, parity, apart = check_parity(
        ref[jnp.float32], ref[jnp.bfloat16], _nhwc(out[torch.float32]),
        _nhwc(out[BF16]), LAYER_FRACTION, f"stride {stride}")
    assert apart > LAYER_FRACTION * gap


def test_refl_conv():
    x = _layer_input(3)
    rng = np.random.RandomState(4)
    kern = (rng.randn(3, 3, 32, 16) * 0.08).astype(np.float32)
    bias = (rng.randn(16) * 0.1).astype(np.float32)
    variables = {"params": {"Conv_0": {"kernel": kern, "bias": bias}}}
    ref = {d: jl.ReflConv(16, dtype=d).apply(variables, x)
           for d in (jnp.float32, jnp.bfloat16)}

    def port(dtype):
        m = layers.ReflConv(32, 16, dtype=dtype)
        m.conv.weight.data, m.conv.bias.data = _conv_w(kern), \
            torch.from_numpy(bias)
        with torch.no_grad():
            return m(_nchw(x))

    out = {d: port(d) for d in (torch.float32, BF16)}
    assert out[BF16].dtype == BF16
    gap, parity, apart = check_parity(
        ref[jnp.float32], ref[jnp.bfloat16], _nhwc(out[torch.float32]),
        _nhwc(out[BF16]), LAYER_FRACTION, "ReflConv")
    assert apart > LAYER_FRACTION * gap


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm(train):
    """Flax's BatchNorm (``force_float32_reductions``) on a bfloat16 input:
    f32 statistics and normalization, output rounded to bfloat16, running
    statistics in f32, moved by the same rule in train mode."""
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 12, 16, 32) * 2.0 + 0.5).astype(np.float32)
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))      # bf16 input
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    shift = (rng.randn(32) * 0.1).astype(np.float32)
    mean = (rng.randn(32) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": shift},
                 "batch_stats": {"mean": mean, "var": var}}
    ref, stats = {}, {}
    for d in (jnp.float32, jnp.bfloat16):
        m = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                          epsilon=1e-5, dtype=d)
        inp = jnp.asarray(xb) if d == jnp.bfloat16 else jnp.asarray(x)
        y, upd = m.apply(variables, inp, mutable=["batch_stats"])
        ref[d], stats[d] = y, upd["batch_stats"]
    out = {}
    for d in (torch.float32, BF16):
        m = layers.BatchNorm2d(32, dtype=d).train(train)
        m.weight.data, m.bias.data = torch.from_numpy(scale), \
            torch.from_numpy(shift)
        m.running_mean.copy_(torch.from_numpy(mean))
        m.running_var.copy_(torch.from_numpy(var))
        with torch.no_grad():
            out[d] = m(_nchw(x).to(d))
        assert m.running_mean.dtype == torch.float32
        if d == BF16:
            np.testing.assert_allclose(m.running_mean.numpy(),
                                       np.asarray(stats[jnp.bfloat16]["mean"]),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(m.running_var.numpy(),
                                       np.asarray(stats[jnp.bfloat16]["var"]),
                                       rtol=1e-5, atol=1e-6)
    assert out[BF16].dtype == BF16 and ref[jnp.bfloat16].dtype == jnp.bfloat16
    gap, parity, apart = check_parity(
        ref[jnp.float32], ref[jnp.bfloat16], _nhwc(out[torch.float32]),
        _nhwc(out[BF16]), LAYER_FRACTION, f"BatchNorm train={train}")
    assert apart > LAYER_FRACTION * gap


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxConfig(compute_dtype="float32", img_resolution="low",
                    use_mxu_warp=False)
    state, _, _ = create_train_state(cfg, jax.random.PRNGKey(0),
                                     steps_per_epoch=10)
    params = jax.tree_util.tree_map(np.asarray, unfreeze(state.params))
    stats = _seeded_bn_stats(
        jax.tree_util.tree_map(np.asarray, unfreeze(state.batch_stats)),
        np.random.RandomState(0))
    return params, stats


def _images(seed, n=B, c=3):
    return np.random.RandomState(seed).rand(n, H, W, c).astype(np.float32)


def _depth_nets(depth_params, stats):
    nets = {}
    for d in (torch.float32, BF16):
        net = DepthNet(dtype=d)
        net.load_state_dict(depth_state_dict(depth_params, stats))
        nets[d] = net.eval()
    return nets


def _jax_encode(variables, x, strict: bool):
    """JAX's encoder features in float32 and bfloat16; ``strict`` compiles
    with ``xla_allow_excess_precision`` off."""
    out = {}
    for d in (jnp.float32, jnp.bfloat16):
        m = JaxDepthNet(dtype=d)
        fn = jax.jit(lambda v, x, m=m: m.apply(v, x, method=m.encode))
        out[d] = fn.lower(variables, x).compile(compiler_options={
            "xla_allow_excess_precision": not strict})(variables, x)
    return out


@pytest.mark.parametrize("strict", [False, True])
def test_encoder_features(jax_params, strict):
    params, stats = jax_params
    x = _images(1)
    ref = _jax_encode({"params": params["depth"], "batch_stats": stats}, x,
                      strict)
    nets = _depth_nets(params["depth"], stats)
    with torch.no_grad():
        out = {d: net.encode(torch.from_numpy(x)) for d, net in nets.items()}
    for i in range(5):
        assert out[BF16][i].dtype == BF16
        fraction = STRICT_FRACTIONS[i] if strict else NET_FRACTION
        gap, _, apart = check_parity(
            ref[jnp.float32][i], ref[jnp.bfloat16][i],
            _nhwc(out[torch.float32][i]), _nhwc(out[BF16][i]), fraction,
            f"encoder feature {i} (strict={strict})")
        if strict and i < 2:
            assert apart > fraction * gap


def test_depth_net_disparity(jax_params):
    """The disparity at trained-like conditioning (``_condition``: a
    variance-preserving decoder, unsaturated heads)."""
    params, stats = jax_params
    depth_params = _condition(params["depth"])
    x = _images(3)
    variables = {"params": depth_params, "batch_stats": stats}
    ref = {d: jax.jit(JaxDepthNet(dtype=d).apply)(variables, x)[0]
           for d in (jnp.float32, jnp.bfloat16)}
    assert ref[jnp.bfloat16].dtype == jnp.bfloat16
    nets = _depth_nets(depth_params, stats)
    with torch.no_grad():
        out = {d: net(torch.from_numpy(x))[0] for d, net in nets.items()}
    assert out[BF16].dtype == BF16 and tuple(out[BF16].shape) == (B, H, W, 1)
    check_parity(ref[jnp.float32], ref[jnp.bfloat16], out[torch.float32],
                 out[BF16], NET_FRACTION, "disparity")


def test_pose_net(jax_params):
    params, stats = jax_params
    x = _images(8, n=4, c=6)
    ref = {d: jax.jit(JaxPoseNet(dtype=d).apply)({"params": params["pose"]},
                                                 x)
           for d in (jnp.float32, jnp.bfloat16)}
    assert ref[jnp.bfloat16].dtype == jnp.float32
    out = {}
    for d in (torch.float32, BF16):
        net = PoseNet(dtype=d)
        net.load_state_dict(from_flax(params, stats)[1])
        with torch.no_grad():
            out[d] = net.eval()(torch.from_numpy(x))
    assert out[BF16].dtype == torch.float32 and tuple(out[BF16].shape) == (4, 6)
    check_parity(ref[jnp.float32], ref[jnp.bfloat16], out[torch.float32],
                 out[BF16], NET_FRACTION, "pose")


def test_every_conv_runs_in_bf16(monkeypatch):
    """``Config(compute_dtype="bfloat16")``'s nets: every conv module of
    both nets calls ``F.conv2d`` once, with a bfloat16 input and weight;
    the disparity is bfloat16 and the pose float32, as in JAX; the state
    dicts are the float32 nets' (float32 parameters and statistics)."""
    depth_net, pose_net = build_models(Config(compute_dtype="bfloat16"),
                                       device="cpu")
    convs = [m for net in (depth_net, pose_net) for m in net.modules()
             if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 20 + 12 + 8
    called, seen = [], []
    for m in convs:
        m.register_forward_pre_hook(lambda mod, args: called.append(mod))
    conv2d = F.conv2d

    def recorded(x, w, *args, **kw):
        seen.append((x.dtype, w.dtype))
        return conv2d(x, w, *args, **kw)

    monkeypatch.setattr(F, "conv2d", recorded)
    imgs = torch.from_numpy(_images(9))
    with torch.no_grad():
        disp = depth_net(imgs)[0]
        pose = pose_net(torch.cat([imgs, imgs.flip(0)], -1))
    assert sorted(map(id, called)) == sorted(map(id, convs))
    assert seen == [(BF16, BF16)] * len(convs)
    assert disp.dtype == BF16 and pose.dtype == torch.float32
    # the state dicts (``models.convert``'s) are the float32 nets', bit for
    # bit from the same seed
    f32_nets = build_models(Config(compute_dtype="float32"), device="cpu")
    for net, ref in zip((depth_net, pose_net), f32_nets):
        sd, ref_sd = net.state_dict(), ref.state_dict()
        assert list(sd) == list(ref_sd)
        for k, v in sd.items():
            assert v.dtype == ref_sd[k].dtype and torch.equal(v, ref_sd[k])
            assert v.dtype in (torch.float32, torch.int64), k
