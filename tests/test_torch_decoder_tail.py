"""The port's fused decoder tail against the JAX package's, on CPU.

``tcsfm_torch.ops.decoder_tail`` and its route through
``models.depth.make_tail_apply`` against ``experiments/decoder_tail.py``
(imported as ``experiments/test_decoder_tail.py`` imports it) and the JAX
package's depth net. The same seeded numpy arrays go to both sides; JAX's
phase-form input ``z [N, H/2, W/2, 4*32]`` becomes the port's
full-resolution NCHW ``x``, HWIO kernels become OIHW (``models/convert``).

Tolerances:
* ``decoder_tail_plain`` vs ``decoder_tail_reference``: atol 1e-5 (the
  same f32 convs, other summation orders);
* vs the Pallas kernel in interpret mode: atol 6e-3, the bound
  ``experiments/test_decoder_tail.py`` holds it to (its matmuls take bf16
  operands);
* ``_DecoderTail``'s backward vs ``jax.grad`` of the reference: 1e-4 of
  each gradient's largest magnitude (both autodiff of the same f32
  formulation);
* ``make_tail_apply`` vs the port's ``DepthNet.forward``: atol 1e-6 (on the
  CPU the tail runs the forward's own convs); vs JAX's depth net 1e-5, and
  vs JAX's ``make_tail_apply`` (Pallas, interpret mode) 6e-3;
* the coupled forward through ``make_tail_apply`` vs JAX's with its depth
  net, under trained-like conditioning: poses atol 1e-6 at every iteration.

The kernel itself runs only on the card: tests/test_torch_cuda.py. Here a
stand-in library shows what the wrapper passes to it, and two emulations
in plain PyTorch hold its design to the plain tail at 1e-6 (a tenth of the
card's 1e-5): its 3xTF32 products (three ``F.conv2d`` terms on operands
rounded to TF32), and its tiling (the tile and buffer sizes read from
``csrc/decoder_tail.cu``, the reflected cell offsets, conv2's padded M,
the persistent loop) at border tiles and images smaller than a tile.
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.core import unfreeze

from tcsfm.config import Config as JaxConfig
from tcsfm.models.depth import DepthNet as JaxDepthNet
from tcsfm.models.depth import make_depth_apply
from tcsfm.solver.coupled import solve_disp as jax_solve_disp
from tcsfm.solver.coupled import solve_pose_iteratively as jax_spi
from tcsfm.train.trainer import create_train_state
from tcsfm.utils.helpers import disp_to_depth as jax_disp_to_depth
from tcsfm_torch import infer
from tcsfm_torch.config import Config
from tcsfm_torch.models.convert import _conv_w, depth_state_dict, from_flax
from tcsfm_torch.models.depth import DepthNet, make_tail_apply, tail_weights
from tcsfm_torch.models.pose import PoseNet
from tcsfm_torch.ops import _build
from tcsfm_torch.ops import decoder_tail as dt
from tcsfm_torch.ops import grid_sample as gs

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "experiments"))
import decoder_tail as jdt  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402, F401 (autouse)

C1, C2 = 32, 8


def _jax_weights(seed=0):
    """HWIO kernels and biases, drawn as experiments/test_decoder_tail.py
    draws them."""
    rng = np.random.RandomState(seed)
    return [a.astype(np.float32) for a in (
        rng.randn(3, 3, C1, C1) * 0.08, rng.randn(C1) * 0.1,
        rng.randn(3, 3, C1, C2) * 0.08, rng.randn(C2) * 0.1,
        rng.randn(3, 3, C2, 1) * 0.2, rng.randn(1) * 0.1)]


def _port(a, requires_grad=False) -> torch.Tensor:
    """An HWIO kernel as OIHW, anything else as it is."""
    t = _conv_w(a) if a.ndim == 4 and a.shape[:2] == (3, 3) else \
        torch.from_numpy(np.array(a, np.float32))
    return t.requires_grad_(requires_grad)


def _z(n, hl, wl, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, hl, wl, 4 * C1) * 0.5).astype(np.float32)


def _phase_to_nchw(z) -> np.ndarray:
    """[N, Hl, Wl, 4*C] (phase 2*pi + pj in channel block p) → [N, C, 2Hl,
    2Wl], as decoder_tail_reference reads it."""
    n, hl, wl, c4 = z.shape
    x = np.asarray(z).reshape(n, hl, wl, 2, 2, c4 // 4)
    x = x.transpose(0, 1, 3, 2, 4, 5).reshape(n, 2 * hl, 2 * wl, c4 // 4)
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


@pytest.mark.parametrize("n,hl,wl", [(2, 4, 4), (1, 3, 5), (2, 5, 12),
                                     (1, 2, 9)])
def test_plain_matches_jax_reference(n, hl, wl):
    """Square and H != W; odd half-resolution sizes (3x5, 2x9); an image
    4 pixels high."""
    z, w = _z(n, hl, wl), _jax_weights()
    ref = jdt.decoder_tail_reference(jnp.asarray(z), *map(jnp.asarray, w))
    out = dt.decoder_tail_plain(torch.from_numpy(_phase_to_nchw(z)),
                                *map(_port, w))
    assert tuple(out.shape) == (n, 2 * hl, 2 * wl, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_plain_matches_pallas_kernel_interpret():
    z, w = _z(1, 4, 8, seed=2), _jax_weights(3)
    ref = jdt._phase_to_space(jdt._tail_forward(
        jnp.asarray(z), *map(jnp.asarray, w), interpret=True))
    out = dt.decoder_tail_plain(torch.from_numpy(_phase_to_nchw(z)),
                                *map(_port, w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=6e-3,
                               rtol=0)


def test_backward_matches_jax(monkeypatch):
    """``_DecoderTail`` with a stand-in for its launch: the gradient of
    sum(out**2) with respect to x and every weight, against jax.grad of
    the reference (what JAX's custom VJP returns for the same
    cotangent)."""
    launched = []

    def stand_in(*inputs):
        launched.append(len(inputs))
        return dt.decoder_tail_plain(*inputs)

    monkeypatch.setattr(dt, "_launch", stand_in)
    z, w = _z(1, 4, 6, seed=4), _jax_weights(5)
    ref = jax.grad(lambda *a: jnp.sum(jdt.decoder_tail_reference(*a) ** 2),
                   argnums=tuple(range(7)))(jnp.asarray(z),
                                            *map(jnp.asarray, w))
    x = torch.from_numpy(_phase_to_nchw(z)).requires_grad_(True)
    ws = [_port(a, requires_grad=True) for a in w]
    (dt._DecoderTail.apply(x, *ws) ** 2).sum().backward()
    assert launched == [7]
    refs = [_phase_to_nchw(ref[0])] + [_port(np.asarray(r)).numpy()
                                       for r in ref[1:]]
    for got, r in zip([x, *ws], refs):
        scale = np.abs(r).max()
        assert scale > 0
        np.testing.assert_allclose(got.grad.numpy(), r, atol=1e-4 * scale,
                                   rtol=0)


def test_backward_only_where_asked(monkeypatch):
    monkeypatch.setattr(dt, "_launch", dt.decoder_tail_plain)
    x = torch.from_numpy(_phase_to_nchw(_z(1, 3, 4))).requires_grad_(True)
    ws = [_port(a) for a in _jax_weights()]
    ws[2].requires_grad_(True)
    dt._DecoderTail.apply(x, *ws).sum().backward()
    assert x.grad is not None and ws[2].grad is not None
    assert all(t.grad is None for i, t in enumerate(ws) if i != 2)


@pytest.fixture(scope="module")
def depth_nets():
    """JAX's DepthNet with the trained-like scaling of
    experiments/test_decoder_tail.py (every variable x 0.25), and the port's
    with the same weights."""
    model = JaxDepthNet(num_scales=1)
    imgs = np.random.RandomState(3).rand(2, 32, 64, 3).astype(np.float32)
    # one compiled init: the same variables, bit for bit, as the eager
    # init, which compiles every operation of the net on its own
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(imgs))
    variables = jax.tree_util.tree_map(lambda p: np.asarray(p) * 0.25,
                                       unfreeze(variables))
    net = DepthNet()
    net.load_state_dict(depth_state_dict(variables["params"],
                                         variables["batch_stats"]))
    return model, variables, net.eval(), imgs


def test_make_tail_apply_matches_forward_and_jax(depth_nets):
    model, variables, net, imgs = depth_nets
    x = torch.from_numpy(imgs)
    before = dt.LAUNCHES
    with torch.no_grad():
        (tail,) = make_tail_apply(net)(x)
        (plain,) = net(x)
    assert dt.LAUNCHES == before            # CPU tensors: the plain tail
    assert tuple(tail.shape) == (2, 32, 64, 1)
    np.testing.assert_allclose(tail.numpy(), plain.numpy(), atol=1e-6,
                               rtol=0)
    ref = make_depth_apply(model, variables)(jnp.asarray(imgs))[0]
    np.testing.assert_allclose(tail.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_make_tail_apply_matches_jax_pallas_tail(depth_nets, monkeypatch):
    model, variables, net, imgs = depth_nets
    monkeypatch.setattr(jdt, "INTERPRET", True)
    ref = jdt.make_tail_apply(model, variables)(jnp.asarray(imgs))[0]
    with torch.no_grad():
        (tail,) = make_tail_apply(net)(torch.from_numpy(imgs))
    np.testing.assert_allclose(tail.numpy(), np.asarray(ref), atol=6e-3,
                               rtol=0)


def test_tail_weights_and_input(depth_nets):
    """The tail's weights are iconv4's, the first feature conv's and the
    first head's; its input is the last upconv's conv output, which the
    decoder's ELU then takes."""
    _, _, net, imgs = depth_nets
    w = tail_weights(net)
    assert [tuple(t.shape) for t in w] == [tuple(s) for s in
                                          dt._WEIGHT_SHAPES]
    assert w[0] is net.iconvs[4][0].conv.weight
    assert w[5] is net.predict_disps[0][0].conv.bias
    with torch.no_grad():
        skips = net.encode(torch.from_numpy(imgs))
        z = net.decode_tail_input(skips)
        upconv = net.depth_upconvs[4](net._trunk(skips)[-1])
    assert tuple(z.shape) == (2, C1, 32, 64)
    assert torch.equal(F.elu(z), upconv)
    with pytest.raises(AssertionError):
        DepthNet(num_scales=2).decode_tail_input(skips)


# the coupled forward: 64x96, B=2, S=2, 4 iterations
B, S, H, W, ITERS = 2, 2, 64, 96, 4
DECODER = ("upconv", "iconv", "feature_conv", "disp_head")


def _condition(depth_params):
    """Variance-preserving decoder kernels (std 1/sqrt(fan_in)) and a
    far-field disparity head (bias -3), as tests/test_torch_coupled.py
    conditions them."""
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


def _smooth_inputs(seed):
    rng = np.random.RandomState(seed)
    lo = torch.from_numpy(rng.rand((S + 1) * B, 3, 9, 13))
    up = F.interpolate(lo, size=(H, W), mode="bilinear", align_corners=True)
    imgs = up.permute(0, 2, 3, 1).numpy().astype(np.float32)
    K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2.5], [0, 0, 1]],
                 np.float32)
    return (imgs[:B], imgs[B:].reshape(S, B, H, W, 3),
            np.broadcast_to(K, (B, 3, 3)).copy())


@pytest.fixture(scope="module")
def jax_state():
    """JAX's seeded train state, initialised once for the module."""
    jcfg = JaxConfig(compute_dtype="float32", img_resolution="low",
                     use_mxu_warp=False, iterations=ITERS)
    return (jcfg,) + create_train_state(jcfg, jax.random.PRNGKey(0),
                                        steps_per_epoch=10)


@pytest.mark.parametrize("seed", [0, 1])
def test_coupled_forward_through_the_tail_matches_jax(seed, jax_state):
    jcfg, state, depth_model, pose_model = jax_state
    params = jax.tree_util.tree_map(np.asarray, unfreeze(state.params))
    stats = jax.tree_util.tree_map(np.asarray, unfreeze(state.batch_stats))
    depth_params = _condition(params["depth"])
    tgt, src, K = _smooth_inputs(seed)

    disps = jax_solve_disp(make_depth_apply(
        depth_model, {"params": depth_params, "batch_stats": stats}),
        jnp.asarray(tgt), jnp.asarray(src))
    depths = jnp.stack([jax_disp_to_depth(d[0], jcfg.min_depth,
                                          jcfg.max_depth)[1] for d in disps])
    _, _, out = jax_spi(ITERS, depths, lambda x: pose_model.apply(
        {"params": params["pose"]}, x), jnp.asarray(tgt), jnp.asarray(src),
        jnp.asarray(K), return_errors=True)
    ref_chain = np.asarray(jnp.concatenate([out["fwd"].poses,
                                            out["inv"].poses]))

    depth_sd, pose_sd = from_flax({"depth": depth_params,
                                   "pose": params["pose"]}, stats)
    depth_net, pose_net = DepthNet(), PoseNet()
    depth_net.load_state_dict(depth_sd)
    pose_net.load_state_dict(pose_sd)
    depth_net.eval()
    pose_net.eval()
    before = (dt.LAUNCHES, gs.LAUNCHES)
    poses, poses_inv, disp, chain = infer.coupled_forward(
        depth_net, pose_net, tgt, src, K, Config(compute_dtype="float32",
                                                 iterations=ITERS),
        device="cpu", depth_apply=make_tail_apply(depth_net))
    assert (dt.LAUNCHES, gs.LAUNCHES) == before
    np.testing.assert_allclose(disp.numpy(), np.asarray(disps[0][0]),
                               atol=1e-5, rtol=0)
    assert chain.shape == ref_chain.shape == (2 * S * B, ITERS, 6)
    for it in range(ITERS):
        err = np.abs(chain[:, it].numpy() - ref_chain[:, it]).max()
        assert err <= 1e-6, f"iteration {it}: max abs delta {err} > 1e-6"
    assert torch.equal(poses, chain[:S * B, -1].reshape(S, B, 6))
    assert torch.equal(poses_inv, chain[S * B:, -1].reshape(S, B, 6))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the fourth card, so that the
    wrapper takes its CUDA path into a stand-in library."""

    @property
    def device(self):
        return torch.device("cuda", 3)


def test_launch_passes_pointers_sizes_and_card(monkeypatch):
    """A CUDA-typed call goes to the library's entry point with the
    tensors' data pointers, N, H, W, the tensors' card and PyTorch's
    stream, and counts one launch; a non-zero return raises and counts
    none."""
    calls = []

    class StandIn:
        def __init__(self, rc):
            self.rc = rc

        def tcsfm_decoder_tail_fwd(self, *args):
            calls.append(args)
            return self.rc

    monkeypatch.setattr(dt._build, "load", lambda: StandIn(0))
    monkeypatch.setattr(dt, "_stream", lambda device: 1234)
    x = torch.from_numpy(_phase_to_nchw(_z(2, 3, 4))).as_subclass(_OnCard)
    ws = [_port(a).as_subclass(_OnCard) for a in _jax_weights()]
    before = dt.LAUNCHES
    out = dt.decoder_tail(x, *ws)
    assert dt.LAUNCHES == before + 1
    assert tuple(out.shape) == (2, 6, 8, 1) and out.is_contiguous()
    assert calls == [(x.data_ptr(), *[t.data_ptr() for t in ws],
                      out.data_ptr(), 2, 6, 8, 3, 1234)]
    monkeypatch.setattr(dt._build, "load", lambda: StandIn(98))
    with pytest.raises(RuntimeError, match="decoder_tail kernel launch "
                       "failed: CUDA error 98"):
        dt.decoder_tail(x, *ws)
    assert dt.LAUNCHES == before + 1 and len(calls) == 2


def test_build_keys_sources_flags_and_name(monkeypatch, tmp_path):
    """``_build.build`` with a stand-in nvcc: the library from every
    ``csrc/*.cu``, and the phase probe's build of ``decoder_tail.cu`` alone
    with its flag under another name and digest; each built once, then
    reused; a failed compile raises and leaves no file behind."""
    log = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    f"open({str(log)!r}, 'a').write(' '.join(sys.argv) + "
                    f"'\\n')\nif '-DFAIL' in sys.argv: sys.exit(1)\n"
                    f"open(sys.argv[sys.argv.index('-o') + 1], 'w')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    lib = _build.build()
    tail = _build.CSRC / "decoder_tail.cu"
    probe = _build.build([tail], ("-DTCSFM_TAIL_PROBE",), "libtail_probe.so")
    assert lib.name == _build.LIB_NAME and probe.name == "libtail_probe.so"
    assert lib.is_file() and probe.is_file() and lib.parent != probe.parent
    assert (_build.build(), _build.build([tail], ("-DTCSFM_TAIL_PROBE",),
                                         "libtail_probe.so")) == (lib, probe)
    lib_call, probe_call = log.read_text().splitlines()
    assert all(str(s) in lib_call for s in _build.CSRC.glob("*.cu"))
    assert "-DTCSFM_TAIL_PROBE" not in lib_call
    assert "-DTCSFM_TAIL_PROBE" in probe_call and str(tail) in probe_call
    assert "grid_sample.cu" not in probe_call
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build([tail], ("-DFAIL",), "libfail.so")
    assert not list((tmp_path / "build").glob("*/libfail.so*"))


@pytest.mark.parametrize("layout",["nchw", "channels_last", "strided"])
def test_cpu_dispatch_is_the_plain_tail(layout):
    """On the CPU any layout goes to the plain version (the port's CPU
    decoder hands the tail channels_last tensors)."""
    x = torch.from_numpy(_phase_to_nchw(_z(1, 3, 4)))
    x = {"nchw": x, "channels_last": x.contiguous(
        memory_format=torch.channels_last), "strided": x[..., ::2]}[layout]
    x.requires_grad_(True)
    ws = [_port(a) for a in _jax_weights()]
    before = dt.LAUNCHES
    out = dt.decoder_tail(x, *ws)
    assert dt.LAUNCHES == before
    assert torch.equal(out, dt.decoder_tail_plain(x, *ws))
    out.sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0


def _bad(case):
    x = torch.from_numpy(_phase_to_nchw(_z(1, 3, 4)))
    ws = [_port(a) for a in _jax_weights()]
    if case == "channels":
        x = x[:, :16].contiguous()
    elif case == "small":
        x = x[:, :, :3].contiguous()
    elif case == "dtype":
        x = x.double()
    elif case == "channels_last":       # the kernel takes NCHW
        x = x.contiguous(memory_format=torch.channels_last).as_subclass(
            _OnCard)
        ws = [t.as_subclass(_OnCard) for t in ws]
    elif case == "weights":
        ws[2] = ws[2][:4].contiguous()
    elif case == "device":
        x = x.as_subclass(_OnCard)
    return x, ws


@pytest.mark.parametrize("case", ["channels", "small", "dtype",
                                  "channels_last", "weights", "device"])
def test_wrapper_rejects_bad_inputs(case):
    x, ws = _bad(case)
    with pytest.raises((TypeError, ValueError)):
        dt.decoder_tail(x, *ws)


def _tail_inputs(shape, seed):
    """x and weights drawn as chip_smoke.py's ``tail_inputs`` draws them."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(*shape) * 0.5).astype(np.float32))
    return x, [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(C1, C1, 3, 3) * 0.08, rng.randn(C1) * 0.1,
        rng.randn(C2, C1, 3, 3) * 0.08, rng.randn(C2) * 0.1,
        rng.randn(1, C2, 3, 3) * 0.2, rng.randn(1) * 0.1)]


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (``cvt.rna.tf32.f32``): the magnitude's bits + half an ulp,
    the 13 low bits cleared."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_rna(t: torch.Tensor):
    hi = _tf32(t)
    return hi, _tf32(t - hi)


def _split(t: torch.Tensor):
    """The kernel's split: Veltkamp's (c = 8193 v, hi = c - (c - v)) in f32
    rounds v to nearest with TF32's 11 significant bits; lo = v - hi
    exactly, of which the tensor core reads the TF32 bits (truncation)."""
    c = t * 8193.0
    hi = c - (c - t)
    lo = t - hi
    return hi, (lo.contiguous().view(torch.int32) & -0x2000).view(
        torch.float32)


def _conv_tf32(x, w, b, terms, split):
    """A reflect-padded 3x3 conv with TF32 operands: one product
    (``terms=1``) or the kernel's three, lo*hi + hi*lo + hi*hi."""
    (xh, xl), (wh, wl) = split(F.pad(x, (1, 1, 1, 1), mode="reflect")), \
        split(w)
    if terms == 1:
        return F.conv2d(xh, wh, b)
    return F.conv2d(xl, wh, b) + F.conv2d(xh, wl) + F.conv2d(xh, wh)


@pytest.mark.parametrize("split", ["rna", "kernel"])
@pytest.mark.parametrize("shape", [(2, C1, 12, 16), (1, C1, 24, 40)])
def test_3xtf32_split_holds_f32_accuracy(shape, split):
    """conv1 and conv2 with 3xTF32 products (conv3 in f32, as the kernel's
    FMAs) stay within 1e-6 of decoder_tail_plain on the sigmoid output
    (measured 3.6e-7, as close to a float64 tail as the f32 one is), a
    tenth of the card's 1e-5, with hi and lo each rounded to nearest
    (ties away, ``cvt.rna.tf32.f32``) and with the kernel's split; one TF32
    product leaves ~2.5e-4 (conv1's output ~7e-4 off), which would break
    the 1e-5 check."""
    split = {"rna": _split_rna, "kernel": _split}[split]
    x, ws = _tail_inputs(shape, sum(shape))
    w1, b1, w2, b2, w3, b3 = ws
    ref = dt.decoder_tail_plain(x, *ws)
    ref64 = dt.decoder_tail_plain(x.double(), *(w.double() for w in ws))
    errs = {}
    for terms in (1, 3):
        y = F.elu(_conv_tf32(F.elu(x), w1, b1, terms, split))
        y = F.elu(_conv_tf32(y, w2, b2, terms, split))
        out = torch.sigmoid(dt._refl_conv(y, w3, b3)).permute(0, 2, 3, 1)
        errs[terms] = (out - ref).abs().max().item()
    f32_err = (ref.double() - ref64).abs().max().item()
    assert errs[3] <= 1e-6 and errs[3] <= 2 * f32_err
    assert errs[1] > 1e-5


def _kernel_constants() -> dict:
    """The integer constants of csrc/decoder_tail.cu (tile and stride
    sizes), by name."""
    src = (_build.CSRC / "decoder_tail.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"\b(k\w+) = (\d+)[,;]", src)}


def _reflect(g: torch.Tensor, n: int) -> torch.Tensor:
    g = g.clamp(-1, n)
    return torch.where(g < 0, -g, torch.where(g >= n, 2 * n - 2 - g, g))


def _mm3(a, b):
    """a @ b in 3xTF32, as the kernel's mma.sync triples."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _implicit_gemm(src, base, width, w, bias):
    """elu(conv) at the cells whose top-left taps lie at ``base`` in the
    flattened buffer ``src`` [C, cells] of row length ``width``: A [cells,
    9 taps x C] (K tap-major), B the OIHW weights as [K, Cout]."""
    taps = torch.tensor([dy * width + dx for dy in range(3)
                         for dx in range(3)])
    a = src[:, base[:, None] + taps].permute(1, 2, 0).reshape(len(base), -1)
    return F.elu(_mm3(a, w.permute(2, 3, 1, 0).reshape(a.shape[1], -1))
                 + bias)


def _emulate_kernel(x, w1, b1, w2, b2, w3, b3, grid):
    """The kernel's tiling in plain PyTorch: ``grid`` persistent blocks
    take tiles in a fixed stride; per tile, elu(x) over rows r0-3.. and
    columns c0-4.. (each at its reflected coordinate), f1's cells and
    conv2's M (padded to a multiple of 16, padding rows clamped to the last
    cell) each computed at its reflected coordinate from its taps' offsets
    in the buffer before, conv3 at the in-image pixels. Checks that every
    tap falls inside its buffer and every output pixel is written once."""
    k = _kernel_constants()
    th, tw = k["kTileH"], k["kTileW"]
    h0, w0, h1, w1_, h2, w2_ = th + 6, tw + 8, th + 4, tw + 4, th + 2, tw + 2
    n, _, hgt, wid = x.shape
    tiles_h, tiles_w = -(-hgt // th), -(-wid // tw)
    out = torch.full((n, hgt, wid), float("nan"))
    for block in range(grid):
        for tile in range(block, n * tiles_h * tiles_w, grid):
            img, rc = divmod(tile, tiles_h * tiles_w)
            r0, c0 = rc // tiles_w * th, rc % tiles_w * tw
            gc = _reflect(torch.arange(c0 - 4, c0 - 4 + w0), wid)
            if c0 >= 4 and c0 + tw + 4 <= wid:     # the 16-byte copies
                assert torch.equal(gc, torch.arange(c0 - 4, c0 - 4 + w0))
            gr = _reflect(torch.arange(r0 - 3, r0 - 3 + h0), hgt)
            f0 = F.elu(x[img][:, gr][:, :, gc]).reshape(C1, -1)
            m = torch.arange(h1 * w1_)
            assert len(m) % 16 == 0
            qr = _reflect(r0 - 2 + m // w1_, hgt) - (r0 - 3)
            qc = _reflect(c0 - 2 + m % w1_, wid) - (c0 - 4)
            assert qr.min() >= 1 and qr.max() <= h0 - 2
            assert qc.min() >= 1 and qc.max() <= w0 - 2
            f1 = _implicit_gemm(f0, (qr - 1) * w0 + qc - 1, w0, w1, b1)
            m = torch.arange(-(-h2 * w2_ // 16) * 16).clamp(max=h2 * w2_ - 1)
            qr = _reflect(r0 - 1 + m // w2_, hgt) - (r0 - 2)
            qc = _reflect(c0 - 1 + m % w2_, wid) - (c0 - 2)
            assert qr.min() >= 1 and qr.max() <= h1 - 2
            assert qc.min() >= 1 and qc.max() <= w1_ - 2
            f2 = _implicit_gemm(f1.t(), (qr - 1) * w1_ + qc - 1, w1_, w2,
                                b2)[:h2 * w2_]
            y = torch.sigmoid(F.conv2d(f2.t().reshape(1, C2, h2, w2_), w3,
                                       b3))[0, 0]
            hh, ww = min(th, hgt - r0), min(tw, wid - c0)
            assert torch.isnan(out[img, r0:r0 + hh, c0:c0 + ww]).all()
            out[img, r0:r0 + hh, c0:c0 + ww] = y[:hh, :ww]
    assert not torch.isnan(out).any()
    return out[..., None]


@pytest.mark.parametrize("shape,grid", [
    ((1, C1, 4, 4), 1),         # the minimum, one tile cut on all sides
    ((1, C1, 5, 7), 2),         # smaller than a tile; more blocks than tiles
    ((1, C1, 14, 40), 3),       # border tiles, partial at bottom and right
    ((2, C1, 26, 72), 4)])      # interior columns; 18 tiles over 4 blocks
def test_kernel_tiling_emulation_matches_plain(shape, grid):
    """Within 1e-6 of the plain tail (measured <= 4.2e-7)."""
    x, ws = _tail_inputs(shape, sum(shape))
    out = _emulate_kernel(x, *ws, grid)
    assert (out - dt.decoder_tail_plain(x, *ws)).abs().max().item() <= 1e-6


def _grid_conv(src, w, b, gw, rows):
    """elu(conv) at ``rows`` positions of a grid ``gw`` wide, stored
    [channels, positions]: position p takes taps p + dy gw + dx (the bf16
    kernel's M-tiles of consecutive positions); reads past the source's end
    are NaN."""
    taps = torch.tensor([dy * gw + dx for dy in range(3) for dx in range(3)])
    pad = torch.full((src.shape[0], rows + taps.max() + 1 - src.shape[1]),
                     float("nan"))
    a = torch.cat([src, pad], 1)[:, torch.arange(rows)[:, None] + taps]
    a = a.permute(1, 2, 0).reshape(rows, -1)
    return F.elu(_mm3(a, w.permute(2, 3, 1, 0).reshape(a.shape[1], -1))
                 + b).t()


def _on_grid(f, rows, gw, r0, c0, hgt, wid, valid_cols):
    """A conv's output on its grid (image row r0 + i, column c0 + j at
    position i gw + j): positions past ``rows`` rows or ``valid_cols``
    columns, or more than one outside the image, NaN (no output may read
    them); those one outside the image take their reflection, as
    ``reflect_border`` copies them."""
    f = f[:, :rows * gw].reshape(f.shape[0], rows, gw).clone()
    gr = torch.arange(r0, r0 + rows)[:, None].expand(rows, gw)
    gc = torch.arange(c0, c0 + gw)[None].expand(rows, gw)
    f[:, :, valid_cols:] = float("nan")
    far = (gr < -1) | (gr > hgt) | (gc < -1) | (gc > wid)
    edge = ~far & ((gr < 0) | (gr >= hgt) | (gc < 0) | (gc >= wid))
    src = f[:, _reflect(gr, hgt) - r0, _reflect(gc, wid) - c0]
    f = torch.where(edge, src, f)
    f[:, far] = float("nan")
    return f.reshape(f.shape[0], -1)


def _emulate_bf16_kernel(x, w1, b1, w2, b2, w3, b3, grid):
    """The bf16 kernel's tiling (``decoder_tail_bf16_kernel``) in plain
    PyTorch, in float32: ``grid`` persistent blocks take tiles in a fixed
    stride; per tile, x's box (rows r0-3.., columns c0-8.., ``kBfBoxW``
    wide: TMA's columns start on 16 bytes) as the producer fills it, its
    cells outside the image NaN (TMA's zeros, or left unwritten: no cell
    may read them); elu(x) on a grid ``kBfTileW`` + 6 positions wide, each
    position at its reflected coordinate in the box; conv1 and conv2 at the
    consecutive positions of their grids (two warpgroups of 64-position
    M-tiles; positions past a row's end, or the grid's, NaN), each then
    reflect-padded by copying; conv3 at the in-image pixels. Checks that
    every read falls inside its buffer and every output pixel is written
    once."""
    k = _kernel_constants()
    th, tw, bw = k["kBfTileH"], k["kBfTileW"], k["kBfBoxW"]
    gw, xh, f1h, f2h = tw + 6, th + 6, th + 4, th + 2
    assert gw + 5 <= bw and bw % 8 == 0
    n, _, hgt, wid = x.shape
    tiles_h, tiles_w = -(-hgt // th), -(-wid // tw)
    out = torch.full((n, hgt, wid), float("nan"))
    for block in range(grid):
        for tile in range(block, n * tiles_h * tiles_w, grid):
            img, rc = divmod(tile, tiles_h * tiles_w)
            r0, c0 = rc // tiles_w * th, rc % tiles_w * tw
            rows = torch.arange(r0 - 3, r0 - 3 + xh)
            cols = torch.arange(c0 - 8, c0 - 8 + bw)
            inside = (((rows >= 0) & (rows < hgt))[:, None]
                      & ((cols >= 0) & (cols < wid))[None])
            box = torch.full((C1, xh, bw), float("nan"))
            box[:, inside] = x[img][:, rows.clamp(0, hgt - 1)][
                :, :, cols.clamp(0, wid - 1)][:, inside]
            rr = _reflect(rows, hgt) - (r0 - 3)
            cc = _reflect(torch.arange(c0 - 3, c0 - 3 + gw), wid) - (c0 - 8)
            assert rr.min() >= 0 and rr.max() < xh
            assert cc.min() >= 0 and cc.max() < bw
            f0 = F.elu(box[:, rr][:, :, cc]).reshape(C1, -1)
            assert not torch.isnan(f0).any()
            m1 = -(-f1h * gw // 128) * 128
            f1 = _on_grid(_grid_conv(f0, w1, b1, gw, m1), f1h, gw, r0 - 2,
                          c0 - 2, hgt, wid, tw + 4)
            m2 = -(-f2h * gw // 128) * 128
            f2 = _on_grid(_grid_conv(f1, w2, b2, gw, m2), f2h, gw, r0 - 1,
                          c0 - 1, hgt, wid, tw + 2)
            y = torch.sigmoid(F.conv2d(f2.reshape(1, C2, f2h, gw), w3,
                                       b3))[0, 0]
            hh, ww = min(th, hgt - r0), min(tw, wid - c0)
            assert torch.isnan(out[img, r0:r0 + hh, c0:c0 + ww]).all()
            out[img, r0:r0 + hh, c0:c0 + ww] = y[:hh, :ww]
    assert not torch.isnan(out).any()
    return out[..., None]


@pytest.mark.parametrize("shape,grid", [
    ((1, C1, 4, 4), 1),         # the minimum, one tile cut on all sides
    ((1, C1, 5, 7), 2),         # smaller than a tile; more blocks than tiles
    ((1, C1, 17, 33), 3),       # one past a tile in H and W
    ((2, C1, 40, 72), 4),       # W % 8 == 0 (TMA), tiles cut at both borders
    ((1, C1, 24, 48), 2)])      # TMA, boxes out of the image on all sides
def test_bf16_kernel_tiling_emulation_matches_plain(shape, grid):
    """The bf16 kernel's tiling, emulated in float32, within 1e-6 of the
    plain tail (the bf16 roundings left out: this checks the geometry)."""
    x, ws = _tail_inputs(shape, sum(shape))
    out = _emulate_bf16_kernel(x, *ws, grid)
    assert (out - dt.decoder_tail_plain(x, *ws)).abs().max().item() <= 1e-6
