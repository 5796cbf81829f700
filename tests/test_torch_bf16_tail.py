"""The bfloat16 decoder tail against the Pallas kernel, on CPU.

``decoder_tail_plain_bf16`` computes what ``experiments/decoder_tail.py``'s
``_tail_kernel`` computes for a bfloat16 net (its ``_tail_forward`` casts):
bf16 x, elu(x) rounded to bf16, bf16 weights into f32 accumulators, f32
biases, f1 and f2 rounded to bf16, an f32 sigmoid. It is held against the
Pallas kernel in interpret mode (as ``tests/test_torch_decoder_tail.py``
runs it) at atol 1e-5: both round the same values at the same points,
so they agree to f32 rounding (measured 6.0e-8 on both inputs here) unless
an f32 sum in another order (or ELU's expm1 against exp - 1) lands a value
on the other side of a bfloat16 rounding boundary, which would show as
~1e-3; the f32 plain tail is 2.4e-3 and 2.7e-3 away (6e-3 is the f32
tail's bound against the kernel).

The tail route of a bfloat16 net (``make_tail_apply``) is held against
JAX's ``make_tail_apply`` with a bfloat16 ``DepthNet`` (Pallas in
interpret mode) at 2 x JAX's own gap between that route in bfloat16 and
in float32, as ``tests/test_torch_bf16.py`` holds the disparity (the same
reasons: XLA's excess precision, the subpixel upconv's bfloat16 tap sums,
the output rounded to bfloat16 last); measured 0.98 x.

The backward is JAX's: autodiff of the f32 reference on f32-cast inputs
(``_tail_bwd``), so on the CPU the bf16 route's gradients are held against
``jax.vjp`` of ``decoder_tail_reference`` at the bfloat16 input: the f32
weights' at 1e-4 of their largest magnitude, as the f32 route's are, and
x's, rounded to bfloat16 on both sides, within one rounding (2^-8) of its
largest.
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tcsfm.config import Config as JaxConfig
from tcsfm.models.depth import DepthNet as JaxDepthNet
from tcsfm.train.trainer import create_train_state
from tcsfm_torch.models.convert import depth_state_dict
from tcsfm_torch.models.depth import DepthNet, make_tail_apply
from tcsfm_torch.ops import _build
from tcsfm_torch.ops import decoder_tail as dt
from test_torch_bf16 import check_parity
from test_torch_decoder_tail import (_OnCard, _condition, _jax_weights,
                                     _phase_to_nchw, _port, _z)
from test_torch_models import _seeded_bn_stats

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "experiments"))
import decoder_tail as jdt  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402, F401

BF16 = torch.bfloat16
PALLAS_ATOL = 1e-5


def _bf16_z(n, hl, wl, seed):
    """A phase-form input whose values are bfloat16 numbers."""
    return np.asarray(jnp.asarray(_z(n, hl, wl, seed)).astype(jnp.bfloat16)
                      .astype(jnp.float32))


@pytest.mark.parametrize("shape,seed", [((1, 4, 8), 2), ((2, 3, 5), 6)])
def test_plain_bf16_matches_pallas_kernel_interpret(shape, seed):
    z, w = _bf16_z(*shape, seed), _jax_weights(seed + 1)
    ref = np.asarray(jdt._phase_to_space(jdt._tail_forward(
        jnp.asarray(z).astype(jnp.bfloat16), *map(jnp.asarray, w),
        interpret=True)))
    x = torch.from_numpy(_phase_to_nchw(z)).to(BF16)
    out = dt.decoder_tail_plain_bf16(x, *map(_port, w))
    f32 = dt.decoder_tail_plain(x.float(), *map(_port, w))
    assert out.dtype == torch.float32
    err = np.abs(out.numpy() - ref).max()
    f32_err = np.abs(f32.numpy() - ref).max()
    print(f"plain bf16 vs Pallas {err:.3e}, plain f32 vs Pallas {f32_err:.3e}")
    assert err <= PALLAS_ATOL < f32_err


def test_cpu_dispatch_and_backward():
    """bf16 x on the CPU: no launch, the plain bf16 tail's value, and the
    gradients of JAX's custom VJP (``jax.vjp`` of the f32 reference at the
    bf16 input), x's in bfloat16: within one bfloat16 rounding of x's
    largest gradient for x, 1e-4 of the largest for the f32 weights."""
    z, w = _bf16_z(1, 4, 6, 4), _jax_weights(5)
    x = torch.from_numpy(_phase_to_nchw(z)).to(BF16).requires_grad_(True)
    ws = [_port(a, requires_grad=True) for a in w]
    before = (dt.LAUNCHES, dt.LAUNCHES_BF16)
    out = dt.decoder_tail(x, *ws)
    assert (dt.LAUNCHES, dt.LAUNCHES_BF16) == before
    assert torch.equal(out, dt.decoder_tail_plain_bf16(x, *ws))
    g = np.random.RandomState(8).randn(*out.shape).astype(np.float32)
    out.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(jdt.decoder_tail_reference,
                     jnp.asarray(z).astype(jnp.bfloat16),
                     *map(jnp.asarray, w))
    ref = vjp(jnp.asarray(g))
    assert ref[0].dtype == jnp.bfloat16 and x.grad.dtype == BF16
    refs = [_phase_to_nchw(np.asarray(ref[0].astype(jnp.float32)))] + [
        _port(np.asarray(r)).numpy() for r in ref[1:]]
    for got, want in zip([x.grad] + [t.grad for t in ws], refs):
        scale = np.abs(want).max()
        tol = (2.0 ** -8 if got.dtype == BF16 else 1e-4) * scale
        assert np.abs(got.float().numpy() - want).max() <= tol


def test_bf16_launch_goes_to_its_entry_point(monkeypatch):
    """A CUDA-typed bf16 call goes to the bf16 entry point with the
    pointers, N, H, W, card and stream, counts one bf16 launch and no f32
    one, and returns float32."""
    calls = []

    class StandIn:
        def tcsfm_decoder_tail_bf16_fwd(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(dt._build, "load", lambda: StandIn())
    monkeypatch.setattr(dt, "_stream", lambda device: 77)
    x = torch.from_numpy(_phase_to_nchw(_z(2, 3, 4))).to(BF16).as_subclass(
        _OnCard)
    ws = [_port(a).as_subclass(_OnCard) for a in _jax_weights()]
    before = (dt.LAUNCHES, dt.LAUNCHES_BF16)
    out = dt.decoder_tail(x, *ws)
    assert (dt.LAUNCHES, dt.LAUNCHES_BF16) == (before[0], before[1] + 1)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 6, 8, 1)
    assert calls == [(x.data_ptr(), *[t.data_ptr() for t in ws],
                      out.data_ptr(), 2, 6, 8, 3, 77)]


def _fma32(a, b, c):
    """fmaf in float32: the float64 product of two float32 values is exact."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def test_bf16_kernel_elu_polynomial_matches_expm1():
    """``elu_bf16`` in csrc/decoder_tail.cu, its branch above -0.25 (its
    coefficients read from the source) in float32 steps as the card takes
    them: within 1e-7 of expm1 relative on [-0.25, 0] (every negative bf16
    there, and float32 values down to 1e-30), where exp(v) - 1 would
    cancel; v itself, bit for bit, above 0. (Below -0.25 it is the fast
    exponential less 1, as the f32 kernel's elu(); that runs only on the
    card.)"""
    src = (_build.CSRC / "decoder_tail.cu").read_text()
    c = {k: np.float32(v) for k, v in
         re.findall(r"\b(kEluC\d) = ([0-9.]+)f", src)}
    assert sorted(c) == ["kEluC2", "kEluC3", "kEluC4", "kEluC5"]
    rng = np.random.default_rng(0)
    neg = (np.arange(0x8000, 0x10000, dtype=np.uint32) << 16).view(np.float32)
    v = np.concatenate([
        neg[(neg > -0.25) & (neg < 0)], -0.25 * rng.random(200_000),
        -np.exp(rng.uniform(np.log(1e-30), np.log(0.25), 200_000)),
        np.float32([-0.25]), np.exp(rng.uniform(-30, 10, 1000)),
        np.float32([0.0])]).astype(np.float32)
    u = np.minimum(v, np.float32(0))
    q = _fma32(u, c["kEluC5"], c["kEluC4"])
    q = _fma32(q, u, c["kEluC3"])
    q = _fma32(q, u, c["kEluC2"])
    p = _fma32((q * u).astype(np.float32), u, v)
    below = v < 0
    ref = np.expm1(v[below].astype(np.float64))
    assert (np.abs(p[below] - ref) / np.abs(ref)).max() <= 1e-7
    assert np.array_equal(p[~below], v[~below])


@pytest.mark.parametrize("case", ["f16", "bf16_weights"])
def test_wrapper_rejects_other_dtypes(case):
    x = torch.from_numpy(_phase_to_nchw(_z(1, 3, 4)))
    ws = [_port(a) for a in _jax_weights()]
    if case == "f16":
        x = x.half()
    else:
        x, ws[0] = x.to(BF16), ws[0].to(BF16)
    with pytest.raises(TypeError):
        dt.decoder_tail(x, *ws)


def test_make_tail_apply_matches_jax_pallas_tail(monkeypatch):
    """A bfloat16 net's tail route: bfloat16 disparity, held against JAX's
    tail route with a bfloat16 DepthNet (trained-like conditioning)."""
    cfg = JaxConfig(compute_dtype="float32", img_resolution="low",
                    use_mxu_warp=False)
    state, _, _ = create_train_state(cfg, jax.random.PRNGKey(0),
                                     steps_per_epoch=10)
    params = _condition(jax.tree_util.tree_map(
        np.asarray, unfreeze(state.params))["depth"])
    stats = _seeded_bn_stats(jax.tree_util.tree_map(
        np.asarray, unfreeze(state.batch_stats)), np.random.RandomState(0))
    variables = {"params": params, "batch_stats": stats}
    imgs = np.random.RandomState(7).rand(2, 32, 64, 3).astype(np.float32)
    monkeypatch.setattr(jdt, "INTERPRET", True)
    ref = {d: jdt.make_tail_apply(JaxDepthNet(dtype=d), variables)(
        jnp.asarray(imgs))[0] for d in (jnp.float32, jnp.bfloat16)}
    assert ref[jnp.bfloat16].dtype == jnp.bfloat16
    out = {}
    for d in (torch.float32, BF16):
        net = DepthNet(dtype=d)
        net.load_state_dict(depth_state_dict(params, stats))
        with torch.no_grad():
            out[d] = make_tail_apply(net.eval())(torch.from_numpy(imgs))[0]
    assert out[BF16].dtype == BF16 and tuple(out[BF16].shape) == (2, 32, 64, 1)
    check_parity(ref[jnp.float32], ref[jnp.bfloat16], out[torch.float32],
                 out[BF16], 2.0, "tail route")
