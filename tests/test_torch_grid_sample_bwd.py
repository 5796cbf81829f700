"""The port's sampler gradient against autodiff and the JAX package's, on CPU.

* ``grid_sample_bwd_plain`` (the CUDA backward kernels' plain twin) vs
  ``torch.autograd`` through ``grid_sample_plain``: d_coords within 1e-6 of
  its largest magnitude (the same f32 terms, summed in another order; the
  magnitude reaches W/2 · C), d_img within 1e-6.
* the same vs ``jax.vjp`` of ``tcsfm.geom.warp.grid_sample`` (the XLA
  sampler): 1e-5 of the largest magnitude, and 1e-5 for d_img.
* vs the Pallas backward ``grid_sample_mxu_diff(..., interpret=True,
  grad_ch=...)`` on in-band, off-integer coords, at the atol 2e-2 / rtol
  3e-2 of tests/test_warp_mxu_grad.py (its taps run hi/lo bf16).
* the integer-y convention: the port follows autodiff of the XLA sampler
  there, where the Pallas tent derivative gives 0.

Coordinates cover pushed 2.0 (gradient exactly 0), the borders and
off-integer positions; ``grad_ch`` in (), (3,) and (0, 1, 2, 3).
The kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcsfm.geom.warp import grid_sample as jax_grid_sample
from tcsfm.ops.warp_mxu import grid_sample_mxu_diff
from tcsfm_torch.ops import grid_sample as gs
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, H, W, C = 2, 32, 64, 4
GRAD_CH = [(), (3,), (0, 1, 2, 3)]


def _identity_coords(b=B, h=H, w=W):
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    g = np.stack([(2 * xs + 1) / w - 1, (2 * ys + 1) / h - 1], -1)
    return np.broadcast_to(g, (b, h, w, 2)).astype(np.float64).copy()


def _coords(case, seed=0):
    """Off-integer pixel positions (fractional parts in [0.1, 0.9]) unless
    the case is about the borders or the push."""
    rng = np.random.RandomState(seed)
    c = _identity_coords()
    frac = rng.uniform(0.1, 0.9, (B, H, W, 2)) - 0.5
    c += frac * [2.0 / W, 2.0 / H]
    if case == "in_band":         # small vertical motion, as a real warp
        c += rng.randint(-3, 4, (B, H, W, 2)) * [2.0 / W, 2.0 / H] * [1, 0.3]
    elif case == "wide":          # shifts of up to 5 px, many taps outside
        c += rng.randint(-5, 6, (B, H, W, 2)) * [2.0 / W, 2.0 / H]
    elif case == "pushed":        # the stn.py OOB rule: pushed to 2.0
        push = rng.rand(B, H, W) < 0.2
        c[push & (rng.rand(B, H, W) < 0.5), 0] = 2.0
        c[push, 1] = np.where(c[push, 0] == 2.0, c[push, 1], 2.0)
    elif case == "border":        # taps straddling each border
        c[:, :, 0, 0] = -1.0 - 0.4 / W
        c[:, :, -1, 0] = 1.0 + 0.4 / W
        c[:, 0, :, 1] = -1.0 - 0.4 / H
        c[:, -1, :, 1] = 1.0 + 0.4 / H
    return c.astype(np.float32)


def _inputs(case, seed=0):
    rng = np.random.RandomState(seed + 10)
    img = rng.rand(B, H, W, C).astype(np.float32)
    g = rng.randn(B, H, W, C).astype(np.float32)
    return img, _coords(case, seed), g


def _close_rel(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(b).max()
    assert scale > 0
    err = np.abs(a - b).max()
    assert err <= rel * scale, f"max abs err {err} > {rel} x {scale}"


def _plain(img, coords, g, grad_ch):
    d_coords, d_img = gs.grid_sample_bwd_plain(
        torch.from_numpy(img), torch.from_numpy(coords), torch.from_numpy(g),
        grad_ch)
    return d_coords.numpy(), None if d_img is None else d_img.numpy()


CASES = ["in_band", "wide", "pushed", "border"]


@pytest.mark.parametrize("grad_ch", GRAD_CH)
@pytest.mark.parametrize("case", CASES)
def test_plain_bwd_matches_torch_autograd(case, grad_ch):
    img, coords, g = _inputs(case)
    ti = torch.from_numpy(img).requires_grad_(True)
    tc = torch.from_numpy(coords).requires_grad_(True)
    gs.grid_sample_plain(ti, tc).backward(torch.from_numpy(g))
    d_coords, d_img = _plain(img, coords, g, grad_ch)
    _close_rel(d_coords, tc.grad.numpy(), 1e-6)
    if grad_ch:
        np.testing.assert_allclose(d_img, ti.grad.numpy()[..., list(grad_ch)],
                                   atol=1e-6, rtol=0)
    else:
        assert d_img is None


@pytest.mark.parametrize("grad_ch", GRAD_CH)
@pytest.mark.parametrize("case", CASES)
def test_plain_bwd_matches_jax_vjp(case, grad_ch):
    img, coords, g = _inputs(case, seed=1)
    _, vjp = jax.vjp(jax_grid_sample, jnp.asarray(img), jnp.asarray(coords))
    ref_img, ref_coords = vjp(jnp.asarray(g))
    d_coords, d_img = _plain(img, coords, g, grad_ch)
    _close_rel(d_coords, ref_coords, 1e-5)
    if grad_ch:
        np.testing.assert_allclose(
            d_img, np.asarray(ref_img)[..., list(grad_ch)], atol=1e-5, rtol=0)
    if case == "pushed":
        pushed = (coords == 2.0).any(-1)
        assert pushed.any() and np.all(d_coords[pushed] == 0.0)


@pytest.mark.parametrize("grad_ch", GRAD_CH)
def test_plain_bwd_matches_pallas_interpret(grad_ch):
    img, coords, g = _inputs("in_band", seed=2)

    def f(im, c):
        return grid_sample_mxu_diff(im, c, 16, True, True, (), grad_ch)

    _, vjp = jax.vjp(f, jnp.asarray(img), jnp.asarray(coords))
    ref_img, ref_coords = vjp(jnp.asarray(g))
    d_coords, d_img = _plain(img, coords, g, grad_ch)
    np.testing.assert_allclose(d_coords, np.asarray(ref_coords), atol=2e-2,
                               rtol=3e-2)
    if grad_ch:
        np.testing.assert_allclose(
            d_img, np.asarray(ref_img)[..., list(grad_ch)], atol=2e-2,
            rtol=3e-2)


def test_integer_y_follows_autodiff():
    """At an exactly integer source row the port gives the one-sided
    difference v(y+1) - v(y) of autodiff, as JAX's autodiff of the XLA
    sampler does; the Pallas tent derivative -sign(y - row) gives 0."""
    img, _, g = _inputs("in_band", seed=3)
    coords = _identity_coords().astype(np.float32)   # integer x and y
    coords[..., 0] += 0.3 * 2.0 / W                  # x off-integer
    _, vjp = jax.vjp(jax_grid_sample, jnp.asarray(img), jnp.asarray(coords))
    ref = np.asarray(vjp(jnp.asarray(g))[1])
    d_coords, _ = _plain(img, coords, g, ())
    _close_rel(d_coords, ref, 1e-5)
    assert np.abs(d_coords[:, :-1, :, 1]).min() > 0   # rows inside: not 0

    def f(c):
        return grid_sample_mxu_diff(jnp.asarray(img), c, 16, True, True, (), ())

    _, vjp_p = jax.vjp(f, jnp.asarray(coords))
    pallas_dy = np.asarray(vjp_p(jnp.asarray(g))[0])[..., 1]
    assert np.abs(pallas_dy).max() < 1e-3 * np.abs(d_coords[..., 1]).max()


@pytest.mark.parametrize("grad_ch", [(), (1, 3), (0, 1, 2, 3)])
def test_wrapper_bwd_on_cpu_is_plain(grad_ch):
    img, coords, g = (torch.from_numpy(a) for a in _inputs("wide", seed=4))
    before = (gs.LAUNCHES_BWD_COORDS, gs.LAUNCHES_BWD_IMG)
    out = gs.grid_sample_bwd(img, coords, g, grad_ch)
    ref = gs.grid_sample_bwd_plain(img, coords, g, grad_ch)
    assert torch.equal(out[0], ref[0])
    assert (out[1] is None) == (ref[1] is None)
    if grad_ch:
        assert torch.equal(out[1], ref[1])
    # the CPU path launches no kernel
    assert (gs.LAUNCHES_BWD_COORDS, gs.LAUNCHES_BWD_IMG) == before


@pytest.mark.parametrize("grad_ch", [(3, 1), (1, 1), (4,), (-1,)])
def test_wrapper_bwd_rejects_bad_grad_ch(grad_ch):
    img, coords, g = (torch.from_numpy(a) for a in _inputs("in_band"))
    with pytest.raises(ValueError):
        gs.grid_sample_bwd(img, coords, g, grad_ch)


def test_tail_is_sampled_after_the_image():
    """grid_sample(img, coords, tail) samples cat([img, tail]); only the
    parts that require a gradient get one."""
    img, coords, g = _inputs("wide", seed=5)
    rgb = torch.from_numpy(img[..., :3].copy())
    depth = torch.from_numpy(img[..., 3:].copy()).requires_grad_(True)
    tc = torch.from_numpy(coords).requires_grad_(True)
    out = gs.grid_sample(rgb, tc, depth)
    assert torch.equal(out.detach(), gs.grid_sample_plain(
        torch.from_numpy(img), torch.from_numpy(coords)))
    out.backward(torch.from_numpy(g))
    d_coords, d_img = _plain(img, coords, g, (3,))
    _close_rel(tc.grad.numpy(), d_coords, 1e-6)
    np.testing.assert_allclose(depth.grad.numpy(), d_img, atol=1e-6, rtol=0)
    assert rgb.grad is None


@pytest.mark.parametrize("needs", ["coords", "tail", "img+tail", "all"])
def test_autograd_function_routing(monkeypatch, needs):
    """The CUDA path's autograd Function, run on CPU tensors with its
    forward launch swapped for the plain forward (its backward's
    ``grid_sample_bwd`` takes CPU tensors to the plain backward): each input
    gets the gradient autograd of the plain sampler gives it, or None."""
    monkeypatch.setattr(gs, "_launch_fwd", gs.grid_sample_plain)
    img, coords, g = _inputs("wide", seed=7)

    def leaves():
        rgb = torch.from_numpy(img[..., :3].copy())
        depth = torch.from_numpy(img[..., 3:].copy())
        tc = torch.from_numpy(coords)
        for t, on in ((rgb, "img" in needs or needs == "all"),
                      (depth, "tail" in needs or needs == "all"),
                      (tc, needs in ("coords", "all"))):
            t.requires_grad_(on)
        return rgb, tc, depth

    ours, ref = leaves(), leaves()
    gs._GridSample.apply(*ours).backward(torch.from_numpy(g))
    gs.grid_sample_plain(*ref).backward(torch.from_numpy(g))
    for a, b in zip(ours, ref):
        assert (a.grad is None) == (b.grad is None)
        if b.grad is not None:
            _close_rel(a.grad.numpy(), b.grad.numpy(), 1e-6)
