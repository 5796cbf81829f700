"""The port's bilinear sampler against the JAX package's, on CPU.

* ``grid_sample_plain`` vs ``tcsfm.geom.warp.grid_sample`` (the XLA
  sampler), including pushed-2.0 and out-of-image coords: atol 1e-6, the
  same arithmetic in the same order in f32.
* ``grid_sample_plain`` vs the Pallas kernel ``grid_sample_mxu`` run in
  interpret mode, as tests/test_warp_mxu.py runs it, on coords inside its
  vertical band: atol 1e-5 (its hi/lo bf16 split is within ~4e-6 of f32).
* The wrapper ``grid_sample``: CPU dispatch, input checks, the no-grad rule.

The kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcsfm.geom.warp import grid_sample as jax_grid_sample
from tcsfm.ops.warp_mxu import grid_sample_mxu
from tcsfm_torch.ops import grid_sample as gs

B, H, W, C = 2, 32, 64, 4


def _identity_coords(b=B, h=H, w=W):
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    g = np.stack([(2 * xs + 1) / w - 1, (2 * ys + 1) / h - 1], -1)
    return np.broadcast_to(g, (b, h, w, 2)).astype(np.float32).copy()


def _img(seed, c=C, b=B, h=H, w=W):
    return np.random.RandomState(seed).rand(b, h, w, c).astype(np.float32)


def _coords(case, seed=0):
    rng = np.random.RandomState(seed)
    c = _identity_coords()
    if case == "identity":
        return c
    if case == "smooth":
        return (c + 0.02 * rng.randn(B, H, W, 2) * [1.0, 0.3]).astype(np.float32)
    if case == "pushed":            # the stn.py OOB rule: pushed to 2.0
        c[:, :4] = 2.0
        c[:, :, :3] = 2.0
        return c
    if case == "edge":              # taps half outside each border
        c[..., 0] += 1.2 / W
        c[..., 1] -= 1.2 / H
        return c
    if case == "wide":              # anywhere in [-1.5, 1.5]^2
        return rng.uniform(-1.5, 1.5, (B, H, W, 2)).astype(np.float32)
    if case == "far":               # far outside, as a Z-clamped projection
        return (rng.choice([-1, 1], (B, H, W, 2))
                * rng.uniform(1.0, 1e4, (B, H, W, 2))).astype(np.float32)
    raise ValueError(case)


CASES = ["identity", "smooth", "pushed", "edge", "wide", "far"]


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_xla_sampler(case, channels):
    img, coords = _img(1, channels), _coords(case)
    port = gs.grid_sample_plain(torch.from_numpy(img), torch.from_numpy(coords))
    ref = jax_grid_sample(jnp.asarray(img), jnp.asarray(coords))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["identity", "smooth", "pushed", "edge"])
def test_plain_matches_pallas_kernel_interpret(case):
    img, coords = _img(2), _coords(case)
    port = gs.grid_sample_plain(torch.from_numpy(img), torch.from_numpy(coords))
    ref = grid_sample_mxu(jnp.asarray(img), jnp.asarray(coords), band=16,
                          interpret=True)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_pushed_coords_sample_exact_zero():
    img, coords = _img(3), _coords("pushed")
    out = gs.grid_sample(torch.from_numpy(img), torch.from_numpy(coords))
    assert torch.all(out[:, :4] == 0) and torch.all(out[:, :, :3] == 0)


def test_wrapper_dispatches_cpu_to_plain():
    img, coords = torch.from_numpy(_img(4)), torch.from_numpy(_coords("wide"))
    before = gs.LAUNCHES
    assert torch.equal(gs.grid_sample(img, coords),
                       gs.grid_sample_plain(img, coords))
    assert gs.LAUNCHES == before          # the CPU path launches no kernel


def _bad_inputs():
    img, coords = torch.from_numpy(_img(5)), torch.from_numpy(_coords("smooth"))
    return {
        "f64_img": (TypeError, img.double(), coords),
        "f16_coords": (TypeError, img, coords.half()),
        "3d_img": (ValueError, img[0], coords),
        "coords_last_dim": (ValueError, img, coords[..., :1].contiguous()),
        "coords_shape": (ValueError, img, coords[:, :-1].contiguous()),
        "non_contiguous": (ValueError, img.transpose(1, 2), coords.transpose(1, 2)),
        "meta_device": (ValueError, img.to("meta"), coords.to("meta")),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_wrapper_rejects_bad_inputs(case):
    exc, img, coords = _bad_inputs()[case]
    with pytest.raises(exc):
        gs.grid_sample(img, coords)


@pytest.mark.parametrize("which", ["img", "coords"])
def test_wrapper_is_forward_only(which):
    img, coords = torch.from_numpy(_img(6)), torch.from_numpy(_coords("smooth"))
    (img if which == "img" else coords).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        gs.grid_sample(img, coords)
    with torch.no_grad():
        out = gs.grid_sample(img, coords)
    assert out.shape == img.shape


def test_plain_is_differentiable():
    """The plain twin carries autograd for its direct callers."""
    img = torch.from_numpy(_img(7)).requires_grad_(True)
    coords = torch.from_numpy(_coords("smooth")).requires_grad_(True)
    gs.grid_sample_plain(img, coords).sum().backward()
    assert torch.isfinite(img.grad).all() and torch.isfinite(coords.grad).all()
