"""The port's value+Jacobian sampler and the sampler's forward mode, on CPU.

* ``grid_sample_with_grads_plain`` (the with-grads kernel's plain twin) vs
  ``torch.func.jvp`` of ``grid_sample_plain`` on the basis tangents of
  each coordinate: 1e-6 of the largest magnitude (the same f32 terms in
  another order; the magnitude reaches W/2 over a pixel step).
* the same vs ``jax.jvp`` of ``tcsfm.geom.warp.grid_sample`` (the XLA
  sampler): 1e-5 of the largest magnitude.
* vs the Pallas kernel ``grid_sample_mxu_with_grads(interpret=True)`` on
  in-band, off-integer coords: 2e-5 of the largest magnitude (its taps run
  hi/lo bf16; measured 6.7e-6).
* the integer-y convention: the port follows autodiff there, where the
  Pallas tent derivative gives 0.
* at smooth main-path-like coords (a small depth and pose through the
  port's ``inverse_warp2``, 64x96): ``grid_sample_plain`` vs the XLA
  sampler (atol 1e-6) and ``grid_sample_with_grads_plain`` vs its
  ``jax.jvp`` (1e-5 of the largest magnitude).
* ``_GridSample`` and ``grid_sample_fwd_diff``'s Function with their
  launches replaced by the plain twins: ``torch.func.jvp``,
  ``torch.autograd.forward_ad``, ``torch.func.vmap`` and ``torch.func.grad``
  (and vmap over jvp and over grad) agree with the plain sampler at 1e-6
  of the largest magnitude, and launch what the card would launch. The
  stand-in launches read their tensors' data pointers, as the real ones
  do: a ``torch.func`` wrapper has none.

The kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from tcsfm.geom.warp import grid_sample as jax_grid_sample
from tcsfm.ops.warp_mxu import grid_sample_mxu_with_grads
from tcsfm_torch.geom.warp import inverse_warp2
from tcsfm_torch.ops import grid_sample as gs

from test_torch_grid_sample_bwd import (B, H, W, _close_rel, _coords,
                                        _identity_coords)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

C = 3
CASES = ["in_band", "wide", "pushed", "border"]


def _img(seed, c=C):
    return np.random.RandomState(seed + 10).rand(B, H, W, c).astype(np.float32)


def _plain_with_grads(img, coords):
    return [t.numpy() for t in gs.grid_sample_with_grads_plain(
        torch.from_numpy(img), torch.from_numpy(coords))]


def _basis(axis):
    t = np.zeros((B, H, W, 2), np.float32)
    t[..., axis] = 1.0
    return t


@pytest.mark.parametrize("case", CASES)
def test_with_grads_plain_matches_torch_jvp(case):
    img, coords = _img(0), _coords(case)
    out, gx, gy = _plain_with_grads(img, coords)
    for axis, ours in ((0, gx), (1, gy)):
        val, ref = torch.func.jvp(
            lambda c: gs.grid_sample_plain(torch.from_numpy(img), c),
            (torch.from_numpy(coords),), (torch.from_numpy(_basis(axis)),))
        assert np.array_equal(out, val.numpy())
        _close_rel(ours, ref.numpy(), 1e-6)
    if case == "pushed":
        pushed = (coords == 2.0).any(-1)
        assert (out[pushed] == 0).all() and (gx[pushed] == 0).all() \
            and (gy[pushed] == 0).all()


@pytest.mark.parametrize("case", CASES)
def test_with_grads_plain_matches_jax_jvp(case):
    img, coords = _img(1), _coords(case, seed=1)
    out, gx, gy = _plain_with_grads(img, coords)
    for axis, ours in ((0, gx), (1, gy)):
        val, ref = jax.jvp(lambda c: jax_grid_sample(jnp.asarray(img), c),
                           (jnp.asarray(coords),),
                           (jnp.asarray(_basis(axis)),))
        np.testing.assert_allclose(out, np.asarray(val), atol=1e-6, rtol=0)
        _close_rel(ours, np.asarray(ref), 1e-5)


def test_with_grads_plain_matches_pallas_interpret():
    img, coords = _img(2), _coords("in_band", seed=2)
    ref = grid_sample_mxu_with_grads(jnp.asarray(img), jnp.asarray(coords),
                                     band=16, interpret=True)
    for ours, theirs in zip(_plain_with_grads(img, coords), ref):
        _close_rel(ours, np.asarray(theirs), 2e-5)


def test_integer_y_follows_autodiff():
    """At an exactly integer source row the port's gy is the one-sided
    difference v(y+1) - v(y) (times H/2) of autodiff, as JAX's jvp of the
    XLA sampler gives; the Pallas tent derivative gives 0 there."""
    img = _img(3)
    coords = _identity_coords().astype(np.float32)   # integer x and y
    coords[..., 0] += 0.3 * 2.0 / W                  # x off-integer
    _, _, gy = _plain_with_grads(img, coords)
    _, ref = jax.jvp(lambda c: jax_grid_sample(jnp.asarray(img), c),
                     (jnp.asarray(coords),), (jnp.asarray(_basis(1)),))
    _close_rel(gy, np.asarray(ref), 1e-5)
    row = 0.7 * img[:, 1:, :-1] + 0.3 * img[:, 1:, 1:] - (
        0.7 * img[:, :-1, :-1] + 0.3 * img[:, :-1, 1:])
    _close_rel(gy[:, :-1, :-1], row * (H / 2), 1e-5)
    pallas_gy = np.asarray(grid_sample_mxu_with_grads(
        jnp.asarray(img), jnp.asarray(coords), band=16, interpret=True)[2])
    assert np.abs(pallas_gy).max() < 1e-3 * np.abs(gy).max()


def _warp_coords(h=64, w=96, b=2, seed=11):
    """The coords that the port's ``inverse_warp2`` hands its sampler for a
    smooth depth (2-6 m, a tilted plane with a bump) and small poses, with
    KITTI-like intrinsics; and the image it samples."""
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    depth = 2.0 + 3.0 * ys + 0.5 * np.sin(6 * xs) * np.cos(4 * ys)
    depth = np.broadcast_to(depth[None, ..., None], (b, h, w, 1))
    pose = np.concatenate([rng.uniform(-0.05, 0.05, (b, 3)),
                           rng.uniform(-0.01, 0.01, (b, 3))], -1)
    K = np.broadcast_to(np.array([[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2.5],
                                  [0, 0, 1]]), (b, 3, 3))
    img = rng.rand(b, h, w, C).astype(np.float32)
    seen = []

    def recording(im, coords):
        seen.append(coords)
        return gs.grid_sample_plain(im, coords)

    inverse_warp2(*(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                    for a in (img, depth, depth, pose, K)),
                  sample_depth=False, sampler=recording)
    return img, seen[0].numpy()


def test_plain_at_main_path_like_coords_matches_jax():
    img, coords = _warp_coords()
    inside = (np.abs(coords) <= 1.0).all(-1)
    assert 0.5 < inside.mean() < 1.0          # mostly in view, some pushed
    out, gx, gy = _plain_with_grads(img, coords)
    assert np.array_equal(out, gs.grid_sample_plain(
        torch.from_numpy(img), torch.from_numpy(coords)).numpy())
    ref = jax_grid_sample(jnp.asarray(img), jnp.asarray(coords))
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-6, rtol=0)
    b, h, w, _ = coords.shape
    for axis, ours in ((0, gx), (1, gy)):
        t = np.zeros((b, h, w, 2), np.float32)
        t[..., axis] = 1.0
        _, tan = jax.jvp(lambda c: jax_grid_sample(jnp.asarray(img), c),
                         (jnp.asarray(coords),), (jnp.asarray(t),))
        _close_rel(ours, np.asarray(tan), 1e-5)


def test_with_grads_wrapper_runs_plain_on_cpu():
    img, coords = torch.from_numpy(_img(4)), torch.from_numpy(_coords("wide"))
    before = (gs.LAUNCHES, gs.LAUNCHES_FWD_GRADS)
    for a, b in zip(gs.grid_sample_with_grads(img, coords),
                    gs.grid_sample_with_grads_plain(img, coords)):
        assert torch.equal(a, b)
    for fn in (gs.grid_sample_fwd_diff, gs.grid_sample_fwd_diff_plain):
        assert torch.equal(fn(img, coords), gs.grid_sample_plain(img, coords))
    assert (gs.LAUNCHES, gs.LAUNCHES_FWD_GRADS) == before
    assert gs.fwd_diff_of(gs.grid_sample) is gs.grid_sample_fwd_diff
    assert gs.fwd_diff_of(gs.grid_sample_plain) is \
        gs.grid_sample_fwd_diff_plain
    with pytest.raises(TypeError):
        gs.grid_sample_with_grads(img.double(), coords)


# -- the autograd Functions, their launches replaced by the plain twins --


@pytest.fixture
def launches(monkeypatch):
    """Route the kernel launches to the plain twins and count them. Like a
    launch, each reads its tensors' data pointers, which a ``torch.func``
    wrapper does not have."""
    seen = {"value": 0, "grads": 0, "bwd": 0}

    def fwd(img, coords):
        img.data_ptr(), coords.data_ptr()
        seen["value"] += 1
        return gs.grid_sample_plain(img, coords)

    def fwd_grads(img, coords):
        img.data_ptr(), coords.data_ptr()
        seen["grads"] += 1
        return gs.grid_sample_with_grads_plain(img, coords)

    def bwd(img, coords, g, grad_ch=()):
        img.data_ptr(), coords.data_ptr(), g.data_ptr()
        seen["bwd"] += 1
        return gs.grid_sample_bwd_plain(img, coords, g, grad_ch)

    monkeypatch.setattr(gs, "_launch_fwd", fwd)
    monkeypatch.setattr(gs, "_launch_fwd_grads", fwd_grads)
    monkeypatch.setattr(gs, "grid_sample_bwd", bwd)
    return seen


def _sampler(name):
    if name == "_GridSample":
        return lambda img, coords: gs._GridSample.apply(img, coords, None)
    return lambda img, coords: gs._GridSampleFwdDiff.apply(img, coords,
                                                           False)[0]


def _transform_inputs(seed):
    rng = np.random.RandomState(seed)
    img = torch.from_numpy(_img(seed))
    coords = torch.from_numpy(_coords("wide", seed))
    t_img = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32))
    t_coords = torch.from_numpy(rng.randn(B, H, W, 2).astype(np.float32))
    return img, coords, t_img, t_coords


# launches (value, with-grads) of one jvp with a coords tangent: the
# forward kernel plus the with-grads kernel for _GridSample, the
# with-grads kernel alone for grid_sample_fwd_diff
JVP_LAUNCHES = {"_GridSample": (1, 1), "fwd_diff": (0, 1)}


@pytest.mark.parametrize("name", ["_GridSample", "fwd_diff"])
@pytest.mark.parametrize("transform", ["jvp", "forward_ad", "vmap", "grad"])
def test_function_under_transform(launches, name, transform):
    f, plain = _sampler(name), gs.grid_sample_plain
    img, coords, t_img, t_coords = _transform_inputs(5)
    if transform == "jvp":
        out, tan = torch.func.jvp(lambda c: f(img, c), (coords,), (t_coords,))
        assert (launches["value"], launches["grads"]) == JVP_LAUNCHES[name]
        ref_out, ref = torch.func.jvp(lambda c: plain(img, c), (coords,),
                                      (t_coords,))
        assert torch.equal(out, ref_out)
        _close_rel(tan, ref, 1e-6)
        # an image tangent too: sampled by the value kernel
        _, tan = torch.func.jvp(f, (img, coords), (t_img, t_coords))
        _, ref = torch.func.jvp(plain, (img, coords), (t_img, t_coords))
        _close_rel(tan, ref, 1e-6)
    elif transform == "forward_ad":
        with fwAD.dual_level():
            out = f(img, fwAD.make_dual(coords, t_coords))
            tan = fwAD.unpack_dual(out).tangent
        assert (launches["value"], launches["grads"]) == JVP_LAUNCHES[name]
        _, ref = torch.func.jvp(lambda c: plain(img, c), (coords,),
                                (t_coords,))
        _close_rel(tan, ref, 1e-6)
    elif transform == "vmap":
        imgs = img[None].expand(3, -1, -1, -1, -1) * torch.tensor(
            [1.0, 0.5, 2.0])[:, None, None, None, None]
        many = coords[None] + 0.01 * t_coords[None] * torch.arange(3.0)[
            :, None, None, None, None]
        out = torch.func.vmap(f)(imgs, many)
        assert torch.equal(out, torch.func.vmap(plain)(imgs, many))
        out = torch.func.vmap(f, in_dims=(None, 0))(img, many)
        assert torch.equal(out, torch.func.vmap(plain, in_dims=(None, 0))(
            img, many))
        assert sum(launches.values()) == 2     # one folded launch each
        # vmap of jvp: one folded launch of each kernel the jvp needs
        before = dict(launches)
        tans = torch.func.vmap(lambda c, t: torch.func.jvp(
            lambda x: f(img, x), (c,), (t,))[1])(many, many)
        refs = torch.func.vmap(lambda c, t: torch.func.jvp(
            lambda x: plain(img, x), (c,), (t,))[1])(many, many)
        _close_rel(tans, refs, 1e-6)
        assert (launches["value"] - before["value"],
                launches["grads"] - before["grads"]) == JVP_LAUNCHES[name]
    else:
        grads = torch.func.grad(lambda i, c: (f(i, c) * t_img).sum(),
                                argnums=(0, 1))(img, coords)
        refs = torch.func.grad(lambda i, c: (plain(i, c) * t_img).sum(),
                               argnums=(0, 1))(img, coords)
        for g, r in zip(grads, refs):
            _close_rel(g, r, 1e-6)
        assert launches["bwd"] == 1
        # per-sample gradients: vmap of grad
        many = coords[None] + 0.01 * t_coords[None] * torch.arange(2.0)[
            :, None, None, None, None]
        per = torch.func.vmap(torch.func.grad(
            lambda c: (f(img, c) * t_img).sum()))(many)
        ref = torch.func.vmap(torch.func.grad(
            lambda c: (plain(img, c) * t_img).sum()))(many)
        _close_rel(per, ref, 1e-6)


def test_grid_sample_jvp_with_tail(launches):
    """A tangent on the sampled tail alone (the training warp's
    differentiable source depth): one value launch of the tangents."""
    img, coords, _, t_coords = _transform_inputs(6)
    tail = img[..., :1].contiguous() * 3.0
    t_tail = torch.ones_like(tail)
    tan = torch.func.jvp(
        lambda c, tl: gs._GridSample.apply(img, c, tl), (coords, tail),
        (t_coords, t_tail))[1]
    ref = torch.func.jvp(
        lambda c, tl: gs.grid_sample_plain(img, c, tl), (coords, tail),
        (t_coords, t_tail))[1]
    _close_rel(tan, ref, 1e-6)
    assert (launches["value"], launches["grads"]) == (2, 1)
