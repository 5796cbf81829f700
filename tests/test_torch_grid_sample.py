"""The port's bilinear sampler against the JAX package's, on CPU.

* ``grid_sample_plain`` vs ``tcsfm.geom.warp.grid_sample`` (the XLA
  sampler), including pushed-2.0 and out-of-image coords: atol 1e-6, the
  same arithmetic in the same order in f32.
* ``grid_sample_plain`` vs the Pallas kernel ``grid_sample_mxu`` run in
  interpret mode, as tests/test_warp_mxu.py runs it, on coords inside its
  vertical band: atol 1e-5 (its hi/lo bf16 split is within ~4e-6 of f32).
* The wrapper ``grid_sample``: CPU dispatch, input checks, its gradient.
* The forward kernel's walk (``csrc/grid_sample.cu``, its constants read
  from the source) emulated in PyTorch: tiles, each warp's run of a row,
  the lanes' pixels, the vector path's 16-byte loads and stores through the
  warp's buffer and the scalar path (a row's ragged end, a misaligned run,
  other C), every output written once and bit-equal (``torch.equal``) to
  the plain versions, value and value+Jacobian.

The kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcsfm.geom.warp import grid_sample as jax_grid_sample
from tcsfm.ops.warp_mxu import grid_sample_mxu
from tcsfm_torch.ops import grid_sample as gs
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

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
def test_wrapper_is_differentiable(which):
    """The wrapper's CPU gradient (autograd through the plain twin) against
    jax.vjp of the XLA sampler: d_img atol 1e-6, d_coords 1e-5 of its
    largest magnitude (f32 sums of up to W/2 · C in another order)."""
    img_np, coords_np = _img(6), _coords("smooth")
    g = np.random.RandomState(7).randn(B, H, W, C).astype(np.float32)
    img, coords = torch.from_numpy(img_np), torch.from_numpy(coords_np)
    leaf = (img if which == "img" else coords).requires_grad_(True)
    gs.grid_sample(img, coords).backward(torch.from_numpy(g))
    _, vjp = jax.vjp(jax_grid_sample, jnp.asarray(img_np),
                     jnp.asarray(coords_np))
    ref = np.asarray(vjp(jnp.asarray(g))[0 if which == "img" else 1])
    other = coords if which == "img" else img
    assert other.grad is None
    if which == "img":
        np.testing.assert_allclose(leaf.grad.numpy(), ref, atol=1e-6, rtol=0)
    else:
        err = np.abs(leaf.grad.numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max()


def test_plain_is_differentiable():
    """The plain twin carries autograd for its direct callers."""
    img = torch.from_numpy(_img(7)).requires_grad_(True)
    coords = torch.from_numpy(_coords("smooth")).requires_grad_(True)
    gs.grid_sample_plain(img, coords).sum().backward()
    assert torch.isfinite(img.grad).all() and torch.isfinite(coords.grad).all()


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the fourth card, so that the
    wrappers take their CUDA path into a stub library."""

    @property
    def device(self):
        return torch.device("cuda", 3)


def test_launches_pass_the_tensors_card(monkeypatch):
    """Every C entry point receives the index of its tensors' card (the
    library makes that card current for its launch), so the kernels run
    on any card, not on the first one only."""
    calls = {}

    class StubLib:
        def __getattr__(self, name):
            def entry(*args):
                calls[name] = args
                return 0
            return entry

    monkeypatch.setattr(gs._build, "load", lambda: StubLib())
    monkeypatch.setattr(gs, "_stream", lambda device: 1234)
    img = torch.from_numpy(_img(8)).as_subclass(_OnCard)
    coords = torch.from_numpy(_coords("smooth")).as_subclass(_OnCard)
    g = torch.ones(B, H, W, C).as_subclass(_OnCard)
    gs.grid_sample_with_grads(img, coords)
    gs._launch_fwd(img, coords)
    gs.grid_sample_bwd(img, coords, g)
    gs.grid_sample_bwd(img, coords, g, (3,))
    assert sorted(calls) == ["tcsfm_grid_sample_bwd",
                             "tcsfm_grid_sample_bwd_coords",
                             "tcsfm_grid_sample_fwd",
                             "tcsfm_grid_sample_fwd_grads"]
    for name, args in calls.items():
        assert args[-2:] == (3, 1234), (name, args[-2:])


def _kernel_constants() -> dict:
    """The walk's integer constants in csrc/grid_sample.cu, by name."""
    src = (gs._build.CSRC / "grid_sample.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def _floats4(f4: torch.Tensor) -> torch.Tensor:
    """The float indices of the float4s ``f4``, lane by lane."""
    return (4 * f4[:, None] + torch.arange(4)).reshape(-1)


def _lane_float4s(n4: int) -> list:
    """The float4s of ``n4`` that the lanes move in one instruction after
    another: lane l the (32 j + l)-th."""
    lanes = torch.arange(32)
    return [i[i < n4] for i in (32 * j + lanes for j in range(-(-n4 // 32)))]


def _emulate_kernel(img, coords, grads, coords_offset=0):
    """The forward kernel's walk in plain PyTorch. A block of kWarps warps
    takes a tile of kWarps rows by kRun pixels, a warp the run of kRun
    pixels of one row; in a run, lane l samples pixels l + 32 k. A full
    run whose coords (after ``coords_offset`` floats of storage) and planes
    fall on 16 bytes, at C in {1, 3, 4}, takes the vector path: lane l
    loads the run's float4s of coords 32 j + l, pixel 32 k + l's coords
    come by shuffle from the lane holding float4 16 k + l / 2, and each
    plane goes out through the warp's buffer, the lanes taking its float4s
    in turn (C = 4: a float4 a pixel, straight); any other run takes the
    scalar path. Each lane's pixel is sampled at the coords it got with
    the plain versions' arithmetic. Returns the planes (out, or out, gx,
    gy) and the number of runs on the vector path; asserts that every
    output float is written once."""
    k = _kernel_constants()
    warps, run = k["kWarps"], 32 * k["kLanePixels"]
    b, h, w, c = img.shape
    lanes = torch.arange(32)
    slots = [32 * j + lanes for j in range(k["kLanePixels"])]
    cflat = torch.cat([torch.zeros(coords_offset), coords.reshape(-1)])
    read = torch.full((b * h * w, 2), float("nan"))
    runs = []
    for bz, by, bx, warp in np.ndindex(b, math.ceil(h / warps),
                                       math.ceil(w / run), warps):
        row, x0 = by * warps + warp, bx * run
        if row >= h or x0 >= w:
            continue
        n = min(run, w - x0)
        px0 = (bz * h + row) * w + x0
        c0 = coords_offset + 2 * px0        # the run's coords in cflat
        vec = (c in (1, 3, 4) and n == run and c0 % 4 == 0
               and px0 * c % 4 == 0)
        if vec:
            # c4[j][l]: the float4 that lane l loads j-th
            c4 = [cflat[c0 + _floats4(32 * j + lanes)].view(32, 4)
                  for j in range(k["kLanePixels"] // 2)]
            for j, p in enumerate(slots):
                src = (16 * j + lanes // 2) % 32
                q = c4[j // 2][src]
                read[px0 + p] = torch.where((lanes % 2 == 1)[:, None],
                                            q[:, 2:], q[:, :2])
        else:
            for p in slots:
                p = p[p < n]
                read[px0 + p, 0] = cflat[c0 + 2 * p]
                read[px0 + p, 1] = cflat[c0 + 2 * p + 1]
        runs.append((px0, n, vec))
    read = read.reshape(b, h, w, 2)
    planes = (gs.grid_sample_with_grads_plain(img, read) if grads
              else (gs.grid_sample_plain(img, read),))
    chans = torch.arange(c)
    outs = []
    for plane in planes:
        vals = plane.reshape(-1, c)         # by the lane slot's pixel
        out = torch.full((b * h * w * c,), float("nan"))
        writes = torch.zeros(b * h * w * c, dtype=torch.int64)
        for px0, n, vec in runs:
            if vec and c == 4:
                for p in slots:
                    f = _floats4(px0 + p)
                    out[f] = vals[px0 + p].reshape(-1)
                    writes[f] += 1
            elif vec:
                buf = torch.full((run * c,), float("nan"))
                for p in slots:
                    buf[(p[:, None] * c + chans).reshape(-1)] = vals[
                        px0 + p].reshape(-1)
                for f4 in _lane_float4s(run * c // 4):
                    f = _floats4(px0 * c // 4 + f4)
                    out[f] = buf[_floats4(f4)]
                    writes[f] += 1
            else:
                for p in slots:
                    p = p[p < n]
                    f = ((px0 + p)[:, None] * c + chans).reshape(-1)
                    out[f] = vals[px0 + p].reshape(-1)
                    writes[f] += 1
        assert bool((writes == 1).all())
        outs.append(out.reshape(b, h, w, c))
    return outs, sum(vec for *_, vec in runs)


def _walk_coords(h, w, seed):
    """Near-identity coords with 5% pushed to 2.0 and 5% far outside."""
    rng = np.random.RandomState(seed)
    c = _identity_coords(2, h, w) + rng.uniform(-3, 3, (2, h, w, 2)) * [
        2.0 / w, 2.0 / h]
    u = rng.rand(2, h, w)
    c[u < 0.05] = 2.0
    c[(u >= 0.05) & (u < 0.1)] *= 40.0
    return c.astype(np.float32)


@pytest.mark.parametrize("coords_offset", [0, 1])
@pytest.mark.parametrize("c", [1, 3, 4, 7])
@pytest.mark.parametrize("w", [61, 62, 63, 64, 253, 254, 255, 256])
def test_kernel_walk_is_bit_equal_to_plain(w, c, coords_offset):
    """H = 11 (not a multiple of a tile's rows), B = 2; runs of a row that
    end ragged, rows whose runs fall on 16 bytes or not (odd W, a coords
    tensor one float into its storage), C with and without a vector
    path."""
    h = 11
    img = torch.from_numpy(_img(9 + c, c, 2, h, w))
    coords = torch.from_numpy(_walk_coords(h, w, seed=w + c))
    (out,), vec_runs = _emulate_kernel(img, coords, False, coords_offset)
    assert torch.equal(out, gs.grid_sample_plain(img, coords))
    planes, _ = _emulate_kernel(img, coords, True, coords_offset)
    for ours, ref in zip(planes, gs.grid_sample_with_grads_plain(img, coords)):
        assert torch.equal(ours, ref)
    run = 32 * _kernel_constants()["kLanePixels"]
    assert (vec_runs > 0) == (w >= run and c in (1, 3, 4)
                              and coords_offset % 2 == 0)
