"""The port's Farneback flow (``tcsfm_torch.ops.flow``) against the JAX
package's (``tcsfm.ops.flow``), on the CPU.

Inputs: ``tests/test_flow.py``'s smooth texture at 128x192 and its copy
shifted by (+1.5, -1.0) px (so the pyramid runs all 3 extra levels), and
an RGB pair made of them. The JAX side compiles once for the module
(``jax_run``: the jitted ``batched_flow_pair`` of the RGB pair, whose two
directions also hold ``farneback_flow`` on its grey pair); its expansion,
update step and level resizes run eagerly on the texture pair.

Each value is held on the interior and, apart, inside the 5-pixel border
ramp (``BORDER``). Tolerances, each with what was measured here:

* ``poly_expansion``, the update step (``_update_matrices``,
  ``_box_blur``, ``_solve_flow``) and ``rgb_to_gray``: the same f32
  operations in the same order, bit-equal here; held within ``EXACT_TOL``
  = 1e-6 of each channel's largest magnitude.
* each pyramid level's resize (``pyramid_level``: Gaussian blur, then the
  antialiased resize): within ``LEVEL_TOL`` = 1e-4 grey levels (0-255);
  measured 3.05e-5, one ulp at 128-255 (JAX resizes by a matmul with the
  weights, PyTorch by its own loop). Without ``antialias`` the port would
  be 1 to 100 grey levels off, which the test also shows.
* ``farneback_flow``, both directions: f32 resolves the flow to ~1e-5
  px in the border ramp (both packages' f32 flows up to 1.03e-5 px from
  the port's float64 run there, 3.1e-6 on the interior), so it is held
  within ``FLOW_TOL`` = 2e-5 px of JAX's (measured up to 7.2e-6 px), and
  both packages' f32 flows within ``FLOW_TOL`` of the float64 run: the
  gap is rounding.
* ``batched_flow_pair`` with ``normalize``: within ``FLOW_TOL`` / W.
* the sub-pixel shift recovered within ``tests/test_flow.py``'s 0.3 px,
  and the port's flow within that test's mean EPE < 0.5 of
  ``cv2.calcOpticalFlowFarneback`` (the reference's call).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcsfm.ops import flow as J
from tcsfm_torch.ops import flow as P
from test_flow import _shift, _texture
from test_torch_depth_metrics import real_cv2  # noqa: F401 (fixture)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W = 128, 192
SHIFT = (1.5, -1.0)
BORDER = 5
EXACT_TOL = 1e-6
LEVEL_TOL = 1e-4
FLOW_TOL = 2e-5


def rgb_of(grey):
    """An RGB frame in [0, 1] whose channels are affine maps of ``grey``."""
    return np.stack([grey, 0.9 * grey + 12.0, 0.8 * grey + 25.0],
                    -1).astype(np.float32) / 255.0


@pytest.fixture(scope="module")
def pair():
    base = _texture(H, W, sigma=3.0)
    return base, _shift(base, *SHIFT)


@pytest.fixture(scope="module")
def jax_run(pair):
    """JAX's ``batched_flow_pair`` (jitted) of the RGB pair, and its grey
    pair: the flow test holds ``farneback_flow`` of that grey pair against
    the un-normalized flows (one compile for the module)."""
    rgb_t, rgb_s = (jnp.asarray(rgb_of(x))[None] for x in pair)
    fwd, back = J.batched_flow_pair(rgb_t, rgb_s)
    greys = [np.asarray(J.rgb_to_gray(x[0])) for x in (rgb_t, rgb_s)]
    return np.asarray(fwd[0]), np.asarray(back[0]), greys


def regions(x):
    """(interior, border ramp) of [H, W, ...]."""
    inner = np.zeros(x.shape[:2], bool)
    inner[BORDER:-BORDER, BORDER:-BORDER] = True
    return {"interior": x[inner], "border": x[~inner]}


def hold(ours, ref, tol, what, relative=False):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, what
    scale = np.abs(ref).reshape(-1, ref.shape[-1]).max(0) if relative else 1
    for name, (a, b) in zip(("interior", "border"),
                            zip(regions(ours).values(),
                                regions(ref).values())):
        err = (np.abs(a - b) / scale).max()
        print(f"{what}, {name}: {err:.3e}")
        assert err <= tol, (what, name, err)


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_rgb_to_gray_matches_jax(pair, jax_run):
    for rgb, ref in zip(pair, jax_run[2]):
        hold(P.rgb_to_gray(t(rgb_of(rgb)))[..., None], ref[..., None],
             EXACT_TOL, "grey", relative=True)


def test_poly_expansion_matches_jax(pair):
    for img in pair:
        hold(P.poly_expansion(t(img)), J.poly_expansion(jnp.asarray(img)),
             EXACT_TOL, "expansion", relative=True)


def test_update_step_matches_jax(pair):
    """One update from a smooth non-zero flow: the matrices, their box
    blur and the 2x2 solve."""
    base, moved = pair
    flow = np.stack(np.broadcast_arrays(
        np.linspace(0.5, 2.0, W)[None, :], np.linspace(-1.5, 0.5, H)[:, None]),
        -1).astype(np.float32)
    rj = [J.poly_expansion(jnp.asarray(x)) for x in pair]
    rp = [P.poly_expansion(t(x)) for x in pair]
    mj = J._update_matrices(*rj, jnp.asarray(flow))
    mp = P._update_matrices(*rp, t(flow))
    hold(mp, mj, EXACT_TOL, "update matrices", relative=True)
    bj, bp = J._box_blur(mj, 15), P._box_blur(mp, 15)
    hold(bp, bj, EXACT_TOL, "box blur", relative=True)
    hold(P._solve_flow(bp), J._solve_flow(bj), FLOW_TOL, "solve")


@pytest.mark.parametrize("k", [1, 2, 3])
def test_pyramid_level_matches_jax(pair, k):
    base = pair[0]
    scale = 0.5 ** k
    lh, lw = round(H * scale), round(W * scale)
    ref = np.asarray(jax.image.resize(
        J._gaussian_blur(jnp.asarray(base), (1.0 / scale - 1.0) * 0.5),
        (lh, lw), "linear"))
    ours = P.pyramid_level(t(base)[None], scale, lh, lw)[0]
    hold(ours[..., None], ref[..., None], LEVEL_TOL, f"level {k}")
    plain = torch.nn.functional.interpolate(
        P._gaussian_blur(t(base), (1.0 / scale - 1.0) * 0.5)[None, None],
        size=(lh, lw), mode="bilinear", align_corners=False)[0, 0]
    assert np.abs(plain.numpy() - ref).max() > 1.0


@pytest.mark.parametrize("size,extra", [((192, 640), 3), ((128, 192), 3),
                                        ((64, 96), 2), ((32, 48), 1)])
def test_level_sizes(size, extra):
    sizes = P.level_sizes(*size)
    assert len(sizes) == extra + 1
    assert sizes[-1] == (1.0, *size)
    assert sizes[0][1:] == tuple(int(round(s * 0.5 ** extra)) for s in size)


def test_farneback_matches_jax_and_float64(jax_run):
    """Both directions of the grey pair, against JAX's ``batched_flow_pair``
    before its normalization (its flows times W: one ulp of the division
    at most, below 2.5e-7 px here)."""
    fwd_j, back_j, (g_t, g_s) = jax_run
    for (a, b), ref, shift in (((g_t, g_s), fwd_j, SHIFT),
                               ((g_s, g_t), back_j, [-s for s in SHIFT])):
        ours = P.farneback_flow(t(a), t(b)).numpy()
        theirs = ref * np.float32(W)
        hold(ours, theirs, FLOW_TOL, "flow vs JAX")
        f64 = P.farneback_flow(t(a), t(b), dtype=torch.float64).numpy()
        hold(ours, f64, FLOW_TOL, "port f32 vs port f64")
        hold(theirs, f64, FLOW_TOL, "JAX f32 vs port f64")
        inner = ours[12:-12, 12:-12].reshape(-1, 2).mean(0)
        np.testing.assert_allclose(inner, shift, atol=0.3)


def test_batched_flow_pair_matches_jax(pair, jax_run):
    rgb_t, rgb_s = (t(rgb_of(x))[None] for x in pair)
    fwd, back = P.batched_flow_pair(rgb_t, rgb_s)
    assert fwd.shape == back.shape == (1, H, W, 2)
    assert fwd.dtype == torch.float32
    hold(fwd[0], jax_run[0], FLOW_TOL / W, "normalized fwd")
    hold(back[0], jax_run[1], FLOW_TOL / W, "normalized back")
    # fwd is target->source (+shift), back source->target
    inner = slice(12, -12)
    np.testing.assert_allclose(fwd[0, inner, inner].reshape(-1, 2).mean(0)
                               * W, SHIFT, atol=0.3)
    np.testing.assert_allclose(back[0, inner, inner].reshape(-1, 2).mean(0)
                               * W, [-s for s in SHIFT], atol=0.3)


def test_pose_flows_stack_sources(pair):
    """``pose_flows`` of [S, B] sources equals ``batched_flow_pair`` of
    each source against the target."""
    rgb_t, rgb_s = (t(rgb_of(x[:32, :48])) for x in pair)
    src = torch.stack([torch.stack([rgb_s, rgb_t]),
                       torch.stack([rgb_t, rgb_s])])       # [2, 2, ...]
    tgt = torch.stack([rgb_t, rgb_s])
    fwd, back = P.pose_flows(tgt, src)
    assert fwd.shape == (2, 2, 32, 48, 2)
    for s in range(2):
        f, b = P.batched_flow_pair(tgt, src[s])
        torch.testing.assert_close(fwd[s], f, rtol=0, atol=0)
        torch.testing.assert_close(back[s], b, rtol=0, atol=0)


def test_matches_cv2(real_cv2):
    """``real_cv2``: the installed cv2, past the stub that
    ``tests/test_reference_parity.py`` puts into ``sys.modules``."""
    cv2 = real_cv2
    fb = getattr(cv2, "calcOpticalFlowFarneback", None)
    if fb is None:
        fb = getattr(getattr(cv2, "video", None),
                     "calcOpticalFlowFarneback", None)
    if fb is None:
        pytest.skip("cv2 Farneback unavailable in this import order")
    base = _texture(64, 96, sigma=3.0)
    moved = _shift(base, 1.5, -1.0)
    ref = fb(base.astype(np.uint8), moved.astype(np.uint8), None,
             0.5, 2, 15, 3, 5, 1.2, 0)
    mine = P.farneback_flow(t(base), t(moved), levels=2).numpy()
    c = slice(12, -12)
    epe = np.hypot(*(mine[c, c] - ref[c, c]).transpose(2, 0, 1))
    print(f"mean EPE vs cv2 {epe.mean():.3f}")
    assert epe.mean() < 0.5
