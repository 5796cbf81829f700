"""The coupled solver's error products (``return_errors=True``) against
the JAX package's, on CPU, in float64 at 1e-5 and in f32.

64x96, B=2, S=2 (``test_torch_coupled.py``'s inputs): smooth images and
smooth depths near 1, the trained-like regime in which f32 resolves the
solver (ROADMAP §3); one case takes its depths from the port's depth net
with trained-like conditioning (``chip_smoke.condition_like_trained``).
Both solvers get the same depths, the pose net converted from Flax's
init by ``from_flax``.

Every field of ``outputs["fwd"]``, ``["inv"]`` and ``["comb"]`` is held:

* in float64 (JAX under ``jax.enable_x64(True)`` with a float64 pose
  net, the port's pose net ``.double()`` with ``grid_sample_plain``):
  every product within ``TOL_F64`` = 1e-5 absolute, the valid masks
  exactly. JAX's float64 pose net keeps float32 pieces, so its poses sit
  up to 1.8e-8 from the port's and the products up to 4.7e-6 (measured
  at 2 iterations on the net's depths; ``auto_mask_error``, which warps
  nothing, 4e-14);
* in f32: the poses within 1e-5, the valid masks exactly, and the rest
  (``img_rec``, ``weight_mask``, ``comb["imgs"]``, and the SSIM products
  ``diff_img`` and ``auto_mask_error``) within 1e-4. f32 does not resolve
  a warp's value at pixels that sample next to the image's border: there
  one f32 warp of the JAX package and one of the port, from identical
  inputs, differ by up to 1.4e-5 (the un-normalization ((g + 1) W - 1) / 2
  rounds g near 1 differently), where float64 warps agree to 2e-14
  (measured). SSIM forms its variances as E[x²] - μ², which cancels in
  f32 against C2 = 9e-4: the jitted JAX ``auto_mask_error``, which warps
  nothing, is 1.7e-5 from the port's, and ``diff_img`` up to 7.4e-5
  (measured). The f32 case is the check of the border and of the
  cancellation at the precision the card runs.

``auto_mask`` is a comparison (diff_img < auto_mask_error): it is held
equal at every pixel where the two compared values lie further apart
than the diff image's limit, and the pixels closer than that are counted
(at most 1%; measured in f32: 40 to 148 of the 49,152). The warps:
``num_iter`` of them, all 3-channel but the last, which samples the
source depth as the 4-channel tail, with a gradient for the depth where
the depth needs one.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

import chip_smoke
from tcsfm.models.pose import PoseNet as JaxPoseNet
from tcsfm.solver.coupled import solve_pose_iteratively as jax_spi
from tcsfm_torch import infer
from tcsfm_torch.config import Config
from tcsfm_torch.models.convert import pose_state_dict
from tcsfm_torch.models.pose import PoseNet
from tcsfm_torch.ops import grid_sample as gs
from tcsfm_torch.solver import coupled
from tcsfm_torch.utils.helpers import disp_to_depth
from test_torch_coupled import B, H, S, W, _inputs, _same_depths
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# limits by field (see the docstring): f32, and float64 for every field
TOL_F64 = 1e-5
TOL = {"diff_img": 1e-4, "img_rec": 1e-4, "valid_mask": 0.0,
       "weight_mask": 1e-4, "poses": 1e-5, "auto_mask_error": 1e-4,
       "imgs": 1e-4}
FIELDS = ("diff_img", "img_rec", "valid_mask", "weight_mask", "poses",
          "auto_mask_error")


@pytest.fixture(scope="module")
def nets():
    pose_model = JaxPoseNet()
    pvars = jax.jit(pose_model.init)(jax.random.PRNGKey(1),
                                     jnp.zeros((1, 32, 32, 6)))
    params = jax.tree_util.tree_map(np.asarray, unfreeze(pvars["params"]))
    pose_net = PoseNet()
    pose_net.load_state_dict(pose_state_dict(params))
    return pose_model, params, pose_net.eval()


def _net_depths(tgt, src):
    """Depths from the port's depth net, seeded, with trained-like
    conditioning applied to its decoder."""
    depth_net, _ = infer.build_models(
        Config(compute_dtype="float32"), device="cpu",
        generator=torch.Generator().manual_seed(3))
    chip_smoke.condition_like_trained(depth_net, torch)
    with torch.no_grad():
        imgs = torch.cat([torch.from_numpy(tgt),
                          torch.from_numpy(src).reshape(S * B, H, W, 3)])
        disp = depth_net(imgs)[0]
    depth = disp_to_depth(disp, 0.06, 80.0 / 30.0)[1]
    return depth.reshape(S + 1, B, H, W, 1).numpy()


def _assert_products_match(ref, out, tol):
    """Every field of ``fwd``, ``inv`` and ``comb`` within ``tol[field]``;
    ``auto_mask`` equal wherever its comparison is decided by more than
    the diff image's limit, and at most 1% of the pixels closer."""
    near, worst = 0, {}
    for part in ("fwd", "inv"):
        r, p = ref[part], out[part]
        for k in FIELDS:
            want, got = np.asarray(getattr(r, k)), getattr(p, k).detach().numpy()
            assert got.shape == want.shape, (part, k)
            worst[f"{part}.{k}"] = float(np.abs(got - want).max())
            np.testing.assert_allclose(got, want, atol=tol[k], rtol=0,
                                       err_msg=f"{part}.{k}")
        gap = np.abs(np.asarray(r.diff_img) - np.asarray(r.auto_mask_error))
        decided = gap > tol["diff_img"]
        near += int((~decided).sum())
        np.testing.assert_array_equal(p.auto_mask.numpy()[decided],
                                      np.asarray(r.auto_mask)[decided])
    print(f"largest |port - JAX| by field: {worst}; auto_mask: {near} "
          f"pixels within {tol['diff_img']} of the comparison's tie")
    assert near <= 0.01 * 2 * S * B * H * W
    for k in ("imgs", "valid_mask"):
        np.testing.assert_allclose(out["comb"][k].detach().numpy(),
                                   np.asarray(ref["comb"][k]), atol=tol[k],
                                   rtol=0, err_msg=f"comb.{k}")


@pytest.mark.parametrize("iterations,depths", [(4, "net"), (2, "smooth"),
                                               (1, "smooth")])
def test_error_products_match_jax(nets, iterations, depths):
    pose_model, params, pose_net = nets
    tgt, src, K = _inputs(11)
    d = _net_depths(tgt, src) if depths == "net" else _same_depths(12)

    @jax.jit
    def solve(d, tgt, src, K):
        return jax_spi(iterations, d, lambda x: pose_model.apply(
            {"params": params}, x), tgt, src, K, return_errors=True)[2]

    ref = solve(d, tgt, src, K)
    warps = []

    def recording(img, coords, tail=None):
        warps.append((img.shape[-1] + (0 if tail is None else tail.shape[-1]),
                      tail is not None and tail.requires_grad))
        return gs.grid_sample_plain(img, coords, tail)

    depth_t = torch.from_numpy(d).requires_grad_()
    poses, poses_inv, out = coupled.solve_pose_iteratively(
        iterations, depth_t, pose_net, torch.from_numpy(tgt),
        torch.from_numpy(src), torch.from_numpy(K), sampler=recording,
        return_errors=True)
    assert warps == [(3, False)] * (iterations - 1) + [(4, True)]
    assert torch.equal(poses, out["fwd"].poses[:, -1].reshape(S, B, 6))
    assert torch.equal(poses_inv, out["inv"].poses[:, -1].reshape(S, B, 6))

    _assert_products_match(ref, out, TOL)
    # the products are differentiable in the depths
    (out["fwd"].weight_mask.sum() + out["fwd"].diff_img.sum()).backward()
    assert depth_t.grad is not None and depth_t.grad.abs().max() > 0


@pytest.mark.parametrize("iterations,depths", [(2, "net")])
def test_error_products_match_jax_f64(nets, iterations, depths):
    pose_model, params, pose_net = nets
    tgt, src, K = (a.astype(np.float64) for a in _inputs(11))
    d = (_net_depths(tgt.astype(np.float32), src.astype(np.float32))
         if depths == "net" else _same_depths(12)).astype(np.float64)

    with jax.enable_x64(True):
        model64 = pose_model.clone(dtype=jnp.float64)
        params64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), params)

        @jax.jit
        def solve(d, tgt, src, K):
            return jax_spi(iterations, d, lambda x: model64.apply(
                {"params": params64}, x), tgt, src, K, return_errors=True)[2]

        ref = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            solve(*(jnp.asarray(a) for a in (d, tgt, src, K))))

    net64 = copy.deepcopy(pose_net).double()
    with torch.no_grad():
        _, _, out = coupled.solve_pose_iteratively(
            iterations, torch.from_numpy(d), net64, torch.from_numpy(tgt),
            torch.from_numpy(src), torch.from_numpy(K),
            sampler=gs.grid_sample_plain, return_errors=True)
    assert out["fwd"].diff_img.dtype == torch.float64
    tol = {k: 0.0 if k == "valid_mask" else TOL_F64 for k in TOL}
    _assert_products_match(ref, out, tol)


def test_pose_only_path_is_unchanged(nets):
    """Without errors the solver keeps its pose-only warps (3-channel,
    the last iteration's re-warp skipped), and its poses are those of the
    solve with errors."""
    pose_net = nets[2]
    tgt, src, K = _inputs(13)
    d = torch.from_numpy(_same_depths(14))
    shapes = []

    def recording(img, coords, tail=None):
        shapes.append(img.shape[-1] + (0 if tail is None else tail.shape[-1]))
        return gs.grid_sample_plain(img, coords, tail)

    args = (d, pose_net, torch.from_numpy(tgt), torch.from_numpy(src),
            torch.from_numpy(K))
    with torch.no_grad():
        poses, poses_inv, chain = coupled.solve_pose_iteratively(
            4, *args, sampler=recording)
        assert shapes == [3, 3, 3]
        p_err, pi_err, out = coupled.solve_pose_iteratively(
            4, *args, return_errors=True)
    assert torch.equal(poses, p_err) and torch.equal(poses_inv, pi_err)
    assert torch.equal(chain, torch.cat([out["fwd"].poses, out["inv"].poses]))
