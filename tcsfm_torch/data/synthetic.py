"""Synthetic geometrically-consistent sequences for tests, demos, benchmarks.

The reference ships bundled KITTI window pickles so its demo runs without a
dataset download (run_sample_optimization_demo.py:160-163). This module
goes further: it *generates* photometrically consistent window data of any
size — a textured fronto-parallel scene over a ground plane, viewed by a
camera translating/rotating with known poses — so the coupled solver, PFT,
training, and the benchmarks all run dataset-free with a known optimum.

Source images are rendered by warping the target texture with the TRUE
depth and pose through the same camera model the solver uses, so the
photometric minimum sits exactly at the ground-truth pose.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tcsfm_torch.data.dataset import SequenceData
from tcsfm_torch.eval.trajectory import np_se3_exp


def _texture(h: int, w: int, rng: np.random.RandomState) -> np.ndarray:
    """Smooth random RGB texture in [0,1]: sum of low-frequency sinusoids."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        acc = np.zeros((h, w), np.float64)
        for _ in range(6):
            fx, fy = rng.uniform(0.5, 4.0, 2)
            px, py = rng.uniform(0, 2 * np.pi, 2)
            acc += rng.uniform(0.3, 1.0) * np.sin(
                2 * np.pi * fx * xs / w + px
            ) * np.cos(2 * np.pi * fy * ys / h + py)
        acc = (acc - acc.min()) / (acc.max() - acc.min() + 1e-9)
        img[..., c] = acc
    return 0.1 + 0.8 * img


def _scene_depth(h: int, w: int, K: np.ndarray, cam_height: float,
                 far_depth: float) -> np.ndarray:
    """Ground plane below the horizon, fronto wall above (z-depth map)."""
    fy, cy = K[1, 1], K[1, 2]
    ys = (np.arange(h) - cy) / fy
    ground = np.where(ys > 0.02, cam_height / np.maximum(ys, 0.02), far_depth)
    depth = np.minimum(ground, far_depth)
    return np.broadcast_to(depth[:, None], (h, w)).astype(np.float32)


def _bilinear_sample(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Clamped bilinear sampling of [H, W, C] at float pixel coords."""
    h, w = img.shape[:2]
    x0 = np.clip(np.floor(x).astype(int), 0, w - 1)
    y0 = np.clip(np.floor(y).astype(int), 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    wx = np.clip(x - x0, 0, 1)[..., None]
    wy = np.clip(y - y0, 0, 1)[..., None]
    return (
        img[y0, x0] * (1 - wx) * (1 - wy) + img[y0, x1] * wx * (1 - wy)
        + img[y1, x0] * (1 - wx) * wy + img[y1, x1] * wx * wy
    )


def _render_view(target_img: np.ndarray, target_depth: np.ndarray,
                 T_src_from_tgt: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Render the scene from a displaced camera.

    For each source pixel, back-project with the source-view depth of the
    (planar) scene, transform into the target frame, and sample the target
    texture. Planar geometry keeps this exact without a mesh renderer.
    """
    h, w = target_depth.shape
    # source-view depth of the same plane geometry: approximate by warping
    # the target depth — for small motions the plane depth field is nearly
    # view-independent, and we only need photometric consistency.
    src_depth = target_depth
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).astype(np.float64)
    rays = pix @ np.linalg.inv(K).T
    pts_src = rays * src_depth[..., None]
    T = np.linalg.inv(T_src_from_tgt)           # target ← source
    pts_tgt = pts_src @ T[:3, :3].T + T[:3, 3]
    proj = pts_tgt @ K.T
    x = proj[..., 0] / np.maximum(proj[..., 2], 1e-6)
    y = proj[..., 1] / np.maximum(proj[..., 2], 1e-6)
    return _bilinear_sample(target_img, x, y).astype(np.float32)


def make_synthetic_sequence(
    n_frames: int = 8,
    image_size: Tuple[int, int] = (64, 96),
    seed: int = 0,
    cam_height: float = 1.5 / 30.0,
    far_depth: float = 2.0,
    step: float = 0.02,
    yaw_rate: float = 0.002,
) -> SequenceData:
    """A camera driving forward over a textured ground plane.

    Depth/translation units are the network's 1/30-metric scale
    (SURVEY.md §0.6). GT poses are world-from-camera.
    """
    h, w = image_size
    rng = np.random.RandomState(seed)
    K = np.array(
        [[0.6 * w, 0.0, w / 2.0], [0.0, 0.6 * w, h / 2.5], [0.0, 0.0, 1.0]],
        np.float64,
    )
    tex = _texture(h, w, rng)
    depth0 = _scene_depth(h, w, K, cam_height, far_depth)

    poses = [np.eye(4)]
    for _ in range(n_frames - 1):
        xi = np.array([0.0, 0.0, step, 0.0, yaw_rate, 0.0])
        dT = np_se3_exp(xi)                      # camera_{k} ← camera_{k+1}
        poses.append(poses[-1] @ dT)
    poses = np.asarray(poses)

    images = np.zeros((n_frames, h, w, 3), np.float32)
    depths = np.zeros((n_frames, h, w), np.float32)
    for i in range(n_frames):
        T_i_from_0 = np.linalg.inv(poses[i])     # camera_i ← camera_0
        images[i] = _render_view(tex, depth0, T_i_from_0, K)
        depths[i] = depth0                       # planar scene, ~constant
    return SequenceData(
        name=f"synthetic_{seed}",
        intrinsics=np.broadcast_to(K.astype(np.float32), (n_frames, 3, 3)).copy(),
        gt_poses=poses,
        vo_poses=poses.copy(),
        timestamps=np.arange(n_frames, dtype=np.float64) * 0.1,
        images=images,
        depths=depths,
    )


# ---------------------------------------------------------------------------
# Arbitrary-length "drive" sequences (round-5 chain-BA flagship)
# ---------------------------------------------------------------------------


def _procedural_field(rng: np.random.RandomState, n_terms: int,
                      freq_lo: float, freq_hi: float):
    """A fixed random sinusoid mix f(u, v) -> [0,1]^3, identical for every
    evaluation (parameters drawn ONCE; normalization by the analytic
    amplitude bound, not per-batch min/max — per-batch normalization
    would make the 'world' texture depend on which points each frame
    happens to see).

    `make_synthetic_sequence` warps a frame-0 texture, which leaves the
    valid photometric region after ~0.5 scene units of travel — fine for
    its <=32-frame gate/test windows, degenerate for a KITTI-09-scale
    sequence. This field is evaluable anywhere, so every neighboring
    pair stays photometrically consistent no matter how long the drive.
    """
    fu = rng.uniform(freq_lo, freq_hi, (3, n_terms))
    fv = rng.uniform(freq_lo, freq_hi, (3, n_terms))
    pu = rng.uniform(0, 2 * np.pi, (3, n_terms))
    pv = rng.uniform(0, 2 * np.pi, (3, n_terms))
    amp = rng.uniform(0.3, 1.0, (3, n_terms))
    amp_total = amp.sum(axis=1)                       # analytic |s| bound

    def field(u: np.ndarray, v: np.ndarray) -> np.ndarray:
        out = np.empty(u.shape + (3,), np.float32)
        for c in range(3):
            s = np.zeros_like(u, dtype=np.float64)
            for k in range(n_terms):
                s += amp[c, k] * np.sin(fu[c, k] * u + pu[c, k]) \
                    * np.cos(fv[c, k] * v + pv[c, k])
            out[..., c] = 0.5 + 0.5 * s / amp_total[c]
        return 0.1 + 0.8 * out

    return field


def make_drive_sequence(
    n_frames: int = 256,
    image_size: Tuple[int, int] = (64, 96),
    seed: int = 0,
    cam_height: float = 1.5 / 30.0,
    far_depth: float = 20.0,
    step: float = 0.02,
    yaw_amp: float = 0.004,
    yaw_period: float = 400.0,
) -> SequenceData:
    """A level camera driving a long, curving path over a world-anchored
    procedural ground plane (KITTI-09-scale sequences for the chain-BA
    flagship benchmark; any ``n_frames``).

    Geometry: the camera stays at ``cam_height`` with zero pitch/roll and
    yaws sinusoidally (amplitude ``yaw_amp`` rad/frame over
    ``yaw_period`` frames — an S-curving drive). Below-horizon pixels see
    the ground plane (exact, view-independent z-depth in the level
    camera frame); above-horizon pixels see an infinitely-distant sky
    dome (direction-indexed — exact under yaw, parallax-free under
    translation) with depth recorded as ``far_depth``. Because pitch and
    height are constant, the per-frame depth map is the same analytic
    field for every frame — and it is EXACT for the ground region, so
    depth-consistency terms see a consistent scene.

    Units are the 1/30-metric network scale; step=0.02 -> 0.6 m/frame
    (~KITTI at 10 Hz), so 1,500 frames cover ~900 m.
    """
    h, w = image_size
    K = np.array(
        [[0.6 * w, 0.0, w / 2.0], [0.0, 0.6 * w, h / 2.5], [0.0, 0.0, 1.0]],
        np.float64,
    )
    # world-anchored ground texture f(X, Z) and an infinitely-distant
    # direction-indexed sky f(azimuth, elevation) — parameters drawn once
    ground_tex = _procedural_field(np.random.RandomState(seed + 1),
                                   n_terms=6, freq_lo=1.0, freq_hi=12.0)
    sky_tex = _procedural_field(np.random.RandomState(seed + 2),
                                n_terms=4, freq_lo=1.0, freq_hi=6.0)

    poses = [np.eye(4)]
    for i in range(n_frames - 1):
        yaw = yaw_amp * np.sin(2 * np.pi * i / yaw_period)
        xi = np.array([0.0, 0.0, step, 0.0, yaw, 0.0])
        poses.append(poses[-1] @ np_se3_exp(xi))
    poses = np.asarray(poses)

    depth0 = _scene_depth(h, w, K, cam_height, far_depth)
    ground_mask = depth0 < far_depth - 1e-6

    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).astype(np.float64)
    rays = pix @ np.linalg.inv(K).T              # camera-frame directions
    pts_cam = rays * depth0[..., None]           # ground-plane 3D points

    images = np.zeros((n_frames, h, w, 3), np.float32)
    depths = np.zeros((n_frames, h, w), np.float32)
    for i in range(n_frames):
        R, t = poses[i][:3, :3], poses[i][:3, 3]
        dirs_w = rays @ R.T
        az = np.arctan2(dirs_w[..., 0], dirs_w[..., 2])
        el = dirs_w[..., 1] / np.maximum(
            np.linalg.norm(dirs_w, axis=-1), 1e-9)
        img = sky_tex(az, 8.0 * el)
        pts_w = pts_cam[ground_mask] @ R.T + t
        img[ground_mask] = ground_tex(pts_w[..., 0], pts_w[..., 2])
        images[i] = img
        depths[i] = depth0
    return SequenceData(
        name=f"drive_{seed}",
        intrinsics=np.broadcast_to(K.astype(np.float32),
                                   (n_frames, 3, 3)).copy(),
        gt_poses=poses,
        vo_poses=poses.copy(),
        timestamps=np.arange(n_frames, dtype=np.float64) * 0.1,
        images=images,
        depths=depths,
    )
