"""Dual-stream data augmentation, host-side numpy.

Re-implements the reference transform pipeline (utils/custom_transforms.py)
without torch: every op maps an (original, augmented) pair so the loss can
consume clean images while the networks see jittered ones
(custom_transforms.py:42-48). Color jitter touches only the augmented
stream (:87-103); horizontal flip transforms BOTH streams and fixes up the
cx intrinsic and the yaw/roll lie-algebra components (:105-154).

Images are float32 [H, W, 3] in [0, 1] (HWC — the framework's NHWC layout).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


def _rgb_to_gray(img: np.ndarray) -> np.ndarray:
    return (
        0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    )[..., None]


def adjust_brightness(img, factor):
    return np.clip(img * factor, 0.0, 1.0)


def adjust_contrast(img, factor):
    mean = _rgb_to_gray(img).mean()
    return np.clip((img - mean) * factor + mean, 0.0, 1.0)


def adjust_saturation(img, factor):
    gray = _rgb_to_gray(img)
    return np.clip((img - gray) * factor + gray, 0.0, 1.0)


def adjust_hue(img, shift):
    """Hue rotation by ``shift`` (fraction of a full turn, [-0.5, 0.5]).

    Contiguous per-channel planes + pairwise max/min + arithmetic sextant
    masks: reductions/gathers over the interleaved channel axis of
    [H, W, 3] measured ~20 ms/frame (np.choose and axis=-1 max were the
    hot spots); this formulation runs ~4 ms at 192x640.
    """
    r = np.ascontiguousarray(img[..., 0])
    g = np.ascontiguousarray(img[..., 1])
    b = np.ascontiguousarray(img[..., 2])
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    v = maxc
    d = maxc - minc
    s = np.where(maxc > 0, d / np.maximum(maxc, 1e-12), 0.0)
    dd = np.maximum(d, 1e-12)
    rc = (maxc - r) / dd
    gc = (maxc - g) / dd
    bc = (maxc - b) / dd
    h = np.where(r == maxc, bc - gc, np.where(g == maxc, 2.0 + rc - bc,
                                              4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = (h + shift) % 1.0
    # hsv → rgb
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    m = [(i == k).astype(img.dtype) for k in range(6)]
    out_r = v * (m[0] + m[5]) + q * m[1] + p * (m[2] + m[3]) + t * m[4]
    out_g = t * m[0] + v * (m[1] + m[2]) + q * m[3] + p * (m[4] + m[5])
    out_b = p * (m[0] + m[1]) + t * m[2] + v * (m[3] + m[4]) + q * m[5]
    out = np.stack([out_r, out_g, out_b], axis=-1)
    return np.where(d[..., None] < 1e-12, img, out).astype(img.dtype)


@dataclass
class JitterParams:
    brightness: float
    contrast: float
    saturation: float
    hue: float
    apply: bool


def sample_jitter(rng: np.random.RandomState,
                  brightness=0.2, contrast=0.2, saturation=0.2,
                  hue=0.1) -> JitterParams:
    """One parameter draw shared across all frames of a window
    (custom_transforms.py:93-98)."""
    return JitterParams(
        brightness=rng.uniform(max(0, 1 - brightness), 1 + brightness),
        contrast=rng.uniform(max(0, 1 - contrast), 1 + contrast),
        saturation=rng.uniform(max(0, 1 - saturation), 1 + saturation),
        hue=rng.uniform(-hue, hue),
        apply=rng.rand() > 0.5,
    )


def apply_jitter(img: np.ndarray, p: JitterParams) -> np.ndarray:
    if not p.apply:
        return img
    img = adjust_brightness(img, p.brightness)
    img = adjust_contrast(img, p.contrast)
    img = adjust_saturation(img, p.saturation)
    img = adjust_hue(img, p.hue)
    return img


def apply_flip(imgs: List[np.ndarray], K: np.ndarray,
               lie_algs: np.ndarray) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
    """Horizontal flip with intrinsics + pose fixup (custom_transforms.py:105-149).

    imgs: list of [H, W, 3]; K: [3, 3]; lie_algs: [..., 6].
    Mirrors cx → w - cx and negates yaw (index 4) and roll (index 5).
    """
    w = imgs[0].shape[1]
    out_imgs = [np.ascontiguousarray(im[:, ::-1]) for im in imgs]
    K2 = K.copy()
    K2[0, 2] = w - K2[0, 2]
    la = np.array(lie_algs, copy=True)
    la[..., 4] = -la[..., 4]
    la[..., 5] = -la[..., 5]
    return out_imgs, K2, la


@dataclass
class WindowTransform:
    """train/val/test transform policy (custom_transforms.py:9-31)."""

    jitter: bool = True
    flip_prob: Optional[float] = 0.5

    def __call__(self, imgs: List[np.ndarray], K: np.ndarray,
                 lie_algs: np.ndarray, rng: np.random.RandomState):
        """Returns ((clean_imgs, K, lie), (aug_imgs, K_aug, lie_aug))."""
        aug_imgs = list(imgs)
        if self.jitter:
            p = sample_jitter(rng)
            aug_imgs = [apply_jitter(im, p) for im in aug_imgs]
        K_o, la_o = K, np.asarray(lie_algs)
        K_a, la_a = K, np.asarray(lie_algs)
        out_imgs = list(imgs)
        if self.flip_prob is not None and rng.uniform() < self.flip_prob:
            out_imgs, K_o, la_o = apply_flip(out_imgs, K, la_o)
            aug_imgs, K_a, la_a = apply_flip(aug_imgs, K, la_a)
        return (out_imgs, K_o, la_o), (aug_imgs, K_a, la_a)


def get_transforms(train_jitter: bool = True) -> dict:
    return {
        "train": WindowTransform(jitter=train_jitter, flip_prob=0.5),
        "val": WindowTransform(jitter=train_jitter, flip_prob=None),
        "test": WindowTransform(jitter=False, flip_prob=None),
    }
