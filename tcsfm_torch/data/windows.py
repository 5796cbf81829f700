"""Sliding-window index construction for sequence datasets.

Host-side numpy replacement for the reference's reshape/split machinery
(data/kitti_loader_stereo.py:149-223, 239-278): instead of materializing
per-window copies of poses/intrinsics/filenames, we build an [M, seq_len]
*index* array into each sequence and gather lazily at load time — same
window semantics, no data duplication.

Semantics (all verified against the reference):
  * windows are consecutive frame runs of length ``seq_len``, stride 1
    (split_data, :214-223);
  * ``correction_rate`` decimates the frame stream *before* windowing
    (:239-245);
  * ``skip`` keeps every skip-th window *after* windowing (:274-278);
  * motion augmentation appends windows built on a frame stream decimated
    by (correction_rate + 1), simulating faster motion (:257-269).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def sliding_windows(n_frames: int, seq_len: int) -> np.ndarray:
    """[M, seq_len] consecutive index windows with stride 1."""
    m = n_frames - seq_len + 1
    if m <= 0:
        return np.zeros((0, seq_len), dtype=np.int64)
    return np.arange(m)[:, None] + np.arange(seq_len)[None, :]


def build_windows(
    n_frames: int,
    seq_len: int,
    correction_rate: int = 1,
    skip: int = 1,
    augment_motion: bool = False,
    num_frames: int | None = None,
) -> np.ndarray:
    """Full window index pipeline for one sequence → [M, seq_len] frame ids."""
    frames = np.arange(n_frames)
    if correction_rate != 1:
        frames = frames[::correction_rate]
    if num_frames:
        frames = frames[:num_frames]

    windows = [frames[sliding_windows(len(frames), seq_len)]]
    if augment_motion:
        fast = np.arange(n_frames)[:: (correction_rate + 1)]
        windows.append(fast[sliding_windows(len(fast), seq_len)])
    out = np.concatenate(windows, axis=0) if len(windows) > 1 else windows[0]
    if skip and skip != 1:
        out = out[::skip]
    return out


def target_source_split(seq_len: int) -> Tuple[int, List[int]]:
    """Middle frame is the target; the rest are sources
    (kitti_loader_stereo.py:87-89)."""
    target = seq_len // 2
    sources = [i for i in range(seq_len) if i != target]
    return target, sources
