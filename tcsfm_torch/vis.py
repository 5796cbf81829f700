"""Visualization utilities, the port's copy of ``tcsfm/vis.py`` (vis.py +
paper_plots_and_data/visualizers.py equivalents): image grids, disparity
colormaps, 6-DoF pose component plots, top-down trajectory plots. All
functions return HWC uint8 numpy images (ready for TensorBoard
``add_image`` or PNG saving) or write to files.
matplotlib is imported inside the functions: where it is not installed,
each raises the ``ImportError`` that names it.
"""

from __future__ import annotations

import io
from typing import Optional, Sequence

import numpy as np


def _fig_to_array(fig) -> np.ndarray:
    import matplotlib.pyplot as plt

    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight", dpi=100)
    plt.close(fig)
    buf.seek(0)
    from PIL import Image

    with Image.open(buf) as im:
        return np.asarray(im.convert("RGB"))


def image_grid(imgs: np.ndarray, nrow: int = 3,
               save_file: Optional[str] = None) -> np.ndarray:
    """[N, H, W, C] (C in {1, 3}) float[0,1] → tiled uint8 grid
    (vis.py plot_img_array equivalent)."""
    imgs = np.asarray(imgs)
    if imgs.ndim == 3:
        imgs = imgs[..., None]
    n, h, w, c = imgs.shape
    if c == 1:
        imgs = np.repeat(imgs, 3, axis=-1)
    ncol = (n + nrow - 1) // nrow if nrow else n
    rows = []
    for r in range(0, n, nrow):
        row = imgs[r:r + nrow]
        if row.shape[0] < nrow:
            pad = np.zeros((nrow - row.shape[0], h, w, 3), row.dtype)
            row = np.concatenate([row, pad], 0)
        rows.append(np.concatenate(list(row), axis=1))
    grid = np.concatenate(rows, axis=0)
    out = (np.clip(grid, 0, 1) * 255).astype(np.uint8)
    if save_file:
        from PIL import Image

        Image.fromarray(out).save(save_file)
    return out


def colorize_disparity(disp: np.ndarray, cmap: str = "plasma",
                       save_file: Optional[str] = None) -> np.ndarray:
    """[H, W] disparity → colormapped uint8 image (vis.py plot_disp)."""
    import matplotlib.cm as cm

    d = np.asarray(disp, np.float32)
    d = (d - d.min()) / max(d.max() - d.min(), 1e-9)
    out = (cm.get_cmap(cmap)(d)[..., :3] * 255).astype(np.uint8)
    if save_file:
        from PIL import Image

        Image.fromarray(out).save(save_file)
    return out


def plot_pose_components(pose_vecs: np.ndarray, title: str = "",
                         save_file: Optional[str] = None) -> np.ndarray:
    """[N, 6] pose vectors → 6x1 component plot (vis.py plot_6_by_1)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = ["tx", "ty", "tz", "rx", "ry", "rz"]
    fig, axes = plt.subplots(6, 1, figsize=(6, 9), sharex=True)
    for i, ax in enumerate(axes):
        ax.plot(pose_vecs[:, i], linewidth=0.8)
        ax.set_ylabel(labels[i])
        ax.grid(True, alpha=0.3)
    axes[0].set_title(title)
    out = _fig_to_array(fig)
    if save_file:
        from PIL import Image

        Image.fromarray(out).save(save_file)
    return out


def plot_trajectories(trajs: Sequence[np.ndarray], labels: Sequence[str],
                      title: str = "", axes=(0, 2),
                      save_file: Optional[str] = None) -> np.ndarray:
    """Top-down trajectory plot from [N, 4, 4] pose arrays
    (vis.py plot_multi_traj / visualizers.py TrajectoryVisualizer)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    styles = ["-", "--", ":", "-."]
    for i, (traj, label) in enumerate(zip(trajs, labels)):
        t = np.asarray(traj)
        ax.plot(t[:, axes[0], 3], t[:, axes[1], 3],
                styles[i % len(styles)], linewidth=1.5, label=label)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("z (m)")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend()
    ax.set_aspect("equal", adjustable="datalim")
    out = _fig_to_array(fig)
    if save_file:
        from PIL import Image

        Image.fromarray(out).save(save_file)
    return out


def plot_segment_errors(named_tms, seg_lengths=None, title: str = "",
                        save_file: Optional[str] = None) -> np.ndarray:
    """KITTI-leaderboard-style averaged segment errors vs segment length
    (visualizers.py TrajectoryVisualizer.plot_segment_errors:122-172).

    Args:
      named_tms: {label: TrajectoryMetrics} — one curve per entry.
      seg_lengths: path lengths in metres (default 100..800 step 100).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    seg_lengths = list(seg_lengths or range(100, 801, 100))
    fig, ax = plt.subplots(1, 2, figsize=(8, 3))
    for label, tm in named_tms.items():
        _, avg = tm.segment_errors(seg_lengths)
        if avg.shape[0] == 0:
            continue
        # trans: fraction → %; rot: rad/m → deg/m (visualizers.py:142-146)
        ax[0].plot(avg[:, 0], avg[:, 1] * 100.0, "-s", label=label)
        ax[1].plot(avg[:, 0], avg[:, 2] * 180.0 / np.pi, "-s", label=label)
    for a, t, yl in ((ax[0], "Translational error", "Average error (%)"),
                     (ax[1], "Rotational error", "Average error (deg/m)")):
        a.minorticks_on()
        a.grid(which="both", linestyle=":", linewidth=0.2)
        a.set_title(t)
        a.set_xlabel("Segment length (m)")
        a.set_ylabel(yl)
    if ax[1].get_legend_handles_labels()[1]:
        ax[1].legend()
    if title:
        fig.suptitle(title)
    out = _fig_to_array(fig)
    if save_file:
        from PIL import Image

        Image.fromarray(out).save(save_file)
    return out


def _norm_err_plot(named_tms, cumulative: bool, title: str,
                   save_file: Optional[str]) -> np.ndarray:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    err_name = "Cumulative Err. Norm." if cumulative else "Err. Norm."
    fig, ax = plt.subplots(1, 2, figsize=(8, 3))
    for label, tm in named_tms.items():
        t_err, r_err = tm.cum_err() if cumulative else tm.error_norms()
        ax[0].plot(t_err, "-", label=label)
        ax[1].plot(r_err * 180.0 / np.pi, "-", label=label)
    for a, t, unit in ((ax[0], "Translational", "m"),
                       (ax[1], "Rotational", "deg")):
        a.minorticks_on()
        a.grid(which="both", linestyle=":", linewidth=0.2)
        a.set_title(f"{t} {err_name}")
        a.set_xlabel("Timestep")
        a.set_ylabel(f"{err_name} ({unit})")
    ax[1].legend()
    if title:
        fig.suptitle(title)
    out = _fig_to_array(fig)
    if save_file:
        from PIL import Image

        Image.fromarray(out).save(save_file)
    return out


def plot_norm_err(named_tms, title: str = "",
                  save_file: Optional[str] = None) -> np.ndarray:
    """Per-timestep trans/rot error norms
    (visualizers.py plot_norm_err:236-243)."""
    return _norm_err_plot(named_tms, False, title, save_file)


def plot_cum_norm_err(named_tms, title: str = "",
                      save_file: Optional[str] = None) -> np.ndarray:
    """Cumulative trans/rot error norms
    (visualizers.py plot_cum_norm_err:245-252)."""
    return _norm_err_plot(named_tms, True, title, save_file)


def reconstruction_panel(source_img, reconstructed, target_img,
                         save_file: Optional[str] = None) -> np.ndarray:
    """(source, reconstruction, target) triplet panel used by the training
    visual check (validate.py:54-55)."""
    return image_grid(
        np.stack([source_img, reconstructed, target_img]), nrow=3,
        save_file=save_file)
