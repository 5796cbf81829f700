"""Disparity/depth conversion and the flip-merge post-processing
(counterpart of ``tcsfm/utils/helpers.py``), and the device rule of the
port's entry points."""

from __future__ import annotations

import torch


def disp_to_depth(disp: torch.Tensor, min_depth: float, max_depth: float):
    """Sigmoid disparity → (scaled_disp, depth).

    d = 1 / (1/max + (1/min - 1/max) * disp)
    """
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def depth_to_disp(depth: torch.Tensor, min_depth: float, max_depth: float):
    """Inverse of ``disp_to_depth``."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    return (1.0 / depth - min_disp) / (max_disp - min_disp)


def post_process_disparity(l_disp: torch.Tensor,
                           r_disp: torch.Tensor) -> torch.Tensor:
    """Monodepth1 flip-merge post-processing.

    l_disp, r_disp: [B, H, W]: disparity of the image and of the flipped
    image (already un-flipped). Blends with edge-favouring ramp masks.
    """
    w = l_disp.shape[-1]
    m_disp = 0.5 * (l_disp + r_disp)
    ramp = torch.linspace(0.0, 1.0, w, dtype=l_disp.dtype,
                          device=l_disp.device)[None, None, :]
    l_mask = 1.0 - (20.0 * (ramp - 0.05)).clamp(0.0, 1.0)
    r_mask = l_mask.flip(-1)
    return r_mask * l_disp + l_mask * r_disp + (1.0 - l_mask - r_mask) * m_disp


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device with no card present raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return device
