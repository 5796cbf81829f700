"""Disparity/depth conversion (counterpart of ``tcsfm/utils/helpers.py:12-27``)."""

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
